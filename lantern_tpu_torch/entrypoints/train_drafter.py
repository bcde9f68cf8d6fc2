"""train_drafter task: drafter self-distillation training.

Counterpart of ``entrypoints_tpu/train_drafter.py``, with the same flags,
epochs, eval split and ``history.json`` (per epoch: the summed step
losses and top-1 over the image rows).  Data comes from
``generate_train_data`` (``.npz`` samples); the base model's frozen
lm_head gives the distillation targets (a checkpoint's, or the random
base of ``--seed``).  Every ``--save-freq`` epochs and at the end,
``state_N`` holds ``{"dparams": ...}`` through ``utils.checkpoint.
save_pytree`` (``torch.save``; orbax in the JAX task).  ``run(args,
device)`` runs on ``device`` (``None`` is the card).
"""

from __future__ import annotations

import glob
import json
import os


def add_args(p):
    p.add_argument("--model", default="llamagen")
    p.add_argument("--model-size", default="XL")
    p.add_argument("--base-path", default=None,
                   help="base checkpoint dir (for embed + lm_head); random if unset")
    p.add_argument("--data-dir", required=False, default="data/drafter_train")
    p.add_argument("--save-dir", default="ckpts/trained_drafters")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--bs", type=int, default=4)
    p.add_argument("--num-epochs", type=int, default=20)
    p.add_argument("--warmup-steps-ratio", type=float, default=0.03)
    p.add_argument("--p-w", type=float, default=0.1)
    p.add_argument("--grad-clip", type=float, default=0.5)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--data-noise", default="uniform", choices=["uniform", "gaussian", "none"])
    p.add_argument("--std", type=float, default=0.2)
    p.add_argument("--cfg-loss", action="store_true")
    p.add_argument("--cfg-scale", type=float, default=3.0)
    p.add_argument("--rollout-depth", type=int, default=1,
                   help="on-policy rollout supervision levels (1 = the "
                        "reference's teacher-forced training; >1 re-runs "
                        "the drafter over its own hidden predictions)")
    p.add_argument("--rollout-w", type=float, default=0.5)
    p.add_argument("--train-data-ratio", type=float, default=0.95)
    p.add_argument("--eval-freq", type=int, default=1)
    p.add_argument("--save-freq", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)


def run(args, device=None):
    import numpy as np
    import torch

    from .. import configs
    from ..device import resolve_device
    from ..models import drafter as drf
    from ..models import transformer as tfm
    from ..train import drafter_train as dt
    from ..utils import checkpoint as ckpt

    dev = resolve_device(device)
    cfg = configs.llamagen_config(args.model_size, "t2i")
    dcfg = configs.drafter_config(cfg)

    if args.base_path:
        sd = ckpt.load_torch_dir(args.base_path)
        embed = sd["model.embed_tokens.weight"].to(dev)
        head = sd["lm_head.weight"].T.contiguous().to(dev)
    else:
        bp = tfm.init_params(
            torch.Generator(device=dev).manual_seed(args.seed), cfg,
            device=dev)
        embed, head = bp["embed"], bp["lm_head"]
        del bp

    dparams = drf.init_drafter_params(
        torch.Generator(device=dev).manual_seed(args.seed + 1), dcfg, embed)
    rope = tfm.make_rope_tables(dcfg.model, dev)

    paths = sorted(glob.glob(os.path.join(args.data_dir, "*.npz")))
    if not paths:
        raise FileNotFoundError(
            f"no .npz samples in {args.data_dir}; run generate_train_data "
            f"first")
    split = int(len(paths) * args.train_data_ratio)
    train_paths, test_paths = paths[:split], paths[split:]
    steps_per_epoch = max(len(train_paths) // args.bs, 1)

    tcfg = dt.TrainConfig(
        lr=args.lr, p_w=args.p_w, grad_clip=args.grad_clip,
        num_epochs=args.num_epochs,
        warmup_steps=int(args.warmup_steps_ratio * steps_per_epoch
                         * args.num_epochs),
        total_steps=steps_per_epoch * args.num_epochs,
        noise=args.data_noise, noise_std=args.std,
        cfg_loss=args.cfg_loss, cfg_scale=args.cfg_scale,
        rollout_depth=args.rollout_depth, rollout_w=args.rollout_w,
    )
    state = dt.init_train_state(dparams, tcfg)
    rng = np.random.default_rng(args.seed)
    noise = torch.Generator(device=dev).manual_seed(args.seed + 2)

    def summed(agg, m):
        # on the device: one read-back an epoch, not one a step
        m = m._asdict()
        return m if agg is None else {k: agg[k] + m[k] for k in m}

    os.makedirs(args.save_dir, exist_ok=True)
    history = []
    for epoch in range(args.num_epochs):
        agg = None
        for batch in dt.batch_iterator(train_paths, args.bs, args.max_len,
                                       rng):
            state, m = dt.train_step(state, dcfg, tcfg, rope, head,
                                     dt.to_device(batch, dev), noise)
            agg = summed(agg, m)
        if agg:
            n = float(max(float(agg["total"]), 1.0))
            print(f"epoch {epoch}: loss={float(agg['loss']):.4f} "
                  f"top1={float(agg['correct']) / n:.3f}")
            history.append({"epoch": epoch, "loss": float(agg["loss"]),
                            "top1": float(agg["correct"]) / n})
        if test_paths and (epoch + 1) % args.eval_freq == 0:
            tm = None
            for batch in dt.batch_iterator(test_paths, args.bs, args.max_len,
                                           rng, shuffle=False):
                tm = summed(tm, dt.eval_step(state, dcfg, tcfg, rope, head,
                                             dt.to_device(batch, dev)))
            if tm:
                n = max(float(tm["total"]), 1.0)
                print(f"  test: loss={float(tm['loss']):.4f} "
                      f"top1={float(tm['correct']) / n:.3f}")
        if (epoch + 1) % args.save_freq == 0 or (epoch + 1) == args.num_epochs:
            out = os.path.join(args.save_dir, f"state_{epoch + 1}")
            ckpt.save_pytree(out, {"dparams": state.dparams})
            print(f"  saved {out}")

    with open(os.path.join(args.save_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=2)
    return 0
