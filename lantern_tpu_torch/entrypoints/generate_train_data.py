"""generate_train_data task: base-model traces -> drafter training samples.

Counterpart of ``entrypoints_tpu/generate_train_data.py``, with the same
flags and outputs: run the base model teacher-forced over token sequences
and write one ``sample_{i:06d}.npz`` per sequence (``tokens``, the
drafter-shifted stream; ``hidden``; ``target``, the next hidden;
``loss_mask`` over the image rows; see ``train/drafter_train.py``).  Two
sources of sequences:

- ``--self-generate``: the base model samples them itself (AR), one at a
  time or ``--slots R`` in lockstep through ``ar.generate_many``;
- ``--codes-dir``: pre-extracted VQ codes (``.npz`` with ``codes``, and
  optionally the caption's ``caption_emb`` / ``caption_mask``, laid out as
  inference lays them out by ``flip_for_left_padding``).

``run(args, device)`` runs on ``device`` (``None`` is the card).  The
teacher forward is ``transformer.forward`` under ``torch.no_grad()`` over
a scratch cache of the sequence's length, the caption's pad rows masked as
inference masks them.
"""

from __future__ import annotations

import os


def add_args(p):
    p.add_argument("--model", default="llamagen")
    p.add_argument("--model-size", default="XL")
    p.add_argument("--base-path", default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--codes-dir", default=None, help=".npz files with 'codes'")
    p.add_argument("--t5-dir", default=None,
                   help="local T5 checkpoint (real captions; without it the "
                        "session falls back to hash-seeded pseudo-embeddings)")
    p.add_argument("--self-generate", action="store_true")
    p.add_argument("--prompts", default="a corgi|a red car|a mountain lake")
    p.add_argument("--num-samples", type=int, default=8)
    p.add_argument("--save-dir", default="data/drafter_train")
    p.add_argument("--cfg", type=float, default=7.5)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--slots", type=int, default=1,
                   help="batched self-generation: R rollouts share every "
                        "weight stream (ar.generate_many; the reference's "
                        "vLLM data-gen role)")


def run(args, device=None):
    import glob

    import numpy as np
    import torch

    from .. import configs
    from ..device import resolve_device
    from ..engine import ar
    from ..engine.session import LlamaGenSession
    from ..engine.spec import request_generator
    from ..kv import KVCache
    from ..models import transformer as tfm
    from ..ops.sampling import LogitsWarp
    from ..utils.t5 import flip_for_left_padding

    dev = resolve_device(device)
    cfg = configs.llamagen_config(args.model_size, "t2i")
    if args.random_weights or args.base_path is None:
        sess = LlamaGenSession.random(cfg, None, with_vq=False, device=dev)
    else:
        sess = LlamaGenSession.from_pretrained(
            args.base_path, cfg, t5_dir=getattr(args, "t5_dir", None),
            device=dev)
    params = sess.params
    rope = tfm.make_rope_tables(cfg, dev)
    Tc = cfg.cls_token_num

    @torch.no_grad()
    def teacher_forward(cond, tokens, prefix_valid):
        """cond [1, Tc, Dc], tokens [1, T] -> hidden [1, Tc + T, H]."""
        embeds = torch.cat([tfm.cond_embed(params, cfg, cond),
                            tfm.token_embed(params, tokens)], dim=1)
        T = embeds.shape[1]
        kv = KVCache.create(cfg, 1, max_len=T, device=dev)
        # caption pads masked exactly as AR/spec inference masks them, or
        # teacher hiddens skew from what the drafter will consume
        block = (torch.tril(torch.ones((T, T), dtype=torch.bool,
                                       device=dev))[None]
                 & prefix_valid[:, None, :T])
        return tfm.forward(params, cfg, embeds, kv,
                           torch.arange(T, device=dev), rope,
                           block_mask=block).hidden

    os.makedirs(args.save_dir, exist_ok=True)

    if args.codes_dir:
        sources = sorted(glob.glob(os.path.join(args.codes_dir, "*.npz")))[
            : args.num_samples]
        items = []
        for s in sources:
            z = np.load(s)
            if "caption_emb" in z:
                # the inference-time layout (session._cond_pair): valid rows
                # flipped to the right, pad rows zeroed
                emb = z["caption_emb"][None]
                mask = (z["caption_mask"][None] if "caption_mask" in z
                        else np.ones(emb.shape[:2], bool))
                emb, mask = flip_for_left_padding(emb, mask)
                items.append((z["codes"].reshape(-1), (emb[0], mask[0])))
            else:
                items.append((z["codes"].reshape(-1), None))
    else:
        # self-generate with the (vanilla AR) base model
        prompts = [p.strip() for p in args.prompts.split("|")]
        items = []
        slots = max(1, getattr(args, "slots", 1))
        if slots > 1:
            # batched rollouts: R requests a forward share the weight reads
            warp = LogitsWarp(temperature=args.temperature, top_k=args.top_k,
                              top_p=1.0)
            for lo in range(0, args.num_samples, slots):
                idxs = list(range(lo, min(lo + slots, args.num_samples)))
                conds, pvs, uncond = [], [], None
                for i in idxs:
                    c, uncond, pv = sess._cond_pair(prompts[i % len(prompts)])
                    conds.append(c)
                    pvs.append(pv)
                pv_b = None if pvs[0] is None else torch.stack(pvs)
                gens = [request_generator(args.seed + i, dev) for i in idxs]
                toks_b = ar.generate_many(
                    params, cfg, torch.stack(conds), uncond, cfg.block_size,
                    args.cfg, warp, gens, rope=rope, prefix_valid=pv_b,
                    device=dev).cpu().numpy()
                for row, i in enumerate(idxs):
                    items.append((toks_b[row], prompts[i % len(prompts)]))
        else:
            for i in range(args.num_samples):
                prompt = prompts[i % len(prompts)]
                toks, _ = sess.generate(
                    prompt, mode="ar", temperature=args.temperature,
                    top_k=args.top_k, cfg_scale=args.cfg, seed=args.seed + i)
                items.append((toks, prompt))

    n_img = cfg.block_size
    for i, (codes, meta) in enumerate(items):
        if isinstance(meta, str) or meta is None:
            cond, _, pv = sess._cond_pair(meta or "")
            cap_valid = (torch.ones((1, Tc), dtype=torch.bool, device=dev)
                         if pv is None else pv[:1, :Tc].bool())
        else:
            emb, mask = meta
            cond = torch.as_tensor(emb, device=dev)[None]
            cap_valid = torch.as_tensor(np.asarray(mask, bool),
                                        device=dev)[None]
        tokens = torch.as_tensor(np.asarray(codes, np.int32), device=dev)[None]
        valid_row = torch.ones((1, Tc + len(codes)), dtype=torch.bool,
                               device=dev)
        valid_row[:, :Tc] = cap_valid
        hidden = teacher_forward(cond, tokens, valid_row)[0].float().cpu(
            ).numpy()

        # drafter stream: token_{i+1} paired with hidden_i (zeros over the
        # conditioning prefix)
        T_all = hidden.shape[0]
        dr_tokens = np.zeros((T_all,), np.int32)
        dr_tokens[Tc - 1: Tc - 1 + len(codes)] = np.asarray(codes)
        target = np.concatenate([hidden[1:], np.zeros_like(hidden[:1])], 0)
        loss_mask = np.zeros((T_all,), np.float32)
        loss_mask[Tc - 1: Tc - 1 + n_img] = 1.0

        out = os.path.join(args.save_dir, f"sample_{i:06d}.npz")
        np.savez_compressed(
            out, tokens=dr_tokens[: T_all - 1], hidden=hidden[: T_all - 1],
            target=target[: T_all - 1], loss_mask=loss_mask[: T_all - 1])
    print(f"wrote {len(items)} samples to {args.save_dir}")
    return 0
