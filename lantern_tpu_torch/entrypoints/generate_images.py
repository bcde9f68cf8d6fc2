"""generate_images task: prompts -> images + per-prompt statistics.

Counterpart of ``entrypoints_tpu/generate_images.py``, with the same flags,
branches and outputs: prompt sources (literal / tsv / MSCOCO caption
json), [start, end) slicing, per-prompt ``prompt_{idx}.png``,
``global_statistics_{start}_{end}.json`` (prompt, step_compression,
latency, and error when a batched request failed) and
``generation_configs.json``.  ``run(args, device)`` runs on ``device``
(``None`` is the card).  ``--tree-choices auto --slots N`` leaves the tree,
or lockstep AR, to ``engine/policy.serving_plan`` (the production recipe
``run.sh`` serves so).  Images are written by ``utils.png``: no path here
imports an imaging library.

A random-weight Chameleon-family session gets a random Chameleon VQGAN at
its published config (seeded), so that every family writes its images; the
JAX entry point has no codec there and writes none.
"""

from __future__ import annotations

import json
import os


def add_args(p):
    p.add_argument("--model", default="llamagen",
                   choices=["llamagen", "llamagen2", "anole", "lumina_mgpt"])
    p.add_argument("--model-type", default="eagle", choices=["base", "eagle"])
    p.add_argument("--model-size", default="XL")
    p.add_argument("--base-path", default=None, help="base model checkpoint dir")
    p.add_argument("--drafter-path", default=None)
    p.add_argument("--vq-path", default=None)
    p.add_argument("--t5-dir", default=None)
    p.add_argument("--nearest-path", default=None)
    p.add_argument("--random-weights", action="store_true",
                   help="random-init weights (smoke/bench without ckpts)")
    p.add_argument("--prompts", default="a photo of a corgi")
    p.add_argument("--prompts-file", default=None,
                   help=".tsv (PartiPrompts-style) or .json (MSCOCO captions)")
    p.add_argument("--labels", default=None,
                   help="comma-separated class ids (c2i mode)")
    p.add_argument("--start-idx", type=int, default=0)
    p.add_argument("--end-idx", type=int, default=10 ** 9)
    p.add_argument("--output-dir", default="out")
    p.add_argument("--target-size", default=None,
                   help="Lumina output resolution in pixels, 'S' or 'WxH' "
                        "(reference eagle_inference_solver.py:244); maps to "
                        "the latent grid at 16 px/latent — e.g. 768 -> 48x48,"
                        " 512x768 -> h48 w32.  Default 768.")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=2000)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--cfg", type=float, default=7.5)
    p.add_argument("--static-tree", action="store_true", default=True)
    p.add_argument("--dynamic-tree", dest="static_tree", action="store_false")
    p.add_argument("--tree-choices", default="naive_extend_57",
                   help="library tree name, a .json file from "
                        "scripts/optimize_bench_tree.py (calibrated shape), "
                        "or auto (with --slots > 1 the serving policy's "
                        "tree or lockstep AR for that slot count)")
    p.add_argument("--lantern", action="store_true")
    p.add_argument("--lantern-k", type=int, default=1000)
    p.add_argument("--lantern-delta", type=float, default=0.1)
    p.add_argument("--quant", default=None, choices=[None, "int8"],
                   help="weight-only quantization of the base model "
                        "(W8A16; halves HBM weight streaming per step)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache (halves KV HBM streaming; the "
                        "dominant per-step traffic for long sequences and "
                        "batched serving)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max-new", type=int, default=None)
    p.add_argument("--total-tokens", type=int, default=59,
                   help="draft-tree budget; -1 = autotune by timing the "
                        "verify forward at candidate sizes (reference "
                        "ea_model_llamagen.py:202-226)")
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--drafter-top-k", type=int, default=10)
    p.add_argument("--slots", type=int, default=1,
                   help="continuous-batching slot count (>1 drives the "
                        "BatchedEngine+Scheduler serving path; requires "
                        "--model-type eagle)")


def load_prompts(args):
    if args.labels is not None:
        return [int(x) for x in args.labels.split(",")]
    if args.prompts_file:
        path = args.prompts_file
        if path.endswith(".tsv"):
            with open(path) as f:
                lines = f.read().strip().split("\n")[1:]
            return [ln.split("\t")[0] for ln in lines]
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and "annotations" in data:
            return [a["caption"] for a in data["annotations"]]
        return list(data)
    return [p.strip() for p in str(args.prompts).split("|")]


def _lumina_grid(target_size: str):
    """Pixels -> latents (16 px a latent); 'WxH' in the reference's (w, h)
    order."""
    if "x" in target_size:
        w_px, h_px = (int(v) for v in target_size.lower().split("x"))
    else:
        w_px = h_px = int(target_size)
    return (h_px // 16, w_px // 16)


def build_session(args, device=None):
    import torch

    from .. import configs
    from ..engine.session import ChameleonSession, LlamaGenSession

    use_drafter = args.model_type == "eagle"
    total = getattr(args, "total_tokens", 59)
    if args.model in ("anole", "lumina_mgpt"):
        family = "anole" if args.model == "anole" else "lumina"
        grid = (32, 32) if family == "anole" else (48, 48)
        ts = getattr(args, "target_size", None)
        if ts and family == "lumina":
            grid = _lumina_grid(ts)
        cfg = configs.chameleon_7b_config(swin_norm=family == "lumina")
        dcfg = configs.drafter_config(cfg, total_tokens=max(total, 2),
                                      depth=args.depth,
                                      top_k=args.drafter_top_k)
        if args.random_weights or args.base_path is None:
            sess = ChameleonSession.random(
                cfg, dcfg if use_drafter else None, family=family, grid=grid,
                device=device)
            if sess.vq_params is None:
                from ..models import vqgan

                sess.vq_cfg = vqgan.chameleon_vq_config()
                sess.vq_params = vqgan.init_vqgan_params(
                    torch.Generator(device=sess.device).manual_seed(2),
                    sess.vq_cfg, device=sess.device)
            return sess
        return ChameleonSession.from_pretrained(
            args.base_path, cfg,
            drafter_path=args.drafter_path if use_drafter else None,
            dcfg=dcfg, vq_path=args.vq_path, nearest_path=args.nearest_path,
            family=family, grid=grid, device=device,
        )

    task = "c2i" if args.labels is not None else "t2i"
    image_tokens = 1024 if args.model == "llamagen2" else 256
    cfg = configs.llamagen_config(args.model_size, task,
                                  image_tokens=image_tokens)
    dcfg = configs.drafter_config(cfg, total_tokens=max(total, 2),
                                  depth=args.depth, top_k=args.drafter_top_k)
    if args.random_weights or args.base_path is None:
        sess = LlamaGenSession.random(cfg, dcfg if use_drafter else None,
                                      device=device)
        if args.lantern:
            from ..ops.vq_distance import nearest_latents

            sess.params["nearest_latents"] = torch.as_tensor(
                nearest_latents(sess.vq_params["codebook"],
                                k=args.lantern_k + 1), device=sess.device)
        return sess
    return LlamaGenSession.from_pretrained(
        args.base_path, cfg,
        drafter_path=args.drafter_path if use_drafter else None,
        dcfg=dcfg, vq_path=args.vq_path, nearest_path=args.nearest_path,
        t5_dir=args.t5_dir, device=device,
    )


def run(args, device=None):
    import dataclasses

    from ..engine.session import LlamaGenSession
    from ..utils.png import write_png

    sess = build_session(args, device)
    if getattr(args, "quant", None) == "int8":
        from ..ops.quant import quantize_params

        sess.params = quantize_params(sess.params)
    if getattr(args, "total_tokens", 59) == -1 and sess.dcfg is not None:
        from ..engine.autotune import autotune_total_tokens

        best = autotune_total_tokens(sess.params, sess.cfg, verbose=True)
        print(f"autotuned total_tokens={best}")
        sess.dcfg = dataclasses.replace(sess.dcfg, total_tokens=best)
    prompts = load_prompts(args)
    os.makedirs(args.output_dir, exist_ok=True)

    mode = ("ar" if args.model_type == "base"
            else ("static" if args.static_tree else "dynamic"))
    stats = {}
    end = min(args.end_idx, len(prompts))
    gen_kw = dict(
        max_new=args.max_new,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        cfg_scale=args.cfg, tree=args.tree_choices,
        lantern_k=args.lantern_k if args.lantern else 0,
        lantern_delta=args.lantern_delta if args.lantern else 0.0,
        kv_quant=getattr(args, "kv_quant", False),
    )

    def save_image(idx, toks):
        if sess.vq_params is None or toks is None:
            return
        if args.model in ("anole", "lumina_mgpt"):
            img = sess.decode_generated(toks)
        else:
            img = sess.decode_ids(toks)[0]
        write_png(os.path.join(args.output_dir, f"prompt_{idx}.png"), img)

    slots = getattr(args, "slots", 1)
    if slots > 1 and (mode != "ar" or isinstance(sess, LlamaGenSession)):
        # continuous batching: R requests share every weight stream
        sel = list(range(args.start_idx, end))
        reqs = sess.generate_batch(
            [prompts[i] for i in sel], slots=slots, mode=mode,
            seed=args.seed + args.start_idx, progress=True, **gen_kw)
        for off, req in enumerate(reqs):
            idx = sel[off]
            save_image(idx, req.tokens)
            stats[f"prompt_{idx}"] = {
                "prompt": prompts[idx],
                "step_compression": req.step_compression,
                "latency": req.latency,
                **({"error": req.error} if req.error else {}),
            }
    else:
        for idx in range(args.start_idx, end):
            prompt = prompts[idx]
            toks, st = sess.generate(prompt, mode=mode, seed=args.seed + idx,
                                     **gen_kw)
            save_image(idx, toks)
            stats[f"prompt_{idx}"] = {
                "prompt": prompt,
                "step_compression": st.step_compression,
                "latency": st.latency,
            }
            print(f"[{idx}] steps={st.steps} compression={st.step_compression:.3f} "
                  f"latency={st.latency:.2f}s")

    with open(os.path.join(
            args.output_dir,
            f"global_statistics_{args.start_idx}_{end}.json"), "w") as f:
        json.dump(stats, f, indent=4)
    with open(os.path.join(args.output_dir, "generation_configs.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()
                   if k not in ("task", "device")}, f, indent=4)
    return 0
