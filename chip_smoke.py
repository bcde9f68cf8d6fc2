#!/usr/bin/env python3
"""Chip smoke test of the H100 port (``lantern_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # 16x16 image grid (273 tokens)
    python3 chip_smoke.py --grid 48  # the bench lane's 48x48 grid (2353 tokens)

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: compiles the CUDA kernels of ``lantern_tpu_torch/csrc`` through
   ``torch.utils.cpp_extension.load``;
3. kernels: each kernel (K1 W8A16 matmul, K2 tree attention, K3 KV write)
   against its plain PyTorch version at the Lumina lane's shapes (K2 also
   at this run's KV capacity, and with known-wrong variants that must fall
   outside its tolerance), with median times (CUDA events, L2 flushed
   before every launch), the bound from bytes and operations, and the
   PyTorch library yardstick;
4. forward: a tiny head_dim-128 Chameleon forward through the kernels on
   the card against the plain-PyTorch forward on the CPU;
5. main path: Lumina-mGPT-7B geometry (32 layers, full width), random int8
   weights from a seed, int8 KV cache, 48x48-grid FSM vocabulary, 16 text
   tokens and the calibrated tree ``ckpts/bench_tree_lumina.json``; runs
   the AR twin and the speculative engine (stale drafting, deferred
   commit, LANTERN k=10 delta=5, top-2000, cfg 3.0) with the launch
   counters reset just before each and read just after, then profiles a
   few steps of each (device time by kernel, device-busy share).

The line before the last two is ``{"kernels": [...]}``; then the
``nvidia-smi`` name/power-limit line; the last line is the device record.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

K1_SHAPES = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w_gu": (4096, 22016),
             "w_down": (11008, 4096), "lm_head": (4096, 65536)}
TEXT = list(range(60000, 60016))          # 16 text tokens, as bench.py


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of ``fn`` with a cold L2 before each call."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, reps: int = 15, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def lane_dims(grid: int) -> tuple[int, int]:
    """(tokens to generate, sequence capacity) of the Lumina lane on a
    ``grid`` x ``grid`` image: ``grid`` rows of ``grid`` tokens and a newline,
    end-of-image, and room for one tree block after the last token."""
    max_new = grid * (grid + 1) + 1
    return max_new, len(TEXT) + 3 + max_new + 74


def phase_kernels(torch, timer, card: str, grid: int):
    import torch.nn.functional as F

    from lantern_tpu_torch import trees
    from lantern_tpu_torch.kv import (group_blocks, quantize_rows,
                                      write_block_cuda, write_block_plain)
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.quant import int8_matmul, int8_matmul_cuda
    from lantern_tpu_torch.ops.tree_attention import (
        NEG_INF, tree_attention_cuda, tree_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"
    records = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- K1 ----
    k1_err, k1_rep = 0.0, None
    for name, (K, N) in K1_SHAPES.items():
        q = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (torch.rand((1, N), generator=gen, device=dev) + 0.5) * 2e-4
        out_dt = torch.float32 if name == "lm_head" else torch.bfloat16
        for M in (2, 38, 64):
            x = randn(M, K)
            got = int8_matmul_cuda(x, q, s, out_dt)
            ref = int8_matmul(x, q, s, out_dt)
            torch.cuda.synchronize()
            scale_ = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            tol = 1e-2 * scale_ + 1e-6
            if not (err <= tol and torch.isfinite(got.float()).all()):
                fail(f"K1 {name} M={M}: max err {err} > tol {tol}")
            k1_err = max(k1_err, err)
            ms = timer(lambda: int8_matmul_cuda(x, q, s, out_dt))
            plain = timer(lambda: int8_matmul(x, q, s, out_dt), reps=5)
            lib = timer(lambda: (x @ q.to(torch.bfloat16)) * s, reps=5)
            nbytes = M * K * 2 + K * N + N * 4 + M * N * (4 if out_dt == torch.float32 else 2)
            b_ms, b_by = bound(nbytes, 2.0 * M * K * N)
            log(f"K1 int8_matmul {name} M={M} K={K} N={N}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e}) ms {ms:.4f} plain_ms {plain:.4f} "
                f"library_ms {lib:.4f} bound_ms {b_ms:.4f} ({b_by}) [{card}]")
            if name == "w_gu" and M == 64:
                k1_rep = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=b_ms, bound_by=b_by,
                              shape=f"M={M} K={K} N={N} (w_gu, tree verify)")
    records["int8_matmul"] = dict(k1_rep, max_abs_err=k1_err)

    # ---- K2 ----
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_lumina.json"))
    tmask = torch.as_tensor(tree.attn_mask, device=dev)
    B, G, W = 2, 32, 128
    # the bench lane's capacity (5 prefix splits and the merge kernel), then
    # this run's grid capacity, so each run checks the split count its own
    # main path uses
    cases = [(2560, 1, 2371), (2560, 19, 0), (2560, 32, 1237)]
    max_new, max_seq_len = lane_dims(grid)
    S_run, prompt = -(-max_seq_len // 128) * 128, len(TEXT) + 3
    if S_run != 2560:
        cases += [(S_run, 1, prompt + max_new - 2),
                  (S_run, 32, (prompt + max_new // 2) | 1)]
    k2_err, k2_rep = 0.0, None
    for S, T, length in cases:
        q, kn, vn = randn(B, T, G, W), randn(B, T, G, W), randn(B, T, G, W)
        kc, ks = quantize_rows(randn(B, G, S, W))
        vc, vs = quantize_rows(randn(B, G, S, W))
        if T == 32:
            mask = tmask[None].expand(B, T, T).contiguous()
        else:
            mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                         device=dev))[None].expand(B, T, T)
            mask = mask.contiguous()
        bias = torch.zeros((B, S), device=dev)
        bias[1, :7] = NEG_INF                      # left-padded uncond row
        ln = torch.tensor(length, dtype=torch.int32, device=dev)
        args = (q, kn, vn, kc, vc, ln, mask, bias, W ** -0.5)
        kw = dict(k_scale=ks, v_scale=vs)
        got = tree_attention_cuda(*args, **kw)
        ref = tree_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2e-2 * ref.float().abs().max().item()
        if not (err <= tol and torch.isfinite(got.float()).all()):
            fail(f"K2 S={S} T={T} length={length}: max err {err} > tol {tol}")
        k2_err = max(k2_err, err)
        # known-wrong variants of the function must land outside tol
        wrong = {}
        if length:
            wrong["v_scale dropped"] = dict(v_scale=torch.ones_like(vs))
            b2 = bias.clone()
            b2[:, length - 1] = NEG_INF
            wrong["last prefix key dropped"] = dict(bias=b2)
        if length >= 64:
            b2 = bias.clone()
            j0 = length // 2 // 32 * 32
            b2[:, j0:j0 + 32] = NEG_INF
            wrong["a 32-key prefix tile dropped"] = dict(bias=b2)
        if T > 1:
            m2 = mask.clone()
            m2[:, T - 1, 0] = ~m2[:, T - 1, 0]
            wrong["a mask entry flipped"] = dict(mask=m2)
        werr = {}
        for why, over in wrong.items():
            bad = tree_attention_plain(
                q, kn, vn, kc, vc, ln, over.get("mask", mask),
                over.get("bias", bias), W ** -0.5, k_scale=ks,
                v_scale=over.get("v_scale", vs))
            werr[why] = (bad.float() - ref.float()).abs().max().item()
            if werr[why] <= tol:
                fail(f"K2 S={S} T={T} length={length}: tol {tol} does not "
                     f"separate a wrong variant ({why}: err {werr[why]})")
        ms = timer(lambda: tree_attention_cuda(*args, **kw))
        plain = timer(lambda: tree_attention_plain(*args, **kw), reps=5)
        # library yardstick: SDPA over the dequantized prefix + block
        kd = torch.cat([(kc[:, :, :length].float() * ks[:, :, :length, None]),
                        quantize_rows(group_blocks(kn))[0].float()
                        * quantize_rows(group_blocks(kn))[1][..., None]],
                       dim=2).to(torch.bfloat16)
        vd = torch.cat([(vc[:, :, :length].float() * vs[:, :, :length, None]),
                        quantize_rows(group_blocks(vn))[0].float()
                        * quantize_rows(group_blocks(vn))[1][..., None]],
                       dim=2).to(torch.bfloat16)
        am = torch.cat([(bias[:, None, None, :length] == 0).expand(B, 1, T, length),
                        mask[:, None]], dim=-1)
        qh = q.transpose(1, 2)
        lib = timer(lambda: F.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=am, scale=W ** -0.5))
        nbytes = (4 * B * T * G * W * 2 + 2 * B * G * length * (W + 4)
                  + B * T * T + B * length * 4)
        b_ms, b_by = bound(nbytes, 4.0 * B * G * T * (length + T) * W)
        log(f"K2 tree_attention S={S} T={T} length={length} int8 KV: "
            f"max_abs_err {err:.3e} (tol {tol:.3e} = 2e-2 * max|ref|) ms "
            f"{ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}) [{card}]")
        log("  wrong variants' max err: " + "; ".join(
            f"{why} {e:.3e}" for why, e in werr.items()))
        if (S, T) == (2560, 32):
            k2_rep = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by,
                          shape=f"B=2 T={T} G=32 length={length} int8 KV")
    records["tree_attention"] = dict(k2_rep, max_abs_err=k2_err)

    # ---- K3 ---- (the bench lane's planes)
    L, S = 32, 2560
    k3_err, k3_rep = 0.0, None
    for T, start in ((1, 1301), (5, 777), (19, 0)):
        kn, vn = randn(L, B, T, G, W), randn(L, B, T, G, W)
        planes = []
        for _ in range(2):
            kb = torch.randint(-127, 128, (L, B, G, S, W), generator=gen,
                               device=dev, dtype=torch.int8)
            vb = torch.randint(-127, 128, (L, B, G, S, W), generator=gen,
                               device=dev, dtype=torch.int8)
            ksc = torch.rand((L, B, G, S), generator=gen, device=dev)
            vsc = torch.rand((L, B, G, S), generator=gen, device=dev)
            planes.append([kb, vb, ksc, vsc])
        planes[1] = [t.clone() for t in planes[0]]
        before = [t.clone() for t in planes[0]]
        st = torch.tensor(start, dtype=torch.int32, device=dev)
        write_block_cuda(*planes[0][:2], *planes[0][2:], kn, vn, st)
        write_block_plain(*planes[1][:2], *planes[1][2:], kn, vn, st)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(planes[0], planes[1]))
        outside = torch.ones(S, dtype=torch.bool, device=dev)
        outside[start:start + T] = False
        untouched = all(torch.equal(a[..., outside, :] if a.ndim == 5 else a[..., outside],
                                    b[..., outside, :] if b.ndim == 5 else b[..., outside])
                        for a, b in zip(planes[0], before))
        if err != 0 or not untouched:
            fail(f"K3 T={T} start={start}: max err {err}, rows outside "
                 f"[start, start+T) untouched: {untouched}")
        k3_err = max(k3_err, err)
        kb, vb, ksc, vsc = planes[0]
        ms = timer(lambda: write_block_cuda(kb, vb, ksc, vsc, kn, vn, st))
        plain = timer(lambda: write_block_plain(kb, vb, ksc, vsc, kn, vn, st),
                      reps=5)
        nbytes = 2 * L * B * T * G * W * 2 + 2 * L * B * T * G * (W + 4)
        b_ms, b_by = bound(nbytes, 0.0)
        log(f"K3 kv_write T={T} start={start} int8: max_abs_err {err:.3e} "
            f"(tol 0, exact) ms {ms:.4f} plain_ms {plain:.4f} library_ms null "
            f"bound_ms {b_ms:.4f} ({b_by}) [{card}]")
        if T == 5:
            k3_rep = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                          bound_by=b_by, shape=f"L=32 B=2 T={T} G=32 int8")
        del planes, before
    records["kv_write"] = dict(k3_rep, max_abs_err=k3_err)
    _cuda.reset_launches()
    return records


def phase_forward(torch):
    """Tiny head_dim-128 Chameleon forward: kernels on the card vs the
    plain path on the CPU, bf16, int8 KV, a tree block after a prefix."""
    from lantern_tpu_torch import configs, trees
    from lantern_tpu_torch.kv import KVCache
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops.quant import quantize_params

    cfg = configs.tiny_config(vocab_size=512, hidden_size=256, num_layers=2,
                              num_heads=2, rope_kind="1d", cond_kind="none",
                              qk_norm=True, swin_norm=True, max_seq_len=256,
                              dtype="bfloat16")
    gen = torch.Generator().manual_seed(5)
    params = quantize_params(tfm.fuse_params(
        tfm.init_params(gen, cfg, device="cpu")))
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_lumina.json"))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in params.items()}
        rope = tfm.make_rope_tables(cfg, dev)
        kv = KVCache.create(cfg, 2, quantized=True, device=dev)
        g2 = torch.Generator().manual_seed(9)
        ids = torch.randint(0, 512, (2, 19), generator=g2).to(dev)
        res = tfm.forward(p, cfg, tfm.token_embed(p, ids), kv,
                          torch.arange(19, device=dev), rope)
        tids = torch.randint(0, 512, (2, tree.num_nodes), generator=g2).to(dev)
        pos = 19 + torch.as_tensor(tree.depth, device=dev).long()
        res2 = tfm.forward(p, cfg, tfm.token_embed(p, tids), res.kv, pos, rope,
                           block_mask=torch.as_tensor(tree.attn_mask, device=dev),
                           commit=False, defer_block=True)
        outs[dev] = tfm.logits_head(p, res2.hidden).cpu()
    err = (outs["cpu"] - outs["cuda"]).abs().max().item()
    tol = 5e-2 * outs["cpu"].abs().max().item()
    if not (err <= tol and torch.isfinite(outs["cuda"]).all()):
        fail(f"forward: card vs CPU logits max err {err} > tol {tol}")
    log(f"forward: tiny bf16 int8-KV tree forward, card kernels vs CPU plain: "
        f"logits max_abs_err {err:.3e} (tol {tol:.3e})")


def phase_main_path(torch, grid: int, card: str):
    from lantern_tpu_torch import configs, trees
    from lantern_tpu_torch.engine import ar, spec
    from lantern_tpu_torch.models import chameleon as cham
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.acceptance import LanternSpec
    from lantern_tpu_torch.ops.quant import quantize_params
    from lantern_tpu_torch.ops.sampling import LogitsWarp
    from lantern_tpu_torch.ops.vq_distance import nearest_latents

    max_new, max_seq_len = lane_dims(grid)
    cfg = configs.chameleon_7b_config(max_seq_len=max_seq_len, swin_norm=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tfm.init_params(gen, cfg, device="cuda")
    params = quantize_params(tfm.fuse_params(params))
    cb = torch.randn((8192, 8), generator=gen, device="cuda")
    near = cham.shift_nearest_table(nearest_latents(cb, k=11), cfg.vocab_size)
    params["nearest_latents"] = torch.as_tensor(near, device="cuda")
    torch.cuda.synchronize()
    log(f"main path: Lumina-7B int8 params built on the card in "
        f"{time.perf_counter() - t0:.1f} s (L={cfg.num_layers} "
        f"H={cfg.hidden_size} V={cfg.vocab_size})")

    warp = LogitsWarp(temperature=1.0, top_k=2000, top_p=1.0)
    tp = cham.lumina_token_prompt(TEXT, grid=(grid, grid))
    fsm = cham.LuminaGridFSM(w=grid, h=grid, image_start_idx=len(TEXT),
                             vocab_size=cfg.vocab_size)
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_lumina.json"))
    ecfg = spec.SpecDecodeConfig(
        warp=warp, cfg_scale=3.0, lantern=LanternSpec(k=10, delta=5.0),
        max_new=max_new, kv_quant=True, walk_batch_warp=True,
        stale_draft=True, deferred_commit=True)

    def run_spec(seed, max_steps=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return spec.generate(params, ecfg, cfg, tree, tp, g,
                             max_steps=max_steps, logits_fn=fsm)

    def run_ar(seed, n):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return ar.generate_tokens(params, cfg, tp, n, 3.0, warp, g,
                                  logits_fn=fsm, kv_quant=True)

    run_spec(7, max_steps=3)              # warm-up (cuBLAS, allocator)
    run_ar(7, 4)
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, dict(_cuda.LAUNCHES)

    torch.cuda.reset_peak_memory_stats()
    ar_res, t_ar, ar_launch = timed(lambda: run_ar(8, max_new))
    sres, t_spec, spec_launch = timed(lambda: run_spec(8))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def legal(toks):
        toks = [int(t) for t in toks]
        for i, t in enumerate(toks[:-1]):
            if i % (grid + 1) == grid:
                if t != cham.LUMINA_NEWLINE_ID:
                    return f"position {i}: {t} is not the newline token"
            elif not cham.IMAGE_TOKEN_START <= t <= cham.IMAGE_TOKEN_END:
                return f"position {i}: {t} is not an image token"
        if toks[-1] != cham.IMAGE_END_ID:
            return f"last token {toks[-1]} is not end-of-image"
        return None

    if sres.n_valid != max_new or ar_res.tokens.shape[0] != max_new:
        fail(f"spec committed {sres.n_valid}, AR {ar_res.tokens.shape[0]}, "
             f"want {max_new}")
    for name, toks in (("spec", sres.tokens.tolist()),
                       ("ar", ar_res.tokens.tolist())):
        why = legal(toks)
        if why:
            fail(f"{name} stream breaks the grid FSM: {why}")
    sc = sres.step_compression
    if sc < 1.0:
        fail(f"step compression {sc} < 1")
    for name, launch in (("spec", spec_launch), ("ar", ar_launch)):
        missing = [k for k, n in launch.items() if n == 0]
        if missing:
            fail(f"{name} run launched no {missing} kernel: {launch}")
    log(f"main path [{card}] grid {grid}x{grid} ({max_new} tokens): "
        f"spec {max_new / t_spec:.2f} tok/s ({t_spec:.2f} s, "
        f"{sres.steps} verify steps, {sres.steps / t_spec:.2f} steps/s, "
        f"step compression {sc:.3f}); AR {max_new / t_ar:.2f} tok/s "
        f"({t_ar:.2f} s); spec/AR {t_ar / t_spec:.3f}; peak memory "
        f"{peak:.2f} GiB")
    log(f"main path launches: spec {spec_launch}; ar {ar_launch}")
    profile("spec, 6 verify steps", lambda: run_spec(9, max_steps=6), card)
    profile("ar, 12 tokens", lambda: run_ar(9, 12), card)
    return spec_launch


def profile(what: str, fn, card: str) -> None:
    """Device time by kernel over one short run (torch.profiler), and the
    share of the run's wall time the card was busy: the union of the
    device-side events (kernels, copies, fills), so an operator and the
    kernel it launched are counted once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not spans:
        log(f"profile [{card}] {what}: wall {wall / 1e3:.2f} ms, device "
            f"busy not measured (the profiler recorded no device events)")
        return
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    log(f"profile [{card}] {what}: wall {wall / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall:.1f}% of wall; "
        f"{len(spans)} device events)")
    rows = sorted(((us, n, k) for k, (us, n) in by_name.items()),
                  reverse=True)
    for us, n, key in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  {n:6d}x  {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=16,
                    help="image latent grid (48 = the bench lane)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    try:
        from lantern_tpu_torch.ops import _cuda
    except ImportError as e:
        fail(f"run from the repository root: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {card}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")

    t = time.perf_counter()
    _cuda.library(verbose=True)
    log(f"build: torch.utils.cpp_extension.load of lantern_tpu_torch/csrc "
        f"in {time.perf_counter() - t:.1f} s")

    timer = Timer(torch)
    records = phase_kernels(torch, timer, f"{card}, {smi}", args.grid)
    phase_forward(torch)
    launches = phase_main_path(torch, args.grid, f"{card}, {smi}")

    kernels = []
    for name, src, rep in (
            ("int8_matmul", "lantern_tpu_torch/csrc/int8_matmul.cu",
             "lantern_tpu/ops/quant.py:73"),
            ("tree_attention", "lantern_tpu_torch/csrc/tree_attention.cu",
             "lantern_tpu/ops/pallas/tree_attention.py:181"),
            ("kv_write", "lantern_tpu_torch/csrc/kv_write.cu",
             "lantern_tpu/ops/pallas/kv_update.py:170")):
        r = records[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
