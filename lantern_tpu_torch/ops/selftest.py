"""Kernel self-test: K1-K4 through the port's dispatching ops, each held
against an independent dense form.

Counterpart of ``lantern_tpu/ops/pallas/selftest.py``.  The tests hold
each plain version to the JAX package and, on a card, each CUDA kernel to
its plain version; this module re-runs the JAX module's checks through the
ops a model calls, on the device it is given (the kernels on a card, the
plain versions on the CPU, as JAX runs interpret mode there), and raises on
divergence, so a bench can call it before it times anything:

- K2 (``tree_attention``) at B=2, T=16, 4 heads of 64 (two a 128-lane
  group), S=512, length 137, the prefix bias on row 0's first 7 keys,
  within 3e-2 of dense f32 attention;
- K3 (``kv.write_block``) at start 200 and K4 (``kv.gather_write_block``)
  of ``rel = [3, 0, 7, 7, 1]``, byte-exact against slice assignments;
- K1 (``w8a16_matmul``) on 8 x 256 x 512 within 1e-1 of the dequantized
  product, f32 out (two f32 sums near |y| ~ 30 that round to neighbouring
  bf16 values differ by 0.125);
- on a card only, the JAX module's TPU check: a tiny 2-layer, hidden-256
  label model over ``chain_bush_8``, 48 sampled tokens with deferred commit
  equal token for token to the run with rollback commit, through the
  kernels (K2 at S = 1024, K3, K4);
- on a card only, beside the JAX module's checks (its keys stay the
  CPU's): K2 at grouped-query heads (``tree_attention_gqa``), 8 query
  heads of 128 over 2 KV heads (G = 2, 4 query heads a KV head), T=16,
  S=512, length 137, within 3e-2 of dense attention over the KV heads
  repeated for their query heads, inputs from ``default_rng(1)``;
- on a card only: K1's wide form (``int8_matmul_wide``), the same check at
  130 rows (above the narrow form's 64: two row tiles, the second ragged),
  inputs from ``default_rng(3)``, its first 8 rows equal bit for bit to
  the 8-row call's (the narrow form);
- on a card only: K5 (``stochastic_verify_tree``) on the benchmark's tree
  (``ckpts/bench_tree_lumina.json``, 32 nodes, 10 children a node, depth
  4) at V = 65,536, multi-draft with LANTERN (k = 10, delta = 5) and top-k
  2,000, against the plain walk under the same coins (drawn, then all 0,
  then all 1), inputs from ``default_rng(2)``: the accepted slots equal,
  the bonus distribution within 1e-5.

The inputs come from ``np.random.default_rng(0)`` in the JAX module's
order (``draw_inputs``), so both modules see the same numbers.

Run standalone: ``python -m lantern_tpu_torch.ops.selftest [--device cpu]``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..kv import gather_write_block, group_blocks, write_block
from . import acceptance
from .quant import quantize_weight, w8a16_matmul
from .sampling import LogitsWarp
from .tree_attention import NEG_INF, tree_attention

# K2's shape: batch, block rows, heads, head dim, cache rows, live prefix
B, T, NH, HD, S, LENGTH = 2, 16, 4, 64, 512, 137
# K3 / K4: layers, head groups, lanes, new rows, start, K4's path and block
L, G, W, TN, START, BLK = 4, 2, 128, 24, 200, 32
REL = [3, 0, 7, 7, 1]
# K1: rows, contraction, columns; the rows of its wide form's case
M, K, N = 8, 256, 512
WIDE_M = 130
# the grouped-query K2 case: KV heads of 128 and query heads a KV head
GQA_NKV, GQA_REP = 2, 4
# K5: the benchmark's tree, vocabulary, warp and LANTERN operating point
WALK_TREE = (Path(__file__).resolve().parents[2] / "ckpts"
             / "bench_tree_lumina.json")
WALK_V, WALK_TOP_K, WALK_LANTERN = 65536, 2000, (10, 5.0)
TOL = {"tree_attention": 3e-2, "kv_write": 0.0, "kv_rollback": 0.0,
       "int8_matmul": 1e-1, "deferred_flash_tokens": 0,
       "tree_attention_gqa": 3e-2, "tree_walk": 1e-5,
       "int8_matmul_wide": 1e-1}


def draw_inputs(seed: int = 0) -> dict:
    """The checks' inputs as numpy arrays, drawn in the JAX module's order
    (``w`` is the f32 weight that K1's check quantizes)."""
    rng = np.random.default_rng(seed)
    out = {name: rng.normal(size=shape) for name, shape in (
        ("q", (B, T, NH, HD)), ("kn", (B, T, NH, HD)), ("vn", (B, T, NH, HD)),
        ("kc", (B, S, NH, HD)), ("vc", (B, S, NH, HD)))}
    out["mask"] = (rng.random((T, T)) < 0.4) | np.eye(T, dtype=bool)
    bias = np.zeros((B, S), np.float32)
    bias[0, :7] = NEG_INF
    out["bias"] = bias
    for name, shape in (("k_buf", (L, B, G, S, W)), ("v_buf", (L, B, G, S, W)),
                        ("k_new", (L, B, G, TN, W)),
                        ("v_new", (L, B, G, TN, W))):
        out[name] = rng.normal(size=shape)
    out["x"] = rng.normal(size=(M, K))
    out["w"] = rng.normal(size=(K, N)).astype(np.float32)
    return out


def dense_attention(q, kn, vn, kc, vc, length: int, mask, bias, scale):
    """Attention of the block ``q`` [B, T, nh, hd] over the cache's first
    ``length`` rows ``kc``/``vc`` [B, S, nh, hd] (plus ``bias``) and the
    block's own keys under ``mask`` [T, T], in f32 from the operands'
    values (the JAX module's ``tree_attention_reference``)."""
    s_pre = torch.einsum("btnh,bsnh->bnts", q.float(), kc.float()) * scale
    vis = torch.arange(kc.shape[1], device=q.device) < length
    s_pre = torch.where(vis, s_pre, NEG_INF) + bias.float()[:, None, None, :]
    s_blk = torch.einsum("btnh,bunh->bntu", q.float(), kn.float()) * scale
    s_blk = torch.where(mask, s_blk, NEG_INF)
    p = torch.softmax(torch.cat([s_pre, s_blk], dim=-1), dim=-1)
    Sc = kc.shape[1]
    o = torch.einsum("bnts,bsnh->btnh", p[..., :Sc], vc.float())
    o = o + torch.einsum("bntu,bunh->btnh", p[..., Sc:], vn.float())
    return o.to(q.dtype)


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def deferred_vs_rollback(device) -> int:
    """The tokens in which 48 sampled tokens with deferred commit differ
    from the same run with rollback commit (a tiny bf16 label model over
    ``chain_bush_8``, the drafter proposing, one seed)."""
    from .. import configs, trees
    from ..engine import spec
    from ..models import drafter as drf
    from ..models import transformer as tfm
    from .acceptance import LanternSpec
    from .sampling import LogitsWarp

    cfg = configs.tiny_config(vocab_size=512, hidden_size=256, num_layers=2,
                              num_heads=4, cond_kind="label", block_size=64,
                              max_seq_len=1024, dtype="bfloat16")
    dcfg = configs.drafter_config(cfg, total_tokens=10, depth=2, top_k=4)
    params = tfm.init_params(torch.Generator(device).manual_seed(0), cfg,
                             device=device)
    dparams = drf.init_drafter_params(torch.Generator(device).manual_seed(1),
                                      dcfg, params["embed"])
    tree = trees.get_tree("chain_bush_8")
    toks = {}
    for defer in (False, True):
        ecfg = spec.SpecDecodeConfig(
            warp=LogitsWarp(temperature=1.0, top_k=50), cfg_scale=2.0,
            lantern=LanternSpec(), max_new=48, mode="static",
            deferred_commit=defer)
        with torch.no_grad():
            res = spec.generate(
                params, ecfg, cfg, tree, None,
                torch.Generator(device).manual_seed(5), device=device,
                dparams=dparams, dcfg=dcfg,
                cond=torch.tensor([3], device=device),
                uncond=torch.tensor([cfg.num_classes], device=device))
        toks[defer] = res.tokens
    return int((toks[True] != toks[False]).sum())


def gqa_attention_error(device) -> float:
    """K2 through ``tree_attention`` at grouped-query heads against
    ``dense_attention`` over the KV heads repeated for their query heads
    (query head ``n`` reads KV head ``n // GQA_REP``)."""
    rng = np.random.default_rng(1)
    nh, hd = GQA_NKV * GQA_REP, 128

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape)).to(
            torch.bfloat16).to(device)

    q = t(B, T, nh, hd)
    kn, vn, kc, vc = (t(B, n, GQA_NKV, hd) for n in (T, T, S, S))
    mask = torch.as_tensor((rng.random((T, T)) < 0.4) | np.eye(T, dtype=bool),
                           device=device)
    bias = torch.zeros((B, S), device=device)
    bias[0, :7] = NEG_INF
    length = torch.tensor(LENGTH, dtype=torch.int32, device=device)
    got = tree_attention(q, kn, vn, group_blocks(kc).contiguous(),
                         group_blocks(vc).contiguous(), length, mask, bias,
                         hd ** -0.5)
    kn, vn, kc, vc = (x.repeat_interleave(GQA_REP, dim=2)
                      for x in (kn, vn, kc, vc))
    return _max_err(got, dense_attention(q, kn, vn, kc, vc, LENGTH, mask,
                                         bias, hd ** -0.5))


def walk_inputs(rng: np.random.Generator, device, V: int = WALK_V):
    """One acceptance walk's inputs on the benchmark's tree, as stale
    drafting leaves them: logits that favour the drafted tokens, q in
    (0, 1) with a few zeros, one drafter row a level broadcast to the
    level's rows, and a nearest table with high tokens among each draft's
    neighbours.  Returns ``(args, kwargs)`` of ``stochastic_verify_tree``
    without its generator and coins."""
    from .. import trees

    spec = trees.get_tree(str(WALK_TREE))
    N1, depth = spec.num_nodes, spec.max_depth
    toks = rng.integers(0, V, size=N1)
    logits = rng.normal(size=(N1, V)) * 2
    nearest = rng.integers(0, V, size=(V, WALK_LANTERN[0] + 1))
    for p in range(N1):
        kids = spec.children[p][spec.children[p] >= 0]
        logits[p, toks[kids]] += rng.choice([0.0, 6.0, 9.0], size=len(kids))
        top = np.argsort(-logits[p])[:12]
        for s in kids:
            nearest[toks[s], :6] = rng.permutation(top)[:6]
    q = rng.uniform(0.02, 0.9, size=N1)
    q[rng.random(N1) < 0.1] = 0.0
    rows = [1] + [len(lv.child_flat_idx) for lv in spec.levels]
    level_probs = [torch.softmax(torch.as_tensor(
        rng.normal(size=(1, V)) * 3, dtype=torch.float32, device=device),
        -1).expand(r, V) for r in rows]

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    args = (t(logits, torch.float32), t(toks, torch.int32),
            t(spec.children, torch.long), depth,
            LogitsWarp(temperature=1.0, top_k=WALK_TOP_K))
    kw = dict(nearest=t(nearest, torch.int32),
              lantern=acceptance.LanternSpec(*WALK_LANTERN),
              node_q=t(q, torch.float32), level_probs=level_probs,
              node_level_row=t(spec.inlevel_rank, torch.long))
    return args, kw


def wide_matmul_error(device) -> float:
    """K1 at ``WIDE_M`` rows (the wide form on a card) against the
    dequantized product, f32 out: the largest error (``inf`` where a row
    of the 8-row call, the narrow form, differs from its row here)."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(WIDE_M, K)), dtype=torch.bfloat16,
                        device=device)
    wq, ws = quantize_weight(torch.as_tensor(
        rng.normal(size=(K, N)).astype(np.float32), device=device))
    got = w8a16_matmul(x, wq, ws, out_dtype=torch.float32)
    if not torch.equal(got[:M], w8a16_matmul(x[:M], wq, ws,
                                             out_dtype=torch.float32)):
        return float("inf")
    return _max_err(got, x.float() @ (wq.float() * ws))


def walk_error(device) -> float:
    """K5 through ``stochastic_verify_tree`` against the plain walk on
    ``walk_inputs``, under drawn coins, then all 0, then all 1: the largest
    bonus-distribution error (``inf`` where the accepted slots differ)."""
    rng = np.random.default_rng(2)
    args, kw = walk_inputs(rng, device)
    C = args[2].shape[1]
    err = 0.0
    for coins in (rng.random((args[3], C)), 0.0, 1.0):
        u = torch.as_tensor(np.broadcast_to(coins, (args[3], C)).copy(),
                            dtype=torch.float32, device=device)
        path, alen, dist = acceptance.stochastic_verify_tree(
            None, *args, uniforms=u, **kw)
        rp, ra, rd = acceptance.stochastic_verify_tree_plain(*args, u, **kw)
        n = int(alen) + 1
        if int(alen) != int(ra) or not torch.equal(path[:n], rp[:n]):
            return float("inf")
        err = max(err, _max_err(dist, rd))
    return err


def run_kernel_selftest(device=None, verbose: bool = False) -> dict:
    """``{check: max_abs_err}`` (and ``"backend"``: the device type);
    raises ``AssertionError`` on divergence.  ``device`` defaults to the
    card."""
    dev = resolve_device(device)
    inp = draw_inputs()
    errs: dict = {"backend": dev.type}

    def t(name, dtype=torch.bfloat16):
        return torch.as_tensor(inp[name]).to(dtype).to(dev)

    # --- K2: tree attention against dense attention ------------------------
    q, kn, vn, kc, vc = (t(n) for n in ("q", "kn", "vn", "kc", "vc"))
    mask = torch.as_tensor(inp["mask"], device=dev)
    bias = torch.as_tensor(inp["bias"], device=dev)
    scale = HD ** -0.5
    length = torch.tensor(LENGTH, dtype=torch.int32, device=dev)
    got = tree_attention(q, kn, vn, group_blocks(kc).contiguous(),
                         group_blocks(vc).contiguous(), length, mask, bias,
                         scale)
    errs["tree_attention"] = _max_err(
        got, dense_attention(q, kn, vn, kc, vc, LENGTH, mask, bias, scale))

    # --- K3 and K4: block write and rollback gather against slices ---------
    k_buf, v_buf, k_new, v_new = (t(n) for n in ("k_buf", "v_buf", "k_new",
                                                 "v_new"))
    start = torch.tensor(START, dtype=torch.int32, device=dev)
    ko, vo = k_buf.clone(), v_buf.clone()
    # the grouped [L, B, G, Tn, W] rows as [L, B, Tn, n_kv = G, hd = W]
    write_block(ko, vo, None, None, k_new.movedim(2, 3).contiguous(),
                v_new.movedim(2, 3).contiguous(), start)
    ref_k, ref_v = k_buf.clone(), v_buf.clone()
    ref_k[:, :, :, START:START + TN] = k_new
    ref_v[:, :, :, START:START + TN] = v_new
    errs["kv_write"] = max(_max_err(ko, ref_k), _max_err(vo, ref_v))
    rel = torch.tensor(REL, dtype=torch.int32, device=dev)
    gather_write_block(ko, vo, None, None, rel, start, BLK)
    rows = [START + r for r in REL]
    errs["kv_rollback"] = max(
        _max_err(ko[:, :, :, START:START + len(REL)], ref_k[:, :, :, rows]),
        _max_err(vo[:, :, :, START:START + len(REL)], ref_v[:, :, :, rows]))

    # --- the TPU module's on-chip check: deferred against rollback commit -
    if dev.type == "cuda":
        errs["deferred_flash_tokens"] = deferred_vs_rollback(dev)
        errs["tree_attention_gqa"] = gqa_attention_error(dev)
        errs["tree_walk"] = walk_error(dev)
        errs["int8_matmul_wide"] = wide_matmul_error(dev)

    # --- K1: the W8A16 matmul against the dequantized product -------------
    x = t("x")
    wq, ws = quantize_weight(torch.as_tensor(inp["w"], device=dev))
    got = w8a16_matmul(x, wq, ws, out_dtype=torch.float32)
    errs["int8_matmul"] = _max_err(got, x.float() @ (wq.float() * ws))

    if verbose:
        print("kernel selftest:", errs)
    bad = {k: v for k, v in errs.items()
           if k != "backend" and not v <= TOL[k]}
    assert not bad, f"kernel selftest diverged: {bad} (tolerances {TOL})"
    return errs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    print(run_kernel_selftest(args.device, verbose=True))


if __name__ == "__main__":
    main()
