"""The port's kernel ops against their ``lantern_tpu`` counterparts.

On the CPU each op runs its plain PyTorch version; it is held against the
JAX code (Pallas kernels in interpret mode, as the JAX package's own tests
run them) on inputs made from a numpy seed.  Tolerances: f32 1e-5; bf16
compared in f32 at rtol 2e-2.  Tests marked ``cuda`` hold each hand-written
CUDA kernel against its plain version and skip where there is no card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import kv as jkv
from lantern_tpu.ops import quant as jq
from lantern_tpu.ops.pallas import kv_update as jkvu
from lantern_tpu.ops.pallas import tree_attention as jta
from lantern_tpu_torch import kv as tkv
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.convert import to_tensor
from lantern_tpu_torch.engine import spec as tspec
from lantern_tpu_torch.ops import _cuda
from lantern_tpu_torch.ops import acceptance as tacc
from lantern_tpu_torch.ops import quant as tq
from lantern_tpu_torch.ops import sampling as tsmp
from lantern_tpu_torch.ops import tree_attention as tta

F32 = dict(rtol=1e-5, atol=1e-5)


def tt(a):
    return to_tensor(np.asarray(a), "cpu")


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# --------------------------------------------------------------------- K1

def test_quantize_weight_matches_jax():
    w = np.random.default_rng(0).normal(size=(3, 256, 384)).astype(np.float32)
    w[1, :, 5] = 0.0                                  # all-zero channel
    qj, sj = jq.quantize_weight(jnp.asarray(w))
    qt, st = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("M", [2, 38, 64])
def test_int8_matmul_plain_matches_jax_f32(M):
    rng = np.random.default_rng(M)
    x = rng.normal(size=(M, 256)).astype(np.float32)
    q, s = jq.quantize_weight(jnp.asarray(rng.normal(size=(256, 384)) * 0.05,
                                          jnp.float32))
    ref = jq.int8_matmul(jnp.asarray(x), q, s)
    got = tq.int8_matmul(torch.from_numpy(x), tt(q), tt(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    # mm / head_matmul dispatch to the plain version on CPU tensors
    w = {"w_q": tt(q), "w_s": tt(s)}
    np.testing.assert_array_equal(tq.mm(torch.from_numpy(x), w, "w").numpy(),
                                  got.numpy())
    head = tq.head_matmul(torch.from_numpy(x), (tt(q), tt(s)))
    assert head.dtype == torch.float32
    np.testing.assert_allclose(head.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("M", [2, 38])
def test_int8_matmul_plain_matches_pallas_interpret_bf16(M):
    rng = np.random.default_rng(10 + M)
    x = jnp.asarray(rng.normal(size=(M, 256)), jnp.bfloat16)
    q, s = jq.quantize_weight(jnp.asarray(rng.normal(size=(256, 512)) * 0.05,
                                          jnp.float32))
    ref = jq.int8_matmul_pallas(x, q, s, block_n=128, interpret=True)
    got = tq.int8_matmul(tt(x), tt(q), tt(s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(ref), rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------- K2

def _attn_case(seed, B=2, T=8, nh=2, hd=128, S=256, length=137,
               dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.normal(size=(B, T, nh, hd)).astype(dtype) for _ in range(3))
    kc, vc = (rng.normal(size=(B, S, nh, hd)).astype(dtype) for _ in range(2))
    mask = (rng.random((B, T, T)) < 0.4) | np.eye(T, dtype=bool)[None]
    bias = np.zeros((B, S), np.float32)
    bias[1, :7] = tta.NEG_INF                # left-padded uncond row
    return q, kn, vn, kc, vc, length, mask, bias


@pytest.mark.parametrize("length", [0, 1, 137, 256])
def test_tree_attention_plain_matches_reference_f32(length):
    q, kn, vn, kc, vc, L, mask, bias = _attn_case(1, length=length)
    scale = 128 ** -0.5
    ref = jta.tree_attention_reference(*map(jnp.asarray, (q, kn, vn, kc, vc)),
                                       jnp.int32(L), jnp.asarray(mask),
                                       jnp.asarray(bias), scale)
    got = tta.tree_attention_plain(
        *map(torch.from_numpy, (q, kn, vn)),
        tt(jkv.group_cache(jnp.asarray(kc))),
        tt(jkv.group_cache(jnp.asarray(vc))),
        torch.tensor(L, dtype=torch.int32), torch.from_numpy(mask),
        torch.from_numpy(bias), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def _int8_cache(kc):
    """f32 [B, S, nh, hd] -> grouped int8 [B, G, S, W] + scales (JAX)."""
    return jkv.quantize_rows(jkv.group_cache(jnp.asarray(kc)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_attention_plain_matches_pallas_interpret_int8(dtype):
    """int8 KV: the TPU kernel dequantizes the cache (rounded through the
    model dtype) and is handed the fake-quantized block, where the
    dense-fused contract factors the scales out of the dots — the same
    function up to rounding."""
    q, kn, vn, kc, vc, L, mask, bias = _attn_case(2, length=150)
    jdt = jnp.dtype(dtype)
    kq, ks = _int8_cache(kc)
    vq, vs = _int8_cache(vc)

    def fq(x):
        g = jkv.group_blocks(jnp.asarray(x, jdt))
        return jkv.ungroup_blocks(jkv.fake_quant_rows(g)).reshape(x.shape)

    scale = 128 ** -0.5
    ref = jta.tree_attention(
        jnp.asarray(q, jdt), fq(kn), fq(vn), kq, vq, jnp.int32(L),
        jnp.asarray(mask), jnp.asarray(bias), scale, blk=128, interpret=True,
        k_scale=ks, v_scale=vs)
    tdt = getattr(torch, dtype)
    got = tta.tree_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, kn, vn)), tt(kq), tt(vq),
        torch.tensor(L, dtype=torch.int32), torch.from_numpy(mask),
        torch.from_numpy(bias), scale, k_scale=tt(ks), v_scale=tt(vs))
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(got), f32(ref), **tol)


def test_tree_attention_dispatch_uses_plain_on_cpu():
    q, kn, vn, kc, vc, L, mask, bias = _attn_case(3, length=40)
    args = (*map(torch.from_numpy, (q, kn, vn)),
            tt(jkv.group_cache(jnp.asarray(kc))),
            tt(jkv.group_cache(jnp.asarray(vc))),
            torch.tensor(L, dtype=torch.int32), torch.from_numpy(mask),
            torch.from_numpy(bias), 128 ** -0.5)
    np.testing.assert_array_equal(tta.tree_attention(*args).numpy(),
                                  tta.tree_attention_plain(*args).numpy())


# --------------------------------------------------------------------- K3

L_, B_, G_, S_, W_ = 2, 2, 2, 256, 128


def _planes(seed, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        kb = rng.integers(-127, 128, size=(L_, B_, G_, S_, W_)).astype(np.int8)
        vb = rng.integers(-127, 128, size=(L_, B_, G_, S_, W_)).astype(np.int8)
        ks, vs = (rng.random((L_, B_, G_, S_)).astype(np.float32)
                  for _ in range(2))
        return kb, vb, ks, vs
    kb, vb = (rng.normal(size=(L_, B_, G_, S_, W_)).astype(np.float32)
              for _ in range(2))
    return kb, vb, None, None


@pytest.mark.parametrize("T,start", [(1, 0), (1, 201), (5, 13), (5, 251),
                                     (19, 111), (32, 77), (33, 240)])
def test_kv_write_plain_matches_pallas_write_block_int8(T, start):
    """Quantize + write at an unaligned (or clamped: 251 + 5 and 240 + 33 >
    256) start, also 32 and 33 rows (the tree block, and one row more than
    a multiple of the rows the kernel takes a round): the int8 planes
    against write_block(interpret=True) and the scale planes against
    lax.dynamic_update_slice, byte for byte."""
    kb, vb, ks, vs = _planes(T * 1000 + start, "int8")
    rng = np.random.default_rng(start)
    kn = rng.normal(size=(L_, B_, T, G_, W_)).astype(np.float32)
    vn = rng.normal(size=(L_, B_, T, G_, W_)).astype(np.float32)
    kq, kqs = jkv.quantize_rows(jkv.group_blocks(jnp.asarray(kn)))
    vq, vqs = jkv.quantize_rows(jkv.group_blocks(jnp.asarray(vn)))
    s = min(start, S_ - T)
    kj, vj = jkvu.write_block(jnp.asarray(kb), jnp.asarray(vb), kq, vq,
                              jnp.int32(s), interpret=True)
    z = jnp.int32(0)
    ksj = jax.lax.dynamic_update_slice(jnp.asarray(ks), kqs, (z, z, z, jnp.int32(start)))
    vsj = jax.lax.dynamic_update_slice(jnp.asarray(vs), vqs, (z, z, z, jnp.int32(start)))
    planes = [torch.from_numpy(a.copy()) for a in (kb, vb, ks, vs)]
    tkv.write_block(*planes, torch.from_numpy(kn), torch.from_numpy(vn),
                    torch.tensor(start, dtype=torch.int32))
    for got, ref in zip(planes, (kj, vj, ksj, vsj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_kv_write_plain_matches_pallas_write_block_float():
    kb, vb, _, _ = _planes(7, "float32")
    rng = np.random.default_rng(8)
    kn = rng.normal(size=(L_, B_, 5, G_, W_)).astype(np.float32)
    vn = -kn
    kj, vj = jkvu.write_block(jnp.asarray(kb), jnp.asarray(vb),
                              jkv.group_blocks(jnp.asarray(kn)),
                              jkv.group_blocks(jnp.asarray(vn)), jnp.int32(37),
                              interpret=True)
    kt, vt = torch.from_numpy(kb.copy()), torch.from_numpy(vb.copy())
    tkv.write_block(kt, vt, None, None, torch.from_numpy(kn),
                    torch.from_numpy(vn), torch.tensor(37, dtype=torch.int32))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("quantized", [False, True])
def test_kvcache_write_commit_matches_jax(quantized):
    """KVCache.write / commit against the JAX cache (dus path), including
    a provisional write at an offset and an advancing write."""
    from lantern_tpu.configs import ModelConfig as JCfg
    from lantern_tpu_torch.configs import ModelConfig as TCfg

    kw = dict(vocab_size=64, hidden_size=256, num_layers=2, num_heads=2,
              num_kv_heads=2, intermediate_size=256, max_seq_len=150,
              dtype="float32")
    rng = np.random.default_rng(4)
    kn = rng.normal(size=(2, 2, 9, 2, 128)).astype(np.float32)
    vn = (kn * 0.5).astype(np.float32)
    cj = jkv.KVCache.create(JCfg(**kw), 2, quantized=quantized).commit(21)
    cj = cj.write(jnp.asarray(kn), jnp.asarray(vn), advance=False, offset=3)
    cj = cj.write(jnp.asarray(kn), jnp.asarray(vn), advance=True)
    ct = tkv.KVCache.create(TCfg(**kw), 2, quantized=quantized,
                            device="cpu").commit(21)
    ct = ct.write(torch.from_numpy(kn), torch.from_numpy(vn), advance=False,
                  offset=3)
    ct = ct.write(torch.from_numpy(kn), torch.from_numpy(vn), advance=True)
    assert ct.k.shape == cj.k.shape and ct.max_len == 256
    assert int(ct.length) == int(cj.length) == 30
    for a, b in ((ct.k, cj.k), (ct.v, cj.v), (ct.k_scale, cj.k_scale),
                 (ct.v_scale, cj.v_scale)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="offset"):
        ct.write(torch.from_numpy(kn), torch.from_numpy(vn), offset=2)


def _ties_rows():
    """An all-zero row, then rows whose values sit exactly at k + 0.5 of
    their scale: amax 127 gives scale 1, amax 63.5 gives scale 0.5."""
    i = np.arange(128, dtype=np.float32)
    ties = ((i % 126) + 0.5) * (1 - 2 * (i % 2))
    ties[0] = 127.0
    return np.stack([np.zeros(128, np.float32), ties, ties / 2, -ties])


def test_quantize_rows_zero_row_and_ties_match_jax():
    """The two cases the division routine K2 and K3 share must reproduce:
    an all-zero row quantizes to zeros with scale 1/127, and exact ties
    round to the even neighbour, as JAX's quantize_rows does."""
    x = _ties_rows()[None]
    q, s = tkv.quantize_rows(torch.from_numpy(x))
    qj, sj = jkv.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert s[0, 0].item() == np.float32(1) / np.float32(127)
    assert not q[0, 0].any()
    assert s[0, 1].item() == 1.0 and s[0, 2].item() == 0.5
    # -1.5 -> -2, 2.5 -> 2, -3.5 -> -4, 4.5 -> 4, ...
    np.testing.assert_array_equal(q[0, 1].numpy(), np.round(x[0, 1]))
    np.testing.assert_array_equal(q[0, 2].numpy(), np.round(2 * x[0, 2]))
    assert q[0, 1, 2].item() == 2 and q[0, 1, 3].item() == -4


def test_fake_quant_rows_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 3, 7, 128)).astype(np.float32)
    x[0, 1, 2] = 0.0
    np.testing.assert_array_equal(
        tkv.fake_quant_rows(torch.from_numpy(x)).numpy(),
        np.asarray(jkv.fake_quant_rows(jnp.asarray(x))))


def test_ops_reject_mixed_devices():
    from lantern_tpu_torch.ops import _cuda

    with pytest.raises(ValueError, match="mixed"):
        _cuda.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


# --------------------------------------------------------------------- K5

BENCH_TREE = str(Path(__file__).resolve().parents[1] / "ckpts"
                 / "bench_tree_lumina.json")
WALK_LANTERN = {"off": (0, 0.0, None), "delta<=1": (10, 0.003, None),
                "delta>1": (10, 5.0, None), "rt": (10, 5.0, (6, 2.5)),
                "k1000": (1000, 0.1, None),      # generate_images' defaults
                "k1000-rt": (1000, 0.1, (100, 0.3))}
WALK_WARPS = {
    "topk-ties": tsmp.LogitsWarp(temperature=1.0, top_k=2000),
    "top_p-hf": tsmp.LogitsWarp(temperature=0.8, top_k=2000, top_p=0.9),
    "top_p-ar": tsmp.LogitsWarp(temperature=1.2, top_k=1500, top_p=0.85,
                                warp_order="ar")}


def _dynamic_children(rng, n=59, k=10, depth=6):
    """A random EAGLE-2-shaped tree: ``n`` drafted nodes under the root, at
    most ``k`` children a node, at most ``depth`` levels; ``children``
    [n + 1, k] int64 (-1 pads), in slot order."""
    kids = [[] for _ in range(n + 1)]
    lvl = [0]
    for s in range(1, n + 1):
        open_ = [p for p in range(s) if lvl[p] < depth and len(kids[p]) < k]
        p = open_[min(int(rng.integers(0, 3)), len(open_) - 1)
                  if rng.random() < 0.5 else int(rng.integers(len(open_)))]
        kids[p].append(s)
        lvl.append(lvl[p] + 1)
    out = np.full((n + 1, k), -1, np.int64)
    for p, ks in enumerate(kids):
        out[p, :len(ks)] = ks
    return out, max(lvl)


def walk_case(seed, tree, V, multidraft, lantern, warp, device="cpu"):
    """One walk's inputs, drawn from ``seed``: a tree (a library name, the
    bench tree's file or "dynamic"), node tokens with duplicates among
    siblings, logits that favour the drafts and carry ties at the top-k
    threshold, grammar-masked entries, a nearest table that puts high
    tokens among a draft's neighbours (with k over 32, its first k + 1
    drawn from the parent's top 2k, so the budget index passes a warp's
    chunk), and (multi-draft) q with zeros and drafter rows (broadcast views
    on even seeds, as stale drafting makes)."""
    rng = np.random.default_rng(seed)
    if tree == "dynamic":
        children, depth = _dynamic_children(rng)
        level_rows = inlevel = None
    else:
        ts = ttr.get_tree(BENCH_TREE if tree == "bench" else tree)
        children, depth = ts.children.astype(np.int64), ts.max_depth
        level_rows = [1] + [len(lv.child_flat_idx) for lv in ts.levels]
        inlevel = ts.inlevel_rank.astype(np.int64)
    N1 = children.shape[0]
    toks = rng.integers(0, V, size=N1).astype(np.int32)
    for p in range(N1):
        ks = children[p][children[p] >= 0]
        if len(ks) > 2 and rng.random() < 0.3:
            toks[ks[-1]] = toks[ks[0]]                 # a duplicate sibling
    logits = (rng.normal(size=(N1, V)) * 2).astype(np.float32)
    for p in range(N1):
        for s in children[p][children[p] >= 0]:
            logits[p, toks[s]] += rng.choice([0.0, 6.0, 9.0])
        order = np.argsort(-logits[p], kind="stable")
        k = WALK_WARPS["topk-ties"].top_k
        logits[p, order[k - 3:k + 3]] = logits[p, order[k - 1]]
        logits[p, order[-5:]] = tsmp.NEG_INF             # masked entries
    lk, delta, rt = WALK_LANTERN[lantern]
    nearest = rng.integers(0, V, size=(V, max(11, lk + 1))).astype(np.int32)
    for p in range(N1):
        top = np.argsort(-logits[p])[:max(12, 2 * lk)]
        for s in children[p][children[p] >= 0]:
            nearest[toks[s], :6] = rng.permutation(top[:12])[:6]
            if lk > 32:
                nearest[toks[s], :lk + 1] = rng.permutation(top)[:lk + 1]
    lspec = tacc.LanternSpec(lk, delta)

    def t(a):
        return torch.as_tensor(a, device=device)

    kw = dict(nearest=t(nearest), lantern=lspec,
              rt=None if rt is None else lspec.runtime(*rt, device=device))
    if multidraft:
        q = rng.uniform(0.02, 0.9, size=N1).astype(np.float32)
        q[rng.random(N1) < 0.1] = 0.0
        lps = []
        for i, r in enumerate(level_rows):
            row = torch.softmax(t(rng.normal(size=(1 if seed % 2 == 0 else r,
                                                   V)) * 3).float(), -1)
            lps.append(row.expand(r, V) if seed % 2 == 0 else row)
        kw.update(node_q=t(q), level_probs=lps, node_level_row=t(inlevel))
    return (t(logits), t(toks), t(children), depth, WALK_WARPS[warp]), kw


def walk_coins_for(seed, depth, C, coins, device="cpu"):
    u = (np.random.default_rng(seed + 1000).random((depth, C))
         if coins == "random" else np.full((depth, C), coins))
    return torch.as_tensor(u.astype(np.float32), device=device)


@pytest.mark.parametrize("warp", ["topk-ties", "top_p-hf", "top_p-ar",
                                  "greedy"])
def test_keep_threshold_reproduces_warp_logits(warp):
    """K5 keeps ``s >= t`` of the scaled row for ``t = keep_threshold``:
    that must be ``warp_logits`` entry for entry, ties at the top-k cut and
    grammar-masked entries included."""
    (logits, *_), _ = walk_case(3, "chain_bush_8", 4096, False, "off",
                                "topk-ties")
    w = (tsmp.LogitsWarp(temperature=0.0) if warp == "greedy"
         else WALK_WARPS[warp])
    s = logits / w.temperature if w.active else logits
    if w.active:
        w = tsmp.LogitsWarp(1.0, w.top_k, w.top_p, w.warp_order)
    t = tsmp.keep_threshold(s, w)
    want = tsmp.warp_logits(s, w)
    got = torch.where(s >= t[:, None], s, torch.full_like(s, tsmp.NEG_INF))
    assert torch.equal(got, want)


@pytest.mark.parametrize("multidraft,lantern", [
    (False, "off"), (False, "rt"), (True, "delta>1"), (True, "delta<=1"),
    (True, "k1000")])
def test_tree_walk_dispatch_uses_plain_on_cpu(multidraft, lantern):
    _cuda.reset_launches()
    args, kw = walk_case(5, "chain_bush_8", 2048, multidraft, lantern,
                         "topk-ties")
    u = walk_coins_for(5, args[3], args[2].shape[1], "random")
    got = tacc.stochastic_verify_tree(None, *args, uniforms=u, **kw)
    want = tacc.stochastic_verify_tree_plain(*args, u, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _cuda.LAUNCHES["tree_walk"] == 0


@pytest.mark.parametrize("multidraft", [False, True])
def test_accept_draws_the_walks_coins_then_the_bonus(multidraft):
    """``spec.accept`` under a sampling warp draws, from the request's
    generator, ``depth`` rows of ``rand((C,))`` (the walk's coins, which
    the benchmark's replay draws again) and then the bonus draw, and the
    walk decides with those coins."""
    (logits, toks, children, depth, warp), kw = walk_case(
        9, "bench", 4096, multidraft, "delta>1", "topk-ties")
    C = children.shape[1]
    tree = tspec.static_tree(ttr.get_tree(BENCH_TREE), "cpu")
    blk = tspec.TreeBlock(
        tokens=toks, candidates=tree.retrieve, node_q=kw.get("node_q"),
        level_probs=kw.get("level_probs"), children=children,
        inlevel_rank=kw.get("node_level_row"), mask=tree.mask,
        pos=tree.depth, retrieve=tree.retrieve, max_depth=depth)
    ecfg = tspec.SpecDecodeConfig(warp=warp, lantern=kw["lantern"])
    g = torch.Generator().manual_seed(11)
    ctx = tspec._Ctx(params=None, rope=None, nearest=kw["nearest"],
                     prefix_valid=None, pos_offsets=None, logits_mask=None,
                     logits_fn=None, generator=g)
    v = tspec.accept(ecfg, ctx, blk, logits, torch.tensor(0))
    ref = torch.Generator().manual_seed(11)
    coins = torch.stack([torch.rand((C,), generator=ref)
                         for _ in range(depth)])
    path, alen, dist = tacc.stochastic_verify_tree_plain(
        logits, toks, children, depth, warp, coins, **kw)
    bonus = tsmp.categorical(ref, torch.log(torch.clamp(dist, min=1e-30)))
    assert torch.equal(g.get_state(), ref.get_state())
    assert int(v.alen) == int(alen) and int(v.bonus) == int(bonus)
    assert torch.equal(v.sel_slots[: int(alen) + 1],
                       path[: int(alen) + 1].long())


# ------------------------------------------------- CUDA kernels (card only)

def k1_counted(x, q, s, out_dt):
    """One K1 call, asserting its launches: one, of the wide form exactly
    when the call has more than ``K1_NARROW_ROWS`` rows."""
    n0, w0 = _cuda.LAUNCHES["int8_matmul"], _cuda.LAUNCHES["int8_matmul_wide"]
    out = tq.int8_matmul_cuda(x, q, s, out_dt)
    wide = x.shape[0] > tq.K1_NARROW_ROWS
    assert _cuda.LAUNCHES["int8_matmul"] == n0 + 1
    assert _cuda.LAUNCHES["int8_matmul_wide"] == w0 + wide
    return out


def assert_rows_alone(x, q, s, out_dt, got):
    """Every row of ``got`` (one call over ``x``) equals, bit for bit, the
    row computed alone and inside a call of ``K1_NARROW_ROWS`` rows."""
    step = tq.K1_NARROW_ROWS
    narrow = torch.cat([tq.int8_matmul_cuda(x[m:m + step], q, s, out_dt)
                        for m in range(0, x.shape[0], step)])
    assert torch.equal(narrow, got)
    alone = torch.cat([tq.int8_matmul_cuda(x[m:m + 1], q, s, out_dt)
                       for m in range(x.shape[0])])
    assert torch.equal(alone, got)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 22, 38, 64, 65, 130, 512, 513, 3840])
def test_int8_matmul_cuda_matches_plain(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((M, 4096), generator=g, device=cuda).bfloat16()
    q = torch.randint(-127, 128, (4096, 1536), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((1, 1536), generator=g, device=cuda) * 1e-3
    for out_dt in (torch.bfloat16, torch.float32):
        got = k1_counted(x, q, s, out_dt)
        ref = tq.int8_matmul(x, q, s, out_dt)
        np.testing.assert_allclose(f32(got.cpu()), f32(ref.cpu()), rtol=2e-2,
                                   atol=2e-2 * ref.abs().max().item())
        # a row's result does not depend on how many rows share the call
        assert_rows_alone(x, q, s, out_dt, got)


# weight shapes the benchmark's cells run at their verify or prefill rows:
# Lumina-7B's w_gu and w_down (9 k splits), Emu3-Gen's w_down and its head
# (184,622 columns, stored padded, f32 out), LlamaGen-XL's w_down at its
# 3,840-row caption prefill
K1_CELL_SHAPES = {"lumina_w_gu": (513, 4096, 22016),
                  "lumina_w_down": (512, 11008, 4096),
                  "emu3_w_down": (513, 14336, 4096),
                  "xl_w_down": (3840, 3584, 1280),
                  "emu3_head": (512, 4096, 184622)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K1_CELL_SHAPES))
def test_int8_matmul_cuda_cell_shapes(cuda, name):
    M, K, N = K1_CELL_SHAPES[name]
    g = torch.Generator(device=cuda).manual_seed(K + N)
    q = torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    s = (torch.rand((1, N), generator=g, device=cuda) + 0.5) * 2e-4
    q, s = tq.pad_columns(q, s)
    x = torch.randn((M, K), generator=g, device=cuda).bfloat16()
    for out_dt in (torch.bfloat16, torch.float32):
        got = k1_counted(x, q, s, out_dt)
        ref = tq.int8_matmul(x, q, s, out_dt)
        assert got.shape == (M, N)
        np.testing.assert_allclose(f32(got.cpu()), f32(ref.cpu()), rtol=0,
                                   atol=1e-2 * ref.float().abs().max().item())
        assert_rows_alone(x, q, s, out_dt, got)
    if N % tq.K1_COL_MULTIPLE:
        # junk and NaN in the pad columns of the stored head change nothing
        qf, sf = tq._padded_storage(q, s)
        qf[:, N:] = 127
        sf[N:] = float("nan")
        assert torch.equal(k1_counted(x, q, s, torch.float32), got)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,length,quant", [
    (1408, 1, 1300, True), (1408, 19, 0, True), (1408, 32, 777, True),
    (1408, 32, 500, False),
    # a short capacity: one prefix split, no merge between blocks
    (384, 1, 290, True), (384, 32, 155, True)])
def test_tree_attention_cuda_matches_plain(cuda, S, T, length, quant):
    g = torch.Generator(device=cuda).manual_seed(T + length)
    B, G, W = 2, 4, 128
    q, kn, vn = (torch.randn((B, T, G, W), generator=g, device=cuda).bfloat16()
                 for _ in range(3))
    kc = torch.randn((B, G, S, W), generator=g, device=cuda).bfloat16()
    vc = torch.randn((B, G, S, W), generator=g, device=cuda).bfloat16()
    kw = {}
    if quant:
        kc, ks = tkv.quantize_rows(kc)
        vc, vs = tkv.quantize_rows(vc)
        kw = dict(k_scale=ks, v_scale=vs)
    mask = (torch.rand((B, T, T), generator=g, device=cuda) < 0.4) | \
        torch.eye(T, dtype=torch.bool, device=cuda)
    bias = torch.zeros((B, S), device=cuda)
    bias[1, :5] = tta.NEG_INF
    args = (q, kn, vn, kc, vc, torch.tensor(length, dtype=torch.int32,
                                            device=cuda), mask, bias,
            W ** -0.5)
    got = tta.tree_attention_cuda(*args, **kw)
    ref = tta.tree_attention_plain(*args, **kw)
    np.testing.assert_allclose(f32(got.cpu()), f32(ref.cpu()), rtol=2e-2,
                               atol=2e-2 * ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("L,G,T,start,quant,rows", [
    pytest.param(4, 4, 1, 1301, True, "", id="1-1301-True"),
    pytest.param(4, 4, 5, 777, True, "", id="5-777-True"),
    pytest.param(4, 4, 19, 0, True, "", id="19-0-True"),
    pytest.param(4, 4, 5, 3, False, "", id="5-3-False"),
    # the lane shape's 32-row tree block; T off a round's rows
    pytest.param(32, 32, 32, 1301, True, "", id="lane-32"),
    pytest.param(32, 32, 7, 1301, True, "", id="lane-7"),
    pytest.param(32, 32, 33, 1301, True, "", id="lane-33"),
    # the last rows, and a start past S - T (clamped to it)
    pytest.param(4, 4, 5, 1403, True, "", id="start=S-T"),
    pytest.param(4, 4, 7, 1405, True, "", id="start-clamped"),
    pytest.param(4, 4, 5, 777, True, "ties", id="zero-rows-and-ties"),
    # the drafter's bf16 one-layer cache, written at length + block_offset
    pytest.param(1, 32, 3, 1247, False, "", id="drafter-bf16"),
])
def test_kv_write_cuda_matches_plain(cuda, L, G, T, start, quant, rows):
    """K3 against its plain version, byte for byte over random planes (so
    rows outside [start, start+T) must stay as they were)."""
    g = torch.Generator(device=cuda).manual_seed(T)
    B, S, W = 2, 1408, 128
    kn, vn = (torch.randn((L, B, T, G, W), generator=g, device=cuda).bfloat16()
              for _ in range(2))
    if rows:
        ties = torch.from_numpy(_ties_rows()).to(cuda).bfloat16()
        kn[:, :, :4] = ties[None, None, :, None]
        vn[:, :, :4] = -ties[None, None, :, None]
    if quant:
        planes = [torch.randint(-127, 128, (L, B, G, S, W), generator=g,
                                device=cuda, dtype=torch.int8)
                  for _ in range(2)]
        planes += [torch.rand((L, B, G, S), generator=g, device=cuda)
                   for _ in range(2)]
    else:
        planes = [torch.randn((L, B, G, S, W), generator=g, device=cuda)
                  .bfloat16() for _ in range(2)] + [None, None]
    ref = [None if p is None else p.clone() for p in planes]
    st = torch.tensor(start, dtype=torch.int32, device=cuda)
    tkv.write_block_cuda(*planes, kn, vn, st)
    tkv.write_block_plain(*ref, kn, vn, st)
    for a, b in zip(planes, ref):
        if b is not None:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# the walk's cases on the card: (tree, V, multi-draft, LANTERN, warp, coins)
K5_CASES = [
    ("bench", 65536, True, "delta>1", "topk-ties", "random"),   # the cell's
    ("bench", 65536, True, "delta>1", "topk-ties", 0.0),
    ("bench", 65536, True, "delta>1", "topk-ties", 1.0),
    ("bench", 65536, False, "off", "topk-ties", "random"),
    ("bench", 65536, True, "delta<=1", "top_p-hf", "random"),
    ("bench", 65536, True, "rt", "top_p-ar", "random"),
    ("bench", 16384, True, "off", "top_p-hf", 1.0),
    ("chain_bush_8", 16384, True, "delta>1", "top_p-ar", "random"),
    ("chain_bush_8", 16384, False, "delta<=1", "topk-ties", "random"),
    ("chain_bush_8", 65536, False, "rt", "topk-ties", 0.0),
    ("chain_bush_8", 65536, True, "rt", "topk-ties", 1.0),
    ("dynamic", 16384, False, "delta>1", "topk-ties", "random"),
    ("dynamic", 16384, False, "off", "top_p-hf", 0.0),
    ("dynamic", 16384, False, "rt", "top_p-ar", 1.0),
    ("dynamic", 65536, False, "delta<=1", "topk-ties", "random"),
    ("bench", 65536, True, "k1000", "topk-ties", "random"),
    ("bench", 16384, True, "k1000", "top_p-hf", "random"),
    ("dynamic", 65536, False, "k1000", "topk-ties", "random"),
    ("dynamic", 16384, False, "k1000", "top_p-ar", "random"),
    ("chain_bush_8", 65536, True, "k1000-rt", "topk-ties", "random"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tree,V,multidraft,lantern,warp,coins", K5_CASES,
                         ids=["-".join(map(str, c)) for c in K5_CASES])
def test_tree_walk_cuda_matches_plain(cuda, tree, V, multidraft, lantern,
                                      warp, coins):
    """K5 against the plain walk on the card, under the same pinned coins,
    over three seeds: the accepted slots and their count equal, the bonus
    distribution within 1e-5 (f32 sums in another order)."""
    for seed in range(3):
        args, kw = walk_case(seed, tree, V, multidraft, lantern, warp, cuda)
        u = walk_coins_for(seed, args[3], args[2].shape[1], coins, cuda)
        n0 = _cuda.LAUNCHES["tree_walk"]
        path, alen, dist = tacc.stochastic_verify_tree(None, *args,
                                                       uniforms=u, **kw)
        assert _cuda.LAUNCHES["tree_walk"] == n0 + 1
        rp, ra, rd = tacc.stochastic_verify_tree_plain(*args, u, **kw)
        a = int(alen)
        assert a == int(ra), (seed, a, int(ra))
        assert torch.equal(path[: a + 1].cpu(), rp[: a + 1].cpu()), seed
        err = float((dist - rd).abs().max())
        assert err <= 1e-5, (seed, err)
