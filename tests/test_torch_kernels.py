"""The port's three kernel ops against their ``lantern_tpu`` counterparts.

On the CPU each op runs its plain PyTorch version; it is held against the
JAX code (Pallas kernels in interpret mode, as the JAX package's own tests
run them) on inputs made from a numpy seed.  Tolerances: f32 1e-5; bf16
compared in f32 at rtol 2e-2.  Tests marked ``cuda`` hold each hand-written
CUDA kernel against its plain version and skip where there is no card.
"""

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
from lantern_tpu_torch.convert import to_tensor
from lantern_tpu_torch.ops import quant as tq
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


# ------------------------------------------------- CUDA kernels (card only)

@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 22, 38, 64, 130])
def test_int8_matmul_cuda_matches_plain(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((M, 4096), generator=g, device=cuda).bfloat16()
    q = torch.randint(-127, 128, (4096, 1536), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((1, 1536), generator=g, device=cuda) * 1e-3
    for out_dt in (torch.bfloat16, torch.float32):
        got = tq.int8_matmul_cuda(x, q, s, out_dt)
        ref = tq.int8_matmul(x, q, s, out_dt)
        np.testing.assert_allclose(f32(got.cpu()), f32(ref.cpu()), rtol=2e-2,
                                   atol=2e-2 * ref.abs().max().item())
    # a row's result does not depend on how many rows share the launch
    one = tq.int8_matmul_cuda(x[:1], q, s, torch.float32)
    np.testing.assert_array_equal(one.cpu().numpy(),
                                  tq.int8_matmul_cuda(x, q, s, torch.float32)[:1].cpu().numpy())


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
