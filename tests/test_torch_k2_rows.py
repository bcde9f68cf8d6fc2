"""Long blocks through K2, and the grid-sizing helpers of K2 and K1.

On the CPU: ``tree_attention_plain`` at T = 96 and 200 against the JAX
dense-fused math (f32 against ``tree_attention_reference``, an int8 cache
against the Pallas kernel in interpret mode, as the T <= 32 tests of
``tests/test_torch_kernels.py`` take it); a 100-token prompt through the
port's ``forward`` and AR loop token-exact against ``lantern_tpu``; the
split helpers as plain functions.  Tolerances: f32 1e-5; bf16 compared in
f32 at rtol 2e-2.  Tests marked ``cuda`` hold the CUDA kernels against
their plain versions at the shapes of the decode lane and skip where there
is no card.  Inputs come from numpy seeds; torch runs on one thread.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu import kv as jkv
from lantern_tpu.engine import ar as jar
from lantern_tpu.models import chameleon as jcham
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops.pallas import tree_attention as jta
from lantern_tpu.ops.sampling import LogitsWarp as JWarp
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch import kv as tkv
from lantern_tpu_torch.convert import to_tensor
from lantern_tpu_torch.engine import ar as tar
from lantern_tpu_torch.models import chameleon as tcham
from lantern_tpu_torch.ops import _cuda
from lantern_tpu_torch.ops import quant as tq
from lantern_tpu_torch.ops import tree_attention as tta
from lantern_tpu_torch.ops.sampling import LogitsWarp as TWarp

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
SMS = 132                                       # an H100 SXM

# (K, N) of every K1 product of the Lumina-7B lane, and its row counts
K1_LANE = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w_gu": (4096, 22016),
           "w_down": (11008, 4096), "lm_head": (4096, 65536),
           "fc_w": (8192, 4096)}


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


def _case(seed, T, length, B=2, nh=2, hd=128, S=256):
    """A causal block of T rows (a prompt's prefill) after ``length``
    prefix rows, with a left-padded second batch row."""
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.normal(size=(B, T, nh, hd)).astype(np.float32)
                 for _ in range(3))
    kc, vc = (rng.normal(size=(B, S, nh, hd)).astype(np.float32)
              for _ in range(2))
    mask = np.broadcast_to(np.tril(np.ones((T, T), bool)), (B, T, T)).copy()
    mask[1, :, :3] = False                   # pads inside the block
    mask[1, :3, :3] = np.eye(3, dtype=bool)
    bias = np.zeros((B, S), np.float32)
    bias[1, :7] = tta.NEG_INF
    return q, kn, vn, kc, vc, length, mask, bias


# ------------------------------------------------- K2's plain version, long T

@pytest.mark.parametrize("length", [0, 137])
@pytest.mark.parametrize("T", [96, 200])
def test_tree_attention_plain_long_block_matches_reference_f32(T, length):
    q, kn, vn, kc, vc, L, mask, bias = _case(T + length, T, length)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [0, 137])
@pytest.mark.parametrize("T", [96, 200])
def test_tree_attention_plain_long_block_matches_pallas_interpret_int8(
        T, length, dtype):
    """int8 KV at T > 64, the rows the card's kernel used to refuse: the
    TPU kernel (T <= 512) dequantizes the cache and is handed the
    fake-quantized block; the dense-fused contract factors the scales out
    of the dots: the same function up to rounding."""
    q, kn, vn, kc, vc, L, mask, bias = _case(1000 + T + length, T, length)
    jdt = jnp.dtype(dtype)
    kq, ks = jkv.quantize_rows(jkv.group_cache(jnp.asarray(kc)))
    vq, vs = jkv.quantize_rows(jkv.group_cache(jnp.asarray(vc)))

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
    np.testing.assert_allclose(f32(got), f32(ref),
                               **(F32 if dtype == "float32" else BF16))


# ------------------------------------------- a 100-token prompt, end to end

V = 8832
GRID = 4
MAX_NEW = GRID * (GRID + 1) + 1
LONG_TEXT = [60 + (7 * i) % 40 for i in range(100)]
KW = dict(vocab_size=V, hidden_size=256, num_layers=2, num_heads=2,
          rope_kind="1d", cond_kind="none", qk_norm=True, swin_norm=True,
          max_seq_len=160)


@pytest.mark.parametrize("kvq", [False, True])
def test_ar_long_prompt_token_exact(kvq):
    """103 prompt rows (T > 64) through the port's forward and AR loop:
    the same tokens as ``lantern_tpu`` commits, legal under the FSM."""
    cfg_j, cfg_t = jc.tiny_config(**KW), tc.tiny_config(**KW)
    pj = jtfm.fuse_params(jtfm.init_params(jax.random.key(0), cfg_j))
    pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
    fkw = dict(w=GRID, h=GRID, image_start_idx=len(LONG_TEXT), vocab_size=V)
    rj = jar.generate_tokens(
        pj, cfg_j, jcham.lumina_token_prompt(LONG_TEXT, grid=(GRID, GRID)),
        MAX_NEW, 3.0, JWarp(temperature=0.0), jax.random.key(0),
        logits_fn=jcham.LuminaGridFSM(**fkw), kv_quant=kvq)
    rt = tar.generate_tokens(
        pt, cfg_t, tcham.lumina_token_prompt(LONG_TEXT, grid=(GRID, GRID)),
        MAX_NEW, 3.0, TWarp(temperature=0.0), None,
        logits_fn=tcham.LuminaGridFSM(**fkw), kv_quant=kvq, device="cpu")
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    toks = [int(t) for t in rt.tokens]
    for i, t in enumerate(toks[:-1]):
        if i % (GRID + 1) == GRID:
            assert t == tcham.LUMINA_NEWLINE_ID, (i, t)
        else:
            assert tcham.IMAGE_TOKEN_START <= t <= tcham.IMAGE_TOKEN_END, (i, t)
    assert toks[-1] == tcham.IMAGE_END_ID
    assert rt.kv.length.tolist() == [int(rj.kv.length)] * 2


# ------------------------------------------------------- the split helpers

@pytest.mark.parametrize("S,T", [(2560, 1), (2560, 3), (2560, 5), (2560, 19),
                                 (2560, 32), (384, 1), (384, 32), (384, 203),
                                 (2560, 512)])
def test_k2_splits_fill_the_card(S, T):
    """Main-path shapes (B=2, G=32): the most splits that keep the grid in
    one wave of ``K2_BLOCKS_PER_SM`` blocks an SM and every split at least
    ``K2_SPLIT_MIN_ROWS`` rows of capacity; at the long capacity that is
    more than one block an SM."""
    n = tta.k2_splits(2, 32, S, T, SMS)
    base = 2 * 32 * -(-T // tta.k2_rows(T))
    wave = tta.K2_BLOCKS_PER_SM * SMS
    cap = min(S // tta.K2_SPLIT_MIN_ROWS, tta.K2_MAX_SPLIT)
    assert 1 <= n <= max(1, cap)
    if n > 1:
        assert base * n <= wave
    # one more split would leave the wave or the capacity
    assert base * (n + 1) > wave or n + 1 > cap
    if S == 2560:
        assert base * n > SMS


@pytest.mark.parametrize("nsplit", [1, 2, 4, 7, 32])
@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 137, 1237, 2371, 2560])
def test_k2_split_tiles_cover_the_prefix_once(length, nsplit):
    shares = tta.k2_split_tiles(length, nsplit)
    assert len(shares) == nsplit
    covered = [t for a, b in shares for t in range(a, b)]
    assert covered == list(range(-(-length // tta.K2_TILE_KEYS)))
    sizes = [b - a for a, b in shares]
    assert max(sizes) - min(sizes) <= 1


def test_k2_splits_small_grids():
    assert tta.k2_splits(2, 4, 1408, 5, SMS) == 1408 // tta.K2_SPLIT_MIN_ROWS
    assert tta.k2_splits(2, 4, 16384, 5, SMS) == tta.K2_MAX_SPLIT
    assert tta.k2_splits(2, 32, 64, 1, SMS) == 1        # one tile of capacity
    assert tta.k2_splits(64, 32, 2560, 32, SMS) == 1    # the grid is full
    assert tta.k2_splits(2, 32, 2560, 1, 2 * SMS) == 8  # a card twice as wide
    assert tta.k2_rows(1) == tta.k2_rows(16) == 16
    assert tta.k2_rows(17) == tta.k2_rows(512) == 32


@pytest.mark.parametrize("name", sorted(K1_LANE))
def test_k1_splits_fill_the_card(name):
    """Every (K, N) of the lane: the fewest splits that reach 2 blocks an SM,
    none under ``K1_SPLIT_MIN_ROWS`` k rows (which leaves the N = 4096
    shapes about a block an SM); every stage of the k range in exactly one
    split, no split empty."""
    K, N = K1_LANE[name]
    n = tq.k1_splits(K, N, SMS)
    tiles = -(-N // tq.K1_TILE_COLS)
    cap = K // tq.K1_SPLIT_MIN_ROWS
    assert 1 <= n <= cap
    assert tiles * n >= tq.K1_BLOCKS_PER_SM * SMS or n == cap
    assert n == 1 or tiles * (n - 1) < tq.K1_BLOCKS_PER_SM * SMS
    assert tiles * n >= 0.9 * SMS
    shares = tq.k1_split_stages(K, n)
    covered = [s for a, b in shares for s in range(a, b)]
    assert covered == list(range(-(-K // tq.K1_STAGE_ROWS)))
    assert all(b - a >= tq.K1_SPLIT_MIN_ROWS // tq.K1_STAGE_ROWS
               for a, b in shares)
    assert max(b - a for a, b in shares) - min(b - a for a, b in shares) <= 1


def test_k1_splits_do_not_see_the_rows():
    """A row's sums must not depend on the row count: the split count is a
    function of (K, N) and the card, and the wrapper's launches of 1..130
    rows all use it."""
    import inspect

    assert list(inspect.signature(tq.k1_splits).parameters) == ["K", "N", "sms"]
    assert tq.k1_splits(256, 512, SMS) == 1             # a short k range
    assert tq.k1_splits(4096, 1536, SMS) == 4           # capped by the k range
    assert tq.k1_splits(4096, 65536, SMS) == 1
    assert tq.k1_split_stages(4096 + 8, 3)[-1][1] == 65   # a ragged last stage


@pytest.mark.parametrize("M,form", [(1, "narrow"), (64, "narrow"),
                                    (65, "wide"), (512, "wide")])
def test_k1_form_from_the_row_count(M, form):
    """K1's form is a function of the call's rows alone: the narrow kernel
    up to ``K1_NARROW_ROWS``, the wide one above."""
    assert tq.k1_form(M) == form


def test_k1_wide_launches_are_counted_and_reset():
    assert {"int8_matmul", "int8_matmul_wide"} <= set(_cuda.LAUNCHES)
    _cuda.LAUNCHES["int8_matmul"] += 2
    _cuda.LAUNCHES["int8_matmul_wide"] += 1
    _cuda.reset_launches()
    assert _cuda.LAUNCHES["int8_matmul"] == 0
    assert _cuda.LAUNCHES["int8_matmul_wide"] == 0


# ------------------------------------------------- CUDA kernels (card only)

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K1_LANE))
def test_int8_matmul_cuda_lane_shapes(cuda, name):
    K, N = K1_LANE[name]
    g = torch.Generator(device=cuda).manual_seed(K + N)
    q = torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    s = (torch.rand((1, N), generator=g, device=cuda) + 0.5) * 2e-4
    x = torch.randn((130, K), generator=g, device=cuda).bfloat16()
    one = tq.int8_matmul_cuda(x[:1], q, s, torch.float32)
    # every width of the kernel's instruction: M <= 8, 16, 32 and 64 rows
    for M in (1, 2, 10, 22, 32, 38, 64, 130):
        for out_dt in (torch.bfloat16, torch.float32):
            got = tq.int8_matmul_cuda(x[:M], q, s, out_dt)
            ref = tq.int8_matmul(x[:M], q, s, out_dt)
            np.testing.assert_allclose(
                f32(got.cpu()), f32(ref.cpu()), rtol=0,
                atol=1e-2 * ref.float().abs().max().item())
        # a row's result does not depend on how many rows share the launch
        assert torch.equal(got[0], one[0])
    # nor on the rows before it: row 64 of the 130-row call (the wide form)
    assert torch.equal(tq.int8_matmul_cuda(x[64:65], q, s, torch.float32)[0],
                       got[64])
    # and every row of a narrower launch equals its row of the 64-row one
    for M in (10, 22):
        assert torch.equal(tq.int8_matmul_cuda(x[:M], q, s, torch.float32),
                           got[:M])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("window", [0, 10])
@pytest.mark.parametrize("T", [1, 5, 32, 65, 96, 512])
@pytest.mark.parametrize("S", [384, 2560])
def test_tree_attention_cuda_rows_and_windows(cuda, S, T, window, quant):
    g = torch.Generator(device=cuda).manual_seed(S + T + window)
    B, G, W = 2, 4, 128
    length = min(S - T - window, 1237) if T <= 96 else 0
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
    if window:
        kw["window_mask"] = torch.rand((B, T, window), generator=g,
                                       device=cuda) < 0.5
    bias = torch.zeros((B, S), device=cuda)
    bias[1, :5] = tta.NEG_INF
    args = (q, kn, vn, kc, vc, torch.tensor(length, dtype=torch.int32,
                                            device=cuda), mask, bias,
            W ** -0.5)
    got = tta.tree_attention_cuda(*args, **kw)
    again = tta.tree_attention_cuda(*args, **kw)     # the tickets were reset
    ref = tta.tree_attention_plain(*args, **kw)
    assert torch.equal(got, again)
    np.testing.assert_allclose(f32(got.cpu()), f32(ref.cpu()), rtol=0,
                               atol=2e-2 * ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 32, 200])
def test_tree_attention_cuda_quantizes_block_rows_exactly(cuda, T):
    """With only itself visible to a row, its output is one term,
    bf16(v_scale) * v_int8: the kernel's quantization of the block's rows
    must match ``kv.quantize_rows`` bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(T)
    B, G, W, S = 2, 4, 128, 384
    q, kn, vn = (torch.randn((B, T, G, W), generator=g, device=cuda).bfloat16()
                 for _ in range(3))
    vn[0, 0, 0] = 0                                   # an all-zero row
    kc, ks = tkv.quantize_rows(
        torch.randn((B, G, S, W), generator=g, device=cuda).bfloat16())
    eye = torch.eye(T, dtype=torch.bool, device=cuda)[None].expand(B, T, T)
    args = (q, kn, vn, kc, kc, torch.zeros((), dtype=torch.int32, device=cuda),
            eye, torch.zeros((B, S), device=cuda), W ** -0.5)
    got = tta.tree_attention_cuda(*args, k_scale=ks, v_scale=ks)
    ref = tta.tree_attention_plain(*args, k_scale=ks, v_scale=ks)
    assert torch.equal(got, ref)
