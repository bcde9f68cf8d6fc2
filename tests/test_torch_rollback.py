"""The rollback path's ops against their ``lantern_tpu`` counterparts on the
CPU: the tree-rollback gather (K4) and ``KVCache.accept_path``, the
provisional window of the tree attention (K2) and of ``forward``, and the
EAGLE drafter (``fuse_inputs``, ``extend``, ``draft_static``).

Inputs come from a numpy seed.  Row moves are compared byte for byte (the
Pallas kernel runs in interpret mode, as ``tests/test_kv_write.py`` runs
it); f32 activations at 1e-5 (logits 1e-4).  Tests marked ``cuda`` hold the
hand-written kernels against their plain versions and skip where there is
no card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu import kv as jkv
from lantern_tpu import trees as jt
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops import quant as jq
from lantern_tpu.ops import sampling as jsmp
from lantern_tpu.ops.pallas import kv_update as jkvu
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch import kv as tkv
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.convert import to_tensor
from lantern_tpu_torch.models import drafter as tdrf
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.ops import quant as tq
from lantern_tpu_torch.ops import sampling as tsmp
from lantern_tpu_torch.ops import tree_attention as tta

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
TREE = "ckpts/bench_tree_lumina.json"
V = 8832


def tt(a):
    return to_tensor(np.asarray(a), "cpu")


def raw(a):
    """Bytes of a tensor or array, for exact comparison of any dtype."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "bfloat16" else a


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_kw(**kw):
    base = dict(vocab_size=V, hidden_size=256, num_layers=2, num_heads=2,
                rope_kind="1d", cond_kind="none", qk_norm=True,
                swin_norm=True, max_seq_len=160)
    base.update(kw)
    return base


# --------------------------------------------------------------------- K4

def _gather_planes(rng, dtype, L=2, B=3, G=2, S=192, W=128):
    if dtype == "int8":
        kb = rng.integers(-127, 128, size=(L, B, G, S, W)).astype(np.int8)
        vb = rng.integers(-127, 128, size=(L, B, G, S, W)).astype(np.int8)
        return jnp.asarray(kb), jnp.asarray(vb)
    kb = rng.normal(size=(L, B, G, S, W)).astype(np.float32)
    return jnp.asarray(kb, dtype), jnp.asarray(-kb * 0.5, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("start,blk,A", [
    pytest.param(0, 57, 6, id="0-57"), pytest.param(13, 16, 6, id="13-16"),
    pytest.param(111, 5, 5, id="111-5"), pytest.param(135, 57, 6, id="135-57"),
    pytest.param(160, 32, 6, id="160-32"),
    pytest.param(37, 24, 1, id="A=1"), pytest.param(64, 32, 32, id="A=blk")])
def test_gather_write_block_plain_matches_pallas_interpret(dtype, start, blk,
                                                           A):
    """``buf[start + j] = buf[start + rel[j]]``, unaligned starts, windows
    that are no tile multiples, overlapping sources and destinations; one
    accepted row, and every row of the block moved (A = blk)."""
    rng = np.random.default_rng(start * 100 + blk)
    kb, vb = _gather_planes(rng, dtype)
    if A == blk:            # one cycle through the block: no row stays
        p = rng.permutation(blk)
        rel = np.empty(blk, np.int32)
        rel[p] = np.roll(p, -1)
        assert (rel != np.arange(blk)).all()
    else:
        rel = rng.integers(0, blk, size=(A,)).astype(np.int32)
    kj, vj = jkvu.gather_write_block(kb, vb, jnp.asarray(rel),
                                     jnp.int32(start), blk, interpret=True)
    kt, vt = tt(kb), tt(vb)
    tkv.gather_write_block(kt, vt, None, None, torch.from_numpy(rel),
                           torch.tensor(start, dtype=torch.int32), blk)
    np.testing.assert_array_equal(raw(kt), raw(kj))
    np.testing.assert_array_equal(raw(vt), raw(vj))


def slots_to_rows(a, R):
    """JAX's slot-major stacked planes ``[R * layers, 2, ...]`` (the
    batched engine's ``custom_vmap`` layout) -> the port's ``[layers, 2R,
    ...]``, slot ``r`` on batch rows ``2r`` and ``2r + 1``."""
    a = np.asarray(a)
    layers = a.shape[0] // R
    a = a.reshape((R, layers) + a.shape[1:]).swapaxes(0, 1)
    return a.reshape((layers, R * a.shape[2]) + a.shape[3:])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gather_write_block_plain_per_slot_matches_pallas_interpret(dtype):
    """R = 3 request slots, each with its own start and accepted path: the
    JAX kernel folds the slots into the plane axis (``start [R]``, ``rel
    [R, A]``); the port folds them into the batch axis (``start [2R]``,
    ``rel [2R, A]``, each slot's repeated for its two rows).  Byte for
    byte, a start past ``S - blk`` and pads outside the block included: the
    JAX kernel takes them clamped, as ``KVCache.accept_path`` clamps ``rel``
    and ``dynamic_update_slice`` a start; the port clamps them itself."""
    rng = np.random.default_rng(5)
    R, layers, blk, S = 3, 2, 24, 192
    kb, vb = _gather_planes(rng, dtype, L=R * layers, B=2, S=S)
    starts = np.asarray([0, 13, 180], np.int32)       # 180 + 24 > 192
    rels = np.asarray([[2, 0, 5, 23], [0, 1, 2, 3], [23, 11, 40, -2]],
                      np.int32)
    kj, vj = jkvu.gather_write_block(
        kb, vb, jnp.asarray(np.clip(rels, 0, blk - 1)),
        jnp.asarray(np.clip(starts, 0, S - blk)), blk, interpret=True)
    kt, vt = (tt(slots_to_rows(x, R)) for x in (kb, vb))
    tkv.gather_write_block(
        kt, vt, None, None, torch.from_numpy(rels).repeat_interleave(2, 0),
        torch.from_numpy(starts).repeat_interleave(2), blk)
    np.testing.assert_array_equal(raw(kt), raw(tt(slots_to_rows(kj, R))))
    np.testing.assert_array_equal(raw(vt), raw(tt(slots_to_rows(vj, R))))


def test_gather_write_block_rejects_bad_arguments():
    kb = torch.zeros((4, 2, 1, 64, 128))
    st = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows > blk"):
        tkv.gather_write_block(kb, kb.clone(), None, None,
                               torch.zeros(9, dtype=torch.int32), st, 8)
    with pytest.raises(ValueError, match=r"start must be \[\] or \[2\]"):
        tkv.gather_write_block(kb, kb.clone(), None, None,
                               torch.zeros((3, 2), dtype=torch.int32),
                               torch.zeros(3, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match=r"rel must be \[A\] or \[2, A\]"):
        tkv.gather_write_block(kb, kb.clone(), None, None,
                               torch.zeros((3, 2), dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="blk=65"):
        tkv.gather_write_block(kb, kb.clone(), None, None,
                               torch.zeros(2, dtype=torch.int32), st, 65)


def test_k4_staging_rule():
    """K4 stages a window's rows in registers (1, 2, 4 or 8 chunks of 16
    bytes a lane a tensor) when A <= 32 and they fit, else in a warp's slice
    of shared memory."""
    assert tkv.k4_staging(5, 128) == 2        # the lane's int8 path
    assert tkv.k4_staging(5, 256) == 4        # bf16
    assert tkv.k4_staging(5, 512) == 8        # f32
    assert tkv.k4_staging(1, 128) == 1
    assert tkv.k4_staging(32, 128) == 8       # int8, A = blk = 32
    assert tkv.k4_staging(32, 256) == 0       # bf16, A = blk = 32
    assert tkv.k4_staging(33, 16) == 0
    for A in range(1, 40):
        for row_bytes in (16, 64, 128, 256, 512):
            rc = tkv.k4_staging(A, row_bytes)
            assert rc in (0,) + tkv.K4_REG_CHUNKS
            if rc:
                assert A <= 32 and A * row_bytes <= 32 * 16 * rc
            else:
                assert A > 32 or A * row_bytes > 32 * 16 * 8


def test_gather_write_block_cuda_rejects_oversized_staging():
    """The shared-memory slice of one warp holds up to 227 KB of rows and
    scales (the old kernel's block took 48 KB); the wrapper refuses more
    before it builds or launches anything."""
    kb = torch.zeros((1, 1, 1, 512, 128))
    st = torch.tensor(0, dtype=torch.int32)
    A = tkv.K4_MAX_STAGE_BYTES // (128 * 4 + 4) + 1
    with pytest.raises(ValueError, match="staging slice"):
        tkv.gather_write_block_cuda(kb, kb.clone(), None, None,
                                    torch.zeros(A, dtype=torch.int32), st, A)


def test_gather_write_block_reads_before_it_writes():
    """Pads that point below their own row: every source is the ORIGINAL
    row, not one an earlier j already overwrote."""
    kb = torch.arange(8, dtype=torch.float32)[None, None, None, :, None] \
        .expand(1, 1, 1, 8, 128).contiguous()
    rel = torch.tensor([0, 3, 7, 1, 2], dtype=torch.int32)
    vb = kb.clone()
    tkv.gather_write_block(kb, vb, None, None, rel,
                           torch.tensor(0, dtype=torch.int32), 8)
    assert kb[0, 0, 0, :, 0].tolist() == [0, 3, 7, 1, 2, 5, 6, 7]
    assert torch.equal(kb, vb)


@pytest.mark.parametrize("mode", ["never", "interpret"])
@pytest.mark.parametrize("quantized", [False, True])
def test_accept_path_matches_jax(mode, quantized):
    """``KVCache.accept_path`` against the JAX cache: its take + write path
    (``PALLAS_WRITE = "never"``) and its fused Pallas kernel in interpret
    mode; an int8 cache moves its scale rows from the same index, and pads
    past ``block_size`` are clamped for rows and scales alike."""
    kw = dict(vocab_size=64, hidden_size=256, num_layers=2, num_heads=2,
              num_kv_heads=2, intermediate_size=256, max_seq_len=192,
              dtype="float32")
    BLK = 24
    rng = np.random.default_rng(3)
    kn = rng.normal(size=(2, 2, BLK, 2, 128)).astype(np.float32)
    vn = (kn * 0.5).astype(np.float32)
    prev = jkv.PALLAS_WRITE
    try:
        jkv.PALLAS_WRITE = mode
        for length, rel in ((0, [2, 0, 5, 23]), (13, [0, 1, 2, 3]),
                            (112, [23, 11, 7, 0]), (77, [0, 4, 30, 99])):
            cj = jkv.KVCache.create(jc.ModelConfig(**kw), 2,
                                    quantized=quantized).commit(length)
            cj = cj.write(jnp.asarray(kn), jnp.asarray(vn), advance=False)
            cj = cj.accept_path(jnp.asarray(rel, jnp.int32), jnp.int32(3),
                                block_size=BLK)
            ct = tkv.KVCache.create(tc.ModelConfig(**kw), 2,
                                    quantized=quantized,
                                    device="cpu").commit(length)
            ct = ct.write(torch.from_numpy(kn), torch.from_numpy(vn),
                          advance=False)
            ct = ct.accept_path(torch.tensor(rel, dtype=torch.int32),
                                torch.tensor(3, dtype=torch.int32),
                                block_size=BLK)
            assert int(ct.length) == int(cj.length) == length + 3
            for a, b in ((ct.k, cj.k), (ct.v, cj.v),
                         (ct.k_scale, cj.k_scale), (ct.v_scale, cj.v_scale)):
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    finally:
        jkv.PALLAS_WRITE = prev


# ----------------------------------------------------- K2: provisional window

def test_tree_attention_plain_window_matches_dense_mask():
    """The window form equals attention over a longer committed prefix whose
    per-row visibility is spelled out: rows ``length + u`` with
    ``window_mask[t, u]`` false are the only difference, so hiding them
    through the bias of a one-row block must give the same numbers."""
    rng = np.random.default_rng(0)
    B, T, nh, hd, S, length, win = 2, 4, 2, 128, 128, 37, 6
    q, kn, vn = (torch.from_numpy(rng.normal(size=(B, T, nh, hd))
                                  .astype(np.float32)) for _ in range(3))
    kc, vc = (torch.from_numpy(rng.normal(size=(B, nh, S, hd))
                               .astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy((rng.random((B, T, T)) < 0.5)
                            | np.eye(T, dtype=bool)[None])
    wmask = torch.from_numpy(rng.random((B, T, win)) < 0.5)
    bias = torch.zeros((B, S))
    bias[1, :5] = tta.NEG_INF
    ln = torch.tensor(length, dtype=torch.int32)
    got = tta.tree_attention(q, kn, vn, kc, vc, ln, mask, bias, hd ** -0.5,
                             window_mask=wmask)
    for b in range(B):
        for t in range(T):
            bt = bias[b: b + 1].clone()
            bt[0, length: length + win][~wmask[b, t]] = tta.NEG_INF
            # row t alone sees block rows under its own mask row: move them
            # behind the window as further cache rows
            kc2, vc2 = kc[b: b + 1].clone(), vc[b: b + 1].clone()
            lo = length + win
            kc2[0, :, lo: lo + T] = kn[b].transpose(0, 1)
            vc2[0, :, lo: lo + T] = vn[b].transpose(0, 1)
            bt[0, lo: lo + T][~mask[b, t]] = tta.NEG_INF
            bt[0, lo + t] = tta.NEG_INF          # the row itself is the block
            ref = tta.tree_attention_plain(
                q[b: b + 1, t: t + 1], kn[b: b + 1, t: t + 1],
                vn[b: b + 1, t: t + 1], kc2, vc2,
                torch.tensor(lo + T, dtype=torch.int32),
                mask[b: b + 1, t: t + 1, t: t + 1], bt, hd ** -0.5)
            np.testing.assert_allclose(got[b, t].numpy(), ref[0, 0].numpy(),
                                       **F32)
    none = tta.tree_attention(q, kn, vn, kc, vc, ln, mask, bias, hd ** -0.5)
    zero = tta.tree_attention(q, kn, vn, kc, vc, ln, mask, bias, hd ** -0.5,
                              window_mask=torch.zeros((B, T, win),
                                                      dtype=torch.bool))
    np.testing.assert_array_equal(none.numpy(), zero.numpy())
    assert not np.allclose(none.numpy(), got.numpy(), atol=1e-3)


@pytest.mark.parametrize("kvq", [False, True])
def test_forward_write_offset_window_matches_jax(kvq):
    """A draft-tree level: the block is written at ``length + off`` and sees
    the earlier level's provisional rows under the ancestor mask.  JAX
    spells the visibility as a dense ``prefix_override``."""
    cfg_j, cfg_t = jc.tiny_config(**tiny_kw()), tc.tiny_config(**tiny_kw())
    pj = jtfm.fuse_params(jtfm.init_params(jax.random.key(2), cfg_j))
    pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
    rng = np.random.default_rng(4)
    ropej, ropet = jtfm.make_rope_tables(cfg_j), ttfm.make_rope_tables(cfg_t, "cpu")
    kj = jkv.KVCache.create(cfg_j, 2, quantized=kvq)
    kt = tkv.KVCache.create(cfg_t, 2, quantized=kvq, device="cpu")
    S = kj.max_len
    pv = np.ones((2, S), bool)
    pv[1, :4] = False
    blocks = [(11, None, 0), (3, np.ones((3, 3), bool) & np.eye(3, dtype=bool), 0),
              (4, rng.random((4, 3 + 4)) < 0.5, 3)]
    blocks[2][1][:, 3:] |= np.eye(4, dtype=bool)
    for i, (T, lvl_mask, off) in enumerate(blocks):
        x = rng.normal(size=(2, T, 256)).astype(np.float32)
        pos = np.broadcast_to(int(kj.length) + np.arange(T), (2, T)).astype(np.int32)
        if i == 0:
            rj = jtfm.forward(pj, cfg_j, jnp.asarray(x), kj, jnp.asarray(pos),
                              ropej, prefix_valid=jnp.asarray(pv))
            rt = ttfm.forward(pt, cfg_t, torch.from_numpy(x), kt,
                              torch.from_numpy(pos), ropet,
                              prefix_valid=torch.from_numpy(pv))
        else:
            po = jdrf._level_prefix_mask(kj.length, S, jnp.asarray(lvl_mask),
                                         off, T, jnp.asarray(pv))
            rj = jtfm.forward(pj, cfg_j, jnp.asarray(x), kj, jnp.asarray(pos),
                              ropej, block_mask=jnp.asarray(lvl_mask[:, off:]),
                              prefix_override=po, commit=False,
                              write_offset=off)
            wm = torch.from_numpy(lvl_mask[:, :off].copy()) if off else None
            rt = ttfm.forward(pt, cfg_t, torch.from_numpy(x), kt,
                              torch.from_numpy(pos), ropet,
                              block_mask=torch.from_numpy(lvl_mask[:, off:].copy()),
                              prefix_valid=torch.from_numpy(pv),
                              window_mask=wm, commit=False, write_offset=off)
        kj, kt = rj.kv, rt.kv
        g, r = rt.hidden.numpy(), np.asarray(rj.hidden)
        if kvq:
            assert np.abs(g - r).max() <= 5e-3 * np.abs(r).max(), i
        else:
            np.testing.assert_allclose(g, r, err_msg=str(i), **F32)
    assert int(kt.length) == int(kj.length) == 11
    if not kvq:
        np.testing.assert_allclose(kt.k.numpy(), np.asarray(kj.k), **F32)
    with pytest.raises(ValueError, match="write_offset"):
        ttfm.forward(pt, cfg_t, torch.zeros((2, 1, 256)), kt,
                     torch.zeros((2, 1), dtype=torch.int32), ropet,
                     write_offset=2)


# ------------------------------------------------------------------ drafter

@pytest.fixture(scope="module")
def drafter_pair():
    cfg_j, cfg_t = jc.tiny_config(**tiny_kw()), tc.tiny_config(**tiny_kw())
    dcfg_j, dcfg_t = jc.drafter_config(cfg_j), tc.drafter_config(cfg_t)
    pj = jtfm.init_params(jax.random.key(0), cfg_j)
    dj = jdrf.init_drafter_params(jax.random.key(1), dcfg_j, pj["embed"])
    # a drafter whose levels matter: scale the layer weights up so the
    # attention over the provisional rows moves the proposals
    dj["layers"] = {k: (v * 3 if k.startswith("w") else v)
                    for k, v in dj["layers"].items()}
    out = {}
    for weights in ("split", "int8"):
        d = dj if weights == "split" else jq.quantize_params(jtfm.fuse_params(dj))
        p = pj if weights == "split" else jq.quantize_params(jtfm.fuse_params(pj))
        ptb = convert.convert_params(jax.tree.map(np.asarray, p), device="cpu")
        out[weights] = (p, d, ptb, convert.convert_drafter_params(
            jax.tree.map(np.asarray, d), device="cpu", embed=ptb["embed"]))
    return (cfg_j, cfg_t, dcfg_j, dcfg_t), out


def test_drafter_config_and_bridge(drafter_pair):
    (cfg_j, cfg_t, dcfg_j, dcfg_t), out = drafter_pair
    assert dcfg_t.model.final_norm is False and dcfg_t.model.swin_norm is False
    for weights, (_, dj, ptb, dt) in out.items():
        assert dt["embed"] is ptb["embed"]                    # shared
        assert "norm" not in dt and "lm_head" not in dt
        assert ("fc_w_q" in dt) == (weights == "int8")
        for k, v in dj.items():
            if k != "layers":
                np.testing.assert_array_equal(dt[k].numpy(), np.asarray(v))
        for k, v in dj["layers"].items():
            np.testing.assert_array_equal(dt["layers"][k].numpy(), np.asarray(v))
    with pytest.raises(ValueError, match="fc_w"):
        convert.convert_params(jax.tree.map(np.asarray, out["split"][1]),
                               device="cpu")
    with pytest.raises(ValueError, match="fc_w_s"):
        bad = jax.tree.map(np.asarray, out["int8"][1])
        del bad["fc_w_s"]
        convert.convert_drafter_params(bad, device="cpu")
    # the port's own quantize_params gives the bridged fc_w layout
    own = tq.quantize_params(ttfm.fuse_params(out["split"][3]))
    np.testing.assert_array_equal(own["fc_w_q"].numpy(),
                                  out["int8"][3]["fc_w_q"].numpy())
    np.testing.assert_array_equal(own["fc_w_s"].numpy(),
                                  out["int8"][3]["fc_w_s"].numpy())


def test_init_drafter_params_shapes_match_jax(drafter_pair):
    (_, cfg_t, _, dcfg_t), out = drafter_pair
    _, dj, ptb, _ = out["split"]
    own = tdrf.init_drafter_params(torch.Generator().manual_seed(0), dcfg_t,
                                   ptb["embed"])
    assert own["embed"] is ptb["embed"]
    assert sorted(own) == sorted(dj)
    for k, v in dj.items():
        if k != "layers":
            assert tuple(own[k].shape) == v.shape, k
    for k, v in dj["layers"].items():
        assert tuple(own["layers"][k].shape) == v.shape, k
    assert own["fc_w"].std().item() == pytest.approx(0.02, rel=0.1)
    assert not own["fc_b"].any()


@pytest.mark.parametrize("weights", ["split", "int8"])
@pytest.mark.parametrize("mode", ["greedy", "pinned"])
def test_drafter_extend_and_draft_static_match_jax(drafter_pair, weights, mode):
    """Converted drafter params through ``fuse_inputs``, ``extend`` (prompt
    prefill with pads, then an accepted-rows extension) and
    ``draft_static``: tokens equal, probabilities within 1e-5."""
    (cfg_j, cfg_t, dcfg_j, dcfg_t), out = drafter_pair
    pj, dj, pt, dt = out[weights]
    spec_j, spec_t = jt.get_tree(TREE), ttr.get_tree(TREE)
    rng = np.random.default_rng(7)
    L, D = 9, 5
    toks = rng.integers(4, 8196, size=(2, L)).astype(np.int32)
    hid = rng.normal(size=(2, L, 256)).astype(np.float32)
    valid = np.ones((2, L), bool)
    valid[1, :6] = False
    offs = np.asarray([0, 6], np.int32)
    dpos = np.maximum(np.arange(L)[None, :] - offs[:, None], 0).astype(np.int32)
    ropej = jtfm.make_rope_tables(dcfg_j.model)
    ropet = ttfm.make_rope_tables(dcfg_t.model, "cpu")
    kj = jkv.KVCache.create(dcfg_j.model, 2)
    kt = tkv.KVCache.create(dcfg_t.model, 2, device="cpu")
    pv = np.ones((2, kj.max_len), bool)
    pv[:, :L] = valid

    xj = jdrf.fuse_inputs(dj, jnp.asarray(toks), jnp.asarray(hid))
    xt = tdrf.fuse_inputs(dt, torch.from_numpy(toks), torch.from_numpy(hid))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **F32)

    hj, kj = jdrf.extend(dj, dcfg_j, ropej, kj, jnp.asarray(toks),
                         jnp.asarray(hid), L, prefix_valid=jnp.asarray(pv),
                         positions=jnp.asarray(dpos),
                         block_valid=jnp.asarray(valid))
    ht, kt = tdrf.extend(dt, dcfg_t, ropet, kt, torch.from_numpy(toks),
                         torch.from_numpy(hid), L,
                         prefix_valid=torch.from_numpy(pv),
                         positions=torch.from_numpy(dpos),
                         block_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(ht.numpy()[valid], np.asarray(hj)[valid], **F32)
    # accepted-rows extension: D rows written, 3 committed
    toks2 = rng.integers(4, 8196, size=(D,)).astype(np.int32)
    hid2 = rng.normal(size=(2, D, 256)).astype(np.float32)
    hj, kj = jdrf.extend(dj, dcfg_j, ropej, kj,
                         jnp.broadcast_to(jnp.asarray(toks2)[None], (2, D)),
                         jnp.asarray(hid2), jnp.int32(3),
                         prefix_valid=jnp.asarray(pv),
                         pos_offsets=jnp.asarray(offs))
    ht, kt = tdrf.extend(dt, dcfg_t, ropet, kt,
                         torch.from_numpy(toks2)[None].expand(2, D),
                         torch.from_numpy(hid2),
                         torch.tensor(3, dtype=torch.int32),
                         prefix_valid=torch.from_numpy(pv),
                         pos_offsets=torch.from_numpy(offs))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **F32)
    assert int(kt.length) == int(kj.length) == L + 3

    if mode == "greedy":
        wj, wt, pin = jsmp.LogitsWarp(temperature=0.0), tsmp.LogitsWarp(temperature=0.0), None
    else:
        wj = jsmp.LogitsWarp(temperature=1.0, top_k=2000)
        wt = tsmp.LogitsWarp(temperature=1.0, top_k=2000)
        pin = 0.5
    mask = np.zeros((V,), bool)
    mask[:4] = True
    mask[8196:] = True
    sj, kj2 = jdrf.draft_static(
        dj, dcfg_j, spec_j, ropej, kj, hj[:, 2:3], jq.head_of(pj), 3.0, wj,
        jax.random.key(0), pos_offsets=jnp.asarray(offs),
        logits_mask=jnp.asarray(mask), prefix_valid=jnp.asarray(pv), pin=pin)
    st, kt2 = tdrf.draft_static(
        dt, dcfg_t, spec_t, ropet, kt, ht[:, 2:3], tq.head_of(pt), 3.0, wt,
        None, pos_offsets=torch.from_numpy(offs),
        logits_mask=torch.from_numpy(mask), prefix_valid=torch.from_numpy(pv),
        pin=pin)
    np.testing.assert_array_equal(st.ss_token.numpy(), np.asarray(sj.ss_token))
    np.testing.assert_allclose(st.ss_prob.numpy(), np.asarray(sj.ss_prob),
                               **(LOGITS if mode == "greedy" else F32))
    assert len(st.level_probs) == len(sj.level_probs) == len(spec_t.levels) + 1
    for a, b in zip(st.level_probs, sj.level_probs):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    assert int(kt2.length) == int(kj2.length) == L + 3
    last = spec_t.levels[-1]
    n_prov = int(last.block_offset) + len(last.child_flat_idx)
    lo = L + 3
    np.testing.assert_allclose(kt2.k.numpy()[:, :, :, lo: lo + n_prov],
                               np.asarray(kj2.k)[:, :, :, lo: lo + n_prov],
                               **F32)


def test_draft_static_sampled_rows_follow_the_distribution(drafter_pair):
    """Unpinned ``draft_static`` draws from a ``torch.Generator``: the first
    proposal of the root row follows the root distribution, q are the
    residual probabilities of the drawn tokens, and no token repeats in a
    row."""
    (_, _, _, dcfg_t), out = drafter_pair
    _, _, pt, dt = out["split"]
    spec = ttr.get_tree(TREE)
    rope = ttfm.make_rope_tables(dcfg_t.model, "cpu")
    warp = tsmp.LogitsWarp(temperature=1.0, top_k=4)
    hid = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 1, 256))
                           .astype(np.float32))
    g = torch.Generator().manual_seed(3)
    firsts = []
    for _ in range(400):
        kv = tkv.KVCache.create(dcfg_t.model, 2, device="cpu").commit(5)
        d, _ = tdrf.draft_static(dt, dcfg_t, spec, rope, kv, hid,
                                 tq.head_of(pt), 3.0, warp, g)
        firsts.append(int(d.ss_token[0, 0]))
    probs = d.level_probs[0][0].numpy()
    assert (probs > 0).sum() == 4
    np.testing.assert_allclose(np.bincount(firsts, minlength=V) / 400, probs,
                               atol=0.09)
    row = d.ss_token[0, :4].tolist()
    assert len(set(row)) == 4 and all(probs[t] > 0 for t in row)
    np.testing.assert_allclose(
        d.ss_prob[0, :4].numpy(),
        tsmp.residual_q(torch.from_numpy(probs[row])).numpy(), **F32)


def test_sample_without_replacement_matches_jax_given_the_same_noise():
    """Same uniforms in, same draws and residual q out."""
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(50), size=6).astype(np.float32)
    u = rng.uniform(1e-6, 1.0, size=probs.shape).astype(np.float32)

    orig = tsmp.uniform
    try:
        tsmp.uniform = lambda gen, shape, device, lo, hi: torch.from_numpy(u)
        idx, q = tsmp.sample_without_replacement(None, torch.from_numpy(probs), 7)
    finally:
        tsmp.uniform = orig
    z = np.log(np.maximum(probs, 1e-30)) - np.log(-np.log(u))
    ref_idx = np.argsort(-z, axis=-1)[:, :7]
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    p_sel = np.take_along_axis(probs, ref_idx, -1)
    ref_q = p_sel / (1.0 - (np.cumsum(p_sel, -1) - p_sel))
    np.testing.assert_allclose(q.numpy(), np.clip(ref_q, 0, 1), **F32)


# ------------------------------------------------- CUDA kernels (card only)

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,R,A,S,G", [
    *[pytest.param(d, r, 5, 1408, 4, id=f"{r}-{d}")
      for r in (1, 4) for d in ("int8", "bfloat16", "float32")],
    pytest.param("int8", 1, 1, 1408, 4, id="A=1-int8"),
    pytest.param("int8", 1, 32, 1408, 4, id="A=blk-int8"),         # registers
    pytest.param("bfloat16", 1, 32, 1408, 4, id="A=blk-bfloat16"), # shared
    pytest.param("float32", 4, 32, 1408, 4, id="A=blk-R4-float32"),
    pytest.param("int8", 4, 5, 2560, 32, id="lane-R4-int8"),
])
def test_kv_gather_cuda_matches_plain(cuda, dtype, R, A, S, G):
    """K4 against its plain version on R request slots of two batch rows
    each (``start [2R]``, ``rel [2R, A]``; R = 1 passes the scalar and
    ``[A]`` forms), byte for byte, a clamped start and clamped pads
    included."""
    g = torch.Generator(device=cuda).manual_seed(R * 100 + A)
    L, B, W, blk = 4, 2 * R, 128, 32
    if dtype == "int8":
        planes = [torch.randint(-127, 128, (L, B, G, S, W), generator=g,
                                device=cuda, dtype=torch.int8) for _ in range(2)]
        planes += [torch.rand((L, B, G, S), generator=g, device=cuda)
                   for _ in range(2)]
    else:
        planes = [torch.randn((L, B, G, S, W), generator=g, device=cuda)
                  .to(getattr(torch, dtype)) for _ in range(2)] + [None, None]
    starts = torch.tensor([S - blk, 0, 777, 5000][:R], dtype=torch.int32,
                          device=cuda)
    if A == 5:
        rels = [[0, 3, 7, 1, 2], [0, 1, 2, 3, 4], [0, 2, 9, 40, -3],
                [31, 30, 0, 0, 0]]
    elif A == 1:
        rels = [[3], [0], [40], [-1]]
    else:                  # A = blk: every row of the block is rewritten
        rels = [[(7 * j + 3 + r) % blk for j in range(blk)] for r in range(4)]
    rels = torch.tensor(rels[:R], dtype=torch.int32, device=cuda)
    if R == 1:
        starts, rels = starts[0], rels[0]
    else:
        starts, rels = starts.repeat_interleave(2), rels.repeat_interleave(2, 0)
    ref = [None if p is None else p.clone() for p in planes]
    tkv.gather_write_block_cuda(*planes, rels, starts, blk)
    tkv.gather_write_block_plain(*ref, rels, starts, blk)
    for a, b in zip(planes, ref):
        if b is not None:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,length,win,quant", [
    (1408, 9, 1300, 7, False), (1408, 12, 0, 16, False),
    (384, 9, 290, 40, False), (1408, 9, 700, 7, True)])
def test_tree_attention_cuda_window_matches_plain(cuda, S, T, length, win,
                                                  quant):
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
    kw["window_mask"] = torch.rand((B, T, win), generator=g, device=cuda) < 0.5
    bias = torch.zeros((B, S), device=cuda)
    bias[1, :5] = tta.NEG_INF
    args = (q, kn, vn, kc, vc, torch.tensor(length, dtype=torch.int32,
                                            device=cuda), mask, bias,
            W ** -0.5)
    got = tta.tree_attention_cuda(*args, **kw)
    ref = tta.tree_attention_plain(*args, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2 * ref.float().abs().max().item())
