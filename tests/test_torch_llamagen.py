"""The port's LlamaGen lane against ``lantern_tpu`` on the CPU.

A tiny LlamaGen config: hidden 256 in four heads of head_dim 64, so the KV
cache packs two heads into each 128-lane group (G = 2, ``pk = 2``), as at
every LlamaGen size; two layers, vocab 256, a 4x4 image grid
(``block_size=16``), f32 unless stated; class-label (c2i) and caption
(t2i) conditioning.  Inputs come from numpy seeds and run through the JAX
function and its port:

- configs (every ``llamagen_config`` size and task, the drafter geometry),
  the 2-D rope tables and interleaved application, ``cond_embed``,
  ``init_params`` shapes and the weight bridge of ``cond``;
- ``forward`` at f32 and bf16, bf16 and int8 KV, within the tolerances of
  ``tests/test_torch_model.py``; the drafter's forward (first layer without
  input norm, rope prefix one row shorter);
- K2's plain version at ``pk = 2`` against the Pallas kernel in interpret
  mode (as ``tests/test_tree_attention_kernel.py`` runs it), and on rows
  that see no key against the JAX dense reference;
- ``ar.generate`` and ``spec.generate`` in static mode (stale + deferred,
  drafter + rollback, drafter + deferred), greedy and pinned (``pin=0.5``),
  with a label and with a left-padded caption: token-exact.

The tests marked ``cuda`` hold K2's ``pk = 2`` kernel against its plain
version and skip without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu import trees as jt
from lantern_tpu.engine import ar as jar
from lantern_tpu.engine import spec as jspec
from lantern_tpu.kv import KVCache as JKV
from lantern_tpu.kv import fake_quant_rows as j_fake_quant
from lantern_tpu.kv import group_blocks as j_group_blocks
from lantern_tpu.kv import group_cache as j_group_cache
from lantern_tpu.kv import ungroup_blocks as j_ungroup_blocks
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops import quant as jq
from lantern_tpu.ops import rope as jrope
from lantern_tpu.ops.acceptance import LanternSpec as JLantern
from lantern_tpu.ops.pallas import tree_attention as jta
from lantern_tpu.ops.sampling import LogitsWarp as JWarp
from lantern_tpu.utils import t5 as jt5
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.engine import ar as tar
from lantern_tpu_torch.engine import spec as tspec
from lantern_tpu_torch.kv import KVCache as TKV
from lantern_tpu_torch.kv import quantize_rows
from lantern_tpu_torch.models import drafter as tdrf
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.ops import rope as trope
from lantern_tpu_torch.ops import tree_attention as tta
from lantern_tpu_torch.ops.acceptance import LanternSpec as TLantern
from lantern_tpu_torch.ops.sampling import LogitsWarp as TWarp
from lantern_tpu_torch.utils import t5 as tt5

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
MAX_NEW = 16
TREE = "mc_sim_7b_63"
KW = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
          block_size=16, max_seq_len=96)
# the caption's cond row is left-padded: its first 3 of 8 rows are pads
CAP_PADS = 3


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def passthrough(dparams, cfg):
    """The hidden-passthrough drafter: output hidden == input base hidden."""
    H = cfg.hidden_size
    fc = np.zeros((2 * H, H), np.float32)
    fc[H:] = np.eye(H)
    return dict(dparams, fc_w=jnp.asarray(fc, cfg.jnp_dtype),
                layers=jax.tree.map(lambda a: a * 0, dparams["layers"]))


def request(cfg_j, uncond_feats, cond_kind):
    """``(jax, port)`` dicts of ``cond``, ``uncond`` and ``prefix_valid`` for
    one request: label 3 against the uncond row, or numpy caption features
    with a left-padded cond row against the params' ``uncond`` features."""
    if cond_kind == "label":
        c = np.asarray([3], np.int32)
        u = np.asarray([cfg_j.num_classes], np.int32)
        pv = None
    else:
        rng = np.random.default_rng(4)
        c = rng.normal(size=(1, cfg_j.cls_token_num,
                             cfg_j.caption_dim)).astype(np.float32)
        c[:, :CAP_PADS] = 0
        u = np.array(jnp.asarray(uncond_feats, jnp.float32))[None]
        pv = np.ones((2, cfg_j.cls_token_num), bool)
        pv[0, :CAP_PADS] = False
    return (dict(cond=jnp.asarray(c), uncond=jnp.asarray(u),
                 prefix_valid=None if pv is None else jnp.asarray(pv)),
            dict(cond=torch.from_numpy(c), uncond=torch.from_numpy(u),
                 prefix_valid=None if pv is None else torch.from_numpy(pv)))


def lane(cond_kind, weights="fused", drafter="random"):
    """Params of both packages, and the request's conditioning, for one
    conditioning kind on the tiny config."""
    cfg_j = jc.tiny_config(cond_kind=cond_kind, **KW)
    cfg_t = tc.tiny_config(cond_kind=cond_kind, **KW)
    dcfg_j, dcfg_t = jc.drafter_config(cfg_j), tc.drafter_config(cfg_t)
    base = jtfm.init_params(jax.random.key(0), cfg_j)
    d = jdrf.init_drafter_params(jax.random.key(1), dcfg_j, base["embed"])
    if drafter == "passthrough":
        d = passthrough(d, cfg_j)
    pj, dj = jtfm.fuse_params(base), jtfm.fuse_params(d)
    if weights == "int8":
        pj, dj = jq.quantize_params(pj), jq.quantize_params(dj)
    pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
    dt = convert.convert_drafter_params(jax.tree.map(np.asarray, dj),
                                        device="cpu", embed=pt["embed"])
    return dict(cfg=(cfg_j, cfg_t), dcfg=(dcfg_j, dcfg_t), p=(pj, pt),
                d=(dj, dt), req=request(cfg_j, base.get("cond", {}).get(
                    "uncond"), cond_kind))


@pytest.fixture(scope="module")
def lanes():
    cache = {}

    def get(cond_kind, weights="fused", drafter="random"):
        key = (cond_kind, weights, drafter)
        if key not in cache:
            cache[key] = lane(*key)
        return cache[key]
    return get


# ------------------------------------------------------------ configs, rope

def _same_fields(t, j):
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("task", ["c2i", "t2i"])
def test_llamagen_config_matches_jax(task):
    for size in ("nano", "B", "L", "XL", "XXL", "3B"):
        t, j = tc.llamagen_config(size, task), jc.llamagen_config(size, task)
        _same_fields(t, j)
        assert t.head_dim == j.head_dim
        d_t, d_j = tc.drafter_config(t, top_k=10), jc.drafter_config(j, top_k=10)
        _same_fields(d_t, d_j)
        assert d_t.model.first_layer_no_input_norm
        assert d_t.model.cls_token_num == t.cls_token_num - 1
    assert {tc.llamagen_config(s).head_dim
            for s in ("B", "L", "XL", "XXL")} == {64}
    xl = tc.llamagen_config("XL", task)
    assert (xl.num_layers, xl.hidden_size, xl.num_heads, xl.vocab_size,
            xl.intermediate_size) == (36, 1280, 20, 16384, 3584)
    with pytest.raises(ValueError):
        tc.llamagen_config("XL", "i2i")


@pytest.mark.parametrize("cls", [1, 8, 120])
def test_rope_2d_matches_jax(cls):
    cj, sj = jrope.rope_table_2d(4, 64, 10000.0, cls)
    ct, st = trope.rope_table_2d(4, 64, 10000.0, cls)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(st, sj)
    assert ct.shape == (cls + 16 + 10, 32)
    assert not ct[:cls].any() and not ct[cls + 16:].any()
    rng = np.random.default_rng(cls)
    x = rng.normal(size=(2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, ct.shape[0], size=(2, 7))
    pos[:, 0] = 0                         # a prefix row: q and k go to zero
    ref = jrope.apply_rope_interleaved(jnp.asarray(x), cj, sj,
                                       jnp.asarray(pos))
    got = trope.apply_rope_interleaved(torch.from_numpy(x),
                                       torch.from_numpy(ct),
                                       torch.from_numpy(st),
                                       torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    assert not got[:, 0].any()
    # bf16 rounds the f32 result once, as the JAX function does
    xb = torch.from_numpy(x).bfloat16()
    gb = trope.apply_rope_interleaved(xb, torch.from_numpy(ct),
                                      torch.from_numpy(st),
                                      torch.from_numpy(pos))
    rb = jrope.apply_rope_interleaved(jnp.asarray(x, jnp.bfloat16), cj, sj,
                                      jnp.asarray(pos))
    np.testing.assert_array_equal(f32(gb), f32(rb))


def test_make_rope_tables_2d(lanes):
    m = lanes("caption")
    (cfg_j, cfg_t), (dcfg_j, dcfg_t) = m["cfg"], m["dcfg"]
    for cj, ct in ((cfg_j, cfg_t), (dcfg_j.model, dcfg_t.model)):
        ref = jtfm.make_rope_tables(cj)
        got = ttfm.make_rope_tables(ct, "cpu")
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b)
    # the drafter's prefix is one row shorter
    assert ttfm.make_rope_tables(dcfg_t.model, "cpu")[0].shape[0] == \
        ttfm.make_rope_tables(cfg_t, "cpu")[0].shape[0] - 1


def test_t5_stand_in_matches_jax():
    prompts = ["a red fox in snow", "https://x.y <b>two</b>  cats"]
    ej, mj = jt5.RandomT5(dim=32, model_max_length=12).get_text_embeddings(
        prompts)
    et, mt = tt5.RandomT5(dim=32, model_max_length=12).get_text_embeddings(
        prompts)
    np.testing.assert_array_equal(et, ej)
    np.testing.assert_array_equal(mt, mj)
    fj = jt5.flip_for_left_padding(ej, mj)
    ft = tt5.flip_for_left_padding(et, mt)
    for a, b in zip(ft, fj):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not ft[0][0, :12 - int(mt[0].sum())].any()
    assert tt5.clean_caption(prompts[1]) == jt5.clean_caption(prompts[1])


# ------------------------------------------------- cond, init, weight bridge

@pytest.mark.parametrize("cond_kind", ["label", "caption"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cond_embed_and_convert_match_jax(cond_kind, dtype):
    cfg_j = jc.tiny_config(cond_kind=cond_kind, **dict(KW, dtype=dtype))
    cfg_t = tc.tiny_config(cond_kind=cond_kind, **dict(KW, dtype=dtype))
    pj = jq.quantize_params(jtfm.fuse_params(
        jtfm.init_params(jax.random.key(2), cfg_j)))
    pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
    # the adapters are carried over bit for bit and stay unquantized
    assert sorted(pt["cond"]) == sorted(pj["cond"])
    for k, v in pj["cond"].items():
        assert pt["cond"][k].dtype == cfg_t.torch_dtype
        np.testing.assert_array_equal(f32(pt["cond"][k]), f32(v))
    rng = np.random.default_rng(0)
    if cond_kind == "label":
        c = np.asarray([3, cfg_j.num_classes], np.int32)
        ref = jtfm.cond_embed(pj, cfg_j, jnp.asarray(c))
        got = ttfm.cond_embed(pt, cfg_t, torch.from_numpy(c))
        np.testing.assert_array_equal(f32(got), f32(ref))
    else:
        c = rng.normal(size=(2, cfg_j.cls_token_num,
                             cfg_j.caption_dim)).astype(np.float32)
        ref = jtfm.cond_embed(pj, cfg_j, jnp.asarray(c))
        got = ttfm.cond_embed(pt, cfg_t, torch.from_numpy(c))
        tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(f32(got), f32(ref), **tol)
    assert tuple(got.shape) == (2, cfg_t.cls_token_num, cfg_t.hidden_size)


@pytest.mark.parametrize("cond_kind", ["label", "caption"])
def test_init_params_shapes_match_jax(cond_kind):
    cfg_j = jc.tiny_config(cond_kind=cond_kind, **KW)
    cfg_t = tc.tiny_config(cond_kind=cond_kind, **KW)
    pj = jtfm.init_params(jax.random.key(0), cfg_j)
    pt = ttfm.init_params(torch.Generator().manual_seed(0), cfg_t,
                          device="cpu")
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), pj)
    shapes_t = jax.tree.map(lambda a: tuple(a.shape), pt)
    assert shapes_t == shapes_j
    if cond_kind == "caption":
        assert pt["cond"]["uncond"].std().item() == pytest.approx(
            cfg_t.caption_dim ** -0.5, rel=0.2)
    # the port's drafter takes no cond subtree, as the JAX one drops it
    dt = tdrf.init_drafter_params(torch.Generator().manual_seed(1),
                                  tc.drafter_config(cfg_t), pt["embed"])
    assert "cond" not in dt


def test_convert_rejects_bad_cond():
    cfg_j = jc.tiny_config(cond_kind="label", **KW)
    p = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), cfg_j))
    with pytest.raises(ValueError, match="cond must hold"):
        convert.convert_params(dict(p, cond={"table": p["cond"]["table"],
                                             "fc1": p["cond"]["table"]}),
                               device="cpu")


# ---------------------------------------------------------------- forward

def _prefix_forward_pair(m, kvq):
    """Prefill the conditioning prefix (with the caption's pad mask in the
    block), run a tree block after it, then one T=1 step.  Returns ``(kind,
    jax value, port value)`` per stage."""
    (cfg_j, cfg_t), (pj, pt) = m["cfg"], m["p"]
    (rj, rt) = m["req"]
    spec = jt.get_tree(TREE)
    Tc = cfg_j.cls_token_num
    ropej = jtfm.make_rope_tables(cfg_j)
    ropet = ttfm.make_rope_tables(cfg_t, "cpu")
    kj = JKV.create(cfg_j, 2, quantized=kvq)
    kt = TKV.create(cfg_t, 2, quantized=kvq, device="cpu")
    pv = np.ones((2, kj.max_len), bool)
    if rj["prefix_valid"] is not None:
        pv[:, :Tc] = np.asarray(rj["prefix_valid"])
    block = np.tril(np.ones((Tc, Tc), bool))[None] & pv[:, None, :Tc]
    outs = []
    ej = jtfm.cond_embed(pj, cfg_j, jnp.concatenate([rj["cond"], rj["uncond"]]))
    et = ttfm.cond_embed(pt, cfg_t, torch.cat([rt["cond"], rt["uncond"]]))
    resj = jtfm.forward(pj, cfg_j, ej, kj, jnp.arange(Tc), ropej,
                        block_mask=jnp.asarray(block))
    rest = ttfm.forward(pt, cfg_t, et, kt, torch.arange(Tc), ropet,
                        block_mask=torch.from_numpy(block))
    outs.append(("hidden", resj.hidden, rest.hidden))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, cfg_j.vocab_size,
                       size=(2, spec.num_nodes)).astype(np.int32)
    pos = Tc + spec.depth
    resj = jtfm.forward(pj, cfg_j, jtfm.token_embed(pj, jnp.asarray(ids)),
                        resj.kv, jnp.asarray(pos), ropej,
                        block_mask=jnp.asarray(spec.attn_mask),
                        prefix_valid=jnp.asarray(pv), commit=False)
    rest = ttfm.forward(pt, cfg_t, ttfm.token_embed(pt, torch.from_numpy(ids)),
                        rest.kv, torch.from_numpy(pos), ropet,
                        block_mask=torch.from_numpy(spec.attn_mask),
                        prefix_valid=torch.from_numpy(pv), commit=False)
    outs.append(("hidden", resj.hidden, rest.hidden))
    outs.append(("logits", jtfm.logits_head(pj, resj.hidden),
                 ttfm.logits_head(pt, rest.hidden)))
    one = np.asarray([[7], [7]], np.int32)
    p1 = np.asarray([Tc], np.int32)
    resj = jtfm.forward(pj, cfg_j, jtfm.token_embed(pj, jnp.asarray(one)),
                        resj.kv, jnp.asarray(p1), ropej,
                        prefix_valid=jnp.asarray(pv))
    rest = ttfm.forward(pt, cfg_t, ttfm.token_embed(pt, torch.from_numpy(one)),
                        rest.kv, torch.from_numpy(p1), ropet,
                        prefix_valid=torch.from_numpy(pv))
    outs.append(("hidden", resj.hidden, rest.hidden))
    outs.append(("logits", jtfm.logits_head(pj, resj.hidden),
                 ttfm.logits_head(pt, rest.hidden)))
    outs.append(("cache_q" if kvq else "cache", resj.kv.k, rest.kv.k))
    return outs


@pytest.mark.parametrize("cond_kind", ["label", "caption"])
@pytest.mark.parametrize("dtype,kvq,weights", [
    ("float32", False, "fused"), ("float32", True, "int8"),
    ("bfloat16", False, "int8"), ("bfloat16", True, "int8")])
def test_forward_matches_jax(cond_kind, dtype, kvq, weights):
    cfg_j = jc.tiny_config(cond_kind=cond_kind, **dict(KW, dtype=dtype))
    cfg_t = tc.tiny_config(cond_kind=cond_kind, **dict(KW, dtype=dtype))
    pj = jtfm.fuse_params(jtfm.init_params(jax.random.key(1), cfg_j))
    if weights == "int8":
        pj = jq.quantize_params(pj)
    pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
    m = dict(cfg=(cfg_j, cfg_t), p=(pj, pt), req=request(
        cfg_j, pj["cond"].get("uncond"), cond_kind))
    for kind, ref, got in _prefix_forward_pair(m, kvq):
        r, g = f32(ref), f32(got)
        assert r.shape == g.shape, kind
        if kind == "cache_q":
            # one last-bit difference of a key flips an int8 rounding; in
            # bf16 the caption MLP's rounding differs too before the layers
            d = np.abs(g - r)
            assert d.max() <= (1 if dtype == "float32" else 3), kind
            assert (d > 0).mean() < (1e-3 if dtype == "float32" else 5e-2), kind
        elif dtype == "float32" and not kvq:
            np.testing.assert_allclose(g, r, **(LOGITS if kind == "logits"
                                                else F32), err_msg=kind)
        else:
            rel = 2e-2 if dtype == "bfloat16" else 5e-3
            assert np.abs(g - r).max() <= rel * np.abs(r).max(), kind


def test_drafter_forward_matches_jax(lanes):
    """The LlamaGen drafter: its first layer takes the fc output with no
    input norm, its rope table is one prefix row shorter; ``extend`` over
    a prefix and a level behind a window, against the JAX forward."""
    m = lanes("caption")
    (dcfg_j, dcfg_t), (dj, dt) = m["dcfg"], m["d"]
    assert dcfg_t.model.first_layer_no_input_norm
    rng = np.random.default_rng(7)
    T, H = 9, dcfg_j.model.hidden_size
    tok = rng.integers(0, 256, size=(2, T)).astype(np.int32)
    hid = rng.normal(size=(2, T, H)).astype(np.float32)
    ropej = jtfm.make_rope_tables(dcfg_j.model)
    ropet = ttfm.make_rope_tables(dcfg_t.model, "cpu")
    hj, kj = jdrf.extend(dj, dcfg_j, ropej, JKV.create(dcfg_j.model, 2),
                         jnp.asarray(tok), jnp.asarray(hid), T)
    ht, kt = tdrf.extend(dt, dcfg_t, ropet,
                         TKV.create(dcfg_t.model, 2, device="cpu"),
                         torch.from_numpy(tok), torch.from_numpy(hid), T)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **F32)
    # the norm skip matters: the same forward with layer 0 normalized differs
    off = dataclasses.replace(dcfg_t, model=dcfg_t.model.replace(
        first_layer_no_input_norm=False))
    h2, _ = tdrf.extend(dt, off, ropet,
                        TKV.create(dcfg_t.model, 2, device="cpu"),
                        torch.from_numpy(tok), torch.from_numpy(hid), T)
    assert np.abs(h2.numpy() - np.asarray(hj)).max() > 1e-3


# ------------------------------------------------ K2's plain version, pk = 2

def _pallas_case(seed, T, length, S=512, nh=4, hd=64, B=2):
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.normal(size=(B, T, nh, hd)).astype(np.float32)
                 for _ in range(3))
    kc, vc = (rng.normal(size=(B, S, nh, hd)).astype(np.float32)
              for _ in range(2))
    mask = (rng.random((T, T)) < 0.4) | np.eye(T, dtype=bool)
    bias = np.zeros((B, S), np.float32)
    bias[0, :7] = jta.NEG_INF
    return q, kn, vn, kc, vc, mask, bias


@pytest.mark.parametrize("T,length", [(16, 0), (16, 137), (1, 375),
                                      (26, 256), (59, 300)])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_k2_plain_pk2_matches_pallas(T, length, kind):
    """K2's plain version with two 64-wide heads per 128-lane group against
    the Pallas kernel in interpret mode.  int8: the Pallas kernel takes the
    in-flight rows already fake-quantized (as the JAX forward feeds it),
    the plain version quantizes them itself; both read the int8 cache with
    its scales."""
    q, kn, vn, kc, vc, mask, bias = _pallas_case(T + length, T, length)
    B, S = q.shape[0], kc.shape[1]
    scale = 64 ** -0.5
    dt = jnp.bfloat16 if kind == "bfloat16" else jnp.float32
    kcg = j_group_cache(jnp.asarray(kc, dt))          # [B, G, S, 128]
    vcg = j_group_cache(jnp.asarray(vc, dt))
    ks = vs = None
    knj, vnj = jnp.asarray(kn, dt), jnp.asarray(vn, dt)
    kn_p, vn_p = knj, vnj
    if kind == "int8":
        qk, qv = quantize_rows(torch.from_numpy(np.asarray(kcg))), \
            quantize_rows(torch.from_numpy(np.asarray(vcg)))
        kcg, ks = jnp.asarray(qk[0].numpy()), jnp.asarray(qk[1].numpy())
        vcg, vs = jnp.asarray(qv[0].numpy()), jnp.asarray(qv[1].numpy())

        def fq(x):
            return j_ungroup_blocks(j_fake_quant(j_group_blocks(x))).reshape(
                x.shape)
        kn_p, vn_p = fq(knj), fq(vnj)
    got_p = jta.tree_attention(jnp.asarray(q, dt), kn_p, vn_p, kcg, vcg,
                               jnp.asarray(length), jnp.asarray(mask),
                               jnp.asarray(bias), scale, blk=128,
                               interpret=True, k_scale=ks, v_scale=vs)
    tq = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32))
                                    ).to(torch.bfloat16 if kind == "bfloat16"
                                         else torch.float32)
    got_t = tta.tree_attention_plain(
        tq(q), tq(knj), tq(vnj),
        torch.from_numpy(np.asarray(kcg)) if kind == "int8" else tq(kcg),
        torch.from_numpy(np.asarray(vcg)) if kind == "int8" else tq(vcg),
        torch.tensor(length, dtype=torch.int32),
        torch.from_numpy(mask)[None].expand(B, T, T),
        torch.from_numpy(bias), scale,
        k_scale=None if ks is None else torch.from_numpy(np.asarray(ks)),
        v_scale=None if vs is None else torch.from_numpy(np.asarray(vs)))
    assert got_t.shape == (B, T, 4, 64)
    r, g = f32(got_p), f32(got_t)
    if kind == "float32":
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-5)
    else:
        # bf16 weights / dequantized rows round at other places than the
        # Pallas kernel does
        np.testing.assert_allclose(g, r, rtol=3e-2, atol=3e-2)
    # the sub-heads are separate softmaxes: the 128-wide product of one
    # softmax per group is another function
    wide = tta.tree_attention_plain(
        tq(q).reshape(B, T, 2, 128), tq(knj).reshape(B, T, 2, 128),
        tq(vnj).reshape(B, T, 2, 128),
        torch.from_numpy(np.asarray(kcg)) if kind == "int8" else tq(kcg),
        torch.from_numpy(np.asarray(vcg)) if kind == "int8" else tq(vcg),
        torch.tensor(length, dtype=torch.int32),
        torch.from_numpy(mask)[None].expand(B, T, T), torch.from_numpy(bias),
        scale, k_scale=None if ks is None else torch.from_numpy(np.asarray(ks)),
        v_scale=None if vs is None else torch.from_numpy(np.asarray(vs)))
    assert np.abs(f32(wide).reshape(r.shape) - r).max() > 0.1


def _dead_rows_case(seed, T, length, S=512):
    """K2's inputs where the first 5 rows of batch row 0 see no key: no
    block key (a caption's pads in their own prefill) and, at length > 0,
    only prefix rows under the pad bias.  Returns the inputs and the bool
    [B, T] of the rows that see no key."""
    q, kn, vn, kc, vc, _, bias = _pallas_case(seed, T, length, S=S)
    B = q.shape[0]
    mask = np.broadcast_to(np.tril(np.ones((T, T), bool)), (B, T, T)).copy()
    mask[0, :, :5] = False
    # the pad bias on the live prefix only, where the JAX forward's mask
    # puts it (the dense reference adds it to the invisible rows too)
    bias[:] = 0
    bias[0, :length] = jta.NEG_INF
    dead = np.zeros((B, T), bool)
    dead[0, :5] = True
    return (q, kn, vn, kc, vc, mask, bias), dead


@pytest.mark.parametrize("length", [0, 137])
def test_k2_plain_row_without_keys_matches_dense(length):
    """A row that sees no key has every score at the finite NEG_INF: the
    plain version gives it, as the JAX dense math does, the mean of the
    value rows of the whole cache plane [0, S) and of the block (every
    other row as before)."""
    T = 16
    (q, kn, vn, kc, vc, mask, bias), dead = _dead_rows_case(7, T, length)
    B, S = q.shape[0], kc.shape[1]
    scale = 64 ** -0.5
    ref = f32(jta.tree_attention_reference(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(length), jnp.asarray(mask),
        jnp.asarray(bias), scale))
    got = f32(tta.tree_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(np.asarray(j_group_cache(jnp.asarray(kc)))),
        torch.from_numpy(np.asarray(j_group_cache(jnp.asarray(vc)))),
        torch.tensor(length, dtype=torch.int32), torch.from_numpy(mask),
        torch.from_numpy(bias), scale))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    mean = (vc[0].sum(0) + vn[0].sum(0)) / (S + T)            # [nh, hd]
    np.testing.assert_allclose(got[dead], np.broadcast_to(
        mean, (int(dead.sum()),) + mean.shape), rtol=1e-4, atol=1e-5)
    assert np.abs(got[dead]).max() > 1e-2          # not zeros


def test_k2_grid_at_xl_widths():
    """K2's grid at LlamaGen-XL (B * G = 20 units, S = 512) on a card of 132
    SMs: 16 query rows a block with two heads a group, and one wave of at
    most two blocks an SM with at most one split per 256 rows of S."""
    assert tta.k2_rows(1, 2) == tta.k2_rows(120, 2) == 16
    assert tta.k2_rows(120) == 32
    for T, want in ((1, 2), (26, 2), (59, 2), (120, 1)):
        n = tta.k2_splits(2, 10, 512, T, 132, 2)
        assert n == want, T
        assert 2 * 10 * -(-T // 16) * n <= tta.K2_BLOCKS_PER_SM * 132


# ------------------------------------------------------------- engines

def _greedy_or_pinned(mode):
    if mode == "greedy":
        return dict(warp=JWarp(temperature=0.0)), dict(warp=TWarp(temperature=0.0))
    return (dict(warp=JWarp(temperature=1.0, top_k=50), pin=0.5,
                 lantern=JLantern(k=6, delta=0.5)),
            dict(warp=TWarp(temperature=1.0, top_k=50), pin=0.5,
                 lantern=TLantern(k=6, delta=0.5)))


def _nearest(cfg):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(cfg.vocab_size, 4))
    d = ((emb[:, None] - emb[None, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :7].astype(np.int32)


@pytest.mark.parametrize("cond_kind", ["label", "caption"])
@pytest.mark.parametrize("kvq", [False, True])
def test_ar_generate_token_exact(lanes, cond_kind, kvq):
    m = lanes(cond_kind, "int8" if kvq else "fused")
    (cfg_j, cfg_t), (pj, pt), (rj, rt) = m["cfg"], m["p"], m["req"]
    resj = jar.generate(pj, cfg_j, rj["cond"], rj["uncond"], MAX_NEW, 3.0,
                        JWarp(temperature=0.0), jax.random.key(0),
                        prefix_valid=rj["prefix_valid"], kv_quant=kvq)
    rest = tar.generate(pt, cfg_t, rt["cond"], rt["uncond"], MAX_NEW, 3.0,
                        TWarp(temperature=0.0), None,
                        prefix_valid=rt["prefix_valid"], kv_quant=kvq,
                        device="cpu")
    np.testing.assert_array_equal(rest.tokens.numpy(), np.asarray(resj.tokens))
    assert rest.kv.length.tolist() == [int(resj.kv.length)] * 2
    if cond_kind == "caption":
        # the pad mask matters: without it the stream is another one
        other = tar.generate(pt, cfg_t, rt["cond"], rt["uncond"], MAX_NEW,
                             3.0, TWarp(temperature=0.0), None, kv_quant=kvq,
                             device="cpu")
        assert not torch.equal(other.tokens, rest.tokens)


def spec_pair(m, ecfg_kw, mode, seed=3):
    """Run both engines on one lane; returns ``(jax result, port result)``."""
    (cfg_j, cfg_t), (dcfg_j, dcfg_t) = m["cfg"], m["dcfg"]
    (pj, pt), (dj, dt), (rj, rt) = m["p"], m["d"], m["req"]
    near = _nearest(cfg_j)
    pj = dict(pj, nearest_latents=jnp.asarray(near))
    pt = dict(pt, nearest_latents=torch.from_numpy(near))
    jk, tk = _greedy_or_pinned(mode)
    common = dict(cfg_scale=3.0, max_new=MAX_NEW, walk_batch_warp=True,
                  **ecfg_kw)
    static = common.get("mode", "static") == "static"
    resj = jspec.generate(pj, dj, jspec.SpecDecodeConfig(**common, **jk),
                          cfg_j, dcfg_j, jt.get_tree(TREE) if static else None,
                          rj["cond"], rj["uncond"], jax.random.key(seed),
                          prefix_valid=rj["prefix_valid"])
    rest = tspec.generate(pt, tspec.SpecDecodeConfig(**common, **tk), cfg_t,
                          ttr.get_tree(TREE) if static else None, None,
                          device="cpu", dparams=dt, dcfg=dcfg_t,
                          cond=rt["cond"], uncond=rt["uncond"],
                          prefix_valid=rt["prefix_valid"])
    return resj, rest


def assert_same(resj, rest):
    np.testing.assert_array_equal(rest.tokens.numpy(), np.asarray(resj.tokens))
    assert (rest.steps, rest.accept_sum, rest.n_valid) == (
        int(resj.steps), int(resj.accept_sum), int(resj.n_valid))
    assert rest.n_valid == MAX_NEW
    toks = rest.tokens.numpy()
    assert ((toks >= 0) & (toks < KW["vocab_size"])).all()


STATIC_MODES = {
    "stale+deferred": dict(stale_draft=True, deferred_commit=True),
    "drafter+rollback": dict(stale_draft=False, deferred_commit=False),
    "drafter+deferred": dict(stale_draft=False, deferred_commit=True),
}


@pytest.mark.parametrize("cond_kind", ["label", "caption"])
@pytest.mark.parametrize("mode", ["greedy", "pinned"])
@pytest.mark.parametrize("commit", list(STATIC_MODES))
def test_static_spec_token_exact(lanes, cond_kind, mode, commit):
    m = lanes(cond_kind, "int8")
    resj, rest = spec_pair(m, dict(STATIC_MODES[commit], kv_quant=True), mode)
    assert_same(resj, rest)


def test_static_spec_greedy_equals_ar(lanes):
    """Greedy speculative decoding is lossless against the AR twin, with
    the caption's pad mask on both."""
    m = lanes("caption", "int8")
    (cfg_t, pt, rt) = m["cfg"][1], m["p"][1], m["req"][1]
    _, rest = spec_pair(m, dict(kv_quant=True, stale_draft=False,
                                deferred_commit=False), "greedy")
    ra = tar.generate(pt, cfg_t, rt["cond"], rt["uncond"], MAX_NEW, 3.0,
                      TWarp(temperature=0.0), None,
                      prefix_valid=rt["prefix_valid"], kv_quant=True,
                      device="cpu")
    np.testing.assert_array_equal(rest.tokens.numpy(), ra.tokens.numpy())


def test_embedding_prefix_request_checks(lanes):
    m = lanes("label")
    cfg_t, pt, rt = m["cfg"][1], m["p"][1], m["req"][1]
    tree = ttr.get_tree(TREE)
    ecfg = tspec.SpecDecodeConfig(stale_draft=True, deferred_commit=True,
                                  max_new=MAX_NEW)
    with pytest.raises(ValueError, match="exactly one"):
        tspec.generate(pt, ecfg, cfg_t, tree, None, device="cpu",
                       cond=rt["cond"])
    with pytest.raises(ValueError, match="exactly one"):
        tspec.generate(pt, ecfg, cfg_t, tree, None, device="cpu")


# ------------------------------------------------- K2 at pk = 2 on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _xl_k2_case(dev, T, length, quant, window=0, S=512, B=2, G=10, seed=0):
    """K2's inputs at LlamaGen-XL widths: 20 heads of 64 in 10 groups."""
    g = torch.Generator(device=dev).manual_seed(seed + 31 * T + length)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()
    q, kn, vn = (randn(B, T, 2 * G, 64) for _ in range(3))
    kc, vc = randn(B, G, S, 128), randn(B, G, S, 128)
    kw = {}
    if quant:
        (kc, ks), (vc, vs) = quantize_rows(kc), quantize_rows(vc)
        kw = dict(k_scale=ks, v_scale=vs)
    mask = torch.rand((B, T, T), generator=g, device=dev) < 0.4
    mask |= torch.eye(T, dtype=torch.bool, device=dev)
    bias = torch.zeros((B, S), device=dev)
    bias[1, :7] = tta.NEG_INF
    if window:
        kw["window_mask"] = torch.rand((T, window), generator=g,
                                       device=dev) < 0.5
    args = (q, kn, vn, kc, vc, torch.tensor(length, dtype=torch.int32,
                                            device=dev),
            mask, bias, 64 ** -0.5)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("T,length,quant,window", [
    (1, 375, True, 0), (1, 375, False, 0), (26, 300, False, 0),
    (26, 300, True, 0), (59, 301, True, 0), (120, 0, True, 0),
    (120, 0, False, 0), (10, 200, False, 0), (10, 200, False, 10),
    (10, 200, False, 30), (5, 0, True, 20)])
def test_k2_pk2_cuda_matches_plain(cuda, T, length, quant, window):
    args, kw = _xl_k2_case(cuda, T, length, quant, window)
    got = tta.tree_attention_cuda(*args, **kw)
    ref = tta.tree_attention_plain(*args, **kw)
    tol = 2e-2 * ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert torch.isfinite(got.float()).all() and err <= tol, (err, tol)
    # known-wrong variants land outside the tolerance: the two heads of a
    # group swapped, and one softmax over the 128-wide product shared by both
    B, T_, nh, hd = ref.shape
    swapped = ref.reshape(B, T_, nh // 2, 2, hd).flip(3).reshape(ref.shape)
    assert (swapped.float() - ref.float()).abs().max().item() > tol
    q, kn, vn, *rest = args
    wide = tta.tree_attention_plain(
        q.reshape(B, T_, nh // 2, 128), kn.reshape(B, T_, nh // 2, 128),
        vn.reshape(B, T_, nh // 2, 128), *rest, **kw).reshape(ref.shape)
    assert (wide.float() - ref.float()).abs().max().item() > tol


@pytest.mark.cuda
def test_k2_pk2_cuda_splits_and_rows(cuda):
    """Every split count and the row tiles of a long block give the same
    function (the merge over splits and over the heads' statistics)."""
    args, kw = _xl_k2_case(cuda, 40, 450, True)
    ref = tta.tree_attention_plain(*args, **kw)
    tol = 2e-2 * ref.float().abs().max().item()
    for nsplit in (1, 2, 3, 7):
        got = tta.tree_attention_launch(*args, nsplit, **kw)
        assert (got.float() - ref.float()).abs().max().item() <= tol, nsplit


@pytest.mark.cuda
@pytest.mark.parametrize("length", [0, 137])
@pytest.mark.parametrize("quant", [False, True])
def test_k2_pk2_cuda_row_without_keys(cuda, length, quant):
    """Rows that see no key get the plain version's mean over the whole
    cache plane and the block, with one split and with several (the
    merging split writes them)."""
    T, B, G, S = 16, 2, 2, 512
    (q, kn, vn, kc, vc, mask, bias), dead = _dead_rows_case(11, T, length, S)
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        cuda).bfloat16()
    kcg = bf(np.asarray(j_group_cache(jnp.asarray(kc))))
    vcg = bf(np.asarray(j_group_cache(jnp.asarray(vc))))
    kw = {}
    if quant:
        (kcg, ks), (vcg, vs) = quantize_rows(kcg), quantize_rows(vcg)
        kw = dict(k_scale=ks, v_scale=vs)
    args = (bf(q), bf(kn), bf(vn), kcg, vcg,
            torch.tensor(length, dtype=torch.int32, device=cuda),
            torch.from_numpy(mask).to(cuda),
            torch.from_numpy(bias).to(cuda), 64 ** -0.5)
    ref = tta.tree_attention_plain(*args, **kw).float()
    dead = torch.from_numpy(dead).to(cuda)
    # the means are small beside the other rows: held to their own scale
    tol = 2e-2 * ref.abs().max().item()
    tol_dead = 2e-2 * ref[dead].abs().max().item()
    for nsplit in (1, 2):
        got = tta.tree_attention_launch(*args, nsplit, **kw).float()
        assert (got - ref).abs().max().item() <= tol, nsplit
        assert (got[dead] - ref[dead]).abs().max().item() <= tol_dead, nsplit
