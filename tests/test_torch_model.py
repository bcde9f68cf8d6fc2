"""``lantern_tpu_torch`` modules against their ``lantern_tpu`` counterparts
on the CPU: configs, trees, rope, sampling, acceptance, the nearest table,
the Chameleon glue, stale drafting, the weight bridge and the decoder
forward.  Inputs come from a numpy seed; tolerances f32 1e-5 (1e-4 for
logits), bf16 compared in f32 at rtol 2e-2."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu import trees as jt
from lantern_tpu.kv import KVCache as JKV
from lantern_tpu.models import chameleon as jcham
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops import acceptance as jacc
from lantern_tpu.ops import quant as jq
from lantern_tpu.ops import rope as jrope
from lantern_tpu.ops import sampling as jsmp
from lantern_tpu.ops.vq_distance import nearest_latents as j_nearest
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.kv import KVCache as TKV
from lantern_tpu_torch.models import chameleon as tcham
from lantern_tpu_torch.models import drafter as tdrf
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.ops import acceptance as tacc
from lantern_tpu_torch.ops import quant as tq
from lantern_tpu_torch.ops import rope as trope
from lantern_tpu_torch.ops import sampling as tsmp
from lantern_tpu_torch.ops.vq_distance import nearest_latents as t_nearest

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
TREE = "ckpts/bench_tree_lumina.json"
V = 8832     # covers the Lumina ids (image 4..8195, newline 8803, grid 8805)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def tiny_kw(**kw):
    base = dict(vocab_size=V, hidden_size=256, num_layers=2, num_heads=2,
                rope_kind="1d", cond_kind="none", qk_norm=True,
                swin_norm=True, max_seq_len=160)
    base.update(kw)
    return base


def to_port(params):
    return convert.convert_params(jax.tree.map(np.asarray, params),
                                  device="cpu")


# ------------------------------------------------------------ configs/trees

def _same_fields(t, j):
    """Every field of the port's config equals the JAX config's (the JAX
    one also carries XLA-only knobs the port has no use for)."""
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b)
        else:
            assert a == b, f.name


def test_configs_match_jax():
    for jcfg, tcfg in (
            (jc.chameleon_7b_config(2446, swin_norm=True),
             tc.chameleon_7b_config(2446, swin_norm=True)),
            (jc.tiny_config(**tiny_kw()), tc.tiny_config(**tiny_kw()))):
        _same_fields(tcfg, jcfg)
        assert tcfg.head_dim == jcfg.head_dim
        assert str(tcfg.torch_dtype).split(".")[-1] == str(jcfg.jnp_dtype)
    _same_fields(tc.drafter_config(tc.chameleon_7b_config(), top_k=10),
                 jc.drafter_config(jc.chameleon_7b_config(), top_k=10))


@pytest.mark.parametrize("tree", [TREE, "mc_sim_7b_63", "chain_bush_8"])
def test_trees_match_jax(tree):
    a, b = jt.get_tree(tree), ttr.get_tree(tree)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "levels":
            assert len(x) == len(y)
            for la, lb in zip(x, y):
                for g in dataclasses.fields(la):
                    np.testing.assert_array_equal(getattr(la, g.name),
                                                  getattr(lb, g.name))
        else:
            np.testing.assert_array_equal(np.asarray(x, dtype=object),
                                          np.asarray(y, dtype=object))
    if tree == TREE:
        assert (b.num_nodes, b.num_paths, b.max_depth, b.path_len) == (32, 18, 4, 5)


def test_tree_errors():
    with pytest.raises(KeyError, match="available"):
        ttr.get_tree("bogus")
    with pytest.raises(ValueError, match="prefix-closed"):
        ttr.compile_tree([[0, 0]])


# ---------------------------------------------------------------- rope

def test_rope_matches_jax():
    cj, sj = jrope.rope_table_1d(64, 128, 10000.0)
    ct, st = trope.rope_table_1d(64, 128, 10000.0)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(st, sj)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 128)).astype(np.float32)
    pos = rng.integers(0, 64, size=(2, 5))
    ref = jrope.apply_rope_half(jnp.asarray(x), cj, sj, jnp.asarray(pos))
    got = trope.apply_rope_half(torch.from_numpy(x), torch.from_numpy(ct),
                                torch.from_numpy(st), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


# ------------------------------------------------------------- sampling

WARPS = [dict(temperature=1.0, top_k=20), dict(temperature=0.7, top_p=0.8),
         dict(temperature=1.3, top_k=5, top_p=0.9, warp_order="ar"),
         dict(temperature=0.0)]


@pytest.mark.parametrize("wkw", WARPS)
def test_warp_logits_matches_jax(wkw):
    x = np.random.default_rng(1).normal(size=(4, 300)).astype(np.float32) * 3
    ref = jsmp.warp_logits(jnp.asarray(x), jsmp.LogitsWarp(**wkw))
    got = tsmp.warp_logits(torch.from_numpy(x), tsmp.LogitsWarp(**wkw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_kth_largest_and_cfg_combine_match_jax():
    x = np.random.default_rng(2).normal(size=(3, 5000)).astype(np.float32)
    np.testing.assert_array_equal(
        tsmp.kth_largest(torch.from_numpy(x), 2000).numpy(),
        np.asarray(jsmp.kth_largest(jnp.asarray(x), 2000)))
    np.testing.assert_allclose(
        tsmp.cfg_combine(torch.from_numpy(x[:2]), 3.0).numpy(),
        np.asarray(jsmp.cfg_combine(jnp.asarray(x[:2]), 3.0)), **F32)


def test_sample_token_distribution():
    """Draws from a torch.Generator follow softmax(warp(logits))."""
    logits = torch.from_numpy(
        np.random.default_rng(3).normal(size=(12,)).astype(np.float32))
    warp = tsmp.LogitsWarp(temperature=1.0, top_k=6)
    probs = torch.softmax(tsmp.warp_logits(logits, warp), -1).numpy()
    g = torch.Generator().manual_seed(0)
    n = 20000
    draws = tsmp.sample_token(g, logits[None].expand(n, 12), warp).numpy()
    freq = np.bincount(draws, minlength=12) / n
    assert np.all(freq[probs == 0] == 0)
    np.testing.assert_allclose(freq, probs, atol=0.015)
    assert tsmp.sample_token(g, logits, tsmp.LogitsWarp(temperature=0.0)) == \
        int(np.argmax(logits.numpy()))


def test_residual_q_matches_jax():
    """The drafter's residual acceptance probabilities of given draws."""
    probs = np.random.default_rng(4).dirichlet(np.ones(40), size=(3,)).astype(np.float32)
    probs[2, :] = 0.0
    probs[2, 0] = 1.0                        # one-hot row: later q are 0/0
    idx, qj = jsmp.sample_without_replacement(jax.random.key(0),
                                              jnp.asarray(probs), 6)
    p_sel = np.take_along_axis(probs, np.asarray(idx), axis=-1)
    qt = tsmp.residual_q(torch.from_numpy(p_sel))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), **F32)


# ------------------------------------------------------------ acceptance

AV = 64


@pytest.fixture(scope="module")
def nearest_small():
    emb = np.random.default_rng(0).normal(size=(AV, 4))
    d = ((emb[:, None] - emb[None]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, 1:12].astype(np.int32)


def _draftlike(rng, spec):
    toks = np.zeros((spec.num_nodes,), np.int32)
    toks[0] = rng.integers(0, AV)
    for s in range(spec.num_nodes):
        kids = [k for k in spec.children[s] if k >= 0]
        if kids:
            toks[kids] = rng.choice(AV, size=len(kids), replace=False)
    return toks


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lantern", [(0, 0.0), (4, 0.3), (6, 3.0)])
def test_greedy_verify_matches_jax(nearest_small, seed, lantern):
    spec = jt.get_tree(TREE)
    rng = np.random.default_rng(seed)
    toks = _draftlike(rng, spec)
    logits = rng.normal(size=(spec.num_nodes, AV)).astype(np.float32) * 2
    # plant a few argmax matches so paths accept
    for s in range(1, spec.num_nodes):
        if rng.random() < 0.5:
            logits[spec.parent_slot[s], toks[s]] += 8.0
    ret = np.where(spec.retrieve_indices < 0, 0, spec.retrieve_indices)
    cand = np.where(spec.retrieve_indices < 0, -1, toks[ret])
    path_logits = logits[ret]
    jl, tl = jacc.LanternSpec(*lantern), tacc.LanternSpec(*lantern)
    bj, aj, lj = jacc.greedy_verify(jnp.asarray(path_logits), jnp.asarray(cand),
                                    jnp.asarray(nearest_small), jl)
    bt, at, lt = tacc.greedy_verify(torch.from_numpy(path_logits),
                                    torch.from_numpy(cand),
                                    torch.from_numpy(nearest_small), tl)
    assert (int(bt), int(at)) == (int(bj), int(aj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_relaxed_prob_matches_jax(nearest_small):
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(AV), size=(5,)).astype(np.float32)
    tok = rng.integers(0, AV, size=(5,)).astype(np.int32)
    for delta in (0.2, 2.5):
        pj, jj = jacc.relaxed_prob(jnp.asarray(probs), jnp.asarray(tok),
                                   jnp.asarray(nearest_small),
                                   jacc.LanternSpec(5, delta))
        pt, jt_ = tacc.relaxed_prob(torch.from_numpy(probs),
                                    torch.from_numpy(tok),
                                    torch.from_numpy(nearest_small),
                                    tacc.LanternSpec(5, delta))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **F32)
        np.testing.assert_array_equal(jt_.numpy(), np.asarray(jj))


def _walk_inputs(seed, spec, multidraft):
    rng = np.random.default_rng(seed)
    toks = _draftlike(rng, spec)
    logits = rng.normal(size=(spec.num_nodes, AV)).astype(np.float32) * 2
    for s in range(1, spec.num_nodes):
        logits[spec.parent_slot[s], toks[s]] += rng.choice([0.0, 3.0])
    extra = {}
    if multidraft:
        rows = [1] + [len(lv.child_flat_idx) for lv in spec.levels]
        extra["level_probs"] = [rng.dirichlet(np.ones(AV), size=(r,)).astype(np.float32)
                                for r in rows]
        extra["node_q"] = rng.uniform(0.05, 1.0, size=(spec.num_nodes,)).astype(np.float32)
        extra["node_level_row"] = spec.inlevel_rank.astype(np.int32)
    return toks, logits, extra


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("u", [0.05, 0.5, 0.95])
@pytest.mark.parametrize("variant", ["plain", "lantern", "multidraft",
                                     "multidraft_lantern"])
def test_stochastic_verify_tree_matches_jax(nearest_small, seed, u, variant):
    spec = jt.get_tree(TREE)
    multidraft = variant.startswith("multidraft")
    lantern = (4, 0.4) if variant.endswith("lantern") else (0, 0.0)
    toks, logits, extra = _walk_inputs(seed, spec, multidraft)
    uni = np.full((spec.max_depth, spec.children.shape[1]), u, np.float32)
    warp_kw = dict(temperature=1.0, top_k=30)
    for bw in (True, False):
        pj, aj, dj = jacc.stochastic_verify_tree(
            None, jnp.asarray(logits), jnp.asarray(toks),
            jnp.asarray(spec.children), spec.max_depth,
            jsmp.LogitsWarp(**warp_kw), nearest=jnp.asarray(nearest_small),
            lantern=jacc.LanternSpec(*lantern),
            node_q=None if not multidraft else jnp.asarray(extra["node_q"]),
            level_probs=None if not multidraft else [jnp.asarray(p) for p in extra["level_probs"]],
            node_level_row=None if not multidraft else jnp.asarray(extra["node_level_row"]),
            uniforms=jnp.asarray(uni), batch_warp=bw)
        pt, at, dt = tacc.stochastic_verify_tree(
            None, torch.from_numpy(logits), torch.from_numpy(toks),
            torch.from_numpy(spec.children), spec.max_depth,
            tsmp.LogitsWarp(**warp_kw), nearest=torch.from_numpy(nearest_small),
            lantern=tacc.LanternSpec(*lantern),
            node_q=None if not multidraft else torch.from_numpy(extra["node_q"]),
            level_probs=None if not multidraft else [torch.from_numpy(p) for p in extra["level_probs"]],
            node_level_row=None if not multidraft else torch.from_numpy(extra["node_level_row"]),
            uniforms=torch.from_numpy(uni), batch_warp=bw)
        assert int(at) == int(aj)
        np.testing.assert_array_equal(pt.numpy()[: int(at) + 1],
                                      np.asarray(pj)[: int(aj) + 1])
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **F32)


def test_stochastic_verify_tree_acceptance_rate():
    """With a torch.Generator, a single-child tree accepts its child with
    probability min(1, p(x) / q(x)) — here p(x) = 0.6, q = 1."""
    spec = ttr.get_tree([[0]])
    p = torch.tensor([0.6, 0.3, 0.1])
    logits = torch.log(p)[None].expand(2, 3).contiguous()
    toks = torch.tensor([2, 0], dtype=torch.int32)
    g = torch.Generator().manual_seed(3)
    n, hits = 3000, 0
    for _ in range(n):
        _, alen, _ = tacc.stochastic_verify_tree(
            g, logits, toks, torch.from_numpy(spec.children), 1,
            tsmp.LogitsWarp(temperature=1.0))
        hits += int(alen)
    assert abs(hits / n - 0.6) < 0.03


# --------------------------------------------- nearest table and Chameleon

def test_nearest_latents_matches_jax():
    cb = np.random.default_rng(5).normal(size=(96, 8)).astype(np.float32)
    for norm in (False, True):
        np.testing.assert_array_equal(
            t_nearest(torch.from_numpy(cb), k=11, l2_normalize=norm),
            j_nearest(jnp.asarray(cb), k=11, l2_normalize=norm))


def test_chameleon_glue_matches_jax():
    np.testing.assert_array_equal(tcham.non_image_token_mask(),
                                  jcham.non_image_token_mask())
    table = np.random.default_rng(6).integers(0, 8192, size=(8192, 11))
    np.testing.assert_array_equal(tcham.shift_nearest_table(table),
                                  jcham.shift_nearest_table(table))
    for grid in ((48, 48), (16, 16), (4, 4)):
        a = jcham.lumina_token_prompt(list(range(60000, 60016)), grid=grid)
        b = tcham.lumina_token_prompt(list(range(60000, 60016)), grid=grid)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("start", [None, 5])
def test_lumina_grid_fsm_matches_jax(start):
    kw = dict(w=4, h=3, image_start_idx=3, vocab_size=V)
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(40, V)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32) + 2
    ref = jcham.LuminaGridFSM(**kw)(
        jnp.asarray(logits), jnp.asarray(pos),
        start=None if start is None else jnp.int32(start))
    got = tcham.LuminaGridFSM(**kw)(
        torch.from_numpy(logits), torch.from_numpy(pos),
        start=None if start is None else torch.tensor(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -------------------------------------------------------- stale drafting

@pytest.mark.parametrize("mode", ["greedy", "pinned"])
def test_draft_stale_matches_jax(mode):
    spec_j, spec_t = jt.get_tree(TREE), ttr.get_tree(TREE)
    rng = np.random.default_rng(8)
    root = rng.normal(size=(V,)).astype(np.float32) * 3
    mask = jcham.non_image_token_mask(V)
    fkw = dict(w=4, h=4, image_start_idx=16, vocab_size=V)
    if mode == "greedy":
        wj, wt, pin = jsmp.LogitsWarp(temperature=0.0), tsmp.LogitsWarp(temperature=0.0), None
    else:
        wj = jsmp.LogitsWarp(temperature=1.0, top_k=2000)
        wt = tsmp.LogitsWarp(temperature=1.0, top_k=2000)
        pin = 0.5
    dj = jdrf.draft_stale(spec_j, jnp.asarray(root), jnp.int32(20), wj,
                          jax.random.key(0), logits_mask=jnp.asarray(mask),
                          logits_fn=jcham.LuminaGridFSM(**fkw), pin=pin)
    dt = tdrf.draft_stale(spec_t, torch.from_numpy(root),
                          torch.tensor(20, dtype=torch.int32), wt, None,
                          logits_mask=torch.from_numpy(mask),
                          logits_fn=tcham.LuminaGridFSM(**fkw), pin=pin)
    # forced (newline / end) rows tie on every masked entry, whose order
    # top-k leaves open; the proposals that can ever be accepted (finite
    # logits, or q > 0 when pinned) must agree in order
    sj = np.asarray(dj.ss_prob)
    ok = sj > 0 if mode == "pinned" else sj > -1e30
    assert dt.ss_token.shape == dj.ss_token.shape and ok.any()
    np.testing.assert_array_equal(dt.ss_token.numpy()[ok],
                                  np.asarray(dj.ss_token)[ok])
    np.testing.assert_allclose(dt.ss_prob.numpy(), sj, **F32)
    for a, b in zip(dt.level_probs, dj.level_probs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_draft_stale_sampling_distribution():
    """Unpinned sampling: each level's first proposal is distributed as
    the warped stale distribution."""
    spec = ttr.get_tree("chain_bush_8")
    logits = torch.tensor([2.0, 1.0, 0.5, -1.0, -3.0] + [-30.0] * 11)
    warp = tsmp.LogitsWarp(temperature=1.0, top_k=4)
    p = torch.softmax(tsmp.warp_logits(logits, warp), -1).numpy()
    g = torch.Generator().manual_seed(2)
    firsts = [int(tdrf.draft_stale(spec, logits, torch.tensor(0), warp, g)
                  .ss_token[0, 0]) for _ in range(3000)]
    np.testing.assert_allclose(np.bincount(firsts, minlength=16) / 3000, p,
                               atol=0.03)


# ------------------------------------------------------------ weight bridge

@pytest.fixture(scope="module")
def jax_params():
    cfg = jc.tiny_config(**tiny_kw())
    return cfg, jtfm.init_params(jax.random.key(0), cfg)


@pytest.mark.parametrize("layout", ["split", "fused", "quantized",
                                    "bf16_fused_quantized"])
def test_convert_layouts(jax_params, layout):
    cfg, p = jax_params
    if layout.startswith("bf16"):
        p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    if layout != "split":
        p = jtfm.fuse_params(p)
    if "quantized" in layout:
        p = jq.quantize_params(p)
    p = dict(p, nearest_latents=jnp.zeros((V, 11), jnp.int32))
    out = convert.convert_params(jax.tree.map(np.asarray, p), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(p)[0]
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        t = out
        for k in keys:
            t = t[k]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
        np.testing.assert_array_equal(f32(t), f32(leaf))
    # the port's own fuse_params and quantize_params give the bridged layout
    if layout in ("fused", "quantized"):
        tp = convert.convert_params(
            jax.tree.map(np.asarray, jax_params[1]), device="cpu")
        tp = ttfm.fuse_params(tp)
        if layout == "quantized":
            tp = tq.quantize_params(tp)
        for k, v in tp["layers"].items():
            np.testing.assert_array_equal(f32(v), f32(out["layers"][k]))


def test_convert_rejects_bad_layouts(jax_params):
    _, p = jax_params
    q = jq.quantize_params(jtfm.fuse_params(p))
    bad = jax.tree.map(np.asarray, q)
    del bad["layers"]["wo_s"]
    with pytest.raises(ValueError, match="wo_q"):
        convert.convert_params(bad, device="cpu")
    with pytest.raises(ValueError, match="unknown entries"):
        convert.convert_params(dict(jax.tree.map(np.asarray, p),
                                    vision_tower={"w": np.zeros((2, 2))}),
                               device="cpu")


def test_init_and_fuse_shapes_match_jax(jax_params):
    cfg, p = jax_params
    tp = ttfm.init_params(torch.Generator().manual_seed(0),
                          tc.tiny_config(**tiny_kw()), device="cpu")
    for k in p["layers"]:
        assert tuple(tp["layers"][k].shape) == p["layers"][k].shape
    fj, ft = jtfm.fuse_params(p), ttfm.fuse_params(tp)
    assert sorted(fj["layers"]) == sorted(ft["layers"])
    assert tp["embed"].std().item() == pytest.approx(0.02, rel=0.1)


def test_build_mask_matches_jax():
    pv = np.ones((2, 32), bool)
    pv[1, :3] = False
    bm = np.tril(np.ones((4, 4), bool))
    mj = jtfm.build_mask(4, 32, jnp.int32(9), jnp.asarray(bm), jnp.asarray(pv), 2)
    mt = ttfm.build_mask(4, 32, torch.tensor(9), torch.from_numpy(bm),
                         torch.from_numpy(pv), 2)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_norms_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 3, 2, 128)).astype(np.float32)
    w, b = rng.normal(size=(2, 2, 128)).astype(np.float32)
    np.testing.assert_allclose(
        ttfm.head_layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-5).numpy(),
        np.asarray(jtfm.head_layer_norm(*map(jnp.asarray, (x, w, b)), 1e-5)),
        **F32)
    np.testing.assert_allclose(
        ttfm.rms_norm(torch.from_numpy(x), torch.from_numpy(w[0]), 1e-5).numpy(),
        np.asarray(jtfm.rms_norm(jnp.asarray(x), jnp.asarray(w[0]), 1e-5)),
        **F32)


# ---------------------------------------------------------------- forward

def _forward_pair(cfg_j, cfg_t, pj, pt, kvq, defer):
    """Prefill a 19-token prompt (T=19, left-padded uncond row), run a
    32-node tree block (T=32, ancestor mask, optional deferred rows from a
    previous block via extra_kv), then one T=1 step.  Returns
    ``(kind, jax value, port value)`` for each stage's hidden states and
    logits, the carried block, and the cache planes."""
    spec = jt.get_tree(TREE)
    rng = np.random.default_rng(11)
    L = 19
    ids = rng.integers(4, 8196, size=(2, L)).astype(np.int32)
    valid = np.ones((2, L), bool)
    valid[1, :16] = False
    pos = np.stack([np.arange(L), np.r_[np.zeros(16), np.arange(3)]]).astype(np.int32)
    block = np.tril(np.ones((L, L), bool))[None] & valid[:, None, :]
    ropej = jtfm.make_rope_tables(cfg_j)
    ropet = ttfm.make_rope_tables(cfg_t, "cpu")
    kj = JKV.create(cfg_j, 2, quantized=kvq)
    kt = TKV.create(cfg_t, 2, quantized=kvq, device="cpu")
    outs = []

    def both(rj, rt):
        outs.append(("hidden", rj.hidden, rt.hidden))
        outs.append(("logits", jtfm.logits_head(pj, rj.hidden),
                     ttfm.logits_head(pt, rt.hidden)))

    rj = jtfm.forward(pj, cfg_j, jtfm.token_embed(pj, jnp.asarray(ids)), kj,
                      jnp.asarray(pos), ropej, block_mask=jnp.asarray(block))
    rt = ttfm.forward(pt, cfg_t, ttfm.token_embed(pt, torch.from_numpy(ids)), kt,
                      torch.from_numpy(pos), ropet,
                      block_mask=torch.from_numpy(block))
    both(rj, rt)
    kj, kt = rj.kv, rt.kv
    pvj = np.ones((2, kj.max_len), bool)
    pvj[:, :L] = valid
    tree_ids = rng.integers(4, 8196, size=(2, spec.num_nodes)).astype(np.int32)
    tpos = L + spec.depth
    extra_j = extra_t = None
    if defer:
        # a previous block's 3 accepted rows ride in as extra_kv
        ex = rng.normal(size=(2, cfg_j.num_layers, 2, 5, 2, 128)).astype(np.float32)
        extra_j = (jnp.asarray(ex[0], cfg_j.jnp_dtype), jnp.asarray(ex[1], cfg_j.jnp_dtype), jnp.int32(3))
        extra_t = (torch.from_numpy(ex[0]).to(cfg_t.torch_dtype),
                   torch.from_numpy(ex[1]).to(cfg_t.torch_dtype),
                   torch.tensor(3, dtype=torch.int32))
        tpos = tpos + 3
    rj = jtfm.forward(pj, cfg_j, jtfm.token_embed(pj, jnp.asarray(tree_ids)), kj,
                      jnp.asarray(tpos), ropej, block_mask=jnp.asarray(spec.attn_mask),
                      prefix_valid=jnp.asarray(pvj), commit=False,
                      extra_kv=extra_j, defer_block=defer)
    rt = ttfm.forward(pt, cfg_t, ttfm.token_embed(pt, torch.from_numpy(tree_ids)), kt,
                      torch.from_numpy(tpos), ropet,
                      block_mask=torch.from_numpy(spec.attn_mask),
                      prefix_valid=torch.from_numpy(pvj), commit=False,
                      extra_kv=extra_t, defer_block=defer)
    both(rj, rt)
    if defer:
        for a, b in zip(rt.block, rj.block):
            outs.append(("block", b, a))
    kj, kt = rj.kv, rt.kv
    assert int(kt.length) == int(kj.length)
    one = np.asarray([[77], [77]], np.int32)
    p1 = np.asarray([[L + 8], [8]], np.int32)
    rj = jtfm.forward(pj, cfg_j, jtfm.token_embed(pj, jnp.asarray(one)), kj,
                      jnp.asarray(p1), ropej, prefix_valid=jnp.asarray(pvj))
    rt = ttfm.forward(pt, cfg_t, ttfm.token_embed(pt, torch.from_numpy(one)), kt,
                      torch.from_numpy(p1), ropet,
                      prefix_valid=torch.from_numpy(pvj))
    both(rj, rt)
    outs.append(("cache_q" if kvq else "cache", rj.kv.k, rt.kv.k))
    if kvq:
        outs.append(("scale", rj.kv.k_scale, rt.kv.k_scale))
    return outs


@pytest.mark.parametrize("dtype,kvq,weights,defer", [
    ("float32", False, "fused", False),
    ("float32", True, "quantized", True),
    ("float32", True, "split", False),
    ("float32", False, "quantized", True),
    ("bfloat16", False, "quantized", True),
    ("bfloat16", True, "quantized", True),
    ("bfloat16", True, "fused", False),
])
def test_forward_matches_jax(dtype, kvq, weights, defer):
    cfg_j = jc.tiny_config(**tiny_kw(dtype=dtype))
    cfg_t = tc.tiny_config(**tiny_kw(dtype=dtype))
    pj = jtfm.init_params(jax.random.key(1), cfg_j)
    if weights != "split":
        pj = jtfm.fuse_params(pj)
    if weights == "quantized":
        pj = jq.quantize_params(pj)
    pt = to_port(pj)
    for kind, ref, got in _forward_pair(cfg_j, cfg_t, pj, pt, kvq, defer):
        r, g = f32(ref), f32(got)
        assert r.shape == g.shape, kind
        if kind == "cache_q":
            # a last-bit difference of a key can flip one int8 rounding
            d = np.abs(g - r)
            assert d.max() <= (1 if dtype == "float32" else 2), kind
            assert (d > 0).mean() < (1e-3 if dtype == "float32" else 5e-2), kind
        elif dtype == "float32" and not kvq:
            np.testing.assert_allclose(g, r, **(LOGITS if kind == "logits"
                                                else F32), err_msg=kind)
        else:
            # bf16 rounds at other places than XLA does, and with an int8
            # cache one flipped rounding moves a key by 1/127 of its row's
            # max: compare against the stage's scale
            rel = 2e-2 if dtype == "bfloat16" else 5e-3
            assert np.abs(g - r).max() <= rel * np.abs(r).max(), kind
