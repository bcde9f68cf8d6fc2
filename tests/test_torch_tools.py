"""The port's tuning tools against ``lantern_tpu`` on the CPU.

- ``trees.optimize_tree``: the same paths for the 1-D and 2-D forms at
  several budgets and depths, the same compiled trees and the same
  validation errors;
- ``acceptance``: ``_dedup_mask``; the path-table ``stochastic_verify`` in
  EAGLE-2 and EAGLE-1 multi-draft mode, with and without LANTERN, with the
  coins pinned: the same ``(best, accept_len)`` and ``sample_dist`` within
  1e-6; the operating point ``rt`` in ``greedy_verify`` and
  ``stochastic_verify_tree`` equal to JAX's, ``spec.runtime()`` equal to
  ``rt=None`` bit for bit, and a wide spec at ``rt = (k', d')`` equal to a
  static ``LanternSpec(k', d')``;
- ``spec.generate(lantern_rt=)`` token-exact against JAX: LlamaGen static
  greedy and dynamic pinned, Lumina static pinned and dynamic greedy;
- ``autotune``: the verify forward's logits equal JAX's; with both
  modules' ``time_verify_forward`` replaced by one table of times,
  ``autotune_total_tokens`` picks the same candidate (default and
  interpolated weights);
- ``calibrate``: ``_teacher_hidden`` within f32 tolerance; under a greedy
  warp ``measure_rank_probs`` and ``measure_stale_rank_probs`` equal
  JAX's arrays; the Monte Carlo ``measure_stale_accept_probs`` and
  ``measure_drafter_accept_probs`` agree with JAX per entry within
  ``4 sqrt(p (1 - p) / n) + 1 / n`` and are equal under top-1 proposals.

Configs: the tiny LlamaGen of ``tests/test_torch_llamagen.py`` (head_dim
64, label or left-padded caption) and a tiny head_dim-128 Chameleon with
the Lumina grid FSM, as ``tests/test_torch_engine.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu import trees as jt
from lantern_tpu.engine import autotune as jat
from lantern_tpu.engine import calibrate as jcal
from lantern_tpu.engine import spec as jspec
from lantern_tpu.kv import KVCache as JKV
from lantern_tpu.models import chameleon as jcham
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops import acceptance as jacc
from lantern_tpu.ops.sampling import LogitsWarp as JWarp
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.engine import autotune as tat
from lantern_tpu_torch.engine import calibrate as tcal
from lantern_tpu_torch.engine import spec as tspec
from lantern_tpu_torch.models import chameleon as tcham
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.ops import acceptance as tacc
from lantern_tpu_torch.ops.sampling import LogitsWarp as TWarp

from test_torch_llamagen import lane, one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)
DIST = dict(rtol=0, atol=1e-6)
TREE = "ckpts/bench_tree_lumina.json"
AV = 64                       # the verifier tests' vocab
NEIGH = 11                    # their nearest-table width


def _paths(paths):
    return [list(p) for p in paths]


# ------------------------------------------------------------ optimize_tree

@pytest.mark.parametrize("form", ["1d", "2d"])
@pytest.mark.parametrize("num_nodes,max_depth",
                         [(1, 1), (7, 3), (26, 5), (60, 8), (40, 2)])
def test_optimize_tree_matches_jax(form, num_nodes, max_depth):
    rng = np.random.default_rng(num_nodes)
    shape = (10,) if form == "1d" else (3, 10)
    probs = rng.uniform(0.01, 0.95, size=shape)
    probs[..., 3] = probs[..., 4]          # a tie, broken by path order
    pt = ttr.optimize_tree(probs, num_nodes, max_depth)
    pj = jt.optimize_tree(probs, num_nodes, max_depth)
    assert _paths(pt) == _paths(pj)
    assert len(pt) == num_nodes and max(len(p) for p in pt) <= max_depth
    st, sj = ttr.get_tree(pt), jt.get_tree(pj)
    for f in ("retrieve_indices", "attn_mask", "children", "p_indices",
              "b_indices", "inlevel_rank"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f), f)


@pytest.mark.parametrize("probs,num_nodes", [
    ([], 5), ([0.5, 0.2], 0), ([0.5, 0.0], 4), ([0.5, 1.2], 4),
    ([[0.5, 0.3], [0.2, -0.1]], 4)])
def test_optimize_tree_errors_match_jax(probs, num_nodes):
    with pytest.raises(ValueError) as et:
        ttr.optimize_tree(probs, num_nodes)
    with pytest.raises(ValueError) as ej:
        jt.optimize_tree(probs, num_nodes)
    assert str(et.value) == str(ej.value)


# ------------------------------------------------------------ verifiers

@pytest.fixture(scope="module")
def nearest_small():
    emb = np.random.default_rng(0).normal(size=(AV, 4))
    d = ((emb[:, None] - emb[None]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, 1:NEIGH + 1].astype(np.int32)


def _draftlike(rng, spec, collide=False):
    """Distinct sibling tokens as a drafter samples them; ``collide`` gives
    the root's second child its first child's token (the dedup path)."""
    toks = np.zeros((spec.num_nodes,), np.int32)
    toks[0] = rng.integers(0, AV)
    for s in range(spec.num_nodes):
        kids = [k for k in spec.children[s] if k >= 0]
        if kids:
            toks[kids] = rng.choice(AV, size=len(kids), replace=False)
    if collide:
        toks[spec.children[0, 1]] = toks[spec.children[0, 0]]
    return toks


def _case(seed, multidraft, collide=False):
    """A verification step over the calibrated Lumina tree: tree tokens,
    node logits with planted matches, the path table, and (multi-draft)
    the drafter's level distributions and residual q."""
    spec = jt.get_tree(TREE)
    rng = np.random.default_rng(seed)
    toks = _draftlike(rng, spec, collide)
    node_logits = rng.normal(size=(spec.num_nodes, AV)).astype(np.float32) * 2
    for s in range(1, spec.num_nodes):
        node_logits[spec.parent_slot[s], toks[s]] += rng.choice([0.0, 3.0])
    ret = np.where(spec.retrieve_indices < 0, 0, spec.retrieve_indices)
    c = dict(spec=spec, toks=toks, node_logits=node_logits,
             cand=np.where(spec.retrieve_indices < 0, -1, toks[ret]),
             path_logits=node_logits[ret])
    if multidraft:
        rows = [1] + [len(lv.child_flat_idx) for lv in spec.levels]
        c["level_probs"] = [rng.dirichlet(np.ones(AV), size=(r,)).astype(np.float32)
                            for r in rows]
        node_q = rng.uniform(0.05, 1.0, size=(spec.num_nodes,)).astype(np.float32)
        node_q[0] = 1.0
        c["node_q"] = node_q
        c["q_probs"] = np.concatenate([node_q, [1.0]]).astype(np.float32)[
            spec.retrieve_indices]
    return c


def test_dedup_mask_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(8):
        tok = rng.integers(-1, 5, size=(12,)).astype(np.int32)
        eligible = rng.random(12) < 0.7
        got = tacc._dedup_mask(torch.from_numpy(tok), torch.from_numpy(eligible))
        want = jacc._dedup_mask(jnp.asarray(tok), jnp.asarray(eligible))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_jstoch = jax.jit(jacc.stochastic_verify, static_argnames=("warp", "lantern"))
WALK_WARP = dict(temperature=1.0, top_k=30)
VARIANTS = {"eagle2": (False, (0, 0.0), None),
            "eagle2_lantern": (False, (4, 0.4), None),
            "eagle2_lantern_rt": (False, (8, 0.123), (4, 0.4)),
            "multidraft": (True, (0, 0.0), None),
            "multidraft_lantern": (True, (4, 3.0), None)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("u", [0.05, 0.5, 0.95])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stochastic_verify_matches_jax(nearest_small, seed, u, variant):
    multidraft, lantern, rt = VARIANTS[variant]
    c = _case(seed, multidraft, collide=seed == 1 and not multidraft)
    spec = c["spec"]
    D, P = spec.path_len, spec.num_paths
    uni = np.full((D - 1, P), u, np.float32)
    md = {}
    if multidraft:
        md = dict(q_probs=c["q_probs"], level_probs=c["level_probs"],
                  p_indices=spec.p_indices, b_indices=spec.b_indices,
                  tree_tokens=c["toks"])
    bj, aj, dj = _jstoch(
        None, jnp.asarray(c["path_logits"]), jnp.asarray(c["cand"]),
        JWarp(**WALK_WARP), nearest=jnp.asarray(nearest_small),
        lantern=jacc.LanternSpec(*lantern), uniforms=jnp.asarray(uni),
        rt=None if rt is None else jacc.LanternSpec(*lantern).runtime(*rt),
        **{k: (tuple(jnp.asarray(x) for x in v) if k == "level_probs"
               else jnp.asarray(v)) for k, v in md.items()})
    bt, at, dt = tacc.stochastic_verify(
        None, torch.from_numpy(c["path_logits"]), torch.from_numpy(c["cand"]),
        TWarp(**WALK_WARP), nearest=torch.from_numpy(nearest_small),
        lantern=tacc.LanternSpec(*lantern), uniforms=torch.from_numpy(uni),
        rt=None if rt is None else tacc.LanternSpec(*lantern).runtime(*rt),
        **{k: ([torch.from_numpy(x) for x in v] if k == "level_probs"
               else torch.from_numpy(np.asarray(v))) for k, v in md.items()})
    assert (int(bt), int(at)) == (int(bj), int(aj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **DIST)


def test_stochastic_verify_equals_tree_walk(nearest_small):
    """The port's path-table verifier and its tree walk accept the same
    tokens and give the same bonus distribution (multi-draft, LANTERN)."""
    c = _case(2, True)
    spec = c["spec"]
    lant = tacc.LanternSpec(4, 3.0)
    for u in (0.05, 0.5, 0.95):
        b, a, d = tacc.stochastic_verify(
            None, torch.from_numpy(c["path_logits"]),
            torch.from_numpy(c["cand"]), TWarp(**WALK_WARP),
            nearest=torch.from_numpy(nearest_small), lantern=lant,
            q_probs=torch.from_numpy(c["q_probs"]),
            level_probs=[torch.from_numpy(x) for x in c["level_probs"]],
            p_indices=torch.from_numpy(spec.p_indices),
            b_indices=torch.from_numpy(spec.b_indices),
            tree_tokens=torch.from_numpy(c["toks"]),
            uniforms=torch.full((spec.path_len - 1, spec.num_paths), u))
        p, a2, d2 = tacc.stochastic_verify_tree(
            None, torch.from_numpy(c["node_logits"]),
            torch.from_numpy(c["toks"]), torch.from_numpy(spec.children),
            spec.max_depth, TWarp(**WALK_WARP),
            nearest=torch.from_numpy(nearest_small), lantern=lant,
            node_q=torch.from_numpy(c["node_q"]),
            level_probs=[torch.from_numpy(x) for x in c["level_probs"]],
            node_level_row=torch.from_numpy(spec.inlevel_rank),
            uniforms=torch.full((spec.max_depth, spec.children.shape[1]), u))
        assert int(a) == int(a2)
        np.testing.assert_array_equal(
            c["cand"][int(b), : int(a) + 1],
            c["toks"][p.numpy()[: int(a2) + 1]])
        np.testing.assert_allclose(d.numpy(), d2.numpy(), **DIST)


RT_POINTS = [(3, 0.2), (5, 0.45), (8, 5.0), (8, 20.0)]


@pytest.mark.parametrize("k_eff,delta_eff", RT_POINTS)
def test_greedy_verify_rt(nearest_small, k_eff, delta_eff):
    c = _case(3, False)
    pl, cand = c["path_logits"], c["cand"]
    wide_t, wide_j = tacc.LanternSpec(NEIGH - 1, 0.123), jacc.LanternSpec(NEIGH - 1, 0.123)
    nt, nj = torch.from_numpy(nearest_small), jnp.asarray(nearest_small)
    got = tacc.greedy_verify(torch.from_numpy(pl), torch.from_numpy(cand), nt,
                             wide_t, rt=wide_t.runtime(k_eff, delta_eff))
    want = jacc.greedy_verify(jnp.asarray(pl), jnp.asarray(cand), nj, wide_j,
                              rt=wide_j.runtime(k_eff, delta_eff))
    static = tacc.greedy_verify(torch.from_numpy(pl), torch.from_numpy(cand),
                                nt, tacc.LanternSpec(k_eff, delta_eff))
    for g, w, s in zip(got, want, static):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, s)
    # the default runtime point is the static one, bit for bit
    spec = tacc.LanternSpec(k_eff, delta_eff)
    for a, b in zip(tacc.greedy_verify(torch.from_numpy(pl),
                                       torch.from_numpy(cand), nt, spec,
                                       rt=spec.runtime()),
                    tacc.greedy_verify(torch.from_numpy(pl),
                                       torch.from_numpy(cand), nt, spec)):
        assert torch.equal(a, b)


_jtree = jax.jit(jacc.stochastic_verify_tree,
                 static_argnames=("depth", "warp", "lantern", "batch_warp"))


@pytest.mark.parametrize("u", [0.05, 0.5, 0.95])
@pytest.mark.parametrize("k_eff,delta_eff", RT_POINTS)
def test_stochastic_verify_tree_rt(nearest_small, u, k_eff, delta_eff):
    c = _case(5, True)
    spec = c["spec"]
    C = spec.children.shape[1]
    uni = np.full((spec.max_depth, C), u, np.float32)

    def port(lantern, rt=None):
        return tacc.stochastic_verify_tree(
            None, torch.from_numpy(c["node_logits"]),
            torch.from_numpy(c["toks"]), torch.from_numpy(spec.children),
            spec.max_depth, TWarp(**WALK_WARP),
            nearest=torch.from_numpy(nearest_small), lantern=lantern,
            node_q=torch.from_numpy(c["node_q"]),
            level_probs=[torch.from_numpy(x) for x in c["level_probs"]],
            node_level_row=torch.from_numpy(spec.inlevel_rank),
            uniforms=torch.from_numpy(uni), rt=rt, batch_warp=True)

    wide_t, wide_j = tacc.LanternSpec(NEIGH - 1, 0.123), jacc.LanternSpec(NEIGH - 1, 0.123)
    pj, aj, dj = _jtree(
        None, jnp.asarray(c["node_logits"]), jnp.asarray(c["toks"]),
        jnp.asarray(spec.children), depth=spec.max_depth,
        warp=JWarp(**WALK_WARP), nearest=jnp.asarray(nearest_small),
        lantern=wide_j, node_q=jnp.asarray(c["node_q"]),
        level_probs=tuple(jnp.asarray(x) for x in c["level_probs"]),
        node_level_row=jnp.asarray(spec.inlevel_rank),
        uniforms=jnp.asarray(uni), rt=wide_j.runtime(k_eff, delta_eff),
        batch_warp=True)
    pt, at, dt = port(wide_t, wide_t.runtime(k_eff, delta_eff))
    assert int(at) == int(aj)
    np.testing.assert_array_equal(pt.numpy()[: int(at) + 1],
                                  np.asarray(pj)[: int(aj) + 1])
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **DIST)
    # a wide spec at (k', d') walks as the static LanternSpec(k', d')
    ps, as_, ds = port(tacc.LanternSpec(k_eff, delta_eff))
    assert int(as_) == int(at)
    np.testing.assert_array_equal(ps.numpy()[: int(at) + 1],
                                  pt.numpy()[: int(at) + 1])
    np.testing.assert_allclose(ds.numpy(), dt.numpy(), **DIST)
    # runtime() at the static point is rt=None bit for bit
    spec_s = tacc.LanternSpec(k_eff, delta_eff)
    for a, b in zip(port(spec_s, spec_s.runtime()), (ps, as_, ds)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ lantern_rt

CV = 8832                       # holds the Lumina ids
GRID = 4
TEXT = [60, 61, 62, 63, 9]
CH_KW = dict(vocab_size=CV, hidden_size=256, num_layers=2, num_heads=2,
             rope_kind="1d", cond_kind="none", qk_norm=True, swin_norm=True,
             max_seq_len=80)
DYN = dict(total_tokens=10, depth=2, top_k=4)


@pytest.fixture(scope="module")
def lumina():
    """Both packages' tiny Lumina model, a random EAGLE drafter (dynamic
    trees), a nearest table over the image ids, the prompt and FSM."""
    cfg_j, cfg_t = jc.tiny_config(**CH_KW), tc.tiny_config(**CH_KW)
    dcfg_j, dcfg_t = (jc.drafter_config(cfg_j, **DYN),
                      tc.drafter_config(cfg_t, **DYN))
    base = jtfm.fuse_params(jtfm.init_params(jax.random.key(0), cfg_j))
    dj = jtfm.fuse_params(jdrf.init_drafter_params(jax.random.key(1), dcfg_j,
                                                   base["embed"]))
    near = np.random.default_rng(0).integers(4, 8196, size=(CV, 11)).astype(np.int32)
    pj = dict(base, nearest_latents=jnp.asarray(near))
    pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
    dt = convert.convert_drafter_params(jax.tree.map(np.asarray, dj),
                                        device="cpu", embed=pt["embed"])
    fkw = dict(w=GRID, h=GRID, image_start_idx=len(TEXT), vocab_size=CV)
    return dict(cfg=(cfg_j, cfg_t), dcfg=(dcfg_j, dcfg_t), p=(pj, pt),
                d=(dj, dt),
                tp=(jcham.lumina_token_prompt(TEXT, grid=(GRID, GRID)),
                    tcham.lumina_token_prompt(TEXT, grid=(GRID, GRID))),
                fsm=(jcham.LuminaGridFSM(**fkw), tcham.LuminaGridFSM(**fkw)))


def _llamagen_nearest(V):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(V, 4))
    d = ((emb[:, None] - emb[None, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, 1:12].astype(np.int32)


def _rt_runs(family, mode, warp, lumina_m):
    """JAX and port ``spec.generate`` with a wide LANTERN spec at the
    narrowed point ``rt = (4, 0.3)``, and the port with the static spec
    at that point."""
    wide, point = (10, 0.123), (4, 0.3)
    if warp == "greedy":
        jk, tk = dict(warp=JWarp(temperature=0.0)), dict(warp=TWarp(temperature=0.0))
    else:
        jk = dict(warp=JWarp(temperature=1.0, top_k=50), pin=0.5)
        tk = dict(warp=TWarp(temperature=1.0, top_k=50), pin=0.5)
    if family == "llamagen":
        m = lane("label", "int8", "random")
        (cfg_j, cfg_t), (dcfg_j, dcfg_t) = m["cfg"], m["dcfg"]
        dcfg_j = jc.drafter_config(cfg_j, **DYN)
        dcfg_t = tc.drafter_config(cfg_t, **DYN)
        (pj, pt), (dj, dt), (rj, rt) = m["p"], m["d"], m["req"]
        near = _llamagen_nearest(cfg_j.vocab_size)
        pj = dict(pj, nearest_latents=jnp.asarray(near))
        pt = dict(pt, nearest_latents=torch.from_numpy(near))
        common = dict(cfg_scale=3.0, max_new=16, mode=mode, kv_quant=True,
                      walk_batch_warp=True)
        jkw = dict(cond=rj["cond"], uncond=rj["uncond"])
        tkw = dict(cond=rt["cond"], uncond=rt["uncond"])
        tree = "mc_sim_7b_63"
    else:
        m = lumina_m
        (cfg_j, cfg_t), (dcfg_j, dcfg_t) = m["cfg"], m["dcfg"]
        (pj, pt), (dj, dt) = m["p"], m["d"]
        (tpj, tpt), (fj, ft) = m["tp"], m["fsm"]
        static = mode == "static"
        common = dict(cfg_scale=3.0, max_new=GRID * (GRID + 1) + 1, mode=mode,
                      walk_batch_warp=True, stale_draft=static,
                      deferred_commit=static)
        jkw = dict(cond=None, uncond=None, token_prompt=tpj, logits_fn=fj)
        tkw = dict(token_prompt=tpt, logits_fn=ft)
        tree = TREE
    js = jt.get_tree(tree) if mode == "static" else None
    ts = ttr.get_tree(tree) if mode == "static" else None
    wj, wt = jacc.LanternSpec(*wide), tacc.LanternSpec(*wide)
    cj = jspec.SpecDecodeConfig(**common, lantern=wj, **jk)
    jkw = dict(jkw)
    cond, uncond = jkw.pop("cond"), jkw.pop("uncond")
    rj_ = jspec.generate(pj, dj, cj, cfg_j, dcfg_j, js, cond, uncond,
                         jax.random.key(3), lantern_rt=wj.runtime(*point),
                         **jkw)

    def port(lantern, rt_):
        return tspec.generate(pt, tspec.SpecDecodeConfig(**common, lantern=lantern,
                                                         **tk),
                              cfg_t, ts, generator=None, device="cpu",
                              dparams=dt, dcfg=dcfg_t, lantern_rt=rt_, **tkw)
    return (rj_, port(wt, wt.runtime(*point)),
            port(tacc.LanternSpec(*point), None))


@pytest.mark.parametrize("family,mode,warp", [
    ("llamagen", "static", "greedy"), ("llamagen", "dynamic", "pinned"),
    ("lumina", "static", "pinned"), ("lumina", "dynamic", "greedy")])
def test_generate_lantern_rt_token_exact(lumina, family, mode, warp):
    rj, rt, rs = _rt_runs(family, mode, warp, lumina)
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    assert (rt.steps, rt.accept_sum) == (int(rj.steps), int(rj.accept_sum))
    # the narrowed runtime point runs as the static spec at that point
    np.testing.assert_array_equal(rs.tokens.numpy(), rt.tokens.numpy())
    assert (rs.steps, rs.accept_sum) == (rt.steps, rt.accept_sum)


# ------------------------------------------------------------ autotune

@pytest.mark.parametrize("length,prefix", [(4, 8), (8, 20)])
def test_verify_forward_matches_jax(length, prefix):
    m = lane("label", "int8")
    (cfg_j, cfg_t), (pj, pt) = m["cfg"], m["p"]
    got = tat.verify_forward(pt, cfg_t, length, prefix=prefix)()
    kv = JKV.create(cfg_j, 2).commit(min(prefix, cfg_j.max_seq_len - length))
    res = jtfm.forward(pj, cfg_j, jtfm.token_embed(pj, jnp.zeros((2, length),
                                                                 jnp.int32)),
                       kv, positions=jnp.arange(length) + kv.length,
                       rope=jtfm.make_rope_tables(cfg_j),
                       block_mask=jnp.tril(jnp.ones((length, length), bool)),
                       commit=False)
    want = jtfm.logits_head(pj, res.hidden)
    assert tuple(got.shape) == (2, length, cfg_t.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-4, atol=1e-4)
    assert tat.time_verify_forward(pt, cfg_t, length, prefix=prefix,
                                   iters=2) > 0


@pytest.mark.parametrize("candidates,times", [
    (tat.CANDIDATES, (1.0, 1.04, 1.07, 1.15, 1.2)),
    (tat.CANDIDATES, (1.0, 1.06, 1.08, 1.12, 1.14)),
    ((4, 8, 12), (1.0, 1.08, 1.1)),
    ((4, 8, 12), (1.0, 1.05, 1.2))])
def test_autotune_picks_as_jax(monkeypatch, candidates, times):
    table = dict(zip(candidates, times))

    def fake(params, cfg, length, prefix=128, iters=20, rope=None):
        return table[length]

    monkeypatch.setattr(tat, "time_verify_forward", fake)
    monkeypatch.setattr(jat, "time_verify_forward", fake)
    m = lane("label")
    (cfg_j, cfg_t), (pj, pt) = m["cfg"], m["p"]
    got = tat.autotune_total_tokens(pt, cfg_t, candidates)
    want = jat.autotune_total_tokens(pj, cfg_j, candidates)
    assert got == want
    w = (tat.WEIGHTS if tuple(candidates) == tat.CANDIDATES else
         [1.0 + 0.13 * (c - min(candidates)) / (max(candidates) - min(candidates))
          for c in candidates])
    assert got == candidates[int(np.argmin(np.asarray(times) / np.asarray(w)))]


# ------------------------------------------------------------ calibrate

CAL_KW = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
              block_size=36, max_seq_len=96)
GREEDY = dict(temperature=0.0)


def _sharpened(params, scale=40.0):
    """A random head gives near-uniform rows, where every walk accepts its
    first child: scale it so that the walks also reject and reach deeper
    ranks."""
    return dict(params, lm_head=params["lm_head"] * scale)


def _cal_lane(cond_kind):
    """The tiny LlamaGen (a 6x6 grid, 36 tokens) of both packages with the
    hidden-passthrough drafter, a nearest table, and one request."""
    from test_torch_llamagen import passthrough, request

    cfg_j = jc.tiny_config(cond_kind=cond_kind, **CAL_KW)
    cfg_t = tc.tiny_config(cond_kind=cond_kind, **CAL_KW)
    dcfg_j, dcfg_t = jc.drafter_config(cfg_j), tc.drafter_config(cfg_t)
    base = _sharpened(jtfm.init_params(jax.random.key(0), cfg_j))
    dj = passthrough(jdrf.init_drafter_params(jax.random.key(1), dcfg_j,
                                              base["embed"]), cfg_j)
    pj, dj = jtfm.fuse_params(base), jtfm.fuse_params(dj)
    pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
    dt = convert.convert_drafter_params(jax.tree.map(np.asarray, dj),
                                        device="cpu", embed=pt["embed"])
    near = _llamagen_nearest(cfg_j.vocab_size)
    rj, rt = request(cfg_j, base.get("cond", {}).get("uncond"), cond_kind)
    return dict(cfg=(cfg_j, cfg_t), dcfg=(dcfg_j, dcfg_t), p=(pj, pt),
                d=(dj, dt), near=(jnp.asarray(near), torch.from_numpy(near)),
                req=(rj, rt))


@pytest.fixture(scope="module")
def cal():
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _cal_lane(kind)
        return cache[kind]
    return get


@pytest.mark.parametrize("cond_kind", ["label", "caption"])
def test_teacher_hidden_and_rank_probs_match_jax(cal, cond_kind):
    m = cal(cond_kind)
    (cfg_j, cfg_t), (dcfg_j, dcfg_t) = m["cfg"], m["dcfg"]
    (pj, pt), (dj, dt), (rj, rt) = m["p"], m["d"], m["req"]
    toks = np.random.default_rng(1).integers(0, 256, size=(20,)).astype(np.int32)
    pair = (jnp.concatenate([rj["cond"], rj["uncond"]], axis=0)
            if cond_kind == "caption" else
            jnp.concatenate([rj["cond"], rj["uncond"]]))
    hj = jcal._teacher_hidden(pj, cfg_j, pair, jnp.asarray(toks),
                              jtfm.make_rope_tables(cfg_j))
    ht = tcal._teacher_hidden(pt, cfg_t, tcal._cond_pair(cfg_t, rt["cond"],
                                                         rt["uncond"]),
                              torch.from_numpy(toks),
                              ttfm.make_rope_tables(cfg_t, "cpu"))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **F32)
    pj_ = jcal.measure_rank_probs(pj, dj, cfg_j, dcfg_j, rj["cond"],
                                  rj["uncond"], jax.random.key(0), max_rank=6,
                                  warp=JWarp(**GREEDY), num_rollouts=2)
    pt_ = tcal.measure_rank_probs(pt, dt, cfg_t, dcfg_t, rt["cond"],
                                  rt["uncond"], None, max_rank=6,
                                  warp=TWarp(**GREEDY), num_rollouts=2)
    np.testing.assert_array_equal(pt_, pj_)
    assert pt_.shape == (6,) and (pt_ > 0).all() and (pt_ <= 1).all()


def _binomial_close(got, want, n):
    """|got - want| <= 4 sqrt(p (1 - p) / n) + 1 / n per entry, where p is
    the mean of the two estimates (each is a frequency over n trials)."""
    p = np.clip((got + want) / 2, 0.0, 1.0)
    tol = 4 * np.sqrt(p * (1 - p) / n[:, None]) + 1.0 / n[:, None]
    bad = np.abs(got - want) > tol
    assert not bad.any(), (got, want, tol)


@pytest.mark.parametrize("proposals", ["sampled", "top1"])
def test_drafter_accept_probs_match_jax(cal, proposals):
    m = cal("label")
    (cfg_j, cfg_t), (dcfg_j, dcfg_t) = m["cfg"], m["dcfg"]
    (pj, pt), (dj, dt), (rj, rt) = m["p"], m["d"], m["req"]
    (nj, nt) = m["near"]
    if proposals == "top1":      # one-hot proposals: the walk is determined
        wj, wt = JWarp(temperature=1.0, top_k=1), TWarp(temperature=1.0, top_k=1)
        rollouts = 1
    else:                        # greedy rollout, sampled star trees
        wj, wt = JWarp(**GREEDY), TWarp(**GREEDY)
        rollouts = 8
    kw = dict(max_rank=6, max_depth=3, num_rollouts=rollouts, chunk=16)
    got = tcal.measure_drafter_accept_probs(
        pt, dt, cfg_t, dcfg_t, rt["cond"], rt["uncond"],
        torch.Generator().manual_seed(0), nt, tacc.LanternSpec(5, 0.3),
        warp=wt, **kw)
    want = jcal.measure_drafter_accept_probs(
        pj, dj, cfg_j, dcfg_j, rj["cond"], rj["uncond"], jax.random.key(0),
        nj, jacc.LanternSpec(5, 0.3), warp=wj, **kw)
    assert got.shape == (3, 6) and (got > 0).all() and (got <= 1).all()
    # hits of one walk are exclusive; the 1e-4 floor may add K x 1e-4
    assert (got.sum(1) <= 1 + got.shape[1] * 1e-4).all()
    if proposals == "top1":
        np.testing.assert_array_equal(got, want)
    else:
        T = cfg_t.block_size
        _binomial_close(got, want, np.array([(T - d) * rollouts
                                             for d in (1, 2, 3)], float))


LUM_GRID = 6
LUM_KW = dict(CH_KW, max_seq_len=160)


@pytest.fixture(scope="module")
def lumina_cal():
    cfg_j, cfg_t = jc.tiny_config(**LUM_KW), tc.tiny_config(**LUM_KW)
    pj = jtfm.fuse_params(_sharpened(jtfm.init_params(jax.random.key(2),
                                                      cfg_j)))
    pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
    near = np.random.default_rng(1).integers(4, 8196, size=(CV, 11)).astype(np.int32)
    fkw = dict(w=LUM_GRID, h=LUM_GRID, image_start_idx=len(TEXT), vocab_size=CV)
    g = (LUM_GRID, LUM_GRID)
    return dict(cfg=(cfg_j, cfg_t), p=(pj, pt),
                near=(jnp.asarray(near), torch.from_numpy(near)),
                tp=(jcham.lumina_token_prompt(TEXT, grid=g),
                    tcham.lumina_token_prompt(TEXT, grid=g)),
                fsm=(jcham.LuminaGridFSM(**fkw), tcham.LuminaGridFSM(**fkw)),
                T=LUM_GRID * (LUM_GRID + 1) + 1)


def test_stale_rank_probs_match_jax(lumina_cal):
    m = lumina_cal
    (cfg_j, cfg_t), (pj, pt) = m["cfg"], m["p"]
    (tpj, tpt), (fj, ft) = m["tp"], m["fsm"]
    for chunk in (512, 16):
        got = tcal.measure_stale_rank_probs(
            pt, cfg_t, tpt, None, m["T"], max_rank=5, max_depth=4,
            warp=TWarp(**GREEDY), logits_fn=ft, chunk=chunk)
        want = jcal.measure_stale_rank_probs(
            pj, cfg_j, tpj, jax.random.key(0), m["T"], max_rank=5,
            max_depth=4, warp=JWarp(**GREEDY), logits_fn=fj, chunk=chunk)
        np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 5)


@pytest.mark.parametrize("proposals", ["sampled", "top1"])
def test_stale_accept_probs_match_jax(lumina_cal, proposals):
    m = lumina_cal
    (cfg_j, cfg_t), (pj, pt) = m["cfg"], m["p"]
    (tpj, tpt), (fj, ft), (nj, nt) = m["tp"], m["fsm"], m["near"]
    if proposals == "top1":
        wj, wt = JWarp(temperature=1.0, top_k=1), TWarp(temperature=1.0, top_k=1)
        rollouts = 1
    else:
        wj, wt = JWarp(**GREEDY), TWarp(**GREEDY)
        rollouts = 6
    kw = dict(max_rank=5, max_depth=3, logits_fn=None, num_rollouts=rollouts,
              cfg_scale=3.0)
    got = tcal.measure_stale_accept_probs(
        pt, cfg_t, tpt, torch.Generator().manual_seed(0), m["T"], nt,
        tacc.LanternSpec(10, 5.0), warp=wt, **dict(kw, logits_fn=ft))
    want = jcal.measure_stale_accept_probs(
        pj, cfg_j, tpj, jax.random.key(0), m["T"], nj,
        jacc.LanternSpec(10, 5.0), warp=wj, **dict(kw, logits_fn=fj))
    assert got.shape == (3, 5) and (got > 0).all() and (got <= 1).all()
    # hits of one walk are exclusive; the 1e-4 floor may add K x 1e-4
    assert (got.sum(1) <= 1 + got.shape[1] * 1e-4).all()
    if proposals == "top1":
        np.testing.assert_array_equal(got, want)
    else:
        _binomial_close(got, want, np.array([(m["T"] - d) * rollouts
                                             for d in (1, 2, 3)], float))
