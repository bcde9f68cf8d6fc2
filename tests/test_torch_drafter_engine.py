"""The port's spec engine with the EAGLE drafter and the rollback commit,
token-exact against ``lantern_tpu`` on the CPU.

Same tiny f32 Chameleon config, 4x4 Lumina grid FSM and calibrated tree as
``tests/test_torch_engine.py``.  ``spec.generate`` runs with the real drafter
(``stale_draft=False``: ``drafter.extend`` + ``draft_static``), with both
commit modes (``deferred_commit`` False: provisional tree write +
``KVCache.accept_path``; True: deferred), greedy and pinned (``pin=0.5``, a
sampling warp, LANTERN on), f32 and int8 weights and KV.  Token streams,
step counts and accept sums must be equal; inside the port the two commit
modes must agree, and the hidden-passthrough drafter must reproduce stale
drafting (f32, as ``tests/test_stale_draft.py`` holds it in JAX).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu import trees as jt
from lantern_tpu.engine import spec as jspec
from lantern_tpu.models import chameleon as jcham
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops import quant as jq
from lantern_tpu.ops.acceptance import LanternSpec as JLantern
from lantern_tpu.ops.sampling import LogitsWarp as JWarp
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.engine import spec as tspec
from lantern_tpu_torch.models import chameleon as tcham
from lantern_tpu_torch.ops.acceptance import LanternSpec as TLantern
from lantern_tpu_torch.ops.sampling import LogitsWarp as TWarp

V = 8832
GRID = 4
MAX_NEW = GRID * (GRID + 1) + 1
TEXT = [60, 61, 62, 63, 9]
TREE = "ckpts/bench_tree_lumina.json"
KW = dict(vocab_size=V, hidden_size=256, num_layers=2, num_heads=2,
          rope_kind="1d", cond_kind="none", qk_norm=True, swin_norm=True,
          max_seq_len=48 + 32)       # room for the 32-row provisional block


def passthrough(dparams, cfg):
    """The hidden-passthrough drafter: output hidden == input base hidden."""
    H = cfg.hidden_size
    fc = np.zeros((2 * H, H), np.float32)
    fc[H:] = np.eye(H)
    out = dict(dparams)
    out["fc_w"] = jnp.asarray(fc, cfg.jnp_dtype)
    out["layers"] = jax.tree.map(lambda a: a * 0, dparams["layers"])
    return out


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = jc.tiny_config(**KW), tc.tiny_config(**KW)
    dcfg_j, dcfg_t = jc.drafter_config(cfg_j), tc.drafter_config(cfg_t)
    base = jtfm.init_params(jax.random.key(0), cfg_j)
    drafter = jdrf.init_drafter_params(jax.random.key(1), dcfg_j,
                                       base["embed"])
    near = np.random.default_rng(0).integers(4, 8196, size=(V, 11)).astype(np.int32)
    drafters = {"random": drafter, "passthrough": passthrough(drafter, cfg_j)}
    out = {}
    for weights in ("fused", "int8"):
        pj = jtfm.fuse_params(base)
        pj = jq.quantize_params(pj) if weights == "int8" else pj
        pj = dict(pj, nearest_latents=jnp.asarray(near))
        pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
        for kind, d in drafters.items():
            dj = jtfm.fuse_params(d)
            dj = jq.quantize_params(dj) if weights == "int8" else dj
            out[weights, kind] = (pj, dj, pt, convert.convert_drafter_params(
                jax.tree.map(np.asarray, dj), device="cpu", embed=pt["embed"]))
    fkw = dict(w=GRID, h=GRID, image_start_idx=len(TEXT), vocab_size=V)
    return dict(cfg=(cfg_j, cfg_t), dcfg=(dcfg_j, dcfg_t), params=out,
                tp=(jcham.lumina_token_prompt(TEXT, grid=(GRID, GRID)),
                    tcham.lumina_token_prompt(TEXT, grid=(GRID, GRID))),
                fsm=(jcham.LuminaGridFSM(**fkw), tcham.LuminaGridFSM(**fkw)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def legal(tokens):
    toks = [int(t) for t in tokens]
    assert len(toks) == MAX_NEW
    for i, t in enumerate(toks[:-1]):
        if i % (GRID + 1) == GRID:
            assert t == tcham.LUMINA_NEWLINE_ID, (i, t)
        else:
            assert tcham.IMAGE_TOKEN_START <= t <= tcham.IMAGE_TOKEN_END, (i, t)
    assert toks[-1] == tcham.IMAGE_END_ID


def _ecfgs(mode, kvq, **kw):
    common = dict(cfg_scale=3.0, max_new=MAX_NEW, kv_quant=kvq,
                  walk_batch_warp=True, **kw)
    if mode == "greedy":
        return (jspec.SpecDecodeConfig(warp=JWarp(temperature=0.0), **common),
                tspec.SpecDecodeConfig(warp=TWarp(temperature=0.0), **common))
    return (jspec.SpecDecodeConfig(warp=JWarp(temperature=1.0, top_k=2000),
                                   pin=0.5, lantern=JLantern(k=10, delta=5.0),
                                   **common),
            tspec.SpecDecodeConfig(warp=TWarp(temperature=1.0, top_k=2000),
                                   pin=0.5, lantern=TLantern(k=10, delta=5.0),
                                   **common))


def run_port(models, weights, kind, ecfg, generator=None):
    _, _, pt, dt = models["params"][weights, kind]
    return tspec.generate(pt, ecfg, models["cfg"][1], ttr.get_tree(TREE),
                          models["tp"][1], generator,
                          logits_fn=models["fsm"][1], device="cpu",
                          dparams=dt, dcfg=models["dcfg"][1])


def run_jax(models, weights, kind, ecfg):
    pj, dj, _, _ = models["params"][weights, kind]
    return jspec.generate(pj, dj, ecfg, models["cfg"][0], models["dcfg"][0],
                          jt.get_tree(TREE), None, None, jax.random.key(3),
                          token_prompt=models["tp"][0],
                          logits_fn=models["fsm"][0])


def same(rt, other):
    np.testing.assert_array_equal(np.asarray(rt.tokens),
                                  np.asarray(other.tokens))
    assert (rt.steps, rt.accept_sum, rt.n_valid) == (
        int(other.steps), int(other.accept_sum), int(other.n_valid))


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("mode", ["greedy", "pinned"])
@pytest.mark.parametrize("weights,kvq", [("fused", False), ("int8", True)])
def test_spec_drafter_token_exact(models, weights, kvq, mode, deferred):
    """Real drafter, both commit modes, against the JAX engine; one compile
    of the JAX loop serves the random and the passthrough drafter."""
    ej, et = _ecfgs(mode, kvq, stale_draft=False, deferred_commit=deferred)
    for kind in ("random", "passthrough"):
        rt = run_port(models, weights, kind, et)
        same(rt, run_jax(models, weights, kind, ej))
        legal(rt.tokens)
        assert rt.step_compression >= 1.0
    # the passthrough drafter proposes the verify step's own distribution:
    # the walk accepts more than the root
    assert rt.step_compression > 1.2


@pytest.mark.parametrize("mode", ["greedy", "pinned"])
@pytest.mark.parametrize("weights,kvq", [("fused", False), ("int8", True)])
@pytest.mark.parametrize("stale", [False, True])
def test_spec_rollback_equals_deferred(models, weights, kvq, mode, stale):
    """Inside the port both commit modes commit the same bytes."""
    outs = [run_port(models, weights, "passthrough",
                     _ecfgs(mode, kvq, stale_draft=stale,
                            deferred_commit=d)[1]) for d in (False, True)]
    same(outs[0], outs[1])
    legal(outs[0].tokens)


@pytest.mark.parametrize("mode", ["greedy", "pinned"])
@pytest.mark.parametrize("deferred", [False, True])
def test_spec_passthrough_drafter_equals_stale(models, mode, deferred):
    """f32: the passthrough drafter's hidden IS the base hidden, so the real
    drafter path and stale drafting commit the same stream."""
    outs = [run_port(models, "fused", "passthrough",
                     _ecfgs(mode, False, stale_draft=s,
                            deferred_commit=deferred)[1]) for s in (False, True)]
    same(outs[0], outs[1])


def test_spec_rollback_cache_holds_the_committed_stream(models):
    """After a rollback run the base cache holds exactly the rows an AR
    pass over the committed tokens would have written (int8 KV, greedy):
    re-verify by running the deferred engine and flushing its pending rows."""
    from lantern_tpu_torch.engine.spec import make_static_step, prefill_request

    states = []
    for deferred in (False, True):
        et = _ecfgs("greedy", True, stale_draft=True,
                    deferred_commit=deferred)[1]
        _, _, pt, _ = models["params"]["int8", "passthrough"]
        tree = ttr.get_tree(TREE)
        state, ctx = prefill_request(pt, et, models["cfg"][1], tree,
                                     models["tp"][1], None,
                                     logits_fn=models["fsm"][1], device="cpu")
        step = make_static_step(et, models["cfg"][1], tree, ctx)
        for _ in range(4):
            state = step(state)
        states.append(state)
    roll, dfr = states
    kv = dfr.base_kv
    sel = torch.clamp(dfr.psel, 0).long()
    kv = kv.write(dfr.blk[0][:, :, sel], dfr.blk[1][:, :, sel],
                  advance=False).commit(dfr.pn)
    n = int(roll.base_kv.length)
    assert n == int(kv.length) == len(TEXT) + 3 + int(roll.n_new)
    for a, b in ((roll.base_kv.k, kv.k), (roll.base_kv.v, kv.v),
                 (roll.base_kv.k_scale, kv.k_scale),
                 (roll.base_kv.v_scale, kv.v_scale)):
        np.testing.assert_array_equal(a[:, :, :, :n].numpy(),
                                      b[:, :, :, :n].numpy())


def test_spec_drafter_sampling_follows_grammar(models):
    """Unpinned sampling with the real drafter and the rollback commit:
    every stream obeys the grid FSM and two seeds differ."""
    et = tspec.SpecDecodeConfig(
        warp=TWarp(temperature=1.0, top_k=2000), cfg_scale=3.0,
        lantern=TLantern(k=10, delta=5.0), max_new=MAX_NEW, kv_quant=True,
        walk_batch_warp=False, stale_draft=False, deferred_commit=False)
    outs = []
    for seed in (0, 1):
        r = run_port(models, "int8", "random", et,
                     torch.Generator().manual_seed(seed))
        legal(r.tokens)
        assert r.n_valid == MAX_NEW and r.step_compression >= 1.0
        outs.append(r.tokens.tolist())
    assert outs[0] != outs[1]
