"""The port's dynamic (EAGLE-2) mode against ``lantern_tpu`` on the CPU.

The tiny LlamaGen config of ``tests/test_torch_llamagen.py`` (head_dim 64,
two heads per 128-lane group; label and left-padded caption conditioning):

- ``topk_stable`` orders ties as ``jax.lax.top_k`` does;
- ``draft_dynamic``'s five outputs (tokens, root paths, ancestor mask,
  depths, children) equal the JAX ones, with a random drafter and with the
  hidden-passthrough drafter (whose level rows tie by construction), and
  its provisional level rows equal the JAX drafter cache's;
- ``spec.generate(mode="dynamic")`` (rollback commit) is token-exact,
  greedy and pinned (``pin=0.5``), with f32 and with int8 weights and KV;
- unpinned sampling: the token after the first follows the warped CFG
  distribution;
- dynamic mode rejects stale drafting and deferred commit, as the JAX
  engine does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu.kv import KVCache as JKV
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops import quant as jq
from lantern_tpu.ops.sampling import LogitsWarp as JWarp
from lantern_tpu_torch.engine import spec as tspec
from lantern_tpu_torch.kv import KVCache as TKV
from lantern_tpu_torch.models import drafter as tdrf
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.ops.quant import head_of
from lantern_tpu_torch.ops.sampling import LogitsWarp as TWarp
from lantern_tpu_torch.ops.sampling import cfg_combine, topk_stable, warp_logits

from test_torch_llamagen import (  # noqa: F401  (fixtures)
    KW, MAX_NEW, assert_same, lanes, one_torch_thread, spec_pair)


def test_topk_stable_orders_ties_as_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(3, 40)).astype(np.float32)
    x[1, 5:9] = -np.inf
    x[2] = 0.0
    for k in (1, 7, 40):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = topk_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def _draft_pair(m, warp_t, warp_j, length):
    """Both packages' ``draft_dynamic`` from one drafter cache that holds
    ``length`` committed rows of random (token, hidden) pairs."""
    (dcfg_j, dcfg_t), (pj, pt), (dj, dt) = m["dcfg"], m["p"], m["d"]
    H = dcfg_j.model.hidden_size
    rng = np.random.default_rng(length)
    tok = rng.integers(0, KW["vocab_size"], size=(2, length)).astype(np.int32)
    hid = rng.normal(size=(2, length, H)).astype(np.float32)
    root = rng.normal(size=(2, 1, H)).astype(np.float32)
    ropej = jtfm.make_rope_tables(dcfg_j.model)
    ropet = ttfm.make_rope_tables(dcfg_t.model, "cpu")
    _, kj = jdrf.extend(dj, dcfg_j, ropej, JKV.create(dcfg_j.model, 2),
                        jnp.asarray(tok), jnp.asarray(hid), length)
    _, kt = tdrf.extend(dt, dcfg_t, ropet,
                        TKV.create(dcfg_t.model, 2, device="cpu"),
                        torch.from_numpy(tok), torch.from_numpy(hid), length)
    draft_j, kj = jdrf.draft_dynamic(
        dj, dcfg_j, ropej, kj, jnp.asarray(root), jnp.int32(17),
        jq.head_of(pj), 3.0, warp_j)
    draft_t, kt = tdrf.draft_dynamic(
        dt, dcfg_t, ropet, kt, torch.from_numpy(root),
        torch.tensor(17, dtype=torch.int32), head_of(pt), 3.0, warp_t)
    return draft_j, kj, draft_t, kt


@pytest.mark.parametrize("drafter", ["random", "passthrough"])
@pytest.mark.parametrize("warp", ["greedy", "top50"])
def test_draft_dynamic_matches_jax(lanes, drafter, warp):
    m = lanes("label", "fused", drafter)
    if warp == "greedy":
        wj, wt = JWarp(temperature=0.0), TWarp(temperature=0.0)
    else:
        wj = JWarp(temperature=1.0, top_k=50)
        wt = TWarp(temperature=1.0, top_k=50)
    dcfg = m["dcfg"][1]
    length = 9
    draft_j, kj, draft_t, kt = _draft_pair(m, wt, wj, length)
    n1 = dcfg.total_tokens
    assert tuple(draft_t.retrieve_indices.shape) == (n1, dcfg.depth + 2)
    for name in draft_t._fields:
        np.testing.assert_array_equal(
            getattr(draft_t, name).numpy(), np.asarray(getattr(draft_j, name)),
            err_msg=name)
    # every root path starts at the root; depths stay within the budget
    paths = draft_t.retrieve_indices.numpy()
    assert (paths[:, 0] == 0).all()
    depth = draft_t.tree_position_ids.numpy()
    assert depth[0] == 0 and depth.max() <= dcfg.depth + 1
    # the provisional level rows the drafter wrote, and the untouched length
    rows = slice(length, length + dcfg.depth * dcfg.top_k)
    assert int(kt.length) == int(kj.length) == length
    np.testing.assert_allclose(kt.k[:, :, :, rows].numpy(),
                               np.asarray(kj.k)[:, :, :, rows],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cond_kind", ["label", "caption"])
@pytest.mark.parametrize("mode", ["greedy", "pinned"])
@pytest.mark.parametrize("weights", ["fused", "int8"])
def test_dynamic_spec_token_exact(lanes, cond_kind, mode, weights):
    m = lanes(cond_kind, weights)
    resj, rest = spec_pair(m, dict(mode="dynamic", kv_quant=weights == "int8"),
                           mode)
    assert_same(resj, rest)


def test_dynamic_spec_passthrough_compresses(lanes):
    """With the passthrough drafter the dynamic tree proposes from the base
    distribution: greedy streams stay token-exact and accept more than one
    token a step."""
    m = lanes("label", "fused", "passthrough")
    resj, rest = spec_pair(m, dict(mode="dynamic"), "greedy")
    assert_same(resj, rest)
    assert rest.step_compression > 1.5


def test_dynamic_sampling_distribution(lanes):
    """Unpinned dynamic-mode sampling: the token after the first (decided by
    the tree walk over a drafted tree) follows the warped CFG distribution
    given the first."""
    m = lanes("label", "fused", "passthrough")
    cfg_t, dcfg_t, pt, dt, rt = (m["cfg"][1], m["dcfg"][1], m["p"][1],
                                 m["d"][1], m["req"][1])
    warp = TWarp(temperature=2.0, top_k=3)
    ecfg = tspec.SpecDecodeConfig(warp=warp, cfg_scale=3.0, max_new=2,
                                  mode="dynamic")
    g = torch.Generator().manual_seed(11)
    pairs = []
    for _ in range(400):
        state, ctx = tspec.prefill_request(
            pt, ecfg, cfg_t, None, None, g, device="cpu", dparams=dt,
            dcfg=dcfg_t, cond=rt["cond"], uncond=rt["uncond"])
        state = tspec.make_dynamic_step(ecfg, cfg_t, ctx)(state)
        t0 = int(state.tokens[0])
        t1 = int(state.tokens[1]) if int(state.n_new) >= 2 else int(
            state.root_token)
        pairs.append((t0, t1))
    t0s = np.asarray([a for a, _ in pairs])
    first = int(np.bincount(t0s).argmax())
    seconds = np.asarray([b for a, b in pairs if a == first])
    assert len(seconds) >= 100
    # the reference: the warped CFG distribution after (prefix, first)
    emb = ttfm.cond_embed(pt, cfg_t, torch.cat([rt["cond"], rt["uncond"]]))
    emb = torch.cat([emb, ttfm.token_embed(
        pt, torch.full((2, 1), first, dtype=torch.int32))], dim=1)
    T = emb.shape[1]
    res = ttfm.forward(pt, cfg_t, emb, TKV.create(cfg_t, 2, device="cpu"),
                       torch.arange(T), ttfm.make_rope_tables(cfg_t, "cpu"))
    lg = cfg_combine(ttfm.logits_head(pt, res.hidden[:, -1:]), 3.0)[0]
    probs = torch.softmax(warp_logits(lg, warp), -1)[0].numpy()
    freq = np.bincount(seconds, minlength=cfg_t.vocab_size) / len(seconds)
    assert (probs > 0).sum() == 3 and np.all(freq[probs == 0] == 0)
    np.testing.assert_allclose(freq, probs, atol=0.1)


@pytest.mark.parametrize("kw,match", [
    (dict(stale_draft=True), "stale_draft requires mode='static'"),
    (dict(deferred_commit=True), "deferred_commit requires mode='static'")])
def test_dynamic_rejects_static_only_options(lanes, kw, match):
    m = lanes("label")
    rt = m["req"][1]
    ecfg = tspec.SpecDecodeConfig(mode="dynamic", max_new=MAX_NEW, **kw)
    with pytest.raises(ValueError, match=match):
        tspec.generate(m["p"][1], ecfg, m["cfg"][1], None, None,
                       device="cpu", dparams=m["d"][1], dcfg=m["dcfg"][1],
                       cond=rt["cond"], uncond=rt["uncond"])
