"""The port's decode loops token-exact against ``lantern_tpu`` on the CPU.

Tiny f32 Chameleon config (hidden 256, two heads of head_dim 128, so the
grouped W=128 KV layout is the real one; two swin-norm layers; a vocab
that holds the Lumina ids), the 4x4 Lumina grid FSM and the calibrated
Lumina tree.  Both packages run the same weights (bridged with
``convert.convert_params``) and must commit the same token streams:

- ``generate_tokens`` greedy (the AR twin);
- ``spec.generate`` greedy;
- ``spec.generate`` pinned (``pin=0.5``, a sampling warp, LANTERN on).

These are the cross-package forms of ``tests/test_deferred_commit.py`` and
``tests/test_stale_draft.py``: the JAX engine runs in the same static mode
with stale drafting and deferred commit (the EAGLE drafter and the
rollback commit are held in ``tests/test_torch_drafter_engine.py``).  Unpinned sampling draws from a
``torch.Generator`` and is checked by the grammar and by distribution.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu import trees as jt
from lantern_tpu.engine import ar as jar
from lantern_tpu.engine import spec as jspec
from lantern_tpu.models import chameleon as jcham
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops import quant as jq
from lantern_tpu.ops.acceptance import LanternSpec as JLantern
from lantern_tpu.ops.sampling import LogitsWarp as JWarp
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.engine import ar as tar
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
          max_seq_len=48)


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = jc.tiny_config(**KW), tc.tiny_config(**KW)
    base = jtfm.fuse_params(jtfm.init_params(jax.random.key(0), cfg_j))
    near = np.random.default_rng(0).integers(4, 8196, size=(V, 11)).astype(np.int32)
    out = {}
    for weights in ("fused", "int8"):
        pj = jq.quantize_params(base) if weights == "int8" else base
        pj = dict(pj, nearest_latents=jnp.asarray(near))
        out[weights] = (pj, convert.convert_params(
            jax.tree.map(np.asarray, pj), device="cpu"))
    fkw = dict(w=GRID, h=GRID, image_start_idx=len(TEXT), vocab_size=V)
    return dict(cfg=(cfg_j, cfg_t), params=out,
                tp=(jcham.lumina_token_prompt(TEXT, grid=(GRID, GRID)),
                    tcham.lumina_token_prompt(TEXT, grid=(GRID, GRID))),
                fsm=(jcham.LuminaGridFSM(**fkw), tcham.LuminaGridFSM(**fkw)))


def legal(tokens):
    toks = [int(t) for t in tokens]
    assert len(toks) == MAX_NEW
    for i, t in enumerate(toks[:-1]):
        if i % (GRID + 1) == GRID:
            assert t == tcham.LUMINA_NEWLINE_ID, (i, t)
        else:
            assert tcham.IMAGE_TOKEN_START <= t <= tcham.IMAGE_TOKEN_END, (i, t)
    assert toks[-1] == tcham.IMAGE_END_ID


@pytest.mark.parametrize("weights,kvq", [("fused", False), ("fused", True),
                                         ("int8", True)])
def test_ar_greedy_token_exact(models, weights, kvq):
    (cfg_j, cfg_t), (pj, pt) = models["cfg"], models["params"][weights]
    (tpj, tpt), (fj, ft) = models["tp"], models["fsm"]
    rj = jar.generate_tokens(pj, cfg_j, tpj, MAX_NEW, 3.0,
                             JWarp(temperature=0.0), jax.random.key(0),
                             logits_fn=fj, kv_quant=kvq)
    rt = tar.generate_tokens(pt, cfg_t, tpt, MAX_NEW, 3.0,
                             TWarp(temperature=0.0), None, logits_fn=ft,
                             kv_quant=kvq, device="cpu")
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    legal(rt.tokens)
    # the lone loop is the lockstep loop at R = 1: a length per CFG row
    assert rt.kv.length.tolist() == [int(rj.kv.length)] * 2


def test_ar_stop_ids_match_jax(models):
    (cfg_j, cfg_t), (pj, pt) = models["cfg"], models["params"]["fused"]
    (tpj, tpt), (fj, ft) = models["tp"], models["fsm"]
    stop = (tcham.LUMINA_NEWLINE_ID,)
    rj = jar.generate_tokens(pj, cfg_j, tpj, MAX_NEW, 3.0,
                             JWarp(temperature=0.0), jax.random.key(0),
                             logits_fn=fj, stop_ids=stop)
    rt = tar.generate_tokens(pt, cfg_t, tpt, MAX_NEW, 3.0,
                             TWarp(temperature=0.0), None, logits_fn=ft,
                             stop_ids=stop, device="cpu")
    assert rt.n_valid == int(rj.n_valid) == GRID + 1
    np.testing.assert_array_equal(rt.tokens.numpy()[: rt.n_valid],
                                  np.asarray(rj.tokens)[: rt.n_valid])


def _spec_pair(models, weights, kvq, mode, seed=3, **extra):
    (cfg_j, cfg_t), (pj, pt) = models["cfg"], models["params"][weights]
    (tpj, tpt), (fj, ft) = models["tp"], models["fsm"]
    common = dict(cfg_scale=3.0, max_new=MAX_NEW, kv_quant=kvq,
                  walk_batch_warp=True, stale_draft=True, deferred_commit=True,
                  **extra)
    if mode == "greedy":
        jk, tk = dict(warp=JWarp(temperature=0.0)), dict(warp=TWarp(temperature=0.0))
    else:
        jk = dict(warp=JWarp(temperature=1.0, top_k=2000), pin=0.5,
                  lantern=JLantern(k=10, delta=5.0))
        tk = dict(warp=TWarp(temperature=1.0, top_k=2000), pin=0.5,
                  lantern=TLantern(k=10, delta=5.0))
    rj = jspec.generate(pj, {}, jspec.SpecDecodeConfig(**common, **jk), cfg_j,
                        jc.drafter_config(cfg_j), jt.get_tree(TREE), None,
                        None, jax.random.key(seed), token_prompt=tpj,
                        logits_fn=fj)
    rt = tspec.generate(pt, tspec.SpecDecodeConfig(**common, **tk), cfg_t,
                        ttr.get_tree(TREE), tpt, None, logits_fn=ft,
                        device="cpu")
    return rj, rt


@pytest.mark.parametrize("mode", ["greedy", "pinned"])
@pytest.mark.parametrize("weights,kvq", [("fused", False), ("int8", True)])
def test_spec_token_exact(models, mode, weights, kvq):
    rj, rt = _spec_pair(models, weights, kvq, mode)
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    assert (rt.steps, rt.accept_sum, rt.n_valid) == (
        int(rj.steps), int(rj.accept_sum), int(rj.n_valid))
    legal(rt.tokens)
    assert rt.step_compression >= 1.0


def test_spec_stop_ids_match_jax(models):
    """A committed stop id ends the loop; n_valid includes it."""
    stop = (tcham.LUMINA_NEWLINE_ID,)
    rj, rt = _spec_pair(models, "fused", False, "greedy", stop_ids=stop)
    assert rt.n_valid == int(rj.n_valid) == GRID + 1
    assert (rt.steps, rt.accept_sum) == (int(rj.steps), int(rj.accept_sum))
    np.testing.assert_array_equal(rt.tokens.numpy()[: rt.n_valid],
                                  np.asarray(rj.tokens)[: rt.n_valid])


def test_spec_greedy_equals_ar(models):
    """Greedy speculative decoding is lossless against the AR twin."""
    (cfg_j, cfg_t), (pj, pt) = models["cfg"], models["params"]["int8"]
    _, rt = _spec_pair(models, "int8", True, "greedy")
    ra = tar.generate_tokens(pt, cfg_t, models["tp"][1], MAX_NEW, 3.0,
                             TWarp(temperature=0.0), None,
                             logits_fn=models["fsm"][1], kv_quant=True,
                             device="cpu")
    np.testing.assert_array_equal(rt.tokens.numpy(), ra.tokens.numpy())


def test_spec_sampling_follows_grammar(models):
    """Unpinned sampling (torch.Generator): every stream obeys the grid
    FSM, commits exactly max_new tokens, and two seeds differ."""
    cfg_t = models["cfg"][1]
    pt = models["params"]["int8"][1]
    ecfg = tspec.SpecDecodeConfig(
        warp=TWarp(temperature=1.0, top_k=2000), cfg_scale=3.0,
        lantern=TLantern(k=10, delta=5.0), max_new=MAX_NEW, kv_quant=True,
        walk_batch_warp=False, stale_draft=True, deferred_commit=True)
    outs = []
    for seed in (0, 1):
        r = tspec.generate(pt, ecfg, cfg_t, ttr.get_tree(TREE),
                           models["tp"][1], torch.Generator().manual_seed(seed),
                           logits_fn=models["fsm"][1], device="cpu")
        legal(r.tokens)
        assert r.n_valid == MAX_NEW and r.step_compression >= 1.0
        outs.append(r.tokens.tolist())
    assert outs[0] != outs[1]


def test_spec_first_token_distribution(models):
    """The first token is drawn from the warped CFG distribution at the
    prompt's end, under the grid FSM."""
    from lantern_tpu_torch.kv import KVCache
    from lantern_tpu_torch.models import transformer as ttfm
    from lantern_tpu_torch.ops.sampling import cfg_combine, warp_logits

    cfg_t = models["cfg"][1]
    pt = models["params"]["fused"][1]
    tp, fsm = models["tp"][1], models["fsm"][1]
    warp = TWarp(temperature=2.0, top_k=3)
    L = tp.tokens.shape[1]
    block = torch.tril(torch.ones((L, L), dtype=torch.bool))[None] & \
        tp.valid[:, None, :]
    res = ttfm.forward(pt, cfg_t, ttfm.token_embed(pt, tp.tokens),
                       KVCache.create(cfg_t, 2, device="cpu"), tp.positions,
                       ttfm.make_rope_tables(cfg_t, "cpu"), block_mask=block)
    lg = cfg_combine(ttfm.logits_head(pt, res.hidden[:, -1:]), 3.0)[0]
    lg = fsm(lg, torch.tensor([L - 1]))
    probs = torch.softmax(warp_logits(lg, warp), -1)[0].numpy()
    ecfg = tspec.SpecDecodeConfig(warp=warp, cfg_scale=3.0, max_new=1,
                                  stale_draft=True, deferred_commit=True)
    tree = ttr.get_tree("chain")
    g = torch.Generator().manual_seed(5)
    n = 600
    firsts = [int(tspec.prefill_request(pt, ecfg, cfg_t, tree, tp, g,
                                        logits_fn=fsm, device="cpu")[0].root_token)
              for _ in range(n)]
    freq = np.bincount(firsts, minlength=V) / n
    assert (probs > 0).sum() == 3 and np.all(freq[probs == 0] == 0)
    np.testing.assert_allclose(freq, probs, atol=0.06)


@pytest.mark.parametrize("kw,exc,match", [
    # dynamic mode drafts with the EAGLE drafter and commits by rollback,
    # as in the JAX engine
    (dict(mode="dynamic"), ValueError, "stale_draft requires mode='static'"),
    (dict(mode="dynamic", stale_draft=False, deferred_commit=True),
     ValueError, "deferred_commit requires mode='static'"),
    # the real drafter needs its weights
    (dict(stale_draft=False), ValueError, "dparams")])
def test_spec_unported_modes_raise(models, kw, exc, match):
    base = dict(stale_draft=True, deferred_commit=True, max_new=MAX_NEW)
    base.update(kw)
    with pytest.raises(exc, match=match):
        tspec.generate(models["params"]["fused"][1],
                       tspec.SpecDecodeConfig(**base), models["cfg"][1],
                       ttr.get_tree(TREE), models["tp"][1], None,
                       device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from lantern_tpu_torch import resolve_device
    from lantern_tpu_torch.kv import KVCache

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        KVCache.create(tc.tiny_config(**KW), 2)
