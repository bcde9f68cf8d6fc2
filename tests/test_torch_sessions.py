"""The port's sessions and lockstep batched AR against ``lantern_tpu`` on
the CPU.

Configs: the tiny LlamaGen of ``tests/test_torch_llamagen.py`` (hidden
256, four heads of 64, vocab 256, a 4x4 grid; label and caption
conditioning) and a tiny Chameleon in the spirit of
``tests/test_torch_model.py`` (hidden 256, two heads of 128, QK-norm, swin
norm, a vocab of 8832 that holds the Anole and Lumina special ids), each
with the small dynamic-tree drafter of ``tests/test_batching.py`` (10
nodes, depth 2, top-4) and a tiny codec (ch 32, ``ch_mult`` (1, 2)).  The
JAX session is built with ``random`` and the port's session from the same
weights (``convert_params``, ``convert_drafter_params``,
``convert_vqgan_params``).

- ``ar.generate_many`` / ``generate_tokens_many``: token-exact against the
  JAX functions under greedy (labels, left-padded captions, the Lumina
  grid FSM, stop ids), and under sampling equal to lone port runs of the
  same seeds;
- ``LlamaGenSession`` and ``ChameleonSession`` (Anole and Lumina, the
  latter with ``fsm_overrides``) ``generate`` in static (stale and
  drafter), dynamic and AR mode, and with ``stop_ids``: tokens and step
  counts equal the JAX sessions' under greedy;
- ``generate_batch`` in all three modes, per request equal to the JAX
  ``generate_batch`` (``tree="auto"``, the serving policy, is held in
  ``tests/test_torch_policy.py``);
- ``decode_ids`` / ``decode_generated`` within one uint8 level of JAX;
- ``from_pretrained`` on checkpoints the test writes (a LlamaGen base,
  drafter, VQ-16-named codec and nearest table; a Chameleon base with a
  tokenizer json) against the JAX sessions loaded from the same files.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu.engine import ar as jar
from lantern_tpu.engine import session as js
from lantern_tpu.models import chameleon as jcham
from lantern_tpu.models import vqgan as jvq
from lantern_tpu.ops import vq_distance as jvd
from lantern_tpu.ops.sampling import LogitsWarp as JWarp
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch.engine import ar as tar
from lantern_tpu_torch.engine import session as ts
from lantern_tpu_torch.engine.spec import request_generator
from lantern_tpu_torch.models import chameleon as tcham
from lantern_tpu_torch.models import vqgan as tvq
from lantern_tpu_torch.models.item_processor import hash_tokenize
from lantern_tpu_torch.ops.sampling import LogitsWarp as TWarp

from test_torch_codecs import (drafter_state_dict, hf_state_dict,
                               save_torch, to_llamagen_names)

LG_KW = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
             block_size=16, max_seq_len=96)
CH_KW = dict(vocab_size=8832, hidden_size=256, num_layers=2, num_heads=2,
             rope_kind="1d", cond_kind="none", qk_norm=True, swin_norm=True,
             max_seq_len=128)
DYN = dict(total_tokens=10, depth=2, top_k=4)
FSM_IDS = dict(newline_id=250, image_end_id=251, image_lo=4, image_hi=249)
VQ_KW = dict(ch=32, ch_mult=(1, 2), z_channels=16, codebook_dim=8)
GRIDS = {"anole": (4, 4), "lumina": (2, 4)}
MAX_NEW = 12
CAPTIONS = ["a red fox", "two cats on a sofa", "an old steam train"]
GREEDY = dict(temperature=0.0, cfg_scale=2.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_weights(J):
    pt = convert.convert_params(jax.tree.map(np.asarray, J.params),
                                device="cpu")
    dt = convert.convert_drafter_params(jax.tree.map(np.asarray, J.dparams),
                                        device="cpu", embed=pt["embed"])
    return pt, dt


def _codec(J, vj, vt, seed):
    J.vq_cfg, J.vq_params = vj, jvq.init_vqgan_params(jax.random.key(seed),
                                                      vj)
    return vt, convert.convert_vqgan_params(
        jax.tree.map(np.asarray, J.vq_params), device="cpu")


@functools.lru_cache(maxsize=None)
def llamagen(kind: str):
    """``(jax session, port session)`` of the tiny LlamaGen, label or
    caption, with the passthrough drafter and a tiny VQ codec."""
    cj = jc.tiny_config(cond_kind=kind, **LG_KW)
    ct = tc.tiny_config(cond_kind=kind, **LG_KW)
    J = js.LlamaGenSession.random(cj, jc.drafter_config(cj, **DYN), seed=0,
                                  with_vq=False)
    vq = dict(codebook_size=cj.vocab_size, **VQ_KW)
    vt, vpt = _codec(J, jvq.VQGANConfig(**vq), tvq.VQGANConfig(**vq), 2)
    pt, dt = _port_weights(J)
    T = ts.LlamaGenSession(ct, tc.drafter_config(ct, **DYN), pt, dt,
                           vq_cfg=vt, vq_params=vpt,
                           passthrough_drafter=J.passthrough_drafter,
                           device="cpu")
    return J, T


@functools.lru_cache(maxsize=None)
def chameleon(family: str):
    """``(jax session, port session)`` of the tiny Chameleon (Lumina with
    its grid FSM's ids overridden), the passthrough drafter and a tiny
    taming-style codec with an 8192-row codebook."""
    cj, ct = jc.tiny_config(**CH_KW), tc.tiny_config(**CH_KW)
    J = js.ChameleonSession.random(cj, jc.drafter_config(cj, **DYN), seed=1,
                                   family=family, grid=GRIDS[family])
    vq = dict(resolution=16, attn_resolutions=(8,), codebook_size=8192,
              **VQ_KW)
    vt, vpt = _codec(J, jvq.chameleon_vq_config(**vq),
                     tvq.chameleon_vq_config(**vq), 3)
    pt, dt = _port_weights(J)
    overrides = FSM_IDS if family == "lumina" else None
    J.fsm_overrides = overrides
    T = ts.ChameleonSession(ct, tc.drafter_config(ct, **DYN), pt, dt,
                            family=family, grid=GRIDS[family], vq_cfg=vt,
                            vq_params=vpt, fsm_overrides=overrides,
                            tokenizer=hash_tokenize,
                            passthrough_drafter=J.passthrough_drafter,
                            device="cpu")
    return J, T


def same_stats(a, b):
    assert (a.steps, a.tokens) == (b.steps, b.tokens)
    assert a.step_compression == pytest.approx(b.step_compression)


# ------------------------------------------------------ lockstep batched AR

def _many_inputs(kind):
    """The JAX and port inputs of ``generate_many`` for three requests."""
    J, T = llamagen(kind)
    if kind == "label":
        conds = np.asarray([[3], [7], [1]], np.int32)
        u = np.asarray([J.cfg.num_classes], np.int32)
        return (jnp.asarray(conds), jnp.asarray(u), None,
                torch.from_numpy(conds), torch.from_numpy(u), None)
    pairs = [J._cond_pair(c) for c in CAPTIONS]
    conds = np.stack([np.array(c) for c, _, _ in pairs])
    pv = np.stack([np.asarray(p) for _, _, p in pairs])
    u = np.array(pairs[0][1])
    return (jnp.asarray(conds), jnp.asarray(u), jnp.asarray(pv),
            torch.from_numpy(conds), torch.from_numpy(u),
            torch.from_numpy(pv))


@pytest.mark.parametrize("kind", ["label", "caption"])
def test_generate_many_matches_jax(kind):
    """Three requests in lockstep, greedy: the JAX vmapped loop's tokens."""
    J, T = llamagen(kind)
    cj, uj, pvj, ct_, ut, pvt = _many_inputs(kind)
    ref = np.asarray(jar.generate_many(
        J.params, J.cfg, cj, uj, MAX_NEW, 2.0, JWarp(temperature=0.0),
        jax.vmap(jax.random.key)(jnp.arange(3, dtype=jnp.uint32)),
        prefix_valid=pvj))
    got = tar.generate_many(T.params, T.cfg, ct_, ut, MAX_NEW, 2.0,
                            TWarp(temperature=0.0), None, prefix_valid=pvt,
                            device="cpu")
    assert got.shape == (3, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len({tuple(r) for r in ref.tolist()}) == 3


def _token_batch(sess, prompts):
    tps = [sess._prompt(p) for p in prompts]
    return tps, [np.stack([np.asarray(getattr(tp, f)) for tp in tps])
                 for f in ("tokens", "positions", "valid")]


@pytest.mark.parametrize("case", ["fsm", "stop"])
def test_generate_tokens_many_matches_jax(case):
    """Three Lumina prompts of one length in lockstep, greedy: under the
    grid FSM (overridden ids), and unconstrained with a stop id that ends
    some requests early."""
    J, T = chameleon("lumina")
    prompts = [[60, 61, 62], [70, 71, 72], [80, 81, 82]]
    tps, (tok, pos, val) = _token_batch(T, prompts)
    L = tok.shape[-1]
    kw_j, kw_t, stop, max_new = {}, {}, (), MAX_NEW
    if case == "fsm":
        h, w = GRIDS["lumina"]
        max_new = h * (w + 1) + 1
        fkw = dict(w=w, h=h, image_start_idx=L - 3, vocab_size=T.cfg.vocab_size,
                   **FSM_IDS)
        kw_j = dict(logits_fn=jcham.LuminaGridFSM(**fkw))
        kw_t = dict(logits_fn=tcham.LuminaGridFSM(**fkw))
    else:
        probe = tar.generate_tokens(T.params, T.cfg, tps[1], MAX_NEW, 2.0,
                                    TWarp(temperature=0.0), None,
                                    device="cpu").tokens.tolist()
        i = next(i for i in range(3, MAX_NEW) if probe[i] not in probe[:i])
        stop = (probe[i],)
    jtp = jcham.anole_token_prompt([1]).__class__(
        tokens=jnp.asarray(tok), positions=jnp.asarray(pos),
        valid=jnp.asarray(val), pos_diff=jnp.zeros((3,), jnp.int32))
    ref, ref_n = jar.generate_tokens_many(
        J.params, J.cfg, jtp, max_new, 2.0, JWarp(temperature=0.0),
        jax.vmap(jax.random.key)(jnp.arange(3, dtype=jnp.uint32)),
        stop_ids=stop, **kw_j)
    ttp = tcham.TokenPrompt(torch.from_numpy(tok), torch.from_numpy(pos),
                            torch.from_numpy(val), torch.zeros(3))
    got, got_n = tar.generate_tokens_many(
        T.params, T.cfg, ttp, max_new, 2.0, TWarp(temperature=0.0), None,
        stop_ids=stop, device="cpu", **kw_t)
    ref_n = np.asarray(ref_n) if stop else np.full((3,), max_new)
    np.testing.assert_array_equal(got_n.numpy(), ref_n)
    for r in range(3):
        np.testing.assert_array_equal(got[r, :ref_n[r]].numpy(),
                                      np.asarray(ref)[r, :ref_n[r]])
    if stop:
        assert ref_n[1] < max_new
        assert not got[1, ref_n[1]:].any()
    else:
        body = got[:, :-1].reshape(3, 2, 5)
        assert (body[:, :, 4] == FSM_IDS["newline_id"]).all()


def test_many_sampling_equals_lone_runs():
    """Under sampling each request draws from its own generator in a lone
    run's order: its lockstep tokens equal a lone run of its seed, for an
    embedding prefix and for token prompts with a stop id."""
    _, T = llamagen("label")
    warp = TWarp(temperature=1.0, top_k=20)
    conds = torch.tensor([[3], [7], [1]])
    uncond = torch.tensor([T.cfg.num_classes])
    got = tar.generate_many(T.params, T.cfg, conds, uncond, MAX_NEW, 2.0,
                            warp, [request_generator(40 + r, "cpu")
                                   for r in range(3)], device="cpu")
    for r in range(3):
        alone = tar.generate(T.params, T.cfg, conds[r], uncond, MAX_NEW, 2.0,
                             warp, request_generator(40 + r, "cpu"),
                             device="cpu")
        np.testing.assert_array_equal(got[r].numpy(), alone.tokens.numpy())
    _, C = chameleon("anole")
    tps, (tok, pos, val) = _token_batch(C, [[60, 61], [70, 71], [80, 81]])
    ttp = tcham.TokenPrompt(torch.from_numpy(tok), torch.from_numpy(pos),
                            torch.from_numpy(val), torch.zeros(3))
    probe = tar.generate_tokens(C.params, C.cfg, tps[0], MAX_NEW, 2.0, warp,
                                request_generator(7, "cpu"),
                                device="cpu").tokens.tolist()
    stop = (probe[4],)
    got, n = tar.generate_tokens_many(
        C.params, C.cfg, ttp, MAX_NEW, 2.0, warp,
        [request_generator(7 + r, "cpu") for r in range(3)], stop_ids=stop,
        device="cpu")
    assert n[0] <= 5
    for r in range(3):
        alone = tar.generate_tokens(C.params, C.cfg, tps[r], MAX_NEW, 2.0,
                                    warp, request_generator(7 + r, "cpu"),
                                    stop_ids=stop, device="cpu")
        assert int(n[r]) == alone.n_valid
        np.testing.assert_array_equal(got[r].numpy(), alone.tokens.numpy())


# -------------------------------------------------------------- generate

LG_MODES = [
    pytest.param("ar", {}, id="ar"),
    pytest.param("static", dict(tree="chain_bush_8"), id="static-stale"),
    pytest.param("static", dict(tree="chain_bush_8", stale_draft=False),
                 id="static-drafter"),
    pytest.param("dynamic", {}, id="dynamic")]


@pytest.mark.parametrize("mode,kw", LG_MODES)
@pytest.mark.parametrize("kind", ["label", "caption"])
def test_llamagen_generate_matches_jax(kind, mode, kw):
    J, T = llamagen(kind)
    prompt = 3 if kind == "label" else CAPTIONS[1]
    a, sa = J.generate(prompt, mode=mode, seed=4, **GREEDY, **kw)
    b, sb = T.generate(prompt, mode=mode, seed=4, **GREEDY, **kw)
    assert isinstance(b, np.ndarray) and b.shape == (T.cfg.block_size,)
    np.testing.assert_array_equal(b, np.asarray(a))
    same_stats(sb, sa)
    assert sb.latency > 0


@pytest.mark.parametrize("mode,kw", [
    pytest.param("ar", {}, id="ar"),
    pytest.param("static", {}, id="static-stale"),
    pytest.param("static", dict(tree="chain_bush_8", stale_draft=False),
                 id="static-drafter"),
    pytest.param("dynamic", {}, id="dynamic")])
@pytest.mark.parametrize("family", ["anole", "lumina"])
def test_chameleon_generate_matches_jax(family, mode, kw):
    """Anole under the image-token mask, Lumina under its grid FSM with
    overridden ids (the default tree, ``mc_sim_7b_63``, unless named)."""
    J, T = chameleon(family)
    a, sa = J.generate([12, 33, 7], mode=mode, seed=2, **GREEDY, **kw)
    b, sb = T.generate([12, 33, 7], mode=mode, seed=2, **GREEDY, **kw)
    np.testing.assert_array_equal(b, np.asarray(a))
    same_stats(sb, sa)
    if family == "lumina":
        h, w = GRIDS["lumina"]
        assert (b[:-1].reshape(h, w + 1)[:, w] == FSM_IDS["newline_id"]).all()
        assert b[-1] == FSM_IDS["image_end_id"]


@pytest.mark.parametrize("mode", ["ar", "static"])
def test_chameleon_stop_ids_match_jax(mode):
    """``stop_ids``: unconstrained logits, the stream cut one past the
    first stop id, as the JAX session cuts it."""
    J, T = chameleon("anole")
    probe, _ = T.generate([12, 33], max_new=16, mode="ar",
                          stop_ids=(T.cfg.vocab_size - 1,), **GREEDY)
    i = next(i for i in range(4, 16) if probe[i] not in probe[:i])
    kw = dict(max_new=16, mode=mode, stop_ids=(int(probe[i]),),
              tree="chain_bush_8", **GREEDY)
    a, sa = J.generate([12, 33], **kw)
    b, sb = T.generate([12, 33], **kw)
    assert len(b) == i + 1 and b[-1] == probe[i]
    np.testing.assert_array_equal(b, np.asarray(a))
    same_stats(sb, sa)


# -------------------------------------------------------- generate_batch

def same_requests(got, ref, steps=True):
    assert [r.uid for r in got] == [r.uid for r in ref]
    for a, b in zip(got, ref):
        assert a.error is None and b.error is None, (a.error, b.error)
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=str(a.uid))
        if steps:
            assert a.steps == b.steps, a.uid


@functools.lru_cache(maxsize=None)
def _jax_batch(what: str, mode: str):
    J, _ = llamagen("label") if what == "label" else chameleon("lumina")
    prompts = ([1, 4, 7, 2, 9] if what == "label"
               else [[12], [12, 33], [12, 33, 7]])
    kw = dict(tree="chain_bush_8") if mode == "static" else {}
    return J.generate_batch(prompts, slots=2, max_new=MAX_NEW, mode=mode,
                            seed=30, **GREEDY, **kw), prompts, kw


@pytest.mark.parametrize("mode", ["static", "dynamic", "ar"])
@pytest.mark.parametrize("what", ["label", "lumina"])
def test_generate_batch_matches_jax(what, mode):
    """Five label requests, or three ragged Lumina prompts (one grid FSM,
    a start per slot), on 2 slots: each request equals the JAX session's
    ``generate_batch`` (tokens, and steps in the speculative modes)."""
    ref, prompts, kw = _jax_batch(what, mode)
    _, T = llamagen("label") if what == "label" else chameleon("lumina")
    got = T.generate_batch(prompts, slots=2, max_new=MAX_NEW, mode=mode,
                           seed=30, **GREEDY, **kw)
    same_requests(got, ref, steps=mode != "ar")


def test_generate_batch_pinned_dynamic_equals_lone_runs():
    """``pin`` (the port's hook, ``SpecDecodeConfig.pin``): a pinned
    sampled dynamic batch equals each request's pinned lone ``generate``,
    tokens and steps."""
    _, T = llamagen("caption")
    kw = dict(max_new=MAX_NEW, mode="dynamic", temperature=1.0, top_k=20,
              cfg_scale=2.0, pin=0.5, seed=60)
    done = T.generate_batch(CAPTIONS, slots=2, **kw)
    for r in done:
        toks, st = T.generate(CAPTIONS[r.uid], **dict(kw, seed=60 + r.uid))
        np.testing.assert_array_equal(r.tokens, toks)
        assert r.steps == st.steps


def test_generate_batch_failures_and_empty():
    """A prompt that fails is recorded with its error and the rest are
    served, in every mode; no prompts, no requests."""
    _, T = llamagen("label")
    for mode in ("static", "ar"):
        done = T.generate_batch([3, "not a label", 5], slots=2,
                                max_new=MAX_NEW, mode=mode, tree="chain",
                                **GREEDY)
        assert [r.uid for r in done] == [0, 1, 2]
        assert done[1].error is not None and done[1].tokens is None
        assert done[0].error is None and done[2].error is None
    assert T.generate_batch([], mode="static", tree="chain") == []


# -------------------------------------------------------------- decoding

def _close_uint8(got, ref):
    ref = np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_decode_matches_jax():
    """LlamaGen ``decode_ids`` on 16 codes and on a batch; Chameleon
    ``decode_generated`` of both families' streams and ``decode_ids`` of a
    Lumina image span: within one uint8 level of the JAX sessions."""
    J, T = llamagen("label")
    codes = np.random.default_rng(0).integers(0, 256, (2, 16))
    _close_uint8(T.decode_ids(codes[0]), J.decode_ids(codes[0]))
    _close_uint8(T.decode_ids(codes), J.decode_ids(codes))
    assert T.decode_ids(codes).shape == (2, 8, 8, 3)
    for family in ("anole", "lumina"):
        J, T = chameleon(family)
        toks, _ = T.generate([12, 33, 7], mode="ar", **GREEDY)
        img = T.decode_generated(toks)
        h, w = GRIDS[family]
        assert img.shape == (2 * h, 2 * w, 3)
        _close_uint8(img, J.decode_generated(toks))
    J, T = chameleon("lumina")
    rng = np.random.default_rng(1)
    span = [tcham.IMAGE_START_ID, 8805, 8806]
    for _ in range(2):
        span += list(rng.integers(4, 8196, 4)) + [tcham.LUMINA_NEWLINE_ID]
    span += [tcham.IMAGE_END_ID]
    stream = [20, 21] + span + [22]
    (ta, ia), (tb, ib) = J.decode_ids(stream), T.decode_ids(stream)
    assert ta == tb == [[20, 21], [22]] and len(ib) == 1
    _close_uint8(ib[0], ia[0])
    with pytest.raises(ValueError, match="codec"):
        ts.LlamaGenSession(T.cfg, None, T.params, None,
                           device="cpu").decode_ids(codes)


# ------------------------------------------------------- construction, IO

def test_random_sessions_run():
    """The port's own random sessions (weights from torch generators)."""
    cfg = tc.tiny_config(cond_kind="label", **LG_KW)
    s = ts.LlamaGenSession.random(cfg, tc.drafter_config(cfg, **DYN),
                                  device="cpu")
    assert s.passthrough_drafter and s.vq_cfg.codebook_size == 256
    toks, st = s.generate(5, max_new=8, mode="static", tree="chain",
                          **GREEDY)
    assert toks.shape == (8,) and st.step_compression >= 1.0
    c = ts.ChameleonSession.random(tc.tiny_config(**CH_KW), None,
                                   family="lumina", grid=(2, 2),
                                   device="cpu")
    c.fsm_overrides = FSM_IDS
    toks, st = c.generate([5, 6], mode="static", **GREEDY)
    assert toks.shape == (7,) and st.step_compression == 1.0
    with pytest.raises(ValueError, match="tokenizer"):
        ts.ChameleonSession(c.cfg, None, c.params, None, device="cpu")\
            .generate("raw text")


def test_from_pretrained_matches_jax(tmp_path):
    """Sessions loaded from checkpoints the test writes: a caption LlamaGen
    base, its drafter, a VQ-16-named codec and a nearest table; a Lumina
    base with its tokenizer json, prompted with raw text.  Greedy tokens
    and decoded images equal the JAX sessions loaded from the same
    files."""
    from test_bpe import _make_tokenizer_file

    J, _ = llamagen("caption")
    base, drafter = tmp_path / "base", tmp_path / "drafter"
    base.mkdir()
    drafter.mkdir()
    save_torch(base / "pytorch_model.bin", hf_state_dict(J.params, J.cfg))
    save_torch(drafter / "pytorch_model.bin",
               drafter_state_dict(J.dparams, J.dcfg))
    # the published VQ-16's module names (the loaders take the tensors'
    # shapes as they come): a narrow codec at ch 32
    vq16 = jvq.vq16_config(codebook_size=J.cfg.vocab_size, ch=32,
                           z_channels=16)
    save_torch(tmp_path / "vq.pt", to_llamagen_names(
        jvq.random_taming_state_dict(vq16, 2), len(vq16.ch_mult)))
    jvd.save_table(str(tmp_path / "near.npy"), np.random.default_rng(0)
                   .integers(0, 256, (256, 11)))
    kw = dict(drafter_path=str(drafter), vq_path=str(tmp_path / "vq.pt"),
              nearest_path=str(tmp_path / "near.npy"))
    cfg_t = tc.tiny_config(cond_kind="caption", **LG_KW)
    a = js.LlamaGenSession.from_pretrained(
        str(base), J.cfg, dcfg=J.dcfg, **kw)
    b = ts.LlamaGenSession.from_pretrained(
        str(base), cfg_t, dcfg=tc.drafter_config(cfg_t, **DYN),
        device="cpu", **kw)
    gk = dict(mode="static", tree="chain_bush_8", stale_draft=False,
              lantern_k=3, lantern_delta=0.1, **GREEDY)
    ta, _ = a.generate(CAPTIONS[0], **gk)
    tb, _ = b.generate(CAPTIONS[0], **gk)
    np.testing.assert_array_equal(tb, np.asarray(ta))
    _close_uint8(b.decode_ids(tb), a.decode_ids(np.asarray(ta)))
    # with a T5 directory both sessions embed captions through T5Embedder
    from test_torch_eval_cli import write_tiny_t5

    t5 = write_tiny_t5(tmp_path / "t5")
    a = js.LlamaGenSession.from_pretrained(str(base), J.cfg, t5_dir=t5)
    b = ts.LlamaGenSession.from_pretrained(str(base), cfg_t, t5_dir=t5,
                                           device="cpu")
    assert type(b.t5).__name__ == "T5Embedder"
    np.testing.assert_allclose(b.t5.get_text_embeddings(CAPTIONS[:2])[0],
                               a.t5.get_text_embeddings(CAPTIONS[:2])[0],
                               rtol=0, atol=1e-6)

    C, _ = chameleon("lumina")
    cbase = tmp_path / "lumina"
    (cbase / "chameleon" / "tokenizer").mkdir(parents=True)
    save_torch(cbase / "pytorch_model.bin", hf_state_dict(C.params, C.cfg))
    _make_tokenizer_file(cbase / "chameleon" / "tokenizer")
    kw = dict(family="lumina", grid=GRIDS["lumina"])
    a = js.ChameleonSession.from_pretrained(str(cbase), C.cfg, **kw)
    b = ts.ChameleonSession.from_pretrained(
        str(cbase), tc.tiny_config(**CH_KW), device="cpu", **kw)
    a.fsm_overrides = b.fsm_overrides = FSM_IDS
    assert b.tokenizer("abc ab") == [12, 10]
    ta, _ = a.generate("abc ab c", **GREEDY)
    tb, _ = b.generate("abc ab c", **GREEDY)
    np.testing.assert_array_equal(tb, np.asarray(ta))
