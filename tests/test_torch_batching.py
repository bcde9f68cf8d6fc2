"""The port's batched serving against ``lantern_tpu`` on the CPU, and the
per-batch-row kernel forms it runs on.

Batched serving: ``BatchedEngine`` + ``Scheduler`` (its one run loop on
the native slot table and on ``SlotTable``, which must answer every call
alike) against the JAX ``BatchedEngine`` + ``Scheduler`` on the
setups of ``tests/test_batching.py``, weights bridged by
``convert_params``: label requests with slot reuse (greedy, pinned, int8
KV, stale drafting), Lumina token prompts, and ragged Lumina prompts on 3
slots under one grid FSM whose static start is wrong for two of them.
Token streams and step counts must be equal.  Under sampling the two
frameworks draw different numbers, so a request's batched tokens are held
to the port's own single-request run of the same seed.  The JAX references
are computed once per module.

Kernel forms: K2's plain version with one ``length`` per batch row against
the Pallas kernel in interpret mode (f32 at 1e-5, bf16 at 2e-2); K3's and
K4's plain versions with one ``start`` per batch row against the Pallas
kernels' slot-major ``[R]`` form, byte for byte.  Tests marked ``cuda``
hold the CUDA kernels against their plain versions and skip here.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu import kv as jkv
from lantern_tpu import trees as jt
from lantern_tpu.engine import batch as jbatch
from lantern_tpu.engine import scheduler as jsched
from lantern_tpu.engine import spec as jspec
from lantern_tpu.models import chameleon as jcham
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops.acceptance import LanternSpec as JLantern
from lantern_tpu.ops.pallas import kv_update as jkvu
from lantern_tpu.ops.pallas import tree_attention as jta
from lantern_tpu.ops.sampling import LogitsWarp as JWarp
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch import kv as tkv
from lantern_tpu_torch import native
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.convert import to_tensor
from lantern_tpu_torch.engine import spec as tspec
from lantern_tpu_torch.engine.batch import EMPTY, BatchedEngine
from lantern_tpu_torch.engine.scheduler import Request, Scheduler, SlotTable
from lantern_tpu_torch.models import chameleon as tcham
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.ops import tree_attention as tta
from lantern_tpu_torch.ops.acceptance import LanternSpec as TLantern
from lantern_tpu_torch.ops.sampling import LogitsWarp as TWarp

F32 = dict(rtol=1e-5, atol=1e-5)
MAX_NEW = 12
TREE = "chain_bush_8"
LABEL_KW = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
                block_size=16, max_seq_len=96)
LUMINA_KW = dict(vocab_size=8832, hidden_size=256, num_layers=2, num_heads=2,
                 rope_kind="1d", cond_kind="none", qk_norm=True,
                 swin_norm=True, max_seq_len=80)
LABELS = [1, 4, 7, 2, 9]                    # 5 requests on 2 slots
LOOPS = [pytest.param(True, id="native"), pytest.param(False, id="python")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def tt(a):
    return to_tensor(np.asarray(a), "cpu")


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def ecfgs(kind: str, **kw):
    """``(jax, port)`` engine configs: greedy, pinned (``pin=0.5``, LANTERN
    k=10 delta=5, top-20) or sampling (the same, unpinned)."""
    common = dict(cfg_scale=2.0, max_new=MAX_NEW, walk_batch_warp=True)
    common.update(kw)
    if kind == "greedy":
        return (jspec.SpecDecodeConfig(warp=JWarp(temperature=0.0), **common),
                tspec.SpecDecodeConfig(warp=TWarp(temperature=0.0), **common))
    pin = 0.5 if kind == "pinned" else None
    return (jspec.SpecDecodeConfig(warp=JWarp(temperature=1.0, top_k=20),
                                   pin=pin, lantern=JLantern(k=10, delta=5.0),
                                   **common),
            tspec.SpecDecodeConfig(warp=TWarp(temperature=1.0, top_k=20),
                                   pin=pin, lantern=TLantern(k=10, delta=5.0),
                                   **common))


def _pair(kw, seed, nearest=False, dkw=()):
    """Base and drafter params of both packages on one tiny config
    (``dkw``: the drafter's dynamic-tree geometry, as items)."""
    cfg_j, cfg_t = jc.tiny_config(**kw), tc.tiny_config(**kw)
    dcfg_j = jc.drafter_config(cfg_j, **dict(dkw))
    dcfg_t = tc.drafter_config(cfg_t, **dict(dkw))
    pj = jtfm.fuse_params(jtfm.init_params(jax.random.key(seed), cfg_j))
    dj = jtfm.fuse_params(jdrf.init_drafter_params(
        jax.random.key(seed + 1), dcfg_j, pj["embed"]))
    if nearest:
        V = cfg_j.vocab_size
        pj = dict(pj, nearest_latents=jnp.asarray(
            np.random.default_rng(seed).integers(0, V, size=(V, 11)),
            jnp.int32))
    pt = convert.convert_params(jax.tree.map(np.asarray, pj), device="cpu")
    dt = convert.convert_drafter_params(jax.tree.map(np.asarray, dj),
                                        device="cpu", embed=pt["embed"])
    return dict(cfg=(cfg_j, cfg_t), dcfg=(dcfg_j, dcfg_t), p=(pj, pt),
                d=(dj, dt), tree=(jt.get_tree(TREE), ttr.get_tree(TREE)))


@pytest.fixture(scope="module")
def label():
    return _pair(dict(cond_kind="label", **LABEL_KW), 0, nearest=True)


@pytest.fixture(scope="module")
def lumina():
    return _pair(LUMINA_KW, 2)


def label_requests(cfg_t, labels=LABELS, seed0=100):
    uncond = torch.tensor([cfg_t.num_classes])
    return [Request(uid=lab, cond=torch.tensor([lab]), uncond=uncond,
                    seed=seed0 + i) for i, lab in enumerate(labels)]


def port_engine(lane, ecfg, slots, **kw):
    return BatchedEngine(ecfg=ecfg, cfg=lane["cfg"][1], tree=lane["tree"][1],
                         params=lane["p"][1], num_slots=slots,
                         dparams=lane["d"][1], dcfg=lane["dcfg"][1],
                         device="cpu", **kw)


def jax_run(lane, ecfg, reqs, slots, **kw):
    """The JAX BatchedEngine + Scheduler (its Python loop, which leaves
    ``native/`` alone): ``{uid: (tokens, steps)}``."""
    (cfg_j, _), (dcfg_j, _) = lane["cfg"], lane["dcfg"]
    eng = jbatch.BatchedEngine(ecfg, cfg_j, dcfg_j, lane["tree"][0],
                               lane["p"][0], lane["d"][0], num_slots=slots,
                               **kw)
    done = jsched.Scheduler(eng, use_native=False).run(reqs)
    assert all(r.error is None for r in done)
    return {r.uid: (np.asarray(r.tokens), int(r.steps)) for r in done}


@functools.lru_cache(maxsize=None)
def _jax_label(mode: str, **kw):
    lane = _pair(dict(cond_kind="label", **LABEL_KW), 0, nearest=True)
    cfg_j = lane["cfg"][0]
    reqs = [jsched.Request(uid=lab, cond=jnp.asarray([lab]),
                           uncond=jnp.asarray([cfg_j.num_classes]),
                           seed=100 + i) for i, lab in enumerate(LABELS)]
    return jax_run(lane, ecfgs(mode, **kw)[0], reqs, 2)


def same_as(done, ref):
    assert len(done) == len(ref)
    for r in done:
        assert r.error is None, r.error
        np.testing.assert_array_equal(r.tokens, ref[r.uid][0],
                                      err_msg=str(r.uid))
        assert r.steps == ref[r.uid][1], r.uid


# ------------------------------------------------------------ label lane

@pytest.mark.parametrize("use_native", LOOPS)
@pytest.mark.parametrize("mode,kw", [
    pytest.param("greedy", {}, id="greedy"),
    pytest.param("pinned", {}, id="pinned"),
    pytest.param("greedy", {"kv_quant": True}, id="int8-kv"),
    pytest.param("pinned", {"stale_draft": True}, id="stale-pinned")])
def test_batched_label_matches_jax(label, use_native, mode, kw):
    """5 label requests on 2 slots (slot reuse): tokens and steps equal the
    JAX engine's on both run loops."""
    eng = port_engine(label, ecfgs(mode, **kw)[1], 2)
    done = Scheduler(eng, use_native=use_native).run(
        label_requests(label["cfg"][1]))
    assert [r.uid for r in done] == LABELS
    same_as(done, _jax_label(mode, **kw))


def test_batched_sampling_equals_single_per_seed(label):
    """Unpinned sampling: each slot draws from its own generator in the
    single-request engine's order, so a request's batched tokens and steps
    equal ``spec.generate`` alone with ``request_generator(seed)``."""
    et = ecfgs("sampling")[1]
    cfg_t = label["cfg"][1]
    reqs = label_requests(cfg_t, labels=[2, 6, 3], seed0=50)
    done = Scheduler(port_engine(label, et, 2), use_native=False).run(reqs)
    streams = set()
    for r in done:
        alone = tspec.generate(label["p"][1], et, cfg_t, label["tree"][1],
                               None, tspec.request_generator(r.seed, "cpu"),
                               device="cpu", dparams=label["d"][1],
                               dcfg=label["dcfg"][1], cond=r.cond,
                               uncond=r.uncond)
        np.testing.assert_array_equal(r.tokens, alone.tokens.numpy())
        assert r.steps == alone.steps
        streams.add(tuple(r.tokens.tolist()))
    assert len(streams) == 3


def test_step_many_equals_repeated_step(label):
    """``step_many(n)`` is n steps: the same state, bit for bit."""
    et = ecfgs("pinned")[1]
    cfg_t = label["cfg"][1]
    outs = []
    for fused in (False, True):
        eng = port_engine(label, et, 2)
        pres = [eng.prefill(torch.tensor([i]), torch.tensor(
            [cfg_t.num_classes]), tspec.request_generator(40 + i, "cpu"))
            for i in range(2)]
        batch = eng.empty_batch(pres[0])
        for i, p in enumerate(pres):
            batch = eng.insert(batch, i, p)
        if fused:
            batch = eng.step_many(batch, 4)
        else:
            for _ in range(4):
                batch = eng.step(batch)
        outs.append((eng.slot_status(batch),
                     [eng.slot_tokens(batch, s) for s in range(2)],
                     batch.base_kv))
    (sa, ta, ka), (sb, tb, kb) = outs
    for a, b in zip(sa, sb):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ta, tb):
        np.testing.assert_array_equal(a, b)
    assert int(sa[1].min()) == 4
    assert torch.equal(ka.length, kb.length)
    assert torch.equal(ka.k, kb.k) and torch.equal(ka.v, kb.v)


def test_empty_slots_are_frozen_and_inserts_do_not_alias(label):
    """An empty slot stays at ``n_new = 1 << 30`` with its cache length at
    0 through steps; inserting a request copies its rows into its own two
    batch rows only, and a step of one slot leaves the other slots' rows
    below their lengths untouched."""
    et = ecfgs("greedy")[1]
    cfg_t = label["cfg"][1]
    eng = port_engine(label, et, 3)
    pre = eng.prefill(torch.tensor([5]), torch.tensor([cfg_t.num_classes]))
    batch = eng.empty_batch(pre)
    assert batch.base_kv.k.data_ptr() != pre[0].base_kv.k.data_ptr()
    batch = eng.insert(batch, 1, pre)
    n0 = int(pre[0].base_kv.length)
    assert batch.base_kv.length.tolist() == [0, 0, n0, n0, 0, 0]
    assert torch.equal(batch.base_kv.k[:, 2:4], pre[0].base_kv.k)
    assert not batch.base_kv.k[:, [0, 1, 4, 5]].any()
    batch = eng.step_many(batch, 2)
    n_new, steps, _ = eng.slot_status(batch)
    assert n_new[0] == n_new[2] == EMPTY and steps[0] == steps[2] == 0
    lens = batch.base_kv.length.tolist()
    assert lens[0] == lens[1] == lens[4] == lens[5] == 0
    assert lens[2] == lens[3] == n0 + n_new[1]


# --------------------------------------------------------- Lumina lanes

def lumina_prompts(texts, grid):
    return ([jcham.lumina_token_prompt(t, grid=grid) for t in texts],
            [tcham.lumina_token_prompt(t, grid=grid) for t in texts])


@functools.lru_cache(maxsize=None)
def _jax_lumina(case: str):
    lane = _pair(LUMINA_KW, 2)
    return _lumina_case(lane, case, jax_side=True)


def _lumina_case(lane, case, jax_side=False, use_native=False):
    """``token``: three Lumina prompts of one length on 2 slots under the
    image-token mask; ``ragged``: prompts of three lengths on 3 slots under
    one grid FSM whose static start is right for none but the first."""
    V = LUMINA_KW["vocab_size"]
    if case == "token":
        grid, texts = (2, 4), [[60, 61, 62], [70, 71, 72], [80, 81, 82]]
        slots, max_new = 2, MAX_NEW
    else:
        grid, texts = (2, 4), [[12], [12, 33], [12, 33, 7]]
        slots, max_new = 3, (grid[1] + 1) * grid[0] + 1
    pj_tp, pt_tp = lumina_prompts(texts, grid)
    ej, et = ecfgs("greedy", max_new=max_new)
    if case == "token":
        kw_j = dict(logits_mask=jnp.asarray(jcham.non_image_token_mask(V)))
        kw_t = dict(logits_mask=torch.from_numpy(
            tcham.non_image_token_mask(V)))
    else:
        fkw = dict(w=grid[1], h=grid[0], image_start_idx=len(texts[0]),
                   vocab_size=V)
        kw_j = dict(logits_fn=jcham.LuminaGridFSM(**fkw))
        kw_t = dict(logits_fn=tcham.LuminaGridFSM(**fkw))
    if jax_side:
        reqs = [jsched.Request(uid=i, token_prompt=tp, seed=9 + i)
                for i, tp in enumerate(pj_tp)]
        return jax_run(lane, ej, reqs, slots, **kw_j)
    reqs = [Request(uid=i, token_prompt=tp, seed=9 + i)
            for i, tp in enumerate(pt_tp)]
    eng = port_engine(lane, et, slots, **kw_t)
    return Scheduler(eng, use_native=use_native).run(reqs), grid, max_new


@pytest.mark.parametrize("use_native", LOOPS)
@pytest.mark.parametrize("case", ["token", "ragged"])
def test_batched_lumina_prompts_match_jax(lumina, case, use_native):
    """Token prompts (slot reuse), and ragged prompts whose grid FSM starts
    at three places: each slot binds its own start, so every stream obeys
    the grammar and equals the JAX engine's."""
    done, grid, max_new = _lumina_case(lumina, case, use_native=use_native)
    same_as(done, _jax_lumina(case))
    for r in done:
        body = r.tokens[:max_new - 1]
        if case == "ragged":
            body = body.reshape(grid[0], grid[1] + 1)
            assert (body[:, grid[1]] == tcham.LUMINA_NEWLINE_ID).all()
            assert r.tokens[max_new - 1] == tcham.IMAGE_END_ID
        else:
            assert ((body >= tcham.IMAGE_TOKEN_START)
                    & (body <= tcham.IMAGE_TOKEN_END)).all()


# ---------------------------------------------- scheduler: the lifecycle

def test_stop_ids_drain(label):
    """Slots that hit a stop id finish early, report ``max_new``, and hold
    the single-request stop run's tokens, one past the stop."""
    cfg_t = label["cfg"][1]
    probe = ecfgs("greedy")[1]
    alone = tspec.generate(label["p"][1], probe, cfg_t, label["tree"][1],
                           None, None, device="cpu", dparams=label["d"][1],
                           dcfg=label["dcfg"][1], cond=torch.tensor([3]),
                           uncond=torch.tensor([cfg_t.num_classes]))
    et = ecfgs("greedy", stop_ids=(int(alone.tokens[5]),))[1]
    expected = {}
    for lab in (3, 5):
        r = tspec.generate(label["p"][1], et, cfg_t, label["tree"][1], None,
                           None, device="cpu", dparams=label["d"][1],
                           dcfg=label["dcfg"][1], cond=torch.tensor([lab]),
                           uncond=torch.tensor([cfg_t.num_classes]))
        expected[lab] = r.tokens[:r.n_valid].numpy()
    assert len(expected[3]) < MAX_NEW               # the stop fires
    done = Scheduler(port_engine(label, et, 2), use_native=False).run(
        label_requests(cfg_t, labels=[3, 5]))
    for r in done:
        assert r.error is None
        np.testing.assert_array_equal(r.tokens, expected[r.uid])


@pytest.mark.parametrize("use_native", LOOPS)
def test_failure_capture_keeps_serving(label, use_native):
    """A request whose prefill raises, and one that arrives failed, are
    recorded with their errors; the others complete; input order holds."""
    cfg_t = label["cfg"][1]
    reqs = label_requests(cfg_t, labels=[1, 4, 7])
    reqs.insert(1, Request(uid="bad", cond=torch.zeros((3, 5)),
                           uncond=torch.tensor([cfg_t.num_classes]), seed=9))
    reqs.insert(3, Request(uid="prefailed", error="ValueError: bad prompt"))
    done = Scheduler(port_engine(label, ecfgs("greedy")[1], 2),
                     use_native=use_native).run(reqs)
    assert [r.uid for r in done] == [1, "bad", 4, "prefailed", 7]
    by = {r.uid: r for r in done}
    assert by["bad"].error is not None and by["bad"].tokens is None
    assert by["prefailed"].error == "ValueError: bad prompt"
    same_as([by[u] for u in (1, 4, 7)],
            {k: v for k, v in _jax_label("greedy").items() if k in (1, 4, 7)})


@pytest.mark.parametrize("use_native", LOOPS)
def test_all_failed_and_empty_runs(label, use_native):
    sched = Scheduler(port_engine(label, ecfgs("greedy")[1], 2),
                      use_native=use_native)
    assert sched.run([]) == []
    done = sched.run([Request(uid=i, error=f"boom {i}") for i in range(3)])
    assert [r.uid for r in done] == [0, 1, 2]
    assert all(r.error == f"boom {r.uid}" and r.tokens is None for r in done)


def test_native_queue_guards():
    """The native queue drops a duplicate live uid and one >= 2**63."""
    ns = native.NativeScheduler(2)
    ns.enqueue(7, prompt_len=0, max_new=4)
    ns.enqueue(7, prompt_len=0, max_new=4)
    ns.enqueue(2 ** 63 + 1, prompt_len=0, max_new=4)
    assert ns.num_waiting == 1
    assert ns.fill_slots() == [(0, 7)] and ns.num_active == 1
    assert ns.report_step([4, 0], [3, 0], [4, 0]) == 1
    assert ns.drain() == [(7, 3, 4)] and ns.num_active == 0
    assert native.LIB_PATH.parent.name == "lantern_sched"


@pytest.mark.parametrize("script", ["finish", "fail"])
def test_slot_tables_agree(script):
    """``SlotTable`` answers the run loop's calls as the native table does:
    a duplicate live uid is dropped, free slots fill in slot order, a
    failed request frees its slot or leaves the queue, and finished
    requests drain with their stats."""
    tables = (native.NativeScheduler(3), SlotTable(3))

    def both(fn):
        got = [fn(t) for t in tables]
        assert got[0] == got[1], got
        return got[0]

    for uid in (5, 5, 6, 7, 8):
        both(lambda t: t.enqueue(uid, prompt_len=0, max_new=4))
    assert both(lambda t: (t.num_waiting, t.num_active)) == (4, 0)
    assert both(lambda t: t.fill_slots()) == [(0, 5), (1, 6), (2, 7)]
    if script == "fail":
        assert both(lambda t: t.fail(8)) and not both(lambda t: t.fail(8))
        assert both(lambda t: t.fail(6))
        assert both(lambda t: t.fill_slots()) == []
        assert both(lambda t: (t.num_waiting, t.num_active)) == (0, 2)
        return
    assert both(lambda t: t.fail(6)) and not both(lambda t: t.fail(6))
    assert both(lambda t: t.fill_slots()) == [(1, 8)]
    assert both(lambda t: t.report_step([4, 2, 4], [3, 1, 2],
                                        [4, 2, 4])) == 2
    assert both(lambda t: t.drain(cap=1)) == [(5, 3, 4)]
    assert both(lambda t: t.drain()) == [(7, 2, 4)]
    assert both(lambda t: (t.num_waiting, t.num_active)) == (0, 1)
    assert both(lambda t: t.report_step([0, 4, 0], [0, 5, 0],
                                        [0, 6, 0])) == 1
    assert both(lambda t: t.drain()) == [(8, 5, 6)]
    assert both(lambda t: (t.num_waiting, t.num_active)) == (0, 0)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A queue that does not build raises; nothing falls back to the Python
    loop."""
    bad = tmp_path / "scheduler.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "lib" / "x.so")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        native.NativeScheduler(2)
    eng = object.__new__(BatchedEngine)
    eng.num_slots = 2
    with pytest.raises(RuntimeError, match="build failed"):
        Scheduler(eng).run([Request(uid=0)])


class _Gated(Scheduler):
    """Requests named in ``after`` arrive once request ``first`` is done;
    the others at once.  Records the step count at every insert."""

    def __init__(self, engine, first, after, **kw):
        super().__init__(engine, **kw)
        self.first, self.after, self.inserts, self.steps = first, after, [], 0
        step, insert = engine.step, engine.insert

        def counted_step(batch):
            self.steps += 1
            return step(batch)

        def recorded_insert(batch, slot, request):
            self.inserts.append((self.steps, slot))
            return insert(batch, slot, request)

        engine.step, engine.insert = counted_step, recorded_insert

    def _arrived(self, req):
        return req.uid not in self.after or self.first.tokens is not None


@pytest.mark.parametrize("use_native", LOOPS)
def test_refill_after_drain_admits_every_arrival(label, use_native):
    """Two requests that arrive together after every slot drained are
    both admitted at once and decode in the same steps (the JAX Python loop
    admits one and leaves the other waiting for a completion)."""
    cfg_t = label["cfg"][1]
    reqs = label_requests(cfg_t, labels=[3, 8, 5])
    sched = _Gated(port_engine(label, ecfgs("greedy")[1], 2), reqs[0],
                   after={8, 5}, use_native=use_native)
    done = sched.run(reqs)
    assert [r.uid for r in done] == [3, 8, 5]
    assert len(sched.inserts) == 3
    (s0, _), (s1, a), (s2, b) = sched.inserts
    assert s0 == 0 and s1 == s2 > 0 and {a, b} == {0, 1}
    ref = _single_greedy(label, (3, 8, 5))
    for r in done:
        np.testing.assert_array_equal(r.tokens, ref[r.uid])


def _single_greedy(label, labels):
    cfg_t = label["cfg"][1]
    out = {}
    for lab in labels:
        r = tspec.generate(label["p"][1], ecfgs("greedy")[1], cfg_t,
                           label["tree"][1], None, None, device="cpu",
                           dparams=label["d"][1], dcfg=label["dcfg"][1],
                           cond=torch.tensor([lab]),
                           uncond=torch.tensor([cfg_t.num_classes]))
        out[lab] = r.tokens.numpy()
    return out


def test_batched_engine_rejects_dynamic_and_deferred(label):
    """Dynamic mode runs (below); what the JAX engine rejects still
    raises: dynamic trees without the drafter, and deferred commit."""
    with pytest.raises(ValueError, match="stale_draft"):
        port_engine(label, ecfgs("greedy", mode="dynamic",
                                 stale_draft=True)[1], 2)
    with pytest.raises(ValueError, match="deferred_commit"):
        port_engine(label, ecfgs("greedy", deferred_commit=True)[1], 2)
    with pytest.raises(ValueError, match="deferred_commit"):
        port_engine(label, ecfgs("greedy", mode="dynamic",
                                 deferred_commit=True)[1], 2)


# ------------------------------------------- batched dynamic (EAGLE-2) mode

# the geometry of tests/test_batching.py's dynamic case
DYN = (("total_tokens", 10), ("depth", 2), ("top_k", 4))


@pytest.fixture(scope="module")
def dynamic_lane():
    return _pair(dict(cond_kind="label", **LABEL_KW), 0, nearest=True,
                 dkw=DYN)


@functools.lru_cache(maxsize=None)
def _jax_dynamic(mode: str):
    lane = _pair(dict(cond_kind="label", **LABEL_KW), 0, nearest=True,
                 dkw=DYN)
    cfg_j = lane["cfg"][0]
    reqs = [jsched.Request(uid=lab, cond=jnp.asarray([lab]),
                           uncond=jnp.asarray([cfg_j.num_classes]),
                           seed=100 + i) for i, lab in enumerate(LABELS)]
    return jax_run(lane, ecfgs(mode, mode="dynamic")[0], reqs, 2)


@pytest.mark.parametrize("use_native", LOOPS)
@pytest.mark.parametrize("mode", ["greedy", "pinned"])
def test_batched_dynamic_matches_jax(dynamic_lane, mode, use_native):
    """EAGLE-2 under the batch (the port of ``tests/test_batching.py``'s
    dynamic case): 5 label requests on 2 slots, each slot drafting its own
    tree; tokens and steps equal the JAX engine's."""
    eng = port_engine(dynamic_lane, ecfgs(mode, mode="dynamic")[1], 2)
    done = Scheduler(eng, use_native=use_native).run(
        label_requests(dynamic_lane["cfg"][1]))
    assert [r.uid for r in done] == LABELS
    same_as(done, _jax_dynamic(mode))


def test_batched_dynamic_frozen_slots(dynamic_lane):
    """Dynamic mode on 3 slots with slot 1 empty: the empty slot stays at
    ``n_new = 1 << 30`` and length 0; a finished slot's state and cache
    length stay put through further steps; each stream and step count
    equals ``spec.generate`` alone (sampled, so each slot's generator is
    drawn in a lone run's order while its neighbours' trees differ)."""
    et = ecfgs("sampling", mode="dynamic")[1]
    cfg_t = dynamic_lane["cfg"][1]
    uncond = torch.tensor([cfg_t.num_classes])
    eng = port_engine(dynamic_lane, et, 3)
    pres = {s: eng.prefill(torch.tensor([lab]), uncond,
                           tspec.request_generator(70 + s, "cpu"))
            for s, lab in ((0, 2), (2, 8))}
    batch = eng.empty_batch(pres[0])
    for s, p in pres.items():
        batch = eng.insert(batch, s, p)
    while True:
        batch = eng.step(batch)
        n_new, steps, _ = eng.slot_status(batch)
        if n_new[0] >= MAX_NEW and n_new[2] >= MAX_NEW:
            break
    lens = batch.base_kv.length.clone()
    toks = [eng.slot_tokens(batch, s) for s in (0, 2)]
    batch = eng.step_many(batch, 3)
    n_new2, steps2, _ = eng.slot_status(batch)
    np.testing.assert_array_equal(n_new2, n_new)
    np.testing.assert_array_equal(steps2, steps)
    assert n_new[1] == EMPTY and steps[1] == 0
    assert torch.equal(batch.base_kv.length, lens)
    assert lens[2] == lens[3] == 0
    for s, lab, got in ((0, 2, toks[0]), (2, 8, toks[1])):
        np.testing.assert_array_equal(got, eng.slot_tokens(batch, s))
        alone = tspec.generate(
            dynamic_lane["p"][1], et, cfg_t, None, None,
            tspec.request_generator(70 + s, "cpu"), device="cpu",
            dparams=dynamic_lane["d"][1], dcfg=dynamic_lane["dcfg"][1],
            cond=torch.tensor([lab]), uncond=uncond)
        np.testing.assert_array_equal(got, alone.tokens.numpy())
        assert steps[s] == alone.steps


def test_verify_forward_per_slot_masks_equal_lone_forwards(dynamic_lane):
    """``verify_forward`` with a mask and depths per slot gives each slot
    the logits of its own single-request verify forward."""
    cfg_t = dynamic_lane["cfg"][1]
    et = ecfgs("greedy", mode="dynamic")[1]
    eng = port_engine(dynamic_lane, et, 2)
    uncond = torch.tensor([cfg_t.num_classes])
    first = eng.prefill(torch.tensor([0]), uncond)
    mask0 = tspec.dynamic_tree_block(eng.dcfg, first[0]).mask
    # the first label whose tree differs in shape from label 0's
    other = next(p for p in (eng.prefill(torch.tensor([lab]), uncond)
                             for lab in range(1, 10))
                 if not torch.equal(
                     tspec.dynamic_tree_block(eng.dcfg, p[0]).mask, mask0))
    pres = [first, other]
    blocks = [tspec.dynamic_tree_block(eng.dcfg, st) for st, _ in pres]
    batch = eng.empty_batch(pres[0])
    for i, p in enumerate(pres):
        batch = eng.insert(batch, i, p)
    kv = batch.base_kv
    _, got = tspec.verify_forward(
        et, cfg_t, eng.params, eng._rope, kv,
        torch.stack([b.tokens for b in blocks]),
        torch.stack([b.mask for b in blocks]),
        torch.stack([b.pos for b in blocks]), batch.prefix_valid,
        batch.pos_offsets, kv.length.clone())
    for r, ((st, ctx), b) in enumerate(zip(pres, blocks)):
        _, want = tspec.verify_forward(
            et, cfg_t, eng.params, eng._rope, st.base_kv, b.tokens[None],
            b.mask, b.pos, ctx.prefix_valid, ctx.pos_offsets,
            st.base_kv.length)
        torch.testing.assert_close(got[r], want[0], **F32)


# ---------------------------------------------- the per-row kernel forms

def _k2_case(seed, B, T, S, nh, hd, lengths):
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.normal(size=(B, T, nh, hd)).astype(np.float32)
                 for _ in range(3))
    kc, vc = (rng.normal(size=(B, S, nh, hd)).astype(np.float32)
              for _ in range(2))
    mask = (rng.random((B, T, T)) < 0.4) | np.eye(T, dtype=bool)[None]
    bias = np.zeros((B, S), np.float32)
    bias[1, :5] = tta.NEG_INF
    return q, kn, vn, kc, vc, np.asarray(lengths, np.int32), mask, bias


@pytest.mark.parametrize("hd", [pytest.param(128, id="pk1"),
                                pytest.param(64, id="pk2")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k2_plain_per_row_length_matches_pallas_interpret(hd, dtype):
    """``length [B]``: a row at 0, one at ``S - T``, the rest distinct; the
    Pallas kernel (interpret mode) takes the same ``[B]``."""
    B, T, S, nh = 4, 9, 256, 256 // hd
    lengths = [0, S - T, 37, 150]
    q, kn, vn, kc, vc, L, mask, bias = _k2_case(hd + len(dtype), B, T, S, nh,
                                                hd, lengths)
    scale = hd ** -0.5
    mdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    kcg, vcg = (jkv.group_cache(jnp.asarray(x, mdt)) for x in (kc, vc))
    kw_j, kw_t = {}, {}
    jk, jv = jnp.asarray(kn, mdt), jnp.asarray(vn, mdt)
    if dtype == "int8":
        (kcg, ks), (vcg, vs) = jkv.quantize_rows(kcg), jkv.quantize_rows(vcg)
        kw_j = dict(k_scale=ks, v_scale=vs)
        kw_t = dict(k_scale=tt(ks), v_scale=tt(vs))

        def fq(x):
            g = jkv.group_blocks(x)
            return jkv.ungroup_blocks(jkv.fake_quant_rows(g)).reshape(x.shape)
        jk, jv = fq(jk), fq(jv)
    ref = jta.tree_attention(jnp.asarray(q, mdt), jk, jv, kcg, vcg,
                             jnp.asarray(L), jnp.asarray(mask),
                             jnp.asarray(bias), scale, blk=128,
                             interpret=True, **kw_j)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = tta.tree_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, kn, vn)), tt(kcg),
        tt(vcg), torch.from_numpy(L), torch.from_numpy(mask),
        torch.from_numpy(bias), scale, **kw_t)
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(got), f32(ref), **tol)
    # each row equals the scalar-length call of its own row
    for b in (0, 2):
        one = tta.tree_attention_plain(
            *(torch.from_numpy(a[b:b + 1]).to(tdt) for a in (q, kn, vn)),
            tt(kcg)[b:b + 1], tt(vcg)[b:b + 1],
            torch.tensor(lengths[b], dtype=torch.int32),
            torch.from_numpy(mask[b:b + 1]), torch.from_numpy(bias[b:b + 1]),
            scale, **{k: v[b:b + 1] for k, v in kw_t.items()})
        assert torch.equal(one[0], got[b])


def test_build_mask_per_row_length_matches_jax():
    bm = np.tril(np.ones((4, 4), bool))
    pv = np.ones((3, 32), bool)
    pv[1, :3] = False
    lens = np.asarray([9, 0, 31], np.int32)
    mt = ttfm.build_mask(4, 32, torch.from_numpy(lens), torch.from_numpy(bm),
                         torch.from_numpy(pv), 3)
    for b in range(3):
        mj = jtfm.build_mask(4, 32, jnp.int32(lens[b]), jnp.asarray(bm),
                             jnp.asarray(pv[b:b + 1]), 1)
        np.testing.assert_array_equal(mt[0][b:b + 1].numpy(),
                                      np.asarray(mj[0]))
        np.testing.assert_array_equal(mt[1].numpy(), np.asarray(mj[1]))


def _slot_planes(rng, dtype, R, layers=2, G=2, S=192, W=128):
    """JAX's slot-major planes [R * layers, 2, G, S, W]."""
    shape = (R * layers, 2, G, S, W)
    if dtype == "int8":
        return [rng.integers(-127, 128, size=shape).astype(np.int8)
                for _ in range(2)]
    return [jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype)
            for _ in range(2)]


def to_rows(a, R):
    """[R * layers, 2, ...] (slot-major) -> [layers, 2R, ...]."""
    a = np.asarray(a)
    layers = a.shape[0] // R
    a = a.reshape((R, layers) + a.shape[1:]).swapaxes(0, 1)
    return a.reshape((layers, R * a.shape[2]) + a.shape[3:])


def raw(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("T", [1, 9, 33])
def test_k3_plain_per_row_start_matches_pallas_slots(dtype, T):
    """R = 3 slots: the JAX kernel writes planes ``[R * layers, 2, ...]`` at
    ``start [R]``; the port writes the same data as ``[layers, 2R, ...]`` at
    ``start [2R]`` (each slot's repeated), one start past ``S - T``
    (clamped as ``dynamic_update_slice`` clamps it).  Byte for byte; the
    int8 cache's scale planes against a per-slot ``dynamic_update_slice``."""
    R, S = 3, 192
    rng = np.random.default_rng(T * 7 + len(dtype))
    kb, vb = _slot_planes(rng, "int8" if dtype == "int8" else dtype, R)
    starts = np.asarray([0, 41, S - 2], np.int32)
    kn = rng.normal(size=(R * 2, 2, T, 2, 128)).astype(np.float32)
    vn = -kn * 0.5
    clamped = np.clip(starts, 0, S - T)
    if dtype == "int8":
        kq, kqs = jkv.quantize_rows(jkv.group_blocks(jnp.asarray(kn)))
        vq, vqs = jkv.quantize_rows(jkv.group_blocks(jnp.asarray(vn)))
        ks, vs = (rng.random((R * 2, 2, 2, S)).astype(np.float32)
                  for _ in range(2))
        z = jnp.int32(0)
        ksj, vsj = [], []
        for r in range(R):
            at = (z, z, z, jnp.int32(starts[r]))
            ksj.append(jax.lax.dynamic_update_slice(
                jnp.asarray(ks[2 * r:2 * r + 2]), kqs[2 * r:2 * r + 2], at))
            vsj.append(jax.lax.dynamic_update_slice(
                jnp.asarray(vs[2 * r:2 * r + 2]), vqs[2 * r:2 * r + 2], at))
        ksj, vsj = jnp.concatenate(ksj), jnp.concatenate(vsj)
    else:
        kq = jkv.group_blocks(jnp.asarray(kn, dtype))
        vq = jkv.group_blocks(jnp.asarray(vn, dtype))
    kj, vj = jkvu.write_block(jnp.asarray(kb), jnp.asarray(vb), kq, vq,
                              jnp.asarray(clamped), interpret=True)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.float32}[dtype]
    planes = [tt(to_rows(kb, R)), tt(to_rows(vb, R))]
    planes += ([tt(to_rows(ks, R)), tt(to_rows(vs, R))] if dtype == "int8"
               else [None, None])
    tkv.write_block(*planes, tt(to_rows(kn, R)).to(tdt),
                    tt(to_rows(vn, R)).to(tdt),
                    torch.from_numpy(starts).repeat_interleave(2))
    refs = [kj, vj] + ([ksj, vsj] if dtype == "int8" else [])
    for got, ref in zip(planes, refs):
        np.testing.assert_array_equal(raw(got), raw(tt(to_rows(ref, R))))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_k4_plain_per_row_start_matches_pallas_slots(dtype):
    """R = 4 slots with their own starts (one past ``S - blk``) and paths
    (pads outside the block): the port's ``[2R]`` form against the JAX
    kernel's ``[R]`` form handed the clamped indices, byte for byte."""
    R, S, blk = 4, 192, 16
    rng = np.random.default_rng(11 + len(dtype))
    kb, vb = _slot_planes(rng, dtype, R, S=S)
    starts = np.asarray([0, 170, 57, 99], np.int32)
    rels = np.asarray([[3, 0, 15, 2, 2], [0, 1, 2, 3, 4], [9, 20, -4, 1, 0],
                       [15, 14, 13, 12, 11]], np.int32)
    kj, vj = jkvu.gather_write_block(
        jnp.asarray(kb), jnp.asarray(vb),
        jnp.asarray(np.clip(rels, 0, blk - 1)),
        jnp.asarray(np.clip(starts, 0, S - blk)), blk, interpret=True)
    kt, vt = tt(to_rows(kb, R)), tt(to_rows(vb, R))
    tkv.gather_write_block(
        kt, vt, None, None, torch.from_numpy(rels).repeat_interleave(2, 0),
        torch.from_numpy(starts).repeat_interleave(2), blk)
    np.testing.assert_array_equal(raw(kt), raw(tt(to_rows(kj, R))))
    np.testing.assert_array_equal(raw(vt), raw(tt(to_rows(vj, R))))


@pytest.mark.parametrize("quantized", [False, True])
def test_kvcache_rows_match_per_request_caches(quantized):
    """A batched cache built by ``put_rows`` from two requests' caches, then
    a per-row write and rollback, equals each request's own cache put
    through the same steps (scales of an int8 cache included)."""
    cfg = tc.ModelConfig(vocab_size=64, hidden_size=256, num_layers=2,
                         num_heads=2, num_kv_heads=2, intermediate_size=256,
                         max_seq_len=150, dtype="float32")
    rng = np.random.default_rng(6)
    singles = []
    for length in (21, 97):
        c = tkv.KVCache.create(cfg, 2, quantized=quantized, device="cpu")
        pre = torch.from_numpy(rng.normal(size=(2, 2, length, 2, 128)).astype(
            np.float32))
        singles.append(c.write(pre, pre * 0.5))
    batch = tkv.KVCache.create(cfg, 6, quantized=quantized, device="cpu",
                               row_lengths=True)
    batch = batch.put_rows(0, singles[0]).put_rows(4, singles[1])
    assert batch.length.tolist() == [21, 21, 0, 0, 97, 97]
    kn = torch.from_numpy(rng.normal(size=(2, 6, 9, 2, 128)).astype(
        np.float32))
    rel = torch.tensor([[2, 0, 5], [2, 0, 5], [1, 1, 1], [1, 1, 1],
                        [8, 3, 0], [8, 3, 0]])
    n = torch.tensor([3, 3, 0, 0, 2, 2], dtype=torch.int32)
    batch = batch.write(kn, -kn, advance=False).accept_path(rel, n, 9)
    assert batch.length.tolist() == [24, 24, 0, 0, 99, 99]
    for i, (c, r0) in enumerate(zip(singles, (0, 4))):
        c = c.write(kn[:, r0:r0 + 2], -kn[:, r0:r0 + 2], advance=False)
        c = c.accept_path(rel[r0], n[r0], 9)
        for a, b in ((batch.k, c.k), (batch.v, c.v),
                     (batch.k_scale, c.k_scale), (batch.v_scale, c.v_scale)):
            if b is not None:
                assert torch.equal(a[:, r0:r0 + 2], b), i


# ------------------------------------------------- CUDA kernels (card only)

@pytest.mark.cuda
@pytest.mark.parametrize("hd,quant", [(128, False), (128, True), (64, False),
                                      (64, True)])
def test_k2_cuda_per_row_length_matches_plain(cuda, hd, quant):
    """K2 with a length per batch row (0, S - T and distinct ones), pk = 1
    and 2, against its plain version; every row taking row 0's length is a
    wrong variant the tolerance must separate."""
    g = torch.Generator(device=cuda).manual_seed(hd + quant)
    B, T, S, G, W = 6, 9, 1408, 4, 128
    nh = G * W // hd
    q, kn, vn = (torch.randn((B, T, nh, hd), generator=g, device=cuda)
                 .bfloat16() for _ in range(3))
    kc, vc = (torch.randn((B, G, S, W), generator=g, device=cuda).bfloat16()
              for _ in range(2))
    kw = {}
    if quant:
        (kc, ks), (vc, vs) = tkv.quantize_rows(kc), tkv.quantize_rows(vc)
        kw = dict(k_scale=ks, v_scale=vs)
    mask = (torch.rand((B, T, T), generator=g, device=cuda) < 0.4) | \
        torch.eye(T, dtype=torch.bool, device=cuda)
    bias = torch.zeros((B, S), device=cuda)
    bias[1, :5] = tta.NEG_INF
    lens = torch.tensor([0, S - T, 300, 1299, 64, 777], dtype=torch.int32,
                        device=cuda)
    args = (q, kn, vn, kc, vc, lens, mask, bias, hd ** -0.5)
    got = tta.tree_attention_cuda(*args, **kw)
    ref = tta.tree_attention_plain(*args, **kw)
    tol = 2e-2 * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol
    wrong = tta.tree_attention_plain(q, kn, vn, kc, vc, lens[0], mask, bias,
                                     hd ** -0.5, **kw)
    assert (wrong.float() - ref.float()).abs().max().item() > tol


def dynamic_tree_masks(g, R, T, device):
    """R random dynamic-tree ancestor-or-self masks of T nodes ([R, T, T]
    bool; node i's parent drawn from the nodes before it)."""
    out = []
    for _ in range(R):
        parent = [0] + [int(torch.randint(0, i, (1,), generator=g))
                        for i in range(1, T)]
        a = torch.eye(T, dtype=torch.bool)
        for i in range(1, T):
            a[i] |= a[parent[i]]
        out.append(a)
    return torch.stack(out).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_k2_cuda_per_row_masks_matches_plain(cuda, quant):
    """K2 at the batched dynamic verify's shape (4 slots, B = 8 rows, T =
    59, G = 10, S = 512, pk = 2): a different tree mask in each slot,
    repeated to its two rows, and a length per row, against its plain
    version; every row taking row 0's mask is a wrong variant the tolerance
    must separate."""
    g = torch.Generator().manual_seed(59 + quant)
    gc = torch.Generator(device=cuda).manual_seed(59 + quant)
    R, T, S, G, W, hd = 4, 59, 512, 10, 128, 64
    B, nh = 2 * R, G * W // hd
    q, kn, vn = (torch.randn((B, T, nh, hd), generator=gc, device=cuda)
                 .bfloat16() for _ in range(3))
    kc, vc = (torch.randn((B, G, S, W), generator=gc, device=cuda).bfloat16()
              for _ in range(2))
    kw = {}
    if quant:
        (kc, ks), (vc, vs) = tkv.quantize_rows(kc), tkv.quantize_rows(vc)
        kw = dict(k_scale=ks, v_scale=vs)
    mask = dynamic_tree_masks(g, R, T, cuda).repeat_interleave(2, dim=0)
    bias = torch.zeros((B, S), device=cuda)
    bias[1::2, :7] = tta.NEG_INF
    lens = torch.tensor([300, 300, 0, 0, 211, 211, S - T, S - T],
                        dtype=torch.int32, device=cuda)
    args = (q, kn, vn, kc, vc, lens, mask, bias, hd ** -0.5)
    got = tta.tree_attention_cuda(*args, **kw)
    ref = tta.tree_attention_plain(*args, **kw)
    tol = 2e-2 * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol
    wrong = tta.tree_attention_plain(q, kn, vn, kc, vc, lens,
                                     mask[:1].expand(B, T, T), bias,
                                     hd ** -0.5, **kw)
    assert (wrong.float() - ref.float()).abs().max().item() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_k2_cuda_pk1_rows_that_see_no_key(cuda, quant):
    """pk = 1 with a length per row and a ``prefix_bias`` that hides every
    prefix key from two rows, whose block mask hides every block key from
    their first rows: those rows see no key, and K2 gives them the plain
    version's mean of the whole plane's and the block's values."""
    g = torch.Generator(device=cuda).manual_seed(3 + quant)
    B, T, S, G, W = 4, 12, 512, 4, 128
    q, kn, vn = (torch.randn((B, T, G, W), generator=g, device=cuda)
                 .bfloat16() for _ in range(3))
    kc, vc = (torch.randn((B, G, S, W), generator=g, device=cuda).bfloat16()
              for _ in range(2))
    kw = {}
    if quant:
        (kc, ks), (vc, vs) = tkv.quantize_rows(kc), tkv.quantize_rows(vc)
        kw = dict(k_scale=ks, v_scale=vs)
    tril = torch.tril(torch.ones((T, T), dtype=torch.bool, device=cuda))
    mask = tril[None].expand(B, T, T).clone()
    bias = torch.zeros((B, S), device=cuda)
    dead = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for b in (0, 2):
        bias[b] = tta.NEG_INF             # every prefix key hidden
        mask[b, :5] = False               # and, for rows < 5, every block key
        mask[b, 5:, :5] = False
        dead[b, :5] = True
    lens = torch.tensor([40, 300, 0, 511], dtype=torch.int32, device=cuda)
    args = (q, kn, vn, kc, vc, lens, mask, bias, W ** -0.5)
    got = tta.tree_attention_cuda(*args, **kw)
    ref = tta.tree_attention_plain(*args, **kw)
    tol = 2e-2 * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol
    dtol = 2e-2 * ref[dead].float().abs().max().item()
    assert ref[dead].float().abs().max().item() > 0
    assert (got[dead].float() - ref[dead].float()).abs().max().item() <= dtol


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("T", [1, 9, 33])
def test_k3_cuda_per_row_start_matches_plain(cuda, quant, T):
    """K3 with a start per batch row (one clamped), byte for byte; two
    slots' starts swapped is a wrong variant the comparison catches."""
    g = torch.Generator(device=cuda).manual_seed(T + 10 * quant)
    L, B, G, S, W = 4, 8, 4, 512, 128
    kn, vn = (torch.randn((L, B, T, G, W), generator=g, device=cuda)
              .bfloat16() for _ in range(2))
    if quant:
        planes = [torch.randint(-127, 128, (L, B, G, S, W), generator=g,
                                device=cuda, dtype=torch.int8)
                  for _ in range(2)]
        planes += [torch.rand((L, B, G, S), generator=g, device=cuda)
                   for _ in range(2)]
    else:
        planes = [torch.randn((L, B, G, S, W), generator=g, device=cuda)
                  .bfloat16() for _ in range(2)] + [None, None]
    starts = torch.tensor([0, 130, S - 3, 77], dtype=torch.int32,
                          device=cuda).repeat_interleave(2)
    ref = [None if p is None else p.clone() for p in planes]
    bad = [None if p is None else p.clone() for p in planes]
    tkv.write_block_cuda(*planes, kn, vn, starts)
    tkv.write_block_plain(*ref, kn, vn, starts)
    swapped = starts.reshape(4, 2)[[1, 0, 2, 3]].reshape(-1)
    tkv.write_block_plain(*bad, kn, vn, swapped)
    for a, b in zip(planes, ref):
        if b is not None:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert not torch.equal(bad[0].view(torch.uint8), ref[0].view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_k4_cuda_per_row_start_matches_plain(cuda, dtype):
    """K4 with a start and a path per batch row (one start clamped, pads
    outside the block), byte for byte; swapped starts are caught."""
    g = torch.Generator(device=cuda).manual_seed(len(dtype))
    L, B, G, S, W, blk = 4, 8, 4, 512, 128, 16
    if dtype == "int8":
        planes = [torch.randint(-127, 128, (L, B, G, S, W), generator=g,
                                device=cuda, dtype=torch.int8)
                  for _ in range(2)]
        planes += [torch.rand((L, B, G, S), generator=g, device=cuda)
                   for _ in range(2)]
    else:
        planes = [torch.randn((L, B, G, S, W), generator=g, device=cuda)
                  .bfloat16() for _ in range(2)] + [None, None]
    starts = torch.tensor([0, 300, S - 5, 41], dtype=torch.int32,
                          device=cuda).repeat_interleave(2)
    rels = torch.tensor([[3, 0, 15, 2, 2], [0, 1, 2, 3, 4],
                         [9, 20, -4, 1, 0], [15, 14, 13, 12, 11]],
                        dtype=torch.int32, device=cuda).repeat_interleave(2, 0)
    ref = [None if p is None else p.clone() for p in planes]
    bad = [None if p is None else p.clone() for p in planes]
    tkv.gather_write_block_cuda(*planes, rels, starts, blk)
    tkv.gather_write_block_plain(*ref, rels, starts, blk)
    swapped = starts.reshape(4, 2)[[1, 0, 2, 3]].reshape(-1)
    tkv.gather_write_block_plain(*bad, rels, swapped, blk)
    for a, b in zip(planes, ref):
        if b is not None:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert not torch.equal(bad[0].view(torch.uint8), ref[0].view(torch.uint8))
