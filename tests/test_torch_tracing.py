"""The port's spans and counters (``lantern_tpu_torch.utils.profiling``).

The recorder alone: nesting, parents and attributes on the host clock,
nothing recorded (and the warnings state and sync debug mode untouched)
outside a profiler or ``recording()``, a ``torch.profiler`` session turning
it on with the spans in ``trace()``'s Chrome trace, the buffer's bound and
``spans_dropped``, the sync counter filing torch's sync warning under the
open spans, and the sync debug mode set only while the outermost recorded
span is open and never over a mode set since.  Then the engines' spans on
tiny configs: ``BatchedEngine``'s step phases in order, the
single-request step's, ``Scheduler``'s on both slot tables, and the AR
loops' ``ar.prefill`` / ``ar.token`` with ``forward``, ``head`` and
``sample`` inside, lockstep and lone; the same seed gives the same tokens
with recording on and off.  CPU only: no JAX.
"""

import json
import time
import warnings

import numpy as np
import pytest
import torch

from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.engine import ar as tar
from lantern_tpu_torch.engine import spec as tspec
from lantern_tpu_torch.engine.batch import BatchedEngine
from lantern_tpu_torch.engine.scheduler import Request, Scheduler
from lantern_tpu_torch.models.chameleon import TokenPrompt
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.ops.sampling import LogitsWarp
from lantern_tpu_torch.utils import profiling as prof

LABEL_KW = dict(cond_kind="label", vocab_size=256, hidden_size=256,
                num_layers=2, num_heads=4, block_size=16, max_seq_len=96)
TOKEN_KW = dict(cond_kind="none", rope_kind="1d", vocab_size=512,
                hidden_size=256, num_layers=2, num_heads=2, max_seq_len=64)
WARP = LogitsWarp(temperature=1.0, top_k=20)
STEP_PHASES = ["step.block", "step.verify", "step.accept", "step.accept",
               "step.commit", "step.advance", "step.draft", "step.freeze",
               "step.advance", "step.draft", "step.freeze"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh():
    prof.clear()
    yield
    prof.clear()


def lane(kw, seed):
    cfg = tc.tiny_config(**kw)
    params = ttfm.fuse_params(ttfm.init_params(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    return cfg, params


@pytest.fixture(scope="module")
def label():
    return lane(LABEL_KW, 0)


@pytest.fixture(scope="module")
def token():
    return lane(TOKEN_KW, 1)


def children(sp, i):
    return [k for k, s in enumerate(sp) if s.parent == i]


def names(sp, idx):
    return [sp[k].name for k in idx]


def warnings_state():
    return list(warnings.filters), warnings.showwarning


# ------------------------------------------------------------ the recorder

def test_spans_nest_with_parents_and_attrs():
    t_before = time.perf_counter()
    with prof.recording():
        with prof.span("a", uid=7):
            with prof.span("b", slot=1):
                prof.count("n", 2)
            prof.count("n")
        with prof.span("c"):
            pass
        prof.count("n")
    t_after = time.perf_counter()
    sp = prof.spans()
    assert [s.name for s in sp] == ["a", "b", "c"]
    assert [s.parent for s in sp] == [-1, 0, -1]
    assert sp[0].attrs == {"uid": 7} and sp[1].attrs == {"slot": 1}
    assert sp[2].attrs == {}
    assert t_before <= sp[0].t0 <= sp[1].t0 <= sp[1].t1 <= sp[0].t1
    assert sp[0].t1 <= sp[2].t0 <= sp[2].t1 <= t_after
    assert prof.counters() == {("n", "a>b"): 2, ("n", "a"): 1, ("n", None): 1}
    prof.clear()
    assert prof.spans() == [] and prof.counters() == {}


def test_nothing_recorded_without_profiler_or_recording():
    before = warnings_state()
    assert prof.span("x") is prof.span("y")          # the shared no-op
    with prof.span("x", slot=0):
        prof.count("n")
    assert prof.spans() == [] and prof.counters() == {}
    assert warnings_state() == before


def test_recording_restores_warnings_state():
    before = warnings_state()
    with prof.recording():
        with prof.span("x"):
            assert warnings.showwarning is not before[1]
    assert warnings_state() == before
    # torch's sync warnings are not taken once recording is off
    with pytest.warns(UserWarning, match=prof.SYNC_WARNING):
        warnings.warn(prof.SYNC_WARNING)
    assert prof.counters() == {}


def fake_sync_mode(monkeypatch, start):
    """A CUDA build's sync debug mode, as a list the test reads and sets."""
    mode = [start]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, m))
    return mode


def test_sync_debug_mode_warns_while_recording_then_restored(monkeypatch):
    """On a CUDA build: the mode is "warn" while the outermost recorded
    span is open, then what it was; untouched when nothing records."""
    mode = fake_sync_mode(monkeypatch, 0)
    with prof.span("off"):
        assert mode == [0]
    with prof.recording():
        assert mode == [0]
        with prof.span("on"):
            assert mode == ["warn"]
            with prof.span("inner"):
                assert mode == ["warn"]
            assert mode == ["warn"]
        assert mode == [0]
    assert mode == [0]


def test_sync_debug_mode_set_since_is_kept(monkeypatch):
    """A profiler session with a span leaves nothing behind: a stricter
    mode set after it holds through spans while off; "error" is never
    lowered to "warn"; a mode set inside a span is not overwritten when
    it closes."""
    mode = fake_sync_mode(monkeypatch, 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with prof.span("step"):
            assert mode == ["warn"]
    assert mode == [0]
    mode[0] = 2
    with prof.span("step"):
        assert mode == [2]
    with prof.recording():
        with prof.span("step"):
            assert mode == [2]
        assert mode == [2]
        mode[0] = 0
        with prof.span("step"):
            mode[0] = 2
        assert mode == [2]
    assert [s.name for s in prof.spans()] == ["step"] * 3


def test_sync_warning_counted_under_innermost_span():
    with prof.recording():
        with prof.span("outer"):
            warnings.warn(prof.SYNC_WARNING + " (synthetic)")
            with prof.span("inner"):
                for _ in range(3):
                    warnings.warn(prof.SYNC_WARNING)
            # other warnings pass through to the hook that was there
            with pytest.warns(UserWarning, match="something else"):
                warnings.warn("something else")
    assert prof.counters() == {("syncs", "outer"): 1,
                               ("syncs", "outer>inner"): 3}


def test_span_buffer_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 3)
    with prof.recording():
        with prof.span("top"):
            for i in range(4):
                with prof.span("leaf", slot=i):
                    pass
    sp = prof.spans()
    assert [s.name for s in sp] == ["top", "leaf", "leaf"]
    assert all(s.t1 is not None for s in sp)
    assert prof.counters() == {("spans_dropped", "top"): 2}


def test_profiler_turns_recording_on_and_trace_shows_spans(tmp_path, label):
    cfg, params = label
    with prof.trace(str(tmp_path / "tr")):
        assert torch.autograd._profiler_enabled()
        tar.generate_many(params, cfg, torch.tensor([3, 5]),
                          torch.tensor([cfg.num_classes]), 2, 2.0, WARP,
                          [tspec.request_generator(s, "cpu") for s in (1, 2)],
                          device="cpu")
    got = [s.name for s in prof.spans()]
    assert got.count("ar.token") == 2 and got.count("forward") == 3
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    shown = {e.get("name") for e in events}
    assert {"ar.prefill", "ar.token", "forward", "head", "sample"} <= shown
    # the session over, spans record nothing
    n = len(prof.spans())
    with prof.span("after"):
        pass
    assert len(prof.spans()) == n


# ------------------------------------------------------------ the engines

def batched_run(label):
    """Two label requests on two slots, stale static drafting, sampled:
    the slots' tokens and status after two steps."""
    cfg, params = label
    ecfg = tspec.SpecDecodeConfig(warp=WARP, cfg_scale=2.0, max_new=12,
                                  stale_draft=True)
    eng = BatchedEngine(ecfg=ecfg, cfg=cfg, tree=ttr.get_tree("chain_bush_8"),
                        params=params, num_slots=2, device="cpu")
    uncond = torch.tensor([cfg.num_classes])
    pres = [eng.prefill(torch.tensor([lab]), uncond,
                        tspec.request_generator(seed, "cpu"))
            for lab, seed in ((2, 11), (6, 12))]
    batch = eng.empty_batch(pres[0])
    for s, pre in enumerate(pres):
        batch = eng.insert(batch, s, pre)
    for _ in range(2):
        batch = eng.step(batch)
    status = eng.slot_status(batch)
    return [eng.slot_tokens(batch, s) for s in range(2)], status


def test_batched_step_phases_in_order(label):
    """Each step holds its phases in order, the per-slot ones once a slot;
    the tokens and status equal a run with recording off."""
    off = batched_run(label)
    assert prof.spans() == []
    with prof.recording():
        on = batched_run(label)
    for a, b in zip(off[0] + list(off[1]), on[0] + list(on[1])):
        np.testing.assert_array_equal(a, b)
    sp = prof.spans()
    top = [s.name for s in sp if s.parent == -1]
    assert top == ["prefill", "prefill", "insert", "insert", "step", "step",
                   "slot_status", "slot_tokens", "slot_tokens"]
    assert [s.attrs for s in sp if s.name == "insert"] == [{"slot": 0},
                                                            {"slot": 1}]
    steps = [i for i, s in enumerate(sp) if s.name == "step"]
    for st in steps:
        kids = children(sp, st)
        assert names(sp, kids) == STEP_PHASES
        slots = [sp[k].attrs.get("slot") for k in kids]
        assert slots == [None, None, 0, 1, None, 0, 0, 0, 1, 1, 1]
        (verify,) = [k for k in kids if sp[k].name == "step.verify"]
        assert names(sp, children(sp, verify)) == ["forward", "head"]
        assert all(sp[a].t1 <= sp[b].t0 for a, b in zip(kids, kids[1:]))
    assert prof.counters()[("steps", "step")] == 2


def test_single_request_step_phases(label):
    cfg, params = label
    ecfg = tspec.SpecDecodeConfig(warp=WARP, cfg_scale=2.0, max_new=6,
                                  stale_draft=True)
    kw = dict(cond=torch.tensor([4]), uncond=torch.tensor([cfg.num_classes]),
              device="cpu", max_steps=2)
    tree = ttr.get_tree("chain_bush_8")
    off = tspec.generate(params, ecfg, cfg, tree, None,
                         tspec.request_generator(5, "cpu"), **kw)
    with prof.recording():
        on = tspec.generate(params, ecfg, cfg, tree, None,
                            tspec.request_generator(5, "cpu"), **kw)
    np.testing.assert_array_equal(off.tokens, on.tokens)
    sp = prof.spans()
    steps = [i for i, s in enumerate(sp) if s.name == "step"]
    assert len(steps) == on.steps == 2
    for i in steps:
        assert names(sp, children(sp, i)) == [
            "step.block", "step.verify", "step.accept", "step.commit",
            "step.advance", "step.draft"]
    assert prof.counters()[("steps", "step")] == 2


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_scheduler_iterations_and_admissions(label, use_native):
    cfg, params = label
    ecfg = tspec.SpecDecodeConfig(warp=WARP, cfg_scale=2.0, max_new=4,
                                  stale_draft=True)
    eng = BatchedEngine(ecfg=ecfg, cfg=cfg, tree=ttr.get_tree("chain_bush_8"),
                        params=params, num_slots=2, device="cpu")
    uncond = torch.tensor([cfg.num_classes])
    reqs = [Request(uid=lab, cond=torch.tensor([lab]), uncond=uncond,
                    seed=20 + lab) for lab in (1, 4, 7)]
    with prof.recording():
        done = Scheduler(eng, use_native=use_native).run(reqs)
    assert all(r.error is None for r in done)
    sp = prof.spans()
    top = [s for s in sp if s.parent == -1]
    assert {s.name for s in top} == {"prefill", "insert", "step",
                                     "slot_status", "slot_tokens"}
    inserts = [s.attrs["slot"] for s in top if s.name == "insert"]
    assert len(inserts) == 3 and inserts[:2] == [0, 1]
    n_steps = sum(s.name == "step" for s in top)
    assert n_steps == sum(s.name == "slot_status" for s in top)
    assert prof.counters()[("steps", "step")] == n_steps > 0


def ar_check(sp, max_new):
    pre = [i for i, s in enumerate(sp) if s.name == "ar.prefill"]
    tok = [i for i, s in enumerate(sp) if s.name == "ar.token"]
    assert len(pre) == 1 and len(tok) == max_new
    for i in pre + tok:
        assert sp[i].parent == -1
        assert sorted(names(sp, children(sp, i))) == ["forward", "head",
                                                      "sample"]
    assert prof.counters()[("ar_tokens", "ar.token")] == max_new


@pytest.mark.parametrize("lone", [False, True], ids=["lockstep", "lone"])
def test_generate_many_spans_and_tokens(label, lone):
    """The lockstep loop over 3 requests, or ``generate`` (the same loop at
    R = 1): the same spans and counters, the same tokens recorded or not."""
    cfg, params = label
    labels, seeds = ([3], [1]) if lone else ([3, 5, 8], [1, 2, 3])

    def run():
        gens = [tspec.request_generator(s, "cpu") for s in seeds]
        args = (params, cfg, torch.tensor(labels),
                torch.tensor([cfg.num_classes]), 5, 2.0, WARP)
        if lone:
            return tar.generate(*args, gens[0], device="cpu").tokens[None]
        return tar.generate_many(*args, gens, device="cpu")

    off = run()
    with prof.recording():
        on = run()
    np.testing.assert_array_equal(off.numpy(), on.numpy())
    ar_check(prof.spans(), 5)


@pytest.mark.parametrize("lone", [False, True], ids=["lockstep", "lone"])
def test_generate_tokens_many_spans_and_tokens(token, lone):
    """The token-prompt loop over 2 requests, or ``generate_tokens`` at
    R = 1 with ``stop_ids`` that never hit: the same spans and counters."""
    cfg, params = token
    R, L = (1, 5) if lone else (2, 5)
    g = torch.Generator().manual_seed(3)
    tp = TokenPrompt(
        tokens=torch.randint(0, cfg.vocab_size, (R, 2, L), generator=g,
                             dtype=torch.int32),
        positions=torch.arange(L, dtype=torch.int32).expand(R, 2, L),
        valid=torch.ones((R, 2, L), dtype=torch.bool),
        pos_diff=torch.zeros((R,), dtype=torch.int32))

    def run():
        gens = [tspec.request_generator(s, "cpu") for s in (7, 8)[:R]]
        if lone:
            res = tar.generate_tokens(
                params, cfg, TokenPrompt(tp.tokens[0], tp.positions[0],
                                         tp.valid[0], tp.pos_diff[0]),
                4, 2.0, WARP, gens[0], stop_ids=(cfg.vocab_size,),
                device="cpu")
            return res.tokens[None], torch.tensor([res.n_valid])
        return tar.generate_tokens_many(params, cfg, tp, 4, 2.0, WARP, gens,
                                        device="cpu")

    off = run()
    with prof.recording():
        on = run()
    np.testing.assert_array_equal(off[0].numpy(), on[0].numpy())
    np.testing.assert_array_equal(off[1].numpy(), on[1].numpy())
    assert on[1].tolist() == [4] * R
    ar_check(prof.spans(), 4)
