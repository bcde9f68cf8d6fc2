"""The five readers of the port's own spans and counters
(``program_spans.py``, ``metrics/idle_*_share.py``,
``metrics/syncs_per_step.py``) on synthetic spans, gaps and counters: the
idle shares split the device's idle time by phase, spans outside the
traced window are cut away, and every reader returns None without a
device trace or where the program keeps no spans."""

import time
from types import SimpleNamespace

import pytest

from h100_bench import harness, program_spans
from lantern_tpu_torch.utils import profiling
from lantern_tpu_torch.utils.profiling import Span

IDLE = ("idle_forward_share", "idle_accept_share", "idle_redraft_share",
        "idle_sample_share")
ALL = IDLE + ("syncs_per_step",)


def span(name, t0, t1, parent=-1, **attrs):
    return Span(name, t0, t1, parent, attrs)


# the window [10, 20]: the device busy 2.5 s, idle in (11, 12), (12.5, 15)
# and (16, 20)
UNION = [[10.0, 11.0], [12.0, 12.5], [15.0, 16.0]]
SPANS = [
    span("forward", 5.0, 6.0),                 # before the window
    span("step", 9.0, 19.5),                   # begins before it
    span("step.verify", 10.2, 11.8, 1),
    span("forward", 10.3, 11.7, 2),            # holds (11, 12)'s midpoint
    span("head", 11.7, 11.8, 2),
    span("step.accept", 11.9, 14.0, 1, slot=0),   # holds 13.75
    span("step.advance", 14.0, 16.5, 1, slot=0),
    span("step.draft", 16.6, 19.0, 1, slot=0),    # holds 18
    span("slot_status", 19.5, 19.6),
    span("sample", 21.0, 22.0),                # after it
]
# syncs a step under `step` and `slot_status`; a request's prefill's and
# the glue's under no span are not a step's
COUNTERS = {("syncs", "step>step.accept"): 1, ("syncs", "slot_status"): 3,
            ("syncs", "prefill"): 5, ("syncs", None): 1,
            ("steps", "step"): 2}


def run_of(union=UNION, dtrace=True):
    d = SimpleNamespace(t0=10.0, t1=20.0) if dtrace else None
    return SimpleNamespace(dtrace=d, union=union if dtrace else None,
                           traced_s=10.0)


@pytest.fixture
def program(monkeypatch):
    box = {"rec": (SPANS, COUNTERS)}
    monkeypatch.setattr(program_spans, "records", lambda: box["rec"])
    return box


def read(name, run):
    return harness.reader(name)(run)


def test_idle_shares_split_the_idle_time(program):
    run = run_of()
    got = {m: read(m, run) for m in IDLE}
    assert got == pytest.approx({"idle_forward_share": 10.0,
                                 "idle_accept_share": 25.0,
                                 "idle_redraft_share": 40.0,
                                 "idle_sample_share": 0.0})
    idle = 100.0 * (1 - sum(b - a for a, b in UNION) / 10.0)
    assert idle == pytest.approx(75.0)
    assert sum(got.values()) <= idle + 1e-9
    # the idle time by chain, worked out once a run
    assert run._program_idle == pytest.approx(
        {"step>step.verify>forward": 1.0, "step>step.accept": 2.5,
         "step>step.draft": 4.0})


def test_spans_outside_the_window_clipped():
    got = program_spans.clipped(SPANS, 10.0, 20.0)
    assert [n for n, _, _ in got] == [s.name for s in SPANS[1:-1]]
    assert got[0] == ("step", 10.0, 19.5)
    assert all(10.0 <= a < b <= 20.0 for _, a, b in got)
    # an open span counts to the window's end
    assert program_spans.clipped([span("x", 12.0, None)], 10.0, 20.0) == [
        ("x", 12.0, 20.0)]


def test_idle_gaps():
    assert program_spans.idle_gaps(UNION, 10.0, 20.0) == [
        (11.0, 12.0), (12.5, 15.0), (16.0, 20.0)]
    assert program_spans.idle_gaps([], 10.0, 20.0) == [(10.0, 20.0)]


def test_sample_share_in_lockstep_ar(program):
    program["rec"] = ([span("ar.token", 10.0, 12.0),
                       span("forward", 10.0, 11.2, 0),
                       span("head", 11.2, 11.3, 0),
                       span("sample", 11.3, 12.0, 0)],
                      {("ar_tokens", "ar.token"): 50,
                       ("syncs", "ar.token>sample"): 1,
                       ("syncs", "ar.prefill>head"): 7,
                       ("syncs", None): 35})
    run = run_of(union=[[10.0, 11.0], [12.0, 20.0]])
    assert read("idle_sample_share", run) == pytest.approx(10.0)
    assert read("idle_forward_share", run) == pytest.approx(0.0)
    assert read("syncs_per_step", run) == pytest.approx(0.02)


def test_syncs_per_step(program):
    assert read("syncs_per_step", run_of()) == pytest.approx(2.0)
    assert program_spans.total(COUNTERS, "syncs") == 10
    program["rec"] = (SPANS, {("syncs", "slot_status"): 3})
    assert read("syncs_per_step", run_of()) is None


@pytest.mark.parametrize("metric", ALL)
def test_none_without_a_device_trace(program, metric):
    assert read(metric, run_of(dtrace=False)) is None


@pytest.mark.parametrize("metric", ALL)
def test_none_where_the_program_keeps_no_spans(program, metric):
    program["rec"] = None                       # a program before the spans
    assert read(metric, run_of()) is None
    program["rec"] = ([], {})                   # nothing recorded
    assert read(metric, run_of()) is None


def test_the_program_recorder_on_the_shared_clock():
    """The real recorder's spans land where a device trace's window on
    ``time.perf_counter`` puts them."""
    profiling.clear()
    t0 = time.perf_counter()
    with profiling.recording():
        with profiling.span("forward"):
            time.sleep(0.05)
        time.sleep(0.05)
    t1 = time.perf_counter()
    (f,) = profiling.spans()
    assert t0 < f.t0 < f.t1 < t1
    # the device busy for a moment at the span's end: the gap before it
    # is the forward's, the one after it the host's
    run = SimpleNamespace(dtrace=SimpleNamespace(t0=t0, t1=t1),
                          union=[[f.t1, f.t1 + 1e-4]], traced_s=t1 - t0)
    share = read("idle_forward_share", run)
    profiling.clear()
    assert share == pytest.approx(100.0 * (f.t1 - t0) / (t1 - t0))
