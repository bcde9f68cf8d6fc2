"""The port's own spans and counters (``lantern_tpu_torch.utils.profiling``),
as a traced run's per-layer metrics read them.

The program records while the device trace's ``torch.profiler`` session is
on, on the host clock (``time.perf_counter``) onto which the trace maps the
device's kernels, so its spans label the device's idle gaps with no
conversion.  Each reader returns None where there is nothing to read: no
device trace, or a program that keeps no spans.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set


def records():
    """``(spans, counters)`` of the program, or None where it keeps none."""
    from lantern_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    return profiling.spans(), profiling.counters()


def clipped(spans, t0: float, t1: float) -> List[tuple]:
    """``(name, start, end)`` of the spans, cut to ``[t0, t1]``; a span
    still open counts as open to ``t1``; spans outside are left out."""
    out = []
    for s in spans:
        a, b = max(s.t0, t0), min(t1 if s.t1 is None else s.t1, t1)
        if b > a:
            out.append((s.name, a, b))
    return out


def idle_gaps(union, t0: float, t1: float) -> List[tuple]:
    """The stretches of ``[t0, t1]`` outside the device's busy union."""
    gaps, prev = [], t0
    for a, b in list(union) + [[t1, t1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return gaps


def program_idle(run) -> Optional[Dict[str, float]]:
    """Idle seconds of the traced window by the chain of program spans open
    at each gap's midpoint (``harness.label_gaps``; "host" where none is),
    or None; worked out once a run."""
    if getattr(run, "dtrace", None) is None or getattr(
            run, "union", None) is None:
        return None
    if not hasattr(run, "_program_idle"):
        from h100_bench.harness import label_gaps

        rec, d = records(), run.dtrace
        spans = None if rec is None else clipped(rec[0], d.t0, d.t1)
        run._program_idle = (label_gaps(spans, idle_gaps(run.union, d.t0,
                                                         d.t1))
                             if spans else None)
    return run._program_idle


def idle_share(run, names: Set[str]) -> Optional[float]:
    """% of the traced window the device idles while a program span named
    in ``names`` is open."""
    idle = program_idle(run)
    if idle is None:
        return None
    d = run.dtrace
    s = sum(v for chain, v in idle.items() if names & set(chain.split(">")))
    return 100.0 * s / (d.t1 - d.t0)


def total(counters, name: str, under: Optional[Set[str]] = None) -> int:
    """A counter summed over the spans it was counted under, or over those
    whose chain of open spans ("outer>...>innermost") holds one named in
    ``under``."""
    return sum(v for (k, chain), v in counters.items() if k == name and (
        under is None or (chain is not None
                          and under & set(chain.split(">")))))
