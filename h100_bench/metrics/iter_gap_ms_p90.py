"""The 90th percentile of the host time between consecutive
``BatchedEngine.slot_status`` returns in the traced window, in ms: one
serving-loop iteration (a step, its readback, any refill's prefill)."""

import statistics


def read(run):
    t = run.tracer.status_times if run.tracer else []
    gaps = [1e3 * (b - a) for a, b in zip(t, t[1:])]
    if len(gaps) < 2:
        return None
    return statistics.quantiles(gaps, n=10)[8]
