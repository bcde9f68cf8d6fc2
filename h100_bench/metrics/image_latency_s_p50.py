"""Median over every request completed in the window of the seconds from
its admission (prefill start) to its last token (``Request.latency``)."""

import statistics


def read(run):
    return statistics.median(run.latencies) if run.latencies else None
