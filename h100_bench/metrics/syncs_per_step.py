"""Synchronizing CUDA operations a step: the program's ``syncs`` counter
(torch's sync debug warnings while the traced window records) under the
spans the serving loop opens once a step (``step``, ``slot_status``,
``ar.token``, and all inside them) over its ``steps`` (speculative steps)
or, where it took none, its ``ar_tokens`` (lockstep AR tokens).  Syncs a
request or a chunk makes once (``prefill``, ``insert``, ``ar.prefill``),
whether or not they fall in the window, are left out."""

from h100_bench.program_spans import records, total

PER_STEP = {"step", "slot_status", "ar.token"}


def read(run):
    if getattr(run, "dtrace", None) is None:
        return None
    rec = records()
    if rec is None:
        return None
    steps = total(rec[1], "steps") or total(rec[1], "ar_tokens")
    if not steps:
        return None
    return total(rec[1], "syncs", PER_STEP) / steps
