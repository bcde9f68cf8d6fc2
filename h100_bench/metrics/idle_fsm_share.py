"""The share of the traced window in which the device idles while the
program's ``grid_fsm`` span (the image grammar's constraints on a slot's
logits, in ``step.accept`` and in the stale re-draft) is open, in %: the
device trace's idle gaps labelled by the port's own spans.  None where the
program records no such span."""

from h100_bench.program_spans import idle_share, records


def read(run):
    rec = records()
    if rec is None or not any(s.name == "grid_fsm" for s in rec[0]):
        return None
    return idle_share(run, {"grid_fsm"})
