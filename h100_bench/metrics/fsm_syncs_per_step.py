"""Synchronizing CUDA operations of the grid FSM a step: the program's
``syncs`` counter under a ``grid_fsm`` span inside a ``step`` (the FSM's
blocking writes of its forced rows, a slot's acceptance and its re-draft)
over the program's ``steps``.  None where the program records no
``grid_fsm`` span or takes no step."""

from h100_bench.program_spans import records


def read(run):
    if getattr(run, "dtrace", None) is None:
        return None
    rec = records()
    if rec is None or not any(s.name == "grid_fsm" for s in rec[0]):
        return None
    counters = rec[1]
    steps = sum(v for (k, _), v in counters.items() if k == "steps")
    if not steps:
        return None
    syncs = sum(v for (k, chain), v in counters.items() if k == "syncs"
                and chain is not None
                and {"step", "grid_fsm"} <= set(chain.split(">")))
    return syncs / steps
