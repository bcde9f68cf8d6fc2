"""Accepted tokens per slot-step over the window: the sum of accepted
tokens (roots included) over the sum of verify steps of the slots, from the
program's own counters (``slot_status``, ``Request.accept_sum`` /
``steps``)."""


def read(run):
    c = run.counters
    if not c.get("slot_steps"):
        return None
    return c["accept_sum"] / c["slot_steps"]
