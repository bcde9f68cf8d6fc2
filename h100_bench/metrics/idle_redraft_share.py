"""The share of the traced window in which the device idles while one of
the program's ``step.advance``, ``step.draft`` or ``step.freeze`` spans (a
slot's commit into its state, its next draft, its freeze) is open, in %:
the device trace's idle gaps labelled by the port's own spans."""

from h100_bench.program_spans import idle_share


def read(run):
    return idle_share(run, {"step.advance", "step.draft", "step.freeze"})
