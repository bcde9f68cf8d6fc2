"""The share of the traced window in which the device idles while the
program's ``sample`` span (the lockstep AR draw of every row) is open, in
%: the device trace's idle gaps labelled by the port's own spans."""

from h100_bench.program_spans import idle_share


def read(run):
    return idle_share(run, {"sample"})
