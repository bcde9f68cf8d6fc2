"""Seconds from the process's start to the window's opening: imports,
weights, the kernels' build or load, prefills and warm-up."""


def read(run):
    return run.setup_s
