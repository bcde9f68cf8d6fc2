"""``torch.cuda.max_memory_allocated()`` at the window's end, after
``reset_peak_memory_stats()`` at its start, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
