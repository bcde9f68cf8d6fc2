"""1 - the union of the device's kernel and copy intervals over the traced
window (``torch.profiler``, CUDA activity only), in %."""


def read(run):
    if run.traced_s <= 0 or run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_s)
