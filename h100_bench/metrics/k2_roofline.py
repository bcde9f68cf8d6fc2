"""K2 (``csrc/tree_attention.cu`` behind ``ops/tree_attention``): the sum
of the window's attention calls' bounds (each row's KV planes read once at
its length, with scales; q, the block and the output) over the sum of the
device time of K2's kernels (``tree_attention_kernel``), in %."""

from h100_bench import roofline

KERNEL = "tree_attention_kernel"


def read(run):
    if not run.tracer or not run.tracer.fwd:
        return None
    dev = run.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    bound = sum(roofline.forward_k2(f)[0] for f in run.tracer.fwd)
    return 100.0 * bound / dev
