"""K1 (``csrc/int8_matmul.cu`` behind ``ops/quant``): the sum of the
window's weight-matmul calls' bounds over the sum of the device time of
K1's kernels (``int8_matmul_kernel``), in %."""

from h100_bench import roofline

KERNEL = "int8_matmul_kernel"


def read(run):
    if not run.tracer or not run.tracer.k1:
        return None
    dev = run.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    bound = sum(roofline.k1_bound_s(M, K, N, ob)
                for M, K, N, ob, _, _ in run.tracer.k1)
    return 100.0 * bound / dev
