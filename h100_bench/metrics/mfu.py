"""The model step's share of the H100's bf16 peak: the operations of every
forward's weight matmuls, attention and logits head in the traced window,
at the shapes they ran (tree rows and CFG rows count; rows of finished
slots and prompt pads do not), over the window and 989 TFLOP/s."""

from h100_bench import roofline


def read(run):
    if run.dtrace is None or not run.tracer.k1 or run.traced_s <= 0:
        return None
    flops = roofline.step_flops(run.tracer.k1, run.tracer.fwd)
    return 100.0 * flops / (run.traced_s * roofline.BF16_FLOPS_PER_S)
