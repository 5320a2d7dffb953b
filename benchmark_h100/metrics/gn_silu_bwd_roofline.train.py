"""The GroupNorm+SiLU backward kernels' share of their roofline in the
traced segment of a train cell, in %: the least time the card could take for
the backward of the GroupNorm+SiLU calls the model's shapes need in the
traced units (x and dy read once, dx written once: three passes over the
forward's GroupNorm+SiLU inputs, in the compute dtype) over the device time
of the kernels named ``gn_silu_bwd*``. None where no such kernel ran (a
program whose backward is plain PyTorch)."""

from benchmark_h100 import tracing
from benchmark_h100.count import peaks


def read(ctx):
    trace = ctx["trace"]
    if ctx["role"] != "train" or trace is None or not trace["units"]:
        return None
    seconds = tracing.kernel_s(trace, "gn_silu_bwd")
    elements = ctx["counts"]["forward"].gn_silu_elements
    if seconds <= 0 or not elements:
        return None
    bound = trace["units"] * 3 * elements * ctx["itemsize"] / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / seconds
