"""The GroupNorm+SiLU kernels' share of their roofline in the traced segment
of a train cell, in %: the least time the card could take for the
GroupNorm+SiLU work the model's shapes need in the traced units (each input
byte read once, each output byte written once; forward work only) over the
device time of the kernels named ``gn_silu_stats*`` and ``gn_silu_apply*``."""

from benchmark_h100.shares import gn_silu_roofline


def read(ctx):
    return gn_silu_roofline(ctx, "train")
