"""The flash-attention kernels' share of their roofline in the traced segment
of a gen cell, in %: 4·B·H·N·N·Dh operations a block forward (and 2.5
times that backward, in training) at 989 TFLOP/s, or the bytes bound where
it is larger, over the device time of the kernels named ``flash_fwd*`` and
``flash_bwd*``."""

from benchmark_h100.shares import flash_roofline


def read(ctx):
    return flash_roofline(ctx, "gen")
