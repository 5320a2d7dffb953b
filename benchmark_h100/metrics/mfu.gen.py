"""The model's counted operations over the window's seconds, as a share of
989 TFLOP/s (bf16 dense, H100 SXM at 700 W), in % (gen cells; a train
step counts three forwards and nothing recomputed)."""

from benchmark_h100.shares import mfu


def read(ctx):
    return mfu(ctx, "gen")
