"""Milliseconds of the current stream that a data-parallel train step's
gradient all-reduce takes on rank 0 (the program's span ``train.allreduce``:
the SUM all-reduces of the flat gradient buffers over the data axis and the
division, waiting for the slowest rank included), summed over the traced
segment of a train cell and divided by its steps."""

from benchmark_h100.declared_spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "train", "mrijax_torch.train.steps", "train.allreduce")
