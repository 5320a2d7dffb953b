"""Milliseconds of the current stream a train step's update takes (the
program's span ``train.update``: the nan guard where the configuration has
one, Adam, EMA), summed over the traced segment of a train cell and divided
by its steps."""

from benchmark_h100.program_spans import stream_ms_per_unit


def read(ctx):
    return stream_ms_per_unit(ctx, "train", "train.update")
