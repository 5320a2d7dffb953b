"""The share of the traced segment of a gen cell in which no operation
ran on the card, in %: 1 − busy_s / window_s."""

from benchmark_h100.shares import idle_share


def read(ctx):
    return idle_share(ctx, "gen")
