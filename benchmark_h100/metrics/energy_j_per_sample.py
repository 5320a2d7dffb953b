"""Joules of the card's NVML energy counter over the window, over the
window's samples. Nothing where the counter cannot be read."""


def read(ctx):
    w = ctx["window"]
    if w["energy_j"] is None or not w["samples"]:
        return None
    return w["energy_j"] / w["samples"]
