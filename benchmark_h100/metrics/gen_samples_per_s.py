"""Finished samples over the whole window of a generation cell (a decoded
volume in 3D, a slice in 2D); the window holds whole calls."""


def read(ctx):
    if ctx["role"] != "gen":
        return None
    w = ctx["window"]
    return w["samples"] / w["seconds"]
