"""Batch × steps over the window of a training cell; the window ends with a
synchronisation after the last step."""


def read(ctx):
    if ctx["role"] != "train":
        return None
    w = ctx["window"]
    return w["samples"] / w["seconds"]
