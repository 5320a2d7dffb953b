"""Seconds from the process's start to the window's: imports, the kernels'
build where the checkout has none, weights, pools and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
