"""The 95th percentile of the denoise-step times of every step of the window,
from the CUDA events the harness's pre-hook records (numpy's linear
interpolation)."""

import numpy as np


def read(ctx):
    if ctx["role"] != "gen" or not ctx["window"]["step_ms"]:
        return None
    return float(np.percentile(np.asarray(ctx["window"]["step_ms"], np.float64), 95))
