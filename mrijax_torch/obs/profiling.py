"""Profiler integration: ``torch.profiler`` traces + named step annotations.

Counterpart of ``mrijax/obs/profiling.py``. The reference's tracing story is
Perun sampling + nvidia-smi side-logs (SURVEY.md §5); here it is PyTorch's
profiler, which records host spans and, through CUPTI, every kernel the card
ran. ``trace`` writes one Chrome trace (``<log_dir>/trace_<time>.json``,
viewable in Perfetto or ``chrome://tracing``); ``step_annotation`` and
``annotate`` add ``record_function`` spans to it.

Usage:
    with trace("profiles/run1"):
        for step in range(10):
            with step_annotation("train_step", step):
                state, loss = train_step(state, batch, generator)
"""

import functools
import time
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextmanager
def trace(log_dir, *, create_perfetto_link: bool = False):
    """Capture host spans and, where CUDA is present, the card's kernels for
    the enclosed region; on exit the Chrome trace is written under
    ``log_dir``. Yields ``log_dir``. ``create_perfetto_link`` is accepted for
    the JAX signature and does nothing: open the written file in Perfetto."""
    del create_perfetto_link
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(log_dir)
    prof.export_chrome_trace(str(log_dir / f"trace_{time.time_ns()}.json"))


@contextmanager
def step_annotation(name: str, step: int = 0):
    """Label a region so it shows up as the span ``f"{name}#{step}"`` in the
    trace."""
    with record_function(f"{name}#{step}"):
        yield


def annotate(name: str):
    """Function decorator adding a named trace span."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
