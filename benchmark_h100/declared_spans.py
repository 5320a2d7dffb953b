"""Per-layer readers of spans that a program module declares in its
``SPANS`` tuple (``mrijax_torch.models.dit3d``, ``mrijax_torch.train.steps``).
A program from before a span was added has no such declaration: the reader
then finds nothing to read and returns None, where
``program_spans.stream_ms_per_unit`` alone would raise for a span the traced
segment did not record. Where the program declares the span, a segment that
recorded none of it still raises there."""

import importlib
from typing import Optional

from benchmark_h100.program_spans import stream_ms_per_unit


def declared(module: str, name: str) -> bool:
    """Whether the program's ``module`` declares the span ``name``."""
    try:
        return name in getattr(importlib.import_module(module), "SPANS", ())
    except ImportError:
        return False


def stream_ms(ctx, role: str, module: str, name: str) -> Optional[float]:
    """Σ stream ms of the span ``name`` over the traced units, or None where
    the program does not declare it."""
    if not declared(module, name):
        return None
    return stream_ms_per_unit(ctx, role, name)
