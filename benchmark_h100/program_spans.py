"""What the per-layer metrics read from the program's own spans
(``mrijax_torch.obs.profiling``): spans record only while a profiler records,
so in a ``--trace 1`` run the newest session is the traced segment
(``tracing.py``), and its units divide the sums. A reader returns None where
the cell is of another role, nothing was traced, or the program has no span
registry (a program from before it). It raises where the program has the
registry and the traced segment of a cell that lists the metric recorded no
such span, or recorded it without timing the stream: the work has then left
the metric's sight, and a number read without it would be wrong."""

from typing import Optional


def stream_ms_per_unit(ctx, role: str, prefix: str) -> Optional[float]:
    """Σ stream ms of the spans named ``prefix…`` over the traced units."""
    if ctx["role"] != role or ctx.get("trace") is None or not ctx["trace"]["units"]:
        return None
    try:
        from mrijax_torch.obs.profiling import spans
    except ImportError:
        return None
    got = spans(prefix)
    if not got:
        raise RuntimeError(f"the traced segment recorded no span {prefix!r}")
    if any(s.stream_ms is None for s in got):
        raise RuntimeError(f"the span {prefix!r} does not time the stream")
    return sum(s.stream_ms for s in got) / ctx["trace"]["units"]
