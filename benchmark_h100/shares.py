"""The arithmetic of the per-layer shares, which several metric readers
share: rooflines, ``mfu`` and the idle share. Each returns a share in % or
None where its cell has nothing for it to read (no trace, no such kernel, no
attention, another role)."""

from typing import Optional

from benchmark_h100 import tracing
from benchmark_h100.count import peaks


def _traced(ctx, role: str) -> Optional[dict]:
    if ctx["role"] != role or ctx.get("trace") is None or not ctx["trace"]["units"]:
        return None
    return ctx["trace"]


def gn_silu_roofline(ctx, role: str) -> Optional[float]:
    trace = _traced(ctx, role)
    if trace is None:
        return None
    seconds = tracing.kernel_s(trace, "gn_silu_stats", "gn_silu_apply")
    elements = ctx["counts"]["forward"].gn_silu_elements
    if seconds <= 0 or not elements:
        return None
    bound = trace["units"] * peaks.gn_silu_bound_s(elements, ctx["itemsize"])
    return 100.0 * bound / seconds


def flash_roofline(ctx, role: str) -> Optional[float]:
    trace = _traced(ctx, role)
    if trace is None:
        return None
    seconds = tracing.kernel_s(trace, "flash_fwd", "flash_bwd")
    blocks = ctx["counts"]["forward"].attention
    if seconds <= 0 or not blocks:
        return None
    per_unit = sum(peaks.flash_bound_s(b, n, c, ctx["itemsize"], role == "train")
                   for b, n, c in blocks)
    return 100.0 * trace["units"] * per_unit / seconds


def mfu(ctx, role: str) -> Optional[float]:
    if ctx["role"] != role or ctx.get("counts") is None:
        return None
    w, c = ctx["window"], ctx["counts"]
    forward = c["forward"].total_flops
    if role == "train":
        flops = 3 * w["steps"] * forward
    else:
        flops = w["forwards"] * forward + w["samples"] * c["decode_flops_per_sample"]
    return 100.0 * flops / w["seconds"] / peaks.BF16_FLOPS


def idle_share(ctx, role: str) -> Optional[float]:
    trace = _traced(ctx, role)
    if trace is None or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
