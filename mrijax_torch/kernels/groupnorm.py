"""Fused GroupNorm + SiLU over channels-last activations, forward.

Counterpart of ``mrijax/kernels/groupnorm_pallas.py``. Two hand-written CUDA
kernels (``mrijax_torch/csrc/groupnorm_silu.cu``) take the place of the two
Pallas kernels: ``gn_silu_stats`` (per-(batch, group) mean and 1/std in fp32)
and ``gn_silu_apply`` (normalise, affine, SiLU, cast) — two reads and one
write of the activation.

For a CUDA tensor the wrappers launch their kernel or raise. The plain
PyTorch versions beside them (``*_reference``) are what a CPU tensor gets,
and what the tests and ``chip_smoke.py`` hold the kernels against.

Like the TPU kernel, this is a forward: it is meant for sampling and other
undifferentiated calls and does not record a gradient.
"""

import ctypes
import functools
from dataclasses import dataclass

import torch

from mrijax_torch.kernels import _build

launches = _build.LaunchCounts("gn_silu_stats", "gn_silu_apply")

MAX_GROUPS = 128          # the finalize kernel sums partials with 256 // G rows
MAX_VECTOR_COLUMNS = 4096  # stats scratch in shared memory: 2 * cols floats
_THREADS = 256
_ELEMENTS_PER_BLOCK = 16384


@dataclass(frozen=True)
class LaunchPlan:
    """How the (B, N, C) activation is cut up for both kernels."""

    vec: int             # channels moved per load; divides C // G
    tx: int              # threads across vector columns
    ty: int              # threads across rows
    rows_per_chunk: int  # rows of one batch entry per block
    chunks: int          # blocks per batch entry


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, c: int, groups: int, itemsize: int,
                alignment: int = 16) -> LaunchPlan:
    """Pick the vector width and the block grid for an (·, n, c) input.

    ``vec`` is the largest power of two such that a vector is at most 16
    bytes, lies inside one group and every row start stays aligned to it.
    ``alignment`` is the alignment of the data pointer in bytes.
    """
    if c % groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"groups must be in 1..{MAX_GROUPS}, got {groups}")
    cpg = c // groups
    vec = 16 // itemsize
    while vec > 1 and (cpg % vec != 0 or alignment % (vec * itemsize) != 0):
        vec //= 2
    cols = c // vec
    if cols > MAX_VECTOR_COLUMNS:
        raise ValueError(
            f"{c} channels in vectors of {vec} give {cols} columns; "
            f"the kernel takes at most {MAX_VECTOR_COLUMNS}"
        )
    tx = min(cols, _THREADS)
    ty = max(_THREADS // cols, 1)
    rows = -(-_ELEMENTS_PER_BLOCK // c)
    rows_per_chunk = max(ty, -(-rows // ty) * ty)
    chunks = -(-n // rows_per_chunk)
    return LaunchPlan(vec, tx, ty, rows_per_chunk, chunks)


def _check_input(x: torch.Tensor, groups: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected (B, N, C), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(
            f"GroupNorm+SiLU kernel needs a contiguous (B, N, C) buffer, got "
            f"strides {x.stride()} for shape {tuple(x.shape)}"
        )
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the grid's 65535")
    if x.shape[1] < 1:
        raise ValueError("empty token axis")
    _build.dtype_code(x.dtype)
    if x.shape[2] % groups != 0:
        raise ValueError(f"channels {x.shape[2]} not divisible by groups {groups}")


def _plan_for(x: torch.Tensor, groups: int) -> LaunchPlan:
    ptr = x.data_ptr()
    alignment = 16 if ptr % 16 == 0 else (ptr & -ptr)
    return launch_plan(x.shape[1], x.shape[2], groups, x.element_size(), alignment)


def _library() -> ctypes.CDLL:
    lib = _build.library("groupnorm_silu")
    if lib.gn_silu_stats.argtypes is None:
        p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        lib.gn_silu_stats.argtypes = [p, p, p, i, i, ll, ll, i, i, i, i, i, i, d, d, p]
        lib.gn_silu_stats.restype = i
        lib.gn_silu_apply.argtypes = [p, p, p, p, p, i, i, ll, ll, i, i, i, i, i, i, p]
        lib.gn_silu_apply.restype = i
    return lib


# --------------------------------------------------------------- plain versions


def gn_silu_stats_reference(x: torch.Tensor, groups: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain version of ``gn_silu_stats``: (B, 2, G) fp32, row 0 the group
    mean, row 1 ``1/sqrt(var + eps)`` with var = E[x²] − mean²."""
    b, n, c = x.shape
    xg = x.float().reshape(b, n, groups, c // groups)
    count = n * (c // groups)
    mean = xg.sum(dim=(1, 3)) / count
    var = ((xg * xg).sum(dim=(1, 3)) / count - mean * mean).clamp_min(0.0)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def gn_silu_apply_reference(x: torch.Tensor, stats: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gn_silu_apply``: ``y = (x−μ)·rstd·γ+β``, then
    ``y·sigmoid(y)`` in fp32, cast to the input dtype."""
    b, n, c = x.shape
    groups = stats.shape[-1]
    mean = stats[:, 0].repeat_interleave(c // groups, dim=-1)[:, None, :]
    rstd = stats[:, 1].repeat_interleave(c // groups, dim=-1)[:, None, :]
    y = (x.float() - mean) * rstd * scale.float() + bias.float()
    return (y * torch.sigmoid(y)).to(x.dtype)


def group_norm_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, groups: int = 8,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the fused op on (B, *spatial, C): the same
    arithmetic as the two kernels (fp32 statistics and SiLU, one cast)."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    stats = gn_silu_stats_reference(x3, groups, eps)
    return gn_silu_apply_reference(x3, stats, scale, bias).reshape(shape)


# -------------------------------------------------------------------- wrappers


def _launch_stats(x: torch.Tensor, groups: int, eps: float,
                  plan: LaunchPlan) -> torch.Tensor:
    """Launch ``gn_silu_stats`` on a checked, contiguous CUDA (B, N, C) tensor."""
    b, n, c = x.shape
    partials = torch.empty((b, plan.chunks, 2, groups), dtype=torch.float32,
                           device=x.device)
    stats = torch.empty((b, 2, groups), dtype=torch.float32, device=x.device)
    err = _library().gn_silu_stats(
        x.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        _build.dtype_code(x.dtype), plan.vec, b, n, c, groups,
        plan.tx, plan.ty, plan.rows_per_chunk, plan.chunks,
        float(n * (c // groups)), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch(err, "gn_silu_stats")
    launches.bump("gn_silu_stats")
    return stats


def _launch_apply(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, plan: LaunchPlan) -> torch.Tensor:
    """Launch ``gn_silu_apply``; ``x`` as for ``_launch_stats``, the others
    contiguous float32 on the same device."""
    b, n, c = x.shape
    groups = stats.shape[-1]
    for name, t, shape in (("stats", stats, (b, 2, groups)),
                           ("scale", scale, (c,)), ("bias", bias, (c,))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 {shape} tensor on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    y = torch.empty_like(x)
    if y.data_ptr() % (plan.vec * x.element_size()) != 0:
        raise RuntimeError("output buffer is less aligned than the input")
    err = _library().gn_silu_apply(
        x.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), _build.dtype_code(x.dtype), plan.vec, b, n, c,
        groups, plan.tx, plan.ty, plan.rows_per_chunk, plan.chunks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch(err, "gn_silu_apply")
    launches.bump("gn_silu_apply")
    return y


def gn_silu_stats(x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-(batch, group) mean and 1/std of a contiguous (B, N, C) tensor, as
    fp32 (B, 2, G). CUDA tensors go through the kernel, CPU tensors through
    the plain version."""
    if not x.is_cuda:
        return gn_silu_stats_reference(x, groups, eps)
    _check_input(x, groups)
    with torch.cuda.device(x.device):
        return _launch_stats(x, groups, eps, _plan_for(x, groups))


def gn_silu_apply(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Normalise a contiguous (B, N, C) tensor with ``stats`` (B, 2, G) from
    ``gn_silu_stats``, apply fp32 ``scale``/``bias`` (C,) and SiLU; the result
    has the input's dtype."""
    if not x.is_cuda:
        return gn_silu_apply_reference(x, stats, scale, bias)
    groups = stats.shape[-1]
    _check_input(x, groups)
    with torch.cuda.device(x.device):
        return _launch_apply(x, stats, scale, bias, _plan_for(x, groups))


def group_norm_silu_fused(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, groups: int = 8,
                          eps: float = 1e-5) -> torch.Tensor:
    """Fused GroupNorm+SiLU on a channels-last (B, *spatial, C) tensor.

    On CUDA: the two kernels, or an error for what they do not take (a
    non-contiguous buffer, another dtype than float32/bfloat16, more than 128
    groups). On the CPU: the plain version. Forward only.
    """
    if not x.is_cuda:
        return group_norm_silu_reference(x, scale, bias, groups, eps)
    shape = x.shape
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        raise NotImplementedError(
            "the GroupNorm+SiLU kernel is forward only: call it under "
            "torch.no_grad() (training on CUDA is not ported yet)"
        )
    if not x.is_contiguous():
        raise ValueError(
            f"GroupNorm+SiLU kernel needs a contiguous channels-last buffer, "
            f"got strides {x.stride()} for shape {tuple(shape)}"
        )
    x3 = x.view(shape[0], -1, shape[-1])
    _check_input(x3, groups)
    plan = _plan_for(x3, groups)
    with torch.cuda.device(x.device):
        stats = _launch_stats(x3, groups, eps, plan)
        return _launch_apply(x3, stats, scale, bias, plan).view(shape)
