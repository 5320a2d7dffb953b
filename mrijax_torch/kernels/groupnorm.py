"""Fused GroupNorm + SiLU over channels-last activations.

Counterpart of ``mrijax/kernels/groupnorm_pallas.py``. Two hand-written CUDA
kernels (``mrijax_torch/csrc/groupnorm_silu.cu``) take the place of the two
Pallas kernels: ``gn_silu_stats`` (per-(batch, group) mean and 1/std in fp32,
one launch) and ``gn_silu_apply`` (normalise, affine, SiLU, cast) — two reads
and one write of the activation. ``launch_plan`` cuts the input up for the
stats kernel, ``apply_plan`` for the apply kernel.

For a CUDA tensor the wrappers launch their kernel or raise. The plain
PyTorch versions beside them (``*_reference``) are what a CPU tensor gets,
and what the tests and ``chip_smoke.py`` hold the kernels against.

``group_norm_silu_fused`` is a ``torch.autograd.Function``. Its forward runs
the two kernels, under autograd too, and saves only (x, γ, β). Its backward
differentiates the plain composition ``mrijax_torch.ops.norms.group_norm_silu``
on the saved input — the TPU version's backward is no Pallas kernel either
(its ``_bwd`` takes the vjp of the same composition), so plain PyTorch is its
port.

Both kernels are also the ``torch.library`` custom ops
``torch.ops.mrijax_torch.gn_silu_stats`` and ``gn_silu_apply`` (CUDA
implementation: the launch; CPU implementation: the plain version; a fake
implementation gives ``torch.export`` the output shapes), which is how they
appear in an exported program (``mrijax_torch.aot``): a ``ctypes`` call cannot
be traced. The fused front takes the op route only while
``torch.compiler.is_exporting()``; eager calls go straight to the launch,
because a Python custom op adds host time to every call (``chip_smoke.py``
prints both host times per pair).
"""

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from mrijax_torch.kernels import _build
from mrijax_torch.obs.profiling import span

launches = _build.LaunchCounts("gn_silu_stats", "gn_silu_apply")

MAX_GROUPS = 128           # the stats kernel sums (2, G) partials in 2 * 128 floats of shared memory
MAX_CHANNELS = 26624       # stats: (2048 + C) * 8 bytes of dynamic shared memory beside 1 KB static
MAX_SHARED_BYTES = 232448  # fit the 227 KB a block may ask for; above 48 KB (C > 3840) the launch raises the limit
SM_COUNT = 132             # streaming multiprocessors of an H100
STATS_ROWS_PER_THREAD = (4, 2)   # loads a thread compiled into gn_silu_stats, most first
STATS_BLOCKS_PER_SM = 2    # blocks of the whole batch per SM that gn_silu_stats launches, at most
STATS_SLABS_PER_SM = 8     # up to this many slabs an SM, one block per SM
SLAB_CHAIN = 32            # slab sums a thread adds in one run (csrc kChain)
APPLY_ROWS_PER_THREAD = (2, 1)   # loads a thread compiled into gn_silu_apply, most first
_THREADS = 256


def _vector_width(c: int, itemsize: int, alignment: int) -> int:
    """The largest power of two such that a vector is at most 16 bytes, ``c``
    is a multiple of it and a pointer aligned to ``alignment`` bytes is
    aligned to it. A vector may span groups: both kernels keep per-channel
    sums or parameters."""
    vec = 16 // itemsize
    while vec > 1 and (c % vec != 0 or alignment % (vec * itemsize) != 0):
        vec //= 2
    return vec


def _check_groups(c: int, groups: int) -> None:
    if c % groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"groups must be in 1..{MAX_GROUPS}, got {groups}")


@dataclass(frozen=True)
class LaunchPlan:
    """How the (B, N, C) activation is cut up for ``gn_silu_stats``: blocks
    of ``tx`` vector columns by ``ty`` rows take slabs of ``ty`` ·
    ``rows_per_thread`` rows of one batch entry, ``blocks`` slabs apart;
    each block leaves one (2, G) partial."""

    vec: int              # channels moved per load; divides C
    tx: int               # threads across vector columns
    ty: int               # threads across rows
    rows_per_thread: int  # R: loads a thread issues before any addition
    blocks: int           # blocks, and partials, per batch entry
    slabs: int            # slabs of ty * R rows in one batch entry

    @property
    def slab_rows(self) -> int:
        return self.ty * self.rows_per_thread

    @property
    def slabs_per_block(self) -> int:
        """Slab sums the busiest thread adds: in runs of ``SLAB_CHAIN``."""
        return -(-self.slabs // self.blocks)

    def shared_bytes(self, c: int) -> int:
        """Dynamic shared memory of the launch for ``c`` channels, as the
        source computes it: float32 (2, warps' rows, tx·vec) row sums and
        (2, C) group-piece sums."""
        slots = self.ty * self.tx // 32 if self.tx < 32 else self.ty
        return 4 * 2 * (slots * self.tx * self.vec + c)


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, c: int, groups: int, itemsize: int, alignment: int = 16,
                batch: int = 1) -> LaunchPlan:
    """Vector width, block shape, loads per thread and blocks per batch entry
    of ``gn_silu_stats`` for a (batch, n, c) input whose data pointer is
    aligned to ``alignment`` bytes.

    ``vec`` is as for ``apply_plan``, narrowed until a vector holds whole
    groups or lies inside one (16 bytes at every main-path shape; 3 channels
    a group take scalar loads): a thread adds its channels of one group
    before the block's reductions.

    Blocks are 256 threads, ``tx`` of them across the vector columns: the
    power of two at or above their number, up to 256 (the threads beyond a
    ragged C's columns only take part in the reductions; a thread walks the
    rows again for each further 256 columns). ``rows_per_thread`` is 4
    where that still gives the batch one slab per SM, else 2 (one load a
    thread never measured faster on an H100: PERF.md).
    ``blocks`` is ⌈per_sm·SM_COUNT/batch⌉, or the number of slabs
    where that is fewer: the whole grid runs in one wave, and a block loops
    over its slabs. ``per_sm`` is 1 where the batch has at most
    ``STATS_SLABS_PER_SM`` slabs an SM, else ``STATS_BLOCKS_PER_SM`` (2): a
    second block an SM hides load latency only where blocks loop over many
    slabs, and otherwise only adds partials for the last block to sum
    (PERF.md). A batch entry has at most ⌈2·SM_COUNT/batch⌉ partials.
    """
    _check_groups(c, groups)
    if c > MAX_CHANNELS:
        raise ValueError(f"{c} channels: the stats kernel takes at most {MAX_CHANNELS}")
    vec = _vector_width(c, itemsize, alignment)
    cpg = c // groups
    while cpg % vec and vec % cpg:   # a vector holds whole groups or lies in one
        vec //= 2
    cols = c // vec
    tx = min(1 << (cols - 1).bit_length(), _THREADS)
    ty = _THREADS // tx
    for r in STATS_ROWS_PER_THREAD:
        slabs = -(-n // (ty * r))
        if slabs * batch >= SM_COUNT:
            break
    per_sm = 1 if slabs * batch <= STATS_SLABS_PER_SM * SM_COUNT else STATS_BLOCKS_PER_SM
    blocks = min(slabs, -(-per_sm * SM_COUNT // batch))
    return LaunchPlan(vec, tx, ty, r, blocks, slabs)


@dataclass(frozen=True)
class ApplyPlan:
    """How one batch entry of the (B, N, C) activation is cut up for
    ``gn_silu_apply``: blocks of ``tx`` vector columns by ``ty`` rows, each
    thread taking ``rows_per_thread`` rows ``ty`` apart in one column."""

    vec: int              # channels moved per load; divides C
    tx: int               # threads across vector columns
    ty: int               # threads across rows
    rows_per_thread: int  # loads a thread issues before any arithmetic
    row_chunks: int       # blocks across the rows of one batch entry
    col_chunks: int       # blocks across the vector columns

    @property
    def blocks_per_batch(self) -> int:
        return self.row_chunks * self.col_chunks


@functools.lru_cache(maxsize=256)
def apply_plan(n: int, c: int, groups: int, itemsize: int,
               alignment: int = 16) -> ApplyPlan:
    """Vector width, block shape and loads per thread of ``gn_silu_apply``
    for an (·, n, c) input whose data pointer is aligned to ``alignment``
    bytes.

    ``vec`` is the largest power of two such that a vector is at most 16
    bytes, ``c`` is a multiple of it and the pointer is aligned to it; a
    vector may span groups (each channel has its own statistics in the
    kernel). Blocks are 256 threads, ``tx`` of them across the vector
    columns. ``rows_per_thread`` is 2 where that still gives every SM a
    block of each batch entry, else 1: small shapes fill the card with one
    load a thread. 4 loads a thread measured slower than 2 on an H100 at
    every main-path shape but the largest, where they tie (PERF.md), and are
    not compiled.
    """
    _check_groups(c, groups)
    vec = _vector_width(c, itemsize, alignment)
    cols = c // vec
    tx = min(cols, _THREADS)
    ty = _THREADS // tx
    col_chunks = -(-cols // tx)
    for rows_per_thread in APPLY_ROWS_PER_THREAD:
        row_chunks = -(-n // (ty * rows_per_thread))
        if row_chunks * col_chunks >= SM_COUNT:
            break
    return ApplyPlan(vec, tx, ty, rows_per_thread, row_chunks, col_chunks)


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


def _alignment(x: torch.Tensor) -> int:
    ptr = x.data_ptr()
    return 16 if ptr % 16 == 0 else (ptr & -ptr)


def _plan_for(x: torch.Tensor, groups: int) -> LaunchPlan:
    return launch_plan(x.shape[1], x.shape[2], groups, x.element_size(), _alignment(x),
                       x.shape[0])


def _apply_plan_for(x: torch.Tensor, groups: int) -> ApplyPlan:
    return apply_plan(x.shape[1], x.shape[2], groups, x.element_size(), _alignment(x))


def _library() -> ctypes.CDLL:
    lib = _build.library("groupnorm_silu")
    if lib.gn_silu_stats.argtypes is None:
        p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        lib.gn_silu_stats.argtypes = [p, p, p, p, i, i, ll, ll, i, i, i, i, i, i, d, d, p]
        lib.gn_silu_stats.restype = i
        lib.gn_silu_apply.argtypes = [p, p, p, p, p, i, i, ll, ll, i, i, i, i, i, i, i, p]
        lib.gn_silu_apply.restype = i
    return lib


# --------------------------------------------------------------- plain versions


def gn_silu_stats_reference(x: torch.Tensor, groups: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain version of ``gn_silu_stats``: (B, 2, G) fp32, row 0 the group
    mean, row 1 ``1/sqrt(var + eps)`` with var the population variance over
    (N, C/G), taken in two passes (``torch.var_mean``) as ``jnp.var`` does.
    A one-pass E[x²] − mean² in float32 cancels where |mean| ≫ std (at mean
    200, std 1.5 and N = 51 200 it was off by ~0.9 of a variance of 2.25)."""
    b, n, c = x.shape
    xg = x.float().reshape(b, n, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0)
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


# (device index, stream) -> (counters, partials): the stats kernel's scratch.
# Counters are zeroed once when allocated and the kernel leaves them zero;
# calls on one stream run in order, so they may share it.
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, batch: int,
               partial_floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    counters, partials = _workspaces.get(key, (None, None))
    if counters is None or counters.numel() < batch:
        counters = torch.zeros(batch, dtype=torch.int32, device=device)
    if partials is None or partials.numel() < partial_floats:
        partials = torch.empty(partial_floats, dtype=torch.float32, device=device)
    _workspaces[key] = (counters, partials)
    return counters, partials


def _launch_stats(x: torch.Tensor, groups: int, eps: float,
                  plan: LaunchPlan) -> torch.Tensor:
    """Launch ``gn_silu_stats`` on a checked, contiguous CUDA (B, N, C) tensor."""
    b, n, c = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters, partials = _workspace(x.device, stream, b, b * plan.blocks * 2 * groups)
    stats = torch.empty((b, 2, groups), dtype=torch.float32, device=x.device)
    err = _library().gn_silu_stats(
        x.data_ptr(), partials.data_ptr(), counters.data_ptr(), stats.data_ptr(),
        _build.dtype_code(x.dtype), plan.vec, b, n, c, groups,
        plan.tx, plan.ty, plan.rows_per_thread, plan.blocks,
        float(n * (c // groups)), float(eps), stream,
    )
    _build.check_launch(err, "gn_silu_stats")
    launches.bump("gn_silu_stats")
    return stats


def _launch_apply(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, plan: ApplyPlan) -> torch.Tensor:
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
        groups, plan.tx, plan.ty, plan.rows_per_thread, plan.row_chunks,
        plan.col_chunks, torch.cuda.current_stream(x.device).cuda_stream,
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
        return _launch_apply(x, stats, scale, bias, _apply_plan_for(x, groups))


# ------------------------------------------------------------- custom ops


@torch.library.custom_op("mrijax_torch::gn_silu_stats", mutates_args=(), device_types="cpu")
def gn_silu_stats_op(x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """``gn_silu_stats`` as a custom op: the plain version on the CPU, the
    kernel on CUDA (its workspace stays outside the op's arguments)."""
    return gn_silu_stats_reference(x, groups, eps)


@gn_silu_stats_op.register_kernel("cuda")
def _(x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    return gn_silu_stats(x, groups, eps)


@gn_silu_stats_op.register_fake
def _(x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    return x.new_empty((x.shape[0], 2, groups), dtype=torch.float32)


@torch.library.custom_op("mrijax_torch::gn_silu_apply", mutates_args=(), device_types="cpu")
def gn_silu_apply_op(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """``gn_silu_apply`` as a custom op: the plain version on the CPU, the
    kernel on CUDA."""
    return gn_silu_apply_reference(x, stats, scale, bias)


@gn_silu_apply_op.register_kernel("cuda")
def _(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
      bias: torch.Tensor) -> torch.Tensor:
    return gn_silu_apply(x, stats, scale, bias)


@gn_silu_apply_op.register_fake
def _(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
      bias: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _fused_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float) -> torch.Tensor:
    if torch.compiler.is_exporting():
        shape = x.shape
        x3 = x.reshape(shape[0], -1, shape[-1])
        stats = gn_silu_stats_op(x3, groups, eps)
        return gn_silu_apply_op(x3, stats, scale, bias).reshape(shape)
    if not x.is_cuda:
        return group_norm_silu_reference(x, scale, bias, groups, eps)
    shape = x.shape
    if not x.is_contiguous():
        raise ValueError(
            f"GroupNorm+SiLU kernel needs a contiguous channels-last buffer, "
            f"got strides {x.stride()} for shape {tuple(shape)}"
        )
    x3 = x.view(shape[0], -1, shape[-1])
    _check_input(x3, groups)
    with torch.cuda.device(x.device):
        stats = _launch_stats(x3, groups, eps, _plan_for(x3, groups))
        return _launch_apply(x3, stats, scale, bias,
                             _apply_plan_for(x3, groups)).view(shape)


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps = groups, eps
        return _fused_forward(x, scale, bias, groups, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        # imported here: ops.norms imports this module for its fused front
        from mrijax_torch.ops.norms import group_norm_silu

        with span("gn_silu.backward"):
            x, scale, bias = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
            with torch.enable_grad():
                y = group_norm_silu(x, ctx.groups, scale, bias, ctx.eps)
            wanted = [t for t, need in zip((x, scale, bias), ctx.needs_input_grad) if need]
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if need else None
                     for need in ctx.needs_input_grad[:3]) + (None, None)


def group_norm_silu_fused(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, groups: int = 8,
                          eps: float = 1e-5) -> torch.Tensor:
    """Fused GroupNorm+SiLU on a channels-last (B, *spatial, C) tensor,
    differentiable in x, scale and bias.

    On CUDA: the two kernels, or an error for what they do not take (a
    non-contiguous buffer, another dtype than float32/bfloat16, more than 128
    groups). On the CPU: the plain version. The gradient is that of the plain
    composition on the saved input. A call that records no gradient (sampling)
    goes straight to the kernels.
    """
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSiLU.apply(x, scale, bias, groups, eps)
    return _fused_forward(x, scale, bias, groups, eps)
