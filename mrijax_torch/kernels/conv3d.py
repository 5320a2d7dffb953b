"""3D convolution with kernel 4, stride 2 and padding 1 on channels-last
bfloat16 activations, and its weight gradient, on the tensor cores.

Replaces no TPU kernel: the JAX package leaves this convolution and its
gradients to XLA. The port left them to cuDNN, which has no tensor-core
engine for them in 3D: its CUDA-core engines took half of a 3D DDIM step
(the forward) and 37 % of a 3D training step (the weight gradient; PERF.md).
Two hand-written CUDA kernels (``mrijax_torch/csrc/conv3d_k4s2.cu``,
implicit GEMMs on ``wgmma``) compute them at the 3D models' stride-2
convolutions (``models/blocks.py``):

* ``conv3d_k4s2``: the forward of ``Downsample`` (``_Downsample3D``) and the
  input gradient of ``Upsample`` (``_Upsample3D``, whose forward stays the
  library's transposed convolution): the input gradient of a transposed
  convolution with kernel 4, stride 2 and padding 1 is this convolution of
  the output gradient with the same weight, read as (in, out) channels, no
  flip;
* ``conv3d_k4s2_wgrad``: the weight gradient of both, the sum over the
  small side's voxels of one plain operand by the other gathered at the
  forward's taps (``Downsample``: dy by x; ``Upsample``: x by dy). The
  ``Downsample``'s input gradient and both bias gradients stay the
  library's (``_library_gradients``).

Each launches its kernel for a CUDA tensor or raises; a CPU tensor gets the
plain version (``conv3d_k4s2_reference``, ``conv3d_k4s2_wgrad_reference``:
explicit im2col in the kernel's K order, then one matmul with fp32
accumulation), which the tests and ``chip_smoke.py`` hold the kernels
against. The forward is also the ``torch.library`` custom op
``torch.ops.mrijax_torch.conv3d_k4s2`` (a fake implementation gives
``torch.export`` its shape), taken only while
``torch.compiler.is_exporting()``: a ``ctypes`` call cannot be traced, and a
Python custom op adds host time to every eager call.
"""

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from mrijax_torch.kernels import _build

launches = _build.LaunchCounts("conv3d_k4s2", "conv3d_k4s2_wgrad")

KERNEL, STRIDE, PADDING = 4, 2, 1
TAPS = KERNEL ** 3
TILE_M = 128               # output voxels a tile (csrc BM); weight gradient: (tap, channel) rows
TILE_N = (64, 128, 256)    # output channels a tile the kernel is compiled for
SM_COUNT = 132             # streaming multiprocessors of an H100
_MAX_ROWS = 2 ** 31 - 1 - TILE_M   # M in int32, with a tile to spare
WGRAD_STEP = 64            # voxels a stage of the weight gradient's sum (csrc BK)
MIN_PART_STEPS = 16        # stages a part of a split sum holds at least
MAX_PART_STEPS = 1600      # stages a part holds at most: 102 400 voxels (see wgrad_plan)
MAX_SPLIT = 16             # parts a tile's sum is cut into at most to fill the SMs


def output_spatial(spatial: Sequence[int]) -> Tuple[int, ...]:
    """(Do, Ho, Wo) of the convolution: each input size halved, rounded down."""
    return tuple((n + 2 * PADDING - KERNEL) // STRIDE + 1 for n in spatial)


def _axis_pairs(n_in: int) -> int:
    """(output, tap) pairs along one axis whose input position lies inside
    the input: the rule of ``benchmark_h100/count/ops.py``."""
    n_out = (n_in + 2 * PADDING - KERNEL) // STRIDE + 1
    return sum(1 for o in range(n_out) for j in range(KERNEL)
               if 0 <= o * STRIDE - PADDING + j < n_in)


def operations(x_shape: Sequence[int], c_out: int, bias: bool = True) -> int:
    """Operations of one call on a (B, D, H, W, Cin) input, counted as
    ``benchmark_h100/count/ops.py`` counts a convolution: 2 a multiply-add of
    every (output, tap) pair whose input lies inside the input (padding taps
    left out), 1 an output element for the bias."""
    b, d, h, w, c_in = x_shape
    pairs = _axis_pairs(d) * _axis_pairs(h) * _axis_pairs(w)
    do, ho, wo = output_spatial((d, h, w))
    return 2 * b * pairs * c_in * c_out + (b * do * ho * wo * c_out if bias else 0)


@dataclass(frozen=True)
class LaunchPlan:
    """Tiles of ``TILE_M`` output voxels by ``tile_n`` channels, and the
    ``grid`` blocks that walk them, ``waves`` tiles each at most."""

    tile_n: int
    tiles: int
    waves: int
    grid: int


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, n: int, sms: int = SM_COUNT) -> LaunchPlan:
    """``tile_n`` is the smallest compiled width that covers ``n`` output
    channels up to 256, else 256; ``waves`` = ⌈tiles / sms⌉ and ``grid`` =
    ⌈tiles / waves⌉, so every block takes ``waves`` tiles or one fewer and
    no SM stands idle in a last wave that others have left."""
    tile_n = next((t for t in TILE_N if n <= t), TILE_N[-1])
    tiles = -(-m // TILE_M) * -(-n // tile_n)
    waves = -(-tiles // sms)
    return LaunchPlan(tile_n, tiles, waves, -(-tiles // waves))


@dataclass(frozen=True)
class WgradPlan:
    """The weight gradient's tiles of ``TILE_M`` (tap, channel) rows by
    ``tile_n`` columns, each tile's sum over ``steps`` stages of
    ``WGRAD_STEP`` voxels cut into ``split`` parts (``part``), and the
    ``grid`` blocks that walk the ``units`` = tiles × split, ``waves`` each
    at most (unit u: tile u // split, part u % split)."""

    tile_n: int
    tiles: int
    steps: int
    split: int
    units: int
    waves: int
    grid: int

    def part(self, i: int) -> range:
        """The stages part ``i`` of a tile's sum takes (the kernel's rule)."""
        return range(i * self.steps // self.split, (i + 1) * self.steps // self.split)


@functools.lru_cache(maxsize=256)
def wgrad_plan(m: int, c_p: int, c_g: int, sms: int = SM_COUNT) -> WgradPlan:
    """Plan of the weight gradient over ``m`` small-side voxels, ``c_p``
    columns (the plain operand's channels) and 64·``c_g`` rows: ``tile_n``
    as ``launch_plan``'s; each tile's sum is cut into ``split`` parts, as
    many as fill the SMs the tiles leave idle in one wave (⌊sms / tiles⌋,
    at most ``MAX_SPLIT``), or more where a part would hold more than
    ``MAX_PART_STEPS`` stages, and never fewer than ``MIN_PART_STEPS``
    stages a part. The tensor cores' fp32 sum is not rounded to nearest and
    drifts over a long sum: on an H100 one part of 409 600 voxels missed
    ``chip_smoke.py``'s bar, parts of 102 400 met it (PERF.md, section 6)."""
    tile_n = next((t for t in TILE_N if c_p <= t), TILE_N[-1])
    tiles = TAPS * c_g // TILE_M * -(-c_p // tile_n)
    steps = -(-m // WGRAD_STEP)
    fill = min(sms // tiles, MAX_SPLIT)
    split = max(1, min(max(fill, -(-steps // MAX_PART_STEPS)), steps // MIN_PART_STEPS))
    units = tiles * split
    waves = -(-units // sms)
    return WgradPlan(tile_n, tiles, steps, split, units, waves, -(-units // waves))


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 4, 4, 4) → the kernel's B matrix (Cout, 64·Cin), K
    ordered (kd, kh, kw, cin): a view of a ``channels_last_3d`` weight, one
    permute copy of any other."""
    c_out = weight.shape[0]
    return weight.permute(0, 2, 3, 4, 1).reshape(c_out, -1)


@functools.lru_cache(maxsize=16)
def _swizzle_index(tile_n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    rows = torch.arange(tile_n, device=device)[:, None]
    return rows, torch.arange(8, device=device)[None, :] ^ (rows & 7)


def tile_weight(weight: torch.Tensor, tile_n: int) -> torch.Tensor:
    """The kernel's B operand: the packed weight cut into tiles of
    ``tile_n`` rows by 64 of K, laid out as a stage of shared memory holds
    them, so that one bulk copy brings a stage's tile: (⌈Cout / tile_n⌉,
    64·Cin / 64, tile_n, 8, 8), the 16-byte piece q of row r at position
    q ^ (r mod 8) (the 128-byte swizzle of ``csrc/wgmma.cuh``), rows past
    Cout zero. One gather a call."""
    packed = pack_weight(weight)
    n, k = packed.shape
    n_tiles = -(-n // tile_n)
    if n_tiles * tile_n != n:
        packed = F.pad(packed, (0, 0, 0, n_tiles * tile_n - n))
    steps = packed.reshape(n_tiles, tile_n, k // 64, 8, 8).permute(0, 2, 1, 3, 4)
    rows, pieces = _swizzle_index(tile_n, packed.device)
    return steps[:, :, rows, pieces]


def im2col(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) → (B·Do·Ho·Wo, 64·C): each output voxel's 64 taps
    of C channels in the kernel's K order, zeros where a tap falls in the
    padding."""
    b, c = x.shape[0], x.shape[-1]
    do, ho, wo = output_spatial(x.shape[1:4])
    xp = F.pad(x, (0, 0, PADDING, PADDING, PADDING, PADDING, PADDING, PADDING))
    taps = [xp[:, kd:kd + STRIDE * do:STRIDE, kh:kh + STRIDE * ho:STRIDE,
               kw:kw + STRIDE * wo:STRIDE]
            for kd in range(KERNEL) for kh in range(KERNEL) for kw in range(KERNEL)]
    return torch.stack(taps, dim=4).reshape(b * do * ho * wo, TAPS * c)


def conv3d_k4s2_reference(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernel on a channels-last (B, D, H, W, Cin) input
    and a (Cout, Cin, 4, 4, 4) weight: ``im2col`` then one matmul, summed in
    float32 (float64 stays float64), the bias added before the one rounding
    to the input's dtype. Returns (B, Do, Ho, Wo, Cout)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    b = x.shape[0]
    do, ho, wo = output_spatial(x.shape[1:4])
    y = im2col(x).to(acc) @ pack_weight(weight).to(acc).t()
    if bias is not None:
        y = y + bias.to(acc)
    return y.to(x.dtype).reshape(b, do, ho, wo, weight.shape[0])


def conv3d_k4s2_wgrad_reference(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the weight-gradient kernel: ``im2col(g)ᵀ @ p`` with
    ``p`` (B, Do, Ho, Wo, Cp) read as (M, Cp) and ``g`` (B, D, H, W, Cg)
    gathered at the taps, summed in float32 (float64 stays float64), one
    rounding to ``g``'s dtype. Returns (Cp, 4, 4, 4, Cg), the columns in the
    kernel's K order."""
    acc = torch.promote_types(g.dtype, torch.float32)
    c_p = p.shape[-1]
    out = p.reshape(-1, c_p).to(acc).t() @ im2col(g).to(acc)
    return out.to(g.dtype).reshape(c_p, KERNEL, KERNEL, KERNEL, g.shape[-1])


# -------------------------------------------------------------------- wrapper


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """Raise unless the kernel takes these operands: bf16 on one device, x
    (B, D, H, W, Cin) with D, H, W ≥ 2, channel stride 1 and 16-byte aligned
    voxels, weight (Cout, Cin, 4, 4, 4), bias (Cout,) or None, Cin and Cout
    multiples of 8."""
    if x.dim() != 5:
        raise ValueError(f"expected a channels-last (B, D, H, W, C) input, got {tuple(x.shape)}")
    c_in = x.shape[-1]
    if weight.dim() != 5 or tuple(weight.shape[1:]) != (c_in, KERNEL, KERNEL, KERNEL):
        raise ValueError(f"weight {tuple(weight.shape)} is not (Cout, {c_in}, 4, 4, 4)")
    c_out = weight.shape[0]
    if c_in % 8 or c_out % 8:
        raise ValueError(f"channels {c_in} -> {c_out}: the kernel takes multiples of 8")
    if min(x.shape[1:4]) < 2 or x.shape[0] < 1:
        raise ValueError(f"input {tuple(x.shape)}: every spatial size must be at least 2")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype != torch.bfloat16 or t.device != x.device):
            raise ValueError(f"{name} must be bfloat16 on {x.device}, got {t.dtype} on {t.device}")
    if bias is not None and tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({c_out},)")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("bias must be contiguous")
    if not kernel_reads(x):
        raise ValueError(
            f"the kernel reads 16-byte runs of channels: x needs channel stride 1, the "
            f"other strides multiples of 8 and a 16-byte aligned start, got strides "
            f"{x.stride()} at {x.data_ptr() % 16} bytes past 16")
    m = x.shape[0] * math.prod(output_spatial(x.shape[1:4]))
    if m > _MAX_ROWS:
        raise ValueError(f"{m} output voxels exceed the kernel's int32 rows")


def kernel_reads(x: torch.Tensor) -> bool:
    """Whether the kernel can read ``x`` through its strides as it is (else a
    caller makes it contiguous first)."""
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:4])
            and x.data_ptr() % 16 == 0)


def row_pitch(t: torch.Tensor) -> int:
    """The row pitch in elements of a channels-last (B, D, H, W, C) tensor
    read as a (B·D·H·W, C) matrix, as the weight-gradient kernel's tensor
    map reads its plain operand (evenly spaced voxels, channel stride 1, a
    pitch of 16-byte multiples from a 16-byte aligned start), or 0 where it
    cannot (a caller then makes it contiguous first)."""
    if t.is_contiguous():
        pitch = t.shape[-1]
    else:
        pitch = expected = t.stride(3)
        for axis in (3, 2, 1, 0):
            if t.shape[axis] > 1 and t.stride(axis) != expected:
                return 0
            expected *= t.shape[axis]
        if t.stride(-1) != 1 or pitch < t.shape[-1]:
            return 0
    return pitch if pitch % 8 == 0 and t.data_ptr() % 16 == 0 else 0


def _check_wgrad(p: torch.Tensor, g: torch.Tensor) -> None:
    """Raise unless the weight-gradient kernel takes these operands: bf16 on
    one device, g (B, D, H, W, Cg) with D, H, W ≥ 2 read as ``kernel_reads``
    says, p (B, Do, Ho, Wo, Cp) at the convolution's small side read as
    ``row_pitch`` says, Cg and Cp multiples of 8."""
    if p.dim() != 5 or g.dim() != 5:
        raise ValueError(f"expected channels-last (B, D, H, W, C) operands, got "
                         f"{tuple(p.shape)} and {tuple(g.shape)}")
    if min(g.shape[1:4]) < 2 or g.shape[0] < 1:
        raise ValueError(f"g {tuple(g.shape)}: every spatial size must be at least 2")
    small = (g.shape[0], *output_spatial(g.shape[1:4]))
    if tuple(p.shape[:4]) != small:
        raise ValueError(f"p {tuple(p.shape)} is not at the small side {small} of g")
    if p.shape[-1] % 8 or g.shape[-1] % 8:
        raise ValueError(f"channels {p.shape[-1]}, {g.shape[-1]}: the kernel takes multiples of 8")
    for name, t in (("p", p), ("g", g)):
        if t.dtype != torch.bfloat16 or t.device != g.device:
            raise ValueError(f"{name} must be bfloat16 on {g.device}, got {t.dtype} on {t.device}")
    if not kernel_reads(g):
        raise ValueError(
            f"the kernel reads 16-byte runs of channels: g needs channel stride 1, the "
            f"other strides multiples of 8 and a 16-byte aligned start, got strides "
            f"{g.stride()} at {g.data_ptr() % 16} bytes past 16")
    if not row_pitch(p):
        raise ValueError(f"p's voxels must be evenly spaced rows of a 16-byte multiple from a "
                         f"16-byte aligned start, got strides {p.stride()}")
    if math.prod(small) > _MAX_ROWS:
        raise ValueError(f"{math.prod(small)} voxels exceed the kernel's int32 rows")


def _library() -> ctypes.CDLL:
    lib = _build.library("conv3d_k4s2")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if lib.conv3d_k4s2.argtypes is None:
        lib.conv3d_k4s2.argtypes = [p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, i, i, i, p]
        lib.conv3d_k4s2.restype = i
    if lib.conv3d_k4s2_wgrad.argtypes is None:
        lib.conv3d_k4s2_wgrad.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, i, i,
                                          i, i, p]
        lib.conv3d_k4s2_wgrad.restype = i
    return lib


def _launch(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands."""
    b, d, h, w, c_in = x.shape
    c_out = weight.shape[0]
    do, ho, wo = output_spatial((d, h, w))
    plan = launch_plan(b * do * ho * wo, c_out)
    tiles = tile_weight(weight, plan.tile_n)
    y = torch.empty((b, do, ho, wo, c_out), dtype=x.dtype, device=x.device)
    sb, sd, sh, sw, _ = x.stride()
    err = _library().conv3d_k4s2(
        x.data_ptr(), tiles.data_ptr(), bias.data_ptr() if bias is not None else None,
        y.data_ptr(), b, d, h, w, c_in, sb, sd, sh, sw, c_out, plan.tile_n, plan.grid,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch(err, "conv3d_k4s2")
    launches.bump("conv3d_k4s2")
    return y


def conv3d_k4s2(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The convolution with kernel 4, stride 2, padding 1 of a channels-last
    (B, D, H, W, Cin) input by a (Cout, Cin, 4, 4, 4) weight, as
    (B, Do, Ho, Wo, Cout). A CUDA tensor launches the kernel (bf16 only;
    anything else raises), a CPU tensor gets the plain version; while
    ``torch.export`` traces, the custom op."""
    if torch.compiler.is_exporting():
        return conv3d_k4s2_op(x, weight, bias)
    if not x.is_cuda:
        return conv3d_k4s2_reference(x, weight, bias)
    _check(x, weight, bias)
    with torch.cuda.device(x.device):
        return _launch(x, weight, bias)


def _launch_wgrad(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the weight-gradient kernel on checked CUDA operands."""
    b, d, h, w, c_g = g.shape
    c_p = p.shape[-1]
    plan = wgrad_plan(b * math.prod(output_spatial((d, h, w))), c_p, c_g)
    out = torch.empty((c_p, KERNEL, KERNEL, KERNEL, c_g), dtype=g.dtype, device=g.device)
    ws = tickets = None
    if plan.split > 1:
        ws = torch.empty(plan.units * TILE_M * plan.tile_n, dtype=torch.float32, device=g.device)
        tickets = torch.zeros(plan.tiles, dtype=torch.int32, device=g.device)
    sb, sd, sh, sw, _ = g.stride()
    err = _library().conv3d_k4s2_wgrad(
        g.data_ptr(), p.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, d, h, w, c_g, sb, sd, sh, sw,
        row_pitch(p), c_p, plan.tile_n, plan.split, plan.grid,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check_launch(err, "conv3d_k4s2_wgrad")
    launches.bump("conv3d_k4s2_wgrad")
    return out


def conv3d_k4s2_wgrad(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of the convolution with kernel 4, stride 2,
    padding 1, (Cp, 4, 4, 4, Cg): ``out[n, k, c] = Σ_o p[o, n] · g[2o − 1 + k,
    c]`` over the voxels o of the small side (B, Do, Ho, Wo) of ``g`` (B, D,
    H, W, Cg), taps in the padding reading 0. ``Downsample``: p = dy, g = x,
    the (Cout, Cin, 4, 4, 4) gradient's channels_last_3d layout; the
    transposed ``Upsample``: p = x, g = dy, its (Cin, Cout, 4, 4, 4). A CUDA
    tensor launches the kernel (bf16 only; anything else raises), a CPU
    tensor gets the plain version."""
    if not g.is_cuda:
        return conv3d_k4s2_wgrad_reference(p, g)
    _check_wgrad(p, g)
    with torch.cuda.device(g.device):
        return _launch_wgrad(p, g)


# ------------------------------------------------------------- custom op


@torch.library.custom_op("mrijax_torch::conv3d_k4s2", mutates_args=(), device_types="cpu")
def conv3d_k4s2_op(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``conv3d_k4s2`` as a custom op: the plain version on the CPU, the
    kernel on CUDA."""
    return conv3d_k4s2_reference(x, weight, bias)


@conv3d_k4s2_op.register_kernel("cuda")
def _(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return conv3d_k4s2(x, weight, bias)


@conv3d_k4s2_op.register_fake
def _(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return x.new_empty((x.shape[0], *output_spatial(x.shape[1:4]), weight.shape[0]))


# ------------------------------------------------------- autograd functions


def _channels_first(t: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) → its (B, C, D, H, W) view."""
    return t.permute(0, 4, 1, 2, 3)


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) → its (B, D, H, W, C) view."""
    return t.permute(0, 2, 3, 4, 1)


def _library_gradients(dy, x, weight, has_bias: bool, transposed: bool, mask):
    """``aten.convolution_backward`` on the channels-first views, the call
    autograd makes for ``F.conv3d`` / ``F.conv_transpose3d``; ``mask``: the
    (input, weight, bias) gradients wanted."""
    return torch.ops.aten.convolution_backward(
        _channels_first(dy), _channels_first(x), weight,
        [weight.shape[1 if transposed else 0]] if has_bias else None, [STRIDE] * 3,
        [PADDING] * 3, [1] * 3, transposed, [0] * 3, 1, mask)


def _weight_gradient(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``conv3d_k4s2_wgrad`` as the weight's (Cp, Cg, 4, 4, 4) view, its
    CUDA operands made readable by the kernel where they are not."""
    if p.is_cuda:
        p = p if row_pitch(p) else p.contiguous()
        g = g if kernel_reads(g) else g.contiguous()
    return conv3d_k4s2_wgrad(p, g).permute(0, 4, 1, 2, 3)


class _Downsample3D(torch.autograd.Function):
    """Forward: the kernel. Backward: the weight gradient by the weight
    kernel (dy by x gathered), the input and bias gradients by
    ``convolution_backward``, as autograd computes them for ``F.conv3d``."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return conv3d_k4s2(x, weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        need_b = need_b and ctx.has_bias
        gx = gw = gb = None
        if need_w:
            gw = _weight_gradient(dy, x)
        if need_x or need_b:
            gx, _, gb = _library_gradients(dy, x, weight, ctx.has_bias, False,
                                           [need_x, False, need_b])
        return _channels_last(gx) if need_x else None, gw, gb


def conv_transpose3d_k4s2(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The library's transposed convolution (kernel 4, stride 2, padding 1)
    of a channels-last (B, D, H, W, Cin) input by a (Cin, Cout, 4, 4, 4)
    weight, on the channels-first view, as (B, 2D, 2H, 2W, Cout)."""
    y = F.conv_transpose3d(_channels_first(x), weight, bias, STRIDE, PADDING)
    return _channels_last(y).contiguous()


class _Upsample3D(torch.autograd.Function):
    """Forward: the library's transposed convolution. Backward: the input
    gradient by the kernel (the convolution of dy by the same weight), the
    weight gradient by the weight kernel (x by dy gathered), the bias
    gradient by ``convolution_backward``."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return conv_transpose3d_k4s2(x, weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        gx = gw = gb = None
        if need_x:
            gx = conv3d_k4s2(dy if kernel_reads(dy) or not dy.is_cuda else dy.contiguous(),
                             weight)
        if need_w:
            gw = _weight_gradient(x, dy)
        if need_b and ctx.has_bias:
            _, _, gb = _library_gradients(dy, x, weight, True, True, [False, False, True])
        return gx, gw, gb


def _records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def downsample(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Downsample``'s convolution on a channels-last input, differentiable:
    the kernel forward (or its plain version on the CPU, or the custom op
    while exporting), and the weight gradient by the weight kernel."""
    if _records_grad(x, weight, bias) and not torch.compiler.is_exporting():
        return _Downsample3D.apply(x, weight, bias)
    return conv3d_k4s2(x, weight, bias)


def upsample(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Upsample``'s transposed convolution on a channels-last input: the
    library's forward; where a gradient is recorded, the input gradient by
    the kernel and the weight gradient by the weight kernel."""
    if _records_grad(x, weight, bias) and not torch.compiler.is_exporting():
        return _Upsample3D.apply(x, weight, bias)
    return conv_transpose3d_k4s2(x, weight, bias)
