"""3D convolution with kernel 4, stride 2 and padding 1 on channels-last
bfloat16 activations, on the tensor cores.

Replaces no TPU kernel: the JAX package leaves this convolution to XLA. The
port left it to cuDNN, which has no tensor-core engine for it in 3D, and its
CUDA-core engine took half of a 3D DDIM step (PERF.md). One hand-written CUDA
kernel (``mrijax_torch/csrc/conv3d_k4s2.cu``, an implicit GEMM on ``wgmma``)
computes it at two places of the 3D models (``models/blocks.py``):

* the forward of ``Downsample`` (``_Downsample3D``, whose backward is the
  library's ``convolution_backward``, as autograd's is);
* the input gradient of ``Upsample`` (``_Upsample3D``, whose forward stays
  the library's transposed convolution): the input gradient of a transposed
  convolution with kernel 4, stride 2 and padding 1 is this convolution of
  the output gradient with the same weight, read as (in, out) channels, no
  flip. Its weight and bias gradients stay the library's.

``conv3d_k4s2`` launches the kernel for a CUDA tensor or raises; a CPU
tensor gets the plain version ``conv3d_k4s2_reference`` (explicit im2col in
the kernel's K order, then one matmul with fp32 accumulation), which the
tests and ``chip_smoke.py`` hold the kernel against. The op is also the
``torch.library`` custom op ``torch.ops.mrijax_torch.conv3d_k4s2`` (a fake
implementation gives ``torch.export`` its shape), taken only while
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

launches = _build.LaunchCounts("conv3d_k4s2")

KERNEL, STRIDE, PADDING = 4, 2, 1
TAPS = KERNEL ** 3
TILE_M = 128               # output voxels a tile (csrc BM)
TILE_N = (64, 128, 256)    # output channels a tile the kernel is compiled for
SM_COUNT = 132             # streaming multiprocessors of an H100
_MAX_ROWS = 2 ** 31 - 1 - TILE_M   # M in int32, with a tile to spare


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


def _library() -> ctypes.CDLL:
    lib = _build.library("conv3d_k4s2")
    if lib.conv3d_k4s2.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conv3d_k4s2.argtypes = [p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, i, i, i, p]
        lib.conv3d_k4s2.restype = i
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


class _Downsample3D(torch.autograd.Function):
    """Forward: the kernel. Backward: ``convolution_backward`` for all three
    gradients, as autograd computes them for ``F.conv3d``."""

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
        gx, gw, gb = _library_gradients(dy, x, weight, ctx.has_bias, False,
                                        [need_x, need_w, need_b and ctx.has_bias])
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
    weight and bias gradients by ``convolution_backward``."""

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
        if need_w or (need_b and ctx.has_bias):
            _, gw, gb = _library_gradients(dy, x, weight, ctx.has_bias, True,
                                           [False, need_w, need_b and ctx.has_bias])
        return gx, gw, gb


def _records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def downsample(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Downsample``'s convolution on a channels-last input, differentiable:
    the kernel forward (or its plain version on the CPU, or the custom op
    while exporting)."""
    if _records_grad(x, weight, bias) and not torch.compiler.is_exporting():
        return _Downsample3D.apply(x, weight, bias)
    return conv3d_k4s2(x, weight, bias)


def upsample(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Upsample``'s transposed convolution on a channels-last input: the
    library's forward; where a gradient is recorded, the input gradient by
    the kernel."""
    if _records_grad(x, weight, bias) and not torch.compiler.is_exporting():
        return _Upsample3D.apply(x, weight, bias)
    return conv_transpose3d_k4s2(x, weight, bias)
