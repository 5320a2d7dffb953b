"""Shared building blocks of the 2D and 3D models, as ``nn.Module``s.

Counterpart of ``mrijax/models/blocks.py``. Every module takes and returns
channels-last activations, ``(B, H, W, C)`` or ``(B, D, H, W, C)``, the layout
of the JAX package. ``nn.Conv2d`` / ``nn.Conv3d`` want channels first: the
convolutions here run on a permuted *view* of the channels-last buffer, which
is exactly a ``torch.channels_last`` / ``channels_last_3d`` tensor, so no copy
is made and the GroupNorm+SiLU kernel sees a contiguous ``(B, N, C)`` buffer.

Module and parameter names follow the reference PyTorch layout (3D:
``norm1``, ``conv1``, ``time_mlp``, ``norm2``, ``conv2``, ``skip``; ``norm``,
``qkv``, ``proj``; 2D: ``conv1``, ``norm1``, ``time_mlp``, ``conv2``,
``norm2``, ``res_conv``), which ``mrijax_torch.io.flax_convert`` maps flax
trees onto and reference checkpoints load into.

Parity notes (math, not code):
* 2D res blocks use conv→norm→act ordering and apply SiLU to the
  conditioning projection before the broadcast add.
* 3D res blocks use norm→act→conv (pre-activation) ordering and add the
  time projection without an activation.
* GroupNorm(8) with eps 1e-5 everywhere.
* Downsample: 4-kernel stride-2 conv, padding 1. Upsample: 4-kernel stride-2
  transposed conv, padding 1 (output = 2× input spatially; flax's
  ``padding="SAME"``).

The 3D ``Downsample`` forward, the ``Upsample`` input gradient and both
modules' weight gradients run the port's own tensor-core kernels on bfloat16
(``kernels/conv3d.py``), chosen by the input's dtype; every other
convolution, the ``Downsample`` input gradient, the bias gradients, and the
2D modules, are cuDNN's.

Precision follows the flax modules: convolutions and linears compute in
``dtype`` (bf16 on the card) and hold their parameters in ``param_dtype``,
cast to ``dtype`` inside ``forward`` so that the gradient flows back through
the cast into a ``param_dtype`` ``.grad``. Training builds with float32
parameters (flax's default, the master weights Adam updates); with
``param_dtype=None`` the parameters are held in ``dtype`` itself, which gives
the same numbers when sampling and halves the weights' memory. GroupNorm
affine parameters and statistics are always float32.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mrijax_torch.kernels import conv3d
from mrijax_torch.kernels.flash_attention import flash_attention
from mrijax_torch.obs.profiling import span
from mrijax_torch.ops.attention import multi_head_self_attention
from mrijax_torch.ops.embeddings import sinusoidal_time_embedding
from mrijax_torch.ops.norms import group_norm, group_norm_silu_auto
from mrijax_torch.parallel.sequence import sequence_parallel_attention


def _channels_last_call(conv_forward, x: torch.Tensor) -> torch.Tensor:
    """Run a channels-first 2D or 3D operation on a channels-last tensor.

    ``x`` is (B, *spatial, C) contiguous; its permutation to (B, C, *spatial)
    is a ``channels_last`` (2D) or ``channels_last_3d`` view. The backend
    answers in the same memory format, so permuting back is again a view;
    ``contiguous()`` is then a no-op and only copies if a backend answered
    channels-first.
    """
    n = x.dim()
    y = conv_forward(x.permute(0, n - 1, *range(1, n - 1)))
    return y.permute(0, *range(2, n), 1).contiguous()


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """A parameter in the compute dtype: itself when it is held in it."""
    return p if p is None or p.dtype == dtype else p.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` with parameters held in
    ``param_dtype`` (``None``: in ``dtype``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, self.compute_dtype),
                        _cast(self.bias, self.compute_dtype))


class _Conv:
    """A convolution on channels-last activations that computes in ``dtype``
    with parameters held in ``param_dtype`` (``None``: in ``dtype``)."""

    span_name = "conv"

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(self.span_name):
            weight = _cast(self.weight, self.compute_dtype)
            bias = _cast(self.bias, self.compute_dtype)
            return _channels_last_call(lambda t: self._conv_forward(t, weight, bias), x)


class Conv3d(_Conv, nn.Conv3d):
    """``nn.Conv3d`` on channels-last (B, D, H, W, C) activations."""


class Conv2d(_Conv, nn.Conv2d):
    """``nn.Conv2d`` on channels-last (B, H, W, C) activations."""


class _Downsample:
    """4-kernel stride-2 conv, padding 1 (halves each spatial dim)."""

    span_name = "conv.down"

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, 4, stride=2, padding=1, dtype=dtype,
                         param_dtype=param_dtype)


class Downsample(_Downsample, Conv3d):
    """A bfloat16 input goes through the hand-written tensor-core kernel
    (``kernels/conv3d.py``), its weight gradient through the weight kernel
    (the input and bias gradients stay the library's), any other dtype
    through cuDNN as ``Conv3d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        with span(self.span_name):
            return conv3d.downsample(x, _cast(self.weight, self.compute_dtype),
                                     _cast(self.bias, self.compute_dtype))


class Downsample2D(_Downsample, Conv2d):
    pass


class _Upsample:
    """4-kernel stride-2 transposed conv, padding 1 (doubles each spatial dim)."""

    span_name = "conv.up"

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, 4, stride=2, padding=1,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(self.span_name):
            weight = _cast(self.weight, self.compute_dtype)
            bias = _cast(self.bias, self.compute_dtype)
            return _channels_last_call(
                lambda t: self._transpose(t, weight, bias, self.stride, self.padding), x)


class Upsample(_Upsample, nn.ConvTranspose3d):
    """The forward is cuDNN's. For a bfloat16 input whose gradient is
    recorded, the input and weight gradients go through the hand-written
    tensor-core kernels (``kernels/conv3d.py``; the bias gradient stays the
    library's)."""

    _transpose = staticmethod(F.conv_transpose3d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        with span(self.span_name):
            return conv3d.upsample(x, _cast(self.weight, self.compute_dtype),
                                   _cast(self.bias, self.compute_dtype))


class Upsample2D(_Upsample, nn.ConvTranspose2d):
    _transpose = staticmethod(F.conv_transpose2d)


class GroupNorm(nn.Module):
    """GroupNorm over channels-last input; stats in fp32, affine params fp32."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.groups, self.weight, self.bias, self.eps)


class GroupNormSiLU(GroupNorm):
    """Fused GroupNorm→SiLU (the norm→act pair in every res block / head):
    the hand-written CUDA kernels for a CUDA tensor, their plain version for
    a CPU tensor (``mrijax_torch.kernels.groupnorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu_auto(x, self.groups, self.weight, self.bias, self.eps)


class _SinusoidalEmbedding(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dim = dim
        self.dtype = dtype

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        # fp32 embedding, then cast to the compute dtype
        return sinusoidal_time_embedding(t, self.dim).to(self.dtype)


class TimeEmbedding(nn.Sequential):
    """SinusoidalPosEmb → Linear(4d) → SiLU → Linear(d); the linears sit at
    indices 1 and 3 as in the reference layout (``time_mlp.1``, ``time_mlp.3``)."""

    def __init__(self, dim: int = 256, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(
            _SinusoidalEmbedding(dim, dtype),
            Linear(dim, dim * 4, dtype, param_dtype),
            nn.SiLU(),
            Linear(dim * 4, dim, dtype, param_dtype),
        )


class ScalarCondEmbedding(nn.Sequential):
    """Linear(4d) → SiLU → Linear(d) on a scalar condition (the slice position
    z); the linears sit at indices 0 and 2 as in the reference layout
    (``slice_mlp.0``, ``slice_mlp.2``)."""

    def __init__(self, dim: int = 256, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(
            Linear(1, dim * 4, dtype, param_dtype),
            nn.SiLU(),
            Linear(dim * 4, dim, dtype, param_dtype),
        )
        self.compute_dtype = dtype

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        # z is cast to the compute dtype before the first linear, as flax
        # casts it: in bf16 that rounds the slice position
        return super().forward(z.to(self.compute_dtype)[:, None])


class ResBlock2D(nn.Module):
    """conv3×3 → GN → SiLU → (+ SiLU(Linear(cond))) → conv3×3 → GN → SiLU →
    + skip (a 1×1 ``res_conv`` where the channel count changes)."""

    def __init__(self, in_ch: int, out_ch: int, cond_dim: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, **kw)
        self.norm1 = GroupNormSiLU(out_ch, groups)
        self.time_mlp = Linear(cond_dim, out_ch, **kw)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, **kw)
        self.norm2 = GroupNormSiLU(out_ch, groups)
        if in_ch != out_ch:
            self.res_conv = Conv2d(in_ch, out_ch, 1, **kw)

    def forward(self, x: torch.Tensor, cond_emb: torch.Tensor) -> torch.Tensor:
        h = self.norm1(self.conv1(x))
        h = h + F.silu(self.time_mlp(cond_emb))[:, None, None, :]
        h = self.norm2(self.conv2(h))
        if hasattr(self, "res_conv"):
            x = self.res_conv(x)
        return h + x


class ResBlock3D(nn.Module):
    """Pre-activation 3D res block, optional time conditioning
    (``time_emb_dim=None`` is the VAE's no-time variant)."""

    def __init__(self, in_ch: int, out_ch: int, time_emb_dim: Optional[int] = None,
                 groups: int = 8, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.norm1 = GroupNormSiLU(in_ch, groups)
        self.conv1 = Conv3d(in_ch, out_ch, 3, padding=1, **kw)
        if time_emb_dim is not None:
            self.time_mlp = Linear(time_emb_dim, out_ch, **kw)
        self.norm2 = GroupNormSiLU(out_ch, groups)
        self.conv2 = Conv3d(out_ch, out_ch, 3, padding=1, **kw)
        if in_ch != out_ch:
            self.skip = Conv3d(in_ch, out_ch, 1, **kw)

    def forward(self, x: torch.Tensor,
                cond_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if cond_emb is not None:
            h = h + self.time_mlp(cond_emb)[:, None, None, None, :]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return h + x


class AttentionBlock3D(nn.Module):
    """GN → qkv → multi-head attention over all D·H·W tokens → proj →
    residual. On channels-last tensors the 1×1×1 convs of the reference are
    linears over the channel axis. ``use_flash`` routes the softmax(qkᵀ)v core
    through ``mrijax_torch.kernels.flash_attention`` (the hand-written kernel
    on CUDA); otherwise the plain materialised attention runs. With
    ``sp_axis`` and ``mesh`` the token axis' work is split over that mesh
    axis (``parallel.sequence.sequence_parallel_attention``, the flash
    kernels on N/d query rows against all N keys)."""

    def __init__(self, channels: int, num_heads: int = 4, groups: int = 8,
                 dtype: torch.dtype = torch.float32, use_flash: bool = True,
                 param_dtype: Optional[torch.dtype] = None,
                 sp_axis: Optional[str] = None, mesh=None):
        super().__init__()
        if channels % num_heads != 0:
            raise ValueError(f"channels {channels} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.sp_axis, self.mesh = sp_axis, mesh
        self.norm = GroupNorm(channels, groups)
        self.qkv = Linear(channels, 3 * channels, dtype, param_dtype)
        self.proj = Linear(channels, channels, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        hd = c // self.num_heads
        h = self.norm(x)
        qkv = self.qkv(h).reshape(b, -1, 3, self.num_heads, hd)  # (B, N, 3, H, Dh)
        # strided views of the fused projection; the flash kernel reads them as they are
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.sp_axis is not None and self.mesh is not None:
            out = sequence_parallel_attention(q, k, v, mesh=self.mesh, axis=self.sp_axis)
        else:
            attend = flash_attention if self.use_flash else multi_head_self_attention
            out = attend(q, k, v)
        out = out.reshape(x.shape)
        return x + self.proj(out)
