"""Shared building blocks of the 3D models, as ``nn.Module``s.

Counterpart of ``mrijax/models/blocks.py`` (3D blocks). Every module takes
and returns channels-last activations ``(B, D, H, W, C)``, the layout of the
JAX package. ``nn.Conv3d`` wants ``(B, C, D, H, W)``: the convolutions here
run on a permuted *view* of the channels-last buffer, which is exactly a
``torch.channels_last_3d`` tensor, so no copy is made and the GroupNorm+SiLU
kernel sees a contiguous ``(B, N, C)`` buffer.

Module and parameter names follow the reference PyTorch layout (``norm1``,
``conv1``, ``time_mlp``, ``norm2``, ``conv2``, ``skip``; ``norm``, ``qkv``,
``proj``), which ``mrijax_torch.io.flax_convert`` maps flax trees onto.

Parity notes (math, not code):
* 3D res blocks use norm→act→conv (pre-activation) ordering and add the
  time projection without an activation.
* GroupNorm(8) with eps 1e-5 everywhere.
* Downsample: 4-kernel stride-2 conv, padding 1. Upsample: 4-kernel stride-2
  transposed conv, padding 1 (output = 2× input spatially).

Precision follows the flax modules: convolutions and linears hold their
parameters and compute in ``dtype`` (bf16 on the card), GroupNorm affine
parameters and statistics stay float32.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mrijax_torch.kernels.flash_attention import flash_attention
from mrijax_torch.ops.attention import multi_head_self_attention
from mrijax_torch.ops.embeddings import sinusoidal_time_embedding
from mrijax_torch.ops.norms import group_norm, group_norm_silu_auto


def _channels_last_call(conv_forward, x: torch.Tensor) -> torch.Tensor:
    """Run a channels-first 3D convolution on a channels-last tensor.

    ``x`` is (B, D, H, W, C) contiguous; its permutation to (B, C, D, H, W) is
    a ``channels_last_3d`` view. The backend answers in the same memory
    format, so permuting back is again a view; ``contiguous()`` is then a
    no-op and only copies if a backend answered channels-first.
    """
    y = conv_forward(x.permute(0, 4, 1, 2, 3))
    return y.permute(0, 2, 3, 4, 1).contiguous()


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` on channels-last (B, D, H, W, C) activations."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _channels_last_call(super().forward, x)


class Downsample(nn.Conv3d):
    """4-kernel stride-2 conv, padding 1 (halves each spatial dim)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 4, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _channels_last_call(super().forward, x)


class Upsample(nn.ConvTranspose3d):
    """4-kernel stride-2 transposed conv, padding 1 (doubles each spatial dim)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 4, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _channels_last_call(super().forward, x)


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

    def __init__(self, dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__(
            _SinusoidalEmbedding(dim, dtype),
            nn.Linear(dim, dim * 4, dtype=dtype),
            nn.SiLU(),
            nn.Linear(dim * 4, dim, dtype=dtype),
        )


class ResBlock3D(nn.Module):
    """Pre-activation 3D res block, optional time conditioning
    (``time_emb_dim=None`` is the VAE's no-time variant)."""

    def __init__(self, in_ch: int, out_ch: int, time_emb_dim: Optional[int] = None,
                 groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_ch, groups)
        self.conv1 = Conv3d(in_ch, out_ch, 3, padding=1, dtype=dtype)
        if time_emb_dim is not None:
            self.time_mlp = nn.Linear(time_emb_dim, out_ch, dtype=dtype)
        self.norm2 = GroupNormSiLU(out_ch, groups)
        self.conv2 = Conv3d(out_ch, out_ch, 3, padding=1, dtype=dtype)
        if in_ch != out_ch:
            self.skip = Conv3d(in_ch, out_ch, 1, dtype=dtype)

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
    on CUDA); otherwise the plain materialised attention runs."""

    def __init__(self, channels: int, num_heads: int = 4, groups: int = 8,
                 dtype: torch.dtype = torch.float32, use_flash: bool = True):
        super().__init__()
        if channels % num_heads != 0:
            raise ValueError(f"channels {channels} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.norm = GroupNorm(channels, groups)
        self.qkv = nn.Linear(channels, 3 * channels, dtype=dtype)
        self.proj = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        hd = c // self.num_heads
        h = self.norm(x)
        qkv = self.qkv(h).reshape(b, -1, 3, self.num_heads, hd)  # (B, N, 3, H, Dh)
        # strided views of the fused projection; the flash kernel reads them as they are
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attend = flash_attention if self.use_flash else multi_head_self_attention
        out = attend(q, k, v).reshape(x.shape)
        return x + self.proj(out)
