"""DiT-XL/2 lifted to 3D latents: a transformer denoiser over the VAE3D latent.

Peebles & Xie, "Scalable Diffusion Models with Transformers" (ICCV 2023,
arXiv:2212.09748), ``github.com/facebookresearch/DiT`` ``models.py``. The
module takes ``UNet3D``'s contract: ``forward(x, t)`` with x (B, D, H, W, C)
channels-last and t (B,) integer steps returns ε (B, D, H, W, C) in float32,
so the samplers and train steps take it unchanged.

* Patch embed: each p×p×p patch of C channels flattened in (pd, ph, pw, c)
  order and mapped by one linear p³·C → hidden (DiT's stride-p convolution).
* Position table: fixed; token (d, h, w), in row-major order, gets
  ``concat(sc(d), sc(h), sc(w))`` with ``sc(pos) = concat(sin(pos·ω),
  cos(pos·ω))``, ω_i = 10000^(−i/(k/2)) over k = hidden/3 channels.
* Timestep embedder: ``concat(cos(t·f), sin(t·f))``, f_i = exp(−ln(10⁴)·i/
  (F/2)) over F = ``freq_dim``, then Linear → SiLU → Linear; c = t_emb.
* ``depth`` adaLN-Zero blocks: ``(shift₁, scale₁, gate₁, shift₂, scale₂,
  gate₂) = Linear(SiLU(c)).chunk(6)``; ``x += gate₁·Attn(LN(x)·(1 + scale₁)
  + shift₁)``; ``x += gate₂·MLP(LN(x)·(1 + scale₂) + shift₂)``. LN has no
  affine and eps 1e-6; qkv is one linear with a bias; the MLP is Linear →
  GELU(tanh) → Linear.
* Final layer: adaLN (shift, scale), Linear(hidden, p³·C), unpatchify.

The linears compute in ``dtype`` (bf16 on the card) with their parameters in
``param_dtype`` (``models.blocks.Linear``); LayerNorm statistics, the
modulation and the residual stream are float32, as DiT's own mixed-precision
training keeps them. The attention core is
``kernels.flash_attention.flash_attention`` on strided q, k, v views of the
fused projection, as ``AttentionBlock3D`` runs it: the hand-written kernel on
the card (a head dim the kernels do not take, 72 in DiT-XL/2, is zero-padded
to the next one they do), its plain version on the CPU.

Departures from DiT, each forced by the data: the 3D patch and position
table; no class embedder (BraTS volumes carry no label); ε only, no learned
Σ (the port's samplers and losses predict ε). ``remat`` recomputes each block
in the backward pass (``torch.utils.checkpoint``, non-reentrant).

Spans (``obs.profiling.span``, recorded only while a profiler records, each
timing the stream): ``dit.msa`` (LN, modulate, qkv, the attention core, proj
and the gated residual), ``dit.flash`` (the attention core alone, with the
head-dim pad and cut copies) and ``dit.mlp`` (LN, modulate, fc1, GELU, fc2
and the gated residual); ``SPANS`` names them.
"""

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mrijax_torch.kernels.flash_attention import flash_attention
from mrijax_torch.models.blocks import Linear
from mrijax_torch.obs.profiling import span

SPANS = ("dit.msa", "dit.flash", "dit.mlp")
LN_EPS = 1e-6


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """DiT's frequency embedding of ``t`` (B,): (B, dim) float32,
    ``concat(cos(t·f), sin(t·f))`` (cos first, unlike
    ``ops.embeddings``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def _sincos(pos: torch.Tensor, k: int) -> torch.Tensor:
    omega = 1.0 / 10000.0 ** (torch.arange(k // 2, dtype=torch.float64) / (k // 2))
    ang = pos.double()[:, None] * omega[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def position_table(grid: Tuple[int, int, int], hidden: int) -> torch.Tensor:
    """The fixed (d·h·w, hidden) float32 table of a token grid, row-major."""
    if hidden % 6:
        raise ValueError(f"hidden {hidden} must divide by 6 for the 3D position table")
    k = hidden // 3
    d, h, w = (torch.arange(n) for n in grid)
    dd, hh, ww = torch.meshgrid(d, h, w, indexing="ij")
    return torch.cat([_sincos(a.reshape(-1), k) for a in (dd, hh, ww)], dim=-1).float()


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, D, H, W, C) → (B, D/p·H/p·W/p, p³·C), patches in (pd, ph, pw, c)
    order."""
    b, d, h, w, c = x.shape
    if d % p or h % p or w % p:
        raise ValueError(f"latent {tuple(x.shape[1:4])} does not divide into patches of {p}")
    x = x.reshape(b, d // p, p, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, (d // p) * (h // p) * (w // p),
                                                     p ** 3 * c)


def unpatchify(x: torch.Tensor, grid: Tuple[int, int, int], p: int) -> torch.Tensor:
    """The inverse of ``patchify``: (B, N, p³·C) → (B, D, H, W, C)."""
    b, gd, gh, gw = x.shape[0], *grid
    c = x.shape[-1] // p ** 3
    x = x.reshape(b, gd, gh, gw, p, p, p, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, gd * p, gh * p, gw * p, c)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), eps=LN_EPS)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]


class TimestepEmbedder(nn.Module):
    """Frequency embedding → Linear → SiLU → Linear (``mlp.0``, ``mlp.2``)."""

    def __init__(self, hidden: int, freq_dim: int = 256, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.freq_dim, self.dtype = freq_dim, dtype
        self.mlp = nn.Sequential(Linear(freq_dim, hidden, dtype, param_dtype), nn.SiLU(),
                                 Linear(hidden, hidden, dtype, param_dtype))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, self.freq_dim).to(self.dtype))


class Attention(nn.Module):
    """qkv (one linear with a bias) → multi-head attention over all tokens →
    proj."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype]):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} not divisible by heads {heads}")
        self.heads = heads
        self.qkv = Linear(hidden, 3 * hidden, dtype, param_dtype)
        self.proj = Linear(hidden, hidden, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads)
        with span("dit.flash", stream=True):
            # strided views of the fused projection, as AttentionBlock3D hands them over
            out = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out.reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, hidden: int, inner: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype]):
        super().__init__()
        self.fc1 = Linear(hidden, inner, dtype, param_dtype)
        self.fc2 = Linear(inner, hidden, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """One adaLN-Zero block on a float32 residual stream (B, N, hidden)."""

    def __init__(self, hidden: int, heads: int, mlp_ratio: float, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = dtype
        self.attn = Attention(hidden, heads, dtype, param_dtype)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio), dtype, param_dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              Linear(hidden, 6 * hidden, dtype, param_dtype))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        mod = self.adaLN_modulation(c).float().chunk(6, dim=1)
        shift1, scale1, gate1, shift2, scale2, gate2 = mod
        with span("dit.msa", stream=True):
            h = self.attn(_modulate(x, shift1, scale1).to(self.dtype))
            x = x + gate1[:, None] * h.float()
        with span("dit.mlp", stream=True):
            h = self.mlp(_modulate(x, shift2, scale2).to(self.dtype))
            x = x + gate2[:, None] * h.float()
        return x


class FinalLayer(nn.Module):
    """adaLN (shift, scale) → Linear(hidden, p³·C)."""

    def __init__(self, hidden: int, out: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = dtype
        self.linear = Linear(hidden, out, dtype, param_dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              Linear(hidden, 2 * hidden, dtype, param_dtype))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).float().chunk(2, dim=1)
        return self.linear(_modulate(x, shift, scale).to(self.dtype))


class DiT3D(nn.Module):
    def __init__(
        self,
        in_channels: int = 16,
        patch: int = 2,
        hidden: int = 1152,
        depth: int = 28,
        heads: int = 16,
        mlp_ratio: float = 4.0,
        freq_dim: int = 256,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        param_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if hidden % 6:
            raise ValueError(f"hidden {hidden} must divide by 6 for the 3D position table")
        self.in_channels, self.patch, self.hidden = in_channels, patch, hidden
        self.remat, self.dtype = remat, dtype
        self.x_embedder = Linear(patch ** 3 * in_channels, hidden, dtype, param_dtype)
        self.t_embedder = TimestepEmbedder(hidden, freq_dim, dtype, param_dtype)
        self.blocks = nn.ModuleList(DiTBlock(hidden, heads, mlp_ratio, dtype, param_dtype)
                                    for _ in range(depth))
        self.final_layer = FinalLayer(hidden, patch ** 3 * in_channels, dtype, param_dtype)
        self._tables: Dict[tuple, torch.Tensor] = {}

    def _position_table(self, grid: Tuple[int, int, int], device: torch.device) -> torch.Tensor:
        key = (grid, str(device))
        if key not in self._tables:
            self._tables[key] = position_table(grid, self.hidden).to(device)
        return self._tables[key]

    def _block(self, block: DiTBlock, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            # the blocks draw no random numbers: no generator state to carry
            return checkpoint(block, x, c, use_reentrant=False, preserve_rng_state=False)
        return block(x, c)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, C) latent, t: (B,) integer timesteps → predicted
        noise (B, D, H, W, C) in float32."""
        p = self.patch
        grid = tuple(n // p for n in x.shape[1:4])
        h = self.x_embedder(patchify(x.to(self.dtype), p)).float()
        h = h + self._position_table(grid, h.device)
        c = self.t_embedder(t)
        for block in self.blocks:
            h = self._block(block, h, c)
        return unpatchify(self.final_layer(h, c), grid, p).float()
