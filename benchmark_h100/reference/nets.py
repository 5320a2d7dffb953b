"""Plain float32 forward passes of the two configurations' networks.

Written from the equations of the models of NickB42/mri-image-generation
(``model_scripts/ddpm_3d_ldm/{unet_attention.py,vae.py}`` and
``model_scripts/slice_cond_2d_ddpm/unet.py``) and their parameter layout, the
layout whose names the benchmark's weights use. Every function takes the
parameters as a dict of tensors by name and computes channels-first with
``torch.nn.functional``; inputs and outputs are channels-last, as the
program hands them over. Nothing here imports the program.

* GroupNorm: 8 groups, eps 1e-5, statistics over each group's channels and
  all positions.
* 3D res block (pre-activation): conv3(SiLU(GN(x))) + Linear(t_emb), then
  conv3(SiLU(GN(h))), plus x (a 1×1×1 ``skip`` where the channels change).
* 2D res block: SiLU(GN(conv3(x))) + SiLU(Linear(cond)), then
  SiLU(GN(conv3(h))), plus x (a 1×1 ``res_conv`` where the channels change).
* Downsample: kernel 4, stride 2, padding 1. Upsample: the transposed one.
* Attention (3D bottleneck): GN, one linear to q, k, v over the channels,
  softmax(q·kᵀ/√Dh)·v over all D·H·W tokens a head, a linear, plus x.
* Time embedding: [sin, cos] of t·exp(−k·ln(10⁴)/(d/2 − 1)), Linear(4d),
  SiLU, Linear(d). The 2D slice position z: Linear(4d), SiLU, Linear(d),
  added to the time embedding.
* UNet3D: per level two res blocks, skip, stride-2 conv (not at the last
  level); res, attention, res; per level up (transposed conv, not at the
  deepest level), concatenation [h, skip], two res blocks; SiLU(GN), conv3.
* UNet2D: as UNet3D with 2D blocks, the skip taken after each level's two
  res blocks, no attention; a bilinear resize where an up-path shape
  differs from its skip's (none at the sizes of the cells).
* VAE3D decoder: conv3 from the latent, then the res blocks and upsamples of
  ``decoder.ups`` in order (no time embedding), conv3 to the modalities.

Departures: none in the equations. The program computes in bfloat16 and
rounds the 2D slice position to bfloat16 before its first linear; the
reference computes everything in float32 with TF32 off (the caller sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False).

``prec="fp8"`` is the control: every convolution, linear and attention
product takes its operands rounded to scaled float8 (``lowp.quantize``).

Each layer reports itself to ``count.ops``'s active tally, which is how the
benchmark counts the model's operations (run on the meta device).
"""

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark_h100.count import ops
from benchmark_h100.reference.lowp import quantize

Params = Dict[str, torch.Tensor]


def _q(x: torch.Tensor, prec: str) -> torch.Tensor:
    return quantize(x) if prec == "fp8" else x


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1, pad: int = 0,
         prec: str = "fp32") -> torch.Tensor:
    w, b = p[name + ".weight"], p.get(name + ".bias")
    f = F.conv3d if x.dim() == 5 else F.conv2d
    y = f(_q(x, prec), _q(w, prec), b, stride, pad)
    ops.add_conv(x.shape, y.shape, w.shape, stride, pad, False, b is not None)
    return y


def conv_up(p: Params, name: str, x: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """Kernel 4, stride 2, padding 1, transposed: doubles each spatial size."""
    w, b = p[name + ".weight"], p.get(name + ".bias")
    f = F.conv_transpose3d if x.dim() == 5 else F.conv_transpose2d
    y = f(_q(x, prec), _q(w, prec), b, 2, 1)
    ops.add_conv(x.shape, y.shape, w.shape, 2, 1, True, b is not None)
    return y


def linear(p: Params, name: str, x: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    w, b = p[name + ".weight"], p.get(name + ".bias")
    y = F.linear(_q(x, prec), _q(w, prec), b)
    ops.add_linear(x.numel() // x.shape[-1], w.shape[1], w.shape[0], b is not None)
    return y


def group_norm(p: Params, name: str, x: torch.Tensor, silu: bool) -> torch.Tensor:
    y = F.group_norm(x, 8, p[name + ".weight"], p[name + ".bias"], 1e-5)
    if silu:
        ops.add_gn_silu(x.numel())
        y = F.silu(y)
    return y


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mlp(p: Params, first: str, second: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    return linear(p, second, F.silu(linear(p, first, x, prec)), prec)


def _spatial(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B, C) vector broadcast over the spatial axes of ``x``."""
    return y.reshape(*y.shape, *([1] * (x.dim() - 2)))


def res3d(p: Params, name: str, x: torch.Tensor, temb: Optional[torch.Tensor],
          prec: str) -> torch.Tensor:
    h = conv(p, name + ".conv1", group_norm(p, name + ".norm1", x, True), 1, 1, prec)
    if temb is not None:
        h = h + _spatial(linear(p, name + ".time_mlp", temb, prec), h)
    h = conv(p, name + ".conv2", group_norm(p, name + ".norm2", h, True), 1, 1, prec)
    if name + ".skip.weight" in p:
        x = conv(p, name + ".skip", x, prec=prec)
    return h + x


def res2d(p: Params, name: str, x: torch.Tensor, cond: torch.Tensor,
          prec: str) -> torch.Tensor:
    h = group_norm(p, name + ".norm1", conv(p, name + ".conv1", x, 1, 1, prec), True)
    h = h + _spatial(F.silu(linear(p, name + ".time_mlp", cond, prec)), h)
    h = group_norm(p, name + ".norm2", conv(p, name + ".conv2", h, 1, 1, prec), True)
    if name + ".res_conv.weight" in p:
        x = conv(p, name + ".res_conv", x, prec=prec)
    return h + x


def attention(p: Params, name: str, x: torch.Tensor, heads: int, prec: str) -> torch.Tensor:
    b, c = x.shape[:2]
    tokens = group_norm(p, name + ".norm", x, False).flatten(2).transpose(1, 2)  # (B, N, C)
    n, dh = tokens.shape[1], c // heads
    qkv = linear(p, name + ".qkv", tokens, prec).reshape(b, n, 3, heads, dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))            # (B, H, N, Dh)
    logits = _q(q, prec) @ _q(k, prec).transpose(-1, -2) * dh ** -0.5
    probs = torch.softmax(logits, dim=-1)
    out = (_q(probs, prec) @ _q(v, prec)).transpose(1, 2).reshape(b, n, c)
    ops.add_attention(b, n, c)
    out = linear(p, name + ".proj", out, prec)
    return x + out.transpose(1, 2).reshape(x.shape)


def _center_crop(x: torch.Tensor, spatial: Sequence[int]) -> torch.Tensor:
    idx = [slice(None), slice(None)]
    for cur, want in zip(x.shape[2:], spatial):
        off = (cur - want) // 2
        idx.append(slice(off, off + want))
    return x[tuple(idx)]


def channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1).contiguous()


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1).contiguous()


def unet3d(p: Params, cfg: dict, x: torch.Tensor, t: torch.Tensor,
           prec: str = "fp32") -> torch.Tensor:
    """ε predicted for the channels-last latent ``x`` (B, D, H, W, C) at
    integer timesteps ``t`` (B,): (B, D, H, W, C) float32."""
    levels = len(cfg["channel_mults"])
    attn_levels = set(cfg.get("attention_levels", ()))
    heads = cfg["num_heads"]
    temb = mlp(p, "time_mlp.1", "time_mlp.3", time_embedding(t, cfg["time_emb_dim"]), prec)
    h = conv(p, "in_conv", channels_first(x.float()), 1, 1, prec)
    skips = []
    for i in range(levels):
        h = res3d(p, f"downs.{i}.res1", h, temb, prec)
        h = res3d(p, f"downs.{i}.res2", h, temb, prec)
        if i in attn_levels:
            h = attention(p, f"downs.{i}.attn", h, heads, prec)
        skips.append(h)
        if i != levels - 1:
            h = conv(p, f"downs.{i}.down", h, 2, 1, prec)
    h = res3d(p, "mid1", h, temb, prec)
    if cfg.get("use_attention", True):
        h = attention(p, "mid_attn", h, heads, prec)
    h = res3d(p, "mid2", h, temb, prec)
    for j in range(levels):
        i = levels - 1 - j
        if i != levels - 1:
            h = conv_up(p, f"ups.{j}.up", h, prec)
        skip = skips.pop()
        if skip.shape[2:] != h.shape[2:]:
            skip = _center_crop(skip, h.shape[2:])
        h = torch.cat([h, skip], dim=1)
        h = res3d(p, f"ups.{j}.res1", h, temb, prec)
        h = res3d(p, f"ups.{j}.res2", h, temb, prec)
        if i in attn_levels:
            h = attention(p, f"ups.{j}.attn", h, heads, prec)
    h = conv(p, "out_conv", group_norm(p, "out_norm", h, True), 1, 1, prec)
    return channels_last(h)


def vae3d_decode(p: Params, z: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """The VAE3D decoder on a channels-last latent: (B, D, H, W, C_z) →
    (B, 4D', 4H', 4W', modalities) float32 (3 levels)."""
    h = conv(p, "decoder.from_latent", channels_first(z.float()), 1, 1, prec)
    k = 0
    while True:
        name = f"decoder.ups.{k}"
        if name + ".norm1.weight" in p:
            h = res3d(p, name, h, None, prec)
        elif name + ".weight" in p:
            h = conv_up(p, name, h, prec)
        else:
            break
        k += 1
    return channels_last(conv(p, "decoder.out_conv", h, 1, 1, prec))


def unet2d(p: Params, cfg: dict, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
           prec: str = "fp32") -> torch.Tensor:
    """ε predicted for the channels-last slice ``x`` (B, H, W, C) at
    timesteps ``t`` (B,) and slice positions ``z`` (B,): (B, H, W, C)."""
    levels = len(cfg["channel_mults"])
    cond = (mlp(p, "time_mlp.1", "time_mlp.3", time_embedding(t, cfg["time_emb_dim"]), prec)
            + mlp(p, "slice_mlp.0", "slice_mlp.2", z.float()[:, None], prec))
    h = conv(p, "init_conv", channels_first(x.float()), 1, 1, prec)
    skips = []
    for i in range(levels - 1):
        h = res2d(p, f"downs.{i}.res1", h, cond, prec)
        h = res2d(p, f"downs.{i}.res2", h, cond, prec)
        skips.append(h)
        h = conv(p, f"downs.{i}.down", h, 2, 1, prec)
    h = res2d(p, "mid_block1", h, cond, prec)
    h = res2d(p, "mid_block2", h, cond, prec)
    for j in range(levels - 1):
        skip = skips.pop()
        h = conv_up(p, f"ups.{j}.up", h, prec)
        if h.shape[2:] != skip.shape[2:]:
            h = F.interpolate(h, size=skip.shape[2:], mode="bilinear", align_corners=False)
        h = torch.cat([h, skip], dim=1)
        h = res2d(p, f"ups.{j}.res1", h, cond, prec)
        h = res2d(p, f"ups.{j}.res2", h, cond, prec)
    h = conv(p, "out_conv", group_norm(p, "out_norm", h, True), 1, 1, prec)
    return channels_last(h)
