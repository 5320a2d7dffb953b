"""Plain float32 forward pass of the ``dit3d_xl2`` configuration's network:
DiT-XL/2 (Peebles & Xie, arXiv:2212.09748; ``models.py`` of
``github.com/facebookresearch/DiT``) lifted to 3D over the flagship's VAE
latent.

A frozen copy of the program's own plain reference
(``mrijax_torch/models/dit3d_reference.py``), so that the yardstick does not
move with the program; nothing here imports the program. Parameters are a
dict of tensors by the program's names; input and output channels-last.

* Patch embed: each p×p×p patch flattened in (pd, ph, pw, c) order, one
  linear p³·C → hidden.
* Position table: token (d, h, w), row-major, gets [sc(d), sc(h), sc(w)],
  sc(pos) = [sin(pos·ω), cos(pos·ω)], ω_i = 10⁴^(−i/(k/2)), k = hidden/3.
* Timestep embedder: [cos(t·f), sin(t·f)], f_i = exp(−ln(10⁴)·i/(F/2)),
  Linear → SiLU → Linear; c = t_emb.
* Blocks (adaLN-Zero): (shift₁, scale₁, gate₁, shift₂, scale₂, gate₂) =
  Linear(SiLU(c)) in six chunks; x += gate₁·Attn(LN(x)(1 + scale₁) +
  shift₁); x += gate₂·MLP(LN(x)(1 + scale₂) + shift₂); LN without affine,
  eps 1e-6; the MLP Linear → GELU(tanh) → Linear; attention in blocks of
  ``Q_BLOCK`` query rows, so that the N×N logits never exist at once.
* Final layer: adaLN (shift, scale), Linear(hidden, p³·C), the patches put
  back.

Departures from DiT-XL/2, each the program's too: the 3D patch and table;
no class embedder; ε only (no learned Σ); every weight random from the seed
(DiT starts its adaLN and final weights at zero). The caller turns TF32 off.

``prec="fp8"`` is the control: every linear and attention product takes its
operands rounded to scaled float8 (``lowp.quantize``). Each linear (the patch
embed among them) and each attention block reports itself to ``count.ops``.
"""

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark_h100.count import ops
from benchmark_h100.reference.lowp import quantize

Params = Dict[str, torch.Tensor]
Q_BLOCK = 512


def _q(x: torch.Tensor, prec: str) -> torch.Tensor:
    return quantize(x) if prec == "fp8" else x


def linear(p: Params, name: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    w, b = p[name + ".weight"], p[name + ".bias"]
    y = _q(x, prec) @ _q(w, prec).t() + b
    ops.add_linear(x.numel() // x.shape[-1], w.shape[1], w.shape[0], True)
    return y


def frequency_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    f = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                     device=t.device) / half)
    a = t.float()[:, None] * f[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def sincos_3d(grid, hidden: int, device) -> torch.Tensor:
    k = hidden // 3
    omega = 10000.0 ** (-torch.arange(k // 2, dtype=torch.float64, device=device) / (k // 2))
    token = torch.arange(grid[0] * grid[1] * grid[2], device=device)
    coords = (token // (grid[1] * grid[2]), token // grid[2] % grid[1], token % grid[2])
    parts = []
    for pos in coords:
        a = pos.double()[:, None] * omega[None]
        parts += [torch.sin(a), torch.cos(a)]
    return torch.cat(parts, dim=1).float()


def to_tokens(x: torch.Tensor, p: int) -> torch.Tensor:
    b, d, h, w, c = x.shape
    out = torch.empty((b, d // p, h // p, w // p, p, p, p, c), dtype=x.dtype, device=x.device)
    for i in range(p):
        for j in range(p):
            for k in range(p):
                out[:, :, :, :, i, j, k] = x[:, i::p, j::p, k::p]
    return out.reshape(b, -1, p ** 3 * c)


def from_tokens(tokens: torch.Tensor, grid, p: int) -> torch.Tensor:
    b, c = tokens.shape[0], tokens.shape[-1] // p ** 3
    t = tokens.reshape(b, *grid, p, p, p, c)
    out = torch.empty((b, grid[0] * p, grid[1] * p, grid[2] * p, c), dtype=tokens.dtype,
                      device=tokens.device)
    for i in range(p):
        for j in range(p):
            for k in range(p):
                out[:, i::p, j::p, k::p] = t[:, :, :, :, i, j, k]
    return out


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prec: str) -> torch.Tensor:
    """softmax(q·kᵀ/√Dh)·v over (B, H, N, Dh), ``Q_BLOCK`` query rows at a
    time."""
    scale = q.shape[-1] ** -0.5
    q, k, v = _q(q, prec), _q(k, prec), _q(v, prec)
    outs = []
    for i in range(0, q.shape[2], Q_BLOCK):
        probs = torch.softmax((q[:, :, i:i + Q_BLOCK] @ k.transpose(-1, -2)) * scale, dim=-1)
        outs.append(_q(probs, prec) @ v)
    return torch.cat(outs, dim=2)


def dit3d(p: Params, cfg: dict, x: torch.Tensor, t: torch.Tensor,
          prec: str = "fp32") -> torch.Tensor:
    """ε for the channels-last latent ``x`` (B, D, H, W, C) at integer
    timesteps ``t`` (B,): (B, D, H, W, C) float32. ``cfg``: the
    configuration file's ``patch_size``, ``num_heads``, ``depth`` and
    ``frequency_embedding_size``."""
    patch, heads = cfg["patch_size"], cfg["num_heads"]
    b, grid = x.shape[0], [n // patch for n in x.shape[1:4]]
    tokens = linear(p, "x_embedder", to_tokens(x.float(), patch), prec)
    hidden = tokens.shape[-1]
    tokens = tokens + sincos_3d(grid, hidden, x.device)[None]
    c = linear(p, "t_embedder.mlp.2", F.silu(linear(
        p, "t_embedder.mlp.0", frequency_embedding(t, cfg["frequency_embedding_size"]), prec)),
        prec)
    dh = hidden // heads
    for i in range(cfg["depth"]):
        n = f"blocks.{i}"
        mod = linear(p, n + ".adaLN_modulation.1", F.silu(c), prec)
        shift1, scale1, gate1, shift2, scale2, gate2 = (
            mod[:, j * hidden:(j + 1) * hidden, None].transpose(1, 2) for j in range(6))
        h = layer_norm(tokens) * (1 + scale1) + shift1
        qkv = linear(p, n + ".attn.qkv", h, prec).reshape(b, -1, 3, heads, dh)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        a = attention(q, k, v, prec).transpose(1, 2).reshape(b, -1, hidden)
        ops.add_attention(b, a.shape[1], hidden)
        tokens = tokens + gate1 * linear(p, n + ".attn.proj", a, prec)
        h = layer_norm(tokens) * (1 + scale2) + shift2
        h = F.gelu(linear(p, n + ".mlp.fc1", h, prec), approximate="tanh")
        tokens = tokens + gate2 * linear(p, n + ".mlp.fc2", h, prec)
    mod = linear(p, "final_layer.adaLN_modulation.1", F.silu(c), prec)
    shift, scale = mod[:, None, :hidden], mod[:, None, hidden:]
    out = linear(p, "final_layer.linear", layer_norm(tokens) * (1 + scale) + shift, prec)
    return from_tokens(out, grid, patch)
