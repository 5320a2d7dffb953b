"""The plain float32 reference of ``models.dit3d.DiT3D``: its forward pass in
plain ``torch`` on a dict of parameters by name, written from the published
description (Peebles & Xie, arXiv:2212.09748, and ``models.py`` of
``github.com/facebookresearch/DiT``), not from the module. Training's loss
and gradients come from autograd through it.

It imports no kernel of the port and nothing of JAX. ``set_precision()``
turns TF32 off in products and convolutions (``torch.backends.cuda.matmul.
allow_tf32`` and ``torch.backends.cudnn.allow_tf32``); ``dit3d_forward``
calls it. Attention runs in blocks of ``q_block`` query rows, so the N×N
logits of a long sequence never exist at once.

Departures from the published DiT-XL/2, each also the module's:

* the patch and the position table are 3D: a p×p×p patch of the
  channels-last latent, flattened in (pd, ph, pw, c) order, and a table of
  three 1D sin-cos tables of hidden/3 channels each, for d, h and w;
* no class embedder: BraTS volumes carry no label, so c is the timestep
  embedding alone;
* ε only, no learned Σ: the port's samplers and losses predict ε, so the
  final linear has p³·C outputs, not 2·p³·C;
* every weight is random from a seed, where DiT starts its adaLN and final
  weights at zero: with zero gates every block is the identity and a
  comparison would say nothing.
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]


def set_precision() -> None:
    """Plain float32: no TF32 in products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def frequency_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[cos(t·f), sin(t·f)], f_i = exp(−ln(10⁴)·i/(dim/2))."""
    half = dim // 2
    f = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                     device=t.device) / half)
    a = t.float()[:, None] * f[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def sincos_3d(grid, hidden: int, device=None) -> torch.Tensor:
    """(d·h·w, hidden): token (d, h, w), row-major, gets [sc(d), sc(h),
    sc(w)], sc(pos) = [sin(pos·ω), cos(pos·ω)], ω_i = 10⁴^(−i/(k/2)),
    k = hidden/3."""
    k = hidden // 3
    omega = 10000.0 ** (-torch.arange(k // 2, dtype=torch.float64, device=device) / (k // 2))
    token = torch.arange(grid[0] * grid[1] * grid[2], device=device)
    coords = (token // (grid[1] * grid[2]), token // grid[2] % grid[1], token % grid[2])
    parts = []
    for pos in coords:
        a = pos.double()[:, None] * omega[None]                      # (N, k/2)
        parts += [torch.sin(a), torch.cos(a)]
    return torch.cat(parts, dim=1).float()


def to_tokens(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, D, H, W, C) → (B, N, p³·C): p×p×p patches, row-major over the
    patch grid, each flattened in (pd, ph, pw, c) order."""
    b, d, h, w, c = x.shape
    out = torch.empty((b, d // p, h // p, w // p, p, p, p, c), dtype=x.dtype, device=x.device)
    for i in range(p):
        for j in range(p):
            for k in range(p):
                out[:, :, :, :, i, j, k] = x[:, i::p, j::p, k::p]
    return out.reshape(b, -1, p ** 3 * c)


def from_tokens(tokens: torch.Tensor, grid, p: int) -> torch.Tensor:
    """The inverse of ``to_tokens``."""
    b, c = tokens.shape[0], tokens.shape[-1] // p ** 3
    t = tokens.reshape(b, *grid, p, p, p, c)
    out = torch.empty((b, grid[0] * p, grid[1] * p, grid[2] * p, c), dtype=tokens.dtype,
                      device=tokens.device)
    for i in range(p):
        for j in range(p):
            for k in range(p):
                out[:, i::p, j::p, k::p] = t[:, :, :, :, i, j, k]
    return out


def linear(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ params[name + ".weight"].t() + params[name + ".bias"]


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_block: int) -> torch.Tensor:
    """softmax(q·kᵀ/√Dh)·v over (B, H, N, Dh), ``q_block`` query rows at a
    time."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for i in range(0, q.shape[2], q_block):
        logits = (q[:, :, i:i + q_block] @ k.transpose(-1, -2)) * scale
        outs.append(torch.softmax(logits, dim=-1) @ v)
    return torch.cat(outs, dim=2)


def block(params: Params, n: str, tokens: torch.Tensor, c: torch.Tensor, heads: int,
          q_block: int) -> torch.Tensor:
    """One adaLN-Zero block ``n`` on the tokens (B, N, hidden)."""
    b, hidden = tokens.shape[0], tokens.shape[-1]
    dh = hidden // heads
    mod = linear(params, n + ".adaLN_modulation.1", F.silu(c))
    shift1, scale1, gate1, shift2, scale2, gate2 = (
        mod[:, j * hidden:(j + 1) * hidden, None].transpose(1, 2) for j in range(6))
    h = layer_norm(tokens) * (1 + scale1) + shift1
    qkv = linear(params, n + ".attn.qkv", h).reshape(b, -1, 3, heads, dh)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))      # (B, H, N, Dh)
    a = attention(q, k, v, q_block).transpose(1, 2).reshape(b, -1, hidden)
    tokens = tokens + gate1 * linear(params, n + ".attn.proj", a)
    h = layer_norm(tokens) * (1 + scale2) + shift2
    h = F.gelu(linear(params, n + ".mlp.fc1", h), approximate="tanh")
    return tokens + gate2 * linear(params, n + ".mlp.fc2", h)


def dit3d_forward(params: Params, x: torch.Tensor, t: torch.Tensor, *, patch: int,
                  heads: int, freq_dim: int = 256, depth: Optional[int] = None,
                  q_block: int = 512, remat: bool = False) -> torch.Tensor:
    """ε for the channels-last latent ``x`` (B, D, H, W, C) at integer
    timesteps ``t`` (B,): (B, D, H, W, C) float32. ``depth`` defaults to the
    number of blocks in ``params``; ``remat`` recomputes each block in the
    backward pass (``torch.utils.checkpoint``), so that a gradient at full
    width keeps one block's attention probabilities at a time."""
    set_precision()
    if depth is None:
        depth = len({k.split(".")[1] for k in params if k.startswith("blocks.")})
    b, grid = x.shape[0], [n // patch for n in x.shape[1:4]]
    tokens = linear(params, "x_embedder", to_tokens(x.float(), patch))
    hidden = tokens.shape[-1]
    tokens = tokens + sincos_3d(grid, hidden, x.device)[None]
    c = linear(params, "t_embedder.mlp.2",
               F.silu(linear(params, "t_embedder.mlp.0", frequency_embedding(t, freq_dim))))
    for i in range(depth):
        if remat:
            tokens = checkpoint(block, params, f"blocks.{i}", tokens, c, heads, q_block,
                                use_reentrant=False)
        else:
            tokens = block(params, f"blocks.{i}", tokens, c, heads, q_block)
    mod = linear(params, "final_layer.adaLN_modulation.1", F.silu(c))
    shift, scale = mod[:, None, :hidden], mod[:, None, hidden:]
    out = linear(params, "final_layer.linear", layer_norm(tokens) * (1 + scale) + shift)
    return from_tokens(out, grid, patch)
