"""Sinusoidal timestep embeddings.

Counterpart of ``mrijax/ops/embeddings.py``: for dimension ``d`` the
frequencies are ``exp(-k * log(10^4) / (d/2 - 1))`` for ``k = 0..d/2-1``;
output is ``[sin, cos]`` concatenated, zero-padded by one column when ``d``
is odd.
"""

import math

import torch
import torch.nn.functional as F


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Embed integer (or float) timesteps ``t`` of shape (B,) into (B, dim).

    Computed in float32 regardless of input dtype; cast at the call site if a
    lower compute precision is wanted.
    """
    half_dim = dim // 2
    if half_dim < 2:
        raise ValueError(f"time embedding dim must be >= 4, got {dim}")
    emb_factor = math.log(10000.0) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb_factor
    )
    ang = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
