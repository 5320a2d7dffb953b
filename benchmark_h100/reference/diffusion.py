"""Plain diffusion arithmetic: schedules, the noising, the two losses, the
DDIM timestep grid and update, and Adam.

Equations of the reference repo (``model_scripts/ddpm_3d_ldm/train.py``,
``model_scripts/slice_cond_2d_ddpm/model.py:24-46``):

* linear β from 1e-4 to 2e-2 over T; cosine (Nichol & Dhariwal, s = 0.008,
  β clipped to [1e-8, 0.999]); ᾱ the running product of 1 − β, computed in
  float64 and stored in float32;
* x_t = √ᾱ_t·x_0 + √(1 − ᾱ_t)·ε;
* MSE: the mean of (ε̂ − ε)² over everything; min-SNR: each sample's mean
  squared error weighted by min(SNR, γ)/SNR, SNR = ᾱ/(1 − ᾱ), then the mean
  over the batch;
* DDIM (η = 0): the grid is T−1 … 1 at stride 1 where the steps asked for
  reach it, else the rounded, de-duplicated ``linspace(T−1, 1, steps)``
  descending; each step goes to the next entry, the last to t = 0;
  x̂_0 = (x_t − √(1 − ᾱ_t)·ε̂)/max(√ᾱ_t, 1e-8), x_prev = √ᾱ_prev·x̂_0 +
  √(1 − ᾱ_prev)·ε̂;
* Adam: β = (0.9, 0.999), ε = 1e-8, bias-corrected moments.

Departures: none. ``ddim_update(..., dtype=torch.bfloat16)`` is the
control's lower precision of the update.
"""

import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def betas(schedule: str, timesteps: int) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(1e-4, 0.02, timesteps, dtype=np.float64)
    if schedule == "cosine":
        s = 0.008
        x = np.linspace(0.0, float(timesteps), timesteps + 1, dtype=np.float64)
        acp = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
        acp = acp / acp[0]
        return np.clip(1.0 - acp[1:] / acp[:-1], 1e-8, 0.999)
    raise ValueError(f"unknown schedule {schedule!r}")


def alphas_cumprod(schedule: str, timesteps: int, device) -> torch.Tensor:
    acp = np.cumprod(1.0 - betas(schedule, timesteps))
    return torch.from_numpy(acp.astype(np.float32)).to(device)


def _per_sample(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, *([1] * (like.dim() - 1)))


def q_sample(acp: torch.Tensor, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    a = _per_sample(acp[t], x0)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def loss_terms(kind: str, acp: torch.Tensor, eps_hat: torch.Tensor, noise: torch.Tensor,
               t: torch.Tensor, gamma: float) -> torch.Tensor:
    """Each sample's term of the loss; the loss is their sum over the whole
    batch divided by the batch size."""
    mse = torch.square(eps_hat.float() - noise.float()).flatten(1).mean(dim=1)
    if kind == "mse":
        return mse
    if kind == "min_snr":
        snr = acp[t] / (1.0 - acp[t])
        return snr.clamp_max(gamma) / snr * mse
    raise ValueError(f"unknown loss {kind!r}")


def ddim_timesteps(timesteps: int, steps: Optional[int]) -> np.ndarray:
    start = timesteps - 1
    if steps is None or steps >= start:
        return np.arange(start, 0, -1, dtype=np.int64)
    return np.unique(np.linspace(start, 1, steps).round().astype(np.int64))[::-1].copy()


def ddim_update(acp: torch.Tensor, x: torch.Tensor, eps: torch.Tensor, t: int,
                t_prev: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    a_t = acp[t].to(dtype)
    a_prev = acp[t_prev].to(dtype) if t_prev >= 0 else torch.ones((), dtype=dtype,
                                                                    device=x.device)
    xd, ed = x.to(dtype), eps.to(dtype)
    x0 = (xd - torch.sqrt(1.0 - a_t) * ed) / torch.sqrt(a_t).clamp_min(1e-8)
    return (torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * ed).float()


class Adam:
    """Adam over a dict of float32 parameters, updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k] / c1, denom, value=-self.lr)


def chunks(n: int, size: int) -> Iterable[slice]:
    for i in range(0, n, size):
        yield slice(i, min(i + size, n))
