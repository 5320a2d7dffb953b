"""Beta schedules and precomputed diffusion constants.

Counterpart of ``mrijax/diffusion/schedules.py``:
* linear schedule β: 1e-4 → 2e-2 over T steps;
* cosine schedule (Nichol & Dhariwal, s=0.008, β clamped to [1e-8, 0.999]);
* derived buffers (ᾱ, √ᾱ, √(1-ᾱ), √(1/α), SNR, posterior variance and its
  clipped log).

The constants are computed host-side in float64 (they are tiny (T,) vectors
built once) and stored as float32 tensors, so the stored values are correctly
rounded.
"""

import dataclasses
import math
from typing import Union

import numpy as np
import torch


def linear_beta_schedule(
    timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02
) -> np.ndarray:
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0.0, float(timesteps), steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 1e-8, 0.999)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed per-timestep constants; every field is a float32 (T,) tensor."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    snr: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor

    @property
    def timesteps(self) -> int:
        return self.betas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def to(self, device: Union[str, torch.device]) -> "DiffusionSchedule":
        """The same schedule with every buffer on ``device``."""
        if torch.device(device) == self.device:
            return self
        return DiffusionSchedule(**{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        })


def make_schedule(betas) -> DiffusionSchedule:
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([np.ones((1,)), alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())

    return DiffusionSchedule(
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas=f32(np.sqrt(1.0 / alphas)),
        snr=f32(alphas_cumprod / (1.0 - alphas_cumprod)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.clip(posterior_variance, 1e-20, None))
        ),
    )
