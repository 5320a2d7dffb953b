"""Diffusion processes: schedules, forward process, DDIM sampling."""

from mrijax_torch.diffusion.gaussian import GaussianDiffusion
from mrijax_torch.diffusion.schedules import (
    DiffusionSchedule,
    cosine_beta_schedule,
    linear_beta_schedule,
    make_schedule,
)

__all__ = [
    "DiffusionSchedule",
    "linear_beta_schedule",
    "cosine_beta_schedule",
    "make_schedule",
    "GaussianDiffusion",
]
