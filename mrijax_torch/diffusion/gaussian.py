"""Gaussian diffusion: forward process and the deterministic DDIM sampler.

Counterpart of ``mrijax/diffusion/gaussian.py``. The model is passed in as a
function ``model_fn(x, t) -> eps`` — conditioning is closed over by the
caller. There is no ``jit`` here: the reverse process is a Python loop under
``torch.no_grad()``, one model call per step.

DDIM supports an arbitrary strided timestep subset (``num_steps``), the fast
path of production sampling.

Not ported yet: the ancestral samplers (``p_sample_*``), DPM-Solver++
(``dpm_sample``) and the training losses (``p_losses``).
"""

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from mrijax_torch.diffusion.schedules import DiffusionSchedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-batch schedule values a[t] and reshape to (B, 1, ..., 1)."""
    return a[t].reshape(t.shape[0], *([1] * (ndim - 1)))


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Functional diffusion process bound to a schedule.

    ``model_fn`` arguments must already close over parameters and any
    conditioning. The schedule's buffers and the tensors handed to a method
    must lie on one device; ``to(device)`` gives a copy bound there, and
    ``ddim_sample`` does that itself for the device of its ``x_t``.
    """

    schedule: DiffusionSchedule

    @property
    def timesteps(self) -> int:
        return self.schedule.timesteps

    def to(self, device: Union[str, torch.device]) -> "GaussianDiffusion":
        schedule = self.schedule.to(device)
        return self if schedule is self.schedule else GaussianDiffusion(schedule)

    # ---------------------------------------------------------------- forward
    def q_sample(
        self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
    ) -> torch.Tensor:
        """Sample q(x_t | x_0) = √ᾱ_t x_0 + √(1-ᾱ_t) ε."""
        s = self.schedule
        nd = x_start.dim()
        return (
            _extract(s.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * noise
        )

    # --------------------------------------------------------------- sampling
    def ddim_step(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        t: torch.Tensor,
        t_prev: torch.Tensor,
    ) -> torch.Tensor:
        """Deterministic DDIM (η=0) step in x0-prediction form. ``t_prev < 0``
        means "to x0" (ᾱ_prev = 1). The update runs in float32."""
        s = self.schedule
        nd = x.dim()
        a_t = _extract(s.alphas_cumprod, t, nd)
        a_prev = torch.where(
            (t_prev >= 0).reshape(-1, *([1] * (nd - 1))),
            _extract(s.alphas_cumprod, t_prev.clamp_min(0), nd),
            torch.ones((), dtype=torch.float32, device=x.device),
        )
        eps = model_fn(x, t).float()
        xf = x.float()
        sqrt_a_t = torch.sqrt(a_t)
        x0 = (xf - torch.sqrt(1.0 - a_t) * eps) / sqrt_a_t.clamp_min(1e-8)
        x_prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return x_prev.to(x.dtype)

    def ddim_timestep_sequence(
        self, num_steps: Optional[int] = None, start_t: Optional[int] = None
    ) -> np.ndarray:
        """Descending timestep sequence for DDIM, as a host int32 array. With
        ``num_steps=None`` it is the stride-1 schedule [start_t..1]; otherwise
        an evenly spaced subset of ``num_steps`` steps ending at t=0's
        neighbor."""
        start = self.timesteps - 1 if start_t is None else int(start_t)
        if num_steps is None or num_steps >= start:
            return np.arange(start, 0, -1, dtype=np.int32)
        return np.unique(
            np.linspace(start, 1, num_steps).round().astype(np.int32)
        )[::-1].copy()

    @torch.no_grad()
    def ddim_sample(
        self,
        model_fn: ModelFn,
        shape: Sequence[int],
        generator: Optional[torch.Generator] = None,
        *,
        num_steps: Optional[int] = None,
        start_t: Optional[int] = None,
        x_t: Optional[torch.Tensor] = None,
        to_x0: bool = False,
    ) -> torch.Tensor:
        """Deterministic DDIM sampling over a (possibly strided) timestep
        subset, one model call per step.

        The start is ``x_t`` where given, else float32 noise drawn from
        ``generator`` on the generator's device. With defaults the loop stops
        at the t=1→0 transition without a final ᾱ=1 step; ``to_x0=True``
        appends that step. ``num_steps`` is the fast path for production
        sampling.
        """
        if x_t is None:
            if generator is None:
                raise ValueError("need generator when x_t is not given")
            x_t = torch.randn(tuple(shape), dtype=torch.float32,
                              device=generator.device, generator=generator)
        diffusion = self.to(x_t.device)
        b = shape[0]
        seq = self.ddim_timestep_sequence(num_steps, start_t)
        if len(seq) == 0:  # start_t=0: nothing to denoise (valid sweep edge)
            return x_t
        # Last transition: the default ends at the t=0 schedule entry;
        # to_x0=True instead finishes with a true ᾱ_prev=1 step.
        seq_prev = np.concatenate([seq[1:], [-1 if to_x0 else 0]])

        x = x_t
        for t_i, t_prev_i in zip(seq.tolist(), seq_prev.tolist()):
            t = torch.full((b,), t_i, dtype=torch.long, device=x.device)
            t_prev = torch.full((b,), t_prev_i, dtype=torch.long, device=x.device)
            x = diffusion.ddim_step(model_fn, x, t, t_prev)
        return x

    def fast_sample(
        self,
        model_fn: ModelFn,
        shape: Sequence[int],
        generator: Optional[torch.Generator] = None,
        *,
        num_steps: Optional[int] = None,
        sampler: str = "ddim",
        **kw,
    ) -> torch.Tensor:
        """Dispatch to a deterministic fast sampler by name. ``"ddim"`` is
        ported; ``"dpm"`` / ``"dpm2m"`` (DPM-Solver++(2M)) is not yet."""
        if sampler == "ddim":
            return self.ddim_sample(model_fn, shape, generator,
                                    num_steps=num_steps, **kw)
        if sampler in ("dpm", "dpm2m"):
            raise NotImplementedError(
                "the DPM-Solver++ sampler (dpm_sample) is not ported yet; it "
                "comes with the slice that ports the remaining samplers"
            )
        raise ValueError(f"unknown sampler {sampler!r} (ddim | dpm)")
