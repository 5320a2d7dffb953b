"""Train and eval steps of all three families: the 2D / 2.5D DDPM step, and
of the 3D family the stage-1 VAE and stage-2 latent diffusion over volumes or
over cached latents.

Counterpart of ``mrijax/train/steps.py``. Each factory returns a plain Python
function that runs eagerly: timestep and noise sampling, ``q_sample``, model
forward, loss, backward and the optimizer update. A step updates the model,
the Adam moments and the EMA shadow of its ``TrainState`` in place and
returns the same state, so the call shape ``state, loss = step(state, …)`` of
the JAX package carries over. A ``torch.Generator`` on the batch's device
takes the place of the PRNG key; because the two frameworks' random streams
differ, every step also takes its random inputs (``t``, ``noise``, ``eps``,
the guidance-dropout mask ``drop``) as explicit tensors.

Conventions: batches are dicts of channels-last tensors; a batch is moved to
the device of the model's parameters; a loss comes back as a float32 0-d
tensor on that device, and a step makes no host synchronisation unless
``nan_guard=True`` (the guard reads one flag). ``donate`` of the JAX factories
has no counterpart and is left out.
"""

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.func import functional_call

from mrijax_torch.diffusion.gaussian import GaussianDiffusion
from mrijax_torch.train.state import TrainState, ema_update

Params = Dict[str, torch.Tensor]


def sample_timesteps(generator: torch.Generator, batch_size: int, timesteps: int,
                     t_min: int = 0) -> torch.Tensor:
    """t ~ U[t_min, T) on the generator's device. The 3D latent trainer uses
    t_min=1."""
    return torch.randint(t_min, timesteps, (batch_size,), generator=generator,
                         device=generator.device)


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _randn_like(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        raise ValueError("need a generator when the random inputs are not given")
    return torch.randn(x.shape, dtype=torch.float32, device=x.device,
                       generator=generator)


def _check_state(state: TrainState, model: torch.nn.Module) -> None:
    if state.model is not model:
        raise ValueError("the train state was created for another model than "
                         "the one this step was made for")


def apply_if_finite(state: TrainState, loss: torch.Tensor) -> TrainState:
    """Optimizer update from the ``.grad`` of the model's parameters, skipped
    as a whole when the step went non-finite.

    The update is applied exactly when the loss AND the sum of every gradient
    are finite. A bad step leaves parameters, Adam moments and step count
    untouched; the caller still reports its loss. Reading the flag waits for
    the device once.
    """
    gsum = sum(p.grad.float().sum() for p in state.model.parameters()
               if p.grad is not None)
    if bool(torch.isfinite(loss) & torch.isfinite(gsum)):
        state.optimizer.step()
        state.step += 1
    return state


def _update(state: TrainState, loss: torch.Tensor, nan_guard: bool,
            ema_decay: Optional[float]) -> TrainState:
    if nan_guard:
        apply_if_finite(state, loss)
    else:
        state.optimizer.step()
        state.step += 1
    if ema_decay is not None:
        ema_update(state, ema_decay)
    return state


# --------------------------------------------------------------------- DDPM


# classifier-free-guidance null token for the slice-position condition: real
# z_pos lies in [0, 1]; the network learns -1 as "no condition" when trained
# with cond_dropout > 0
CFG_NULL_Z = -1.0


def _draw(diffusion: GaussianDiffusion, x: torch.Tensor,
          generator: Optional[torch.Generator], t: Optional[torch.Tensor],
          noise: Optional[torch.Tensor], t_min: int):
    """``t`` ~ U[t_min, T) and float32 noise like ``x``, each drawn from
    ``generator`` (in that order) unless given, on ``x``'s device."""
    if t is None:
        if generator is None:
            raise ValueError("need a generator when t is not given")
        t = sample_timesteps(generator, x.shape[0], diffusion.timesteps, t_min)
    noise = _randn_like(x, generator) if noise is None else noise
    return t.to(x.device), noise.to(x.device)


def _loss_update(state: TrainState, model_fn, diffusion: GaussianDiffusion,
                 x: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                 nan_guard: bool, ema_decay: Optional[float]):
    """Diffusion loss, backward, Adam (guarded where asked) and EMA."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = diffusion.p_losses(model_fn, x, t, noise)
    loss.backward()
    _update(state, loss.detach(), nan_guard, ema_decay)
    return state, loss.detach()


def _conditioning(batch, dev: torch.device):
    """The batch's slice positions and its 2.5D context (or None) on ``dev``."""
    context = batch.get("context")
    return batch["z_pos"].to(dev), None if context is None else context.to(dev)


def make_diffusion_train_step(
    model: torch.nn.Module, diffusion: GaussianDiffusion, *, t_min: int = 0,
    nan_guard: bool = False, ema_decay: Optional[float] = None,
    cond_dropout: float = 0.0,
) -> Callable:
    """Train step of the 2D / 2.5D DDPMs.

    ``train_step(state, batch, generator=None, *, t=None, noise=None,
    drop=None)`` with batch {"image": (B, H, W, C), "z_pos": (B,)
    [, "context": (B, H, W, Ck)]}; returns ``(state, loss)``.

    ``t`` ~ U[t_min, T) and the noise are drawn from ``generator`` in that
    order unless given. ``cond_dropout``: classifier-free-guidance training —
    each sample's z_pos is replaced by ``CFG_NULL_Z`` with this probability,
    teaching one network the conditional and the unconditional score
    (``generate.sample_2d(guidance_scale=...)``). The (B,) boolean mask is
    ``drop`` where given, else drawn after the noise; with ``cond_dropout=0``
    nothing more is drawn, so the step draws exactly what it draws without
    guidance training.
    """

    def train_step(state: TrainState, batch, generator=None, *, t=None, noise=None,
                   drop=None):
        _check_state(state, model)
        dev = _device_of(model)
        x = batch["image"].to(dev)
        d = diffusion.to(dev)
        t, noise = _draw(d, x, generator, t, noise, t_min)
        z, context = _conditioning(batch, dev)
        if cond_dropout > 0.0:
            if drop is None:
                if generator is None:
                    raise ValueError("need a generator when drop is not given")
                drop = torch.rand(z.shape, device=generator.device,
                                  generator=generator) < cond_dropout
            z = torch.where(drop.to(dev), torch.full_like(z, CFG_NULL_Z), z)
        return _loss_update(state, lambda xx, tt: model(xx, tt, z, context), d, x, t,
                            noise, nan_guard, ema_decay)

    return train_step


def make_diffusion_eval_step(model: torch.nn.Module, diffusion: GaussianDiffusion, *,
                             t_min: int = 0) -> Callable:
    """``eval_step(params, batch, generator=None, *, t=None, noise=None)`` →
    loss of ``model`` run on ``params`` (for example
    ``inference_params(state)``), with ``t`` ~ U[t_min, T) and the noise drawn
    from ``generator`` unless given."""

    @torch.no_grad()
    def eval_step(params: Params, batch, generator=None, *, t=None, noise=None):
        dev = _device_of(model)
        x = batch["image"].to(dev)
        d = diffusion.to(dev)
        t, noise = _draw(d, x, generator, t, noise, t_min)
        z, context = _conditioning(batch, dev)
        return d.p_losses(
            lambda xx, tt: functional_call(model, params, (xx, tt, z, context)),
            x, t, noise)

    return eval_step


# ---------------------------------------------------------------------- VAE


def vae_loss(recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, kl_weight: float):
    """L1 reconstruction + KL: kl = -0.5 * mean(1 + logσ² - μ² - e^{logσ²}).
    Returns ``(loss, (recon_loss, kl))``."""
    recon_loss = (recon.float() - x.float()).abs().mean()
    kl = -0.5 * torch.mean(1.0 + logvar - torch.square(mu) - torch.exp(logvar))
    return recon_loss + kl_weight * kl, (recon_loss, kl)


def make_vae_train_step(vae: torch.nn.Module, *, kl_weight: float = 1e-4,
                        nan_guard: bool = False, grad_accum: int = 1) -> Callable:
    """batch: {"volume": (B, D, H, W, C)}.

    ``train_step(state, batch, generator=None, *, eps=None)`` returns
    ``(state, {"loss", "recon", "kl"})``. The reparameterisation noise is
    ``eps`` (B, *latent shape) where given, else drawn from ``generator``.

    ``grad_accum > 1``: gradient accumulation over ``grad_accum`` microbatches
    of ``B / grad_accum`` volumes and one optimizer update on the mean
    gradient, which is the full-batch gradient because ``vae_loss`` is a mean
    over its batch. Microbatch ``a`` takes the strided rows
    ``{m * grad_accum + a}`` (of ``eps`` too), the assignment of the JAX
    package. Only one microbatch's activations are alive at a time.
    """
    accum = max(int(grad_accum), 1)

    def train_step(state: TrainState, batch, generator=None, *, eps=None):
        _check_state(state, vae)
        x = batch["volume"].to(_device_of(vae))
        if x.shape[0] % accum:
            raise ValueError(
                f"batch size {x.shape[0]} is not divisible by grad_accum={accum}")
        state.optimizer.zero_grad(set_to_none=True)
        per_micro = []
        for a in range(accum):
            xm = x[a::accum]
            em = None if eps is None else eps[a::accum].to(x.device)
            recon, mu, logvar = vae(xm, generator, em)
            loss, (recon_loss, kl) = vae_loss(recon, xm, mu, logvar, kl_weight)
            loss.backward()  # sums into .grad across the microbatches
            per_micro.append(torch.stack([loss, recon_loss, kl]).detach())
        if accum > 1:
            torch._foreach_div_(
                [p.grad for p in vae.parameters() if p.grad is not None], accum)
        loss, recon_loss, kl = torch.stack(per_micro).mean(dim=0)
        _update(state, loss, nan_guard, None)
        return state, {"loss": loss, "recon": recon_loss, "kl": kl}

    return train_step


def make_vae_eval_step(vae: torch.nn.Module, *, kl_weight: float = 1e-4) -> Callable:
    """``eval_step(params, batch, generator=None, *, eps=None)`` →
    ``{"loss", "recon", "kl"}`` of ``vae`` run on ``params``."""

    @torch.no_grad()
    def eval_step(params: Params, batch, generator=None, *, eps=None):
        x = batch["volume"].to(_device_of(vae))
        if eps is not None:
            eps = eps.to(x.device)
        recon, mu, logvar = functional_call(vae, params, (x, generator, eps))
        loss, (recon_loss, kl) = vae_loss(recon, x, mu, logvar, kl_weight)
        return {"loss": loss, "recon": recon_loss, "kl": kl}

    return eval_step


@torch.no_grad()
def estimate_latent_scale(vae: torch.nn.Module, batches: Iterable[torch.Tensor]) -> float:
    """1/√(mean per-batch latent variance) over the given batches of volumes
    (population variance, as ``jnp.var``)."""
    dev = _device_of(vae)
    return estimate_latent_scale_from_latents(
        vae.encode_to_latent(x.to(dev)) for x in batches)


def estimate_latent_scale_from_latents(batches: Iterable[torch.Tensor]) -> float:
    """``estimate_latent_scale`` when the latents are already in hand."""
    vars_ = [float(torch.as_tensor(z).float().var(correction=0)) for z in batches]
    v = float(np.mean(np.asarray(vars_, np.float32))) if vars_ else 1.0
    return 1.0 / (max(v, 1e-8) ** 0.5)


# ----------------------------------------------------------- latent diffusion


def _diffusion_update(state: TrainState, unet: torch.nn.Module,
                      diffusion: GaussianDiffusion, z: torch.Tensor,
                      generator: Optional[torch.Generator],
                      t: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                      t_min: int, nan_guard: bool, ema_decay: Optional[float]):
    """What both stage-2 steps do once the scaled latent ``z`` is in hand."""
    diffusion = diffusion.to(z.device)
    t, noise = _draw(diffusion, z, generator, t, noise, t_min)
    return _loss_update(state, unet, diffusion, z, t, noise, nan_guard, ema_decay)


def make_latent_diffusion_train_step(
    unet: torch.nn.Module, vae: torch.nn.Module, diffusion: GaussianDiffusion, *,
    t_min: int = 1, nan_guard: bool = False, ema_decay: Optional[float] = None,
) -> Callable:
    """Stage-2 step: frozen-VAE encode → scale → diffusion loss (min-SNR when
    the diffusion says so) → Adam → EMA.

    ``train_step(state, batch, generator, latent_scale, *, t=None,
    noise=None)`` with batch {"volume": (B, D, H, W, C)}; ``vae`` is used as it
    is, under ``no_grad``. ``t`` and ``noise`` are drawn from ``generator``
    unless given.
    """

    def train_step(state: TrainState, batch, generator, latent_scale, *,
                   t=None, noise=None):
        _check_state(state, unet)
        with torch.no_grad():
            z = vae.encode_to_latent(batch["volume"].to(_device_of(unet)))
            z = z.float() * latent_scale
        return _diffusion_update(state, unet, diffusion, z, generator, t, noise,
                                 t_min, nan_guard, ema_decay)

    return train_step


def make_cached_latent_train_step(
    unet: torch.nn.Module, diffusion: GaussianDiffusion, *, t_min: int = 1,
    nan_guard: bool = False, ema_decay: Optional[float] = None,
) -> Callable:
    """Stage-2 step over PRECOMPUTED frozen-VAE latents: the encoder is frozen
    after stage 1, so its output is a pure function of the data and is encoded
    once, offline; training then runs from latent crops and the encode leaves
    the step.

    ``train_step(state, batch, generator, latent_scale, *, t=None,
    noise=None)`` with batch {"latent": (B, d, h, w, Cz)} — raw (unscaled) VAE
    means. Identical math to ``make_latent_diffusion_train_step`` given the
    same latents, timesteps and noise.
    """

    def train_step(state: TrainState, batch, generator, latent_scale, *,
                   t=None, noise=None):
        _check_state(state, unet)
        z = batch["latent"].to(_device_of(unet)).float() * latent_scale
        return _diffusion_update(state, unet, diffusion, z, generator, t, noise,
                                 t_min, nan_guard, ema_decay)

    return train_step


def _diffusion_eval(unet, diffusion, params, z, generator, t_fixed, noise):
    diffusion = diffusion.to(z.device)
    t = torch.full((z.shape[0],), int(t_fixed), dtype=torch.long, device=z.device)
    noise = _randn_like(z, generator) if noise is None else noise.to(z.device)
    return diffusion.p_losses(
        lambda x, tt: functional_call(unet, params, (x, tt)), z, t, noise)


def make_cached_latent_eval_step(unet: torch.nn.Module,
                                 diffusion: GaussianDiffusion) -> Callable:
    """Fixed-timestep validation on precomputed latents:
    ``eval_step(params, batch, generator, latent_scale, t_fixed, *,
    noise=None)`` → loss of ``unet`` run on ``params`` (for example
    ``inference_params(state)``)."""

    @torch.no_grad()
    def eval_step(params: Params, batch, generator, latent_scale, t_fixed, *,
                  noise=None):
        z = batch["latent"].to(_device_of(unet)).float() * latent_scale
        return _diffusion_eval(unet, diffusion, params, z, generator, t_fixed, noise)

    return eval_step


def make_latent_diffusion_eval_step(unet: torch.nn.Module, vae: torch.nn.Module,
                                    diffusion: GaussianDiffusion) -> Callable:
    """Fixed-timestep validation on volumes, on a deterministic grid of
    timesteps (``fixed_validation_timesteps``) cycled across batches for a
    low-variance validation loss. Pass the grid value as ``t_fixed``."""

    @torch.no_grad()
    def eval_step(params: Params, batch, generator, latent_scale, t_fixed, *,
                  noise=None):
        z = vae.encode_to_latent(batch["volume"].to(_device_of(unet)))
        z = z.float() * latent_scale
        return _diffusion_eval(unet, diffusion, params, z, generator, t_fixed, noise)

    return eval_step


def fixed_validation_timesteps(timesteps: int, n: int = 8) -> np.ndarray:
    return np.linspace(1, timesteps - 1, n).astype(np.int32)
