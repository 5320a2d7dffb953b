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

Data parallelism (``mesh=``, a ``parallel.make_mesh`` mesh with a ``data``
axis): the batch a step is given is this rank's rows of the global batch.
Between the backward and the update the gradients are averaged over the
axis' group (SUM all-reduces of flat buffers, ÷ the axis size) and the loss
becomes the global mean, so every rank tests the same loss in the nan guard
(whose flag is agreed on too) and applies the same update. The random inputs
are drawn from the generator at the GLOBAL batch size and each rank takes
its rows — a run over d processes draws what the one-process run at the
global batch draws; explicit ``t``, ``noise``, ``eps`` and ``drop`` are the
global batch's too. The eval steps draw the same way and return the local
loss (``Trainer`` takes the weighted mean over ranks). A state that
``parallel.fsdp.shard_train_state`` sharded runs its own collectives (see
there). With ``mesh=None`` no collective runs and nothing changes.
"""

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from mrijax_torch.diffusion.gaussian import GaussianDiffusion
from mrijax_torch.parallel.mesh import (
    all_reduce_mean,
    axis_size,
    global_rows,
    local_rows,
)
from mrijax_torch.train.state import TrainState, ema_update, optimized_params

Params = Dict[str, torch.Tensor]


def sample_timesteps(generator: torch.Generator, batch_size: int, timesteps: int,
                     t_min: int = 0) -> torch.Tensor:
    """t ~ U[t_min, T) on the generator's device. The 3D latent trainer uses
    t_min=1."""
    return torch.randint(t_min, timesteps, (batch_size,), generator=generator,
                         device=generator.device)


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _check_state(state: TrainState, model: torch.nn.Module) -> None:
    if state.model is not model:
        raise ValueError("the train state was created for another model than "
                         "the one this step was made for")


def apply_if_finite(state: TrainState, loss: torch.Tensor, group=None) -> TrainState:
    """Optimizer update from the ``.grad`` of the parameters, skipped as a
    whole when the step went non-finite.

    The update is applied exactly when the loss AND the sum of every gradient
    are finite — on every rank of ``group`` (the flags are all-reduced with
    MIN, so all ranks take the same branch even where a rank's gradient slice
    alone went bad). A bad step leaves parameters, Adam moments and step
    count untouched; the caller still reports its loss. Reading the flag
    waits for the device once.
    """
    gsum = sum(p.grad.float().sum() for p in optimized_params(state).values()
               if p.grad is not None)
    ok = torch.isfinite(loss) & torch.isfinite(gsum)
    if group is not None:
        ok = ok.to(torch.int32).reshape(1)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    if bool(ok):
        state.optimizer.step()
        state.step += 1
    return state


def _synchronise(state: TrainState, mesh, loss: torch.Tensor):
    """After the backward, under a mesh or a sharded state: the gradients
    averaged over the data axis (reduce-scattered into the slices under
    FSDP) and the loss made the global mean. Returns ``(loss, group)``;
    ``group`` is None where no collective ran."""
    layout = state.fsdp
    if layout is None and mesh is None:
        return loss, None
    if layout is not None:
        group, n = layout.group, layout.n
        layout.reduce_gradients()
    else:
        group, n = mesh.get_group("data"), axis_size(mesh, "data")
        all_reduce_mean([p.grad for p in state.model.parameters() if p.grad is not None],
                        group, n)
    total = loss.detach().float().reshape(1).clone()
    dist.all_reduce(total, group=group)
    return total.div_(n).reshape(()), group


def _update(state: TrainState, loss: torch.Tensor, nan_guard: bool,
            ema_decay: Optional[float], group=None) -> TrainState:
    if nan_guard:
        apply_if_finite(state, loss, group)
    else:
        state.optimizer.step()
        state.step += 1
    if ema_decay is not None:
        ema_update(state, ema_decay)
    if state.fsdp is not None:
        state.fsdp.gather_parameters()
    return state


def _zero_grad(state: TrainState) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    if state.fsdp is not None:
        state.model.zero_grad(set_to_none=True)


def _global_draws(mesh, rows: int, given: Optional[torch.Tensor], name: str, draw):
    """This rank's rows of a global-batch random input: ``given`` (the
    global batch's) where it is, else ``draw(global rows)``."""
    g = global_rows(mesh, rows)
    if given is None:
        given = draw(g)
    elif mesh is not None and given.shape[0] != g:
        raise ValueError(f"{name} has {given.shape[0]} rows; under a mesh it must be "
                         f"the global batch's {g}")
    return local_rows(mesh, given)


# --------------------------------------------------------------------- DDPM


# classifier-free-guidance null token for the slice-position condition: real
# z_pos lies in [0, 1]; the network learns -1 as "no condition" when trained
# with cond_dropout > 0
CFG_NULL_Z = -1.0


def _need(generator: Optional[torch.Generator], name: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"need a generator when {name} is not given")
    return generator


def _draw(diffusion: GaussianDiffusion, x: torch.Tensor,
          generator: Optional[torch.Generator], t: Optional[torch.Tensor],
          noise: Optional[torch.Tensor], t_min: int, mesh=None):
    """``t`` ~ U[t_min, T) and float32 noise like ``x``, each drawn from
    ``generator`` (in that order) unless given, on ``x``'s device; under a
    mesh drawn at the global batch size and cut to this rank's rows."""
    t = _global_draws(mesh, x.shape[0], t, "t", lambda g: sample_timesteps(
        _need(generator, "t"), g, diffusion.timesteps, t_min))
    noise = _global_draws(mesh, x.shape[0], noise, "noise", lambda g: torch.randn(
        (g, *x.shape[1:]), dtype=torch.float32, device=x.device,
        generator=_need(generator, "noise")))
    return t.to(x.device), noise.to(x.device)


def _loss_update(state: TrainState, model_fn, diffusion: GaussianDiffusion,
                 x: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                 nan_guard: bool, ema_decay: Optional[float], mesh=None):
    """Diffusion loss, backward, the data-parallel synchronisation (under a
    mesh), Adam (guarded where asked) and EMA."""
    _zero_grad(state)
    loss = diffusion.p_losses(model_fn, x, t, noise)
    loss.backward()
    loss, group = _synchronise(state, mesh, loss.detach())
    _update(state, loss, nan_guard, ema_decay, group)
    return state, loss


def _conditioning(batch, dev: torch.device):
    """The batch's slice positions and its 2.5D context (or None) on ``dev``."""
    context = batch.get("context")
    return batch["z_pos"].to(dev), None if context is None else context.to(dev)


def make_diffusion_train_step(
    model: torch.nn.Module, diffusion: GaussianDiffusion, *, t_min: int = 0,
    nan_guard: bool = False, ema_decay: Optional[float] = None,
    cond_dropout: float = 0.0, mesh=None,
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
        t, noise = _draw(d, x, generator, t, noise, t_min, mesh)
        z, context = _conditioning(batch, dev)
        if cond_dropout > 0.0:
            drop = _global_draws(mesh, z.shape[0], drop, "drop", lambda g: torch.rand(
                (g,), device=_need(generator, "drop").device,
                generator=generator) < cond_dropout)
            z = torch.where(drop.to(dev), torch.full_like(z, CFG_NULL_Z), z)
        return _loss_update(state, lambda xx, tt: model(xx, tt, z, context), d, x, t,
                            noise, nan_guard, ema_decay, mesh)

    return train_step


def make_diffusion_eval_step(model: torch.nn.Module, diffusion: GaussianDiffusion, *,
                             t_min: int = 0, mesh=None) -> Callable:
    """``eval_step(params, batch, generator=None, *, t=None, noise=None)`` →
    loss of ``model`` run on ``params`` (for example
    ``inference_params(state)``), with ``t`` ~ U[t_min, T) and the noise drawn
    from ``generator`` unless given."""

    @torch.no_grad()
    def eval_step(params: Params, batch, generator=None, *, t=None, noise=None):
        dev = _device_of(model)
        x = batch["image"].to(dev)
        d = diffusion.to(dev)
        t, noise = _draw(d, x, generator, t, noise, t_min, mesh)
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


class _GlobalEpsVAE(torch.nn.Module):
    """``vae``'s forward with the reparameterisation noise drawn from
    ``generator`` at the global batch size and cut to this rank's rows
    (``eps``, where given, is this rank's already); without a mesh that is
    ``vae``'s own draw. A module, so that ``functional_call`` can run it on a
    parameter dict (its parameters are ``vae.*``)."""

    def __init__(self, vae: torch.nn.Module, mesh):
        super().__init__()
        self.vae = vae
        self.mesh = mesh

    def forward(self, x, generator=None, eps=None):
        mu, logvar = self.vae.encode(x)
        if eps is None:
            g = global_rows(self.mesh, x.shape[0])
            eps = local_rows(self.mesh, torch.randn(
                (g, *mu.shape[1:]), dtype=mu.dtype, device=mu.device,
                generator=_need(generator, "eps")))
        return self.vae.decode(self.vae.reparameterize(mu, logvar, None, eps)), mu, logvar


def _local_eps(mesh, eps: Optional[torch.Tensor], rows: int):
    return None if eps is None else _global_draws(mesh, rows, eps, "eps", None)


def make_vae_train_step(vae: torch.nn.Module, *, kl_weight: float = 1e-4,
                        nan_guard: bool = False, grad_accum: int = 1,
                        mesh=None) -> Callable:
    """batch: {"volume": (B, D, H, W, C)}.

    ``train_step(state, batch, generator=None, *, eps=None)`` returns
    ``(state, {"loss", "recon", "kl"})``. The reparameterisation noise is
    ``eps`` (B, *latent shape) where given, else drawn from ``generator``.

    ``grad_accum > 1``: gradient accumulation over ``grad_accum`` microbatches
    of ``B / grad_accum`` volumes and one optimizer update on the mean
    gradient, which is the full-batch gradient because ``vae_loss`` is a mean
    over its batch. Microbatch ``a`` takes the strided rows
    ``{m * grad_accum + a}`` (of ``eps`` too), the assignment of the JAX
    package. Only one microbatch's activations are alive at a time. Under a
    mesh each microbatch's noise is drawn at the global microbatch size, of
    which a rank takes its rows.
    """
    accum = max(int(grad_accum), 1)
    forward = _GlobalEpsVAE(vae, mesh)

    def train_step(state: TrainState, batch, generator=None, *, eps=None):
        _check_state(state, vae)
        x = batch["volume"].to(_device_of(vae))
        if x.shape[0] % accum:
            raise ValueError(
                f"batch size {x.shape[0]} is not divisible by grad_accum={accum}")
        eps = _local_eps(mesh, eps, x.shape[0])
        _zero_grad(state)
        per_micro = []
        for a in range(accum):
            xm = x[a::accum]
            em = None if eps is None else eps[a::accum].to(x.device)
            recon, mu, logvar = forward(xm, generator, em)
            loss, (recon_loss, kl) = vae_loss(recon, xm, mu, logvar, kl_weight)
            loss.backward()  # sums into .grad across the microbatches
            per_micro.append(torch.stack([loss, recon_loss, kl]).detach())
        if accum > 1:
            torch._foreach_div_(
                [p.grad for p in vae.parameters() if p.grad is not None], accum)
        loss, recon_loss, kl = torch.stack(per_micro).mean(dim=0)
        loss, group = _synchronise(state, mesh, loss)
        if group is not None:
            parts = torch.stack([recon_loss, kl])
            dist.all_reduce(parts, group=group)
            recon_loss, kl = parts.div_(dist.get_world_size(group))
        _update(state, loss, nan_guard, None, group)
        return state, {"loss": loss, "recon": recon_loss, "kl": kl}

    return train_step


def make_vae_eval_step(vae: torch.nn.Module, *, kl_weight: float = 1e-4,
                       mesh=None) -> Callable:
    """``eval_step(params, batch, generator=None, *, eps=None)`` →
    ``{"loss", "recon", "kl"}`` of ``vae`` run on ``params``."""
    forward = _GlobalEpsVAE(vae, mesh)

    @torch.no_grad()
    def eval_step(params: Params, batch, generator=None, *, eps=None):
        x = batch["volume"].to(_device_of(vae))
        eps = _local_eps(mesh, eps, x.shape[0])
        if eps is not None:
            eps = eps.to(x.device)
        recon, mu, logvar = functional_call(
            forward, {"vae." + k: v for k, v in params.items()}, (x, generator, eps))
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
                      t_min: int, nan_guard: bool, ema_decay: Optional[float], mesh):
    """What both stage-2 steps do once the scaled latent ``z`` is in hand."""
    diffusion = diffusion.to(z.device)
    t, noise = _draw(diffusion, z, generator, t, noise, t_min, mesh)
    return _loss_update(state, unet, diffusion, z, t, noise, nan_guard, ema_decay, mesh)


def make_latent_diffusion_train_step(
    unet: torch.nn.Module, vae: torch.nn.Module, diffusion: GaussianDiffusion, *,
    t_min: int = 1, nan_guard: bool = False, ema_decay: Optional[float] = None,
    mesh=None,
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
                                 t_min, nan_guard, ema_decay, mesh)

    return train_step


def make_cached_latent_train_step(
    unet: torch.nn.Module, diffusion: GaussianDiffusion, *, t_min: int = 1,
    nan_guard: bool = False, ema_decay: Optional[float] = None, mesh=None,
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
                                 t_min, nan_guard, ema_decay, mesh)

    return train_step


def _diffusion_eval(unet, diffusion, params, z, generator, t_fixed, noise, mesh):
    diffusion = diffusion.to(z.device)
    t = torch.full((z.shape[0],), int(t_fixed), dtype=torch.long, device=z.device)
    noise = _global_draws(mesh, z.shape[0], noise, "noise", lambda g: torch.randn(
        (g, *z.shape[1:]), dtype=torch.float32, device=z.device,
        generator=_need(generator, "noise"))).to(z.device)
    return diffusion.p_losses(
        lambda x, tt: functional_call(unet, params, (x, tt)), z, t, noise)


def make_cached_latent_eval_step(unet: torch.nn.Module,
                                 diffusion: GaussianDiffusion, mesh=None) -> Callable:
    """Fixed-timestep validation on precomputed latents:
    ``eval_step(params, batch, generator, latent_scale, t_fixed, *,
    noise=None)`` → loss of ``unet`` run on ``params`` (for example
    ``inference_params(state)``)."""

    @torch.no_grad()
    def eval_step(params: Params, batch, generator, latent_scale, t_fixed, *,
                  noise=None):
        z = batch["latent"].to(_device_of(unet)).float() * latent_scale
        return _diffusion_eval(unet, diffusion, params, z, generator, t_fixed, noise,
                               mesh)

    return eval_step


def make_latent_diffusion_eval_step(unet: torch.nn.Module, vae: torch.nn.Module,
                                    diffusion: GaussianDiffusion, mesh=None) -> Callable:
    """Fixed-timestep validation on volumes, on a deterministic grid of
    timesteps (``fixed_validation_timesteps``) cycled across batches for a
    low-variance validation loss. Pass the grid value as ``t_fixed``."""

    @torch.no_grad()
    def eval_step(params: Params, batch, generator, latent_scale, t_fixed, *,
                  noise=None):
        z = vae.encode_to_latent(batch["volume"].to(_device_of(unet)))
        z = z.float() * latent_scale
        return _diffusion_eval(unet, diffusion, params, z, generator, t_fixed, noise,
                               mesh)

    return eval_step


def fixed_validation_timesteps(timesteps: int, n: int = 8) -> np.ndarray:
    return np.linspace(1, timesteps - 1, n).astype(np.int32)
