"""Generation entry points of all three families.

Counterpart of ``mrijax/generate.py``:

* ``sample_2d``, ``sample_pseudo3d_sweep`` — grid sampling at a fixed slice
  position and the z-sweep (all slice positions as one batch), with optional
  classifier-free guidance (``cfg_model_fn``: one batch-doubled forward).
* ``conditional_sample_25d``, ``generate_pseudo3d_real_context`` (every slice
  of a subject conditioned on its real neighbours, in chunks of
  ``batch_size``) and ``generate_pseudo3d_hybrid`` (ascending-z
  autoregression: generated slices replace real context below the current
  one).
* ``generate_3d_volumes`` — latent sample (a fast sampler, or full-T
  ancestral sampling with ``ddim_steps=None``) → unscale → VAE decode; and
  ``Vae3dDiagnostics``, its sanity probes.

The models are ``nn.Module``s that hold their own parameters, so the separate
``*_params`` arguments of the JAX functions are gone; a ``torch.Generator``
(or an explicit start ``x_t``) takes the place of the PRNG key. Where the JAX
functions fold the key per chunk or slice, the port draws each chunk's or
slice's start noise in order from the one generator; an explicit ``x_t`` of
the whole output's shape is cut the same way, which is what makes the two
packages comparable.

Data-parallel sampling (``mesh=``, over the mesh's ``data`` axis, through
``parallel.sampling.sharded_sample``): shard i of d denoises its rows with a
generator made from ``(seed, i)`` alone, and every rank gets the whole
batch. The result is the concatenation of the d one-process calls with
those generators, so it depends on (seed, d); ``generator`` and ``x_t`` are
then not taken. ``generate_pseudo3d_real_context`` shards each chunk whose
size the axis divides (its default chunk is 4 slices a rank) and runs a
ragged last chunk whole; chunk c's seed is mixed from (seed, its first
slice).

Entry points take ``device=`` and default to ``"cuda"``; they raise where
CUDA is asked for and absent, and run on the CPU only when told to. Results
are float32 tensors on ``device``.
"""

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from mrijax_torch._device import require_device
from mrijax_torch.diffusion.gaussian import GaussianDiffusion
from mrijax_torch.parallel.mesh import axis_size
from mrijax_torch.parallel.sampling import sharded_sample
from mrijax_torch.train.steps import CFG_NULL_Z

Device = Union[str, torch.device]


def _generator(dev: torch.device, generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, which must live on ``dev``; a generator seeded with 0
    there where none is given."""
    if generator is None:
        return torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, but device={str(dev)!r}")
    return generator


def _denoise(diffusion: GaussianDiffusion, model_fn, shape: Sequence[int],
             generator: torch.Generator, x_t: Optional[torch.Tensor],
             ddim_steps: Optional[int], sampler: str) -> torch.Tensor:
    """The reverse process from ``x_t`` (else noise drawn from ``generator``):
    ``ddim_steps`` steps of ``sampler``, or the full-T ancestral loop."""
    if ddim_steps is not None:
        return diffusion.fast_sample(model_fn, shape, generator, num_steps=ddim_steps,
                                     sampler=sampler, x_t=x_t)
    return diffusion.p_sample_loop_auto(model_fn, shape, generator, x_t=x_t)


def _on(x: Optional[torch.Tensor], dev: torch.device) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x).to(dev)


def _sharded(mesh, generator, x_t, sample_fn, seed: int, num: int, dev, cond=None):
    """``sharded_sample`` of ``sample_fn(generator, local_or_cond)`` over the
    mesh's data axis; a mesh takes its generators from ``seed``."""
    if generator is not None or x_t is not None:
        raise ValueError("with mesh=, the shards' generators come from seed: "
                         "pass neither generator nor x_t")
    return sharded_sample(mesh, lambda _, gen, local: sample_fn(gen, local), None,
                          seed, num, cond=cond, device=dev)


# ------------------------------------------------------------------ 2D


def cfg_model_fn(model: torch.nn.Module, z: torch.Tensor, guidance_scale: float,
                 context: Optional[torch.Tensor] = None):
    """Classifier-free-guided ε-predictor for the slice-position condition.

    ε = ε_null + s·(ε_cond − ε_null), evaluated as ONE batch-doubled forward
    (conditional half, then the ``CFG_NULL_Z`` half). ``s=1`` is the plain
    conditional model; a model trained with ``cond_dropout > 0`` knows the
    null token."""

    def model_fn(x, t):
        z2 = torch.cat([z, torch.full_like(z, CFG_NULL_Z)])
        ctx2 = torch.cat([context, context]) if context is not None else None
        eps_c, eps_u = model(torch.cat([x, x]), torch.cat([t, t]), z2, ctx2).chunk(2)
        return eps_u + guidance_scale * (eps_c - eps_u)

    return model_fn


def _conditioned(model, z, guidance_scale, context=None):
    if guidance_scale is not None:
        return cfg_model_fn(model, z, guidance_scale, context)
    return lambda x, t: model(x, t, z, context)


@torch.no_grad()
def sample_2d(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    *,
    num_samples: int,
    image_size: int,
    z_pos: float = 0.5,
    generator: Optional[torch.Generator] = None,
    x_t: Optional[torch.Tensor] = None,
    ddim_steps: Optional[int] = None,
    sampler: str = "ddim",
    channels: int = 1,
    guidance_scale: Optional[float] = None,
    device: Device = "cuda",
    mesh=None,
    seed: int = 0,
) -> torch.Tensor:
    """Grid sampling at one slice position (default z = 0.5): returns
    (num_samples, image_size, image_size, channels). ``guidance_scale``
    turns on classifier-free guidance (twice the work per step). With
    ``mesh``, data-parallel from ``seed`` (module docstring)."""
    dev = require_device(device)
    model = model.to(dev).eval()

    def run(gen, local, x0=None):
        z = torch.full((local,), z_pos, dtype=torch.float32, device=dev)
        return _denoise(diffusion, _conditioned(model, z, guidance_scale),
                        (local, image_size, image_size, channels), gen, x0,
                        ddim_steps, sampler)

    if mesh is not None:
        return _sharded(mesh, generator, x_t, run, seed, num_samples, dev)
    return run(_generator(dev, generator), num_samples, _on(x_t, dev))


@torch.no_grad()
def sample_pseudo3d_sweep(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    *,
    num_slices: int = 155,
    image_size: int = 128,
    generator: Optional[torch.Generator] = None,
    x_t: Optional[torch.Tensor] = None,
    ddim_steps: Optional[int] = None,
    sampler: str = "ddim",
    channels: int = 1,
    guidance_scale: Optional[float] = None,
    device: Device = "cuda",
    mesh=None,
    seed: int = 0,
) -> torch.Tensor:
    """z-sweep pseudo-3D volume: the ``num_slices`` positions
    ``linspace(0, 1, num_slices)`` sampled as one batch. Returns
    (S, H, W, C). With ``mesh``, the positions are split over the data axis
    and sampled from ``seed`` (module docstring)."""
    dev = require_device(device)
    model = model.to(dev).eval()
    z = torch.linspace(0.0, 1.0, num_slices, dtype=torch.float32, device=dev)

    def run(gen, z_local, x0=None):
        return _denoise(diffusion, _conditioned(model, z_local, guidance_scale),
                        (z_local.shape[0], image_size, image_size, channels), gen, x0,
                        ddim_steps, sampler)

    if mesh is not None:
        return _sharded(mesh, generator, x_t, run, seed, num_slices, dev, cond=z)
    return run(_generator(dev, generator), z, _on(x_t, dev))


# ----------------------------------------------------------------- 2.5D


def _subject_slices(dataset, subject_idx: int):
    """Dataset indices belonging to one subject (in ascending z)."""
    path = dataset.volume_paths[subject_idx]
    return [i for i, (p, _) in enumerate(dataset.slice_tuples) if p == path]


def _sample_25d(model, diffusion, z_pos, context, generator, x_t, ddim_steps,
                sampler, out_channels, guidance_scale):
    shape = (context.shape[0], context.shape[1], context.shape[2], out_channels)
    return _denoise(diffusion, _conditioned(model, z_pos, guidance_scale, context), shape,
                    generator, x_t, ddim_steps, sampler)


@torch.no_grad()
def conditional_sample_25d(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    z_pos: torch.Tensor,
    context: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    x_t: Optional[torch.Tensor] = None,
    ddim_steps: Optional[int] = None,
    sampler: str = "ddim",
    out_channels: int = 4,
    guidance_scale: Optional[float] = None,
    device: Device = "cuda",
    mesh=None,
    seed: int = 0,
) -> torch.Tensor:
    """Center slices given z_pos (B,) and their neighbours' context
    (B, H, W, Ck): returns (B, H, W, out_channels). ``guidance_scale`` guides
    on the z condition; the context stays attached to both halves. With
    ``mesh``, the (z_pos, context) batch is split over the data axis and
    sampled from ``seed`` (module docstring)."""
    dev = require_device(device)
    model = model.to(dev).eval()
    z_pos, context = _on(z_pos, dev).float(), _on(context, dev).float()
    if mesh is not None:
        return _sharded(mesh, generator, x_t, lambda gen, cond: _sample_25d(
            model, diffusion, cond[0], cond[1], gen, None, ddim_steps, sampler,
            out_channels, guidance_scale), seed, context.shape[0], dev,
            cond=(z_pos, context))
    return _sample_25d(model, diffusion, z_pos, context,
                       _generator(dev, generator), _on(x_t, dev), ddim_steps, sampler,
                       out_channels, guidance_scale)


@torch.no_grad()
def generate_pseudo3d_real_context(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    dataset,
    subject_idx: int = 0,
    *,
    generator: Optional[torch.Generator] = None,
    x_t: Optional[torch.Tensor] = None,
    ddim_steps: Optional[int] = None,
    sampler: str = "ddim",
    batch_size: Optional[int] = None,
    guidance_scale: Optional[float] = None,
    device: Device = "cuda",
    mesh=None,
    seed: int = 0,
) -> torch.Tensor:
    """Every slice of one subject conditioned on its REAL neighbours: the
    slices are independent given that context, so they are denoised in
    batches of ``batch_size`` (all of them at once by default; with ``mesh``
    4 slices a rank, each chunk the axis divides split over it — module
    docstring). Returns (S, H, W, 4).

    ``dataset`` is duck-typed as in the JAX package: ``volume_paths``,
    ``slice_tuples`` ((path, z) per item) and ``__getitem__`` giving numpy
    ``{"image", "context", "z_pos"}``. ``x_t`` is the whole (S, H, W, 4)
    start, cut per chunk; without it each chunk's start is drawn in order
    from ``generator``.
    """
    dev = require_device(device)
    model = model.to(dev).eval()
    gen = _generator(dev, generator)
    samples = [dataset[i] for i in _subject_slices(dataset, subject_idx)]
    context = torch.from_numpy(np.stack([s["context"] for s in samples])).float().to(dev)
    z_pos = torch.tensor([float(s["z_pos"]) for s in samples], dtype=torch.float32,
                         device=dev)
    n = len(samples)
    if mesh is not None:
        if generator is not None or x_t is not None:
            raise ValueError("with mesh=, the shards' generators come from seed: "
                             "pass neither generator nor x_t")
        d = axis_size(mesh, "data")
        bs = batch_size or 4 * d
        outs = []
        for s0 in range(0, n, bs):
            z_c, ctx_c = z_pos[s0:s0 + bs], context[s0:s0 + bs]
            outs.append(sharded_sample(
                mesh if z_c.shape[0] % d == 0 else None,
                lambda _, gen, cond: _sample_25d(
                    model, diffusion, cond[0], cond[1], gen, None, ddim_steps,
                    sampler, 4, guidance_scale),
                None, _chunk_seed(seed, s0), z_c.shape[0], cond=(z_c, ctx_c),
                device=dev))
        return torch.cat(outs)
    x_t = _on(x_t, dev)
    bs = batch_size or n
    outs = [
        _sample_25d(model, diffusion, z_pos[s0:s0 + bs], context[s0:s0 + bs], gen,
                    None if x_t is None else x_t[s0:s0 + bs], ddim_steps, sampler, 4,
                    guidance_scale)
        for s0 in range(0, n, bs)
    ]
    return torch.cat(outs)


def _chunk_seed(seed: int, s0: int) -> int:
    """The seed of the chunk that starts at slice ``s0``."""
    return int(np.random.SeedSequence((seed, s0)).generate_state(1, np.uint64)[0] >> 1)


@torch.no_grad()
def generate_pseudo3d_hybrid(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    dataset,
    subject_idx: int = 0,
    *,
    generator: Optional[torch.Generator] = None,
    x_t: Optional[torch.Tensor] = None,
    ddim_steps: Optional[int] = None,
    sampler: str = "ddim",
    progress: Optional[Callable[[int, int], None]] = None,
    guidance_scale: Optional[float] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """Ascending-z autoregressive generation: a slice's context takes the
    already generated slices for neighbours below it and the real slices
    otherwise; a neighbour outside the subject falls back to the real center
    slice. Channels are dz-major, modality-minor. Returns (S, H, W, 4).

    ``dataset`` as for ``generate_pseudo3d_real_context`` (plus
    ``slice_radius``); ``x_t`` is the whole (S, H, W, 4) start, one slice
    per step; without it each slice's start is drawn in order from
    ``generator``. The slices stay on ``device`` throughout.
    """
    dev = require_device(device)
    model = model.to(dev).eval()
    gen = _generator(dev, generator)
    samples = [dataset[i] for i in _subject_slices(dataset, subject_idx)]
    real = torch.from_numpy(np.stack([s["image"] for s in samples])).float().to(dev)
    z_positions = torch.tensor([float(s["z_pos"]) for s in samples], dtype=torch.float32,
                               device=dev)
    x_t = _on(x_t, dev)
    n = len(samples)
    radius = dataset.slice_radius
    out = []
    for k in range(n):
        chans = []
        for dz in range(-radius, radius + 1):
            if dz == 0:
                continue
            j = k + dz
            if j < 0 or j >= n:
                chans.append(real[k])
            elif j < k:
                chans.append(out[j])
            else:
                chans.append(real[j])
        context = torch.cat(chans, dim=-1)[None]   # (1, H, W, 4·2r)
        slice_k = _sample_25d(model, diffusion, z_positions[k:k + 1], context, gen,
                              None if x_t is None else x_t[k:k + 1], ddim_steps, sampler,
                              4, guidance_scale)
        out.append(slice_k[0])
        if progress is not None:
            progress(k + 1, n)
    return torch.stack(out)


# ------------------------------------------------------------------- 3D


@torch.no_grad()
def generate_3d_volumes(
    unet: torch.nn.Module,
    vae: torch.nn.Module,
    diffusion: GaussianDiffusion,
    *,
    num_volumes: int = 1,
    latent_spatial: Sequence[int],
    latent_channels: int,
    latent_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    x_t: Optional[torch.Tensor] = None,
    ddim_steps: Optional[int] = None,
    sampler: str = "ddim",
    device: Device = "cuda",
    mesh=None,
    seed: int = 0,
) -> torch.Tensor:
    """Latent sample → unscale → VAE decode. Returns (N, D, H, W, C) float32
    volumes in model space, on ``device``. ``ddim_steps`` steps of ``sampler``
    ("ddim" or "dpm"), or with ``ddim_steps=None`` the full-T ancestral loop.
    With ``mesh``, the volumes are split over the data axis — each rank
    denoises and decodes its own — and sampled from ``seed`` (module
    docstring).

    Both models are moved to ``device``. The start noise is ``x_t`` where
    given (moved to ``device``), else drawn from ``generator``, which must
    live on ``device``; with neither, a generator seeded with 0 is made there.
    All volumes are decoded in one call: a caller short of memory samples
    latents and decodes them in chunks itself.
    """
    dev = require_device(device)
    unet = unet.to(dev).eval()
    vae = vae.to(dev).eval()

    def run(gen, local, x0=None):
        z = _denoise(diffusion, unet, (local, *latent_spatial, latent_channels), gen,
                     x0, ddim_steps, sampler)
        return vae.decode_from_latent(z / latent_scale)

    if mesh is not None:
        return _sharded(mesh, generator, x_t, run, seed, num_volumes, dev)
    return run(_generator(dev, generator), num_volumes, _on(x_t, dev))


@torch.no_grad()
def latent_shape_for(vae: torch.nn.Module, volume_shape: Sequence[int],
                     device: Device = "cuda") -> tuple:
    """Latent shape (D, H, W, C) for a volume of shape ``volume_shape``
    (D, H, W, C), found by encoding a dummy patch."""
    dev = require_device(device)
    dummy = torch.zeros((1, *volume_shape), dtype=torch.float32, device=dev)
    mu = vae.to(dev).eval().encode_to_latent(dummy)
    return tuple(mu.shape[1:])


NoiseByT = Callable[[int], torch.Tensor]


class Vae3dDiagnostics:
    """Sanity probes of a trained 3D pair: VAE reconstruction, latent
    statistics, a noise-then-DDIM round trip and the ε-prediction error by
    timestep.

    The probes that noise a latent draw the noise of each timestep in order
    from ``generator`` (on ``device``; seeded with 0 where none is given), or
    take it from ``noise``, a function from timestep to a tensor of the
    latent's shape (for a mapping, pass its ``__getitem__``) — the JAX
    package draws it from ``fold_in(key, t)``, which a test hands over this
    way. Numbers come back as Python floats.
    """

    def __init__(self, unet: torch.nn.Module, vae: torch.nn.Module,
                 diffusion: GaussianDiffusion, latent_scale: float = 1.0,
                 device: Device = "cuda"):
        self.device = require_device(device)
        self.unet = unet.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.diffusion = diffusion.to(self.device)
        self.latent_scale = latent_scale

    def _encode(self, volumes) -> torch.Tensor:
        return self.vae.encode_to_latent(_on(volumes, self.device)) * self.latent_scale

    def _noise(self, t: int, like: torch.Tensor, generator: Optional[torch.Generator],
               noise: Optional[NoiseByT]) -> torch.Tensor:
        if noise is not None:
            return torch.as_tensor(noise(t)).to(like.device, torch.float32)
        return torch.randn(like.shape, dtype=torch.float32, device=like.device,
                           generator=generator)

    @torch.no_grad()
    def reconstruction(self, volumes):
        """VAE reconstruction of real volumes: ``(recon, l1_error)``."""
        x = _on(volumes, self.device)
        recon = self.vae.decode_from_latent(self.vae.encode_to_latent(x))
        return recon, float((recon - x).abs().mean())

    @torch.no_grad()
    def latent_stats(self, volumes) -> Dict[str, float]:
        z = self._encode(volumes)
        return {"mean": float(z.mean()), "std": float(z.std(correction=0)),
                "min": float(z.min()), "max": float(z.max())}

    @torch.no_grad()
    def noising_roundtrip(self, volumes, ts=(50, 100, 200, 399),
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[NoiseByT] = None) -> Dict[int, float]:
        """Encode → q_sample to t → DDIM back from t → decode: the L1 between
        the volumes and their round trip, by t (clamped to T − 1)."""
        x = _on(volumes, self.device)
        gen = _generator(self.device, generator)
        z0 = self._encode(x)
        out = {}
        for t in ts:
            t = int(min(t, self.diffusion.timesteps - 1))
            tt = torch.full((z0.shape[0],), t, dtype=torch.long, device=self.device)
            zt = self.diffusion.q_sample(z0, tt, self._noise(t, z0, gen, noise))
            zr = self.diffusion.ddim_sample(self.unet, z0.shape, x_t=zt, start_t=t)
            rec = self.vae.decode_from_latent(zr / self.latent_scale)
            out[t] = float((rec - x).abs().mean())
        return out

    @torch.no_grad()
    def eps_mse_by_t(self, volumes, num_ts: int = 8,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[NoiseByT] = None) -> Dict[int, float]:
        """ε-prediction MSE on ``num_ts`` timesteps spread over [1, T − 1]."""
        gen = _generator(self.device, generator)
        z0 = self._encode(volumes)
        grid = np.linspace(1, self.diffusion.timesteps - 1, num_ts).astype(int)
        out = {}
        for t in grid.tolist():
            tt = torch.full((z0.shape[0],), t, dtype=torch.long, device=self.device)
            eps_true = self._noise(t, z0, gen, noise)
            eps = self.unet(self.diffusion.q_sample(z0, tt, eps_true), tt)
            out[t] = float(torch.square(eps - eps_true).mean())
        return out
