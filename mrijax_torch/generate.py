"""Generation entry points — the 3D latent-diffusion pipeline.

Counterpart of ``mrijax/generate.py`` (3D part): latent DDIM sample →
unscale → VAE decode. The models are ``nn.Module``s that hold their own
parameters, so the separate ``*_params`` arguments of the JAX functions are
gone; a ``torch.Generator`` (or an explicit start ``x_t``) takes the place of
the PRNG key.

Entry points take ``device=`` and default to ``"cuda"``; they raise where
CUDA is asked for and absent, and run on the CPU only when told to.
"""

from typing import Optional, Sequence, Union

import torch

from mrijax_torch._device import require_device
from mrijax_torch.diffusion.gaussian import GaussianDiffusion


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
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Latent sample → unscale → VAE decode. Returns (N, D, H, W, C) float32
    volumes in model space, on ``device``.

    Both models are moved to ``device``. The start noise is ``x_t`` where
    given (moved to ``device``), else drawn from ``generator``, which must
    live on ``device``; with neither, a generator seeded with 0 is made there.
    All volumes are decoded in one call: a caller short of memory samples
    latents and decodes them in chunks itself.
    """
    dev = require_device(device)
    if ddim_steps is None:
        raise NotImplementedError(
            "full-T ancestral sampling (p_sample_loop) is not ported yet: "
            "pass ddim_steps"
        )
    unet = unet.to(dev).eval()
    vae = vae.to(dev).eval()
    shape = (num_volumes, *latent_spatial, latent_channels)
    if x_t is not None:
        x_t = x_t.to(dev)
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(
            f"generator lives on {generator.device}, but device={str(dev)!r}"
        )
    z = diffusion.fast_sample(
        unet, shape, generator, num_steps=ddim_steps, sampler=sampler, x_t=x_t
    )
    return vae.decode_from_latent(z / latent_scale)


@torch.no_grad()
def latent_shape_for(vae: torch.nn.Module, volume_shape: Sequence[int],
                     device: Union[str, torch.device] = "cuda") -> tuple:
    """Latent shape (D, H, W, C) for a volume of shape ``volume_shape``
    (D, H, W, C), found by encoding a dummy patch."""
    dev = require_device(device)
    dummy = torch.zeros((1, *volume_shape), dtype=torch.float32, device=dev)
    mu = vae.to(dev).eval().encode_to_latent(dummy)
    return tuple(mu.shape[1:])
