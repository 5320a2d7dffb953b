"""3D convolutional VAE for the latent diffusion model's stage 1.

Counterpart of ``mrijax/models/vae3d.py``:
* Encoder: conv3×3×3 stem → per level i in 0..num_down-1: {res(cur→cur)}
  and, for all but the last level, {res(cur→2cur), conv4 s2} — spatial
  downsample factor 2^(num_down-1) — → conv3×3×3 to 2·latent channels,
  split into (μ, logσ²).
* Reparameterization: z = μ + exp(0.5·logσ²)·ε.
* Decoder mirrors the encoder with transposed convs.
* ``encode_to_latent`` returns μ deterministically; ``decode_from_latent``
  decodes samples.

Channels-last (B, D, H, W, C); compute dtype ``dtype`` configurable, parameters
of the convolutions held in ``param_dtype`` (``None``: ``dtype``; training uses
float32), μ/logσ²/output cast to fp32. ``remat`` recomputes every res block of
encoder and decoder in the backward pass (``torch.utils.checkpoint``,
non-reentrant), as the JAX package's ``nn.remat``; the ``state_dict`` keys do
not depend on it. Module names follow the reference PyTorch layout:
``encoder.in_conv``, ``encoder.downs.{k}`` (a flat list of res blocks and
stride-2 convs), ``encoder.to_mu_logvar``, ``decoder.from_latent``,
``decoder.ups.{k}``, ``decoder.out_conv``.
"""

from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from mrijax_torch.models.blocks import Conv3d, Downsample, ResBlock3D, Upsample


def _run(layer: nn.Module, h: torch.Tensor, remat: bool) -> torch.Tensor:
    """One layer; a res block under ``remat`` is recomputed in the backward
    pass."""
    if remat and isinstance(layer, ResBlock3D) and torch.is_grad_enabled():
        # the blocks draw no random numbers: no generator state to carry
        return checkpoint(layer, h, use_reentrant=False, preserve_rng_state=False)
    return layer(h)


class Encoder3D(nn.Module):
    def __init__(self, in_channels: int = 4, base_channels: int = 32,
                 num_down: int = 3, latent_channels: int = 8, groups: int = 8,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.in_conv = Conv3d(in_channels, base_channels, 3, padding=1, **kw)
        self.downs = nn.ModuleList()
        cur = base_channels
        for i in range(num_down):
            self.downs.append(ResBlock3D(cur, cur, None, groups, **kw))
            if i != num_down - 1:
                self.downs.append(ResBlock3D(cur, cur * 2, None, groups, **kw))
                self.downs.append(Downsample(cur * 2, cur * 2, **kw))
                cur *= 2
        self.to_mu_logvar = Conv3d(cur, 2 * latent_channels, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.in_conv(x.to(self.dtype))
        for layer in self.downs:
            h = _run(layer, h, self.remat)
        mu, logvar = torch.chunk(self.to_mu_logvar(h).float(), 2, dim=-1)
        return mu, logvar


class Decoder3D(nn.Module):
    def __init__(self, out_channels: int = 4, base_channels: int = 32,
                 num_down: int = 3, latent_channels: int = 8, groups: int = 8,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        cur = base_channels * (2 ** (num_down - 1))
        self.from_latent = Conv3d(latent_channels, cur, 3, padding=1, **kw)
        self.ups = nn.ModuleList()
        for i in reversed(range(num_down)):
            self.ups.append(ResBlock3D(cur, cur, None, groups, **kw))
            if i != 0:
                self.ups.append(ResBlock3D(cur, cur // 2, None, groups, **kw))
                self.ups.append(Upsample(cur // 2, cur // 2, **kw))
                cur //= 2
        self.out_conv = Conv3d(cur, out_channels, 3, padding=1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.from_latent(z.to(self.dtype))
        for layer in self.ups:
            h = _run(layer, h, self.remat)
        return self.out_conv(h).float()


class VAE3D(nn.Module):
    def __init__(self, in_channels: int = 4, base_channels: int = 32,
                 num_down: int = 3, latent_channels: int = 8, groups: int = 8,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        self.num_down = num_down
        self.encoder = Encoder3D(in_channels, base_channels, num_down,
                                 latent_channels, groups, dtype, param_dtype, remat)
        self.decoder = Decoder3D(in_channels, base_channels, num_down,
                                 latent_channels, groups, dtype, param_dtype, remat)
        # conv weights in the layout the channels-last convolutions read
        self.to(memory_format=torch.channels_last_3d)

    @property
    def spatial_downsample(self) -> int:
        return 2 ** (self.num_down - 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def reparameterize(self, mu: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z = μ + exp(0.5·logσ²)·ε, with ε given or drawn from ``generator``."""
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = torch.randn(std.shape, dtype=std.dtype, device=std.device,
                              generator=generator)
        return mu + eps * std

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        mu, logvar = self.encode(x)
        z = self.reparameterize(mu, logvar, generator, eps)
        return self.decode(z), mu, logvar

    def encode_to_latent(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic latent (μ) for diffusion."""
        return self.encode(x)[0]

    def decode_from_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)
