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

Channels-last (B, D, H, W, C); compute dtype configurable, μ/logσ²/output
cast to fp32. Module names follow the reference PyTorch layout:
``encoder.in_conv``, ``encoder.downs.{k}`` (a flat list of res blocks and
stride-2 convs), ``encoder.to_mu_logvar``, ``decoder.from_latent``,
``decoder.ups.{k}``, ``decoder.out_conv``.
"""

from typing import Optional, Tuple

import torch
import torch.nn as nn

from mrijax_torch.models.blocks import Conv3d, Downsample, ResBlock3D, Upsample


class Encoder3D(nn.Module):
    def __init__(self, in_channels: int = 4, base_channels: int = 32,
                 num_down: int = 3, latent_channels: int = 8, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.in_conv = Conv3d(in_channels, base_channels, 3, padding=1, dtype=dtype)
        self.downs = nn.ModuleList()
        cur = base_channels
        for i in range(num_down):
            self.downs.append(ResBlock3D(cur, cur, None, groups, dtype))
            if i != num_down - 1:
                self.downs.append(ResBlock3D(cur, cur * 2, None, groups, dtype))
                self.downs.append(Downsample(cur * 2, cur * 2, dtype))
                cur *= 2
        self.to_mu_logvar = Conv3d(cur, 2 * latent_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.in_conv(x.to(self.dtype))
        for layer in self.downs:
            h = layer(h)
        mu, logvar = torch.chunk(self.to_mu_logvar(h).float(), 2, dim=-1)
        return mu, logvar


class Decoder3D(nn.Module):
    def __init__(self, out_channels: int = 4, base_channels: int = 32,
                 num_down: int = 3, latent_channels: int = 8, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cur = base_channels * (2 ** (num_down - 1))
        self.from_latent = Conv3d(latent_channels, cur, 3, padding=1, dtype=dtype)
        self.ups = nn.ModuleList()
        for i in reversed(range(num_down)):
            self.ups.append(ResBlock3D(cur, cur, None, groups, dtype))
            if i != 0:
                self.ups.append(ResBlock3D(cur, cur // 2, None, groups, dtype))
                self.ups.append(Upsample(cur // 2, cur // 2, dtype))
                cur //= 2
        self.out_conv = Conv3d(cur, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.from_latent(z.to(self.dtype))
        for layer in self.ups:
            h = layer(h)
        return self.out_conv(h).float()


class VAE3D(nn.Module):
    def __init__(self, in_channels: int = 4, base_channels: int = 32,
                 num_down: int = 3, latent_channels: int = 8, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_down = num_down
        self.encoder = Encoder3D(in_channels, base_channels, num_down,
                                 latent_channels, groups, dtype)
        self.decoder = Decoder3D(in_channels, base_channels, num_down,
                                 latent_channels, groups, dtype)
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
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        std = torch.exp(0.5 * logvar)
        eps = torch.randn(std.shape, dtype=std.dtype, device=std.device,
                          generator=generator)
        return mu + eps * std

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        mu, logvar = self.encode(x)
        z = self.reparameterize(mu, logvar, generator)
        return self.decode(z), mu, logvar

    def encode_to_latent(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic latent (μ) for diffusion."""
        return self.encode(x)[0]

    def decode_from_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)
