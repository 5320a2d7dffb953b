"""Forward parity: mrijax UNet3D / VAE3D vs independently-written torch
models with the reference 3D topology, through the weight converter."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn as tnn
import torch.nn.functional as F

import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.io.torch_convert import (
    convert_reference_unet3d,
    convert_reference_vae3d,
)
from mrijax.models import UNet3D, VAE3D


class TRes3D(tnn.Module):
    def __init__(self, cin, cout, tdim=None, groups=8):
        super().__init__()
        self.norm1 = tnn.GroupNorm(groups, cin)
        self.conv1 = tnn.Conv3d(cin, cout, 3, padding=1)
        if tdim is not None:
            self.time_mlp = tnn.Linear(tdim, cout)
        self.norm2 = tnn.GroupNorm(groups, cout)
        self.conv2 = tnn.Conv3d(cout, cout, 3, padding=1)
        self.skip = tnn.Conv3d(cin, cout, 1) if cin != cout else tnn.Identity()

    def forward(self, x, t=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if t is not None:
            h = h + self.time_mlp(t)[:, :, None, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + self.skip(x)


class TAttn3D(tnn.Module):
    def __init__(self, c, heads=2, groups=8):
        super().__init__()
        self.heads = heads
        self.norm = tnn.GroupNorm(groups, c)
        self.qkv = tnn.Conv3d(c, c * 3, 1)
        self.proj = tnn.Conv3d(c, c, 1)

    def forward(self, x):
        B, C, D, H, W = x.shape
        q, k, v = self.qkv(self.norm(x)).chunk(3, dim=1)
        hd = C // self.heads
        q = q.reshape(B, self.heads, hd, D * H * W)
        k = k.reshape(B, self.heads, hd, D * H * W)
        v = v.reshape(B, self.heads, hd, D * H * W)
        attn = torch.softmax(
            torch.einsum("bhcn,bhcm->bhnm", q, k) * hd**-0.5, dim=-1
        )
        h = torch.einsum("bhnm,bhcm->bhcn", attn, v).reshape(B, C, D, H, W)
        return x + self.proj(h)


class TSinEmb(tnn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        freqs = torch.exp(
            torch.arange(half, dtype=torch.float32) * -(math.log(10000.0) / (half - 1))
        )
        ang = t.float()[:, None] * freqs[None, :]
        return torch.cat([ang.sin(), ang.cos()], dim=-1)


class TUNet3D(tnn.Module):
    def __init__(self, cin=4, base=16, mults=(1, 2), tdim=32, heads=2):
        super().__init__()
        chs = [base * m for m in mults]
        L = len(chs)
        self.time_mlp = tnn.Sequential(
            TSinEmb(tdim), tnn.Linear(tdim, tdim * 4), tnn.SiLU(),
            tnn.Linear(tdim * 4, tdim),
        )
        self.in_conv = tnn.Conv3d(cin, chs[0], 3, padding=1)
        downs = []
        for i in range(L):
            downs.append(tnn.ModuleDict({
                "res1": TRes3D(chs[i], chs[i], tdim),
                "res2": TRes3D(chs[i], chs[i], tdim),
                "down": (tnn.Conv3d(chs[i], chs[i + 1], 4, stride=2, padding=1)
                         if i != L - 1 else tnn.Identity()),
            }))
        self.downs = tnn.ModuleList(downs)
        self.mid1 = TRes3D(chs[-1], chs[-1], tdim)
        self.mid_attn = TAttn3D(chs[-1], heads)
        self.mid2 = TRes3D(chs[-1], chs[-1], tdim)
        ups = []
        cur = chs[-1]
        for i in reversed(range(L)):
            ups.append(tnn.ModuleDict({
                "up": (tnn.ConvTranspose3d(cur, chs[i], 4, stride=2, padding=1)
                       if i != L - 1 else tnn.Identity()),
                "res1": TRes3D(chs[i] * 2, chs[i], tdim),
                "res2": TRes3D(chs[i], chs[i], tdim),
            }))
            cur = chs[i]
        self.ups = tnn.ModuleList(ups)
        self.out_norm = tnn.GroupNorm(8, chs[0])
        self.out_conv = tnn.Conv3d(chs[0], cin, 3, padding=1)

    def forward(self, x, t):
        emb = self.time_mlp(t)
        h = self.in_conv(x)
        skips = []
        for b in self.downs:
            h = b["res2"](b["res1"](h, emb), emb)
            skips.append(h)
            h = b["down"](h)
        h = self.mid2(self.mid_attn(self.mid1(h, emb)), emb)
        for b in self.ups:
            h = b["up"](h)
            skip = skips.pop()
            if h.shape[-3:] != skip.shape[-3:]:
                dz = (skip.shape[-3] - h.shape[-3]) // 2
                dy = (skip.shape[-2] - h.shape[-2]) // 2
                dx = (skip.shape[-1] - h.shape[-1]) // 2
                skip = skip[..., dz:dz + h.shape[-3], dy:dy + h.shape[-2],
                            dx:dx + h.shape[-1]]
            h = torch.cat([h, skip], dim=1)
            h = b["res2"](b["res1"](h, emb), emb)
        return self.out_conv(F.silu(self.out_norm(h)))


class TEnc3D(tnn.Module):
    def __init__(self, cin=4, base=16, num_down=2, latent=4):
        super().__init__()
        self.in_conv = tnn.Conv3d(cin, base, 3, padding=1)
        downs = []
        cur = base
        for i in range(num_down):
            downs.append(TRes3D(cur, cur))
            if i != num_down - 1:
                downs.append(TRes3D(cur, cur * 2))
                downs.append(tnn.Conv3d(cur * 2, cur * 2, 4, stride=2, padding=1))
                cur *= 2
        self.downs = tnn.ModuleList(downs)
        self.to_mu_logvar = tnn.Conv3d(cur, 2 * latent, 3, padding=1)

    def forward(self, x):
        h = self.in_conv(x)
        for l in self.downs:
            h = l(h)
        return torch.chunk(self.to_mu_logvar(h), 2, dim=1)


class TDec3D(tnn.Module):
    def __init__(self, cout=4, base=16, num_down=2, latent=4):
        super().__init__()
        cur = base * (2 ** (num_down - 1))
        self.from_latent = tnn.Conv3d(latent, cur, 3, padding=1)
        ups = []
        for i in reversed(range(num_down)):
            ups.append(TRes3D(cur, cur))
            if i != 0:
                ups.append(TRes3D(cur, cur // 2))
                ups.append(tnn.ConvTranspose3d(cur // 2, cur // 2, 4,
                                               stride=2, padding=1))
                cur //= 2
        self.ups = tnn.ModuleList(ups)
        self.out_conv = tnn.Conv3d(cur, cout, 3, padding=1)

    def forward(self, z):
        h = self.from_latent(z)
        for l in self.ups:
            h = l(h)
        return self.out_conv(h)


class TVAE3D(tnn.Module):
    def __init__(self, cin=4, base=16, num_down=2, latent=4):
        super().__init__()
        self.encoder = TEnc3D(cin, base, num_down, latent)
        self.decoder = TDec3D(cin, base, num_down, latent)


def test_unet3d_matches_torch_reference():
    torch.manual_seed(0)
    tm = TUNet3D(cin=4, base=16, mults=(1, 2), tdim=32, heads=2).eval()
    params = convert_reference_unet3d(
        tm.state_dict(), channel_mults=(1, 2), use_attention=True
    )
    fm = UNet3D(in_channels=4, base_channels=16, channel_mults=(1, 2),
                time_emb_dim=32, num_heads=2, use_attention=True,
                use_flash_attention=False)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8, 8, 8, 4)).astype(np.float32)
    t = np.asarray([5], np.int64)
    with torch.no_grad():
        out_t = tm(torch.tensor(x.transpose(0, 4, 1, 2, 3)), torch.tensor(t))
        out_t = out_t.numpy().transpose(0, 2, 3, 4, 1)
    out_j = np.asarray(fm.apply(params, jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(out_j, out_t, atol=3e-4)


def test_vae3d_matches_torch_reference():
    torch.manual_seed(1)
    tm = TVAE3D(cin=4, base=16, num_down=2, latent=4).eval()
    params = convert_reference_vae3d(tm.state_dict(), num_down=2)
    fm = VAE3D(in_channels=4, base_channels=16, num_down=2, latent_channels=4)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 8, 8, 4)).astype(np.float32)
    with torch.no_grad():
        mu_t, logvar_t = tm.encoder(torch.tensor(x.transpose(0, 4, 1, 2, 3)))
        recon_t = tm.decoder(mu_t).numpy().transpose(0, 2, 3, 4, 1)
        mu_t = mu_t.numpy().transpose(0, 2, 3, 4, 1)
        logvar_t = logvar_t.numpy().transpose(0, 2, 3, 4, 1)
    mu_j, logvar_j = fm.apply(params, jnp.asarray(x), method="encode")
    np.testing.assert_allclose(np.asarray(mu_j), mu_t, atol=2e-4)
    np.testing.assert_allclose(np.asarray(logvar_j), logvar_t, atol=2e-4)
    recon_j = fm.apply(params, mu_j, method="decode_from_latent")
    np.testing.assert_allclose(np.asarray(recon_j), recon_t, atol=3e-4)
