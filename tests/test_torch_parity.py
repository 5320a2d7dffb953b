"""Forward-output parity: mrijax UNet2D vs an independently-written torch
model with the reference topology, through the weight converter.

This is the strongest topology-parity check available without real
checkpoints: a torch network built from the documented reference structure
(`slice_cond_2d_ddpm/unet.py:28-199`) is randomly initialized, its
state_dict converted by ``mrijax.io.torch_convert``, and both models must
produce the same outputs on random inputs. Passing means reference-trained
checkpoints load and run identically in mrijax.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn as tnn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.io.torch_convert import (
    convert_reference_unet2d,
    infer_timesteps,
    strip_prefixes,
)
from mrijax.models import UNet2D


# --- torch twin of the reference topology (written from SURVEY.md's
# structural description; channel plumbing per unet.py:108-199) ---

class TorchSinPosEmb(tnn.Module):
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


class TorchResBlock(tnn.Module):
    def __init__(self, cin, cout, tdim):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout, 3, padding=1)
        self.conv2 = tnn.Conv2d(cout, cout, 3, padding=1)
        self.time_mlp = tnn.Linear(tdim, cout)
        self.norm1 = tnn.GroupNorm(8, cout)
        self.norm2 = tnn.GroupNorm(8, cout)
        self.res_conv = tnn.Conv2d(cin, cout, 1) if cin != cout else tnn.Identity()

    def forward(self, x, emb):
        h = F.silu(self.norm1(self.conv1(x)))
        h = h + F.silu(self.time_mlp(emb))[:, :, None, None]
        h = F.silu(self.norm2(self.conv2(h)))
        return h + self.res_conv(x)


class TorchDown(tnn.Module):
    def __init__(self, cin, cout, tdim):
        super().__init__()
        self.res1 = TorchResBlock(cin, cout, tdim)
        self.res2 = TorchResBlock(cout, cout, tdim)
        self.down = tnn.Conv2d(cout, cout, 4, stride=2, padding=1)

    def forward(self, x, emb):
        x = self.res2(self.res1(x, emb), emb)
        return self.down(x), x


class TorchUp(tnn.Module):
    def __init__(self, cin, cskip, cout, tdim):
        super().__init__()
        self.up = tnn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)
        self.res1 = TorchResBlock(cout + cskip, cout, tdim)
        self.res2 = TorchResBlock(cout, cout, tdim)

    def forward(self, x, skip, emb):
        x = self.up(x)
        if x.shape[-2:] != skip.shape[-2:]:
            x = F.interpolate(x, size=skip.shape[-2:], mode="bilinear",
                              align_corners=False)
        x = torch.cat([x, skip], dim=1)
        return self.res2(self.res1(x, emb), emb)


class TorchRefUNet(tnn.Module):
    def __init__(self, img_channels=1, base=16, mults=(1, 2, 4), tdim=32,
                 in_channels=None):
        super().__init__()
        cin = in_channels if in_channels is not None else img_channels
        self.time_mlp = tnn.Sequential(
            TorchSinPosEmb(tdim), tnn.Linear(tdim, tdim * 4), tnn.SiLU(),
            tnn.Linear(tdim * 4, tdim),
        )
        self.slice_mlp = tnn.Sequential(
            tnn.Linear(1, tdim * 4), tnn.SiLU(), tnn.Linear(tdim * 4, tdim),
        )
        chs = [base * m for m in mults]
        self.init_conv = tnn.Conv2d(cin, chs[0], 3, padding=1)
        self.downs = tnn.ModuleList(
            [TorchDown(a, b, tdim) for a, b in zip(chs[:-1], chs[1:])]
        )
        self.mid_block1 = TorchResBlock(chs[-1], chs[-1], tdim)
        self.mid_block2 = TorchResBlock(chs[-1], chs[-1], tdim)
        ups = []
        cur = chs[-1]
        for cskip, cout in zip(reversed(chs[1:]), reversed(chs[:-1])):
            ups.append(TorchUp(cur, cskip, cout, tdim))
            cur = cout
        self.ups = tnn.ModuleList(ups)
        self.out_norm = tnn.GroupNorm(8, chs[0])
        self.out_conv = tnn.Conv2d(chs[0], img_channels, 3, padding=1)

    def forward(self, x, t, z, context=None):
        emb = self.time_mlp(t) + self.slice_mlp(z.float().unsqueeze(-1))
        if context is not None:
            x = torch.cat([x, context], dim=1)
        x = self.init_conv(x)
        skips = []
        for d in self.downs:
            x, s = d(x, emb)
            skips.append(s)
        x = self.mid_block2(self.mid_block1(x, emb), emb)
        for u in self.ups:
            x = u(x, skips.pop(), emb)
        return self.out_conv(F.silu(self.out_norm(x)))


@pytest.mark.parametrize("mults,size", [((1, 2, 4), 24), ((1, 2), 17)])
def test_unet2d_matches_torch_reference(mults, size):
    torch.manual_seed(0)
    tm = TorchRefUNet(img_channels=1, base=16, mults=mults, tdim=32).eval()
    params = convert_reference_unet2d(
        {f"model.{k}": v for k, v in tm.state_dict().items()},
        channel_mults=mults,
    )
    fm = UNet2D(in_channels=1, out_channels=1, base_channels=16,
                channel_mults=mults, time_emb_dim=32)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, size, size, 1)).astype(np.float32)
    t = np.asarray([3, 7], np.int64)
    z = np.asarray([0.25, 0.75], np.float32)

    with torch.no_grad():
        out_t = tm(torch.tensor(x.transpose(0, 3, 1, 2)), torch.tensor(t),
                   torch.tensor(z)).numpy().transpose(0, 2, 3, 1)
    out_j = np.asarray(fm.apply(params, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(z)))
    np.testing.assert_allclose(out_j, out_t, atol=2e-4)


def test_unet25d_matches_torch_reference():
    """2.5D variant: 4-channel denoised + 8-channel context concat."""
    torch.manual_seed(1)
    tm = TorchRefUNet(img_channels=4, base=16, mults=(1, 2), tdim=32,
                      in_channels=12).eval()
    params = convert_reference_unet2d(
        {f"model.{k}": v for k, v in tm.state_dict().items()},
        channel_mults=(1, 2),
    )
    fm = UNet2D(in_channels=12, out_channels=4, base_channels=16,
                channel_mults=(1, 2), time_emb_dim=32)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    t = np.asarray([5], np.int64)
    z = np.asarray([0.4], np.float32)
    with torch.no_grad():
        out_t = tm(torch.tensor(x.transpose(0, 3, 1, 2)), torch.tensor(t),
                   torch.tensor(z),
                   context=torch.tensor(ctx.transpose(0, 3, 1, 2))
                   ).numpy().transpose(0, 2, 3, 1)
    out_j = np.asarray(fm.apply(params, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(z), jnp.asarray(ctx)))
    np.testing.assert_allclose(out_j, out_t, atol=2e-4)


def test_prefix_stripping_and_timestep_inference():
    sd = {"model.module.init_conv.weight": np.zeros((4, 1, 3, 3)),
          "betas": np.linspace(1e-4, 0.02, 123)}
    stripped = strip_prefixes(sd)
    assert "init_conv.weight" in stripped
    assert infer_timesteps(sd) == 123
    wrapped = {"state_dict": sd}
    assert infer_timesteps(wrapped) == 123


def test_full_ddim_chain_matches_torch_reference():
    """End-to-end sampling-chain parity: the deterministic DDIM reverse
    process (x0-prediction form, `ddpm_3d_ldm/diffusion.py:167-196`) run for
    all steps through BOTH a torch twin and mrijax with converted weights
    must produce the same final image from the same x_T."""
    torch.manual_seed(3)
    T = 20
    mults = (1, 2)
    tm = TorchRefUNet(img_channels=1, base=16, mults=mults, tdim=32).eval()
    params = convert_reference_unet2d(
        {f"model.{k}": v for k, v in tm.state_dict().items()},
        channel_mults=mults,
    )
    fm = UNet2D(in_channels=1, out_channels=1, base_channels=16,
                channel_mults=mults, time_emb_dim=32)

    from mrijax.diffusion import (
        GaussianDiffusion, linear_beta_schedule, make_schedule,
    )

    diffusion = GaussianDiffusion(make_schedule(linear_beta_schedule(T)))

    rng = np.random.default_rng(3)
    x_T = rng.normal(size=(1, 16, 16, 1)).astype(np.float32)
    z = np.asarray([0.5], np.float32)

    # --- torch twin: stride-1 DDIM from t = T-1 down to 1 (x0 form) ---
    betas = torch.linspace(1e-4, 0.02, T, dtype=torch.float64)
    acp = torch.cumprod(1.0 - betas, dim=0).float()
    x = torch.tensor(x_T.transpose(0, 3, 1, 2))
    with torch.no_grad():
        for i in range(T - 1, 0, -1):
            t = torch.tensor([i])
            eps = tm(x, t, torch.tensor(z))
            a_t, a_prev = acp[i], acp[i - 1]
            x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
            x = torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps
    out_t = x.numpy().transpose(0, 2, 3, 1)

    # --- mrijax: one scan with the same weights and x_T ---
    def model_fn(xx, tt):
        return fm.apply(params, xx, tt, jnp.asarray(z))

    out_j = np.asarray(
        diffusion.ddim_sample(model_fn, x_T.shape, x_t=jnp.asarray(x_T),
                              start_t=T - 1)
    )
    np.testing.assert_allclose(out_j, out_t, atol=5e-3)
