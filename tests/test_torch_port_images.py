"""``mrijax_torch.io.images`` (PNG grids and panels, a copy of the JAX
package's numpy/PIL module) and ``generate.Vae3dDiagnostics`` against
``mrijax`` on the CPU: the image writers bitwise, the diagnostics on the same
weights with the JAX probes' own noise handed to the port."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.generate import Vae3dDiagnostics as JVae3dDiagnostics
from mrijax.io import images as jimages
from mrijax.models import UNet3D as JUNet3D
from mrijax.models import VAE3D as JVAE3D
from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
from mrijax_torch.generate import Vae3dDiagnostics
from mrijax_torch.io import images, unet3d_state_dict_from_flax, vae3d_state_dict_from_flax
from mrijax_torch.models import UNet3D, VAE3D

T = 20
UNET_KW = dict(in_channels=4, base_channels=8, channel_mults=(1, 2), time_emb_dim=16,
               num_heads=2)
VAE_KW = dict(in_channels=2, base_channels=8, num_down=2, latent_channels=4)


# ------------------------------------------------------------------- images


@pytest.mark.parametrize("shape", [(5, 6, 7), (3, 8, 8, 1)])
def test_make_grid_and_to_uint8_match_jax(shape):
    x = np.random.default_rng(0).uniform(-1.3, 1.3, size=shape).astype(np.float32)
    for nrow, padding in ((8, 2), (2, 1)):
        got = images.make_grid(x, nrow=nrow, padding=padding)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jimages.make_grid(x, nrow=nrow, padding=padding))
    np.testing.assert_array_equal(images.to_uint8(x, (0.0, 1.0)), jimages.to_uint8(x, (0.0, 1.0)))
    # a CPU tensor is read as its numpy array
    np.testing.assert_array_equal(images.make_grid(torch.from_numpy(x)), jimages.make_grid(x))


def test_percentile_window_and_midslice_panel_match_jax():
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(6, 9, 7, 2)).astype(np.float32)
    np.testing.assert_array_equal(images.percentile_window(vol[..., 0], 2.0, 98.0),
                                  jimages.percentile_window(vol[..., 0], 2.0, 98.0))
    flat = np.full((4, 4), 0.5, np.float32)   # hi == lo: the window widens, no division by 0
    np.testing.assert_array_equal(images.percentile_window(flat), jimages.percentile_window(flat))
    panel = images.volume_midslice_panel(vol)
    assert panel.dtype == np.uint8 and panel.shape == (2 * 9, 3 * 9)
    np.testing.assert_array_equal(panel, jimages.volume_midslice_panel(vol))


def test_png_writers_match_jax(tmp_path):
    x = np.random.default_rng(2).uniform(-1, 1, size=(4, 5, 6, 1)).astype(np.float32)
    images.save_grid_png(tmp_path / "port" / "grid.png", x, nrow=2)
    jimages.save_grid_png(tmp_path / "jax" / "grid.png", x, nrow=2)
    images.save_png(tmp_path / "port" / "slice.png", x[0, ..., 0])
    jimages.save_png(tmp_path / "jax" / "slice.png", x[0, ..., 0])
    for name in ("grid.png", "slice.png"):
        got = np.asarray(Image.open(tmp_path / "port" / name))
        np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "jax" / name)))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / "grid.png")),
                                  images.make_grid(x, nrow=2))


# -------------------------------------------------------------- diagnostics


def _random_params(module, rng, *args):
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return jax.tree_util.tree_map(
        lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def diagnostics():
    """Both packages' diagnostics on one tiny UNet3D + VAE3D pair."""
    rng = np.random.default_rng(3)
    junet, jvae = JUNet3D(**UNET_KW), JVAE3D(**VAE_KW)
    up = _random_params(junet, rng, jnp.zeros((1, 4, 4, 4, 4)), jnp.zeros((1,), jnp.int32))
    vp = _random_params(jvae, rng, jnp.zeros((1, 8, 8, 8, 2)), jax.random.PRNGKey(1))
    unet, vae = UNet3D(**UNET_KW), VAE3D(**VAE_KW)
    unet.load_state_dict(unet3d_state_dict_from_flax(up, UNET_KW["channel_mults"]))
    vae.load_state_dict(vae3d_state_dict_from_flax(vp, VAE_KW["num_down"]))
    betas = cosine_beta_schedule(T)
    jd = JVae3dDiagnostics(junet, jax.tree_util.tree_map(jnp.asarray, up), jvae,
                           jax.tree_util.tree_map(jnp.asarray, vp),
                           JGaussianDiffusion(jsched.make_schedule(betas)), latent_scale=0.7)
    td = Vae3dDiagnostics(unet, vae, GaussianDiffusion(make_schedule(betas)), latent_scale=0.7,
                          device="cpu")
    volumes = rng.uniform(-1, 1, size=(2, 8, 8, 8, 2)).astype(np.float32)
    return jd, td, volumes


def jax_noise(key, ts, shape):
    """The noise the JAX probes draw for each t: ``normal(fold_in(key, t))``."""
    return {t: torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, t), shape,
                                                           jnp.float32))) for t in ts}


def test_reconstruction_and_latent_stats_match_jax(diagnostics):
    jd, td, volumes = diagnostics
    recon_j, l1_j = jd.reconstruction(jnp.asarray(volumes))
    recon, l1 = td.reconstruction(torch.from_numpy(volumes))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-5)
    assert l1 == pytest.approx(l1_j, abs=1e-6)
    got, want = td.latent_stats(volumes), jd.latent_stats(jnp.asarray(volumes))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k


def test_noising_roundtrip_and_eps_mse_match_jax(diagnostics):
    """The JAX probes' noise, by timestep, handed to the port; t = 25 is
    clamped to T − 1. 1e-4 absolute: float32 over up to 19 DDIM steps."""
    jd, td, volumes = diagnostics
    key = jax.random.PRNGKey(4)
    latent = (2, 4, 4, 4, 4)
    ts = (3, 11, 25)
    want = jd.noising_roundtrip(jnp.asarray(volumes), ts=ts, key=key)
    got = td.noising_roundtrip(torch.from_numpy(volumes), ts=ts,
                               noise=jax_noise(key, (3, 11, 19), latent).__getitem__)
    assert got.keys() == want.keys() == {3, 11, 19}
    for t in want:
        assert got[t] == pytest.approx(want[t], abs=1e-4), t
    want = jd.eps_mse_by_t(jnp.asarray(volumes), num_ts=4, key=key)
    got = td.eps_mse_by_t(torch.from_numpy(volumes), num_ts=4,
                          noise=lambda t: jax_noise(key, (t,), latent)[t])
    assert got.keys() == want.keys()
    for t in want:
        assert got[t] == pytest.approx(want[t], abs=1e-5), t
    # drawn from a generator: reproducible, and the default device is the card
    a = td.eps_mse_by_t(volumes, num_ts=2, generator=torch.Generator().manual_seed(1))
    b = td.eps_mse_by_t(volumes, num_ts=2, generator=torch.Generator().manual_seed(1))
    assert a == b
    with pytest.raises(RuntimeError, match="cuda"):
        Vae3dDiagnostics(td.unet, td.vae, td.diffusion)
