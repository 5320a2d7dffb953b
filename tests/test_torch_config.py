"""The port's experiment config and model builders against ``mrijax``'s:
every ``configs/*.json`` and every preset read the same, unknown keys raise
in both, and the builders make models of the same configuration — the flax
parameters of the JAX package's builders, converted, load strict into the
port's models and give the same output (float32 on the CPU, 3e-4 absolute,
the bar of ``tests/test_torch_port_models.py``)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrijax import config as jconfig
from mrijax.train import experiments as jexp
from mrijax_torch import config
from mrijax_torch.io import unet3d_state_dict_from_flax, vae3d_state_dict_from_flax
from mrijax_torch.train import experiments

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.json"))
OVERRIDES = {"train.epochs": 2, "unet.base_channels": 8, "unet.channel_mults": [1, 2],
             "train.ema_decay": 0.999, "unet.remat_levels": [0], "data.patch_size": [32, 40, 40],
             "vae.remat": False, "train.checkpoint_dir": "/elsewhere"}
ATOL = 3e-4


def random_flax_params(module, rng, *init_args):
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *init_args))
    return jax.tree_util.tree_map(
        lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_every_config_field_is_ported():
    for name in ("DataConfig", "UNetConfig", "VAEConfig", "DiffusionConfig", "TrainConfig",
                 "ExperimentConfig"):
        want = [(f.name, f.default) for f in dataclasses.fields(getattr(jconfig, name))]
        got = [(f.name, f.default) for f in dataclasses.fields(getattr(config, name))]
        assert got == want, name


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_files_read_the_same(path, tmp_path):
    got = config.ExperimentConfig.from_json(path)
    want = jconfig.ExperimentConfig.from_json(path)
    assert got.to_dict() == want.to_dict()
    # and back: the port's json reads the same in the JAX package
    out = tmp_path / "config.json"
    got.to_json(out)
    assert jconfig.ExperimentConfig.from_json(out).to_dict() == want.to_dict()
    assert config.ExperimentConfig.from_dict(want.to_dict()).to_dict() == want.to_dict()


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
@pytest.mark.parametrize("over", [{}, OVERRIDES], ids=["defaults", "overrides"])
def test_presets_read_the_same(preset, over):
    assert sorted(config.PRESETS) == sorted(jconfig.PRESETS)
    got = config.PRESETS[preset]("/data", **over)
    want = jconfig.PRESETS[preset]("/data", **over)
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()


def test_unknown_keys_raise_in_both():
    for module in (config, jconfig):
        with pytest.raises(KeyError):
            module.preset_ddpm_3d_ldm(**{"train.epochz": 2})
        with pytest.raises(KeyError):
            module.ExperimentConfig.from_dict({"unet": {"base_channel": 8}})


# ------------------------------------------------------------------ builders

SMALL = {"unet.base_channels": 8, "unet.channel_mults": (1, 2), "unet.time_emb_dim": 16,
         "unet.num_heads": 2, "unet.in_channels": 4, "unet.out_channels": 4,
         "unet.compute_dtype": "float32", "vae.base_channels": 8, "vae.num_down": 2,
         "vae.latent_channels": 4, "vae.in_channels": 2, "vae.compute_dtype": "float32"}


def test_build_unet3d_matches_the_jax_builder():
    cfg = config.preset_ddpm_3d_ldm(**SMALL)
    jcfg = jconfig.preset_ddpm_3d_ldm(**SMALL)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 8, 4)).astype(np.float32)
    t = np.asarray([3, 9], np.int32)
    jm = jexp.build_unet3d(jcfg.unet, use_flash=False)
    params = random_flax_params(jm, rng, jnp.asarray(x), jnp.asarray(t))
    want = np.asarray(jm.apply(to_jax(params), jnp.asarray(x), jnp.asarray(t)))

    model = experiments.build_unet3d(cfg.unet).eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.load_state_dict(unet3d_state_dict_from_flax(
        params, cfg.unet.channel_mults, cfg.unet.use_attention, cfg.unet.attention_levels),
        strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_build_unet3d_bf16_config_keeps_float32_parameters():
    model = experiments.build_unet3d(config.preset_ddpm_3d_ldm(
        **{**SMALL, "unet.compute_dtype": "bfloat16"}).unet)
    assert model.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_build_vae3d_matches_the_jax_builder():
    cfg = config.preset_ddpm_3d_ldm(**SMALL)
    jcfg = jconfig.preset_ddpm_3d_ldm(**SMALL)
    assert cfg.vae.remat and jcfg.vae.remat   # the preset's setting, built as it is
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 8, 2)).astype(np.float32)
    jm = jexp.build_vae3d(jcfg.vae)
    params = random_flax_params(jm, rng, jnp.asarray(x), jax.random.PRNGKey(0))
    want = np.asarray(jm.apply(to_jax(params), jnp.asarray(x), method="encode_to_latent"))

    model = experiments.build_vae3d(cfg.vae).eval()
    assert model.encoder.remat and model.decoder.remat
    model.load_state_dict(vae3d_state_dict_from_flax(params, cfg.vae.num_down), strict=True)
    with torch.no_grad():
        got = model.encode_to_latent(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_build_unet3d_rejects_out_of_range_remat_levels_in_both():
    for module, cfgmod in ((experiments, config), (jexp, jconfig)):
        cfg = cfgmod.preset_ddpm_3d_ldm(**{**SMALL, "unet.remat_levels": (0, 2)})
        with pytest.raises(ValueError, match="out of range"):
            module.build_unet3d(cfg.unet)


def test_build_diffusion_matches_the_jax_builder():
    for schedule in ("linear", "cosine"):
        over = {"diffusion.schedule": schedule, "diffusion.timesteps": 50}
        got = experiments.build_diffusion(config.preset_ddpm_3d_ldm(**over).diffusion)
        want = jexp.build_diffusion(jconfig.preset_ddpm_3d_ldm(**over).diffusion)
        assert (got.loss_type, got.min_snr_gamma) == (want.loss_type, want.min_snr_gamma)
        np.testing.assert_allclose(got.schedule.betas.numpy(), np.asarray(want.schedule.betas),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="unknown schedule"):
        experiments.build_diffusion(config.DiffusionConfig(schedule="sigmoid"))


def test_vae3d_remat_gives_the_same_loss_and_gradients():
    """Rematerialisation recomputes the res blocks in the backward pass: the
    same loss and gradients (float32, 1e-6 absolute: the same operations run
    again on the same inputs) and the same state_dict keys."""
    from mrijax_torch.models import VAE3D
    from mrijax_torch.train import vae_loss

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 8, 2)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(2, 4, 4, 4, 4)).astype(np.float32))
    kw = dict(in_channels=2, base_channels=8, num_down=2, latent_channels=4)
    plain = VAE3D(**kw)
    remat = VAE3D(**kw, remat=True)
    assert plain.state_dict().keys() == remat.state_dict().keys()
    remat.load_state_dict(plain.state_dict())
    results = []
    for model in (plain, remat):
        recon, mu, logvar = model(x, eps=eps)
        loss, _ = vae_loss(recon, x, mu, logvar, 1e-4)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append((loss.detach(), grads))
    (loss_a, grads_a), (loss_b, grads_b) = results
    torch.testing.assert_close(loss_b, loss_a, atol=1e-6, rtol=0)
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
