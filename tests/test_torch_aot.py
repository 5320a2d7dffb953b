"""``mrijax_torch.aot`` (``torch.export`` of the per-step programs) and the
kernels' custom ops, on the CPU.

* The three forward kernels are ``torch.library`` custom ops that pass
  ``opcheck`` (schema, fake tensors, autograd registration, AOT dispatch);
  their CPU implementation is the plain version, bitwise.
* The exported per-step denoisers, on weights carried over from a flax
  tree, match ``model.apply`` of the JAX package within 1e-4.
* A loaded ``.pt2`` samples bitwise like the port's own library pipeline
  (``generate.sample_2d`` / ``generate_3d_volumes``) with the same generator,
  in this process and in a fresh one; it holds no weights; it refuses
  another device type; the 2D program keeps its ``--sampler``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax import config as jconfig
from mrijax.train import experiments as jexperiments
from mrijax_torch import aot, generate
from mrijax_torch.config import preset_ddpm_25d, preset_ddpm_3d_ldm, preset_slice_cond_2d
from mrijax_torch.io import (
    unet2d_state_dict_from_flax,
    unet3d_state_dict_from_flax,
    vae3d_state_dict_from_flax,
)
from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.kernels import groupnorm as gn
from mrijax_torch.models.blocks import GroupNormSiLU
from mrijax_torch.train.experiments import build_diffusion, build_unet2d, build_unet3d, build_vae3d

REPO = Path(__file__).resolve().parent.parent
TINY_2D = {"data.image_size": 16, "unet.base_channels": 8, "unet.channel_mults": (1, 2),
           "unet.time_emb_dim": 16, "unet.compute_dtype": "float32", "diffusion.timesteps": 50}
TINY_3D = {"data.patch_size": (8, 8, 8), "vae.base_channels": 8, "vae.num_down": 2,
           "vae.latent_channels": 4, "vae.compute_dtype": "float32", "unet.in_channels": 4,
           "unet.out_channels": 4, "unet.base_channels": 8, "unet.channel_mults": (1, 2),
           "unet.time_emb_dim": 16, "unet.num_heads": 2, "unet.compute_dtype": "float32",
           "diffusion.timesteps": 6}


def random_params(module, rng, *args):
    # eval_shape: only the tree's shapes are needed, so no initializer runs
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return jax.tree_util.tree_map(
        lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree)


def weights(model):
    return {k: v.detach() for k, v in model.named_parameters()}


@pytest.fixture(scope="module")
def two_d():
    """The tiny 2D config in both packages, the port's UNet2D on the weights
    of a flax tree."""
    cfg = preset_slice_cond_2d("/unused", **TINY_2D)
    jcfg = jconfig.preset_slice_cond_2d("/unused", **TINY_2D)
    jm = jexperiments.build_unet2d(jcfg.unet)
    params = random_params(jm, np.random.default_rng(0), jnp.zeros((1, 16, 16, 1)),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1,)))
    model = build_unet2d(cfg.unet)
    model.load_state_dict(unet2d_state_dict_from_flax(
        params, channel_mults=cfg.unet.channel_mults), strict=True)
    return dict(cfg=cfg, jm=jm, params=params, model=model.eval(),
                diffusion=build_diffusion(cfg.diffusion))


@pytest.fixture(scope="module")
def three_d():
    cfg = preset_ddpm_3d_ldm("/unused", **TINY_3D)
    jcfg = jconfig.preset_ddpm_3d_ldm("/unused", **TINY_3D)
    rng = np.random.default_rng(1)
    junet = jexperiments.build_unet3d(jcfg.unet, use_flash=False)
    jvae = jexperiments.build_vae3d(jcfg.vae)
    up = random_params(junet, rng, jnp.zeros((2, 4, 4, 4, 4)), jnp.zeros((2,), jnp.int32))
    vp = random_params(jvae, rng, jnp.zeros((1, 8, 8, 8, 4)), jax.random.PRNGKey(1))
    unet, vae = build_unet3d(cfg.unet), build_vae3d(cfg.vae)
    unet.load_state_dict(unet3d_state_dict_from_flax(up, cfg.unet.channel_mults), strict=True)
    vae.load_state_dict(vae3d_state_dict_from_flax(vp, cfg.vae.num_down), strict=True)
    return dict(cfg=cfg, junet=junet, jvae=jvae, up=up, vp=vp, unet=unet.eval(),
                vae=vae.eval(), diffusion=build_diffusion(cfg.diffusion))


@pytest.fixture(scope="module")
def exported_2d(two_d, tmp_path_factory):
    path = tmp_path_factory.mktemp("aot") / "prog.pt2"
    aot.save_exported(path, aot.build_slice_sampler(two_d["cfg"], num_samples=3,
                                                    ddim_steps=4, device="cpu"))
    return path


@pytest.fixture(scope="module")
def exported_3d(three_d, tmp_path_factory):
    path = tmp_path_factory.mktemp("aot") / "vol.pt2"
    aot.save_exported(path, aot.build_volume_sampler(three_d["cfg"], 1.3, num_volumes=2,
                                                     ddim_steps=3, device="cpu"))
    return path


# -------------------------------------------------------------- custom ops


def _gn_args(dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 37, 16)).astype(np.float32)).to(dtype)
    scale, bias = (torch.from_numpy(rng.normal(size=16).astype(np.float32)) for _ in range(2))
    return x, scale, bias


def _flash_args(dtype):
    qkv = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 19, 3, 2, 32))
                           .astype(np.float32)).to(dtype)
    return qkv.unbind(2)   # strided views, as the attention block hands them over


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("op", ["gn_silu_stats", "gn_silu_apply", "flash_attn_fwd"])
def test_custom_ops_pass_opcheck_and_equal_the_plain_versions(op, dtype):
    if op == "flash_attn_fwd":
        args = _flash_args(dtype)
        want = fa.flash_attention_reference(*args)
    else:
        x, scale, bias = _gn_args(dtype)
        stats = gn.gn_silu_stats_reference(x, 4)
        args = (x, 4, 1e-5) if op == "gn_silu_stats" else (x, stats, scale, bias)
        want = (stats if op == "gn_silu_stats"
                else gn.gn_silu_apply_reference(x, stats, scale, bias))
    packet = getattr(torch.ops.mrijax_torch, op)
    result = torch.library.opcheck(packet.default, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got = packet(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_fronts_take_the_ops_only_while_exporting(two_d):
    """Eager calls never go through the ops; the exported graph calls them."""
    ep = aot.export_callable(*(lambda s: (s.programs["denoise"], s.example_args["denoise"]))(
        aot.build_slice_sampler(two_d["cfg"], num_samples=2, ddim_steps=2, device="cpu")))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    sites = sum(isinstance(m, GroupNormSiLU) for m in two_d["model"].modules())
    assert sites == 13   # the 29 of the presets' four levels, at two
    assert targets.count("mrijax_torch.gn_silu_stats.default") == sites
    assert targets.count("mrijax_torch.gn_silu_apply.default") == sites
    assert not torch.compiler.is_exporting()


# ------------------------------------------------------- against the JAX package


def test_exported_2d_denoiser_matches_flax_apply(two_d, exported_2d):
    program = aot.deserialize_exported(exported_2d, "cpu").programs["denoise"].module()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 16, 16, 1)).astype(np.float32)
    t = np.asarray([0, 17, 49], np.int32)
    z = np.asarray([0.1, 0.5, 0.9], np.float32)
    want = np.asarray(jax.jit(two_d["jm"].apply)(two_d["params"], jnp.asarray(x),
                                                 jnp.asarray(t), jnp.asarray(z)))
    with torch.no_grad():
        got = program(weights(two_d["model"]), torch.from_numpy(x),
                      torch.from_numpy(t).long(), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_exported_3d_programs_match_flax_apply(three_d, exported_3d):
    programs = aot.deserialize_exported(exported_3d, "cpu").programs
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 4, 4, 4)).astype(np.float32)
    t = np.asarray([1, 5], np.int32)
    want = np.asarray(jax.jit(three_d["junet"].apply)(three_d["up"], jnp.asarray(x),
                                                      jnp.asarray(t)))
    want_dec = np.asarray(jax.jit(lambda p, z: three_d["jvae"].apply(
        p, z, method="decode_from_latent"))(three_d["vp"], jnp.asarray(x)))
    with torch.no_grad():
        got = programs["denoise"].module()(weights(three_d["unet"]), torch.from_numpy(x),
                                           torch.from_numpy(t).long())
        got_dec = programs["decode"].module()(weights(three_d["vae"]), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(got_dec.numpy(), want_dec, atol=1e-4)


# ------------------------------------------------ against the port's library


def test_slice_sampler_equals_sample_2d(two_d, exported_2d):
    sampler = aot.load_exported(exported_2d, "cpu")
    assert sampler.batch == 3 and sampler.shape == (3, 16, 16, 1)
    got = sampler(weights(two_d["model"]), torch.Generator().manual_seed(7),
                  torch.full((3,), 0.5))
    want = generate.sample_2d(two_d["model"], two_d["diffusion"], num_samples=3,
                              image_size=16, generator=torch.Generator().manual_seed(7),
                              ddim_steps=4, device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("steps,sampler", [(None, "ddim"), (4, "dpm")], ids=["full-T", "dpm"])
def test_slice_sampler_keeps_steps_and_sampler(two_d, tmp_path, steps, sampler):
    """Full-T ancestral sampling exports (the loop stays in Python); a DPM
    program samples with DPM-Solver++, not DDIM."""
    path = aot.save_exported(tmp_path / "p.pt2", aot.build_slice_sampler(
        two_d["cfg"], num_samples=2, ddim_steps=steps, sampler=sampler, device="cpu"))
    assert aot.read_settings(path)["sampler"] == sampler
    got = aot.load_exported(path, "cpu")(weights(two_d["model"]),
                                         torch.Generator().manual_seed(1), torch.full((2,), 0.3))
    kw = dict(num_samples=2, image_size=16, z_pos=0.3, ddim_steps=steps, device="cpu")
    want = generate.sample_2d(two_d["model"], two_d["diffusion"], sampler=sampler,
                              generator=torch.Generator().manual_seed(1), **kw)
    assert torch.equal(got, want)
    if steps is not None:
        ddim = generate.sample_2d(two_d["model"], two_d["diffusion"], sampler="ddim",
                                  generator=torch.Generator().manual_seed(1), **kw)
        assert not torch.allclose(got, ddim, atol=1e-4)


def test_volume_sampler_equals_generate_3d_volumes(three_d, exported_3d):
    sampler = aot.load_exported(exported_3d, "cpu")
    got = sampler(weights(three_d["unet"]), weights(three_d["vae"]),
                  torch.Generator().manual_seed(2))
    want = generate.generate_3d_volumes(
        three_d["unet"], three_d["vae"], three_d["diffusion"], num_volumes=2,
        latent_spatial=(4, 4, 4), latent_channels=4, latent_scale=1.3,
        generator=torch.Generator().manual_seed(2), ddim_steps=3, device="cpu")
    assert got.shape == (2, 8, 8, 8, 4) and torch.equal(got, want)


def test_files_hold_no_weights(two_d, three_d, exported_2d, exported_3d):
    for path, models in ((exported_2d, [two_d["model"]]),
                         (exported_3d, [three_d["unet"], three_d["vae"]])):
        weight_bytes = sum(p.numel() * p.element_size() for m in models for p in m.parameters())
        size, largest = aot.file_bytes(path)
        assert largest < 1024, (path, largest)   # no tensor data beyond a few scalars
        settings = aot.read_settings(path)
        assert settings["device"] == "cpu" and "config" in settings
        # the graph only: the 16² test models are small, so bound the file
        # by the flagship's weights, not these
        assert size < 5e6 and weight_bytes > 1e5


def test_cross_process_load(two_d, exported_2d, tmp_path):
    """A fresh process loads the file and samples with the weights and the
    generator alone: no run directory, no model construction."""
    w = tmp_path / "w.pt"
    torch.save(weights(two_d["model"]), w)
    want = aot.load_exported(exported_2d, "cpu")(
        weights(two_d["model"]), torch.Generator().manual_seed(11), torch.full((3,), 0.5))
    torch.save(want, tmp_path / "want.pt")
    prog = """
import sys, torch
from mrijax_torch.aot import load_exported
sample = load_exported(sys.argv[1], device="cpu")
got = sample(torch.load(sys.argv[2]), torch.Generator().manual_seed(11), torch.full((3,), 0.5))
assert torch.equal(got, torch.load(sys.argv[3]))
print("SERVE-OK")
"""
    r = subprocess.run([sys.executable, "-c", prog, str(exported_2d), str(w),
                        str(tmp_path / "want.pt")],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SERVE-OK" in r.stdout


def test_device_guard(exported_2d):
    """A program traced on the CPU refuses to run on CUDA at load time, with
    a clear message (before require_device would)."""
    with pytest.raises(ValueError, match="exported for device type 'cpu'"):
        aot.deserialize_exported(exported_2d, "cuda")
    with pytest.raises(ValueError, match="exported for device type 'cpu'"):
        aot.load_exported(exported_2d)   # the default device is the card


def test_slice_sampler_rejects_context_configs():
    with pytest.raises(ValueError, match="context"):
        aot.build_slice_sampler(preset_ddpm_25d("/unused"), device="cpu")


def test_mismatched_weights_are_named(two_d, exported_2d):
    sampler = aot.load_exported(exported_2d, "cpu")
    good = weights(two_d["model"])
    sampler.check_params(good)
    bad = dict(good)
    bad.pop(next(iter(bad)))
    bad["extra.weight"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="mismatch"):
        sampler.check_params(bad)
