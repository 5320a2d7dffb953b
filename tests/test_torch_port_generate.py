"""The slice as a whole — the samplers (DDIM, DPM-Solver++, ancestral) and
``generate_3d_volumes`` — against ``mrijax`` on the same weights and the same
start noise, plus the port's hygiene rules (no JAX import, importable without CUDA, no silent CPU run)."""

import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mrijax_torch
from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.models import UNet3D as JUNet3D
from mrijax.models import VAE3D as JVAE3D
from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
from mrijax_torch.generate import generate_3d_volumes, latent_shape_for
from mrijax_torch.io import unet3d_state_dict_from_flax, vae3d_state_dict_from_flax
from mrijax_torch.models import UNet3D, VAE3D

REPO = Path(__file__).resolve().parent.parent
T = 20
UNET_KW = dict(in_channels=4, base_channels=8, channel_mults=(1, 2),
               time_emb_dim=16, num_heads=2)
VAE_KW = dict(in_channels=2, base_channels=8, num_down=2, latent_channels=4)
LATENT = (2, 8, 8, 8, 4)


def _random_params(module, rng, *args):
    # eval_shape: only the tree's shapes are needed, so no initializer runs
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return jax.tree_util.tree_map(
        lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def pipeline():
    """A tiny UNet3D + VAE3D in both frameworks on the same weights."""
    rng = np.random.default_rng(0)
    x = jnp.zeros(LATENT, jnp.float32)
    junet, jvae = JUNet3D(**UNET_KW), JVAE3D(**VAE_KW)
    up = _random_params(junet, rng, x, jnp.zeros((2,), jnp.int32))
    vp = _random_params(jvae, rng, jnp.zeros((1, 8, 8, 8, 2)), jax.random.PRNGKey(1))
    unet, vae = UNet3D(**UNET_KW).eval(), VAE3D(**VAE_KW).eval()
    unet.load_state_dict(unet3d_state_dict_from_flax(up, UNET_KW["channel_mults"]))
    vae.load_state_dict(vae3d_state_dict_from_flax(vp, VAE_KW["num_down"]))
    betas = cosine_beta_schedule(T)
    return dict(
        junet=junet, jvae=jvae, up=jax.tree_util.tree_map(jnp.asarray, up),
        vp=jax.tree_util.tree_map(jnp.asarray, vp), unet=unet, vae=vae,
        jdiff=JGaussianDiffusion(jsched.make_schedule(betas)),
        diff=GaussianDiffusion(make_schedule(betas)),
        x_t=np.random.default_rng(1).normal(size=LATENT).astype(np.float32),
    )


@pytest.mark.parametrize("kw", [
    dict(num_steps=5),
    dict(num_steps=5, to_x0=True),
    dict(num_steps=None, start_t=6),
])
def test_ddim_sample_matches_jax(pipeline, kw):
    """Shared numpy start noise. Tolerance 1e-3 absolute: float32 differences
    of the two UNets compound over the steps."""
    p = pipeline
    want = p["jdiff"].ddim_sample(
        lambda x, t: p["junet"].apply(p["up"], x, t), LATENT,
        x_t=jnp.asarray(p["x_t"]), **kw)
    got = p["diff"].ddim_sample(p["unet"], LATENT, x_t=torch.from_numpy(p["x_t"]), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_ddim_step_matches_jax(pipeline):
    """One step with a fixed eps function, to_x0 included (t_prev = -1)."""
    p = pipeline
    t = np.asarray([9, 9], np.int32)
    t_prev = np.asarray([4, -1], np.int32)
    want = p["jdiff"].ddim_step(lambda x, t: 0.5 * x, jnp.asarray(p["x_t"]),
                                jnp.asarray(t), jnp.asarray(t_prev))
    got = p["diff"].ddim_step(lambda x, t: 0.5 * x, torch.from_numpy(p["x_t"]),
                              torch.from_numpy(t).long(), torch.from_numpy(t_prev).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_generate_3d_volumes_matches_jax(pipeline):
    """End to end on a shared start: the JAX side runs ``ddim_sample(x_t=…)``
    and ``decode_from_latent`` (its ``generate_3d_volumes`` draws its own
    noise from a key, and the two frameworks' random streams differ).
    Tolerance 1e-3 absolute: error compounds over steps and the decoder."""
    p = pipeline
    scale = 0.5
    z = p["jdiff"].ddim_sample(
        lambda x, t: p["junet"].apply(p["up"], x, t), LATENT,
        x_t=jnp.asarray(p["x_t"]), num_steps=5)
    want = p["jvae"].apply(p["vp"], z / scale, method="decode_from_latent")
    got = generate_3d_volumes(
        p["unet"], p["vae"], p["diff"], num_volumes=2, latent_spatial=LATENT[1:4],
        latent_channels=LATENT[4], latent_scale=scale, x_t=torch.from_numpy(p["x_t"]),
        ddim_steps=5, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_generate_3d_volumes_with_generator_is_reproducible(pipeline):
    p = pipeline
    kw = dict(num_volumes=1, latent_spatial=(4, 4, 4), latent_channels=4,
              ddim_steps=3, device="cpu")
    a = generate_3d_volumes(p["unet"], p["vae"], p["diff"],
                            generator=torch.Generator().manual_seed(5), **kw)
    b = generate_3d_volumes(p["unet"], p["vae"], p["diff"],
                            generator=torch.Generator().manual_seed(5), **kw)
    c = generate_3d_volumes(p["unet"], p["vae"], p["diff"],
                            generator=torch.Generator().manual_seed(6), **kw)
    assert tuple(a.shape) == (1, 8, 8, 8, 2) and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_latent_shape_for_matches_jax(pipeline):
    from mrijax.generate import latent_shape_for as jlatent_shape_for

    p = pipeline
    want = jlatent_shape_for(p["jvae"], p["vp"], (8, 12, 8, 2))
    assert latent_shape_for(p["vae"], (8, 12, 8, 2), device="cpu") == tuple(want)


@pytest.mark.parametrize("kw", [
    dict(num_steps=5),
    dict(num_steps=5, to_x0=True),
    dict(num_steps=4, order=1),
    dict(num_steps=None, start_t=6),
])
def test_dpm_sample_matches_jax(pipeline, kw):
    """DPM-Solver++(2M) on a shared numpy start. Tolerance 1e-3 absolute, as
    for DDIM: float32 differences of the two UNets compound over the steps."""
    p = pipeline
    want = p["jdiff"].dpm_sample(
        lambda x, t: p["junet"].apply(p["up"], x, t), LATENT,
        x_t=jnp.asarray(p["x_t"]), **kw)
    got = p["diff"].dpm_sample(p["unet"], LATENT, x_t=torch.from_numpy(p["x_t"]), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    if kw.get("order") == 1:   # order 1 is DDIM, written in another algebraic form
        ddim = p["diff"].ddim_sample(p["unet"], LATENT, x_t=torch.from_numpy(p["x_t"]),
                                     num_steps=kw["num_steps"])
        torch.testing.assert_close(got, ddim, atol=1e-5, rtol=1e-5)
    via_front = p["diff"].fast_sample(p["unet"], LATENT, x_t=torch.from_numpy(p["x_t"]),
                                      sampler="dpm", **kw)
    torch.testing.assert_close(via_front, got, rtol=0, atol=0)


def _jax_step_noise(key, shape):
    """The per-step noise of the JAX ancestral loop for ``key``, by timestep."""
    _, loop_key = jax.random.split(key)
    return lambda i: torch.from_numpy(np.array(
        jax.random.normal(jax.random.fold_in(loop_key, i), shape, jnp.float32)))


@pytest.mark.parametrize("kw", [dict(), dict(start_t=7, end_t=3)])
def test_p_sample_loop_matches_jax(pipeline, kw):
    """Ancestral sampling on a shared start and the JAX loop's own per-step
    noise, injected by timestep. Tolerance 1e-3 absolute over up to T = 20
    steps."""
    p = pipeline
    key = jax.random.PRNGKey(11)
    want = p["jdiff"].p_sample_loop(
        lambda x, t: p["junet"].apply(p["up"], x, t), LATENT, key,
        x_t=jnp.asarray(p["x_t"]), **kw)
    got = p["diff"].p_sample_loop(p["unet"], LATENT, x_t=torch.from_numpy(p["x_t"]),
                                  step_noise=_jax_step_noise(key, LATENT), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_p_sample_step_masks_the_noise_at_t0_and_matches_jax(pipeline):
    p = pipeline
    t = np.asarray([0, 9], np.int32)
    noise = np.random.default_rng(2).normal(size=LATENT).astype(np.float32)
    want = p["jdiff"].p_sample_step(lambda x, t: 0.5 * x, jnp.asarray(p["x_t"]),
                                    jnp.asarray(t), jnp.asarray(noise))
    got = p["diff"].p_sample_step(lambda x, t: 0.5 * x, torch.from_numpy(p["x_t"]),
                                  torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    quiet = p["diff"].p_sample_step(lambda x, t: 0.5 * x, torch.from_numpy(p["x_t"]),
                                    torch.from_numpy(t).long(), torch.zeros(LATENT))
    torch.testing.assert_close(got[0], quiet[0], rtol=0, atol=0)
    assert not torch.equal(got[1], quiet[1])


def test_ancestral_variants_run_the_plain_loop(pipeline):
    """The segmented and "auto" loops keep their signatures and draw what the
    plain loop draws from the same generator; a loop split with ``end_t`` /
    ``start_t`` on one generator equals the single loop."""
    p = pipeline
    shape = (1, 4, 4, 4, 4)

    def gen():
        return torch.Generator().manual_seed(9)

    whole = p["diff"].p_sample_loop(p["unet"], shape, gen(), start_t=6)
    assert bool(torch.isfinite(whole).all())
    auto = p["diff"].p_sample_loop_auto(p["unet"], shape, gen(), start_t=6)
    seg = p["diff"].p_sample_loop_segmented(p["unet"], shape, gen(), segments=3, start_t=6)
    g = gen()
    half = p["diff"].p_sample_loop(p["unet"], shape, g, start_t=6, end_t=4)
    split = p["diff"].p_sample_loop(p["unet"], shape, g, start_t=3, x_t=half)
    for other in (auto, seg, split):
        torch.testing.assert_close(other, whole, rtol=0, atol=0)
    with pytest.raises(ValueError, match="segments"):
        p["diff"].p_sample_loop_segmented(p["unet"], shape, gen(), segments=0)
    with pytest.raises(ValueError, match="generator"):
        p["diff"].p_sample_loop(p["unet"], shape, x_t=torch.zeros(shape))


def test_generate_3d_volumes_full_ancestral_route(pipeline):
    """``ddim_steps=None`` runs the full-T ancestral loop, then the decoder."""
    p = pipeline
    kw = dict(num_volumes=1, latent_spatial=(4, 4, 4), latent_channels=4, device="cpu")
    a = generate_3d_volumes(p["unet"], p["vae"], p["diff"],
                            generator=torch.Generator().manual_seed(5), **kw)
    g = torch.Generator().manual_seed(5)
    z = p["diff"].p_sample_loop(p["unet"], (1, 4, 4, 4, 4), g)
    with torch.no_grad():
        want = p["vae"].decode_from_latent(z)
    assert tuple(a.shape) == (1, 8, 8, 8, 2)
    torch.testing.assert_close(a, want, rtol=0, atol=0)
    dpm = generate_3d_volumes(p["unet"], p["vae"], p["diff"], x_t=torch.zeros(1, 4, 4, 4, 4),
                              ddim_steps=3, sampler="dpm", **kw)
    assert bool(torch.isfinite(dpm).all())


def test_unported_samplers_say_so(pipeline):
    """Every sampler of the JAX package is ported now; what is left to say is
    which names and arguments the fronts refuse."""
    p = pipeline
    with pytest.raises(ValueError, match="unknown sampler"):
        p["diff"].fast_sample(p["unet"], LATENT, x_t=torch.zeros(LATENT), sampler="euler")
    with pytest.raises(ValueError, match="order must be 1 or 2"):
        p["diff"].dpm_sample(p["unet"], LATENT, x_t=torch.zeros(LATENT), order=3)
    with pytest.raises(ValueError, match="generator"):
        p["diff"].ddim_sample(p["unet"], LATENT)
    with pytest.raises(ValueError, match="generator"):
        p["diff"].dpm_sample(p["unet"], LATENT)


# ------------------------------------------------------------------- hygiene


def _port_sources():
    files = sorted((REPO / "mrijax_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    return files


def _forbidden(module_name: str) -> bool:
    root = module_name.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "optax", "orbax", "mrijax")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    """The port and chip_smoke.py import torch, never jax, flax or mrijax."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_every_port_module_imports_without_cuda():
    """No nvcc, no triton, no GPU is needed to import anything of the port."""
    assert not torch.cuda.is_available()
    names = [m.name for m in pkgutil.walk_packages(mrijax_torch.__path__, "mrijax_torch.")]
    assert "mrijax_torch.kernels.flash_attention" in names
    assert "mrijax_torch.kernels._build" in names
    assert "mrijax_torch.data.cnifti" in names
    assert "mrijax_torch.evals.features" in names
    for name in ("mrijax_torch.cli", "mrijax_torch.aot", "mrijax_torch.obs.energy"):
        assert name in names
    # the native NIfTI reader, which the CPU tests use, may have been built
    # already; importing builds nothing more
    built = set((REPO / "mrijax_torch" / "_build").glob("*.so"))
    for name in names:
        importlib.import_module(name)
    assert set((REPO / "mrijax_torch" / "_build").glob("*.so")) == built
    assert not any(p.name.startswith(("libgroupnorm", "libflash")) for p in built)


def test_default_device_raises_without_cuda(pipeline):
    """Entry points default to CUDA and do not fall back to the CPU."""
    p = pipeline
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        generate_3d_volumes(p["unet"], p["vae"], p["diff"], num_volumes=1,
                            latent_spatial=(4, 4, 4), latent_channels=4, ddim_steps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        latent_shape_for(p["vae"], (8, 8, 8, 2))
    # nothing was moved or run: the models still answer on the CPU
    assert next(p["unet"].parameters()).device.type == "cpu"
