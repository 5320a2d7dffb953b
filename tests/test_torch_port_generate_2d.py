"""The 2D and 2.5D serving path — ``sample_2d`` (DDIM, DPM-Solver++, guided),
``sample_pseudo3d_sweep``, ``conditional_sample_25d`` and the two pseudo-3D
generators — against ``mrijax.generate`` on the same weights and the same
start noise. The JAX functions draw their start from their key
(``normal(key)``; per chunk ``normal(fold_in(key, s0))``, per slice
``normal(fold_in(key, k))``): the tests draw the same and hand it to the port
as ``x_t``. float32 on the CPU; tolerance 1e-4 absolute (float32 differences
of the two UNets over at most 4 sampler steps)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrijax import generate as jgen
from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.models import UNet2D as JUNet2D
from mrijax_torch.diffusion import GaussianDiffusion, linear_beta_schedule, make_schedule
from mrijax_torch.generate import (
    cfg_model_fn,
    conditional_sample_25d,
    generate_pseudo3d_hybrid,
    generate_pseudo3d_real_context,
    sample_2d,
    sample_pseudo3d_sweep,
)
from mrijax_torch.io import unet2d_state_dict_from_flax
from mrijax_torch.models import UNet2D

T = 20
STEPS = 4
SIZE = 16
RADIUS = 1
MULTS = (1, 2)
KW = dict(base_channels=8, channel_mults=MULTS, time_emb_dim=16)
ATOL = 1e-4


def random_params(module, rng, *args):
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return jax.tree_util.tree_map(
        lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree)


class SliceStandIn:
    """A 2.5D dataset as both packages' generators read it: two subjects of
    5 and 4 slices of 4 modalities, with the real neighbours (the center
    slice past the edges) as context, dz-major and modality-minor."""

    slice_radius = RADIUS

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.volume_paths = ["subject_a", "subject_b"]
        self.volumes = {p: rng.uniform(-1, 1, size=(n, SIZE, SIZE, 4)).astype(np.float32)
                        for p, n in zip(self.volume_paths, (5, 4))}
        self.slice_tuples = [(p, k) for p in self.volume_paths
                             for k in range(len(self.volumes[p]))]

    def __len__(self):
        return len(self.slice_tuples)

    def __getitem__(self, i):
        path, k = self.slice_tuples[i]
        vol = self.volumes[path]
        n = len(vol)
        neighbours = [vol[k + dz] if 0 <= k + dz < n else vol[k]
                      for dz in range(-RADIUS, RADIUS + 1) if dz != 0]
        return {"image": vol[k], "context": np.concatenate(neighbours, axis=-1),
                "z_pos": np.float32(k / (n - 1))}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    betas = linear_beta_schedule(T)
    out = {"jdiff": JGaussianDiffusion(jsched.make_schedule(betas)),
           "diff": GaussianDiffusion(make_schedule(betas)), "data": SliceStandIn()}
    for name, ch in (("1ch", dict(in_channels=1, out_channels=1)),
                     ("25d", dict(in_channels=4 + 8 * RADIUS, out_channels=4))):
        jm = JUNet2D(**ch, **KW)
        ctx = jnp.zeros((1, SIZE, SIZE, 8 * RADIUS)) if name == "25d" else None
        params = random_params(jm, rng, jnp.zeros((1, SIZE, SIZE, ch["out_channels"])),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1,)), ctx)
        model = UNet2D(**ch, **KW).eval()
        model.load_state_dict(unet2d_state_dict_from_flax(params, channel_mults=MULTS))
        out[name] = (jm, jax.tree_util.tree_map(jnp.asarray, params), model)
    return out


def start(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def close(got, want):
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("guidance_scale", [None, 2.5], ids=["plain", "guided"])
@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_sample_2d_matches_jax(setup, sampler, guidance_scale):
    jm, params, model = setup["1ch"]
    key = jax.random.PRNGKey(1)
    kw = dict(num_samples=3, image_size=SIZE, z_pos=0.3, ddim_steps=STEPS, sampler=sampler,
              guidance_scale=guidance_scale)
    want = jgen.sample_2d(jm, params, setup["jdiff"], key=key, **kw)
    got = sample_2d(model, setup["diff"], x_t=torch.from_numpy(start(key, (3, SIZE, SIZE, 1))),
                    device="cpu", **kw)
    close(got, want)


def test_guidance_scale_one_is_the_plain_model(setup):
    """ε_null + 1·(ε_cond − ε_null) = ε_cond, whatever the null half says:
    one step and a whole guided run equal the plain ones (1e-5: the two
    forwards run at another batch size)."""
    _, _, model = setup["1ch"]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, SIZE, SIZE, 1)).astype(np.float32))
    t, z = torch.tensor([3, 9, 17]), torch.tensor([0.1, 0.5, 0.9])
    with torch.no_grad():
        torch.testing.assert_close(cfg_model_fn(model, z, 1.0)(x, t), model(x, t, z),
                                   rtol=0, atol=1e-5)
    kw = dict(num_samples=3, image_size=SIZE, ddim_steps=STEPS, x_t=x, device="cpu")
    torch.testing.assert_close(sample_2d(model, setup["diff"], guidance_scale=1.0, **kw),
                               sample_2d(model, setup["diff"], **kw), rtol=0, atol=1e-5)


@pytest.mark.parametrize("guidance_scale", [None, 3.0], ids=["plain", "guided"])
def test_sample_pseudo3d_sweep_matches_jax(setup, guidance_scale):
    jm, params, model = setup["1ch"]
    key = jax.random.PRNGKey(3)
    kw = dict(num_slices=5, image_size=SIZE, ddim_steps=STEPS, sampler="dpm",
              guidance_scale=guidance_scale)
    want = jgen.sample_pseudo3d_sweep(jm, params, setup["jdiff"], key=key, **kw)
    got = sample_pseudo3d_sweep(model, setup["diff"], device="cpu",
                                x_t=torch.from_numpy(start(key, (5, SIZE, SIZE, 1))), **kw)
    close(got, want)


@pytest.mark.parametrize("guidance_scale", [None, 2.0], ids=["plain", "guided"])
def test_conditional_sample_25d_matches_jax(setup, guidance_scale):
    jm, params, model = setup["25d"]
    rng = np.random.default_rng(4)
    z = np.asarray([0.2, 0.8], np.float32)
    ctx = rng.normal(size=(2, SIZE, SIZE, 8 * RADIUS)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(ddim_steps=STEPS, guidance_scale=guidance_scale)
    want = jgen.conditional_sample_25d(jm, params, setup["jdiff"], jnp.asarray(z),
                                       jnp.asarray(ctx), key=key, **kw)
    got = conditional_sample_25d(model, setup["diff"], torch.from_numpy(z),
                                 torch.from_numpy(ctx), device="cpu",
                                 x_t=torch.from_numpy(start(key, (2, SIZE, SIZE, 4))), **kw)
    close(got, want)


def real_context_start(key, s, batch_size):
    """The JAX generator's start noise: one ``normal(fold_in(key, s0))`` per chunk."""
    return np.concatenate([start(jax.random.fold_in(key, s0), (min(batch_size, s - s0),
                                                                SIZE, SIZE, 4))
                           for s0 in range(0, s, batch_size)])


@pytest.mark.parametrize("batch_size", [None, 2], ids=["one_chunk", "chunks_of_2"])
def test_generate_pseudo3d_real_context_matches_jax(setup, batch_size):
    """Subject 1 (4 slices): all at once, and in chunks of 2 (each chunk its
    own start, as the JAX package folds the key per chunk). The chunked port
    also equals one chunk from the same whole start (1e-5: batch size only)."""
    jm, params, model = setup["25d"]
    key = jax.random.PRNGKey(5)
    kw = dict(ddim_steps=STEPS, batch_size=batch_size)
    want = jgen.generate_pseudo3d_real_context(jm, params, setup["jdiff"], setup["data"], 1,
                                               key=key, **kw)
    x_t = torch.from_numpy(real_context_start(key, 4, batch_size or 4))
    got = generate_pseudo3d_real_context(model, setup["diff"], setup["data"], 1, x_t=x_t,
                                         device="cpu", **kw)
    close(got, want)
    whole = generate_pseudo3d_real_context(model, setup["diff"], setup["data"], 1, x_t=x_t,
                                           ddim_steps=STEPS, device="cpu")
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-5)


def test_generate_pseudo3d_hybrid_matches_jax(setup):
    """Subject 0 (5 slices), ascending z: the generated slices feed their
    upper neighbours' context. The progress callback sees every slice."""
    jm, params, model = setup["25d"]
    key = jax.random.PRNGKey(6)
    want = jgen.generate_pseudo3d_hybrid(jm, params, setup["jdiff"], setup["data"], 0,
                                         key=key, ddim_steps=STEPS)
    x_t = np.concatenate([start(jax.random.fold_in(key, k), (1, SIZE, SIZE, 4))
                          for k in range(5)])
    seen = []
    got = generate_pseudo3d_hybrid(model, setup["diff"], setup["data"], 0,
                                   x_t=torch.from_numpy(x_t), ddim_steps=STEPS,
                                   progress=lambda k, n: seen.append((k, n)), device="cpu")
    close(got, want)
    assert seen == [(k, 5) for k in range(1, 6)]
    # context from generated slices: not what the real-context generator gives
    real = generate_pseudo3d_real_context(model, setup["diff"], setup["data"], 0,
                                          x_t=torch.from_numpy(x_t), ddim_steps=STEPS,
                                          device="cpu")
    torch.testing.assert_close(got[0], real[0], rtol=0, atol=1e-5)
    assert not torch.allclose(got[1:], real[1:], atol=1e-3)


def test_generators_draw_each_chunk_and_slice_in_order(setup):
    """Without ``x_t`` the start of each chunk (real context) and of each
    slice (hybrid) is drawn in order from the one generator; full-T ancestral
    sampling (``ddim_steps=None``) runs ``p_sample_loop`` on the generator."""
    _, _, model = setup["25d"]
    data, diff = setup["data"], setup["diff"]
    got = generate_pseudo3d_real_context(model, diff, data, 1, batch_size=3, ddim_steps=2,
                                         generator=torch.Generator().manual_seed(7),
                                         device="cpu")
    g = torch.Generator().manual_seed(7)
    x_t = torch.cat([torch.randn((n, SIZE, SIZE, 4), generator=g) for n in (3, 1)])
    want = generate_pseudo3d_real_context(model, diff, data, 1, batch_size=3, ddim_steps=2,
                                          x_t=x_t, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = generate_pseudo3d_hybrid(model, diff, data, 1, ddim_steps=2, device="cpu",
                                   generator=torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(8)
    x_t = torch.cat([torch.randn((1, SIZE, SIZE, 4), generator=g) for _ in range(4)])
    want = generate_pseudo3d_hybrid(model, diff, data, 1, ddim_steps=2, x_t=x_t, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    _, _, model = setup["1ch"]
    small = GaussianDiffusion(make_schedule(linear_beta_schedule(5)))
    got = sample_2d(model, small, num_samples=2, image_size=8, device="cpu",
                    generator=torch.Generator().manual_seed(9))
    z = torch.full((2,), 0.5)
    want = small.p_sample_loop(lambda x, t: model(x, t, z), (2, 8, 8, 1),
                               torch.Generator().manual_seed(9))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool(torch.isfinite(got).all())


def test_2d_entry_points_default_to_cuda_and_raise_without_it(setup):
    assert not torch.cuda.is_available()
    _, _, model = setup["25d"]
    data, diff = setup["data"], setup["diff"]
    calls = [
        lambda: sample_2d(model, diff, num_samples=1, image_size=SIZE, ddim_steps=1),
        lambda: sample_pseudo3d_sweep(model, diff, num_slices=2, image_size=SIZE,
                                      ddim_steps=1),
        lambda: conditional_sample_25d(model, diff, torch.zeros(1),
                                       torch.zeros(1, SIZE, SIZE, 8), ddim_steps=1),
        lambda: generate_pseudo3d_real_context(model, diff, data, ddim_steps=1),
        lambda: generate_pseudo3d_hybrid(model, diff, data, ddim_steps=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # nothing was moved or run: the model still answers on the CPU
    assert next(model.parameters()).device.type == "cpu"
