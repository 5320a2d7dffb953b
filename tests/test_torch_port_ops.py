"""The port's plain ops, schedules and DDIM timestep grid against their
``mrijax`` counterparts, on the same numpy inputs, float32 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.ops import attention as jattention
from mrijax.ops import embeddings as jembeddings
from mrijax.ops import norms as jnorms
from mrijax.ops import resize as jresize
from mrijax_torch.diffusion import GaussianDiffusion, schedules
from mrijax_torch.ops import (
    center_crop_to,
    group_norm,
    group_norm_silu,
    group_norm_silu_auto,
    multi_head_self_attention,
    sinusoidal_time_embedding,
)


def _norm_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape,groups", [
    ((2, 40, 32), 8),
    ((1, 3, 4, 5, 16), 4),
    ((2, 6, 10, 24), 8),
])
@pytest.mark.parametrize("fn_name", ["group_norm", "group_norm_silu", "group_norm_silu_auto"])
def test_group_norm_variants_match_jax(shape, groups, fn_name):
    """Tolerance 2e-5 absolute: float32 statistics summed in another order."""
    x, scale, bias = _norm_inputs(shape, 0)
    fn = {"group_norm": group_norm, "group_norm_silu": group_norm_silu,
          "group_norm_silu_auto": group_norm_silu_auto}[fn_name]
    # the CPU route of the JAX dispatcher is its plain composition
    jfn = {"group_norm": jnorms.group_norm, "group_norm_silu": jnorms.group_norm_silu,
           "group_norm_silu_auto": jnorms.group_norm_silu}[fn_name]
    got = fn(torch.from_numpy(x), groups, torch.from_numpy(scale), torch.from_numpy(bias))
    want = jfn(jnp.asarray(x), groups, jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_group_norm_keeps_bf16_and_rejects_bad_groups():
    x = torch.randn(1, 10, 16, generator=torch.Generator().manual_seed(0)).bfloat16()
    out = group_norm(x, 8, torch.ones(16), torch.zeros(16))
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="not divisible"):
        group_norm(x, 5, torch.ones(16), torch.zeros(16))


@pytest.mark.parametrize("b,n,h,d", [(2, 50, 4, 16), (1, 130, 2, 32)])
def test_multi_head_self_attention_matches_jax(b, n, h, d):
    """Tolerance 1e-5: float32 softmax and products, another summation order."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    got = multi_head_self_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jattention.multi_head_self_attention(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim", [32, 33, 256])
def test_sinusoidal_time_embedding_matches_jax(dim):
    """Even and odd dims. Tolerance 2e-4 absolute: the angle t·freq reaches
    ~400, where one float32 ulp of the argument is 3e-5 and the two
    frameworks' exp/sin/cos differ in the last bits."""
    t = np.asarray([0, 1, 7, 199, 399], np.int32)
    got = sinusoidal_time_embedding(torch.from_numpy(t), dim)
    want = jembeddings.sinusoidal_time_embedding(jnp.asarray(t), dim)
    assert tuple(got.shape) == (5, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    with pytest.raises(ValueError):
        sinusoidal_time_embedding(torch.from_numpy(t), 3)


@pytest.mark.parametrize("target", [(4, 6, 5), (5, 7, 6), (2, 2, 2)])
def test_center_crop_to_matches_jax(target):
    x = np.random.default_rng(2).normal(size=(2, 5, 7, 6, 3)).astype(np.float32)
    got = center_crop_to(torch.from_numpy(x), target)
    want = jresize.center_crop_to(jnp.asarray(x), target)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="exceeds"):
        center_crop_to(torch.from_numpy(x), (6, 7, 6))


@pytest.mark.parametrize("kind,timesteps", [("linear", 50), ("cosine", 50), ("cosine", 400)])
def test_schedules_match_jax(kind, timesteps):
    """Betas are float64 numpy on both sides (exact); the derived float32
    buffers agree to 1e-7 relative."""
    name = f"{kind}_beta_schedule"
    betas = getattr(schedules, name)(timesteps)
    jbetas = getattr(jsched, name)(timesteps)
    np.testing.assert_array_equal(betas, jbetas)
    got, want = schedules.make_schedule(betas), jsched.make_schedule(jbetas)
    assert got.timesteps == want.timesteps == timesteps
    for field in ("betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
                  "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                  "sqrt_recip_alphas", "snr", "posterior_variance",
                  "posterior_log_variance_clipped"):
        a = getattr(got, field)
        assert a.dtype == torch.float32 and tuple(a.shape) == (timesteps,)
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-7, atol=0, err_msg=field)


@pytest.mark.parametrize("num_steps,start_t", [
    (None, None), (5, None), (20, None), (50, None), (10, 30), (None, 7), (3, 0),
])
def test_ddim_timestep_sequence_is_exact(num_steps, start_t):
    betas = schedules.cosine_beta_schedule(40)
    got = GaussianDiffusion(schedules.make_schedule(betas)).ddim_timestep_sequence(
        num_steps, start_t)
    want = JGaussianDiffusion(jsched.make_schedule(betas)).ddim_timestep_sequence(
        num_steps, start_t)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_q_sample_matches_jax():
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(3, 4, 4, 4, 2)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.asarray([0, 7, 19], np.int32)
    betas = schedules.linear_beta_schedule(20)
    got = GaussianDiffusion(schedules.make_schedule(betas)).q_sample(
        torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(noise))
    want = JGaussianDiffusion(jsched.make_schedule(betas)).q_sample(
        jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
