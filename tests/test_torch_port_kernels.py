"""The plain PyTorch versions that stand beside the port's CUDA kernels,
against the JAX package's Pallas kernels run in TPU interpret mode on the CPU
(as ``tests/test_groupnorm_pallas.py`` and ``tests/test_flash_attention.py``
run them). The CUDA kernels themselves run only on a GPU: ``chip_smoke.py``
holds them against these same plain versions there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mrijax.kernels.flash_attention_pallas import _flash_forward_lse
from mrijax.kernels.groupnorm_pallas import group_norm_silu_pallas
from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.kernels import groupnorm as gn
from mrijax_torch.ops.norms import group_norm_silu


@pytest.mark.parametrize("shape,groups", [
    ((2, 40, 128), 8),       # (B, N, C) flat
    ((1, 6, 10, 128), 8),    # N = 60, ragged against every block size
    ((2, 3, 4, 5, 32), 4),   # (B, D, H, W, C)
    ((1, 300, 256), 8),
])
def test_group_norm_silu_reference_matches_pallas_interpret(shape, groups):
    """Tolerance 2e-5 absolute, that of the JAX package's own kernel test."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = group_norm_silu_pallas(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), groups)
    args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), groups)
    got = gn.group_norm_silu_reference(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # on a CPU tensor the wrapper is the plain version
    torch.testing.assert_close(gn.group_norm_silu_fused(*args), got, rtol=0, atol=0)


def test_group_norm_silu_reference_bf16_input_matches_pallas_interpret():
    """bf16 in, bf16 out, fp32 statistics. Tolerance: one bf16 ulp of the
    output (both sides round a float32 result once)."""
    rng = np.random.default_rng(1)
    x32 = rng.normal(size=(1, 64, 128)).astype(np.float32) * 10
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x32).bfloat16()
    np.testing.assert_array_equal(np.asarray(xj, np.float32), xt.float().numpy())
    with pltpu.force_tpu_interpret_mode():
        want = group_norm_silu_pallas(xj, jnp.ones((128,)), jnp.zeros((128,)), 8)
    got = gn.group_norm_silu_reference(xt, torch.ones(128), torch.zeros(128), 8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("shape,groups", [
    ((2, 40, 128), 8),
    ((1, 6, 10, 128), 8),
    ((2, 3, 4, 5, 32), 4),
])
def test_group_norm_silu_function_gradients_match_pallas_vjp(shape, groups):
    """Gradients of the ``autograd.Function`` (x, scale and bias) against
    ``jax.grad`` of ``group_norm_silu_pallas`` and against autograd through
    the plain composition; 1e-4, the bar of ``tests/test_groupnorm_pallas.py``."""
    rng = np.random.default_rng(5)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)

    def loss(xx, ss, bb):
        return jnp.sum(group_norm_silu_pallas(xx, ss, bb, groups) * jnp.asarray(dy))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, scale, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = gn.group_norm_silu_fused(*leaves, groups)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    plain = torch.autograd.grad(group_norm_silu(leaves[0], groups, *leaves[1:]), leaves,
                                torch.from_numpy(dy))
    for name, g, w, p in zip(("dx", "dscale", "dbias"), got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4, err_msg=name)
        torch.testing.assert_close(g, p, atol=1e-5, rtol=1e-5)


def test_group_norm_silu_function_gradient_for_a_subset_of_inputs():
    """Only x needs a gradient (frozen affine parameters), bf16 activation:
    the gradient keeps the input's dtype and the others stay None."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(1, 30, 16)).astype(np.float32)).bfloat16()
    x.requires_grad_()
    scale, bias = torch.ones(16), torch.zeros(16)
    gn.group_norm_silu_fused(x, scale, bias, 4).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and bool(torch.isfinite(x.grad).all())
    assert scale.grad is None and bias.grad is None
    y = x.detach().requires_grad_()
    group_norm_silu(y, 4, scale, bias).float().sum().backward()
    torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=0)


def test_stats_and_apply_references_compose():
    """gn_silu_stats → gn_silu_apply is the fused op; stats are (B, 2, G)
    fp32 mean and 1/std."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 50, 24)).astype(np.float32) + 1.0)
    scale = torch.from_numpy(rng.normal(size=(24,)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(24,)).astype(np.float32))
    stats = gn.gn_silu_stats(x, 8)
    assert tuple(stats.shape) == (2, 2, 8) and stats.dtype == torch.float32
    xg = x.reshape(2, 50, 8, 3)
    torch.testing.assert_close(stats[:, 0], xg.mean(dim=(1, 3)), atol=1e-6, rtol=0)
    torch.testing.assert_close(
        stats[:, 1], torch.rsqrt(xg.var(dim=(1, 3), correction=0) + 1e-5),
        atol=1e-5, rtol=0)
    torch.testing.assert_close(gn.gn_silu_apply(x, stats, scale, bias),
                               gn.group_norm_silu_reference(x, scale, bias, 8))


@pytest.mark.parametrize("n,c,groups,itemsize,alignment,want_vec", [
    (51200, 128, 8, 2, 16, 8),
    (3276800, 32, 8, 2, 16, 8),     # 4 channels a group: a vector spans two groups
    (409600, 64, 8, 4, 16, 4),
    (1000, 24, 8, 4, 16, 1),        # 3 channels a group: scalar loads
    (800, 1024, 8, 2, 16, 8),
    (800, 1024, 8, 2, 4, 2),        # a pointer aligned to 4 bytes only
    (800, 2048, 8, 4, 16, 4),       # more vector columns than threads
])
def test_launch_plan_covers_the_tensor(n, c, groups, itemsize, alignment, want_vec):
    """The Python side of the stats kernel's launch: vector width, block
    shape, and slabs of ty·R rows that cover the rows, ``blocks`` apart."""
    plan = gn.launch_plan(n, c, groups, itemsize, alignment, 2)
    assert plan.vec == want_vec
    assert c % plan.vec == 0 and plan.vec * itemsize <= 16
    cols = c // plan.vec
    assert plan.tx == min(1 << (cols - 1).bit_length(), 256) and plan.tx * plan.ty == 256
    assert plan.slabs * plan.slab_rows >= n > (plan.slabs - 1) * plan.slab_rows
    assert plan.blocks * plan.slabs_per_block >= plan.slabs
    assert plan.blocks <= -(-gn.STATS_BLOCKS_PER_SM * gn.SM_COUNT // 2)


def test_launch_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="not divisible"):
        gn.launch_plan(10, 30, 8, 4)
    with pytest.raises(ValueError, match="groups"):
        gn.launch_plan(10, 256, 256, 4)
    with pytest.raises(ValueError, match="channels"):   # beyond 227 KB of shared memory
        gn.launch_plan(10, gn.MAX_CHANNELS + 8, 8, 4, alignment=4)


@pytest.mark.parametrize("b,n,h,d", [
    (1, 200, 2, 16),    # padded to the TPU block
    (2, 256, 2, 32),    # block-aligned: the TPU kernel compiles its mask out
    (1, 130, 4, 64),
])
def test_flash_attention_reference_matches_pallas_interpret(b, n, h, d):
    """(out, lse) against ``_flash_forward_lse``. Tolerance 1e-5: float32
    online softmax against a materialised one."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want_out, want_lse = _flash_forward_lse(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = fa.flash_attention_reference(tq, tk, tv)
    assert tuple(out.shape) == (b, n, h, d) and tuple(lse.shape) == (b * h, n)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=1e-5, rtol=1e-5)
    # on CPU tensors the wrapper and the front are the plain version
    w_out, w_lse = fa.flash_attention_forward(tq, tk, tv)
    torch.testing.assert_close(w_out, out, rtol=0, atol=0)
    torch.testing.assert_close(w_lse, lse, rtol=0, atol=0)
    torch.testing.assert_close(fa.flash_attention(tq, tk, tv), out, rtol=0, atol=0)


def test_flash_attention_reference_takes_strided_qkv_slices():
    """The attention block hands over slices of one fused (B, N, 3, H, Dh)
    projection; the result must not depend on the layout."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(1, 70, 3, 2, 32)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, lse = fa.flash_attention_forward(q, k, v)
    out_c, lse_c = fa.flash_attention_forward(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, out_c, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_c, rtol=0, atol=0)
    with pytest.raises(ValueError, match="share one"):
        fa.flash_attention_forward(q, k[:, :10], v)


def test_launch_counts_only_count_kernel_launches():
    """On the CPU no kernel is launched, so no count moves; reset() zeroes."""
    gn.launches.reset()
    fa.launches.reset()
    x = torch.ones(1, 8, 16, requires_grad=True)
    gn.group_norm_silu_fused(x, torch.ones(16), torch.zeros(16), 8).sum().backward()
    q = torch.ones(1, 4, 1, 32, requires_grad=True)
    fa.flash_attention(q, q, q).sum().backward()
    assert gn.launches.as_dict() == {"gn_silu_stats": 0, "gn_silu_apply": 0,
                                     "gn_silu_bwd_reduce": 0, "gn_silu_bwd_apply": 0}
    assert fa.launches.as_dict() == {"flash_attn_fwd": 0, "flash_attn_bwd_dkv": 0,
                                     "flash_attn_bwd_dq": 0}
    gn.launches.bump("gn_silu_apply")
    assert gn.launches["gn_silu_apply"] == 1
    gn.launches.reset()
    assert gn.launches["gn_silu_apply"] == 0
