"""The plain PyTorch versions of the port's flash-attention backward kernels
against ``jax.grad`` of the JAX package's Pallas kernels run in TPU interpret
mode on the CPU (as ``tests/test_flash_attention.py`` runs them), and the
``torch.autograd.Function`` around them against autograd through the
materialised attention. The CUDA kernels themselves run only on a GPU:
``chip_smoke.py`` holds them against these same plain versions there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.kernels.flash_attention_pallas import flash_attention_pallas
from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.ops.attention import multi_head_self_attention


def _pallas_grads(q, k, v, dout):
    """(dq, dk, dv) of the Pallas custom_vjp for the cotangent ``dout``."""

    def loss(q, k, v):
        out = flash_attention_pallas(q, k, v)
        return jnp.sum(out.astype(jnp.float32) * dout.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _plain_grads(q, k, v, dout):
    out, lse = fa.flash_attention_reference(q, k, v)
    return fa.flash_attention_backward_reference(q, k, v, out, lse, dout)


@pytest.mark.parametrize("b,n,h,d", [
    (1, 200, 2, 32),    # padded to the TPU block: rows and columns masked
    (2, 256, 2, 32),    # block-aligned: the TPU kernels compile their masks out
    (1, 130, 2, 64),
    (1, 300, 1, 64),    # two blocks, the second one ragged
])
def test_flash_backward_reference_matches_pallas_interpret(b, n, h, d):
    """float32, 1e-4 absolute and relative: the bar of the JAX package's own
    gradient test (blocked sums against sums taken at once)."""
    rng = np.random.default_rng(10)
    q, k, v, dout = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(4))
    want = _pallas_grads(*(jnp.asarray(a) for a in (q, k, v, dout)))
    got = _plain_grads(*(torch.from_numpy(a) for a in (q, k, v, dout)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (b, n, h, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_flash_backward_reference_bf16_matches_pallas_interpret():
    """bf16 in, bf16 gradients. Tolerance 2e-2 relative + 2e-3: both sides round
    float32 sums to bf16 (dq twice, around the Dh^-1/2 multiply), and their
    forwards may differ by one bf16 ulp of ``out``, which enters Δ — a few
    bf16 ulps (2^-8 relative each) of gradients of size ~0.1."""
    rng = np.random.default_rng(11)
    shape = (1, 128, 2, 32)
    arrays = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in arrays)
    np.testing.assert_array_equal(np.asarray(jq, np.float32), tq.float().numpy())
    want = _pallas_grads(jq, jk, jv, jdo)
    got = _plain_grads(tq, tk, tv, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=2e-2, atol=2e-3, err_msg=name)


def test_flash_backward_reference_by_blocks_of_rows():
    """``q_block`` only changes how many query rows are materialised at once
    (1e-6: the sums over rows are taken block by block)."""
    rng = np.random.default_rng(12)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(2, 90, 2, 32)).astype(np.float32))
                     for _ in range(4))
    out, lse = fa.flash_attention_reference(q, k, v)
    whole = fa.flash_attention_backward_reference(q, k, v, out, lse, dout)
    blocks = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, q_block=32)
    for a, b in zip(whole, blocks):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("strided", [False, True])
def test_flash_attention_function_matches_autograd_through_plain_attention(strided):
    """The ``autograd.Function`` on CPU tensors (plain forward and backward)
    against autograd through ``multi_head_self_attention``, with q, k, v as
    contiguous tensors and as strided slices of one fused projection; the
    output gradient arrives as a non-contiguous view. 1e-4, the bar of the JAX
    package's gradient test."""
    rng = np.random.default_rng(13)
    b, n, h, d = 2, 70, 2, 32
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3, h, d)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))

    def grads(attend):
        if strided:
            leaf = qkv.clone().requires_grad_()
            q, k, v = leaf[:, :, 0], leaf[:, :, 1], leaf[:, :, 2]
            assert not q.is_contiguous()
            leaves = (leaf,)
        else:
            leaves = tuple(qkv[:, :, i].contiguous().requires_grad_() for i in range(3))
            q, k, v = leaves
        out = attend(q, k, v)
        # the permuted product hands backward a dout that is a transposed view
        loss = (out.permute(0, 2, 1, 3) * weight).sum() + (out ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    for got, want in zip(grads(fa.flash_attention), grads(multi_head_self_attention)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_attention_function_takes_an_expanded_gradient():
    """``out.sum()`` hands backward a gradient whose strides are all 0."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 20, 1, 32)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    got = torch.autograd.grad(fa.flash_attention(q, k, v).sum(), (q, k, v))
    want = torch.autograd.grad(multi_head_self_attention(q, k, v).sum(), (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


def test_backward_wrappers_check_their_operands():
    q = torch.zeros(1, 8, 2, 32)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="dout must be"):
        fa.flash_attn_bwd_dq(q, q, q, q[:, :4], lse, lse)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attn_bwd_dkv(q, q, q, q, lse[:, :4], lse)
    with pytest.raises(ValueError, match="delta must be"):
        fa.flash_attn_bwd_dkv(q, q, q, q, lse, lse.double())
    with pytest.raises(ValueError, match="out and dout"):
        fa.flash_attention_backward(q, q, q, q[:, :4], lse, q)
    # on CPU tensors the wrappers are the plain versions and launch nothing
    fa.launches.reset()
    dk, dv = fa.flash_attn_bwd_dkv(q, q, q, q, lse, lse)
    assert tuple(dk.shape) == tuple(dv.shape) == (1, 8, 2, 32)
    assert fa.launches["flash_attn_bwd_dkv"] == 0 and fa.launches["flash_attn_bwd_dq"] == 0
