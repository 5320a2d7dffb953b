"""The flash-attention wrappers at head dims the kernels are not compiled for.

The CUDA kernels take Dh of 32, 64 and 128 in one piece (and multiples of
128 above that in column chunks: ``tests/test_torch_flash_large_dh.py``).
For any other Dh up to 128 the wrappers zero-pad q, k, v (and dO) along Dh
to the next of those sizes,
launch with the true scale Dh^-1/2 and cut the results back
(``at_kernel_head_dim``). Here that same helper runs on CPU tensors with the
kernels' plain versions in place of the launches, and the result is held
against the JAX package's plain attention (``multi_head_self_attention``)
and its chunked ``_chunked_attention_xla`` and their gradients, float32 at
1e-5. The kernels themselves at these head dims are held against the same
plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrijax.kernels.flash_attention import _chunked_attention_xla
from mrijax.ops.attention import multi_head_self_attention
from mrijax_torch.kernels import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL_DH = (4, 8, 16)
SHAPE = (2, 48, 2)   # B, N, H
Q_CHUNK = 16         # _chunked_attention_xla scans three chunks of query rows


def _arrays(d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(*SHAPE, d)).astype(np.float32) for _ in range(4)]


def _padded_forward(q, k, v):
    return fa.at_kernel_head_dim(fa.flash_attention_reference, q, k, v)


def _padded_backward(q, k, v, dout):
    """(out, dq, dk, dv) through the wrappers' pad, scale and slice, with the
    kernels' plain versions where the card launches the kernels."""
    out, lse = _padded_forward(q, k, v)
    delta = fa.flash_attention_delta(out, dout)
    dk, dv = fa.at_kernel_head_dim(
        lambda *t: fa.flash_attn_bwd_dkv_reference(*t[:4], lse, delta, scale=t[4]),
        q, k, v, dout)
    dq = fa.at_kernel_head_dim(
        lambda *t: fa.flash_attn_bwd_dq_reference(*t[:4], lse, delta, scale=t[4]),
        q, k, v, dout)
    return out, dq, dk, dv


@pytest.mark.parametrize("d", SMALL_DH)
def test_padded_forward_matches_jax_plain_and_chunked_attention(d):
    q, k, v, _ = _arrays(d, seed=d)
    out, lse = _padded_forward(*(torch.from_numpy(a) for a in (q, k, v)))
    assert tuple(out.shape) == (*SHAPE, d) and out.is_contiguous()
    assert tuple(lse.shape) == (SHAPE[0] * SHAPE[2], SHAPE[1])
    plain = multi_head_self_attention(*(jnp.asarray(a) for a in (q, k, v)))
    chunked = _chunked_attention_xla(*(jnp.asarray(a) for a in (q, k, v)), q_chunk=Q_CHUNK)
    np.testing.assert_allclose(out.numpy(), np.asarray(plain), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(chunked), **TOL)
    # the logsumexp of the padded launch is that of the true head dim
    s = np.einsum("bnhd,bmhd->bhnm", q, k) * d ** -0.5
    want_lse = np.log(np.exp(s).sum(-1)).reshape(-1, SHAPE[1])
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


@pytest.mark.parametrize("d", SMALL_DH)
def test_padded_backward_matches_jax_gradients(d):
    q, k, v, dout = _arrays(d, seed=10 + d)
    _, dq, dk, dv = _padded_backward(*(torch.from_numpy(a) for a in (q, k, v, dout)))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, dout))
    for fn in (multi_head_self_attention,
               lambda q, k, v: _chunked_attention_xla(q, k, v, q_chunk=Q_CHUNK)):
        _, vjp = jax.vjp(fn, jq, jk, jv)
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), vjp(jdo)):
            assert tuple(got.shape) == (*SHAPE, d) and got.is_contiguous()
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


@pytest.mark.parametrize("d,size", [(1, 32), (4, 32), (8, 32), (16, 32), (33, 64), (48, 64),
                                    (100, 128)])
def test_launch_sees_zero_padded_operands_and_the_true_scale(d, size):
    """What a launch is handed: every operand padded with zero columns to the
    compiled head dim, the scale of the true one; its padded output columns
    (zero, since the padded v columns are) are cut off."""
    assert fa.kernel_head_dim(d) == size
    q, k, v = (torch.randn(1, 5, 2, d, dtype=torch.bfloat16)[:, :, :, :d] for _ in range(3))
    seen = {}

    def launch(q, k, v, scale):
        seen.update(shapes={tuple(t.shape) for t in (q, k, v)}, scale=scale,
                    tails=[t[..., d:] for t in (q, k, v)])
        return fa.flash_attention_reference(q, k, v, scale)

    out, _ = fa.at_kernel_head_dim(launch, q, k, v)
    assert seen["shapes"] == {(1, 5, 2, size)}
    assert seen["scale"] == d ** -0.5
    assert all(not t.any() for t in seen["tails"])
    want, _ = fa.flash_attention_reference(q, k, v)
    assert torch.equal(out, want)


@pytest.mark.parametrize("d", fa.SUPPORTED_HEAD_DIMS)
def test_compiled_head_dims_go_to_the_launch_as_they_are(d):
    """No copy at 32, 64 and 128: the launch gets the caller's tensors."""
    q, k, v = (torch.zeros(1, 3, 1, d) for _ in range(3))
    got = fa.at_kernel_head_dim(lambda *t: t, q, k, v)
    assert got[0] is q and got[1] is k and got[2] is v and got[3] == d ** -0.5


@pytest.mark.parametrize("d", [0, 129, 256])
def test_head_dims_outside_1_to_128_raise(d):
    """Outside 1..128 the wrappers refuse Dh 0 and anything above
    ``MAX_HEAD_DIM`` (the grid's 65 535 column chunks of 128); above 128 they
    take Dh in column chunks, zero-padded to a multiple of 128 (129 -> 256)."""
    limit = f"head dims 1..{fa.MAX_HEAD_DIM}"
    with pytest.raises(ValueError, match=limit):
        fa.kernel_head_dim(fa.MAX_HEAD_DIM + 1)
    q = torch.zeros(1, 3, 1, d)
    if d == 0:
        with pytest.raises(ValueError, match=limit):
            fa.kernel_head_dim(d)
        with pytest.raises(ValueError, match=limit):
            fa.at_kernel_head_dim(fa.flash_attention_reference, q, q, q)
        return
    assert fa.kernel_head_dim(d) == 256
    out, lse = fa.at_kernel_head_dim(fa.flash_attention_reference, q, q, q)
    assert tuple(out.shape) == (1, 3, 1, d) and tuple(lse.shape) == (1, 3)
