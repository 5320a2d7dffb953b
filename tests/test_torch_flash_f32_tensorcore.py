"""The arithmetic of the float32 flash backward kernels, emulated in plain
PyTorch on the CPU, and their launch plans.

On the card ``flash_attn_bwd_dkv`` and ``flash_attn_bwd_dq`` take float32
operands through Hopper's warpgroup products in TF32 (``wgmma``, k = 8), three
passes a product: every operand x is split into hi = x truncated to TF32 (the
13 low mantissa bits cleared) and lo = x − hi, of which the tensor cores read
the TF32 part (emulated here as truncated too, the coarser of the two ways
hardware can read it), and A·B = hi_a·hi_b + hi_a·lo_b + lo_a·hi_b, summed in
float32 — the TPU
kernels' ``Precision.HIGHEST`` done with TF32 instead of bf16 passes. A block
owns 32 keys (dkv) or query rows (dq) and takes the other side in tiles of 64
rows; the emulation goes tile by tile the same way: the logits S and dP, P =
exp(S − lse) and dU = P∘(dP − Δ) (the kernel's P = 2^(S·log2e − lse·log2e) on
the special-function unit is within 2^-22 of it), then dVᵀ += dOᵀ·P, dKᵀ += q′ᵀ·dU (dkv) or dQ′ᵀ += Kᵀ·dUᵀ
(dq). The emulation runs no CUDA code: it shows that three TF32 passes meet
the bar the card holds the kernels to (1e-4 absolute against the plain
versions) and one pass does not, not that the kernel does; ``chip_smoke.py``
and ``tests/test_torch_port_cuda.py`` hold the kernels against the plain
versions on the card. Two cases hold the emulation against the JAX package's
``_dkv_kernel`` and ``_dq_kernel`` in TPU interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mrijax.kernels.flash_attention_pallas import flash_attention_pallas
from mrijax_torch.kernels import flash_attention as fa

TILE = 64          # rows of the other side a step
CARD_BAR = 1e-4    # float32 dk, dv and dq against the plain versions on the card


def _tf32(x):
    """x truncated to TF32: the 13 low mantissa bits cleared, as the kernel
    makes hi (and as the tensor cores may read a float that is not TF32)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _terms(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(spec, a, b, passes):
    """einsum ``spec`` of float32 a and b as the kernel's products: with
    ``passes`` = 3, hi·hi + hi·lo + lo·hi of the TF32 terms, summed in
    float32; with 1, hi·hi alone."""
    (ah, al), (bh, bl) = _terms(a), _terms(b)
    out = torch.einsum(spec, ah, bh)
    if passes == 3:
        out = out + torch.einsum(spec, ah, bl) + torch.einsum(spec, al, bh)
    return out


def _operands(q_shape, nk, seed):
    """q, dO (B, Nq, H, Dh) and k, v (B, Nk, H, Dh) from numpy, and the plain
    forward's lse and Δ."""
    b, nq, h, d = q_shape
    rng = np.random.default_rng(seed)
    q, dout = (torch.from_numpy(rng.normal(size=q_shape).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, nk, h, d)).astype(np.float32)) for _ in range(2))
    out, lse = fa.flash_attention_reference(q, k, v)
    return q, k, v, dout, lse, fa.flash_attention_delta(out, dout)


def _dkv_emulation(q, k, v, dout, lse, delta, passes=3):
    """dkv's arithmetic: per tile of 64 query rows S = q′·kᵀ and dP = dO·vᵀ,
    P = exp(S − lse), dU = P∘(dP − Δ); dVᵀ += dOᵀ·P and
    dKᵀ += q′ᵀ·dU, every product in ``passes`` TF32 passes."""
    b, nq, h, d = q.shape
    scale = d ** -0.5
    lse, delta = lse.reshape(b, h, nq, 1), delta.reshape(b, h, nq, 1)
    dk_t = torch.zeros(b, h, d, k.shape[1])
    dv_t = torch.zeros_like(dk_t)
    for r0 in range(0, nq, TILE):
        rows = slice(r0, r0 + TILE)
        qp, do = q[:, rows] * scale, dout[:, rows]
        p = torch.exp(_mm("bnhd,bmhd->bhnm", qp, k, passes) - lse[:, :, rows])
        dp = _mm("bnhd,bmhd->bhnm", do, v, passes)
        du = p * (dp - delta[:, :, rows])
        dv_t += _mm("bnhd,bhnm->bhdm", do, p, passes)
        dk_t += _mm("bnhd,bhnm->bhdm", qp, du, passes)
    return dk_t.permute(0, 3, 1, 2), dv_t.permute(0, 3, 1, 2)


def _dq_emulation(q, k, v, dout, lse, delta, passes=3):
    """dq's arithmetic: per tile of 64 keys Sᵀ = k·q′ᵀ and dPᵀ = v·dOᵀ,
    P = exp(Sᵀ − lse), dU = P∘(dPᵀ − Δ); dQ′ᵀ += kᵀ·dU, every product in
    ``passes`` TF32 passes; dq = dQ′·Dh^-1/2 in float32."""
    b, nq, h, d = q.shape
    scale = d ** -0.5
    qp = q * scale
    lse, delta = lse.reshape(b, h, 1, nq), delta.reshape(b, h, 1, nq)
    dq_t = torch.zeros(b, h, d, nq)
    for k0 in range(0, k.shape[1], TILE):
        keys = slice(k0, k0 + TILE)
        kt, vt = k[:, keys], v[:, keys]
        p = torch.exp(_mm("bmhd,bnhd->bhmn", kt, qp, passes) - lse)
        du = p * (_mm("bmhd,bnhd->bhmn", vt, dout, passes) - delta)
        dq_t += _mm("bmhd,bhmn->bhdn", kt, du, passes)
    return dq_t.permute(0, 3, 1, 2) * scale


def _max_err(got, want):
    return float((got - want).abs().max())


# Dh 32, 64, 128, 256, ragged N; the last two Nq != Nk (sequence-parallel chunks)
CASES = [((1, 130, 2, 32), 130), ((1, 100, 3, 64), 100), ((1, 200, 2, 128), 200),
         ((1, 96, 1, 256), 96), ((1, 48, 2, 64), 130), ((2, 70, 1, 128), 150)]


@pytest.mark.parametrize("q_shape,nk", CASES)
def test_three_tf32_passes_meet_the_card_bar(q_shape, nk):
    """dk, dv and dq of three TF32 passes a product within 1e-4 of the plain
    versions: hi + lo is x to 2^-20, the dropped lo·lo term is 2^-20
    relative, so the sums differ from float32's in their last digits."""
    q, k, v, dout, lse, delta = _operands(q_shape, nk, seed=sum(q_shape) + nk)
    want_dk, want_dv = fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta)
    want_dq = fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta)
    dk, dv = _dkv_emulation(q, k, v, dout, lse, delta)
    dq = _dq_emulation(q, k, v, dout, lse, delta)
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv), ("dq", dq, want_dq)):
        assert got.shape == want.shape, name
        assert _max_err(got, want) <= CARD_BAR, (name, _max_err(got, want))


@pytest.mark.parametrize("q_shape,nk", [((1, 200, 2, 128), 200), ((1, 96, 1, 256), 96)])
def test_one_tf32_pass_misses_the_card_bar(q_shape, nk):
    """Why three passes: with every operand cut to TF32 once (2^-10
    relative) dk, dv or dq miss the 1e-4 bar; on the same inputs three
    passes meet it."""
    q, k, v, dout, lse, delta = _operands(q_shape, nk, seed=sum(q_shape) + nk)
    want = (*fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta),
            fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta))

    def worst(passes):
        got = (*_dkv_emulation(q, k, v, dout, lse, delta, passes),
               _dq_emulation(q, k, v, dout, lse, delta, passes))
        return max(_max_err(g, w) for g, w in zip(got, want))

    assert worst(1) > 2 * CARD_BAR
    assert worst(3) <= CARD_BAR


def test_tf32_split_keeps_twenty_bits():
    """hi keeps 11 significant bits (1 + 2^-10 stays, 1 + 2^-11 becomes 1,
    negatives mirror), hi + lo with lo cut to TF32 too keeps x to 2^-20."""
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, -(1 + 2 ** -11 + 2 ** -12), 3.0])
    assert _tf32(x).tolist() == [1 + 2 ** -10, 1.0, -1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi, lo = _terms(y)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2 ** -20
    assert float(((hi - y).abs() / y.abs()).max()) <= 2 ** -10


@pytest.mark.parametrize("n,h,d", [(72, 2, 32), (130, 1, 64), (64, 1, 128), (40, 1, 256)])
def test_three_tf32_passes_match_pallas_interpret(n, h, d):
    """dq, dk and dv of the emulation against ``jax.grad`` through the JAX
    package's Pallas kernels (``_dkv_kernel``, ``_dq_kernel``, float32 at
    ``Precision.HIGHEST``) in TPU interpret mode, on the same numpy inputs,
    within the card's 1e-4."""
    rng = np.random.default_rng(n + d)
    arrays = [rng.normal(size=(1, n, h, d)).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)

    def loss(q, k, v):
        return jnp.sum(flash_attention_pallas(q, k, v) * jdo)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v, dout = (torch.from_numpy(a) for a in arrays)
    out, lse = fa.flash_attention_reference(q, k, v)
    delta = fa.flash_attention_delta(out, dout)
    got = (_dq_emulation(q, k, v, dout, lse, delta), *_dkv_emulation(q, k, v, dout, lse, delta))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=CARD_BAR, rtol=0, err_msg=name)


# ------------------------------------------------------------------ launch plan


@pytest.mark.parametrize("d,chunks", [(32, 1), (64, 1), (128, 1), (256, 1), (384, 3),
                                      (512, 2)])
@pytest.mark.parametrize("kernel", ["flash_attn_bwd_dkv", "flash_attn_bwd_dq"])
def test_float32_backward_launch_plan(kernel, d, chunks):
    """32 keys or query rows and two warpgroups a block, ``chunks`` column
    chunks above Dh 128 (256 columns each, 128 at an odd multiple of 128:
    the logits once a chunk), and the shared memory the source lays out,
    within the 227 KB a block may ask for: 226 KB (dkv) and 209 KB (dq) at
    Dh 128 and above (one block an SM), less below."""
    b, n, h = 8, 800, 1
    plan = fa.launch_plan(kernel, b, n, h, d, torch.float32)
    assert (plan.tile, plan.warps, plan.chunks) == (32, 8, chunks)
    assert plan.blocks == b * h * -(-n // 32) * chunks
    dkv = kernel == "flash_attn_bwd_dkv"
    own = 4 * 32 * d * 4 if d <= 128 else 2 * 4 * 32 * 64 * 4
    slots = 2 * 2 * 64 * min(d, 128) * 4
    terms = (4 if dkv else 2) * 32 * 64 * 4
    assert plan.shared_bytes == 1024 + own + terms + slots + (1024 if dkv else 0)
    assert plan.shared_bytes <= fa.MAX_SHARED_BYTES == 232448
    if d >= 128:
        assert plan.shared_bytes == (231424 if dkv else 214016)
        assert 2 * plan.shared_bytes > fa.MAX_SHARED_BYTES
