"""The arithmetic of the float32 flash forward kernel, emulated in plain
PyTorch on the CPU, and its launch plans.

On the card ``flash_attn_fwd`` takes float32 operands through Hopper's
warpgroup products in TF32 (``wgmma``, k = 8), three passes a product, as
the float32 backward does (``tests/test_torch_flash_f32_tensorcore.py``):
every operand x is split into hi = x truncated to TF32 and lo = x − hi, of
which the tensor cores read the TF32 part (emulated as truncated too), and
A·B = hi_a·hi_b + hi_a·lo_b + lo_a·hi_b, summed in float32. A block owns
64 query rows (32 above Dh 256) and walks the keys in tiles of 64; the
emulation goes tile by tile the same way: the logits Sᵀ = K·q′ᵀ with
q′ = q·Dh^-1/2 in float32, summed as two partial sums (each warpgroup takes
half of every unit of min(Dh, 128) columns) that are then added; the online
max m and its rescale α = exp(m_old − m); P = exp(S − m) (the kernel's
2^(S·log2e − m·log2e) on the special-function unit is within 2^-22 of it),
split into its terms for the tile's Vᵀ·Pᵀ, which is summed from zero and
added to α·Oᵀ; l the sum of the unrounded P; at the end out = O/l and
lse = m + log(max(l, 1e-30)). The emulation runs no CUDA
code: it shows that three TF32 passes meet the bar the card holds the kernel
to (1e-4 on out and lse against the plain version, 1e-5 on out at a long N)
and that one pass does not, not that the kernel does; ``chip_smoke.py`` and
``tests/test_torch_port_cuda.py`` hold the kernel against the plain version
on the card. One case holds the emulation against the JAX package's
``_flash_kernel`` (``_flash_forward_lse``) in TPU interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mrijax.kernels.flash_attention_pallas import _flash_forward_lse
from mrijax_torch.kernels import flash_attention as fa

TILE = 64          # keys a step
UNIT = 128         # columns of a unit above Dh 128
CARD_BAR = 1e-4    # float32 out and lse against the plain version on the card
LONG_BAR = 1e-5    # out at a long N, where it is of size ~0.01


def _tf32(x):
    """x truncated to TF32: the 13 low mantissa bits cleared."""
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


def _warpgroup_columns(d):
    """The head-dim columns whose logits each warpgroup sums: half of every
    unit of min(Dh, 128) columns."""
    unit = min(d, UNIT)
    cols = torch.arange(d)
    first = (cols % unit) < unit // 2
    return cols[first], cols[~first]


def _forward_emulation(q, k, v, passes=3):
    """The kernel's arithmetic: per tile of 64 keys the two warpgroups'
    partial logits Sᵀ = K·q′ᵀ, added; the online max and α; P = exp(S − m),
    l = α·l + ΣP, Oᵀ = α·Oᵀ + Vᵀ·Pᵀ, every product in ``passes`` TF32
    passes; out = O/l, lse = m + log(max(l, 1e-30))."""
    b, nq, h, d = q.shape
    qp = q * d ** -0.5
    halves = _warpgroup_columns(d)
    m = torch.full((b, h, nq), -1e30)
    l = torch.zeros(b, h, nq)
    o_t = torch.zeros(b, h, d, nq)
    for k0 in range(0, k.shape[1], TILE):
        keys = slice(k0, k0 + TILE)
        kt, vt = k[:, keys], v[:, keys]
        s = sum(_mm("bmhd,bnhd->bhmn", kt[..., cols], qp[..., cols], passes) for cols in halves)
        mn = torch.maximum(m, s.amax(dim=2))
        alpha = torch.exp(m - mn)
        p = torch.exp(s - mn[:, :, None])
        l = alpha * l + p.sum(dim=2)
        o_t = alpha[:, :, None] * o_t + _mm("bmhd,bhmn->bhdn", vt, p, passes)
        m = mn
    out = (o_t / l[:, :, None]).permute(0, 3, 1, 2)
    return out, (m + torch.log(torch.clamp(l, min=1e-30))).reshape(b * h, nq)


def _operands(q_shape, nk, seed):
    b, nq, h, d = q_shape
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=q_shape).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, nk, h, d)).astype(np.float32)) for _ in range(2))
    return q, k, v


def _max_err(got, want):
    return float((got - want).abs().max())


# Dh 32, 64, 128, 256, ragged N; the last two Nq != Nk (sequence-parallel chunks)
CASES = [((1, 130, 2, 32), 130), ((1, 100, 3, 64), 100), ((1, 200, 2, 128), 200),
         ((1, 96, 1, 256), 96), ((1, 48, 2, 64), 130), ((2, 70, 1, 128), 150)]


@pytest.mark.parametrize("q_shape,nk", CASES)
def test_three_tf32_passes_meet_the_card_bar(q_shape, nk):
    """out and lse of three TF32 passes a product within 1e-4 of the plain
    version: hi + lo is x to 2^-20, the dropped lo·lo term is 2^-20
    relative."""
    q, k, v = _operands(q_shape, nk, seed=sum(q_shape) + nk)
    want_out, want_lse = fa.flash_attention_reference(q, k, v)
    out, lse = _forward_emulation(q, k, v)
    assert out.shape == want_out.shape and lse.shape == want_lse.shape
    assert _max_err(out, want_out) <= CARD_BAR
    assert _max_err(lse, want_lse) <= CARD_BAR


@pytest.mark.parametrize("q_shape,nk", [((1, 200, 2, 128), 200), ((1, 96, 1, 256), 96)])
def test_one_tf32_pass_misses_the_card_bar(q_shape, nk):
    """Why three passes (and not ``allow_tf32``'s one): with every operand
    cut to TF32 once (2^-10 relative) out or lse miss the 1e-4 bar, and
    their error is at least 8 times that of three passes on the same
    inputs."""
    q, k, v = _operands(q_shape, nk, seed=sum(q_shape) + nk)
    want = fa.flash_attention_reference(q, k, v)

    def worst(passes):
        return max(_max_err(g, w) for g, w in zip(_forward_emulation(q, k, v, passes), want))

    one, three = worst(1), worst(3)
    assert one > CARD_BAR
    assert one >= 8 * three
    assert three <= CARD_BAR


def test_three_tf32_passes_meet_the_long_bar():
    """At 8192 keys out is of size ~0.01 and lse sums 128 tiles: three passes
    keep out within 1e-5 of the plain version (and lse within 1e-4), as the
    card's check at N = 51 200 asks."""
    q, k, v = _operands((1, 8192, 1, 32), 8192, seed=8192)
    q = q[:, ::16]   # 512 query rows against all 8192 keys
    want_out, want_lse = fa.flash_attention_reference(q, k, v)
    out, lse = _forward_emulation(q, k, v)
    assert float(want_out.abs().mean()) < 0.05
    assert _max_err(out, want_out) <= LONG_BAR
    assert _max_err(lse, want_lse) <= CARD_BAR


@pytest.mark.parametrize("n,h,d", [(72, 2, 32), (130, 1, 64), (64, 1, 128), (40, 1, 256)])
def test_three_tf32_passes_match_pallas_interpret(n, h, d):
    """out and lse of the emulation against the JAX package's ``_flash_kernel``
    (float32 at ``Precision.HIGHEST``) in TPU interpret mode, on the same
    numpy inputs, within the card's 1e-4."""
    rng = np.random.default_rng(n + d)
    arrays = [rng.normal(size=(1, n, h, d)).astype(np.float32) for _ in range(3)]
    with pltpu.force_tpu_interpret_mode():
        want_out, want_lse = _flash_forward_lse(*(jnp.asarray(a) for a in arrays))
    out, lse = _forward_emulation(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=CARD_BAR, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=CARD_BAR, rtol=0)


# ------------------------------------------------------------------ launch plan


def _layout_bytes(own, d):
    """``f32::Layout`` of ``csrc/flash_attention_fwd.cu`` written out: 1 KB of
    alignment, the q′ terms, a ring of as many slots as fit (4 at most),
    P's two terms of own × 64, α and l."""
    resident = d <= 512
    unit = min(d, UNIT)
    terms = 2 * own * d * 4 if resident else 2 * 2 * own * unit * 4
    slot = 64 * unit * 4 + (0 if resident else own * unit * 4)
    fixed = 1024 + terms + 2 * own * 64 * 4 + 2 * own * 4
    ring = min(4, (fa.MAX_SHARED_BYTES - fixed) // slot)
    assert ring >= 2
    return fixed + ring * slot


@pytest.mark.parametrize("d,own,chunks,shared", [
    (32, 64, 1, 83456), (64, 64, 1, 132608), (128, 64, 1, 230912), (256, 64, 1, 230912),
    (384, 32, 1, 214272), (512, 32, 1, 214272), (640, 32, 5, 230656), (768, 32, 3, 230656),
    (1024, 32, 2, 230656)])
def test_float32_forward_launch_plan(d, own, chunks, shared):
    """64 query rows a block up to Dh 256 and 32 above, two warpgroups; one
    block holds every output column up to Dh 512 (the logits once), above
    that chunks of 512 (256, 128 where Dh is no multiple of 512); the shared
    memory the source lays out, within the 227 KB a block may ask for, one
    block an SM at Dh 128 and above."""
    b, n, h = 8, 800, 1
    plan = fa.launch_plan("flash_attn_fwd", b, n, h, d, torch.float32)
    assert (plan.tile, plan.warps, plan.chunks) == (own, 8, chunks)
    assert plan.blocks == b * h * -(-n // own) * chunks
    assert plan.shared_bytes == _layout_bytes(own, d) == shared
    assert plan.shared_bytes <= fa.MAX_SHARED_BYTES == 232448
    if d >= 128:
        assert 2 * plan.shared_bytes > fa.MAX_SHARED_BYTES


@pytest.mark.parametrize("b,n,h,d,blocks", [(2, 800, 4, 128, 104), (8, 800, 4, 128, 416),
                                            (8, 6400, 1, 256, 800), (8, 800, 1, 512, 200),
                                            (1, 51200, 4, 32, 3200)])
def test_float32_forward_blocks_at_the_main_shapes(b, n, h, d, blocks):
    plan = fa.launch_plan("flash_attn_fwd", b, n, h, d, torch.float32)
    assert plan.blocks == blocks


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_forward_launch_names_a_misaligned_float32_operand(name):
    """The float32 forward moves its tiles in 16-byte asynchronous copies:
    before anything is built or launched, its launch refuses an operand that
    starts 4 bytes into its buffer, and names it."""
    shape = (1, 40, 2, 32)
    operands = dict(zip("qkv", _operands(shape, 40, seed=7)))
    flat = torch.zeros(operands[name].numel() + 4)
    operands[name] = flat[1:1 + operands[name].numel()].view(shape)
    with pytest.raises(ValueError, match=rf"^{name}: data pointer is not 16-byte aligned"):
        fa._launch_forward(*operands.values(), shape[-1] ** -0.5)
