"""What surrounds the bf16 tensor-core flash-attention kernels and can be
checked without a GPU: the arithmetic of their design (emulated here in plain
PyTorch, tile by tile), the launch plan, and the alignment check of the
wrappers.

The arithmetic tests run no CUDA code. They hold the emulation against the
port's own plain versions (``flash_attention_reference``,
``flash_attn_bwd_dkv_reference``, ``flash_attn_bwd_dq_reference``): they show
that two bf16 terms of P and dU can meet the bar of the card and one cannot,
not that the kernel does. Two cases hold the emulations against the JAX
package's Pallas ``_dkv_kernel`` and ``_dq_kernel`` in interpret mode. The parity of the plain versions with the Pallas kernels is
in ``tests/test_torch_port_kernels.py`` and ``tests/test_torch_port_flash_bwd.py``;
the kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``."""

import math

import numpy as np
import pytest
import torch

from mrijax_torch.kernels import flash_attention as fa

LOG2E = math.log2(math.e)
ONE_BF16_ULP = dict(atol=1e-5, rtol=2 ** -7)   # the bar dk and dv are held to on the card
TWO_BF16_ULPS = dict(atol=1e-5, rtol=2 ** -6)  # the bar bf16 dq is held to on the card
SHAPES = [(1, 800, 1, 128), (1, 130, 3, 64), (1, 17, 2, 64)]


def _operands(shape, dtype, seed):
    """q, k, v as slices of one fused (B, N, 3, H, Dh) buffer, dO, and the
    plain forward's (out, lse) and Δ."""
    b, n, h, d = shape
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3, h, d)).astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = fa.flash_attention_reference(q, k, v)
    return q, k, v, dout, out, lse, fa.flash_attention_delta(out, dout)


def _bf16_terms(x, terms):
    """x as a sum of ``terms`` bf16 values, each held in float32: hi = bf16(x),
    lo = bf16(x - hi), ... — what the kernel feeds the tensor cores."""
    parts, rest = [], x
    for _ in range(terms):
        part = rest.bfloat16().float()
        parts.append(part)
        rest = rest - part
    return parts


def _dkv_emulation(q, k, v, dout, lse, delta, terms, q_tile=64):
    """The dkv kernel's arithmetic for bf16 inputs: per tile of 64 query rows
    the transposed logits Sᵀ = k·q′ᵀ and dPᵀ = v·dOᵀ from bf16 operands with
    fp32 sums, Pᵀ = 2^(Sᵀ·log2e − lse·log2e), dUᵀ = Pᵀ∘(dPᵀ − Δ), then
    dV += Pᵀ·dO and dK += dUᵀ·q′ with Pᵀ and dUᵀ split into ``terms`` bf16
    terms, one product per term, summed in fp32; dk and dv rounded once."""
    b, n, h, d = q.shape
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    kf, vf = k.float(), v.float()
    dk = torch.zeros(q.shape, dtype=torch.float32)
    dv = torch.zeros(q.shape, dtype=torch.float32)
    lse2 = (lse * LOG2E).reshape(b, h, n)
    delta = delta.reshape(b, h, n)
    for start in range(0, n, q_tile):
        rows = slice(start, start + q_tile)
        q_prime = (q[:, rows].float() * scale).to(q.dtype).float()
        do = dout[:, rows].float()
        s_t = torch.einsum("bmhd,bnhd->bhmn", kf, q_prime)
        dp_t = torch.einsum("bmhd,bnhd->bhmn", vf, do)
        p_t = torch.exp2(s_t * LOG2E - lse2[:, :, None, rows])
        du_t = p_t * (dp_t - delta[:, :, None, rows])
        for part in _bf16_terms(p_t, terms):
            dv += torch.einsum("bhmn,bnhd->bmhd", part, do)
        for part in _bf16_terms(du_t, terms):
            dk += torch.einsum("bhmn,bnhd->bmhd", part, q_prime)
    return dk.to(k.dtype), dv.to(v.dtype)


def _outside(got, want, atol, rtol):
    g, w = got.float(), want.float()
    return int(((g - w).abs() > atol + rtol * w.abs()).sum())


@pytest.mark.parametrize("shape", SHAPES)
def test_two_bf16_terms_hold_dk_and_dv_to_one_ulp(shape):
    """P and dU as hi + lo carry 16 significant bits (2^-17 relative): the
    fp32 sums differ from the plain version's in their last digits only, so
    after the one rounding to bf16 no element is more than one ulp away."""
    q, k, v, dout, _, lse, delta = _operands(shape, torch.bfloat16, seed=20)
    want = fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta)
    got = _dkv_emulation(q, k, v, dout, lse, delta, terms=2)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _outside(g, w, **ONE_BF16_ULP) == 0, name


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_one_bf16_rounding_of_p_misses_the_bar(shape):
    """Why the split exists: with P and dU rounded to bf16 once (2^-9
    relative per term) the sums are off by more than the last bf16 bit of
    the result wherever terms cancel."""
    q, k, v, dout, _, lse, delta = _operands(shape, torch.bfloat16, seed=20)
    want = fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta)
    got = _dkv_emulation(q, k, v, dout, lse, delta, terms=1)
    assert sum(_outside(g, w, **ONE_BF16_ULP) for g, w in zip(got, want)) > 0
    # and it is the rounding, not the tiling: the same tiles with two terms fit
    got2 = _dkv_emulation(q, k, v, dout, lse, delta, terms=2)
    assert sum(_outside(g, w, **ONE_BF16_ULP) for g, w in zip(got2, want)) == 0


def test_two_term_emulation_in_float32_inputs_is_the_plain_version():
    """With float32 inputs nothing but P and dU is rounded: the emulation
    then differs from the plain version by the split's 2^-17 alone (1e-5)."""
    q, k, v, dout, _, lse, delta = _operands((1, 130, 2, 32), torch.float32, seed=21)
    want = fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta)
    got = _dkv_emulation(q, k, v, dout, lse, delta, terms=2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_two_term_emulation_bf16_matches_pallas_dkv_interpret():
    """dk and dv of the two-term arithmetic against the JAX package's
    ``_dkv_kernel`` (TPU interpret mode), bf16 in and out. Tolerance 2e-2
    relative + 2e-3, that of the plain version's own bf16 hold against Pallas:
    the two forwards may differ by one bf16 ulp of ``out``, which enters Δ."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from mrijax.kernels.flash_attention_pallas import flash_attention_pallas

    rng = np.random.default_rng(23)
    shape = (1, 128, 2, 32)
    arrays = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in arrays)

    def loss(q, k, v):
        out = flash_attention_pallas(q, k, v)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(1, 2))(jq, jk, jv)
    out, lse = fa.flash_attention_reference(q, k, v)
    got = _dkv_emulation(q, k, v, dout, lse, fa.flash_attention_delta(out, dout), terms=2)
    for name, g, w in zip(("dk", "dv"), got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=2e-2, atol=2e-3, err_msg=name)


def _dq_emulation(q, k, v, dout, lse, delta, terms, k_tile=64):
    """The dq kernel's arithmetic for bf16 inputs: per tile of 64 keys
    S = q′·kᵀ and dP = dO·vᵀ from bf16 operands with fp32 sums,
    P = 2^(S·log2e − lse·log2e), dU = P∘(dP − Δ), then dQ′ += dU·k with dU
    split into ``terms`` bf16 terms, one product per term, summed in fp32;
    dq = round(round(dQ′)·Dh^-1/2), the two casts of the TPU wrapper."""
    b, n, h, d = q.shape
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    q_prime = (q.float() * scale).to(q.dtype).float()
    do = dout.float()
    lse2 = (lse * LOG2E).reshape(b, h, n, 1)
    delta = delta.reshape(b, h, n, 1)
    dq_prime = torch.zeros(b, h, n, d)
    for start in range(0, n, k_tile):
        keys = slice(start, start + k_tile)
        kf = k[:, keys].float()
        s = torch.einsum("bnhd,bmhd->bhnm", q_prime, kf)
        dp = torch.einsum("bnhd,bmhd->bhnm", do, v[:, keys].float())
        du = torch.exp2(s * LOG2E - lse2) * (dp - delta)
        for part in _bf16_terms(du, terms):
            dq_prime += torch.einsum("bhnm,bmhd->bhnd", part, kf)
    dq_prime = dq_prime.permute(0, 2, 1, 3).to(q.dtype)
    return (dq_prime.float() * scale).to(q.dtype)


DQ_SHAPES = SHAPES + [(2, 800, 4, 128)]


@pytest.mark.parametrize("shape", DQ_SHAPES)
def test_two_bf16_terms_hold_dq_to_two_ulps(shape):
    """dU as hi + lo: the fp32 sums differ from the plain version's in their
    last digits, but dq is rounded twice (dQ′, then the scaled value), and
    two roundings of sums taken in another order can land two bf16 ulps
    apart: the bar of bf16 dq on the card is 2^-6 relative + 1e-5."""
    q, k, v, dout, _, lse, delta = _operands(shape, torch.bfloat16, seed=20)
    want = fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta)
    got = _dq_emulation(q, k, v, dout, lse, delta, terms=2)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _outside(got, want, **TWO_BF16_ULPS) == 0


@pytest.mark.parametrize("shape", [(1, 800, 1, 128), (1, 130, 3, 64), (1, 17, 2, 64)])
def test_one_bf16_rounding_of_du_misses_the_dq_bar(shape):
    """Why dU is split: rounded to bf16 once (2^-9 relative per term), the
    sums miss even the two-ulp bar wherever terms cancel."""
    q, k, v, dout, _, lse, delta = _operands(shape, torch.bfloat16, seed=20)
    want = fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta)
    got = _dq_emulation(q, k, v, dout, lse, delta, terms=1)
    assert _outside(got, want, **TWO_BF16_ULPS) > 0


def test_two_casts_not_the_split_set_the_dq_bar():
    """Three bf16 terms of dU (24 significant bits, as good as fp32) still
    leave elements of dq outside one ulp at the generation shape, where two
    terms leave more: the two roundings, not the split, push dq past one
    ulp. Both stay inside two."""
    q, k, v, dout, _, lse, delta = _operands((2, 800, 4, 128), torch.bfloat16, seed=20)
    want = fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta)
    three = _dq_emulation(q, k, v, dout, lse, delta, terms=3)
    two = _dq_emulation(q, k, v, dout, lse, delta, terms=2)
    assert 0 < _outside(three, want, **ONE_BF16_ULP) <= _outside(two, want, **ONE_BF16_ULP)
    assert _outside(three, want, **TWO_BF16_ULPS) == 0


def test_two_term_dq_emulation_bf16_matches_pallas_dq_interpret():
    """dq of the two-term arithmetic against the JAX package's ``_dq_kernel``
    run through ``_flash_backward`` in TPU interpret mode, on the Pallas
    forward's own (out, lse), bf16 in and out. Tolerance 2e-2 relative +
    2e-3, that of the plain version's own bf16 hold against Pallas
    (``tests/test_torch_port_flash_bwd.py``): the TPU kernel runs dP from a
    bf16 dO at default precision and rounds dq twice as well."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from mrijax.kernels.flash_attention_pallas import _flash_backward, _flash_forward_lse

    rng = np.random.default_rng(24)
    shape = (1, 200, 2, 32)
    arrays = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_forward_lse(jq, jk, jv)
        want, _, _ = _flash_backward(jq, jk, jv, out, lse, jdo)
    out = torch.from_numpy(np.array(out, np.float32)).bfloat16()
    lse = torch.from_numpy(np.array(lse, np.float32)[..., 0])
    got = _dq_emulation(q, k, v, dout, lse, fa.flash_attention_delta(out, dout), terms=2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-3)


def _forward_emulation(q, k, v, k_tile=64):
    """The forward kernel's arithmetic: online softmax over tiles of 64 keys,
    exponentials as 2^(s·log2e − m·log2e), the row sum from the unrounded P,
    P rounded to the input dtype for P·V, out = acc / l."""
    b, n, h, d = q.shape
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    q_prime = (q.float() * scale).to(q.dtype).float()
    m = torch.full((b, h, n, 1), -1e30)
    l = torch.zeros(b, h, n, 1)
    acc = torch.zeros(b, h, n, d)
    for start in range(0, n, k_tile):
        keys = slice(start, start + k_tile)
        s = torch.einsum("bnhd,bmhd->bhnm", q_prime, k[:, keys].float())
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(s * LOG2E - m_new * LOG2E)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhnm,bmhd->bhnd", p.to(q.dtype).float(),
                                         v[:, keys].float())
        m = m_new
    out = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    return out, (m + torch.log(l)).reshape(b * h, n)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_tile_arithmetic_matches_plain_version(shape, dtype):
    """The bars of the card: float32 1e-4; bf16 out 2e-3 + 1e-2 relative (P is
    rounded against a running max here and the final one there), lse 1e-4."""
    q, k, v, *_ = _operands(shape, dtype, seed=22)
    out, lse = _forward_emulation(q, k, v)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
    tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else dict(atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(out, ref_out, **tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ launch plan


@pytest.mark.parametrize("kernel", ["flash_attn_fwd", "flash_attn_bwd_dkv"])
@pytest.mark.parametrize("d", fa.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("b,n,h", [(2, 800, 4), (8, 800, 4), (1, 51200, 4), (1, 17, 2), (1, 1, 1)])
def test_launch_plan_fits_the_card(kernel, d, b, n, h):
    for dtype in (torch.bfloat16, torch.float32):
        plan = fa.launch_plan(kernel, b, n, h, d, dtype)
        assert plan.shared_bytes <= 232448
        assert plan.blocks == b * h * -(-n // plan.tile)
        assert plan.warps * 32 <= 1024
        if dtype == torch.bfloat16:
            tiles = fa.FORWARD_TILES if kernel == "flash_attn_fwd" else (fa.DKV_TILE,)
            assert plan.tile in tiles and plan.warps == 4
        else:
            assert (plan.tile, plan.warps) == (64, 8)


def test_forward_launch_plan_trades_blocks_against_l2_traffic():
    """A block reads all of K and V from L2, so the plan takes the largest
    tile that still gives every SM a block. Generation (2, 800, 4, 128): 128
    rows would leave 76 SMs idle, so 64 rows and 104 blocks — not 32 rows and
    200 blocks, which cover the card but measured slower on an H100
    (PERF.md) and are not compiled. The training batch affords 128 rows
    (``scripts/probe_torch_flash_tiles.py`` times 64 against 128). At Dh = 32 the softmax binds and 64 rows are kept."""
    gen = fa.launch_plan("flash_attn_fwd", 2, 800, 4, 128, torch.bfloat16)
    assert (gen.tile, gen.warps, gen.blocks) == (64, 4, 104)
    assert 2 * 4 * -(-800 // 32) >= fa.SM_COUNT > gen.blocks
    train = fa.launch_plan("flash_attn_fwd", 8, 800, 4, 128, torch.bfloat16)
    assert (train.tile, train.warps, train.blocks) == (128, 4, 224)
    assert train.blocks >= fa.SM_COUNT
    long = fa.launch_plan("flash_attn_fwd", 1, 51200, 4, 32, torch.bfloat16)
    assert (long.tile, long.warps, long.blocks) == (64, 4, 3200)
    wide = fa.launch_plan("flash_attn_fwd", 32, 800, 4, 64, torch.bfloat16)
    assert (wide.tile, wide.blocks) == (128, 896)


@pytest.mark.parametrize("b,n,h,d,blocks", [(2, 800, 4, 128, 104), (8, 800, 4, 128, 416),
                                            (1, 51200, 4, 32, 3200)])
def test_dkv_launch_plan_keeps_64_keys_a_block(b, n, h, d, blocks):
    plan = fa.launch_plan("flash_attn_bwd_dkv", b, n, h, d, torch.bfloat16)
    assert (plan.tile, plan.warps, plan.blocks) == (64, 4, blocks)


def test_launch_plan_shared_memory_is_what_the_sources_lay_out():
    """bf16 tiles of pitch Dh + 8: forward Q + 2·(K, V) of 64 rows; dkv K, V
    + 2·(Q, dO) of 64 rows + 2·(lse, Δ) of 64 floats. float32: the FMA
    kernels' fp32 tiles of pitch Dh + 4."""
    assert fa.launch_plan("flash_attn_fwd", 2, 800, 4, 128, torch.bfloat16).shared_bytes \
        == 2 * (64 + 4 * 64) * 136
    assert fa.launch_plan("flash_attn_fwd", 8, 800, 4, 128, torch.bfloat16).shared_bytes \
        == 2 * (128 + 4 * 64) * 136
    assert fa.launch_plan("flash_attn_bwd_dkv", 8, 800, 4, 128, torch.bfloat16).shared_bytes \
        == 2 * (2 * 64 + 4 * 64) * 136 + 2 * 2 * 64 * 4
    assert fa.launch_plan("flash_attn_fwd", 2, 800, 4, 128, torch.float32).shared_bytes \
        == 4 * (2 * 64 * 132 + 64 * 128 + 64 * 68)
    assert fa.launch_plan("flash_attn_bwd_dkv", 2, 800, 4, 128, torch.float32).shared_bytes \
        == 4 * (4 * 64 * 132 + 2 * 64 * 68)


@pytest.mark.parametrize("b,n,h,d,blocks", [(2, 800, 4, 128, 104), (8, 800, 4, 128, 416),
                                            (1, 51200, 4, 32, 3200), (1, 17, 2, 64, 2)])
def test_dq_launch_plan_keeps_64_query_rows_a_block(b, n, h, d, blocks):
    for dtype in (torch.bfloat16, torch.float32):
        plan = fa.launch_plan("flash_attn_bwd_dq", b, n, h, d, dtype)
        assert (plan.tile, plan.blocks) == (64, blocks)
        assert plan.warps == (4 if dtype == torch.bfloat16 else 8)


@pytest.mark.parametrize("d", fa.SUPPORTED_HEAD_DIMS)
def test_dq_launch_plan_shared_memory_is_what_the_source_lays_out(d):
    """bf16: q′ and dO of 64 rows + 2 stages of K and V of 64 keys, pitch
    Dh + 8 (two blocks an SM at Dh = 128). float32: the FMA kernel's Q, dO,
    K, V tiles of pitch Dh + 4 and one (64, 68) dU tile."""
    bf16 = fa.launch_plan("flash_attn_bwd_dq", 8, 800, 4, d, torch.bfloat16)
    assert bf16.shared_bytes == 2 * (2 * 64 + 4 * 64) * (d + 8)
    fp32 = fa.launch_plan("flash_attn_bwd_dq", 8, 800, 4, d, torch.float32)
    assert fp32.shared_bytes == 4 * (4 * 64 * (d + 4) + 64 * 68)
    if d == 128:
        assert bf16.shared_bytes == 104448 and 2 * bf16.shared_bytes <= 232448


def test_launch_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="head dims"):
        fa.launch_plan("flash_attn_fwd", 1, 64, 1, 48, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.launch_plan("flash_attn_fwd", 1, 64, 1, 32, torch.float16)
    with pytest.raises(ValueError, match="no launch plan"):
        fa.launch_plan("flash_attn_bwd", 1, 64, 1, 32, torch.bfloat16)


# -------------------------------------------------------------------- alignment


def _fused_views():
    """q, k, v as the attention block hands them over: slices of a fused
    (B, N, 3, H, Dh) projection."""
    qkv = torch.zeros(2, 50, 3, 4, 32, dtype=torch.bfloat16)
    return {"q": qkv[:, :, 0], "k": qkv[:, :, 1], "v": qkv[:, :, 2]}


def test_views_of_the_fused_projection_are_aligned():
    for name, t in _fused_views().items():
        fa.check_copy_alignment(name, t)
    fa.check_copy_alignment("dout", torch.zeros(2, 50, 4, 32, dtype=torch.bfloat16))


@pytest.mark.parametrize("name", ["q", "k", "v", "dout"])
def test_alignment_check_names_the_operand_with_a_shifted_pointer(name):
    """A view that starts 4 bf16 values (8 bytes) into its buffer."""
    flat = torch.zeros(2 * 50 * 4 * 32 + 8, dtype=torch.bfloat16)
    if flat.data_ptr() % 16 != 0:   # allocators align far beyond 16 bytes
        pytest.fail("the test buffer itself is not 16-byte aligned")
    shifted = flat[4:4 + 2 * 50 * 4 * 32].view(2, 50, 4, 32)
    with pytest.raises(ValueError, match=rf"^{name}: data pointer is not 16-byte aligned"):
        fa.check_copy_alignment(name, shifted)


@pytest.mark.parametrize("name", ["q", "k", "v", "dout"])
def test_alignment_check_names_the_operand_with_a_misfit_stride(name):
    """Heads of 32 cut out of rows of 36 values: the head stride is 72 bytes."""
    wide = torch.zeros(2, 50, 4, 36, dtype=torch.bfloat16)[..., :32]
    assert wide.stride(3) == 1
    with pytest.raises(ValueError, match=rf"^{name}: head stride 36 elements is 72 bytes"):
        fa.check_copy_alignment(name, wide)


@pytest.mark.parametrize("name", ["q", "k", "v", "dout"])
def test_dq_launch_names_a_misaligned_bf16_operand(name):
    """The bf16 dq kernel moves its tiles in 16-byte asynchronous copies too:
    before anything is built or launched, its launch refuses an operand
    that starts 8 bytes into its buffer, and names it."""
    shape = (1, 40, 2, 32)
    q, k, v, dout, _, lse, delta = _operands(shape, torch.bfloat16, seed=25)
    operands = {"q": q, "k": k, "v": v, "dout": dout}
    flat = torch.zeros(dout.numel() + 8, dtype=torch.bfloat16)
    operands[name] = flat[4:4 + dout.numel()].view(shape)
    dq = torch.empty(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=rf"^{name}: data pointer is not 16-byte aligned"):
        fa._launch_backward("flash_attn_bwd_dq", *operands.values(), lse, delta, (dq,))


def test_backward_copies_a_misaligned_output_gradient():
    """``flash_attention_backward`` hands the kernels an aligned copy of a
    gradient whose rows are not 16-byte aligned, as it already copies one
    whose last axis is strided; on the CPU both go to the plain version and
    the gradients are those of the aligned tensor."""
    q, k, v, dout, out, lse, _ = _operands((1, 40, 2, 32), torch.bfloat16, seed=23)
    flat = torch.zeros(dout.numel() + 8, dtype=torch.bfloat16)
    shifted = flat[4:4 + dout.numel()].view(dout.shape).copy_(dout)
    assert fa._misalignment(shifted) and not fa._misalignment(dout)
    want = fa.flash_attention_backward(q, k, v, out, lse, dout)
    got = fa.flash_attention_backward(q, k, v, out, lse, shifted)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
