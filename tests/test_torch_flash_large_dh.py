"""The flash-attention kernels at head dims above 128, and GroupNorm+SiLU above
3840 channels.

Above 128 the CUDA kernels take Dh in column chunks: a block owns a chunk of
output columns (128 in float32, 256 in the three bf16 kernels), computes the
logits over all of Dh and accumulates its own columns only; the wrappers
zero-pad any other Dh to the next multiple of 128 (``kernel_head_dim``). Here
the plain versions of that decomposition (``*_column_chunks_reference`` at
chunk widths 128 and 256) go through the wrappers' own
pad, scale and cut (``at_kernel_head_dim``) on CPU tensors, and are held
against the JAX package's attention — the plain ``multi_head_self_attention``,
the chunked ``_chunked_attention_xla`` and the Pallas kernel in TPU interpret
mode — forward and VJP, float32 at 1e-5·max(1, max|ref|). A UNet3D with one
head of 256 is held against the JAX UNet3D on the same carried weights. The
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.kernels.flash_attention import _chunked_attention_xla
from mrijax.kernels.flash_attention_pallas import flash_attention_pallas
from mrijax.models import UNet3D as JUNet3D
from mrijax.ops.attention import multi_head_self_attention
from mrijax.ops.norms import group_norm_silu as jax_group_norm_silu
from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
from mrijax_torch.io import flax_convert
from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.kernels import groupnorm as gn
from mrijax_torch.models import UNet3D

LARGE_DH = (129, 192, 256, 320, 512)
SHAPE = (1, 40, 1)    # B, N, H
Q_CHUNK = 16          # _chunked_attention_xla scans three chunks of query rows


def _arrays(shape, d, seed, count=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(*shape, d)).astype(np.float32) for _ in range(count)]


def _close(got, want, name=""):
    """1e-5·max(1, max|want|), absolute and relative."""
    want = np.asarray(want)
    bar = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=bar, rtol=bar, err_msg=name)


def _chunked_backward(q, k, v, dout, width=fa.BACKWARD_CHUNK):
    """(out, lse, dq, dk, dv) through the wrappers' pad, scale and cut, with
    the plain column-chunk versions where the card launches the kernels, in
    chunks of ``width`` columns."""
    out, lse = fa.at_kernel_head_dim(
        functools.partial(fa.flash_attention_column_chunks_reference, width=width), q, k, v)
    delta = fa.flash_attention_delta(out, dout)
    dk, dv = fa.at_kernel_head_dim(
        lambda *t: fa.flash_attn_bwd_dkv_column_chunks_reference(*t[:4], lse, delta,
                                                                 scale=t[4], width=width),
        q, k, v, dout)
    dq = fa.at_kernel_head_dim(
        lambda *t: fa.flash_attn_bwd_dq_column_chunks_reference(*t[:4], lse, delta,
                                                                scale=t[4], width=width),
        q, k, v, dout)
    return out, lse, dq, dk, dv


def _pallas(q, k, v):
    with pltpu.force_tpu_interpret_mode():
        return flash_attention_pallas(q, k, v)


def _jax_attentions():
    return {"plain": multi_head_self_attention,
            "chunked": lambda q, k, v: _chunked_attention_xla(q, k, v, q_chunk=Q_CHUNK),
            "pallas": _pallas}


# the bf16 kernels' chunk of 256 (ids as before), and the 128 of the float32
# backward at an odd multiple of 128
CHUNK_CASES = ([pytest.param(d, fa.BACKWARD_CHUNK, id=str(d)) for d in LARGE_DH]
               + [pytest.param(d, 128, id=f"{d}-width128") for d in LARGE_DH])


@pytest.mark.parametrize("d,width", CHUNK_CASES)
def test_column_chunks_match_jax_attention_and_pallas(d, width):
    """out, lse and the VJP (dq, dk, dv) of the wrappers' route with the
    column-chunk plain versions in chunks of ``width``, against each JAX
    attention's output and VJP."""
    q, k, v, dout = _arrays(SHAPE, d, seed=d)
    out, lse, dq, dk, dv = _chunked_backward(*(torch.from_numpy(a) for a in (q, k, v, dout)),
                                             width=width)
    assert tuple(lse.shape) == (SHAPE[0] * SHAPE[2], SHAPE[1])
    # the logsumexp of the padded, chunked launch is that of the true head dim
    s = np.einsum("bnhd,bmhd->bhnm", q.astype(np.float64), k) * d ** -0.5
    _close(lse.numpy(), np.log(np.exp(s).sum(-1)).reshape(-1, SHAPE[1]), "lse")
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, dout))
    for label, attend in _jax_attentions().items():
        with pltpu.force_tpu_interpret_mode():
            want, vjp = jax.vjp(attend, jq, jk, jv)
            wants = vjp(jdo)
        for name, got, w in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv), (want, *wants)):
            assert tuple(got.shape) == (*SHAPE, d) and got.is_contiguous()
            _close(got.numpy(), w, f"{label} {name}")


def test_column_chunks_at_nq_ne_nk_match_jax():
    """A block of 24 query rows against 40 keys at Dh 320 (zero-padded to
    384: chunks of 256 and 128, and three of 128): the sequence-parallel
    chunk. The JAX reference is its
    plain attention on the same rows, whose logits and softmax do not need
    Nq = Nk."""
    d, nk, nq = 320, 40, 24
    q, k, v, dout = _arrays((1, nk, 2), d, seed=7)
    q, dout = q[:, :nq], dout[:, :nq]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, dout))
    want, vjp = jax.vjp(multi_head_self_attention, jq, jk, jv)
    wants = vjp(jdo)
    for width in (fa.BACKWARD_CHUNK, 128):
        out, _, dq, dk, dv = _chunked_backward(*(torch.from_numpy(a) for a in (q, k, v, dout)),
                                               width=width)
        _close(out.numpy(), want, f"out width {width}")
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), wants):
            _close(got.numpy(), w, f"{name} width {width}")


# csrc/flash_attention_bwd.cu, namespace wide: 1 KB of alignment, own rows
# and two slots of 8 blocks of 64 x 64 bf16, P and dU hi and lo tiles (dq:
# dU), and in dkv two slots of lse and delta
BWD_WIDE_SHARED = {"flash_attn_bwd_dkv": 1024 + 3 * 65536 + 4 * 8192 + 1024,
                   "flash_attn_bwd_dq": 1024 + 3 * 65536 + 2 * 8192}
# csrc/flash_attention_bwd.cu, f32::Layout above 128: 1 KB of alignment, two
# buffers of the 32 own rows' hi and lo terms of two tensors at 64 columns,
# the P and dU terms of 32 x 64 (dq: dU's), two 64 KB slots, in dkv two slots
# of lse and delta
F32_WIDE_SHARED = {"flash_attn_bwd_dkv": 1024 + 2 * 32768 + 4 * 8192 + 2 * 65536 + 1024,
                   "flash_attn_bwd_dq": 1024 + 2 * 32768 + 2 * 8192 + 2 * 65536}
# csrc/flash_attention_fwd.cu, namespace wide, by query rows a block: 1 KB of
# alignment, q' of the chunk (32 KB a warpgroup of 64 rows), two 64 KB slots
FWD_WIDE_SHARED = {64: 1024 + 32768 + 2 * 65536, 128: 1024 + 2 * 32768 + 2 * 65536}


# the float32 forward at a kernel head dim: rows a block, chunks, shared bytes
# (tests/test_torch_flash_f32_forward.py lays them out)
F32_FWD_PLANS = {256: (64, 1, 230912), 384: (32, 1, 214272), 512: (32, 1, 214272),
                 640: (32, 5, 230656), 1024: (32, 2, 230656)}


@pytest.mark.parametrize("d,kernel_d,chunks", [(129, 256, 2), (256, 256, 2), (320, 384, 3),
                                               (512, 512, 4), (1024, 1024, 8), (384, 384, 3),
                                               (640, 640, 5)])
def test_head_dims_above_128_launch_in_column_chunks(d, kernel_d, chunks):
    """``kernel_head_dim`` rounds up to a multiple of 128. The float32
    kernels have 8 warps a block: the forward holds every column up to Dh
    512 (64 rows at 256, 32 above) and takes chunks of 512 above (of 128 at
    640), the backward chunks of 256 (of 128 at
    an odd multiple of 128) and 32 keys or rows (226 KB and 209 KB of shared
    memory at any Dh); the three bf16 kernels ⌈Dh/256⌉ (the last 128
    wide at an odd multiple of 128), one block an SM: the backward 64 keys
    or rows and 8 warps, the forward a warpgroup of 4 warps for every 64
    query rows, 64 rows where the (8, 800, 1) launch then fits the card in
    one wave (one chunk: Dh 256), else 128. Shared memory within what a
    block may ask for, and the same at any Dh for a given kernel, type and
    tile but the float32 forward's (``F32_FWD_PLANS``)."""
    assert fa.kernel_head_dim(d) == kernel_d and fa.runs_in_chunks(kernel_d)
    wide_chunks = -(-kernel_d // fa.BACKWARD_CHUNK)
    assert wide_chunks * fa.BACKWARD_CHUNK - kernel_d == (128 if chunks % 2 else 0)
    for kernel in ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
        for dtype, warps in ((torch.bfloat16, 4), (torch.float32, 8)):
            plan = fa.launch_plan(kernel, 8, 800, 1, kernel_d, dtype)
            want = (64, warps, chunks)
            if dtype == torch.float32 and kernel == "flash_attn_fwd":
                tile, f32_chunks, shared = F32_FWD_PLANS[kernel_d]
                want = (tile, 8, f32_chunks)
                assert plan.shared_bytes == shared
            elif dtype == torch.float32:
                want = (fa.F32_BACKWARD_TILE, 8, chunks if chunks % 2 else chunks // 2)
                assert plan.shared_bytes == F32_WIDE_SHARED[kernel]
            elif dtype == torch.bfloat16 and kernel != "flash_attn_fwd":
                want = (64, 8, wide_chunks)
                assert plan.shared_bytes == BWD_WIDE_SHARED[kernel]
            elif dtype == torch.bfloat16:
                tile = 64 if 8 * -(-800 // 64) * wide_chunks <= fa.SM_COUNT else 128
                assert tile == (64 if kernel_d == 256 else 128)
                want = (tile, tile // 16, wide_chunks)
                assert plan.shared_bytes == FWD_WIDE_SHARED[tile]
            if dtype == torch.bfloat16:
                assert 2 * plan.shared_bytes > fa.MAX_SHARED_BYTES
            assert (plan.tile, plan.warps, plan.chunks) == want
            assert plan.blocks == 8 * -(-800 // plan.tile) * plan.chunks
            assert plan.shared_bytes <= fa.MAX_SHARED_BYTES
            if plan.tile in (64, fa.F32_BACKWARD_TILE) and (kernel, dtype) != (
                    "flash_attn_fwd", torch.float32):
                assert plan.shared_bytes == fa.launch_plan(kernel, 8, 800, 1, 256,
                                                           dtype).shared_bytes


@pytest.mark.parametrize("shape,tile,blocks", [
    ((8, 6400, 1, 256), 128, 400),   # the 1-head flagship's level 1, training
    ((2, 6400, 1, 256), 128, 100),   # the same, generating: 200 blocks of 64
    ((8, 800, 2, 256), 128, 112),    # 208 of 64
    ((8, 800, 1, 512), 128, 112),    # the bottleneck at 1 head, two chunks
    ((2, 800, 1, 1024), 64, 104),    # one wave of 64-row blocks
    ((2, 800, 2, 256), 64, 52),
    ((32, 800, 1, 512), 128, 448),
])
def test_wide_forward_launch_plan_takes_64_rows_only_where_they_fit_one_wave(shape, tile,
                                                                             blocks):
    """The bf16 forward above Dh 128: a block of 128 query rows (two
    warpgroups sharing each K and V tile) took about 1.1 times as long as
    one of 64 on the card, so 64 rows only where B·H·⌈N/64⌉·chunks ≤ 132
    blocks fill the card in one wave, else 128."""
    b, n, h, d = shape
    plan = fa.launch_plan("flash_attn_fwd", b, n, h, d, torch.bfloat16)
    assert (plan.tile, plan.warps, plan.blocks) == (tile, tile // 16, blocks)
    assert plan.chunks == -(-d // fa.BACKWARD_CHUNK)
    assert plan.shared_bytes == FWD_WIDE_SHARED[tile]


# ------------------------------------------------------------ UNet3D at 1 head

UNET_KW = dict(in_channels=16, base_channels=64, channel_mults=(1, 2, 4), time_emb_dim=32,
               num_heads=1)
LATENT = (1, 8, 8, 8, 16)
ATOL = 3e-4    # tests/test_torch_port_models.py


def test_unet3d_with_one_head_of_256_matches_jax():
    """The bottleneck's 256 channels in one head: Dh 256, the column-chunk
    route. One cached-latent step's loss (min-SNR, t and noise given to
    both): the forward on the noised latent at the 3D parity tests' 3e-4,
    the loss and its gradient at the trajectory test's bars (1e-4 absolute,
    1e-4 relative L2)."""
    rng = np.random.default_rng(31)
    x = rng.normal(size=LATENT).astype(np.float32)
    noise = rng.normal(size=LATENT).astype(np.float32)
    t = np.asarray([9], np.int32)
    jm = JUNet3D(**UNET_KW)
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(LATENT),
                                          jnp.zeros((1,), jnp.int32)))
    params = jax.tree_util.tree_map(
        lambda leaf: (0.05 * rng.normal(size=leaf.shape)).astype(np.float32), tree)
    tm = UNet3D(**UNET_KW)
    tm.load_state_dict(flax_convert.unet3d_state_dict_from_flax(
        params, UNET_KW["channel_mults"]), strict=True)
    assert tm.mid_attn.num_heads == 1 and fa.kernel_head_dim(256) == 256

    betas = cosine_beta_schedule(16)
    jd = JGaussianDiffusion(jsched.make_schedule(betas), loss_type="min_snr")
    td = GaussianDiffusion(make_schedule(betas), loss_type="min_snr")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    @jax.jit
    def loss_and_grad(p):
        def loss(p):
            seen = {}

            def model(xx, tt):
                seen["prediction"] = jm.apply(p, xx, tt)
                return seen["prediction"]

            return jd.p_losses(model, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise)), seen

        return jax.value_and_grad(loss, has_aux=True)(p)

    (want_loss, want_seen), jgrads = loss_and_grad(jparams)
    seen = {}

    def model(xx, tt):
        seen["prediction"] = tm(xx, tt)
        return seen["prediction"]

    loss = td.p_losses(model, torch.from_numpy(x), torch.from_numpy(t).long(),
                       torch.from_numpy(noise))
    np.testing.assert_allclose(seen["prediction"].detach().numpy(),
                               np.asarray(want_seen["prediction"]), atol=ATOL)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=0, atol=1e-4)
    want = flax_convert.unet3d_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), UNET_KW["channel_mults"])
    got = {name: p.grad for name, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 < 1e-4
    # the bottleneck attention's own gradients, not drowned by the rest
    for name in ("mid_attn.qkv.weight", "mid_attn.proj.weight"):
        rel = float((got[name] - want[name]).norm() / want[name].norm())
        assert rel < 1e-4, (name, rel)


# ------------------------------------------------- GroupNorm above 3840 channels


@pytest.mark.parametrize("n,c,batch,shared", [(256, 4096, 2, 8 * (2048 + 4096)),
                                              (256, 4096, 64, 8 * (2048 + 4096)),
                                              (64, 8192, 2, 8 * (2048 + 8192))])
def test_stats_launch_plan_above_3840_channels(n, c, batch, shared):
    """bf16 16-byte vectors, 256 vector columns a pass, and (2048 + C)·8
    bytes of dynamic shared memory: above the default 48 KB, within the
    227 KB a block may ask for once the launch raises the kernel's limit."""
    plan = gn.launch_plan(n, c, 8, 2, 16, batch)
    assert (plan.vec, plan.tx, plan.ty) == (8, 256, 1)
    assert plan.shared_bytes(c) == shared
    # more than a 3840-channel launch, the most the default 48 KB holds
    # beside the kernel's 1 KB of static shared memory
    assert gn.launch_plan(n, 3840, 8, 2, 16, batch).shared_bytes(3840) == 47104
    assert 47104 < plan.shared_bytes(c) <= gn.MAX_SHARED_BYTES - 2048
    assert gn.launch_plan(1, gn.MAX_CHANNELS, 8, 2, 16, 1).shared_bytes(gn.MAX_CHANNELS) \
        <= gn.MAX_SHARED_BYTES - 2048
    with pytest.raises(ValueError, match="at most"):
        gn.launch_plan(1, gn.MAX_CHANNELS + 8, 8, 2, 16, 1)


def test_group_norm_silu_at_4096_channels_matches_jax():
    """The plain version a CPU tensor gets (the kernels' arithmetic) against
    ``mrijax.ops.norms.group_norm_silu`` at (2, 64, 4096), 8 groups of 512
    channels: float32 at 2e-5, the JAX package's kernel-test bar."""
    rng = np.random.default_rng(41)
    x = (1.5 * rng.normal(size=(2, 64, 4096)) + 0.3).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=4096)).astype(np.float32)
    bias = (0.1 * rng.normal(size=4096)).astype(np.float32)
    got = gn.group_norm_silu_fused(torch.from_numpy(x), torch.from_numpy(scale),
                                   torch.from_numpy(bias), 8)
    want = jax_group_norm_silu(jnp.asarray(x), 8, jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
