"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: run with ``python -m pytest tests/test_torch_port_cuda.py -m gpu``
on a machine with an NVIDIA GPU and ``nvcc``. Without a GPU every test here
skips (``chip_smoke.py`` makes the same comparisons at the main-path shapes).
"""

import numpy as np
import pytest
import torch

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax_torch.diffusion import (
    GaussianDiffusion,
    cosine_beta_schedule,
    linear_beta_schedule,
    make_schedule,
)
from mrijax_torch.io import CheckpointManager
from mrijax_torch.kernels import conv3d as cv
from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.kernels import groupnorm as gn
from mrijax_torch.generate import sample_2d
from mrijax_torch.models import UNet2D, UNet3D
from mrijax_torch.ops.attention import multi_head_self_attention
from mrijax_torch.ops.norms import group_norm_silu
from mrijax_torch.train import (
    Trainer,
    create_train_state,
    make_cached_latent_eval_step,
    make_cached_latent_train_step,
    make_diffusion_train_step,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    # decided when a test runs, never at import: every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    ((2, 800, 512), 8), ((2, 1000, 64), 8), ((1, 5000, 32), 8), ((2, 333, 24), 8),
    ((1, 4, 5, 6, 128), 8), ((1, 70, 2048), 16),
    # the UNet2D's sites at 128² (N, C): 8 and 16 channels a group, and up to 64
    ((2, 128, 128, 128), 8), ((2, 64, 64, 256), 8), ((2, 32, 32, 512), 8),
    ((2, 16, 16, 512), 8), ((2, 32, 32, 256), 8), ((2, 64, 64, 128), 8),
    ((2, 128, 128, 64), 8), ((310, 16, 16, 512), 8),
    # the same sites at the presets' batch of 64, where the launch plans differ
    ((64, 128, 128, 128), 8), ((64, 64, 64, 256), 8), ((64, 32, 32, 512), 8),
    ((64, 16, 16, 512), 8), ((64, 32, 32, 256), 8), ((64, 64, 64, 128), 8),
    ((64, 128, 128, 64), 8),
    # above 3840 channels the stats launch raises its shared-memory limit
    ((2, 256, 4096), 8), ((2, 64, 8192), 8),
])
def test_group_norm_silu_kernels_match_plain_version(cuda, shape, groups, dtype):
    """fp32: 2e-5 absolute (another summation order). bf16: one ulp of the output."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 1.5 + 0.3)
    x = x.to(cuda, dtype)
    scale = torch.from_numpy(rng.normal(size=shape[-1]).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(size=shape[-1]).astype(np.float32)).to(cuda)
    gn.launches.reset()
    with torch.no_grad():
        got = gn.group_norm_silu_fused(x, scale, bias, groups)
    assert gn.launches.as_dict() == {"gn_silu_stats": 1, "gn_silu_apply": 1,
                                     "gn_silu_bwd_reduce": 0, "gn_silu_bwd_apply": 0}
    want = gn.group_norm_silu_reference(x, scale, bias, groups)
    tol = dict(atol=2e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 800, 4, 128), (1, 1000, 2, 32), (1, 130, 3, 64), (1, 1, 1, 32),
                                   (1, 4100, 2, 32), (1, 17, 2, 64),
                                   # head dims padded to the next compiled one
                                   (2, 64, 4, 4), (1, 64, 2, 8), (2, 130, 2, 16), (1, 70, 2, 48),
                                   # above 128: column chunks (192 and 320 padded first)
                                   (2, 800, 2, 256), (2, 130, 1, 192), (1, 64, 1, 320),
                                   (1, 300, 1, 512), (1, 70, 1, 1024)])
def test_flash_attention_kernel_matches_plain_version(cuda, shape, dtype):
    """fp32: 1e-4 absolute (tile-by-tile sums against a running max). bf16:
    2e-3 + 1e-2 relative on out (probabilities rounded against another max)."""
    b, n, h, d = shape
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3, h, d)).astype(np.float32)).to(cuda, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    fa.launches.reset()
    out, lse = fa.flash_attention_forward(q, k, v)
    assert fa.launches["flash_attn_fwd"] == 1
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
    tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else dict(atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(out, ref_out, **tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,pointer_shift", [
    ((2, 800, 512), 0.3, 0),      # one load a thread
    ((2, 800, 1024), 0.3, 0),     # two
    ((1, 51200, 128), 0.3, 0),    # four
    ((1, 4096, 32), 0.3, 0),      # 16-byte bf16 vectors across two groups of 4 channels
    ((2, 333, 24), 0.3, 0),       # 3 channels a group, ragged N
    ((2, 100, 64), 200.0, 0),     # |mean| >> std
    ((1, 70, 2048), 0.3, 0),      # more vector columns than a block has threads
    ((1, 300, 64), 0.3, 1),       # a pointer one element off: narrower vectors
])
def test_gn_silu_apply_kernel_matches_plain_version(cuda, shape, offset, pointer_shift, dtype):
    """``gn_silu_apply`` alone, on the plain version's statistics, at every
    loads-per-thread count, vector width and column split ``apply_plan``
    gives. fp32: 2e-5 absolute; bf16: one ulp of the output."""
    rng = np.random.default_rng(5)
    b, n, c = shape
    groups = 16 if c == 2048 else 8
    x32 = rng.normal(size=b * n * c + pointer_shift).astype(np.float32) * 1.5 + offset
    flat = torch.from_numpy(x32).to(cuda, dtype)
    x = flat[pointer_shift:].view(shape)
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=c).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(0.1 * rng.normal(size=c).astype(np.float32)).to(cuda)
    stats = gn.gn_silu_stats_reference(x, groups)
    gn.launches.reset()
    got = gn.gn_silu_apply(x, stats, scale, bias)
    assert gn.launches.as_dict() == {"gn_silu_stats": 0, "gn_silu_apply": 1,
                                     "gn_silu_bwd_reduce": 0, "gn_silu_bwd_apply": 0}
    want = gn.gn_silu_apply_reference(x, stats, scale, bias)
    tol = dict(atol=2e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,pointer_shift", [
    ((2, 800, 512), 0.3, 0),      # two loads a thread, one slab a block
    ((8, 800, 512), 0.3, 0),      # the training batch
    ((1, 409600, 32), 0.3, 0),    # 16-byte bf16 vectors across groups, slabs in series
    ((2, 333, 24), 0.3, 0),       # 3 channels a group, ragged N, idle columns
    ((2, 100, 64), 200.0, 0),     # |mean| >> std
    ((1, 70, 2048), 0.3, 0),      # more vector columns than a block has threads
    ((1, 300, 64), 0.3, 1),       # a pointer one element off: narrower vectors
])
def test_gn_silu_stats_kernel_matches_plain_version(cuda, shape, offset, pointer_shift, dtype):
    """``gn_silu_stats`` alone, one launch a call: mean and 1/std at 2e-5
    absolute (another summation order), the same bits from two calls, and
    counters left at 0 (the next call's tickets start there). At offset 200
    the mean is held to 1e-6 relative (a few ulps of 200) and 1/std to 1e-2
    relative: E[x²] − mean² cancels to 1/17 800 of E[x²] there, and each side
    may miss the variance by 16·2⁻²⁴·E[x²] (``chip_smoke.py``'s bar), 0.85 %
    of 1/std."""
    rng = np.random.default_rng(6)
    b, n, c = shape
    groups = 16 if c == 2048 else 8
    x32 = rng.normal(size=b * n * c + pointer_shift).astype(np.float32) * 1.5 + offset
    x = torch.from_numpy(x32).to(cuda, dtype)[pointer_shift:].view(shape)
    gn.launches.reset()
    got = gn.gn_silu_stats(x, groups)
    assert gn.launches.as_dict() == {"gn_silu_stats": 1, "gn_silu_apply": 0,
                                     "gn_silu_bwd_reduce": 0, "gn_silu_bwd_apply": 0}
    want = gn.gn_silu_stats_reference(x, groups)
    if offset < 100:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        torch.testing.assert_close(got[:, 0], want[:, 0], atol=2e-5, rtol=1e-6)
        torch.testing.assert_close(got[:, 1], want[:, 1], atol=0, rtol=1e-2)
    assert torch.equal(gn.gn_silu_stats(x, groups), got)
    for counters, _ in gn._workspaces.values():
        assert int(counters.abs().sum()) == 0


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 16, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu_fused(x.transpose(1, 2), w[:16], w[:16], 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gn.group_norm_silu_fused(x.half(), w, w, 8)
    # no head dim, and one above MAX_HEAD_DIM (an expanded view: no memory)
    for q in (torch.zeros(1, 8, 2, 0, device=cuda),
              torch.zeros(1, 1, 1, 1, device=cuda).expand(1, 8, 2, fa.MAX_HEAD_DIM + 1)):
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_attention_forward(q, q, q)
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_attention(q.requires_grad_(), q, q)
    with pytest.raises(ValueError, match="channels"):
        gn.gn_silu_stats(torch.zeros(1, 2, gn.MAX_CHANNELS + 8, device=cuda), 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 800, 4, 128), (1, 1000, 2, 32), (1, 130, 3, 64), (1, 1, 1, 32),
                                   (1, 4100, 2, 32), (1, 17, 2, 64),
                                   # head dims padded to the next compiled one
                                   (2, 64, 4, 4), (1, 64, 2, 8), (2, 130, 2, 16), (1, 70, 2, 48),
                                   # above 128: column chunks (192 and 320 padded first)
                                   (2, 800, 2, 256), (2, 130, 1, 192), (1, 64, 1, 320),
                                   (1, 300, 1, 512), (1, 70, 1, 1024)])
def test_flash_attention_backward_kernels_match_plain_versions(cuda, shape, dtype):
    """fp32: 1e-4 absolute (tile-by-tile sums). bf16 dk, dv: 1e-5 + 2**-7
    relative, one bf16 ulp (float32 sums rounded to bf16 once on both
    sides); bf16 dq: 1e-5 + 2**-6 relative, two ulps (rounded twice, around
    the Dh^-1/2 multiply, after sums taken in another order)."""
    b, n, h, d = shape
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3, h, d)).astype(np.float32)).to(cuda, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    out, lse = fa.flash_attention_forward(q, k, v)
    fa.launches.reset()
    got = fa.flash_attention_backward(q, k, v, out, lse, dout)
    assert fa.launches.as_dict() == {"flash_attn_fwd": 0, "flash_attn_bwd_dkv": 1,
                                     "flash_attn_bwd_dq": 1}
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.is_contiguous()
        if dtype == torch.float32:
            tol = dict(atol=1e-4, rtol=0)
        else:
            tol = dict(atol=1e-5, rtol=2 ** -6 if name == "dq" else 2 ** -7)
        torch.testing.assert_close(g, w, **tol, msg=name)


@pytest.mark.parametrize("q_shape,nk", [
    ((8, 800, 4, 128), 800), ((1, 130, 3, 64), 130), ((1, 1000, 2, 32), 1000),
    ((1, 17, 2, 64), 17),
    # above 128: chunks of 256, and of 128 at an odd multiple of 128
    ((2, 800, 2, 256), 800), ((1, 300, 1, 512), 300), ((1, 64, 1, 384), 64),
    # a sequence-parallel chunk: q of 400 rows against 800 keys
    ((8, 400, 4, 128), 800)])
def test_float32_backward_kernels_match_plain_versions_bitwise_again(cuda, q_shape, nk):
    """The float32 ``flash_attn_bwd_dkv`` and ``flash_attn_bwd_dq`` (three
    TF32 passes on ``wgmma``) against their plain versions at 1e-4 absolute,
    one launch each; a second launch of each gives the same bits (every
    output element is summed by one thread in a fixed order)."""
    b, n, h, d = q_shape
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(b, nk, 3, h, d)).astype(np.float32)).to(cuda)
    q, k, v = qkv[:, :n, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.from_numpy(rng.normal(size=q_shape).astype(np.float32)).to(cuda)
    out, lse = fa.flash_attention_forward(q, k, v)
    delta = fa.flash_attention_delta(out, dout)
    fa.launches.reset()
    dk, dv = fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta)
    dq = fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta)
    assert fa.launches.as_dict() == {"flash_attn_fwd": 0, "flash_attn_bwd_dkv": 1,
                                     "flash_attn_bwd_dq": 1}
    want_dk, want_dv = fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta, q_block=400)
    want_dq = fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta, q_block=400)
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv), ("dq", dq, want_dq)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0, msg=name)
    again = (*fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta),
             fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta))
    for name, got, first in zip(("dk", "dv", "dq"), again, (dk, dv, dq)):
        assert torch.equal(got, first), name


@pytest.mark.parametrize("q_shape,nk", [
    ((2, 800, 4, 128), 800), ((1, 130, 2, 32), 130), ((2, 64, 4, 4), 64),
    ((1, 200, 1, 256), 200), ((2, 96, 1, 384), 96), ((8, 800, 1, 512), 800),
    # sequence-parallel chunks: q of fewer rows than the keys, one ragged
    ((8, 400, 4, 128), 800), ((1, 48, 2, 64), 130)])
def test_float32_forward_kernel_matches_plain_version_bitwise_again(cuda, q_shape, nk):
    """The float32 ``flash_attn_fwd`` (three TF32 passes on ``wgmma``) on
    strided views of one (B, Nk, 3, H, Dh) buffer against the plain version:
    out and lse within 1e-4 absolute, one launch; a second launch gives the
    same bits (every output is summed by one thread in a fixed order)."""
    b, n, h, d = q_shape
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.normal(size=(b, nk, 3, h, d)).astype(np.float32)).to(cuda)
    q, k, v = qkv[:, :n, 0], qkv[:, :, 1], qkv[:, :, 2]
    fa.launches.reset()
    out, lse = fa.flash_attention_forward(q, k, v)
    assert fa.launches.as_dict() == {"flash_attn_fwd": 1, "flash_attn_bwd_dkv": 0,
                                     "flash_attn_bwd_dq": 0}
    want_out, want_lse = fa.flash_attention_reference(q, k, v)
    assert out.dtype == torch.float32 and out.is_contiguous() and out.shape == q_shape
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=0, msg="out")
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0, msg="lse")
    again = fa.flash_attention_forward(q, k, v)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


def test_flash_attention_autograd_route_launches_all_three_kernels(cuda):
    """Under autograd on CUDA the front does not raise: forward and both
    backward kernels run, and the gradient of the fused qkv buffer agrees with
    autograd through the materialised attention (fp32, 1e-4). Without autograd
    the front is the forward kernel alone."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, 300, 3, 2, 64)).astype(np.float32)).to(cuda)
    qkv.requires_grad_()
    weight = torch.from_numpy(rng.normal(size=(2, 2, 300, 64)).astype(np.float32)).to(cuda)
    grads = []
    for attend in (fa.flash_attention, multi_head_self_attention):
        fa.launches.reset()
        out = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        grads.append(torch.autograd.grad((out.permute(0, 2, 1, 3) * weight).sum(), qkv)[0])
        if attend is fa.flash_attention:
            assert fa.launches.as_dict() == {"flash_attn_fwd": 1, "flash_attn_bwd_dkv": 1,
                                             "flash_attn_bwd_dq": 1}
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=1e-4)
    fa.launches.reset()
    with torch.no_grad():
        fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    assert fa.launches.as_dict() == {"flash_attn_fwd": 1, "flash_attn_bwd_dkv": 0,
                                     "flash_attn_bwd_dq": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_autograd_route_runs_the_kernels(cuda, dtype):
    """Under autograd on CUDA the fused op does not raise: its forward
    launches both forward kernels, its backward both backward kernels, and
    its gradients are those of the plain composition in float32 on the same
    inputs (fp32 1e-4, the bar of the JAX package's kernel test; bf16 one ulp
    of dx: the kernels do the SiLU and its gradient in float32, where the
    plain composition on bf16 rounds to bf16 before the SiLU)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 500, 64)).astype(np.float32)).to(cuda, dtype)
    leaves = [x.requires_grad_(),
              torch.from_numpy(rng.normal(size=64).astype(np.float32)).to(cuda).requires_grad_(),
              torch.from_numpy(rng.normal(size=64).astype(np.float32)).to(cuda).requires_grad_()]
    dy = torch.from_numpy(rng.normal(size=(2, 500, 64)).astype(np.float32)).to(cuda, dtype)
    gn.launches.reset()
    y = gn.group_norm_silu_fused(*leaves, 8)
    assert gn.launches.as_dict() == {"gn_silu_stats": 1, "gn_silu_apply": 1,
                                     "gn_silu_bwd_reduce": 0, "gn_silu_bwd_apply": 0}
    got = torch.autograd.grad(y, leaves, dy)
    assert gn.launches.as_dict() == {"gn_silu_stats": 1, "gn_silu_apply": 1,
                                     "gn_silu_bwd_reduce": 1, "gn_silu_bwd_apply": 1}
    x32 = leaves[0].detach().float().requires_grad_()
    want = torch.autograd.grad(group_norm_silu(x32, 8, *leaves[1:]), [x32, *leaves[1:]],
                               dy.float())
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-3, rtol=1e-2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, **tol)


# (B, N, C) of every GroupNorm+SiLU backward of the training paths: the UNet2D
# at the 2D cells' batch of 64, the UNet3D at the 3D cells' 32 and at 8, the
# VAE3D's largest at one volume
GN_BACKWARD_SHAPES = ([(64, n, c) for n, c in ((16384, 64), (16384, 128), (4096, 128),
                                               (4096, 256), (1024, 256), (1024, 512), (256, 512))]
                      + [(b, n, c) for b in (32, 8)
                         for n, c in ((51200, 128), (51200, 256), (6400, 256), (6400, 512),
                                      (800, 512), (800, 1024))]
                      + [(1, 3276800, 32)])


def _gn_silu_float64_gradient(x, dy, scale, bias, groups=8):
    leaves = [t.detach().double().requires_grad_() for t in (x, scale, bias)]
    b, c = x.shape[0], x.shape[-1]
    xg = leaves[0].reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    y = torch.nn.functional.silu(
        ((xg - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape) * leaves[1] + leaves[2])
    return torch.autograd.grad(y, leaves, dy.double())


def _relative_error(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GN_BACKWARD_SHAPES)
def test_group_norm_silu_backward_kernels_match_float64(cuda, shape, dtype):
    """``gn_silu_backward`` (the two backward kernels, on the forward
    kernel's stats) against the float64 gradient of the same function on the
    same inputs, as the largest error over the largest value of dx, dγ and
    dβ: float32 within 1e-5; bf16 no further than the plain composition's own
    gradient (``ops.norms.group_norm_silu``, which rounds to bf16 before the
    SiLU). Two calls give the same bits."""
    b, n, c = shape
    rng = np.random.default_rng(9)
    x = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)) * 1.5 + 0.3).to(cuda, dtype)
    dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=c).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(0.1 * rng.normal(size=c).astype(np.float32)).to(cuda)
    stats = gn.gn_silu_stats(x, 8)
    gn.launches.reset()
    got = gn.gn_silu_backward(x, dy, stats, scale, bias)
    assert gn.launches.as_dict() == {"gn_silu_stats": 0, "gn_silu_apply": 0,
                                     "gn_silu_bwd_reduce": 1, "gn_silu_bwd_apply": 1}
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    assert all(torch.equal(a, g) for a, g in zip(gn.gn_silu_backward(x, dy, stats, scale, bias),
                                                 got))
    want = _gn_silu_float64_gradient(x, dy, scale, bias)
    errs = [_relative_error(g, w) for g, w in zip(got, want)]
    del got
    if dtype == torch.float32:
        bars = [1e-5] * 3
    else:
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
        plain = torch.autograd.grad(group_norm_silu(leaves[0], 8, *leaves[1:]), leaves, dy)
        bars = [_relative_error(g, w) for g, w in zip(plain, want)]
    for name, e, bar in zip(("dx", "dscale", "dbias"), errs, bars):
        assert e <= bar, (name, e, bar)


@pytest.mark.parametrize("family", ["unet3d", "unet2d"])
def test_training_step_runs_each_backward_kernel_29_times(cuda, family, monkeypatch):
    """One bf16 training step of a narrow model with the flagships' topology
    (29 GroupNorm+SiLU sites a forward) launches each forward and each
    backward kernel 29 times, and never the plain composition the CPU route
    differentiates."""
    from mrijax_torch.ops import norms

    plain_calls = []
    plain = norms.group_norm_silu
    monkeypatch.setattr(norms, "group_norm_silu",
                        lambda *a, **k: plain_calls.append(1) or plain(*a, **k))
    torch.manual_seed(0)
    kw = dict(base_channels=16, time_emb_dim=32, dtype=torch.bfloat16, param_dtype=torch.float32)
    if family == "unet3d":
        model = UNet3D(in_channels=4, channel_mults=(1, 2, 4), num_heads=1, **kw)
        diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(20)), loss_type="min_snr")
        step = make_cached_latent_train_step(model, diffusion)
        batch = {"latent": torch.randn(2, 8, 8, 8, 4, device=cuda)}
        args = (batch, 0.8)
    else:
        model = UNet2D(channel_mults=(1, 2, 4, 8), **kw)
        diffusion = GaussianDiffusion(make_schedule(linear_beta_schedule(20)))
        step = make_diffusion_train_step(model, diffusion)
        args = ({"image": torch.rand(2, 32, 32, 1, device=cuda) * 2 - 1,
                 "z_pos": torch.rand(2, device=cuda)},)
    state = create_train_state(model, 1e-3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    gn.launches.reset()
    state, loss = step(state, args[0], gen, *args[1:])
    torch.cuda.synchronize()
    assert gn.launches.as_dict() == {"gn_silu_stats": 29, "gn_silu_apply": 29,
                                     "gn_silu_bwd_reduce": 29, "gn_silu_bwd_apply": 29}
    assert not plain_calls and bool(torch.isfinite(loss))


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "concat_slice"])
@pytest.mark.parametrize("shape", [(1, 5, 7, 8, 8, 8), (3, 9, 8, 7, 24, 40), (2, 6, 6, 6, 64, 264),
                                   (2, 8, 10, 10, 128, 256), (1, 4, 6, 4, 256, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3d_k4s2_kernel_matches_plain_version(cuda, shape, strided):
    """Within half a bf16 ulp of the plain version's float32 sum, plus 1e-4
    of the largest output for the other order of the sum; every compiled
    tile width (Cout 8, 40: 64; 264: two of 256), ragged M and odd sizes."""
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(b, d, h, w, 2 * cin, device=cuda, generator=g).bfloat16()
    x = x[..., :cin] if strided else x[..., :cin].contiguous()
    weight = (torch.randn(cout, cin, 4, 4, 4, device=cuda, generator=g)
              / (64 * cin) ** 0.5).bfloat16()
    bias = (0.1 * torch.randn(cout, device=cuda, generator=g)).bfloat16()
    for args in ((x, weight, bias), (x, weight, None)):
        cv.launches.reset()
        got = cv.conv3d_k4s2(*args)
        assert cv.launches["conv3d_k4s2"] == 1
        want = cv.conv3d_k4s2_reference(*(None if t is None else t.float() for t in args))
        err = (got.float() - want).abs()
        assert not bool((err > 2 ** -8 * want.abs() + 1e-4 * want.abs().max()).any())


def test_conv3d_modules_launch_the_kernel_in_bf16_only(cuda):
    """A bf16 UNet3D launches the kernel twice a forward and twice more in
    its backward (the Upsamples' input gradients); float32 never."""
    kw = dict(in_channels=8, base_channels=16, channel_mults=(1, 2, 4), time_emb_dim=16,
              num_heads=1)
    x = torch.randn(2, 8, 8, 8, 8, device=cuda)
    t = torch.tensor([3, 9], device=cuda)
    for dtype, want in ((torch.bfloat16, (2, 4)), (torch.float32, (0, 0))):
        net = UNet3D(**kw, dtype=dtype, param_dtype=torch.float32).to(cuda)
        cv.launches.reset()
        with torch.no_grad():
            net(x, t)
        forward = cv.launches["conv3d_k4s2"]
        cv.launches.reset()
        net(x, t).square().mean().backward()
        assert (forward, cv.launches["conv3d_k4s2"]) == want
    with pytest.raises(ValueError, match="bfloat16"):
        cv.conv3d_k4s2(x[..., :8].contiguous(), torch.zeros(8, 8, 4, 4, 4, device=cuda))


def test_trainer_runs_an_epoch_on_the_card_and_restores(cuda, tmp_path):
    """One epoch of a narrow UNet3D through ``Trainer`` with the cached-latent
    step on the card: every kernel of the path launches, the losses are
    finite, and the checkpoint restores bitwise into fresh weights on the
    card."""
    class Loader(list):
        batch_size = 2

        def set_epoch(self, epoch):
            pass

    def state(seed):
        torch.manual_seed(seed)
        unet = UNet3D(in_channels=4, base_channels=16, channel_mults=(1, 2), time_emb_dim=32,
                      num_heads=1, dtype=torch.bfloat16, param_dtype=torch.float32)
        return create_train_state(unet, 1e-3, ema=True, device=cuda)

    rng = np.random.default_rng(5)
    batches = [{"latent": torch.from_numpy(rng.normal(size=(2, 8, 8, 8, 4)).astype(np.float32))
                .to(cuda)} for _ in range(3)]
    trained = state(0)
    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(20)), loss_type="min_snr")
    step = make_cached_latent_train_step(trained.model, diffusion, ema_decay=0.9)
    evaluate = make_cached_latent_eval_step(trained.model, diffusion)
    mgr = CheckpointManager(tmp_path / "ck")
    trainer = Trainer(
        train_step=lambda s, b, g: step(s, b, g, 0.8),
        eval_step=lambda p, b, g: evaluate(p, b, g, 0.8, 10),
        train_loader=Loader(batches[:2]), val_loader=Loader(batches[2:]),
        checkpoint_manager=mgr, epochs=1)
    gn.launches.reset()
    fa.launches.reset()
    result = trainer.fit(trained)
    counts = {**gn.launches.as_dict(), **fa.launches.as_dict()}
    assert min(counts.values()) > 0, counts
    assert result.epochs_run == 1 and trained.step == 2
    assert np.isfinite(result.best_val_loss)

    fresh = state(1)
    restored, extra = mgr.restore(fresh)
    assert extra["epoch_complete"] and extra["global_step"] == 2
    assert all(p.is_cuda for p in fresh.model.parameters())
    for a, b in zip(list(fresh.model.parameters()) + list(fresh.ema_params.values()),
                    list(trained.model.parameters()) + list(trained.ema_params.values())):
        assert torch.equal(a, b)


def test_unet2d_sampling_on_the_card_matches_the_cpu(cuda):
    """A narrow float32 UNet2D through guided ``sample_2d`` on the card
    (kernels) and on the CPU (plain versions), from the same start: 1e-3
    absolute over 4 DDIM steps (float32 sums in another order; TF32 off).
    Small weights and a linear schedule keep the output of order 1 (on the
    CPU a 1e-7 relative change of the weights moves it by ~1e-6); torch's
    default initialisation with a cosine T = 20 gives outputs near 2 000,
    where float32 rounding alone exceeds any absolute bar of this size.
    29 GroupNorm sites a forward at mults (1, 2, 4, 8); each guided step is
    one forward."""
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = UNet2D(base_channels=16, channel_mults=(1, 2, 4, 8), time_emb_dim=32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" not in name:
                p.normal_(0.0, 0.02)
    diffusion = GaussianDiffusion(make_schedule(linear_beta_schedule(20)))
    x_t = torch.randn(3, 32, 32, 1)
    kw = dict(num_samples=3, image_size=32, ddim_steps=4, x_t=x_t, guidance_scale=2.0)
    gn.launches.reset()
    got = sample_2d(model, diffusion, device="cuda", **kw)
    assert gn.launches.as_dict() == {"gn_silu_stats": 4 * 29, "gn_silu_apply": 4 * 29,
                                     "gn_silu_bwd_reduce": 0, "gn_silu_bwd_apply": 0}
    want = sample_2d(model, diffusion, device="cpu", **kw)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0)


def test_span_times_the_stream_and_adds_nothing_to_the_profilers_timeline(cuda):
    """A recorded span that times the stream covers the kernel inside it
    (within the events around it) while its host ms is the launch alone; its
    ``cuEventRecord`` events put no event and no user annotation in the
    profiler's trace. A span that does not time the stream has no stream
    ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mrijax_torch.obs import profiling

    with profiling.span("test.off"):
        pass
    torch.cuda._sleep(1000)      # the first launch loads the kernel
    torch.cuda.synchronize()
    outer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        outer[0].record()
        with profiling.span("test.sleep", stream=True):
            torch.cuda._sleep(10_000_000)
        outer[1].record()
        with profiling.span("test.host"):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    (s,) = profiling.spans("test.sleep")
    (host,) = profiling.spans("test.host")
    assert host.stream_ms is None and host.host_ms > 0
    around = outer[0].elapsed_time(outer[1])
    assert 0.8 * around < s.stream_ms <= around and s.host_ms < 0.5 * s.stream_ms
    device = [e.name for e in prof.events() if e.device_type != DeviceType.CPU]
    assert device and not any("test." in n for n in device)
    assert not [e.name for e in prof.events() if e.is_user_annotation]
