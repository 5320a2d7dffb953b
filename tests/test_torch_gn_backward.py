"""What surrounds the GroupNorm+SiLU backward kernels (``gn_silu_bwd_reduce``
and ``gn_silu_bwd_apply``) and can be checked without a GPU: their launch
plans (``backward_plan``) at the shapes the training paths give them, and
the order in which the two passes sum, emulated in plain PyTorch and held
against the float64 gradient of the float32 function and against ``jax.grad``
of the JAX package's ``group_norm_silu``. The kernels themselves are held
against the float64 gradient on the card by ``chip_smoke.py`` and
``tests/test_torch_port_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mrijax.ops.norms import group_norm_silu as jax_group_norm_silu
from mrijax_torch.kernels import groupnorm as gn
from mrijax_torch.ops.norms import group_norm_silu
from test_torch_gn_apply import _coverage as _apply_coverage
from test_torch_gn_stats import _coverage, _pair_sums, _tree

GROUPS = 8
EPS = 1e-5
# (B, N, C) of every GroupNorm+SiLU backward of the training paths: the
# UNet2D at the 2D cells' batch of 64, the UNet3D at the 3D cells' 32 and the
# smoke run's 8, the VAE3D's largest at one volume; then ragged sizes
UNET2D = [(16384, 64), (16384, 128), (4096, 128), (4096, 256), (1024, 256), (1024, 512),
          (256, 512)]
UNET3D = [(51200, 128), (51200, 256), (6400, 256), (6400, 512), (800, 512), (800, 1024)]
MAIN_PATH = ([(64, n, c) for n, c in UNET2D] + [(b, n, c) for b in (32, 8) for n, c in UNET3D]
             + [(1, 3276800, 32)])
RAGGED = [(2, 1000, 64), (3, 333, 24), (64, 250, 512), (1, 3276799, 32)]
SHARED_BYTES = 48 * 1024 - 4 * 2 * gn.MAX_GROUPS - 16   # dynamic shared memory beside the static


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b,n,c", MAIN_PATH + RAGGED)
def test_backward_plan_covers_every_element_once(b, n, c, itemsize):
    """Both passes visit every element of a batch entry once; the reduce
    grid is resident at once (at most BWD_BLOCKS_PER_SM blocks an SM over the
    batch) in whole warps, and its row sums and (2, C) sums fit in shared
    memory beside the static."""
    plan = gn.backward_plan(b, n, c, GROUPS, itemsize)
    r = plan.reduce
    assert c % r.vec == 0 and r.vec * itemsize <= 16 and r.vec == plan.apply.vec
    assert r.tx * r.ty == 256 and r.tx & (r.tx - 1) == 0 and r.tx >= min(c // r.vec, 256)
    assert r.rows_per_thread == gn.BWD_ROWS_PER_THREAD
    assert r.slabs == -(-n // r.slab_rows) and 1 <= r.blocks <= r.slabs
    assert b * r.blocks <= gn.BWD_BLOCKS_PER_SM * gn.SM_COUNT
    assert r.shared_bytes(c) <= SHARED_BYTES
    for counts in (*_coverage(r, n, c), *_apply_coverage(plan.apply, n, c)):
        assert (counts == 1).all()


@pytest.mark.parametrize("b,want_blocks", [(64, 4), (32, 8), (8, 33), (1, 264), (300, 1)])
def test_backward_plan_fills_one_wave(b, want_blocks):
    """⌊2·132/B⌋ blocks a batch entry, rounded down so that no block waits
    for a second wave; at least one where the batch alone exceeds it."""
    assert gn.backward_plan(b, 51200, 128, GROUPS, 2).reduce.blocks == want_blocks


def test_backward_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="not divisible"):
        gn.backward_plan(2, 10, 30, 8, 4)
    with pytest.raises(ValueError, match="groups"):
        gn.backward_plan(2, 10, 256, 256, 4)
    with pytest.raises(ValueError, match="channels"):
        gn.backward_plan(2, 10, gn.MAX_CHANNELS + 8, 8, 2)


# ------------------------------------------------------------------ arithmetic


def _kernel_order_sums(v, plan):
    """One batch entry's (N, C) values summed per channel in
    ``gn_silu_bwd_reduce``'s order, float32, one (blocks, C) partial a
    block: per thread and channel, each slab's R rows as a tree, slab sums in
    runs of SLAB_CHAIN, then the runs (zero slabs past N add nothing); the
    rows of a warp (rows_w = 32/tx of them where tx < 32) as a butterfly,
    then the warps' rows as a tree."""
    n, c = v.shape
    rows_w = 32 // plan.tx if plan.tx < 32 else 1
    rounds = plan.slabs_per_block
    padded = torch.zeros(rounds * plan.blocks * plan.slab_rows, c)
    padded[:n] = v
    # row (i·blocks + p)·ty·R + r·ty + y  ->  (i, p, r, y)
    slab = _tree(padded.view(rounds, plan.blocks, plan.rows_per_thread, plan.ty, c).movedim(2, 0))
    acc = torch.zeros(plan.blocks, plan.ty, c)
    run = torch.zeros(plan.blocks, plan.ty, c)
    for i, s in enumerate(slab, start=1):
        run = run + s
        if i % gn.SLAB_CHAIN == 0:
            acc, run = acc + run, torch.zeros_like(run)
    acc = (acc + run).view(plan.blocks, plan.ty // rows_w, rows_w, c)
    warps = _tree(acc.movedim(2, 0))       # (blocks, slots, C)
    return _tree(warps.movedim(1, 0))      # (blocks, C)


def _emulated_backward(x, dy, stats, scale, bias, plan):
    """dx (float32, before the cast to x's dtype), dγ and dβ as the two
    kernels compute them: g = dy·s·(1 + a·(1 − s)) with a = (x − μ)·(r·γ) +
    β and s = σ(a); per batch entry the blocks' (2, C) partials of g and
    g·(x − μ) summed in block order (``pair_sums``) into S, its second row
    times r (the sums of g·x̂); m1, m2 = the group sums of γ·S over N·C/G;
    dβ, dγ = S summed over the batch in entry order; dx = g·(r·γ) − r·m1 −
    (x − μ)·(r²·m2)."""
    b, n, c = x.shape
    groups = stats.shape[-1]
    cpg = c // groups
    per_channel = stats.repeat_interleave(cpg, dim=-1)[:, :, None, :]   # (B, 2, 1, C)
    mean, rs = per_channel[:, 0], per_channel[:, 1]
    rg = rs * scale
    xm = x.float() - mean
    a = xm * rg + bias
    s = 1 / (1 + torch.exp(-a))
    g = dy.float() * s * (1 + a * (1 - s))
    gx = g * xm
    sums = []
    for k in range(b):
        partials = torch.cat([_kernel_order_sums(v[k], plan.reduce) for v in (g, gx)], dim=1)
        sums.append(_pair_sums(partials.T))                       # (2C,)
    sums = torch.stack(sums).view(b, 2, c)
    sums[:, 1] *= rs[:, 0]
    sums = sums.view(b, 2 * c)
    means = torch.stack([_pair_sums((row * scale.repeat(2)).view(2 * groups, cpg))
                         for row in sums]) / (n * cpg)            # (B, 2G)
    dparams = _pair_sums(sums.T).view(2, c)
    m = means.view(b, 2, groups).repeat_interleave(cpg, dim=-1)[:, :, None, :]
    dx = g * rg - rs * m[:, 0] - xm * (rs * rs * m[:, 1])
    return dx, dparams[1], dparams[0]


def _float64_gradient(x, dy, scale, bias, groups=GROUPS):
    """Autograd through the composition in float64, on x's values."""
    leaves = [t.detach().double().requires_grad_() for t in (x, scale, bias)]
    b, c = x.shape[0], x.shape[-1]
    xg = leaves[0].reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    y = F.silu(((xg - mean) * torch.rsqrt(var + EPS)).reshape(x.shape) * leaves[1] + leaves[2])
    return torch.autograd.grad(y, leaves, dy.double())


def _relative(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def _inputs(b, n, c, seed, offset=0.3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32) * 1.5 + offset)
    dy = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32))
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=c).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.normal(size=c).astype(np.float32))
    return x, dy, scale, bias


# (B, N, C), plan: the one backward_plan gives, or one made by hand with many
# slabs a block (runs of slab sums at a size the CPU holds: 79 slabs a block,
# the second block's last ragged)
EMULATED = [
    ((2, 800, 64), None), ((3, 333, 24), None), ((4, 256, 512), None), ((1, 70, 2048), None),
    ((1, 20000, 32), gn.LaunchPlan(vec=8, tx=4, ty=64, rows_per_thread=2, blocks=2, slabs=157)),
]


@pytest.mark.parametrize("shape,plan", EMULATED)
def test_kernel_order_matches_float64_gradient(shape, plan):
    """dx, dγ, dβ of the emulated passes within 1e-5 of the largest value of
    the float64 gradient, on the forward's float32 stats, float32 and bf16
    inputs (dx before its cast: what bf16 rounds is the result)."""
    b, n, c = shape
    x, dy, scale, bias = _inputs(b, n, c, seed=50)
    groups = 16 if c == 2048 else GROUPS
    for dtype in (torch.float32, torch.bfloat16):
        xd, dyd = x.to(dtype), dy.to(dtype)
        stats = gn.gn_silu_stats_reference(xd, groups)
        if plan is None:
            p = gn.backward_plan(b, n, c, groups, xd.element_size())
        else:
            p = gn.BackwardPlan(plan, gn.apply_plan(n, c, groups, xd.element_size()))
        got = _emulated_backward(xd, dyd, stats, scale, bias, p)
        want = _float64_gradient(xd, dyd, scale, bias, groups)
        for name, g, w in zip(("dx", "dscale", "dbias"), got, want):
            assert _relative(g, w) <= 1e-5, (dtype, name, _relative(g, w))


@pytest.mark.parametrize("shape", [(2, 500, 64), (1, 4096, 32)])
def test_kernel_order_matches_jax_grad(shape):
    """dx, dγ, dβ of the emulated passes against ``jax.vjp`` of the JAX
    package's ``group_norm_silu`` (float32 on the CPU) within 1e-4 of the
    largest value."""
    b, n, c = shape
    x, dy, scale, bias = _inputs(b, n, c, seed=51)
    _, vjp = jax.vjp(lambda xx, ss, bb: jax_group_norm_silu(xx, GROUPS, ss, bb),
                     *(jnp.asarray(t.numpy()) for t in (x, scale, bias)))
    want = [torch.from_numpy(np.array(w, dtype=np.float64)) for w in vjp(jnp.asarray(dy.numpy()))]
    stats = gn.gn_silu_stats_reference(x, GROUPS)
    got = _emulated_backward(x, dy, stats, scale, bias, gn.backward_plan(b, n, c, GROUPS, 4))
    for name, g, w in zip(("dx", "dscale", "dbias"), got, want):
        assert _relative(g, w) <= 1e-4, (name, _relative(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_differentiates_the_plain_composition(dtype):
    """On a CPU tensor the ``autograd.Function`` saves no stats, launches no
    kernel, and its gradients are bitwise those of autograd through
    ``ops.norms.group_norm_silu``."""
    x, dy, scale, bias = _inputs(2, 96, 32, seed=52)
    leaves = [x.to(dtype).requires_grad_(), scale.requires_grad_(), bias.requires_grad_()]
    gn.launches.reset()
    y = gn.group_norm_silu_fused(*leaves, GROUPS)
    assert y.grad_fn.saved_tensors[3] is None
    got = torch.autograd.grad(y, leaves, dy.to(dtype))
    want = torch.autograd.grad(group_norm_silu(leaves[0], GROUPS, *leaves[1:]), leaves,
                               dy.to(dtype))
    assert not any(gn.launches.as_dict().values())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
