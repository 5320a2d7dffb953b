"""What surrounds the ``gn_silu_stats`` kernel and can be checked without a
GPU: its launch plan (``launch_plan``: vector width, block shape, loads per
thread, blocks and partials per batch entry) at the shapes the main paths
give it, and the order in which the kernel sums, emulated in plain PyTorch
and held against the port's plain version, against the JAX package's Pallas
``_stats_kernel`` in interpret mode and, where the mean is far from zero,
against float64 sums. The kernel itself is held against the plain version on
the card by ``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``."""

import functools

import numpy as np
import pytest
import torch

from mrijax_torch.kernels import groupnorm as gn

GROUPS = 8
EPS = 1e-5
# (N, C) of every GroupNorm+SiLU call site of the generation and training
# paths (UNet3D and VAE3D decode), then the ragged sizes chip_smoke.py adds
MAIN_PATH = [(51200, 128), (51200, 256), (6400, 256), (6400, 512), (800, 512),
             (800, 1024), (51200, 64), (409600, 64), (409600, 32), (3276800, 32)]
RAGGED = [(1000, 64), (333, 24)]
SHARED_BYTES = 48 * 1024 - 4 * 2 * gn.MAX_GROUPS - 16   # dynamic shared memory beside the static


def _coverage(plan, n, c):
    """How often the kernel's index arithmetic visits each row and each
    vector column of one batch entry: block p (< blocks) takes slabs
    s = p, p + blocks, ... (< slabs); thread (x, y) takes rows
    s·ty·R + r·ty + y for r < R and, in column pass k, vector column
    k·tx + x; out-of-range rows and columns are skipped. Rows and columns are
    independent, so every element is visited exactly once iff both counts are
    all ones."""
    cols = c // plan.vec
    slabs = np.concatenate([np.arange(p, plan.slabs, plan.blocks) for p in range(plan.blocks)])
    rows = (slabs[:, None, None] * plan.slab_rows
            + np.arange(plan.rows_per_thread)[None, :, None] * plan.ty
            + np.arange(plan.ty)[None, None, :]).ravel()
    passes = -(-cols // plan.tx)
    columns = (np.arange(passes)[:, None] * plan.tx + np.arange(plan.tx)[None, :]).ravel()
    return (np.bincount(rows[rows < n], minlength=n),
            np.bincount(columns[columns < cols], minlength=cols))


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,c", MAIN_PATH + RAGGED)
def test_launch_plan_covers_every_element_once(n, c, itemsize, batch):
    plan = gn.launch_plan(n, c, GROUPS, itemsize, 16, batch)
    assert c % plan.vec == 0 and plan.vec * itemsize <= 16
    assert plan.rows_per_thread in gn.STATS_ROWS_PER_THREAD
    assert plan.slabs == -(-n // plan.slab_rows) and 1 <= plan.blocks <= plan.slabs
    row_counts, col_counts = _coverage(plan, n, c)
    assert (row_counts == 1).all() and (col_counts == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,c", MAIN_PATH + RAGGED + [(70, 2048)])
def test_launch_plan_block_is_whole_warps_in_shared_memory(n, c, itemsize):
    """256 threads, tx a power of two (the reductions shuffle inside warps);
    a vector holds whole groups or lies in one; the warps' row sums and the
    group pieces fit beside the static shared memory."""
    plan = gn.launch_plan(n, c, GROUPS, itemsize)
    assert plan.tx * plan.ty == 256 and plan.tx & (plan.tx - 1) == 0
    assert plan.tx >= min(c // plan.vec, 256)
    cpg = c // GROUPS
    assert cpg % plan.vec == 0 or plan.vec % cpg == 0
    slots = plan.ty * plan.tx // 32 if plan.tx < 32 else plan.ty
    assert slots <= 8
    assert 4 * 2 * (slots * plan.tx * plan.vec + c) <= SHARED_BYTES


@pytest.mark.parametrize("n,c,itemsize,alignment,want_vec", [
    (3276800, 32, 2, 16, 8),   # 4 channels a group: a 16-byte vector spans two groups
    (409600, 32, 2, 16, 8),
    (3276800, 32, 2, 8, 4),    # a pointer aligned to 8 bytes only
    (3276800, 32, 2, 2, 1),
    (3276800, 32, 4, 16, 4),
    (333, 24, 2, 16, 1),       # 3 channels a group: no vector holds whole groups
    (333, 24, 4, 4, 1),
    (100, 48, 2, 16, 2),       # 6 channels a group: pairs of channels
])
def test_launch_plan_takes_16_byte_vectors_across_groups(n, c, itemsize, alignment, want_vec):
    assert gn.launch_plan(n, c, GROUPS, itemsize, alignment, 2).vec == want_vec


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,c", MAIN_PATH)
def test_launch_plan_fills_the_card_at_every_main_path_shape(n, c, itemsize):
    """At least one block per SM across the two batch entries of a generate
    call, with the most loads a thread that still allow it."""
    plan = gn.launch_plan(n, c, GROUPS, itemsize, 16, 2)
    assert 2 * plan.blocks >= gn.SM_COUNT
    if plan.rows_per_thread < max(gn.STATS_ROWS_PER_THREAD):
        assert 2 * -(-n // (2 * plan.slab_rows)) < gn.SM_COUNT


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("n,c", MAIN_PATH + RAGGED)
def test_partials_per_batch_entry_stay_within_the_stated_bound(n, c, batch):
    """At most ⌈STATS_BLOCKS_PER_SM·SM_COUNT/B⌉ partials a batch entry: the
    grid is one wave. A thread adds its slab sums in runs of SLAB_CHAIN, then
    the runs: no chain of more than a few dozen additions."""
    plan = gn.launch_plan(n, c, GROUPS, 2, 16, batch)
    assert plan.blocks <= -(-gn.STATS_BLOCKS_PER_SM * gn.SM_COUNT // batch)
    assert batch * plan.blocks <= gn.STATS_BLOCKS_PER_SM * gn.SM_COUNT + batch
    per_block = plan.slabs_per_block
    assert min(per_block, gn.SLAB_CHAIN) + per_block // gn.SLAB_CHAIN <= 48


def test_stats_plan_at_the_most_frequent_shape():
    """(2, 800, 512) bf16, 11 calls a UNet forward: 66 blocks a batch entry,
    one an SM across the batch (100 slabs of 8 rows an entry), two 16-byte
    loads a thread."""
    plan = gn.launch_plan(800, 512, GROUPS, 2, 16, 2)
    assert (plan.vec, plan.tx, plan.ty, plan.rows_per_thread) == (8, 64, 4, 2)
    assert (plan.blocks, plan.slabs, plan.slabs_per_block) == (66, 100, 2)


@pytest.mark.parametrize("n,c,want_per_sm", [
    (800, 512, 1), (800, 1024, 1), (6400, 256, 1), (6400, 512, 1), (51200, 64, 1),
    (51200, 128, 2), (51200, 256, 2), (409600, 64, 2), (409600, 32, 2), (3276800, 32, 2),
])
def test_stats_plan_takes_a_second_block_an_sm_only_for_many_slabs(n, c, want_per_sm):
    """bf16, B = 2: one block an SM up to STATS_SLABS_PER_SM slabs an SM,
    two above."""
    plan = gn.launch_plan(n, c, GROUPS, 2, 16, 2)
    assert 2 * plan.blocks == want_per_sm * gn.SM_COUNT


def test_launch_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="not divisible"):
        gn.launch_plan(10, 30, 8, 4)
    with pytest.raises(ValueError, match="groups"):
        gn.launch_plan(10, 256, 256, 4)
    with pytest.raises(ValueError, match="channels"):
        gn.launch_plan(10, 4096, 8, 2)


# ------------------------------------------------------------------ arithmetic


def _tree(v):
    """Sum over the first axis as the kernel's shared-memory tree: with h
    the power of two below n (at or above n / 2), row y takes row y + h for
    y < n − h, then n = h."""
    n = v.shape[0]
    h = 1
    while 2 * h < n:
        h *= 2
    while n > 1:
        v = torch.cat([v[:n - h] + v[h:n], v[n - h:h]])
        n, h = h, h // 2
    return v[0]


def _pair_sums(vals):
    """``pair_sums`` of the kernel on (pairs, count) values: L lanes a pair
    (the largest power of two up to 32 with L·pairs ≤ 256), lane l adds items
    l, l + L, ... in order from 0, then the lanes add as a tree."""
    pairs, count = vals.shape
    lanes = 32
    while lanes > 1 and lanes * pairs > 256:
        lanes //= 2
    k = -(-count // lanes)
    padded = torch.zeros(pairs, k * lanes, dtype=vals.dtype)
    padded[:, :count] = vals
    acc = torch.zeros(pairs, lanes, dtype=vals.dtype)
    for step in padded.view(pairs, k, lanes).unbind(1):
        acc = acc + step
    return _tree(acc.T)


def _kernel_sums(x, groups, plan):
    """Σx and Σx² (B, 2, G) in the kernel's order, float32: per thread and
    channel, each slab's R rows as a tree, slab sums added in series in runs
    of SLAB_CHAIN, then the runs (zero slabs past N add nothing); the
    thread's adjacent channels of one group pairwise; the rows of a warp
    (rows_w = 32/tx of them where tx < 32) as a butterfly, then the warps'
    rows as a tree; the group pieces of a row and the batch entry's partials
    (block-index order) with ``pair_sums``."""
    b, n, c = x.shape
    x = x.float()
    piece = min(c // groups, plan.vec)
    rows_w = 32 // plan.tx if plan.tx < 32 else 1
    rounds = plan.slabs_per_block
    rows = rounds * plan.blocks * plan.slab_rows
    xp = torch.zeros(b, rows, c)
    xp[:, :n] = x
    # row (i·blocks + p)·ty·R + r·ty + y  ->  (i, p, r, y)
    xp = xp.view(b, rounds, plan.blocks, plan.rows_per_thread, plan.ty, c)
    out = []
    for xb in xp:
        per_kind = []
        for v in (xb, xb * xb):
            slab = _tree(v.movedim(2, 0))                  # (rounds, blocks, ty, C)
            acc = torch.zeros(plan.blocks, plan.ty, c)
            run = torch.zeros(plan.blocks, plan.ty, c)
            for i, s in enumerate(slab, start=1):
                run = run + s
                if i % gn.SLAB_CHAIN == 0:
                    acc, run = acc + run, torch.zeros_like(run)
            acc = acc + run
            acc = acc.view(plan.blocks, plan.ty, c // piece, piece)
            while acc.shape[-1] > 1:                      # adjacent channels, pairwise
                acc = acc[..., 0::2] + acc[..., 1::2]
            acc = acc.view(plan.blocks, plan.ty // rows_w, rows_w, c // piece)
            warps = _tree(acc.movedim(2, 0))              # (blocks, slots, pieces)
            per_kind.append(_tree(warps.movedim(1, 0)))   # (blocks, pieces)
        pieces = torch.stack(per_kind, dim=1)             # (blocks, 2, C / piece)
        partials = torch.stack([_pair_sums(blk.reshape(2 * groups, -1)) for blk in pieces])
        out.append(_pair_sums(partials.T).view(2, groups))
    return torch.stack(out)


def _stats_from_sums(sums, count, eps=EPS):
    """The kernel's finalize: mean = Σx/count, var = max(Σx²/count − mean², 0)."""
    mean = sums[:, 0] / count
    var = (sums[:, 1] / count - mean * mean).clamp_min(0.0)
    return torch.stack([mean, 1.0 / torch.sqrt(var + eps)], dim=1)


def _inputs(b, n, c, seed, offset=0.3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32) * 1.5 + offset)


# (B, N, C), plan: the one launch_plan gives, or one made by hand with many
# slabs a block (the largest shapes' runs of slab sums, at a size the CPU
# holds; the last: 127 slabs a block, the second block's last slab ragged)
EMULATED = [
    ((2, 800, 512), None), ((2, 6400, 256), None), ((2, 333, 24), None),
    ((2, 1000, 64), None), ((1, 51200, 32), None), ((1, 70, 2048), None),
    ((2, 4096, 32), gn.LaunchPlan(vec=8, tx=4, ty=64, rows_per_thread=4, blocks=2, slabs=16)),
    ((1, 32768, 32), gn.LaunchPlan(vec=8, tx=4, ty=64, rows_per_thread=4, blocks=4, slabs=128)),
    ((1, 65000, 32), gn.LaunchPlan(vec=8, tx=4, ty=64, rows_per_thread=4, blocks=2, slabs=254)),
]


@pytest.mark.parametrize("shape,plan", EMULATED)
def test_kernel_order_matches_plain_version(shape, plan):
    """Mean and 1/std at 2e-5 absolute, the bar of the kernel on the card,
    float32 and bf16 inputs."""
    b, n, c = shape
    x = _inputs(b, n, c, seed=40)
    groups = 16 if c == 2048 else GROUPS
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        p = plan or gn.launch_plan(n, c, groups, xd.element_size(), 16, b)
        got = _stats_from_sums(_kernel_sums(xd, groups, p), n * (c // groups))
        want = gn.gn_silu_stats_reference(xd, groups)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        # on a CPU tensor the wrapper is the plain version
        torch.testing.assert_close(gn.gn_silu_stats(xd, groups), want, atol=0, rtol=0)


def test_kernel_order_matches_pallas_stats_kernel_interpret():
    """Σx and Σx² against the JAX package's ``_stats_kernel`` alone, in TPU
    interpret mode (4 row blocks summed over its sequential grid axis).
    Tolerance: count·2⁻²⁴·Σ|x| absolute, the bound on the rounding of any
    order of float32 additions of ``count`` terms (Σ|x|² = Σx² for the
    squares)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from mrijax.kernels.groupnorm_pallas import STATS_PAD, _stats_kernel

    b, n, c, block_n = 2, 256, 32, 64
    x = _inputs(b, n, c, seed=41)
    vmem = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    call = functools.partial(
        pl.pallas_call,
        functools.partial(_stats_kernel, n=n, block_n=block_n, groups=GROUPS),
        grid=(b, n // block_n),
        in_specs=[vmem((1, block_n, c), lambda i, j: (i, j, 0))],
        out_specs=vmem((1, 2, STATS_PAD), lambda i, j: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, 2, STATS_PAD), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, STATS_PAD), jnp.float32)],
    )
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(lambda a: call()(a))(jnp.asarray(x.numpy())))[:, :, :GROUPS]
    got = _kernel_sums(x, GROUPS, gn.launch_plan(n, c, GROUPS, 4, 16, b)).numpy()
    count = n * (c // GROUPS)
    xg = x.double().reshape(b, n, GROUPS, -1)
    magnitude = torch.stack([xg.abs().sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))], dim=1)
    np.testing.assert_array_less(np.abs(got - want), count * 2.0 ** -24 * magnitude.numpy())


@pytest.mark.parametrize("shape,plain_too", [((2, 100, 64), True), ((1, 51200, 32), True)])
def test_far_from_zero_mean_against_float64(shape, plain_too):
    """x = 200 + 1.5·N(0, 1): E[x²] − mean² cancels to 1/17 800 of E[x²].
    The kernel's order holds the variance to 16·2⁻²⁴·E[x²] of the float64
    variance: Σx²/count and mean² are each within a few ulps of E[x²] (tree
    sums, at most a few dozen terms a chain), so their difference is too. One
    float32 chain over all N·C/G terms of a group misses that bar at
    N = 51 200. The plain version, whose variance is two-pass
    (``torch.var_mean``), is held to the same bar at both shapes."""
    b, n, c = shape
    x = _inputs(b, n, c, seed=42, offset=200.0)
    count = n * (c // GROUPS)
    xg = x.double().reshape(b, n, GROUPS, -1)
    ex2 = (xg * xg).sum(dim=(1, 3)) / count
    mean = xg.sum(dim=(1, 3)) / count
    var64 = ex2 - mean * mean
    bar = 16 * 2.0 ** -24 * ex2
    sums = _kernel_sums(x, GROUPS, gn.launch_plan(n, c, GROUPS, 4, 16, b))
    kernel_mean = sums[:, 0] / count
    orders = {"kernel": (sums[:, 1] / count - kernel_mean * kernel_mean).double()}
    if plain_too:
        orders["plain"] = gn.gn_silu_stats_reference(x, GROUPS)[:, 1].double() ** -2 - EPS
    for name, var in orders.items():
        assert bool(((var - var64).abs() <= bar).all()), (name, (var - var64).abs().max())
    if n >= 51200:
        # what the bar rules out: one float32 chain over every term of a group
        chain = torch.zeros(b, GROUPS)
        for row in (x * x).reshape(b, n, GROUPS, -1).permute(1, 3, 0, 2).reshape(-1, b, GROUPS):
            chain = chain + row
        chained = chain.double() / count - mean * mean
        assert bool(((chained - var64).abs() > bar).any())


def test_plain_route_far_from_zero_matches_jax_group_norm_silu():
    """The port's CPU route of GroupNorm+SiLU (``group_norm_silu_auto``: the
    kernels' plain versions on a CPU tensor) against the JAX package's
    ``mrijax.ops.norms.group_norm_silu`` (``jnp.mean`` and ``jnp.var``) at a
    UNet level-0 shape, (2, 51 200, 128), with x = 200 + 1.5·N(0, 1). The
    plain variance stays within 16·2⁻²⁴·E[x²] of float64, and the outputs
    agree to 1e-4 absolute: each side's mean is within a few float32 ulps of
    200 (1.5e-5 each), about 1e-5 of a normalised unit."""
    import jax.numpy as jnp

    from mrijax.ops.norms import group_norm_silu as jax_group_norm_silu
    from mrijax_torch.ops.norms import group_norm_silu_auto

    b, n, c = 2, 51200, 128
    x = _inputs(b, n, c, seed=43, offset=200.0)
    rng = np.random.default_rng(44)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)

    xg = x.double().reshape(b, n, GROUPS, -1)
    var64 = xg.var(dim=(1, 3), correction=0)
    bar = 16 * 2.0 ** -24 * (xg * xg).mean(dim=(1, 3))
    var = gn.gn_silu_stats_reference(x, GROUPS)[:, 1].double() ** -2 - EPS
    assert bool(((var - var64).abs() <= bar).all()), (var - var64).abs().max()

    got = group_norm_silu_auto(x, GROUPS, torch.from_numpy(scale), torch.from_numpy(bias))
    want = jax_group_norm_silu(jnp.asarray(x.numpy()), GROUPS, jnp.asarray(scale),
                               jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
