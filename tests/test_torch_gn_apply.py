"""What surrounds the ``gn_silu_apply`` kernel and can be checked without a
GPU: its launch plan (``apply_plan``: vector width, block shape, loads per
thread) at the shapes the main paths give it, and the per-channel arithmetic
of its design, emulated in plain PyTorch and held against the port's plain
version and against the JAX package's Pallas ``_apply_kernel`` in interpret
mode. The kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``."""

import functools

import numpy as np
import pytest
import torch

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax_torch.kernels import groupnorm as gn

GROUPS = 8
# (N, C) of every GroupNorm+SiLU call site of the generation and training
# paths (UNet3D and VAE3D decode), then the ragged sizes chip_smoke.py adds
MAIN_PATH = [(51200, 128), (51200, 256), (6400, 256), (6400, 512), (800, 512),
             (800, 1024), (51200, 64), (409600, 64), (409600, 32), (3276800, 32)]
RAGGED = [(1000, 64), (333, 24)]
SMALL = [(n, c) for n, c in MAIN_PATH if n * c <= 6400 * 512]


def _coverage(plan, n, c):
    """How often the kernel's index arithmetic visits each row and each
    vector column of one batch entry: block (row_chunk, batch, col_chunk),
    thread (x, y), rows row_chunk·ty·R + y + r·ty for r < R, column
    col_chunk·tx + x; out-of-range rows and columns are skipped. Rows and columns are independent, so every element is visited
    exactly once iff both counts are all ones."""
    cols = c // plan.vec
    rows = (np.arange(plan.row_chunks)[:, None, None] * plan.ty * plan.rows_per_thread
            + np.arange(plan.ty)[None, :, None]
            + np.arange(plan.rows_per_thread)[None, None, :] * plan.ty).ravel()
    columns = (np.arange(plan.col_chunks)[:, None] * plan.tx
               + np.arange(plan.tx)[None, :]).ravel()
    return (np.bincount(rows[rows < n], minlength=n),
            np.bincount(columns[columns < cols], minlength=cols))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,c", MAIN_PATH + RAGGED)
def test_apply_plan_covers_every_element_once(n, c, itemsize):
    plan = gn.apply_plan(n, c, GROUPS, itemsize)
    assert c % plan.vec == 0 and plan.vec * itemsize <= 16
    assert plan.tx * plan.ty <= 256 and plan.rows_per_thread in gn.APPLY_ROWS_PER_THREAD
    row_counts, col_counts = _coverage(plan, n, c)
    assert (row_counts == 1).all() and (col_counts == 1).all()


@pytest.mark.parametrize("b", [2, 8])
def test_apply_plan_grid_is_the_same_for_every_batch_entry(b):
    """The grid's second axis is the batch entry: at B = 8 each entry gets
    the blocks of the plan, which depends on (N, C) alone."""
    for n, c in MAIN_PATH:
        plan = gn.apply_plan(n, c, GROUPS, 2)
        assert b * plan.blocks_per_batch * plan.tx * plan.ty * plan.rows_per_thread \
            >= b * n * (c // plan.vec)


@pytest.mark.parametrize("n,c,itemsize,alignment,want_vec", [
    (3276800, 32, 2, 16, 8),   # 4 channels a group: a 16-byte vector spans two groups
    (409600, 32, 2, 16, 8),
    (3276800, 32, 2, 8, 4),    # a pointer aligned to 8 bytes only
    (3276800, 32, 4, 16, 4),
    (333, 24, 2, 16, 8),       # 3 channels a group
    (333, 24, 4, 16, 4),
    (333, 24, 2, 4, 2),
    (100, 12, 2, 16, 4),       # C not a multiple of 8 bf16 values
    (100, 9, 4, 16, 1),
])
def test_apply_plan_takes_16_byte_vectors_across_groups(n, c, itemsize, alignment, want_vec):
    groups = 3 if c == 9 else (4 if c == 12 else GROUPS)
    assert gn.apply_plan(n, c, groups, itemsize, alignment).vec == want_vec


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,c", SMALL)
def test_apply_plan_gives_every_sm_a_block_at_small_shapes(n, c, itemsize):
    """Each batch entry alone gets at least one block per SM of an H100."""
    assert gn.apply_plan(n, c, GROUPS, itemsize).blocks_per_batch >= gn.SM_COUNT


def test_apply_plan_at_the_most_frequent_shape():
    """(2, 800, 512) bf16, 11 calls a UNet forward: the stats plan's 66
    blocks a batch entry over 100 slabs of 8 rows (two 16-byte loads a
    thread) and apply's 200 blocks of 4 rows, one 16-byte vector a thread —
    400 blocks at B = 2."""
    stats = gn.launch_plan(800, 512, GROUPS, 2, 16, 2)
    assert (stats.blocks, stats.slab_rows, stats.rows_per_thread) == (66, 8, 2)
    plan = gn.apply_plan(800, 512, GROUPS, 2)
    assert (plan.vec, plan.tx, plan.ty, plan.rows_per_thread) == (8, 64, 4, 1)
    assert 2 * plan.blocks_per_batch == 400


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,c", MAIN_PATH + RAGGED)
def test_apply_plan_gives_each_thread_the_most_loads_that_fill_the_card(n, c, itemsize):
    """R = rows_per_thread loads a thread, the largest of 2, 1 that keeps a
    block on every SM; the large shapes issue 2."""
    plan = gn.apply_plan(n, c, GROUPS, itemsize)
    r = plan.rows_per_thread
    if r < max(gn.APPLY_ROWS_PER_THREAD):
        more = -(-n // (plan.ty * 2 * r)) * plan.col_chunks
        assert more < gn.SM_COUNT
    if n * c >= 51200 * 128:
        assert r == max(gn.APPLY_ROWS_PER_THREAD)


def test_apply_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="not divisible"):
        gn.apply_plan(10, 30, 8, 4)
    with pytest.raises(ValueError, match="groups"):
        gn.apply_plan(10, 256, 256, 4)


# ------------------------------------------------------------------ arithmetic


def _apply_emulation(x, stats, scale, bias):
    """The kernel's arithmetic: every channel carries its own mean,
    rstd·γ and β; y = (x − mean_c)·(rstd·γ)_c + β_c and SiLU as
    y / (1 + exp(−y)) in fp32, one cast."""
    c = x.shape[-1]
    group = torch.arange(c) // (c // stats.shape[-1])
    mean = stats[:, 0][:, group][:, None, :]
    a = (stats[:, 1][:, group] * scale)[:, None, :]
    y = (x.float() - mean) * a + bias
    return (y / (1 + torch.exp(-y))).to(x.dtype)


def _inputs(b, n, c, seed, offset=0.3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32) * 1.5 + offset)
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=c).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.normal(size=c).astype(np.float32))
    return x, scale, bias


@pytest.mark.parametrize("b,n,c,offset", [
    (2, 800, 512, 0.3), (2, 333, 24, 0.3), (1, 4096, 32, 0.3),
    (2, 100, 64, 200.0),   # |mean| >> std: the subtraction must come first
])
def test_per_channel_arithmetic_matches_plain_version(b, n, c, offset):
    """float32 2e-5 absolute (the kernel's bar on the card: the product is
    (x − μ)·(rstd·γ) there, ((x − μ)·rstd)·γ in the plain version); bf16
    one ulp."""
    x, scale, bias = _inputs(b, n, c, seed=30, offset=offset)
    for dtype, tol in ((torch.float32, dict(atol=2e-5, rtol=0)),
                       (torch.bfloat16, dict(atol=1e-5, rtol=1e-2))):
        xd = x.to(dtype)
        stats = gn.gn_silu_stats_reference(xd, GROUPS)
        want = gn.gn_silu_apply_reference(xd, stats, scale, bias)
        torch.testing.assert_close(_apply_emulation(xd, stats, scale, bias), want, **tol)
        # on a CPU tensor the wrapper is the plain version
        torch.testing.assert_close(gn.gn_silu_apply(xd, stats, scale, bias), want,
                                   rtol=0, atol=0)


def test_per_channel_arithmetic_matches_pallas_apply_kernel_interpret():
    """The JAX package's ``_apply_kernel`` alone, in TPU interpret mode, on
    the same per-(batch, group) sums: it broadcasts the group statistics to
    channels as the kernel does. Tolerance 2e-5 absolute, that of the JAX
    package's own kernel test."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from mrijax.kernels.groupnorm_pallas import STATS_PAD, _apply_kernel

    b, n, c, eps = 2, 64, 32, 1e-5
    x, scale, bias = _inputs(b, n, c, seed=31)
    xg = x.reshape(b, n, GROUPS, c // GROUPS)
    sums = torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))], dim=1)   # (B, 2, G)
    padded = np.zeros((b, 2, STATS_PAD), np.float32)
    padded[:, :, :GROUPS] = sums.numpy()
    vmem = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    call = functools.partial(
        pl.pallas_call,
        functools.partial(_apply_kernel, n=n, block_n=n, groups=GROUPS, eps=eps),
        grid=(b, 1),
        in_specs=[vmem((1, n, c), lambda i, j: (i, j, 0)),
                  vmem((1, 2, STATS_PAD), lambda i, j: (i, 0, 0)),
                  vmem((1, c), lambda i, j: (0, 0)), vmem((1, c), lambda i, j: (0, 0))],
        out_specs=vmem((1, n, c), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((b, n, c), jnp.float32),
    )
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda *args: call()(*args))(jnp.asarray(x.numpy()), jnp.asarray(padded),
                    jnp.asarray(scale.numpy()).reshape(1, c), jnp.asarray(bias.numpy()).reshape(1, c))
    count = n * (c // GROUPS)
    mean = sums[:, 0] / count
    rstd = torch.rsqrt(sums[:, 1] / count - mean * mean + eps)
    got = _apply_emulation(x, torch.stack([mean, rstd], dim=1), scale, bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
