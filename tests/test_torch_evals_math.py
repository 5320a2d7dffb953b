"""The port's evaluation statistics against ``mrijax.evals`` on the same
seeded numpy inputs: the host math copies (FID, KID, improved precision and
recall, memorization, Dice, HD95) bitwise, and SSIM / MS-SSIM (PyTorch
convolutions against ``lax.conv``) within 1e-5 absolute."""

import numpy as np
import pytest
import torch

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.evals import frechet as jfrechet
from mrijax.evals import memorization as jmem
from mrijax.evals import prd as jprd
from mrijax.evals import segmentation as jseg
from mrijax.evals.ssim import ms_ssim as jax_ms_ssim, ssim as jax_ssim
from mrijax_torch.evals import frechet, memorization, prd, segmentation
from mrijax_torch.evals import ms_ssim, ssim

SSIM_ATOL = 1e-5


def feats(seed, n, d=24, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) + shift).astype(np.float32)


def test_frechet_and_fid_bitwise():
    real, fake = feats(0, 40), feats(1, 36, shift=0.3)
    acc_j, acc_p = jfrechet.FidAccumulator(24), frechet.FidAccumulator(24)
    for lo in range(0, 40, 16):   # streamed in uneven batches
        acc_j.update(real[lo:lo + 16])
        acc_p.update(real[lo:lo + 16])
    mu_j, cov_j = acc_j.stats()
    mu_p, cov_p = acc_p.stats()
    assert np.array_equal(mu_j, mu_p) and np.array_equal(cov_j, cov_p)
    other = jfrechet.FidAccumulator(24)
    other.update(fake)
    assert (frechet.frechet_distance(mu_p, cov_p, *other.stats())
            == jfrechet.frechet_distance(mu_j, cov_j, *other.stats()))
    assert frechet.fid_from_features(real, fake) == jfrechet.fid_from_features(real, fake)
    with pytest.raises(ValueError):
        frechet.FidAccumulator(4).stats()


@pytest.mark.parametrize("subset_size,num_subsets,seed", [(1000, 100, 0), (12, 7, 3)])
def test_kid_bitwise(subset_size, num_subsets, seed):
    """Seeded subsets: all points (subset larger than the sets) and random
    subsets of 12."""
    real, fake = feats(2, 30), feats(3, 25, shift=0.2)
    kw = dict(subset_size=subset_size, num_subsets=num_subsets, seed=seed)
    assert (frechet.kid_from_features(real, fake, **kw)
            == jfrechet.kid_from_features(real, fake, **kw))


@pytest.mark.parametrize("chunk", [1024, 7])
def test_improved_precision_recall_bitwise(chunk):
    real, fake = feats(4, 50), feats(5, 45, shift=0.5)
    got = prd.improved_precision_recall(real, fake, k=3, chunk=chunk)
    assert got == jprd.improved_precision_recall(real, fake, k=3, chunk=chunk)
    assert 0.0 < got[0] < 1.0 and 0.0 < got[1] < 1.0
    with pytest.raises(ValueError):
        prd.improved_precision_recall(real[:3], fake)


def test_memorization_bitwise():
    rng = np.random.default_rng(6)
    fakes = rng.uniform(-1, 1, size=(20, 8, 8, 1)).astype(np.float32)
    reals = rng.uniform(-1, 1, size=(33, 8, 8, 1)).astype(np.float32)
    reals[5] = fakes[3]   # one memorized sample
    got = memorization.memorization_stats(fakes, reals, chunk=6)
    assert got == jmem.memorization_stats(fakes, reals, chunk=6)
    assert got["max"] == pytest.approx(1.0)
    assert np.array_equal(memorization.max_cosine_similarity(fakes, reals),
                          jmem.max_cosine_similarity(fakes, reals))


def label_maps(seed, shape=(20, 24, 12)):
    """Two overlapping BraTS-style label maps (labels 1, 2, 4 in blobs)."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    out = []
    for _ in range(2):
        lab = np.zeros(shape, np.int16)
        for label, radius in ((2, 7.0), (1, 4.0), (4, 2.5)):
            c = [s / 2 + rng.uniform(-2, 2) for s in shape]
            d2 = sum((g - ci) ** 2 for g, ci in zip(grids, c))
            lab[d2 <= radius ** 2] = label
        out.append(lab)
    return out


@pytest.mark.parametrize("spacing", [None, (1.0, 1.0, 2.5)])
@pytest.mark.parametrize("absent", [None, 4, "pred"])
def test_dice_and_hd95_bitwise(spacing, absent):
    """With and without voxel spacing; a label absent from both maps
    (Dice 1, HD95 0) and from the prediction only (HD95 inf)."""
    pred, target = label_maps(7)
    if absent == 4:
        pred[pred == 4] = 0
        target[target == 4] = 0
    elif absent == "pred":
        pred[pred == 1] = 0
    dice = segmentation.dice_per_label(pred, target)
    assert dice == jseg.dice_per_label(pred, target)
    hd = segmentation.hd95_per_label(pred, target, spacing=spacing)
    assert hd == jseg.hd95_per_label(pred, target, spacing=spacing)
    if absent == 4:
        assert dice[4] == 1.0 and hd[4] == 0.0
    if absent == "pred":
        assert hd[1] == float("inf")
    assert segmentation.BRATS_LABELS == jseg.BRATS_LABELS
    with pytest.raises(ValueError):
        segmentation.dice_per_label(pred, target[:-1])


def ssim_pair(seed, size, channels):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, size=(3, size, size, channels)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("channels,data_range", [(1, 1.0), (3, 2.0)])
def test_ssim_matches_jax(channels, data_range):
    a, b = ssim_pair(8, 37, channels)
    want = np.asarray(jax_ssim(a, b, data_range=data_range))
    got = ssim(torch.from_numpy(a), torch.from_numpy(b), data_range=data_range)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SSIM_ATOL)
    # numpy in, the same numbers
    np.testing.assert_array_equal(ssim(a, b, data_range=data_range).numpy(), got.numpy())


@pytest.mark.parametrize("levels,size", [(2, 48), (3, 48), (3, 51)])
def test_ms_ssim_matches_jax(levels, size):
    """Levels 2 and 3 at 48² (11·2² = 44 ≤ 48), and at 51², where the pools
    drop the odd row and column."""
    a, b = ssim_pair(9, size, 1)
    want = np.asarray(jax_ms_ssim(a, b, data_range=1.0, levels=levels))
    got = ms_ssim(torch.from_numpy(a), torch.from_numpy(b), data_range=1.0, levels=levels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SSIM_ATOL)
