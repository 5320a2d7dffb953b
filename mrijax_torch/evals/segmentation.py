"""Segmentation-map metrics: per-label Dice and HD95.

Copy of ``mrijax/evals/segmentation.py`` (numpy and ``scipy.ndimage`` on the
host). Parity with `evaluation_scripts/evaluate_models.py:476-549` (BraTS
labels 1/2/4): Dice = (2|A∩B| + eps) / (|A|+|B| + eps) with eps=1e-5, the
reference's literal smoothed formula at :495-498 (the empty-empty convention
= 1.0 falls out as eps/eps); HD95 = 95th percentile of the symmetric
MASK-to-mask distances (the EDT of each mask's complement sampled at every
voxel of the other mask — interior voxels of the overlap contribute 0,
exactly the reference's `distance_transform_edt` formulation at :519-527;
NOT a surface-to-surface variant, which disagrees whenever masks overlap).
"""

from typing import Dict, Sequence

import numpy as np
from scipy import ndimage

BRATS_LABELS = (1, 2, 4)

DICE_EPS = 1e-5  # evaluate_models.py:480


def dice_coefficient(a: np.ndarray, b: np.ndarray,
                     eps: float = DICE_EPS) -> float:
    """Smoothed Dice `(2I + eps) / (|A|+|B| + eps)`
    (`evaluate_models.py:495-498`). Both masks empty → eps/eps = 1.0."""
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    inter = np.logical_and(a, b).sum()
    denom = a.sum() + b.sum()
    return float((2.0 * inter + eps) / (denom + eps))


def dice_per_label(
    pred: np.ndarray, target: np.ndarray, labels: Sequence[int] = BRATS_LABELS,
    eps: float = DICE_EPS,
) -> Dict[int, float]:
    pred = np.asarray(pred)
    target = np.asarray(target)
    if pred.shape != target.shape:
        raise ValueError(
            f"Shape mismatch: pred {pred.shape}, target {target.shape}")
    return {
        int(l): dice_coefficient(pred == l, target == l, eps) for l in labels
    }


def hd95(a: np.ndarray, b: np.ndarray, spacing=None) -> float:
    """95th-percentile symmetric Hausdorff distance, reference formulation
    (`evaluate_models.py:500-528`): EDT of each mask's COMPLEMENT sampled
    at every voxel of the other mask. Conventions: both empty → 0.0;
    exactly one empty → inf."""
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    if not a.any() and not b.any():
        return 0.0
    if not a.any() or not b.any():
        return float("inf")
    dt_b = ndimage.distance_transform_edt(~b, sampling=spacing)
    dt_a = ndimage.distance_transform_edt(~a, sampling=spacing)
    all_d = np.concatenate([dt_b[a], dt_a[b]])
    return float(np.percentile(all_d, 95))


def hd95_per_label(
    pred: np.ndarray, target: np.ndarray, labels: Sequence[int] = BRATS_LABELS,
    spacing=None,
) -> Dict[int, float]:
    pred = np.asarray(pred)
    target = np.asarray(target)
    if pred.shape != target.shape:
        raise ValueError(
            f"Shape mismatch: pred {pred.shape}, target {target.shape}")
    return {int(l): hd95(pred == l, target == l, spacing) for l in labels}
