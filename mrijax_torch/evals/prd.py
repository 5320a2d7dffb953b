"""Improved precision & recall for generative models (Kynkäänniemi et al.).

Copy of ``mrijax/evals/prd.py`` (numpy, float64 on the host). Parity with
`slice_cond_2d_ddpm/metrics.py:147-229`: per-point k-NN radius (k=3) in
feature space; precision = fraction of fakes inside any real point's
radius-ball, recall = fraction of reals inside any fake ball. Distances are
chunked so the N×M matrix never fully materializes.
"""

from typing import Tuple

import numpy as np


def _knn_radii(feats: np.ndarray, k: int = 3, chunk: int = 1024) -> np.ndarray:
    """Distance to the k-th nearest neighbor (excluding self) per point."""
    n = feats.shape[0]
    if n <= k:
        raise ValueError(f"need > {k} points for k-NN radii, got {n}")
    sq = np.sum(feats**2, axis=1)
    radii = np.empty((n,), np.float64)
    for i in range(0, n, chunk):
        block = feats[i : i + chunk]
        d2 = sq[i : i + chunk, None] + sq[None, :] - 2.0 * block @ feats.T
        np.maximum(d2, 0.0, out=d2)
        # k+1 smallest includes the zero self-distance
        part = np.partition(d2, k, axis=1)[:, : k + 1]
        radii[i : i + chunk] = np.sqrt(np.sort(part, axis=1)[:, k])
    return radii


def _fraction_covered(
    queries: np.ndarray, refs: np.ndarray, ref_radii: np.ndarray, chunk: int = 1024
) -> float:
    """Fraction of query points within any ref point's radius ball."""
    sq_q = np.sum(queries**2, axis=1)
    sq_r = np.sum(refs**2, axis=1)
    radii_sq = ref_radii**2  # compare squared distances: skips a full-matrix sqrt
    covered = np.zeros((queries.shape[0],), bool)
    for i in range(0, queries.shape[0], chunk):
        block = queries[i : i + chunk]
        d2 = sq_q[i : i + chunk, None] + sq_r[None, :] - 2.0 * block @ refs.T
        np.maximum(d2, 0.0, out=d2)
        covered[i : i + chunk] = np.any(d2 <= radii_sq[None, :], axis=1)
    return float(covered.mean())


def improved_precision_recall(
    real_feats, fake_feats, k: int = 3, chunk: int = 1024
) -> Tuple[float, float]:
    """Returns (precision, recall)."""
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    real_r = _knn_radii(real, k, chunk)
    fake_r = _knn_radii(fake, k, chunk)
    precision = _fraction_covered(fake, real, real_r, chunk)
    recall = _fraction_covered(real, fake, fake_r, chunk)
    return precision, recall
