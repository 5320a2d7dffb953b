"""Memorization statistics: nearest-real cosine similarity of generations.

Copy of ``mrijax/evals/memorization.py`` (numpy, float64 on the host).
Parity with `evaluation_scripts/evaluate_models.py:374-469`: each fake's max
cosine similarity against a pool of (≤2000) real samples, computed in
chunks; reported as mean / p95 / p99 / max plus the full per-fake vector.
Works on raw pixels (flattened, as the reference does) or on features.
"""

from typing import Dict

import numpy as np


def max_cosine_similarity(
    fakes: np.ndarray, real_pool: np.ndarray, chunk: int = 256
) -> np.ndarray:
    """(N, ...) fakes vs (M, ...) reals → (N,) max cosine sim per fake."""
    f = np.asarray(fakes, np.float64).reshape(fakes.shape[0], -1)
    r = np.asarray(real_pool, np.float64).reshape(real_pool.shape[0], -1)
    f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    r = r / np.maximum(np.linalg.norm(r, axis=1, keepdims=True), 1e-12)
    best = np.full((f.shape[0],), -np.inf)
    for i in range(0, f.shape[0], chunk):
        sims = f[i : i + chunk] @ r.T  # (chunk, M)
        best[i : i + chunk] = sims.max(axis=1)
    return best


def memorization_stats(
    fakes: np.ndarray, real_pool: np.ndarray, chunk: int = 256
) -> Dict[str, object]:
    sims = max_cosine_similarity(fakes, real_pool, chunk)
    return {
        "mean": float(sims.mean()),
        "p95": float(np.percentile(sims, 95)),
        "p99": float(np.percentile(sims, 99)),
        "max": float(sims.max()),
        # full per-fake vector (reference layout's all_max_cosine,
        # evaluate_models.py:468) for distribution-level analyses
        "all_max_cosine": [float(v) for v in sims],
    }
