"""FID (Fréchet distance) and KID (kernel MMD²) over feature embeddings.

Copy of ``mrijax/evals/frechet.py`` (numpy and ``scipy.linalg``, float64 on
the host; the JAX package's ``evals/__init__`` pulls in flax, so the port
keeps its own copy). From-scratch math matching
`evaluation_scripts/evaluate_models.py`:

* FID :195-218 — ‖μ₁−μ₂‖² + tr(Σ₁+Σ₂−2(Σ₁Σ₂)^{1/2}) with scipy
  ``linalg.sqrtm`` and the eps-offset retry when the product matrix is
  numerically singular;
* KID :221-277 — unbiased polynomial-kernel MMD² with
  k(x,y) = (xᵀy/d + 1)³, subset-sampled mean±std (torchmetrics protocol:
  ``subset_size=1000``, ``subsets=100`` by default in
  `slice_cond_2d_ddpm/metrics.py:330-335`).

Streaming accumulation (``FidAccumulator``) keeps only (Σx, Σxxᵀ, n) so
evals never hold all features — the analog of torchmetrics' ``update()``.
"""

from typing import Tuple

import numpy as np
from scipy import linalg


class FidAccumulator:
    """Streaming mean/covariance of feature batches."""

    def __init__(self, dim: int):
        self.n = 0
        self.s = np.zeros((dim,), np.float64)
        self.ss = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.s += f.sum(axis=0)
        self.ss += f.T @ f

    def stats(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            raise ValueError("need ≥2 samples for covariance")
        mu = self.s / self.n
        cov = (self.ss - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-12) -> float:
    """tr((Σ₁Σ₂)^{1/2}) is computed as Σ√λᵢ of the symmetric PSD matrix
    Σ₁^{1/2} Σ₂ Σ₁^{1/2} (same trace, but eigh-based — avoids scipy sqrtm's
    numerical failures on near-singular products that force the reference's
    eps-offset retry, evaluate_models.py:195-218)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    diff = mu1 - mu2
    w1, v1 = linalg.eigh(cov1)
    sqrt1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    inner = sqrt1 @ cov2 @ sqrt1
    w = linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = np.sqrt(np.clip(w, eps, None)).sum()
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt)


def fid_from_features(real_feats, fake_feats) -> float:
    a, b = FidAccumulator(real_feats.shape[1]), FidAccumulator(fake_feats.shape[1])
    a.update(real_feats)
    b.update(fake_feats)
    return frechet_distance(*a.stats(), *b.stats())


def _poly_kernel(x: np.ndarray, y: np.ndarray, degree=3, gamma=None, coef=1.0):
    d = x.shape[1]
    gamma = gamma if gamma is not None else 1.0 / d
    return (x @ y.T * gamma + coef) ** degree


def _mmd2_unbiased(kxx, kyy, kxy) -> float:
    m = kxx.shape[0]
    n = kyy.shape[0]
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    sum_xy = kxy.mean()
    return float(sum_xx + sum_yy - 2.0 * sum_xy)


def kid_from_features(
    real_feats,
    fake_feats,
    subset_size: int = 1000,
    num_subsets: int = 100,
    seed: int = 0,
) -> Tuple[float, float]:
    """Returns (mean, std) of unbiased MMD² over random subsets."""
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    m = min(subset_size, real.shape[0], fake.shape[0])
    if m < 2:
        raise ValueError("need ≥2 samples for KID")
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(num_subsets):
        r = real[rng.choice(real.shape[0], m, replace=False)]
        f = fake[rng.choice(fake.shape[0], m, replace=False)]
        vals.append(
            _mmd2_unbiased(_poly_kernel(r, r), _poly_kernel(f, f), _poly_kernel(r, f))
        )
    return float(np.mean(vals)), float(np.std(vals))
