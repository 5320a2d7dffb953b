"""Synthetic BraTS-like data for tests and benchmarks.

A copy of ``mrijax/data/synthetic.py`` (the port imports nothing of ``mrijax``).

The reference assumes the real BraTS 2021 archive on a cluster filesystem;
this environment has no MRI data, so tests/benches generate structurally
faithful stand-ins: per-subject directories with the four modality files
``<case>_{t1,t1ce,t2,flair}.nii.gz`` in (H, W, D) axis order, float32,
zero background outside an ellipsoidal "brain" — enough to exercise every
indexing, normalization, and padding path of the datasets.
"""

from pathlib import Path

import numpy as np

from mrijax_torch.data import nifti

MODALITIES = ("t1", "t1ce", "t2", "flair")


def make_brain_volume(
    rng: np.random.Generator, shape=(48, 48, 32), dtype=np.float32
) -> np.ndarray:
    """A smooth random 'brain': ellipsoid support, positive intensities,
    exact zeros outside (so nonzero-mask normalization is exercised)."""
    h, w, d = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, h), np.linspace(-1, 1, w), np.linspace(-1, 1, d),
        indexing="ij",
    )
    support = (zz**2 + yy**2 + xx**2) < 0.81
    base = rng.gamma(2.0, 200.0, size=shape).astype(dtype)
    # low-frequency structure
    freq = rng.uniform(1.5, 4.0, size=3)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    waves = (
        np.sin(freq[0] * np.pi * zz + phase[0])
        + np.sin(freq[1] * np.pi * yy + phase[1])
        + np.sin(freq[2] * np.pi * xx + phase[2])
    )
    vol = base * (1.2 + 0.4 * waves.astype(dtype))
    vol *= support.astype(dtype)
    return np.ascontiguousarray(vol, dtype=dtype)


def write_synthetic_brats(
    root, num_subjects: int = 3, shape=(48, 48, 32), seed: int = 0
) -> Path:
    """Create ``root/BraTS2021_NNNNN/BraTS2021_NNNNN_<mod>.nii.gz`` files."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    for i in range(num_subjects):
        case = f"BraTS2021_{i:05d}"
        case_dir = root / case
        case_dir.mkdir(parents=True, exist_ok=True)
        for mod in MODALITIES:
            vol = make_brain_volume(rng, shape)
            nifti.save(case_dir / f"{case}_{mod}.nii.gz", vol)
    return root
