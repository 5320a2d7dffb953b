"""PNG grid/slice writers for generated samples.

Counterpart of ``mrijax/io/images.py``, copied (numpy and PIL only; the JAX
package's ``io`` package imports its checkpoint module, so it is not
imported). Replaces the reference's ``torchvision.utils.save_image`` grids
and matplotlib mid-slice panels with PIL-backed writers.

Conventions: inputs are channels-last float arrays in [-1, 1] (model space)
unless ``value_range`` says otherwise — a tensor is read through
``np.asarray``, so pass it on the CPU (``.cpu()``); percentile windowing
mirrors the reference's display normalization for MRI volumes.
"""

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np


def to_uint8(
    img: np.ndarray,
    value_range: Tuple[float, float] = (-1.0, 1.0),
) -> np.ndarray:
    lo, hi = value_range
    x = (np.asarray(img, np.float32) - lo) / max(hi - lo, 1e-8)
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def percentile_window(img: np.ndarray, p_lo: float = 1.0, p_hi: float = 99.0) -> np.ndarray:
    """Windowed display normalization (`ddpm_3d_ldm/show_model.py:118-126`)."""
    lo, hi = np.percentile(img, [p_lo, p_hi])
    if hi <= lo:
        hi = lo + 1e-6
    return np.clip((img - lo) / (hi - lo), 0.0, 1.0)


def make_grid(
    images: np.ndarray,
    nrow: int = 8,
    padding: int = 2,
    value_range: Tuple[float, float] = (-1.0, 1.0),
) -> np.ndarray:
    """(N, H, W) or (N, H, W, 1) float → uint8 grid image (rows × cols)."""
    imgs = np.asarray(images)
    if imgs.ndim == 4 and imgs.shape[-1] == 1:
        imgs = imgs[..., 0]
    n, h, w = imgs.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding),
        dtype=np.uint8,
    )
    u8 = to_uint8(imgs, value_range)
    for i in range(n):
        r, c = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = c * (w + padding) + padding
        grid[y : y + h, x : x + w] = u8[i]
    return grid


def save_png(path, img: np.ndarray) -> None:
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    Image.fromarray(arr).save(path)


def save_grid_png(path, images: np.ndarray, nrow: int = 8,
                  value_range: Tuple[float, float] = (-1.0, 1.0)) -> None:
    save_png(path, make_grid(images, nrow=nrow, value_range=value_range))


def volume_midslice_panel(
    volume: np.ndarray,
    modality_names: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """(D, H, W, C) volume → uint8 panel of axial/coronal/sagittal mid-slices
    per modality (the reference's 4×3 diagnostic grid,
    `ddpm_3d_ldm/show_model.py:106-168`), percentile-windowed."""
    vol = np.asarray(volume, np.float32)
    d, h, w, c = vol.shape
    views = []
    for ch in range(c):
        v = vol[..., ch]
        axial = v[d // 2]                      # (H, W)
        coronal = v[:, h // 2]                 # (D, W)
        sagittal = v[:, :, w // 2]             # (D, H)
        row = []
        target = (max(h, d), max(w, h))
        for sl in (axial, coronal, sagittal):
            img = percentile_window(sl)
            pad_y = target[0] - img.shape[0]
            pad_x = target[1] - img.shape[1]
            img = np.pad(img, ((0, pad_y), (0, pad_x)))
            row.append(img)
        views.append(np.concatenate(row, axis=1))
    panel = np.concatenate(views, axis=0)
    return (panel * 255.0 + 0.5).astype(np.uint8)
