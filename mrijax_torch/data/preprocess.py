"""Preprocessing: normalization, resize, crop, pad.

Counterpart of ``mrijax/data/preprocess.py``. The normalization and resize
run in PyTorch on the device of the tensor they are given: the packers hand
them a whole volume's slices on the card (``preprocess_slice_batch``) and
bring the result back once. Crop and pad are the 3D data pipeline's
per-sample host transforms: on a numpy array they are the JAX package's
numpy code (bit-identical), on a tensor the same arithmetic in PyTorch.

Math (the reference formulas, as in the JAX package):

* ``zscore_nonzero``: z-score over the nonzero mask (fallback: all elements
  when the mask is empty) → clip to ±5 → map [-5, 5] → [-1, 1]. The 2D
  pipeline does this per slice; the 3D pipeline per volume.
  Reference: `slice_cond_2d_ddpm/dataset.py:73-83` (slice),
  `ddpm_3d_ldm/dataset.py:11-41` (volume, incl. empty-mask fallback).
* ``preprocess_slice``: normalize → bilinear resize (align_corners=False
  half-pixel convention) to ``image_size``² — `dataset.py:86-95`.
* 3D: symmetric zero-pad to ≥ patch (`_pad_to_min_shape`,
  `ddpm_3d_ldm/dataset.py:44-75`) then random (train) / center (val) crop
  (`_random_or_center_crop`, :78-105).

The nonzero mask is data-dependent; it is applied with ``torch.where`` masked
sums, so a batch of slices keeps one static shape.
"""

from typing import Optional

import numpy as np
import torch

from mrijax_torch.ops.resize import resize_bilinear


def _tensor(x) -> torch.Tensor:
    """A float32 tensor of ``x`` on its own device (numpy → CPU)."""
    return torch.as_tensor(x).float()


def zscore_nonzero(x, axes=None, eps: Optional[float] = 1e-6) -> torch.Tensor:
    """Z-score the nonzero elements (zeros stay zero), clip ±5, rescale to
    [-1, 1], in float32 on ``x``'s device.

    The two families differ in one branch, as in the reference:
    * statistics over the nonzero mask; only masked values are z-scored —
      background voxels remain 0, which maps to 0 after [-5,5] → [-1,1];
    * degenerate-std handling: the 3D path replaces ``std < eps`` with 1.0
      (`ddpm_3d_ldm/dataset.py:11-41`); the 2D/2.5D path replaces only
      ``std == 0`` (`slice_cond_2d_ddpm/dataset.py:78`) — pass ``eps=None``
      for that branch;
    * with an empty mask, *all* elements are z-scored.

    ``axes``: reduction axes (None = all).
    """
    xf = _tensor(x)
    if axes is None:
        axes = tuple(range(xf.dim()))
    axes = tuple(axes)
    mask = (xf != 0).float()
    count = mask.sum(dim=axes, keepdim=True)
    has_nonzero = count > 0

    def fix_std(s):
        if eps is None:  # 2D/2.5D branch: replace only an exactly-zero std
            return torch.where(s > 0.0, s, torch.ones_like(s))
        return torch.where(s < eps, torch.ones_like(s), s)

    denom = torch.clamp(count, min=1.0)
    mean_m = (xf * mask).sum(dim=axes, keepdim=True) / denom
    var_m = (torch.square(xf - mean_m) * mask).sum(dim=axes, keepdim=True) / denom
    std_m = fix_std(torch.sqrt(var_m))

    mean_a = xf.mean(dim=axes, keepdim=True)
    std_a = fix_std(xf.std(dim=axes, keepdim=True, correction=0))

    z_masked = torch.where(mask > 0, (xf - mean_m) / std_m, torch.zeros_like(xf))
    z_all = (xf - mean_a) / std_a
    z = torch.where(has_nonzero, z_masked, z_all)
    z = torch.clamp(z, -5.0, 5.0)
    # [-5, 5] → [0, 1] → [-1, 1] collapses to z/5 (dataset.py:79-83).
    return z / 5.0


def preprocess_slice(sl, image_size: int = 128) -> torch.Tensor:
    """Raw (H, W) slice → normalized, resized (image_size, image_size) in
    [-1, 1] (`slice_cond_2d_ddpm/dataset.py:73-95`)."""
    return preprocess_slice_batch(_tensor(sl)[None], image_size)[0]


def preprocess_slice_batch(slices, image_size: int = 128) -> torch.Tensor:
    """(N, H, W) raw slices → (N, S, S) with per-slice statistics, in one
    batched pass on ``slices``' device."""
    z = zscore_nonzero(slices, axes=(1, 2), eps=None)  # 2D branch: std == 0 only
    out = resize_bilinear(z[..., None], (image_size, image_size))  # (N, S, S, 1)
    return out[..., 0]


def normalize_volume(vol) -> torch.Tensor:
    """Per-volume nonzero z-score → [-1, 1], statistics over the whole array
    (`ddpm_3d_ldm/dataset.py:11-41`)."""
    return zscore_nonzero(vol)


def _pad_widths(shape, min_shape):
    nd = len(min_shape)
    pads = [(0, 0)] * (len(shape) - nd)
    for cur, tgt in zip(shape[-nd:], min_shape):
        p = max(tgt - cur, 0)
        pads.append((p // 2, p - p // 2))
    return pads


def pad_volume_to_min(vol, min_shape):
    """Symmetric zero-pad trailing spatial dims up to ``min_shape``
    (before = total // 2) — `ddpm_3d_ldm/dataset.py:44-75`. A tensor is
    padded in PyTorch on its device; anything else as the numpy array the
    JAX package pads."""
    if isinstance(vol, torch.Tensor):
        pads = _pad_widths(tuple(vol.shape), min_shape)
        if all(p == (0, 0) for p in pads):
            return vol
        return torch.nn.functional.pad(vol, [w for pair in reversed(pads) for w in pair])
    vol = np.asarray(vol)
    pads = _pad_widths(vol.shape, min_shape)
    if any(p != (0, 0) for p in pads):
        vol = np.pad(vol, pads)
    return vol


def crop_volume(vol, patch_shape, *, rng=None):
    """Random (``rng``, a numpy Generator, given) or center crop of trailing
    spatial dims to ``patch_shape`` — `ddpm_3d_ldm/dataset.py:78-105`. A
    tensor gives a view of itself; anything else a view of its numpy array."""
    if not isinstance(vol, torch.Tensor):
        vol = np.asarray(vol)
    nd = len(patch_shape)
    lead = vol.ndim - nd
    starts = []
    for cur, tgt in zip(vol.shape[lead:], patch_shape):
        extra = cur - tgt
        if extra < 0:
            raise ValueError(f"volume dim {cur} < patch dim {tgt}; pad first")
        if rng is not None:
            starts.append(int(rng.integers(0, extra + 1)))
        else:
            starts.append(extra // 2)
    slices = [slice(None)] * lead + [
        slice(s, s + t) for s, t in zip(starts, patch_shape)
    ]
    return vol[tuple(slices)]
