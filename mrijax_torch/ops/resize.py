"""Spatial resize, crop and pad helpers (channels-last).

Counterpart of ``mrijax/ops/resize.py``. ``resize_bilinear`` is
``torch.nn.functional.interpolate(mode="bilinear"/"trilinear",
align_corners=False)`` — the half-pixel convention of the reference data
pipeline and of the 2D UNet's up-path shape fix-up — without antialiasing,
which is what the JAX package asks of ``jax.image.resize`` (``antialias=False``)
when it downsamples too. ``center_crop_to`` is the 3D UNet's skip-connection
center crop on shape mismatch; ``pad_to_min_spatial`` the 3D data pipeline's
symmetric zero pad.
"""

import torch
import torch.nn.functional as F

_MODES = {4: "bilinear", 5: "trilinear"}


def resize_bilinear(x: torch.Tensor, out_spatial) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) [or (B, D, H, W, C) trilinear] to
    ``out_spatial`` (a tuple with one size per spatial dim), in ``x``'s dtype.

    The interpolation runs on the channels-first *view* of the buffer (a
    channels-last tensor), so neither the input nor the output is copied to
    another layout.
    """
    n = x.dim()
    if n not in _MODES or len(out_spatial) != n - 2:
        raise ValueError(f"resize_bilinear: input {tuple(x.shape)}, target {tuple(out_spatial)}")
    y = F.interpolate(x.permute(0, n - 1, *range(1, n - 1)), size=tuple(out_spatial),
                      mode=_MODES[n], align_corners=False, antialias=False)
    return y.permute(0, *range(2, n), 1).contiguous()


def center_crop_to(x: torch.Tensor, target_spatial) -> torch.Tensor:
    """Center-crop the spatial dims of (B, *spatial, C) to ``target_spatial``.

    Offsets use floor((cur - target) / 2). Returns a view when it crops.
    """
    spatial = tuple(x.shape[1:-1])
    if spatial == tuple(target_spatial):
        return x
    slices = [slice(None)]
    for cur, tgt in zip(spatial, target_spatial):
        if tgt > cur:
            raise ValueError(
                f"center_crop_to: target {tuple(target_spatial)} exceeds "
                f"current spatial {spatial} — pad first (pad_to_min_spatial)"
            )
        off = (cur - tgt) // 2
        slices.append(slice(off, off + tgt))
    slices.append(slice(None))
    return x[tuple(slices)]


def pad_to_min_spatial(x: torch.Tensor, min_spatial) -> torch.Tensor:
    """Symmetric zero-pad of the spatial dims of (B, *spatial, C) up to
    ``min_spatial`` (before-pad = total // 2); dims already as large stay."""
    widths = []
    for cur, tgt in zip(x.shape[1:-1], min_spatial):
        p = max(tgt - cur, 0)
        widths.append((p // 2, p - p // 2))
    # F.pad takes (before, after) from the last dim backwards: channels first
    return F.pad(x, [0, 0] + [w for pair in reversed(widths) for w in pair])
