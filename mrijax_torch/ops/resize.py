"""Spatial crop helper (channels-last).

Counterpart of ``mrijax/ops/resize.py::center_crop_to``: the 3D UNet's
skip-connection center crop on shape mismatch.
"""

import torch


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
                f"current spatial {spatial} — pad first"
            )
        off = (cur - tgt) // 2
        slices.append(slice(off, off + tgt))
    slices.append(slice(None))
    return x[tuple(slices)]
