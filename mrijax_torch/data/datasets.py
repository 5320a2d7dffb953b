"""BraTS slice/volume datasets (host-side indexing + decode, numpy out).

A copy of ``mrijax/data/datasets.py``: these classes only *index and decode*
(NIfTI bytes → raw float32 numpy) and run the per-sample host transforms as
numpy, so their samples are bit for bit those of the JAX package; the
batched normalization on the device is ``mrijax_torch.data.preprocess``, and
batching, prefetch and the copy to the card live in
``mrijax_torch.data.loader``.

Parity with the reference datasets (indexing semantics verified by tests):

* ``SliceDataset2D`` ~ ``BraTSSliceDataset``
  (`slice_cond_2d_ddpm/dataset.py:10-101`): globs ``*_flair.nii.gz``
  (configurable modality suffix), indexes the central 80% of slices
  (z ∈ [0.1·D, 0.9·D)), LRU-caches 4 decoded volumes, z_pos = z/(D−1).
* ``MultiModalSliceDataset25D`` ~ `ddpm_25d_all_modalities/dataset.py:10-154`:
  anchors on FLAIR, loads modalities [t1, t1ce, t2, flair] by suffix
  replacement, z-range shrunk by ``slice_radius``; context channels ordered
  dz-major then modality, excluding dz=0.
* ``VolumeDataset3D`` ~ `ddpm_3d_ldm/dataset.py:108-193`: subjects with all
  4 modalities [flair, t1, t1ce, t2], per-modality volume normalization,
  (H, W, D) → (D, H, W) reorder, symmetric pad to ≥ patch, random/center
  crop.

Outputs are channels-LAST ((H, W, C) / (D, H, W, C)), the layout the port's
models take, where the reference is channels-first.
"""

from collections import OrderedDict
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from mrijax_torch.data import cnifti, nifti
from mrijax_torch.data.preprocess import (
    crop_volume,
    pad_volume_to_min,
)


def _zscore_nonzero_np(x: np.ndarray, eps: Optional[float] = 1e-6) -> np.ndarray:
    """Numpy twin of ``preprocess.zscore_nonzero`` for host-side per-sample
    transforms: z-score over the brain mask (nonzero voxels), clip to ±5σ,
    rescale to [-1, 1]. ``eps=None`` selects the 2D/2.5D degenerate-std
    branch (replace only ``std == 0``, `slice_cond_2d_ddpm/dataset.py:78`);
    the default mirrors the 3D path's ``std < eps``
    (`ddpm_3d_ldm/dataset.py:23-24`). An all-zero sample degenerates to the
    plain z-score over everything, which maps zeros to zeros — so the
    statistics can simply be taken over the full array in that case."""
    x = x.astype(np.float32).copy()
    sel = x != 0
    if not sel.any():
        sel = np.ones_like(sel)
    vals = x[sel]
    std = vals.std()
    degenerate = (std == 0.0) if eps is None else (std < eps)
    x[sel] = (vals - vals.mean()) / (1.0 if degenerate else std)
    np.clip(x, -5.0, 5.0, out=x)
    return x / 5.0


def _resize_bilinear_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Separable bilinear resize, half-pixel convention (align_corners=False),
    matching ``F.interpolate(mode="bilinear")``. img: (H, W) → out_hw."""
    out = img.astype(np.float32)
    for axis, target in ((0, out_hw[0]), (1, out_hw[1])):
        size = out.shape[axis]
        if size == target:
            continue
        scale = size / target
        coords = (np.arange(target, dtype=np.float64) + 0.5) * scale - 0.5
        coords = np.clip(coords, 0, size - 1)
        lo = np.floor(coords).astype(np.int64)
        hi = np.minimum(lo + 1, size - 1)
        w_hi = (coords - lo).astype(np.float32)
        out = np.moveaxis(out, axis, 0)
        out = out[lo] * (1.0 - w_hi)[:, None] + out[hi] * w_hi[:, None]
        out = np.moveaxis(out, 0, axis)
    return out


def preprocess_slice_np(sl: np.ndarray, image_size: int) -> np.ndarray:
    """Full reference slice pipeline on host: masked z-score → clip → resize.
    The resize runs on the [0,1]-equivalent linear scale; since bilinear
    weights sum to 1, doing it after the affine map is exact."""
    z = _zscore_nonzero_np(sl, eps=None)  # 2D branch: replace only std == 0
    return _resize_bilinear_np(z, (image_size, image_size))


def load_volume(path) -> np.ndarray:
    """Decode a NIfTI volume with the native C++ reader
    (``mrijax_torch.data.cnifti``, built at first use; ``nifti.load`` is its
    plain version, bit-identical)."""
    return cnifti.load(path)


class _VolumeLRU:
    """LRU cache of decoded volumes (reference caches 4,
    `slice_cond_2d_ddpm/dataset.py:43-62`)."""

    def __init__(self, capacity: int = 4):
        self.capacity = capacity
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()

    def get(self, path: str) -> np.ndarray:
        key = str(path)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        vol = load_volume(key)
        self._cache[key] = vol
        if len(self._cache) > self.capacity:
            self._cache.popitem(last=False)
        return vol


MODALITY_SUFFIXES_25D = ("_t1.nii.gz", "_t1ce.nii.gz", "_t2.nii.gz", "_flair.nii.gz")
MODALITIES_3D = ("flair", "t1", "t1ce", "t2")


def central_slice_range(depth: int, margin_frac: float = 0.1, radius: int = 0):
    """[0.1·D + r, 0.9·D − r) — the reference's central-80% slice window
    (`slice_cond_2d_ddpm/dataset.py:28-38`; radius shrink
    `ddpm_25d_all_modalities/dataset.py:48-51`)."""
    z_start = int(margin_frac * depth) + radius
    z_end = int((1.0 - margin_frac) * depth) - radius
    return range(z_start, z_end)


class SliceDataset2D:
    """(slice (H, W, 1) in [-1,1], z_pos ∈ [0,1]) samples from one modality."""

    def __init__(
        self,
        root_dir,
        image_size: int = 128,
        modality_suffix: str = "_flair.nii.gz",
        cache_size: int = 4,
    ):
        self.root_dir = Path(root_dir)
        self.image_size = image_size
        self.modality_suffix = modality_suffix
        self.volume_paths = sorted(self.root_dir.rglob(f"*{modality_suffix}"))
        if not self.volume_paths:
            raise RuntimeError(
                f"no volumes (*{modality_suffix}) under {root_dir}"
            )
        self.slice_tuples = []
        for p in self.volume_paths:
            shape = nifti.load_header(p).shape
            if len(shape) != 3:
                continue
            depth = shape[2]
            for z in central_slice_range(depth):
                self.slice_tuples.append((p, z))
        self._lru = _VolumeLRU(cache_size)

    def __len__(self):
        return len(self.slice_tuples)

    def __getitem__(self, idx: int):
        path, z = self.slice_tuples[idx]
        vol = self._lru.get(path)
        sl = preprocess_slice_np(vol[:, :, z], self.image_size)
        z_pos = np.float32(z / (vol.shape[-1] - 1))
        return {"image": sl[:, :, None], "z_pos": z_pos}


class MultiModalSliceDataset25D:
    """Center slice of all 4 modalities + 4·2·radius context channels."""

    def __init__(
        self,
        root_dir,
        image_size: int = 128,
        slice_radius: int = 2,
        cache_size: int = 16,
    ):
        self.root_dir = Path(root_dir)
        self.image_size = image_size
        self.slice_radius = slice_radius
        self.flair_suffix = "_flair.nii.gz"
        self.modalities = list(MODALITY_SUFFIXES_25D)
        self.volume_paths = sorted(self.root_dir.rglob(f"*{self.flair_suffix}"))
        if not self.volume_paths:
            raise RuntimeError(f"no FLAIR volumes under {root_dir}")
        self.slice_tuples = []
        for p in self.volume_paths:
            shape = nifti.load_header(p).shape
            if len(shape) != 3:
                continue
            depth = shape[2]
            for z in central_slice_range(depth, radius=slice_radius):
                self.slice_tuples.append((p, z))
        # 4 modalities × LRU 4 subjects
        self._lru = _VolumeLRU(cache_size)

    def __len__(self):
        return len(self.slice_tuples)

    @property
    def context_channels(self) -> int:
        return len(self.modalities) * 2 * self.slice_radius

    def _modality_paths(self, flair_path) -> list:
        return [
            str(flair_path).replace(self.flair_suffix, sfx)
            for sfx in self.modalities
        ]

    def __getitem__(self, idx: int):
        flair_path, z = self.slice_tuples[idx]
        vols = [self._lru.get(p) for p in self._modality_paths(flair_path)]
        depth = vols[0].shape[-1]

        center = np.stack(
            [preprocess_slice_np(v[:, :, z], self.image_size) for v in vols],
            axis=-1,
        )  # (S, S, 4)

        context = []  # dz-major, modality-minor (dataset.py:141-150)
        for dz in range(-self.slice_radius, self.slice_radius + 1):
            if dz == 0:
                continue
            for v in vols:
                context.append(preprocess_slice_np(v[:, :, z + dz], self.image_size))
        context = np.stack(context, axis=-1)  # (S, S, 4·2r)

        z_pos = np.float32(z / (depth - 1))
        return {"image": center, "context": context, "z_pos": z_pos}


def find_brats_cases(root_dir, modalities=None):
    """Complete BraTS cases under ``root_dir``: tuples of per-modality NIfTI
    paths, anchored on `*_flair.nii.gz` with string-replace for the siblings
    (reference case discovery, `ddpm_3d_ldm/dataset.py:140-155`)."""
    from pathlib import Path as _Path

    modalities = tuple(modalities or MODALITIES_3D)
    cases = []
    for flair_path in sorted(_Path(root_dir).rglob("*_flair.nii.gz")):
        base = str(flair_path).replace("_flair.nii.gz", "")
        paths = {m: _Path(base + f"_{m}.nii.gz") for m in modalities}
        paths["flair"] = _Path(flair_path)
        if all(p.exists() for p in paths.values()):
            cases.append(tuple(paths[m] for m in modalities))
    return cases


def load_normalized_case(case_paths) -> np.ndarray:
    """Decode one case's modalities → (C, D, H, W) float32: squeeze a 4th
    NIfTI dim, (H,W,D)→(D,H,W), per-modality nonzero z-score — the shared
    decode half of ``VolumeDataset3D.__getitem__`` (pad/crop stay with the
    reader because the crop is per-epoch random)."""
    chans = []
    for p in case_paths:
        vol = load_volume(p)
        if vol.ndim == 4:
            vol = vol[..., 0]
        chans.append(_zscore_nonzero_np(np.transpose(vol, (2, 0, 1))))
    return np.stack(chans, axis=0)


class VolumeDataset3D:
    """(D, H, W, 4) normalized patches; random (train) or center (val) crop."""

    def __init__(
        self,
        root_dir,
        patch_size: Tuple[int, int, int] = (128, 160, 160),
        random_crop: bool = True,
        modalities: Sequence[str] = MODALITIES_3D,
        seed: int = 0,
    ):
        self.root_dir = Path(root_dir)
        self.patch_size = tuple(patch_size)
        self.random_crop = random_crop
        self.modalities = tuple(modalities)
        self.seed = seed
        self.epoch = 0
        self.cases = find_brats_cases(self.root_dir, self.modalities)
        if not self.cases:
            raise ValueError(f"no complete BraTS cases under {root_dir}")

    def set_epoch(self, epoch: int) -> None:
        """Crops are seeded per (seed, epoch, index): reproducible across
        resume, and identical for a given global sample on every process
        (multi-host workers each decode a different subset of rows, so a
        shared mutable stream would desynchronize from sample identity)."""
        self.epoch = epoch

    def __len__(self):
        return len(self.cases)

    def __getitem__(self, idx: int):
        vol = load_normalized_case(self.cases[idx])  # (4, D, H, W)
        vol = pad_volume_to_min(vol, self.patch_size)
        rng = (
            np.random.default_rng((self.seed, self.epoch, idx))
            if self.random_crop
            else None
        )
        vol = crop_volume(vol, self.patch_size, rng=rng)
        return {"volume": np.moveaxis(vol, 0, -1)}  # (D, H, W, 4)
