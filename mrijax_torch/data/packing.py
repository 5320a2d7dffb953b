"""Offline preprocessing into packed numpy shards (+ packed dataset).

Counterpart of ``mrijax/data/packing.py``: the same shards, ``index.json``
files and samples. The slice packers normalize and resize on the card
(``use_device=True``, ``device="cuda"``); ``pack_latents`` encodes with the
port's ``VAE3D`` on the card.

The reference's offline path (`slice_cond_2d_ddpm/preprocess_data.py:10-136`)
saves one torch ``.pt`` per volume with ``{"slices": (N,1,S,S),
"z_pos": (N,)}``; its reader re-opens every file at init just to count
slices (`preprocessed_dataset.py:9-75`). Here:

* ``preprocess_volume_to_arrays`` — identical math (per-slice nonzero
  z-score → clip → bilinear resize → [-1,1]); the whole volume's slices are
  normalized and resized in one batched device call
  (``preprocess_slice_batch``) instead of a Python per-slice loop.
* ``pack_dataset`` — mirrors the source tree as ``.npz`` files and writes a
  single ``index.json`` (per-file slice counts), so dataset init is one
  JSON read instead of N file opens.
* ``PackedSliceDataset`` — map-style reader over the packed shards with an
  LRU of open arrays; yields the same sample dict as ``SliceDataset2D``.

Volume (3D) and multimodal (2.5D) packing — beyond the reference's 2D-only
offline path (SURVEY §7 step 3): at flagship batch sizes, decoding 4 NIfTI
volumes per sample per epoch on the host starves the chip, so the
decode+normalize work moves offline:

* ``pack_volumes`` / ``PackedVolumeDataset`` — per-case normalized
  (C, D, H, W) float32 volumes; the reader applies the same pad +
  per-(seed, epoch, index) crop as ``VolumeDataset3D`` (bit-identical
  samples, tested).
* ``pack_multimodal_slices`` / ``PackedMultiModalDataset25D`` — per-subject
  preprocessed slice stacks (N, S, S, 4) over the radius-0 central range
  (which exactly covers every center+context slice any radius needs); the
  reader assembles center + dz-major/modality-minor context by slicing.
"""

import json
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from mrijax_torch._device import require_device
from mrijax_torch.data import nifti
from mrijax_torch.data.datasets import (
    MODALITIES_3D,
    MODALITY_SUFFIXES_25D,
    central_slice_range,
    find_brats_cases,
    load_normalized_case,
    preprocess_slice_np,
)
from mrijax_torch.data.preprocess import crop_volume, pad_volume_to_min, preprocess_slice_batch


class _Lru:
    """Tiny keyed LRU shared by the packed readers. One dataset instance can
    back several loader views (train/val `_IndexView`s) whose prefetch
    threads overlap — e.g. a producer stuck in a slow ``np.load`` past
    BatchLoader's 5 s shutdown join — so mutation is locked. ``load_fn``
    runs outside the lock (it's the expensive part; a rare duplicate load
    is cheaper than serializing all IO)."""

    def __init__(self, load_fn, size: int):
        self._load_fn = load_fn
        self._size = size
        self._cache = OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, key):
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        val = self._load_fn(key)
        with self._lock:
            self._cache[key] = val
            if len(self._cache) > self._size:
                self._cache.popitem(last=False)
        return val


def _iter_normalized_cases(root_dir, modalities=None):
    """Yield ``(rel_path, (C, D, H, W) float32)`` for every complete BraTS
    case under ``root_dir`` (``find_brats_cases`` + ``load_normalized_case``
    — exactly the ``VolumeDataset3D`` decode, so packed samples stay
    bit-identical to direct reads)."""
    root_dir = Path(root_dir)
    cases = find_brats_cases(root_dir, modalities)
    if not cases:
        raise RuntimeError(f"no complete BraTS cases under {root_dir}")
    for case_paths in cases:
        rel = str(Path(case_paths[0]).relative_to(root_dir))
        yield rel, load_normalized_case(case_paths)


def _slices_on(raw: np.ndarray, image_size: int, device: Optional[torch.device]) -> np.ndarray:
    """(N, H, W) raw slices → (N, S, S) float32: one batched call on
    ``device``, or the per-slice numpy pipeline where ``device`` is None."""
    if device is None:
        return np.stack([preprocess_slice_np(s, image_size) for s in raw])
    x = torch.from_numpy(np.ascontiguousarray(raw)).to(device)
    return preprocess_slice_batch(x, image_size).cpu().numpy()


def _device_or_none(use_device: bool, device) -> Optional[torch.device]:
    return require_device(device) if use_device else None


def preprocess_volume_to_arrays(
    path, image_size: int = 128, *, use_device: bool = True,
    device: Union[str, torch.device] = "cuda",
):
    """One volume → (slices (N, S, S) float32 in [-1,1], z_pos (N,)); the
    slices are normalized and resized on ``device`` with ``use_device``."""
    dev = _device_or_none(use_device, device)
    vol = nifti.load(path)  # (H, W, D)
    if vol.ndim != 3:
        raise ValueError(f"expected 3D volume, got {vol.shape} for {path}")
    depth = vol.shape[-1]
    zs = np.asarray(list(central_slice_range(depth)), dtype=np.int64)
    raw = np.moveaxis(vol[:, :, zs], -1, 0)  # (N, H, W)
    slices = _slices_on(raw, image_size, dev)
    z_pos = (zs / (depth - 1)).astype(np.float32)
    return slices.astype(np.float32), z_pos


def pack_dataset(
    root_dir,
    output_dir,
    *,
    image_size: int = 128,
    modality_suffix: str = "_flair.nii.gz",
    use_device: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """Preprocess every ``*{modality_suffix}`` under ``root_dir`` into
    mirrored ``.npz`` shards + ``index.json``, the slices normalized and
    resized on ``device`` with ``use_device``. Returns the index."""
    dev = _device_or_none(use_device, device)
    root_dir, output_dir = Path(root_dir), Path(output_dir)
    paths = sorted(root_dir.rglob(f"*{modality_suffix}"))
    if not paths:
        raise RuntimeError(f"no volumes (*{modality_suffix}) under {root_dir}")
    index = {"image_size": image_size, "files": []}
    for p in paths:
        slices, z_pos = preprocess_volume_to_arrays(
            p, image_size, use_device=dev is not None, device=dev or "cpu"
        )
        rel = p.relative_to(root_dir)
        out_path = (output_dir / rel).with_suffix("").with_suffix(".npz")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, slices=slices, z_pos=z_pos)
        index["files"].append(
            {"path": str(out_path.relative_to(output_dir)), "num_slices": int(len(z_pos))}
        )
    (output_dir / "index.json").write_text(json.dumps(index, indent=1))
    return index


class PackedSliceDataset:
    """Reader over ``pack_dataset`` output; same samples as ``SliceDataset2D``."""

    def __init__(self, packed_dir, cache_size: int = 4):
        self.packed_dir = Path(packed_dir)
        index_path = self.packed_dir / "index.json"
        if index_path.exists():
            index = json.loads(index_path.read_text())
            self.image_size = index.get("image_size")
            files = [(f["path"], f["num_slices"]) for f in index["files"]]
        else:  # fall back to scanning (reference reader behavior)
            files = []
            self.image_size = None
            for p in sorted(self.packed_dir.rglob("*.npz")):
                with np.load(p) as z:
                    files.append((str(p.relative_to(self.packed_dir)), len(z["z_pos"])))
        self.files = files
        self.index_tuples = [
            (fi, si) for fi, (_, n) in enumerate(files) for si in range(n)
        ]
        self._load = _Lru(self._read, cache_size)

    def __len__(self):
        return len(self.index_tuples)

    def _read(self, file_idx: int) -> dict:
        path = self.packed_dir / self.files[file_idx][0]
        with np.load(path) as z:
            return {"slices": z["slices"], "z_pos": z["z_pos"]}

    def __getitem__(self, idx: int):
        file_idx, slice_idx = self.index_tuples[idx]
        data = self._load(file_idx)
        return {
            "image": data["slices"][slice_idx][:, :, None],
            "z_pos": np.float32(data["z_pos"][slice_idx]),
        }


# ------------------------------------------------------------- 3D volumes


def pack_volumes(root_dir, output_dir, *, modalities=None) -> dict:
    """Decode + normalize every complete BraTS case into one ``.npz`` of
    shape (C, D, H, W) float32 (the decode/normalize half of
    ``VolumeDataset3D.__getitem__``; pad/crop stay in the reader because the
    crop is per-epoch random)."""
    modalities = tuple(modalities or MODALITIES_3D)
    root_dir, output_dir = Path(root_dir), Path(output_dir)
    index = {"kind": "volumes3d", "modalities": list(modalities), "files": []}
    for rel, packed in _iter_normalized_cases(root_dir, modalities):
        out_path = (output_dir / rel).with_suffix("").with_suffix(".npz")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, volume=packed)
        index["files"].append(
            {"path": str(out_path.relative_to(output_dir)),
             "shape": list(packed.shape)}
        )
    (output_dir / "index.json").write_text(json.dumps(index, indent=1))
    return index


class PackedVolumeDataset:
    """Reader over ``pack_volumes`` output; samples bit-identical to
    ``VolumeDataset3D`` (same pad + per-(seed, epoch, index) crop)."""

    def __init__(self, packed_dir, patch_size=(128, 160, 160), *,
                 random_crop: bool = True, seed: int = 0, cache_size: int = 2):
        self.packed_dir = Path(packed_dir)
        index = json.loads((self.packed_dir / "index.json").read_text())
        if index.get("kind") != "volumes3d":
            raise ValueError(f"{packed_dir} is not a pack_volumes directory")
        self.files = [f["path"] for f in index["files"]]
        self.patch_size = tuple(patch_size)
        self.random_crop = random_crop
        self.seed = seed
        self.epoch = 0
        self._load = _Lru(self._read, cache_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return len(self.files)

    def _read(self, idx: int) -> np.ndarray:
        with np.load(self.packed_dir / self.files[idx]) as z:
            return z["volume"]

    def __getitem__(self, idx: int):
        vol = pad_volume_to_min(self._load(idx), self.patch_size)
        rng = (
            np.random.default_rng((self.seed, self.epoch, idx))
            if self.random_crop
            else None
        )
        vol = crop_volume(vol, self.patch_size, rng=rng)
        return {"volume": np.moveaxis(vol, 0, -1)}  # (D, H, W, C)


# ---------------------------------------------------------- 2.5D multimodal


def pack_multimodal_slices(
    root_dir, output_dir, *, image_size: int = 128, use_device: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """Per-subject preprocessed slice stacks (N, S, S, 4) over the radius-0
    central range — the union of every center/context slice any
    ``slice_radius`` needs (0.1·D + r − r = 0.1·D); normalized and resized
    on ``device`` with ``use_device``."""
    dev = _device_or_none(use_device, device)
    root_dir, output_dir = Path(root_dir), Path(output_dir)
    flair_suffix = "_flair.nii.gz"
    paths = sorted(root_dir.rglob(f"*{flair_suffix}"))
    if not paths:
        raise RuntimeError(f"no FLAIR volumes under {root_dir}")
    index = {"kind": "multimodal25d", "image_size": image_size, "files": []}
    for flair_path in paths:
        mod_paths = [
            Path(str(flair_path).replace(flair_suffix, sfx))
            for sfx in MODALITY_SUFFIXES_25D
        ]
        if not all(p.exists() for p in mod_paths):
            continue
        vols = [nifti.load(p) for p in mod_paths]
        depth = vols[0].shape[-1]
        zs = np.asarray(list(central_slice_range(depth)), dtype=np.int64)
        per_mod = []
        for vol in vols:
            raw = np.moveaxis(vol[:, :, zs], -1, 0)  # (N, H, W)
            per_mod.append(_slices_on(raw, image_size, dev))
        slices = np.stack(per_mod, axis=-1).astype(np.float32)  # (N, S, S, 4)
        rel = flair_path.relative_to(root_dir)
        out_path = (output_dir / rel).with_suffix("").with_suffix(".npz")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, slices=slices, zs=zs, depth=np.int64(depth))
        index["files"].append(
            {"path": str(out_path.relative_to(output_dir)),
             "depth": int(depth), "z_start": int(zs[0]), "num_slices": int(len(zs))}
        )
    if not index["files"]:
        raise RuntimeError(f"no complete multimodal subjects under {root_dir}")
    (output_dir / "index.json").write_text(json.dumps(index, indent=1))
    return index


class PackedMultiModalDataset25D:
    """Reader over ``pack_multimodal_slices``; samples bit-identical to
    ``MultiModalSliceDataset25D`` (center (S,S,4) + dz-major/modality-minor
    context (S,S,4·2r), z_pos = z/(D−1))."""

    def __init__(self, packed_dir, slice_radius: int = 2, cache_size: int = 4):
        self.packed_dir = Path(packed_dir)
        index = json.loads((self.packed_dir / "index.json").read_text())
        if index.get("kind") != "multimodal25d":
            raise ValueError(f"{packed_dir} is not a pack_multimodal_slices dir")
        self.image_size = index["image_size"]
        self.slice_radius = slice_radius
        self.files = index["files"]
        self.index_tuples = []
        for fi, f in enumerate(self.files):
            for z in central_slice_range(f["depth"], radius=slice_radius):
                self.index_tuples.append((fi, z))
        self._load = _Lru(self._read, cache_size)

    @property
    def context_channels(self) -> int:
        return 4 * 2 * self.slice_radius

    def __len__(self):
        return len(self.index_tuples)

    def _read(self, fi: int) -> dict:
        with np.load(self.packed_dir / self.files[fi]["path"]) as z:
            return {"slices": z["slices"], "z_start": int(z["zs"][0]),
                    "depth": int(z["depth"])}

    def __getitem__(self, idx: int):
        fi, z = self.index_tuples[idx]
        data = self._load(fi)
        pos = z - data["z_start"]
        r = self.slice_radius
        center = data["slices"][pos]  # (S, S, 4)
        context = np.concatenate(
            [data["slices"][pos + dz] for dz in range(-r, r + 1) if dz != 0],
            axis=-1,
        )  # (S, S, 4·2r), dz-major then modality
        z_pos = np.float32(z / (data["depth"] - 1))
        return {"image": center, "context": context, "z_pos": z_pos}


# ------------------------------------------------------------- 3D latents


def latent_source_files(src_dir) -> list:
    """Ordered relative paths of the cases ``pack_latents(src_dir, ...)``
    would encode, WITHOUT reading any volume data. Recorded in the latent
    cache's index.json so a stale cache (cases added/removed, or a different
    source dir) is detected and repacked rather than silently reused."""
    src_dir = Path(src_dir)
    idx_path = src_dir / "index.json"
    if idx_path.exists():
        index = json.loads(idx_path.read_text())
        if index.get("kind") != "volumes3d":
            raise ValueError(f"{src_dir} is not a pack_volumes directory")
        return [f["path"] for f in index["files"]]
    cases = find_brats_cases(src_dir, None)
    return [str(Path(c[0]).relative_to(src_dir)) for c in cases]


def latent_cache_is_stale(index_path, params_fp: float, src_files: list) -> bool:
    """True when the latent cache at ``index_path`` must be repacked: no
    index, a different VAE (params fingerprint), or different source data
    (case list changed — cases added/removed or another source dir)."""
    index_path = Path(index_path)
    if not index_path.exists():
        return True
    index = json.loads(index_path.read_text())
    old_fp = index.get("params_fingerprint")
    if old_fp is None or abs(old_fp - params_fp) > 1e-6 * max(1.0, abs(params_fp)):
        return True
    return index.get("source_files") != src_files


def pack_latents(
    src_dir,
    output_dir,
    vae: torch.nn.Module,
    *,
    downsample: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """Encode every full volume ONCE through the frozen VAE and store the
    latents (the stage-2 LDM then trains from latent crops —
    ``make_cached_latent_train_step``).

    The frozen encoder's output is a pure function of the data, so the
    reference's encode-per-step (`ddpm_3d_ldm/train.py:391-400`) leaves the
    training step. Volumes are padded (symmetric, the ``pad_volume_to_min``
    rule) so every spatial dim is a multiple of the VAE's total downsample
    factor, then encoded WHOLE with ``vae.encode_to_latent`` under
    ``torch.no_grad`` on ``device``, where the VAE's parameters must lie;
    training crops in latent space, so crop offsets land on a
    ``downsample``-voxel pixel grid instead of the reference's 1-voxel grid
    (the one distribution difference, documented in the index).

    ``src_dir``: a ``pack_volumes`` output dir (kind=volumes3d) or a raw
    BraTS tree. Returns the written index, the JAX package's fields.
    """
    dev = require_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    where = {p.device for p in vae.parameters()}
    if where != {dev}:
        raise ValueError(f"pack_latents runs on {dev}, the VAE's parameters lie on "
                         f"{sorted(map(str, where))}")
    src_dir, output_dir = Path(src_dir), Path(output_dir)
    if downsample is None:
        # VAE3D downsamples on the first num_down-1 levels only (matching
        # `ddpm_3d_ldm/vae.py:26-47`), so the true factor is 2**(num_down-1).
        downsample = vae.spatial_downsample

    def volumes():
        idx_path = src_dir / "index.json"
        if idx_path.exists():
            index = json.loads(idx_path.read_text())
            if index.get("kind") != "volumes3d":
                raise ValueError(f"{src_dir} is not a pack_volumes directory")
            for f in index["files"]:
                with np.load(src_dir / f["path"]) as z:
                    yield f["path"], z["volume"]  # (C, D, H, W)
        else:
            yield from _iter_normalized_cases(src_dir)

    index = {
        "kind": "latents3d",
        "downsample": int(downsample),
        "source": str(src_dir),
        "source_files": latent_source_files(src_dir),
        "params_fingerprint": params_fingerprint(vae),
        "files": [],
    }
    for rel, packed in volumes():
        tgt = [int(-(-s // downsample)) * downsample for s in packed.shape[1:]]
        padded = pad_volume_to_min(packed, tgt)  # (C, D*, H*, W*)
        x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(padded, 0, -1)[None]))
        with torch.no_grad():                     # (1, D*, H*, W*, C)
            z = vae.encode_to_latent(x.to(dev)).float()[0].cpu().numpy()  # (d, h, w, Cz)
        out_path = (output_dir / rel).with_suffix("").with_suffix(".npz")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, latent=np.moveaxis(z, -1, 0))  # (Cz, d, h, w)
        index["files"].append(
            {"path": str(out_path.relative_to(output_dir)),
             "shape": list(z.shape)}
        )
    (output_dir / "index.json").write_text(json.dumps(index, indent=1))
    return index


def params_fingerprint(params) -> float:
    """Cheap content fingerprint of a model's parameters (catches a latent
    cache built by a DIFFERENT VAE than the one training resumes with): the
    float64 Σ|w| over every parameter, as the JAX package sums its parameter
    tree, so that either package judges the other's cache fresh.
    ``params``: a module, or a mapping of name → tensor or array."""
    if isinstance(params, torch.nn.Module):
        leaves = [p.detach() for p in params.parameters()]
    else:
        leaves = list(params.values())
    return float(sum(float(torch.as_tensor(l).double().abs().sum()) for l in leaves))


class PackedLatentDataset:
    """Reader over ``pack_latents`` output: per-(seed, epoch, index) random
    (or center) crops in LATENT space; yields {"latent": (d, h, w, Cz)}."""

    def __init__(self, packed_dir, latent_patch, *, random_crop: bool = True,
                 seed: int = 0, cache_size: int = 8):
        self.packed_dir = Path(packed_dir)
        index = json.loads((self.packed_dir / "index.json").read_text())
        if index.get("kind") != "latents3d":
            raise ValueError(f"{packed_dir} is not a pack_latents directory")
        self.downsample = index["downsample"]
        self.params_fingerprint = index.get("params_fingerprint")
        self.files = [f["path"] for f in index["files"]]
        self.latent_patch = tuple(latent_patch)
        self.random_crop = random_crop
        self.seed = seed
        self.epoch = 0
        self._load = _Lru(self._read, cache_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return len(self.files)

    def _read(self, idx: int) -> np.ndarray:
        with np.load(self.packed_dir / self.files[idx]) as z:
            return z["latent"]  # (Cz, d, h, w)

    def __getitem__(self, idx: int):
        lat = pad_volume_to_min(self._load(idx), self.latent_patch)
        rng = (
            np.random.default_rng((self.seed, self.epoch, idx))
            if self.random_crop
            else None
        )
        lat = crop_volume(lat, self.latent_patch, rng=rng)
        return {"latent": np.moveaxis(lat, 0, -1)}  # (d, h, w, Cz)
