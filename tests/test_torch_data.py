"""The port's data package (``mrijax_torch.data``) against ``mrijax.data`` on
the CPU, at the JAX data tests' size (3 synthetic subjects of 32×32×20).

What numpy computes in both packages (NIfTI decode, the datasets' samples,
the packed shards and readers, crop and pad, the loaders' index order, the
splits) is held bitwise. What runs in PyTorch where the JAX package runs XLA
(``preprocess_slice_batch`` and the other normalizations) is held to 1e-5
absolute: float32 sums in another order. ``pack_latents`` of the same VAE,
converted from flax parameters, is held to 1e-4 absolute (two float32
convolution stacks), and the fingerprints in the two caches' ``index.json``
to the 1e-6 relative bar of ``latent_cache_is_stale``.
"""

import gzip
import json
import struct
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrijax import data as jdata
from mrijax.data import loader as jloader
from mrijax.data import nifti as jnifti
from mrijax.data import packing as jpacking
from mrijax.data import split as jsplit
from mrijax.data import synthetic as jsynthetic
from mrijax.models import VAE3D as JVAE3D
from mrijax_torch import data
from mrijax_torch.data import cnifti, nifti, packing, preprocess, split, synthetic
from mrijax_torch.io import vae3d_state_dict_from_flax
from mrijax_torch.models import VAE3D

PREPROCESS_ATOL = 1e-5
LATENT_ATOL = 1e-4
FINGERPRINT_RTOL = 1e-6


@pytest.fixture(scope="module")
def brats_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    synthetic.write_synthetic_brats(root, num_subjects=3, shape=(32, 32, 20), seed=0)
    return root


def nii_paths(root):
    return sorted(root.rglob("*.nii.gz"))


def assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def assert_datasets_equal(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        assert_samples_equal(got[i], want[i])


# ------------------------------------------------------------------ NIfTI


def test_synthetic_tree_is_the_jax_packages(tmp_path, brats_root):
    other = jsynthetic.write_synthetic_brats(tmp_path / "j", 3, (32, 32, 20), seed=0)
    mine, theirs = nii_paths(brats_root), nii_paths(other)
    assert [p.relative_to(brats_root) for p in mine] == [p.relative_to(other) for p in theirs]
    for a, b in zip(mine, theirs):
        assert gzip.decompress(a.read_bytes()) == gzip.decompress(b.read_bytes())


def test_nifti_round_trip_and_both_readers(tmp_path, brats_root):
    rng = np.random.default_rng(0)
    for dtype, suffix in ((np.float32, ".nii.gz"), (np.int16, ".nii"), (np.uint8, ".nii.gz")):
        vol = (rng.uniform(0, 100, size=(7, 5, 3))).astype(dtype)
        p = tmp_path / f"v_{np.dtype(dtype).name}{suffix}"
        nifti.save(p, vol)
        np.testing.assert_array_equal(nifti.load(p), vol.astype(np.float32))
        np.testing.assert_array_equal(jnifti.load(p), nifti.load(p))
        np.testing.assert_array_equal(cnifti.load(p), nifti.load(p))
        assert nifti.load_header(p).shape == (7, 5, 3)
    for p in nii_paths(brats_root):
        want = jnifti.load(p)
        np.testing.assert_array_equal(nifti.load(p), want)
        got = cnifti.load(p)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert cnifti.probe(p)[0] == jnifti.load_header(p).shape
    paths = nii_paths(brats_root)[:4]
    for got, p in zip(cnifti.load_batch(paths, num_threads=2), paths):
        np.testing.assert_array_equal(got, jnifti.load(p))
    with pytest.raises(IOError):
        cnifti.load(str(paths[0]) + ".missing")


def test_cnifti_rejects_corrupt_headers(tmp_path, brats_root):
    """The corruptions of ``tests/test_data.py``'s native-reader test: each
    comes back as an ``IOError`` from the port's build of the reader."""
    src = nii_paths(brats_root)[0]
    base = bytearray(gzip.decompress(src.read_bytes()))

    def corrupt(name, mutate):
        buf = bytearray(base)
        mutate(buf)
        p = tmp_path / f"{name}.nii"
        p.write_bytes(bytes(buf))
        with pytest.raises(IOError):
            cnifti.load(p)

    corrupt("magic", lambda b: struct.pack_into("<2s", b, 344, b"xx"))
    corrupt("negdim", lambda b: struct.pack_into("<h", b, 42, -5))
    corrupt("overflow", lambda b: struct.pack_into("<8h", b, 40, 7, *([32767] * 7)))
    corrupt("bitpix", lambda b: (
        struct.pack_into("<h", b, 72, 8),
        b.__setitem__(slice(352, len(b)), b[352:352 + (len(b) - 352) // 4]),
    ))
    corrupt("voxoff", lambda b: struct.pack_into("<f", b, 108, 1e12))
    corrupt("dtype", lambda b: struct.pack_into("<h", b, 70, 128))
    gz = gzip.compress(bytes(base))
    p = tmp_path / "trunc.nii.gz"
    p.write_bytes(gz[: len(gz) // 2])
    with pytest.raises(IOError):
        cnifti.load(p)


def test_cnifti_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails leaves no library and raises; nothing falls back
    to the numpy reader."""
    monkeypatch.setattr(cnifti, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cnifti, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="build failed"):
        cnifti.build()
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(RuntimeError, match="build failed"):
        data.datasets.load_volume(tmp_path / "any.nii.gz")


# ---------------------------------------------------------------- datasets


def test_slice_datasets_bitwise(brats_root):
    assert_datasets_equal(data.SliceDataset2D(brats_root, image_size=16),
                          jdata.SliceDataset2D(brats_root, image_size=16))
    assert_datasets_equal(data.SliceDataset2D(brats_root, image_size=24,
                                              modality_suffix="_t2.nii.gz"),
                          jdata.SliceDataset2D(brats_root, image_size=24,
                                               modality_suffix="_t2.nii.gz"))
    for radius in (1, 2):
        got = data.MultiModalSliceDataset25D(brats_root, image_size=16, slice_radius=radius)
        want = jdata.MultiModalSliceDataset25D(brats_root, image_size=16, slice_radius=radius)
        assert got.context_channels == want.context_channels
        assert_datasets_equal(got, want)


@pytest.mark.parametrize("patch", [(16, 16, 16), (24, 40, 40)], ids=["crop", "pad"])
def test_volume_dataset_bitwise(brats_root, patch):
    for random_crop in (True, False):
        got = data.VolumeDataset3D(brats_root, patch, random_crop=random_crop, seed=3)
        want = jdata.VolumeDataset3D(brats_root, patch, random_crop=random_crop, seed=3)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert_datasets_equal(got, want)
    assert [tuple(map(str, c)) for c in data.datasets.find_brats_cases(brats_root)] == [
        tuple(map(str, c)) for c in jdata.datasets.find_brats_cases(brats_root)]
    assert list(data.central_slice_range(155, radius=2)) == list(
        jdata.central_slice_range(155, radius=2))


# ------------------------------------------------------------ preprocessing


def test_preprocess_slice_batch_matches_jax(brats_root):
    vol = nifti.load(nii_paths(brats_root)[0])
    raw = np.moveaxis(vol, -1, 0).copy()            # every slice, the empty ones too
    raw[3] = 0.0                                     # an all-zero slice: the fallback branch
    raw[4] = 7.0                                     # a constant slice: std == 0
    for size in (16, 48):
        want = np.asarray(jdata.preprocess_slice_batch(jnp.asarray(raw), size))
        got = preprocess.preprocess_slice_batch(torch.from_numpy(raw), size)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=PREPROCESS_ATOL, rtol=0)
        one = preprocess.preprocess_slice(raw[5], size)
        np.testing.assert_allclose(one.numpy(), np.asarray(jdata.preprocess_slice(
            jnp.asarray(raw[5]), size)), atol=PREPROCESS_ATOL, rtol=0)
    # a numpy array is taken as it is, on the CPU
    np.testing.assert_array_equal(preprocess.preprocess_slice_batch(raw, 16).numpy(),
                                  preprocess.preprocess_slice_batch(torch.from_numpy(raw),
                                                                    16).numpy())


def test_normalizations_match_jax():
    rng = np.random.default_rng(2)
    vol = rng.gamma(2.0, 100.0, size=(6, 10, 12)).astype(np.float32)
    vol[:, :2] = 0.0
    cases = [(vol, None, 1e-6), (vol, (1, 2), None), (np.zeros((4, 5), np.float32), None, 1e-6),
             (np.full((4, 5), 3.0, np.float32), None, 1e-6),
             (np.full((4, 5), 3.0, np.float32), None, None)]
    for x, axes, eps in cases:
        want = np.asarray(jdata.zscore_nonzero(jnp.asarray(x), axes=axes, eps=eps))
        got = preprocess.zscore_nonzero(torch.from_numpy(x), axes=axes, eps=eps)
        np.testing.assert_allclose(got.numpy(), want, atol=PREPROCESS_ATOL, rtol=0)
    np.testing.assert_allclose(preprocess.normalize_volume(vol).numpy(),
                               np.asarray(jdata.normalize_volume(jnp.asarray(vol))),
                               atol=PREPROCESS_ATOL, rtol=0)


def test_pad_and_crop_bitwise_on_numpy_and_equal_on_tensors():
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(2, 7, 9, 4)).astype(np.float32)
    for target in ((10, 9, 7), (7, 12, 5), (7, 9, 4)):
        want = jdata.pad_volume_to_min(vol, target)
        got = preprocess.pad_volume_to_min(vol, target)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            preprocess.pad_volume_to_min(torch.from_numpy(vol), target).numpy(), want)
    for patch in ((5, 9, 2), (7, 3, 4)):
        for seed in (None, 0, 1):
            want = jdata.crop_volume(vol, patch, rng=None if seed is None
                                     else np.random.default_rng(seed))
            got = preprocess.crop_volume(vol, patch, rng=None if seed is None
                                         else np.random.default_rng(seed))
            np.testing.assert_array_equal(got, want)
            got_t = preprocess.crop_volume(torch.from_numpy(vol), patch, rng=None if seed is None
                                           else np.random.default_rng(seed))
            np.testing.assert_array_equal(got_t.numpy(), want)
    with pytest.raises(ValueError, match="pad first"):
        preprocess.crop_volume(vol, (8, 9, 4))


# ------------------------------------------------------------------ packing


def test_packed_datasets_bitwise(tmp_path, brats_root):
    """Each packed reader gives the direct reads bitwise (host route), and the
    shards and index are the JAX package's."""
    index = packing.pack_volumes(brats_root, tmp_path / "vol")
    assert index == jpacking.pack_volumes(brats_root, tmp_path / "jvol")
    for patch in ((16, 16, 16), (24, 40, 40)):
        for random_crop in (True, False):
            got = data.PackedVolumeDataset(tmp_path / "vol", patch, random_crop=random_crop)
            want = data.VolumeDataset3D(brats_root, patch, random_crop=random_crop)
            for epoch in (0, 1):
                got.set_epoch(epoch)
                want.set_epoch(epoch)
                assert_datasets_equal(got, want)

    index = packing.pack_dataset(brats_root, tmp_path / "sl", image_size=16, use_device=False)
    assert index == jpacking.pack_dataset(brats_root, tmp_path / "jsl", image_size=16,
                                          use_device=False)
    assert_datasets_equal(data.PackedSliceDataset(tmp_path / "sl"),
                          data.SliceDataset2D(brats_root, image_size=16))
    assert_datasets_equal(data.PackedSliceDataset(tmp_path / "sl"),
                          jdata.PackedSliceDataset(tmp_path / "jsl"))

    index = packing.pack_multimodal_slices(brats_root, tmp_path / "mm", image_size=16,
                                           use_device=False)
    assert index == jpacking.pack_multimodal_slices(brats_root, tmp_path / "jmm",
                                                    image_size=16, use_device=False)
    for radius in (1, 2):
        got = data.PackedMultiModalDataset25D(tmp_path / "mm", radius)
        assert_datasets_equal(got, data.MultiModalSliceDataset25D(brats_root, 16, radius))
        assert_datasets_equal(got, jdata.PackedMultiModalDataset25D(tmp_path / "jmm", radius))


def test_device_route_packing_matches_jax(tmp_path, brats_root):
    """``use_device=True`` (here ``device="cpu"``) against the JAX package's
    device route: the same index, slices within ``PREPROCESS_ATOL``."""
    got = packing.pack_dataset(brats_root, tmp_path / "sl", image_size=16, device="cpu")
    want = jpacking.pack_dataset(brats_root, tmp_path / "jsl", image_size=16)
    assert got == want
    a, b = data.PackedSliceDataset(tmp_path / "sl"), jdata.PackedSliceDataset(tmp_path / "jsl")
    for i in range(len(b)):
        np.testing.assert_allclose(a[i]["image"], b[i]["image"], atol=PREPROCESS_ATOL, rtol=0)
        assert a[i]["z_pos"] == b[i]["z_pos"]
    got = packing.pack_multimodal_slices(brats_root, tmp_path / "mm", image_size=16,
                                         device="cpu")
    want = jpacking.pack_multimodal_slices(brats_root, tmp_path / "jmm", image_size=16)
    assert got == want
    a = data.PackedMultiModalDataset25D(tmp_path / "mm", 2)
    b = jdata.PackedMultiModalDataset25D(tmp_path / "jmm", 2)
    for i in range(len(b)):
        for k in ("image", "context"):
            np.testing.assert_allclose(a[i][k], b[i][k], atol=PREPROCESS_ATOL, rtol=0)


def test_entry_points_default_to_the_card(tmp_path, brats_root):
    """Without CUDA the entry points raise unless the caller asks for the
    CPU; host-only routes need no device."""
    assert not torch.cuda.is_available()
    ds = data.SliceDataset2D(brats_root, image_size=16)
    with pytest.raises(RuntimeError, match="cuda"):
        data.BatchLoader(ds, 2)
    data.BatchLoader(ds, 2, device_put=False)
    with pytest.raises(RuntimeError, match="cuda"):
        packing.pack_dataset(brats_root, tmp_path / "a", image_size=16)
    with pytest.raises(RuntimeError, match="cuda"):
        packing.pack_multimodal_slices(brats_root, tmp_path / "b", image_size=16)
    with pytest.raises(RuntimeError, match="cuda"):
        packing.pack_latents(brats_root, tmp_path / "c", VAE3D(4, 8, 2, 4))
    assert not (tmp_path / "a").exists() and not (tmp_path / "c").exists()


# ------------------------------------------------------------------ loaders


class _Items:
    """A dataset of seeded numpy samples with per-epoch state."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.items = [{"x": rng.normal(size=(3, 2)).astype(np.float32),
                       "z": np.float32(rng.uniform())} for _ in range(n)]
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return {**self.items[i], "epoch": np.int64(self.epoch)}


def _batches(loader, epochs=2, to_numpy=lambda v: v.numpy()):
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.append([{k: to_numpy(v) for k, v in b.items()} for b in loader])
    return out


def _assert_batches_equal(got, want):
    assert [len(e) for e in got] == [len(e) for e in want]
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            assert_samples_equal(g, w)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_loader_matches_jax(shuffle, drop_last, prefetch):
    """Two epochs, batch for batch: the port's loader on the CPU and with
    ``device_put=False`` against the JAX loader with ``device_put=False``,
    ragged ``drop_last=False`` tails and per-epoch dataset state included."""
    ds = _Items(11)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5, prefetch=prefetch)
    want = _batches(jdata.BatchLoader(ds, 4, device_put=False, **kw), to_numpy=np.asarray)
    got = _batches(data.BatchLoader(ds, 4, device="cpu", **kw))
    assert len(data.BatchLoader(ds, 4, device="cpu", **kw)) == len(
        jdata.BatchLoader(ds, 4, device_put=False, **kw))
    _assert_batches_equal(got, want)
    host = _batches(data.BatchLoader(ds, 4, device_put=False, **kw), to_numpy=lambda v: v)
    assert all(isinstance(v, np.ndarray) for e in host for b in e for v in b.values())
    _assert_batches_equal(host, want)
    first = next(iter(data.BatchLoader(ds, 4, device="cpu", **kw)))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in first.values())


def test_batch_loader_transform_and_views():
    """``set_epoch`` reaches the dataset through subset and split views, and a
    ``transform`` sees the stacked host batch — in both packages alike."""
    ds = _Items(20, seed=1)

    def transform(batch):
        return {**batch, "x": batch["x"] * 2.0}

    sub = data.take_subset(ds, fraction=0.9, seed=42)
    train, _ = data.split_dataset(sub, 0.25, seed=0)
    jsub = jdata.take_subset(ds, fraction=0.9, seed=42)
    jtrain, _ = jdata.split_dataset(jsub, 0.25, seed=0)
    got = _batches(data.BatchLoader(train, 3, device="cpu", transform=transform), epochs=3)
    want = _batches(jdata.BatchLoader(jtrain, 3, device_put=False, transform=transform),
                    epochs=3, to_numpy=np.asarray)
    _assert_batches_equal(got, want)
    assert [int(e[0]["epoch"][0]) for e in got] == [0, 1, 2]


def test_loader_propagates_producer_errors():
    class _Bad:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise RuntimeError("decode exploded")

    for prefetch in (0, 2):
        with pytest.raises(RuntimeError, match="decode exploded"):
            list(data.BatchLoader(_Bad(), 4, prefetch=prefetch, device="cpu"))


def test_loader_early_stop_leaks_no_thread():
    """A consumer that stops after one batch ends the producer thread."""
    before = threading.active_count()
    loader = data.BatchLoader(_Items(64), 2, prefetch=2, device="cpu")
    for _ in range(3):
        it = iter(loader)
        next(it)
        it.close()
    assert threading.active_count() == before


def test_subsets_and_splits_index_for_index(tmp_path):
    ds = _Items(37)
    for kw in ({"fraction": 1 / 3}, {"max_items": 10}, {"fraction": 0.5, "max_items": 7,
                                                         "seed": 3}):
        assert np.array_equal(data.take_subset(ds, **kw).indices,
                              jdata.take_subset(ds, **kw).indices)
    for frac, seed in ((0.1, 0), (0.34, 2)):
        for got, want in zip(data.split_dataset(ds, frac, seed), jdata.split_dataset(ds, frac, seed)):
            assert np.array_equal(got.indices, want.indices)
    for n in (1, 2, 3, 10, 37):
        assert split.split_counts(n) == jsplit.split_counts(n)
    subjects = [f"sub{i:02d}" for i in range(13)]
    assert split.split_subjects(subjects, seed=7) == jsplit.split_subjects(subjects, seed=7)
    assert split.volume_split_indices(50, seed=42) == jsplit.volume_split_indices(50, seed=42)
    for i in range(6):
        (tmp_path / "src" / f"s{i}").mkdir(parents=True)
    got = split.apply_split(tmp_path / "src", tmp_path / "out", seed=1, mode="symlink")
    want = jsplit.apply_split(tmp_path / "src", tmp_path / "jout", seed=1, mode="symlink")
    assert {k: [p.name for p in v] for k, v in got.items()} == {
        k: [p.name for p in v] for k, v in want.items()}
    for name in ("train", "val", "test"):
        assert ((tmp_path / "out" / "splits" / f"{name}.txt").read_text()
                == (tmp_path / "jout" / "splits" / f"{name}.txt").read_text())
    with pytest.raises(ValueError):
        split.apply_split(tmp_path / "src", tmp_path / "src" / "bad")
    assert np.array_equal(data.epoch_permutation(9, 3, 4), jloader.epoch_permutation(9, 3, 4))


# ------------------------------------------------------------------ latents


@pytest.fixture(scope="module")
def vaes():
    """The JAX package's VAE3D (flax parameters from its init) and the port's
    with those parameters converted."""
    jvae = JVAE3D(in_channels=4, base_channels=8, num_down=2, latent_channels=4)
    params = jax.jit(jvae.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 4)),
                                jax.random.PRNGKey(1))
    vae = VAE3D(4, 8, 2, 4)
    vae.load_state_dict(vae3d_state_dict_from_flax(params, 2), strict=True)
    return jvae, params, vae


def _read_latents(cache_dir, index):
    return [np.load(cache_dir / f["path"])["latent"] for f in index["files"]]


@pytest.mark.parametrize("source", ["packed", "raw"])
def test_pack_latents_matches_jax(tmp_path, brats_root, vaes, source):
    jvae, params, vae = vaes
    src = brats_root
    if source == "packed":
        src = tmp_path / "vol"
        packing.pack_volumes(brats_root, src)
    got = packing.pack_latents(src, tmp_path / "lat", vae, device="cpu")
    want = jpacking.pack_latents(src, tmp_path / "jlat", jvae, params)
    assert json.loads((tmp_path / "lat" / "index.json").read_text()) == got
    fp, jfp = got.pop("params_fingerprint"), want.pop("params_fingerprint")
    assert fp == pytest.approx(jfp, rel=FINGERPRINT_RTOL)
    assert fp == pytest.approx(packing.params_fingerprint(vae.state_dict()), rel=1e-12)
    assert got == want          # kind, downsample, source, source_files, files and shapes
    for a, b in zip(_read_latents(tmp_path / "lat", got), _read_latents(tmp_path / "jlat", want)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=LATENT_ATOL, rtol=0)
    lat = data.PackedLatentDataset(tmp_path / "lat", (4, 8, 8))
    jlat = jdata.PackedLatentDataset(tmp_path / "jlat", (4, 8, 8))
    for epoch in (0, 1):
        lat.set_epoch(epoch)
        jlat.set_epoch(epoch)
        for i in range(len(jlat)):
            np.testing.assert_allclose(lat[i]["latent"], jlat[i]["latent"], atol=LATENT_ATOL,
                                       rtol=0)


def test_latent_caches_are_judged_alike(tmp_path, brats_root, vaes):
    """A cache written by either package is fresh for the other's fingerprint
    of the same VAE, and stale for another VAE or other sources."""
    jvae, params, vae = vaes
    src = tmp_path / "vol"
    packing.pack_volumes(brats_root, src)
    files = packing.latent_source_files(src)
    assert files == jpacking.latent_source_files(src)
    assert packing.latent_source_files(brats_root) == jpacking.latent_source_files(brats_root)
    fp, jfp = packing.params_fingerprint(vae), jpacking.params_fingerprint(params)
    packing.pack_latents(src, tmp_path / "lat", vae, device="cpu")
    jpacking.pack_latents(src, tmp_path / "jlat", jvae, params)
    for cache in ("lat", "jlat"):
        idx = tmp_path / cache / "index.json"
        assert not packing.latent_cache_is_stale(idx, fp, files)
        assert not jpacking.latent_cache_is_stale(idx, jfp, files)
        assert packing.latent_cache_is_stale(idx, fp * (1 + 1e-4), files)
        assert packing.latent_cache_is_stale(idx, fp, files[:-1])
    assert packing.latent_cache_is_stale(tmp_path / "none" / "index.json", fp, files)


def test_pack_latents_refuses_a_vae_on_another_device(tmp_path, brats_root):
    vae = VAE3D(4, 8, 2, 4).to("meta")
    with pytest.raises(ValueError, match="parameters lie on"):
        packing.pack_latents(brats_root, tmp_path / "lat", vae, device="cpu")
