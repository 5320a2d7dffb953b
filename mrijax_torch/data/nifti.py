"""Minimal NIfTI-1 reader/writer in pure numpy.

A copy of ``mrijax/data/nifti.py`` (the port imports nothing of ``mrijax``).

The reference delegates NIfTI decode to nibabel (whose hot path is C zlib);
this environment has no nibabel, so mrijax ships its own implementation of
the NIfTI-1 container:

* header parse (348-byte struct: dims, datatype, scl_slope/inter, affine),
* ``.nii`` and ``.nii.gz`` (zlib) payloads,
* data returned as float32 with slope/intercept applied, in the on-disk
  (H, W, D[, ...]) axis order — matching what ``np.asanyarray(img.dataobj)``
  gives the reference datasets (`slice_cond_2d_ddpm/dataset.py:54-56`).

``mrijax_torch.data.cnifti`` (ctypes binding over the repository's C++
reader, built at first use) does gunzip+cast for the training ingest path;
this module is its plain version and the writer.
"""

import gzip
import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


class NiftiHeader:
    def __init__(self, dim, datatype, bitpix, vox_offset, scl_slope, scl_inter,
                 pixdim, affine, endian="<"):
        self.dim = dim
        self.datatype = datatype
        self.bitpix = bitpix
        self.vox_offset = vox_offset
        self.scl_slope = scl_slope
        self.scl_inter = scl_inter
        self.pixdim = pixdim
        self.affine = affine
        self.endian = endian

    @property
    def shape(self) -> Tuple[int, ...]:
        ndim = self.dim[0]
        return tuple(int(d) for d in self.dim[1 : 1 + ndim])


def _read_raw(path: Path) -> bytes:
    data = Path(path).read_bytes()
    if data[:2] == b"\x1f\x8b":  # gzip magic
        return gzip.decompress(data)
    return data


def parse_header(buf: bytes) -> NiftiHeader:
    if len(buf) < HEADER_SIZE:
        raise ValueError("truncated NIfTI header")
    for endian in ("<", ">"):
        sizeof_hdr = struct.unpack(endian + "i", buf[0:4])[0]
        if sizeof_hdr == 348:
            break
    else:
        raise ValueError("not a NIfTI-1 file (sizeof_hdr != 348)")
    magic = buf[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"bad NIfTI magic {magic!r}")
    dim = struct.unpack(endian + "8h", buf[40:56])
    datatype, bitpix = struct.unpack(endian + "2h", buf[70:74])
    pixdim = struct.unpack(endian + "8f", buf[76:108])
    vox_offset, scl_slope, scl_inter = struct.unpack(endian + "3f", buf[108:120])
    # affine from srow_x/y/z (quaternion form ignored: BraTS ships srow)
    srow = np.frombuffer(buf[280:328], dtype=endian + "f4").reshape(3, 4)
    affine = np.vstack([srow, [0, 0, 0, 1]]).astype(np.float32)
    return NiftiHeader(
        dim=dim, datatype=datatype, bitpix=bitpix, vox_offset=vox_offset,
        scl_slope=scl_slope, scl_inter=scl_inter, pixdim=pixdim,
        affine=affine, endian=endian,
    )


def load(path, dtype=np.float32) -> np.ndarray:
    """Load a .nii / .nii.gz volume as ``dtype`` with slope/inter applied.

    Axis order matches the on-disk Fortran layout, i.e. the same (H, W, D)
    the reference gets from nibabel.
    """
    raw = _read_raw(Path(path))
    hdr = parse_header(raw)
    np_dtype = _DTYPES.get(hdr.datatype)
    if np_dtype is None:
        raise ValueError(f"unsupported NIfTI datatype code {hdr.datatype}")
    shape = hdr.shape
    count = int(np.prod(shape))
    offset = int(hdr.vox_offset) if hdr.vox_offset >= HEADER_SIZE else HEADER_SIZE
    arr = np.frombuffer(
        raw, dtype=np.dtype(np_dtype).newbyteorder(hdr.endian),
        count=count, offset=offset,
    )
    vol = arr.reshape(shape, order="F").astype(dtype)
    slope, inter = hdr.scl_slope, hdr.scl_inter
    if slope not in (0.0, 1.0) or inter != 0.0:
        s = slope if slope != 0.0 else 1.0
        vol = vol * s + inter
    return vol


def load_header(path) -> NiftiHeader:
    """Parse only the header (cheap volume-shape probe for slice indexing —
    the reference calls ``nib.load(p).shape`` per volume at dataset init,
    `slice_cond_2d_ddpm/dataset.py:30-33`)."""
    p = Path(path)
    data = p.read_bytes()
    if data[:2] == b"\x1f\x8b":
        # decompress only enough bytes for the header
        d = zlib.decompressobj(16 + zlib.MAX_WBITS)
        buf = b""
        i = 0
        chunk = 16384
        while len(buf) < HEADER_SIZE and i < len(data):
            buf += d.decompress(data[i : i + chunk], HEADER_SIZE - len(buf))
            i += chunk
        return parse_header(buf)
    return parse_header(data[:HEADER_SIZE])


def save(path, vol: np.ndarray, affine: Optional[np.ndarray] = None) -> None:
    """Write a .nii / .nii.gz (by extension) with an identity (or given)
    affine — the reference saves generated volumes the same way
    (`ddpm_3d_ldm/show_model.py:229-259`)."""
    path = Path(path)
    vol = np.asarray(vol)
    code = _DTYPE_CODES.get(vol.dtype)
    if code is None:
        vol = vol.astype(np.float32)
        code = 16
    if affine is None:
        affine = np.eye(4, dtype=np.float32)
    ndim = vol.ndim
    dim = [ndim] + list(vol.shape) + [1] * (7 - ndim)

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, code, vol.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *([1.0] * ndim), *([0.0] * (7 - ndim)))
    struct.pack_into("<3f", hdr, 108, 352.0, 1.0, 0.0)  # vox_offset, slope, inter
    # qform/sform codes: use sform=1 (scanner anat)
    struct.pack_into("<2h", hdr, 252, 0, 1)
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + vol.tobytes(order="F")
    if str(path).endswith(".gz"):
        path.write_bytes(gzip.compress(payload))
    else:
        path.write_bytes(payload)
