"""ctypes binding to the native NIfTI reader (``csrc/mrijax_io.cpp``).

Counterpart of ``mrijax/data/cnifti.py``: gunzip + header parse + float32
cast in C++, and a batch decode on a thread pool that runs outside the GIL.
The shared library is built from the repository's ``csrc/mrijax_io.cpp`` at
its first use, the way ``mrijax_torch/kernels/_build.py`` builds the CUDA
sources::

    g++ -O3 -std=c++17 -fPIC -shared -o mrijax_torch/_build/libmrijax_io_<hash>.so \
        csrc/mrijax_io.cpp -lz -lpthread

The hash covers the source and the flags, so an edited source is rebuilt and
a stale library is never loaded. Nothing is built when the module is
imported. A missing compiler or a failed build raises; there is no route
from here to the numpy reader. ``mrijax_torch.data.nifti.load`` is the plain
version, and the two give bit-identical float32 output (tested).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "mrijax_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LINK_FLAGS = ("-lz", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()   # loader threads may ask for the library at once

_ERRORS = {
    -1: "cannot open file",
    -2: "gzip decode failed",
    -3: "bad NIfTI header",
    -4: "unsupported NIfTI datatype",
    -5: "size mismatch",
}


class _NiftiInfo(ctypes.Structure):
    _fields_ = [
        ("ndim", ctypes.c_int32),
        ("shape", ctypes.c_int64 * 7),
        ("datatype", ctypes.c_int32),
        ("bitpix", ctypes.c_int32),
        ("scl_slope", ctypes.c_double),
        ("scl_inter", ctypes.c_double),
        ("vox_offset", ctypes.c_int64),
        ("little_endian", ctypes.c_int32),
    ]


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256()
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmrijax_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/mrijax_io.cpp`` unless its library exists; return its
    path. Raises when ``g++`` is missing or the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH: mrijax_torch.data.cnifti compiles "
                           "csrc/mrijax_io.cpp at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native NIfTI reader build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: never a half-written library
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.nifti_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_NiftiInfo)]
            lib.nifti_probe.restype = ctypes.c_int
            lib.nifti_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            ]
            lib.nifti_decode.restype = ctypes.c_int
            lib.nifti_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.nifti_decode_batch.restype = ctypes.c_int
            _lib = lib
        return _lib


def _raise(rc: int, path) -> None:
    raise IOError(f"native NIfTI decode failed for {path}: "
                  f"{_ERRORS.get(rc, f'code {rc}')}")


def probe(path) -> Tuple[Tuple[int, ...], dict]:
    """(shape, header dict) without decoding voxels."""
    info = _NiftiInfo()
    rc = _load().nifti_probe(str(path).encode(), ctypes.byref(info))
    if rc != 0:
        _raise(rc, path)
    shape = tuple(int(info.shape[i]) for i in range(info.ndim))
    return shape, {
        "datatype": info.datatype,
        "bitpix": info.bitpix,
        "scl_slope": info.scl_slope,
        "scl_inter": info.scl_inter,
        "vox_offset": info.vox_offset,
        "little_endian": bool(info.little_endian),
    }


def load(path) -> np.ndarray:
    """Decode one volume to float32 in the on-disk (Fortran) axis order —
    same output as ``mrijax_torch.data.nifti.load``."""
    shape, _ = probe(path)
    n = int(np.prod(shape))
    out = np.empty((n,), np.float32)
    rc = _load().nifti_decode(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
    )
    if rc != 0:
        _raise(rc, path)
    return out.reshape(shape, order="F")


def load_batch(paths: Sequence, num_threads: Optional[int] = None) -> List[np.ndarray]:
    """Decode many volumes concurrently (C++ thread pool, GIL released)."""
    lib = _load()
    num_threads = num_threads or min(8, os.cpu_count() or 1)
    shapes = [probe(p)[0] for p in paths]
    outs = [np.empty((int(np.prod(s)),), np.float32) for s in shapes]

    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for o in outs]
    )
    c_elems = (ctypes.c_int64 * n)(*[o.size for o in outs])
    c_rcs = (ctypes.c_int32 * n)()
    rc = lib.nifti_decode_batch(c_paths, c_outs, c_elems, n, num_threads, c_rcs)
    if rc != 0:
        bad = next(i for i in range(n) if c_rcs[i] != 0)
        _raise(c_rcs[bad], paths[bad])
    return [o.reshape(s, order="F") for o, s in zip(outs, shapes)]
