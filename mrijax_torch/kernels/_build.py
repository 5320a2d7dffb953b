"""Builds the CUDA sources of ``mrijax_torch/csrc`` at first use and loads
them with ``ctypes``.

Each ``*.cu`` becomes one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o mrijax_torch/_build/lib<name>_<hash>.so <name>.cu

The hash covers the source, every ``*.cuh`` beside it and the flags, so an
edited source is rebuilt and a stale library is never loaded. The first
request for any library starts one ``nvcc`` per source that still needs
building, all at once, and waits for them: a process that uses several
kernels pays for the slowest build, not for the sum.

Nothing here runs when the package is imported: importing needs neither
``nvcc`` nor a GPU. A missing compiler or a failed build raises; there is no
route from here to a kernel's plain PyTorch version.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes — must match mrijax_torch/csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: Dict[str, ctypes.CDLL] = {}


class LaunchCounts:
    """Plain integer launch counters, one per kernel name. A wrapper bumps its
    kernel's count where it launches the kernel and nowhere else."""

    def __init__(self, *names: str):
        self._counts = {n: 0 for n in names}

    def bump(self, name: str) -> None:
        self._counts[name] += 1

    def reset(self) -> None:
        for n in self._counts:
            self._counts[n] = 0

    def __getitem__(self, name: str) -> int:
        return self._counts[name]

    def as_dict(self) -> Dict[str, int]:
        return dict(self._counts)


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        shutil.which("nvcc"),
        str(Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and Path(c).exists():
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, under CUDA_HOME and /usr/local/cuda): "
        "the mrijax_torch kernels are compiled from mrijax_torch/csrc at first use"
    )


def cuda_tool(name: str) -> str:
    """Path of a toolkit program that ships beside ``nvcc`` (``cuobjdump``)."""
    return shutil.which(name) or str(Path(_nvcc()).with_name(name))


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _library_path(name: str, src: Path) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing (one ``nvcc`` each, all
    started together) and return ``{name: library path}``."""
    sources = _sources()
    libs = {name: _library_path(name, src) for name, src in sources.items()}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = libs[name].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(sources[name])]
        procs[name] = (tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, cmd, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])  # atomic: never a half-written library
    if failures:
        raise RuntimeError("kernel build failed\n" + "\n".join(failures))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    if name not in _loaded:
        libs = build_all()
        if name not in libs:
            raise KeyError(f"no kernel source csrc/{name}.cu")
        _loaded[name] = ctypes.CDLL(str(libs[name]))
    return _loaded[name]


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for ``csrc/<name>.cu`` (registers,
    shared memory, spills), or "" when the library was not built here."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
