#!/usr/bin/env python3
"""Time the ``gn_silu_apply`` kernel of ``mrijax_torch`` against variants of
itself, on one NVIDIA GPU.

    python3 scripts/probe_torch_gn_apply.py

At five main-path shapes (bf16, batch 2) it times, with CUDA events (3
warm-up calls, median of 20 calls, a spin kernel before each so that the
launch latency is not in the time):

* the committed kernel with the plan ``apply_plan`` picks (``plan``), and
  with each number of loads a thread it is compiled for (``rows_1``,
  ``rows_2``), the other fields as the plan gives them; each is held against
  the plain version (one bf16 ulp);
* ablations, copies of ``mrijax_torch/csrc/groupnorm_silu.cu`` built beside
  it with one part cut, launched with the committed plan: ``no_params``
  (constant mean, scale and shift: no block-wide preamble that computes
  them from the statistics, γ and β, no barrier, no shared-memory reads),
  ``no_silu`` (the affine alone: no exponential, no division),
  ``fast_silu`` (``__expf`` and ``__fdividef`` in place of ``expf`` and
  ``/``), ``copy`` (y = x: the loads and stores alone);
* ``torch_copy``: ``Tensor.copy_`` of the same bytes into a fresh tensor, one
  read and one write, as a yardstick of what the card does for them (the
  port never calls it).

It prints the card's name and power limit first and one JSON line per shape
with the bytes bound (one read and one write over 3.35 TB/s).
"""

import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mrijax_torch.kernels import _build  # noqa: E402
from mrijax_torch.kernels import groupnorm as gn  # noqa: E402

SHAPES = [(2, 800, 512), (2, 6400, 256), (2, 51200, 128), (2, 409600, 64), (2, 3276800, 32)]
GROUPS = 8
HBM_BYTES_PER_S = 3.35e12

SILU = "o.v[i] = from_float<T>(v / (1.f + expf(-v)));"
SOURCE = (Path(__file__).resolve().parent.parent / "mrijax_torch/csrc/groupnorm_silu.cu").read_text()
PREAMBLE = SOURCE[SOURCE.index("    // meanwhile the block computes"):SOURCE.index("    if (!col_ok) return;")]
PARAMS = """    load_channels<VEC>(own, mean);
    load_channels<VEC>(own + nch, a);
    load_channels<VEC>(own + 2 * nch, be);"""
CONSTANTS = """    for (int i = 0; i < VEC; ++i) {
        mean[i] = 0.25f;
        a[i] = 1.5f;
        be[i] = 0.1f;
    }"""
VARIANTS = {
    "no_params": [(PREAMBLE, ""), ("    const float* own = params + threadIdx.x * VEC;\n", ""),
                  (PARAMS, CONSTANTS)],
    "no_silu": [(SILU, "o.v[i] = from_float<T>(v);")],
    "fast_silu": [(SILU, "o.v[i] = from_float<T>(__fdividef(v, 1.f + __expf(-v)));")],
    "copy": [(SILU, "o.v[i] = p[r].v[i];")],
}


def build_variants():
    """One library per variant, all ``nvcc`` started together."""
    out = _build.BUILD_DIR / "probe_gn_apply"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = SOURCE
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        src, lib = out / f"groupnorm_silu_{name}.cu", out / f"libgroupnorm_silu_{name}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
               "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        libs[name] = lib
    return libs


def time_ms(fn, repeats=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    committed = _build.library("groupnorm_silu")
    variants = {name: ctypes.CDLL(str(path)) for name, path in build_variants().items()}
    rng = np.random.default_rng(0)
    for b, n, c in SHAPES:
        x = torch.from_numpy(rng.standard_normal((b, n, c), dtype=np.float32)).cuda()
        x = x.mul_(1.5).add_(0.3).bfloat16()
        scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(c, dtype=np.float32)).cuda()
        bias = torch.from_numpy(0.1 * rng.standard_normal(c, dtype=np.float32)).cuda()
        stats = gn.gn_silu_stats(x, GROUPS)
        want = gn.gn_silu_apply_reference(x, stats, scale, bias)
        plan = gn.apply_plan(n, c, GROUPS, x.element_size())
        row = {"shape": [b, n, c], "apply_plan": dataclasses.asdict(plan),
               "bound_ms": 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3}
        for r in gn.APPLY_ROWS_PER_THREAD[::-1]:
            plan_r = dataclasses.replace(plan, rows_per_thread=r,
                                         row_chunks=-(-n // (plan.ty * r)))
            got = gn._launch_apply(x, stats, scale, bias, plan_r)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-2)
            row[f"rows_{r}_ms"] = time_ms(lambda: gn._launch_apply(x, stats, scale, bias, plan_r))
        row["plan_ms"] = time_ms(lambda: gn.gn_silu_apply(x, stats, scale, bias))
        for name, lib in variants.items():
            _build._loaded["groupnorm_silu"] = lib
            row[f"{name}_ms"] = time_ms(lambda: gn.gn_silu_apply(x, stats, scale, bias))
        _build._loaded["groupnorm_silu"] = committed
        row["torch_copy_ms"] = time_ms(lambda: torch.empty_like(x).copy_(x))
        print(json.dumps(row), flush=True)
        del x, stats, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
