#!/usr/bin/env python3
"""Where the time of the bf16 flash backward above Dh 128 goes, on one NVIDIA GPU.

    python3 scripts/probe_torch_flash_wide_bwd.py

Builds ``mrijax_torch/csrc/flash_attention_bwd.cu`` as it is and in four
copies that each leave one phase of ``flash_bwd_dkv_wide_tc_kernel`` and
``flash_bwd_dq_wide_tc_kernel`` out: ``no_copies`` (the ring's cp.async of
the next slot), ``no_logits`` (the S and dP warpgroup products),
``no_elementwise`` (the P / dU stores to shared memory) and ``no_accumulate``
(the dV, dK and dQ' products). A copy computes garbage; only its time means
anything: the whole kernel's time less a copy's is what that phase costs
where it does not overlap the others. Each library is built with the
package's own ``nvcc`` flags into ``mrijax_torch/_build/probe_wide_bwd/`` and
swapped in for the wrapper's library. Times: CUDA events around single calls
after a spin kernel, 3 warm-up calls, the median of 11, at (8, 6400, 1, 256)
(level 1 of the 1-head flagship), (8, 800, 2, 256) and (8, 800, 1, 512),
the unmodified build first and last. Prints the card's name and power
limit, the ``ptxas`` registers of each build, and one JSON line a build:
per shape, the ms of dkv and dq.
"""

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mrijax_torch.kernels import _build  # noqa: E402
from mrijax_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = ((8, 6400, 1, 256), (8, 800, 2, 256), (8, 800, 1, 512))
OUT = _build.BUILD_DIR / "probe_wide_bwd"

# (text in the source, what replaces it, how many times it occurs)
CUTS = {
    "no_copies": [("            if (u + 1 < total) load_unit(u + 1);\n", "", 2)],
    "no_logits": [(re.compile(r"            issue_logits\([^;]*\);\n"), "", 2)],
    "no_elementwise": [
        ("            store_split(tp, pv, r0, c);\n            store_split(tp + 2 * BB, du, r0, c);",
         "            if (du[0] == 12345.f) store_split(tp, pv, r0, c);", 1),
        ("            store_split(tp, du, r0, 32 * wg + 8 * jn + 2 * t);",
         "            if (du[0] == 12345.f) store_split(tp, du, r0, 32 * wg + 8 * jn + 2 * t);", 1)],
    "no_accumulate": [(re.compile(r"        accumulate\([^;]*\);\n"), "", 3)],
}


def variant_source(text, cuts):
    for old, new, count in cuts:
        if isinstance(old, str):
            found = text.count(old)
            text = text.replace(old, new)
        else:
            text, found = old.subn(new, text)
        if found != count:
            raise RuntimeError(f"expected {count} of {old!r} in the source, found {found}")
    return text


def build(name, text, source="flash_attention_bwd", out=OUT):
    """Compile one variant of ``csrc/<source>.cu`` into ``out/name`` beside
    copies of the headers; returns the library's path and the nvcc process."""
    d = out / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, d)
    (d / f"{source}.cu").write_text(text)
    lib = d / f"lib{source}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(lib),
           str(d / f"{source}.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def registers(log):
    """ptxas registers of the two wide kernels in one build log."""
    out, entry = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '\S*(flash_bwd_d\w+_wide_tc_kernel)", line):
            entry = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            out[entry], entry = int(m.group(1)), None
    return out


def time_ms(fn, repeats=11):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    source = (_build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    texts = {"kernel": source, **{n: variant_source(source, c) for n, c in CUTS.items()}}
    builds = {name: build(name, text) for name, text in texts.items()}
    libs = {}
    for name, (lib, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}")
        libs[name] = lib
        print(f"{name}: registers {json.dumps(registers(log))}")

    rng = np.random.default_rng(0)
    inputs = {}
    for shape in SHAPES:
        b, n, h, d = shape
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32))
        qkv = qkv.cuda().bfloat16()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out, lse = fa.flash_attention_forward(q, k, v)
        dout = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().bfloat16()
        inputs[shape] = (q, k, v, dout, lse, fa.flash_attention_delta(out, dout))
    for name in [*libs, "kernel"]:
        _build._loaded["flash_attention_bwd"] = ctypes.CDLL(str(libs[name]))
        fa._backward_library()
        row = {"build": name}
        for shape, a in inputs.items():
            row[str(shape)] = [time_ms(lambda: fa.flash_attn_bwd_dkv(*a)),
                               time_ms(lambda: fa.flash_attn_bwd_dq(*a))]
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
