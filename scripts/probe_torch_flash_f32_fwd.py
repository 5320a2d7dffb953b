#!/usr/bin/env python3
"""Where the time of the float32 flash forward goes, on one NVIDIA GPU.

    python3 scripts/probe_torch_flash_f32_fwd.py

Builds ``mrijax_torch/csrc/flash_attention_fwd.cu`` as it is, in a copy with
32 own query rows a block at every head dim (``own32``: the source takes 64
up to Dh 256), in a copy that sums P·V over all keys in the tensor cores'
accumulator, rescaling it in place (``sum_in_tensor_cores``: the source sums
each tile's from zero and adds it to O in registers), and in four copies
that each leave one phase of
``flash_fwd_f32_kernel`` (every head dim) out: ``no_copies`` (the cp.async
of the ring's next unit), ``no_logits`` (the S^T products), ``no_softmax``
(the two partial logits to shared memory, the max, the exponentials and P's
terms; the barrier stays) and ``no_pv`` (the V^T P^T products). A cut copy
computes garbage; only its time means anything: the whole kernel's time less
a copy's is what that phase costs where it does not overlap the others. Each
library is built with the package's own ``nvcc`` flags into
``mrijax_torch/_build/probe_f32_fwd/`` and swapped in for the wrapper's
library. Times: CUDA events around single calls after a spin kernel, 3
warm-up calls, the median of 11 (5 at (8, 6400, 1, 256)), float32 at (2,
800, 4, 128) and (8, 800, 4, 128) (the flagship's bottleneck heads,
generating and training), (8, 6400, 1, 256) and (8, 800, 1, 512) (the
1-head flagship's level 1 and bottleneck), the unmodified build first and
last. Prints the card's name and power limit, the ``ptxas`` registers and
spilled bytes of each build's float32 instances, and one JSON line a build:
per shape, the ms of the forward, and for the whole builds (the source,
``own32``, ``sum_in_tensor_cores``) the largest error of out and of lse
against the plain version at N = 51 200 (Dh 32, 4 heads; query rows in
chunks of 4096, three chunks), where the card holds out to 1e-5.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from mrijax_torch.kernels import _build  # noqa: E402
from mrijax_torch.kernels import flash_attention as fa  # noqa: E402
from probe_torch_flash_wide_bwd import build, time_ms, variant_source  # noqa: E402

SHAPES = (((2, 800, 4, 128), 11), ((8, 800, 4, 128), 11), ((8, 6400, 1, 256), 5),
          ((8, 800, 1, 512), 11))
OUT = _build.BUILD_DIR / "probe_f32_fwd"
SOURCE = "flash_attention_fwd"

# (text in the source, what replaces it, how many times it occurs)
CUTS = {
    "own32": [("constexpr int own_rows(int dh) { return dh && dh <= 256 ? 64 : 32; }",
               "constexpr int own_rows(int dh) { return 32; }", 1)],
    "no_copies": [("            load_unit(u + R - 1);\n", "", 2)],
    "no_logits": [(re.compile(r" *logits<NF, UW, BATCH>\([^;]*\);\n"), "", 1)],
    "no_softmax": [(re.compile(r" *// The two partial S\^T.*?wgmma::fence_proxy_async\(\);\n        \}\n",
                               re.S), "        __syncthreads();\n", 1)],
    "no_pv": [(re.compile(r" *pv<NF, BATCH>\([^;]*\);\n"), "", 1)],
    "sum_in_tensor_cores": [
        ("            mma3(o, f[bt & 1][s], phi + off, plo + off, kk > 0);",
         "            mma3(o, f[bt & 1][s], phi + off, plo + off, 1);", 1),
        (re.compile(r"            pv<NF, BATCH>\(c,(.*?)\n *// O\^T = alpha.*?\n            \}\n", re.S),
         "            wgmma::fence_operand(o[a]);\n"
         "#pragma unroll\n"
         "            for (int jn = 0; jn < NF; ++jn) {\n"
         "                const float2 al = *reinterpret_cast<const float2*>(alpha_s + 8 * jn + 2 * t);\n"
         "                o[a][jn][0] *= al.x;\n"
         "                o[a][jn][1] *= al.y;\n"
         "                o[a][jn][2] *= al.x;\n"
         "                o[a][jn][3] *= al.y;\n"
         "            }\n"
         "            pv<NF, BATCH>(o[a],\\1\n", 1)],
}
WHOLE = ("kernel", "own32", "sum_in_tensor_cores")
LONG = (1, 51200, 4, 32)


def registers(log):
    """ptxas registers and spilled bytes of the float32 instances in one build
    log, by instance (OWN, DH, CW)."""
    out, entry = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '\S*flash_fwd_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                          line):
            entry = ",".join(m.groups())
        elif (m := re.search(r"(\d+) bytes spill stores", line)) and entry:
            out[entry] = [None, int(m.group(1))]
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            out.setdefault(entry, [None, 0])[0] = int(m.group(1))
            entry = None
    return out


def long_errors(q, k, v):
    out, lse = fa.flash_attention_forward(q, k, v)
    err_out = err_lse = 0.0
    for start in (0, LONG[1] // 2, LONG[1] - 4096):
        rows = slice(start, start + 4096)
        ref_out, ref_lse = fa.flash_attention_reference(q[:, rows], k, v)
        err_out = max(err_out, float((out[:, rows] - ref_out).abs().max()))
        err_lse = max(err_lse, float((lse.view(LONG[2], -1)[:, rows] - ref_lse).abs().max()))
    return [err_out, err_lse]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    source = (_build.CSRC_DIR / f"{SOURCE}.cu").read_text()
    texts = {"kernel": source, **{n: variant_source(source, c) for n, c in CUTS.items()}}
    builds = {name: build(name, text, source=SOURCE, out=OUT) for name, text in texts.items()}
    libs = {}
    for name, (lib, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}")
        libs[name] = lib
        print(f"{name}: float32 (OWN,DH,CW): [registers, spilled bytes] "
              f"{json.dumps(registers(log))}")

    rng = np.random.default_rng(0)
    inputs = {}
    for shape, _ in SHAPES:
        b, n, h, d = shape
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32)).cuda()
        inputs[shape] = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    long_qkv = [torch.from_numpy(rng.standard_normal(LONG, dtype=np.float32)).cuda()
                for _ in range(3)]
    for name in [*libs, "kernel"]:
        _build._loaded[SOURCE] = ctypes.CDLL(str(libs[name]))
        fa._library()
        row = {"build": name}
        for shape, repeats in SHAPES:
            a = inputs[shape]
            row[str(shape)] = time_ms(lambda: fa.flash_attention_forward(*a), repeats)
        if name in WHOLE:
            row[f"{LONG} max abs err out, lse"] = long_errors(*long_qkv)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
