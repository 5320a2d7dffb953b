#!/usr/bin/env python3
"""Where the time of the float32 flash backward goes, on one NVIDIA GPU.

    python3 scripts/probe_torch_flash_f32_bwd.py

Builds ``mrijax_torch/csrc/flash_attention_bwd.cu`` as it is and in four
copies that each leave one phase of ``flash_bwd_f32_kernel`` (dkv and dq,
every head dim) out: ``no_copies`` (the cp.async of the next tile or unit),
``no_logits`` (the S and dP products), ``no_elementwise`` (P and dU and
their stores; the two barriers stay) and ``no_accumulate`` (the dV, dK and
dQ' products). A copy computes garbage; only its time means anything: the
whole kernel's time less a copy's is what that phase costs where it does not
overlap the others. Each library is built with the package's own ``nvcc``
flags into ``mrijax_torch/_build/probe_f32_bwd/`` and swapped in for the
wrapper's library. Times: CUDA events around single calls after a spin
kernel, 3 warm-up calls, the median of 11 (5 at (8, 6400, 1, 256)), float32
at (8, 800, 4, 128) (the flagship's bottleneck heads at the training batch),
(8, 6400, 1, 256) and (8, 800, 1, 512) (the 1-head flagship's level 1 and
bottleneck), the unmodified build first and last. Prints the card's name
and power limit, the ``ptxas`` registers of each build's float32 instances,
and one JSON line a build: per shape, the ms of dkv and dq.
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

SHAPES = (((8, 800, 4, 128), 11), ((8, 6400, 1, 256), 5), ((8, 800, 1, 512), 11))
OUT = _build.BUILD_DIR / "probe_f32_bwd"

# (text in the source, what replaces it, how many times it occurs)
CUTS = {
    "no_copies": [
        ("            if (j + 1 < ntiles) load_tile(j + 1);\n", "", 1),
        ("                if (p + 1 < pieces) load_piece(u + 1, j, p + 1);\n"
         "                else load_cols(u + 1, j, 0);\n", "", 1),
        ("                if (a + 1 < A) load_cols(u + 1, j, a + 1);\n"
         "                else if (j + 1 < ntiles) load_piece(u + 1, j + 1, 0);\n", "", 1)],
    "no_logits": [(re.compile(r" *logits<[^>]*>\([^;]*\);\n"), "", 2)],
    "no_elementwise": [(re.compile(r"p_and_du\(j\);"), "__syncthreads(); __syncthreads();", 2)],
    "no_accumulate": [(re.compile(r"accumulate_t<[^>]*>\(acc\[\w\], it, t\);"), "", 2)],
}


def registers(log):
    """ptxas registers of the float32 instances in one build log, in order."""
    out, entry = [], False
    for line in log.splitlines():
        if re.search(r"Compiling entry function '\S*flash_bwd_f32_kernel", line):
            entry = True
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            out.append(int(m.group(1)))
            entry = False
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    source = (_build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    texts = {"kernel": source, **{n: variant_source(source, c) for n, c in CUTS.items()}}
    builds = {name: build(name, text, out=OUT) for name, text in texts.items()}
    libs = {}
    for name, (lib, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}")
        libs[name] = lib
        print(f"{name}: float32 registers {registers(log)}")

    rng = np.random.default_rng(0)
    inputs = {}
    for shape, _ in SHAPES:
        b, n, h, d = shape
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32)).cuda()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out, lse = fa.flash_attention_forward(q, k, v)
        dout = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
        inputs[shape] = (q, k, v, dout, lse, fa.flash_attention_delta(out, dout))
    for name in [*libs, "kernel"]:
        _build._loaded["flash_attention_bwd"] = ctypes.CDLL(str(libs[name]))
        fa._backward_library()
        row = {"build": name}
        for shape, repeats in SHAPES:
            a = inputs[shape]
            row[str(shape)] = [time_ms(lambda: fa.flash_attn_bwd_dkv(*a), repeats),
                               time_ms(lambda: fa.flash_attn_bwd_dq(*a), repeats)]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
