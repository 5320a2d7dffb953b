#!/usr/bin/env python3
"""Where the time of the bf16 flash forward above Dh 128 goes, on one NVIDIA GPU.

    python3 scripts/probe_torch_flash_wide_fwd.py

Builds ``mrijax_torch/csrc/flash_attention_fwd.cu`` as it is and in five
copies that each leave one phase of ``flash_fwd_wide_tc_kernel`` out:
``no_copies`` (the ring's cp.async of the next slot), ``no_logits`` (the
S = q'K^T warpgroup products), ``no_softmax`` (max, exponentials, sums and
the rescale: P is the logits, rounded), ``no_rescale`` (the accumulator's
rescale alone) and ``no_pv`` (the O += P V products). A copy computes
garbage; only its time means anything: the whole kernel's time less a
copy's is what that phase costs where it does not overlap the others. Each
library is built with the package's own ``nvcc`` flags into
``mrijax_torch/_build/probe_wide_fwd/`` and swapped in for the wrapper's
library. Times: CUDA events around single calls after a spin kernel, 3
warm-up calls, the median of 11, at (8, 6400, 1, 256) and (2, 6400, 1, 256)
(level 1 of the 1-head flagship, training and generating) and
(8, 800, 1, 512) (its bottleneck), the unmodified build first and last.
Prints the card's name and power limit, the ``ptxas`` registers of each
build, and one JSON line a build: per shape, the ms of the forward.
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

SHAPES = ((8, 6400, 1, 256), (2, 6400, 1, 256), (8, 800, 1, 512))
OUT = _build.BUILD_DIR / "probe_wide_fwd"
SOURCE = "flash_attention_fwd"

# P of the tile as the logits, rounded: the softmax left out
ROUND_ONLY = "".join(
    f"            pa[{kk}][{e}] = mma::pack_bf16(s[{2 * kk + e // 2}][{2 * (e % 2)}], "
    f"s[{2 * kk + e // 2}][{2 * (e % 2) + 1}]);\n" for kk in range(4) for e in range(4))

# (text in the source, what replaces it, how many times it occurs)
CUTS = {
    "no_copies": [("            if (u + 1 < total) load_unit(u + 1);\n", "", 1)],
    "no_logits": [(re.compile(r"            issue_logits\([^;]*\);\n"), "", 1)],
    "no_softmax": [("        softmax(s, j * KEYS, NK, t, m, l, o, pa);\n", ROUND_ONLY, 1)],
    "no_rescale": [("            o[nd][2 * r] *= alpha;\n            o[nd][2 * r + 1] *= alpha;\n",
                    "", 1)],
    "no_pv": [(re.compile(r"            wgmma::m64n256k16_rs_mn\([^;]*\);\n"), "            ;\n", 1)],
}


def registers(log):
    """ptxas registers of the wide kernel's two instances in one build log."""
    out, entry = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '\S*(flash_fwd_wide_tc_kernelILi\d)", line):
            entry = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            out[entry], entry = int(m.group(1)), None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    source = (_build.CSRC_DIR / f"{SOURCE}.cu").read_text()
    texts = {"kernel": source, **{n: variant_source(source, c) for n, c in CUTS.items()}}
    builds = {name: build(name, text, SOURCE, OUT) for name, text in texts.items()}
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
        inputs[shape] = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    for name in [*libs, "kernel"]:
        _build._loaded[SOURCE] = ctypes.CDLL(str(libs[name]))
        fa._library()
        row = {"build": name}
        for shape, a in inputs.items():
            row[str(shape)] = time_ms(lambda: fa.flash_attention_forward(*a))
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
