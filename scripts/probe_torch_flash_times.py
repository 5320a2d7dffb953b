#!/usr/bin/env python3
"""Time the three flash-attention kernels of one tree of ``mrijax_torch``
on one NVIDIA GPU, so that two trees can be compared in turns on one card.

    python3 scripts/probe_torch_flash_times.py [--tree DIR] [--label NAME]

``--tree`` is the root of a checkout or of a ``git archive`` copy (default:
this script's own checkout); its ``mrijax_torch`` is imported and its kernels
are built into its own ``mrijax_torch/_build/``. To compare a change with its
parent, unpack the parent into a git-ignored directory and run the script on
the two trees alternately (parent, change, change, parent, …), one process
each. Times: CUDA events around single calls after a spin kernel, 3 warm-up
calls, the median of 25 calls (7 at N = 51 200 and at (8, 6400, 1, 256)), at
the flagship's shapes (8, 800, 4, 128) and (2, 800, 4, 128), at N = 51 200
with Dh 32 and at (1, 1000, 2, 32), and at every head dim above 128 of
``chip_smoke.py``'s ``FLASH_LARGE_DH`` and ``FLASH_LARGE_DH_CHUNK``: the
flagship with 1 or 2 heads, (8, 6400, 1, 256) and (2, 6400, 1, 256) (level 1
at 1 head, training and generating), (8, 800, 2, 256), (2, 800, 2, 256),
(8, 800, 1, 512) and its sequence-parallel half (q of 400 rows against 800
keys), 1024 columns, and Dh 192 and 320 (zero-padded to 256 and 384 by the
wrappers), all in bf16; then in float32 (TF32 off for PyTorch's own
products) at (8, 800, 4, 128), (2, 800, 4, 128), (8, 6400, 1, 256) (7
calls) and (8, 800, 1, 512). It prints the card's name and power limit,
then one JSON line: per shape (q shape, then "of" the key count where it
differs, then "float32" for those), the ms of ``flash_attn_fwd``,
``flash_attn_bwd_dkv`` and ``flash_attn_bwd_dq``.
"""

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# (B, N, H, Dh), repeats, query rows (None: N)
SHAPES = (((1, 51200, 4, 32), 7, None), ((8, 800, 4, 128), 25, None),
          ((2, 800, 4, 128), 25, None), ((1, 1000, 2, 32), 25, None),
          ((8, 6400, 1, 256), 7, None), ((2, 6400, 1, 256), 25, None),
          ((8, 800, 2, 256), 25, None), ((2, 800, 2, 256), 25, None),
          ((8, 800, 1, 512), 25, None), ((8, 800, 1, 512), 25, 400),
          ((2, 800, 1, 1024), 25, None), ((2, 130, 1, 192), 25, None),
          ((1, 64, 1, 320), 25, None))
# float32: the flagship's heads at the training and the generation batch,
# the 1-head flagship's level 1 and bottleneck at the training batch
FP32_SHAPES = (((8, 800, 4, 128), 25), ((2, 800, 4, 128), 25), ((8, 6400, 1, 256), 7),
               ((8, 800, 1, 512), 25))


def time_ms(fn, repeats):
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--label", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(args.tree.resolve()))
    fa = importlib.import_module("mrijax_torch.kernels.flash_attention")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(0)
    row = {"tree": args.label or str(args.tree), "module": fa.__file__}
    for shape, repeats, nq in SHAPES:
        b, n, h, d = shape
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32))
        qkv = qkv.cuda().bfloat16()
        q, k, v = qkv[:, :nq, 0], qkv[:, :, 1], qkv[:, :, 2]
        out, lse = fa.flash_attention_forward(q, k, v)
        dout = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).cuda().bfloat16()
        delta = fa.flash_attention_delta(out, dout)
        key = str(tuple(q.shape)) + ("" if nq is None else f" of {n}")
        row[key] = [
            time_ms(lambda: fa.flash_attention_forward(q, k, v), repeats),
            time_ms(lambda: fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta), repeats),
            time_ms(lambda: fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta), repeats)]
    for shape, repeats in FP32_SHAPES:
        b, n, h, d = shape
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32)).cuda()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out, lse = fa.flash_attention_forward(q, k, v)
        dout = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).cuda()
        delta = fa.flash_attention_delta(out, dout)
        row[f"{tuple(q.shape)} float32"] = [
            time_ms(lambda: fa.flash_attention_forward(q, k, v), repeats),
            time_ms(lambda: fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta), repeats),
            time_ms(lambda: fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta), repeats)]
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
