#!/usr/bin/env python3
"""Time the bf16 tensor-core ``flash_attn_fwd`` kernels of ``mrijax_torch`` at
both block sizes they are compiled for, on one NVIDIA GPU.

    python3 scripts/probe_torch_flash_tiles.py

``mrijax_torch.kernels.flash_attention.launch_plan`` picks 64 or 128 query
rows per block, at Dh ≤ 128 and above (``flash_fwd_wide_tc_kernel``: one or
two warpgroups of 64 rows). This script overrides that choice with each in
turn, at the generation shape (2, 800, 4, 128), the training shape
(8, 800, 4, 128), the full-resolution shape (1, 51200, 4, 32), and at the
head dims above 128 of the flagship with 1 or 2 heads (``WIDE_SHAPES``:
level 1 at Dh 256 and 6400 tokens at batch 8 and 2, the bottleneck at Dh 256
and 512, 1024 columns), checks the result against the plain version (the
bars of ``chip_smoke.py``; not at N = 51 200), and times the kernel with CUDA
events (3 warm-up calls, median of 20 calls, 5 at N ≥ 5000, a spin kernel
before each so that the launch latency is not in the time). It prints the
card's name and power limit first and one JSON line per shape; ``"plan"`` is
the tile ``launch_plan`` chooses, ``"blocks_tile_<t>"`` the blocks of each tile.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mrijax_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = [(2, 800, 4, 128), (8, 800, 4, 128), (1, 51200, 4, 32)]
WIDE_SHAPES = [(8, 6400, 1, 256), (2, 6400, 1, 256), (8, 800, 2, 256), (2, 800, 2, 256),
               (8, 800, 1, 512), (2, 800, 1, 1024)]


def time_ms(fn, repeats):
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


def outside(got, want, atol, rtol):
    g, w = got.float(), want.float()
    return int(((g - w).abs() > atol + rtol * w.abs()).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    planned = fa.launch_plan
    rng = np.random.default_rng(0)
    for shape in SHAPES + WIDE_SHAPES:
        b, n, h, d = shape
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32))
        qkv = qkv.cuda().bfloat16()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        small = n < 5000
        checked = n < 51200
        if checked:
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
        row = {"shape": list(shape),
               "plan": planned("flash_attn_fwd", b, n, h, d, torch.bfloat16).tile}
        for tile in fa.FORWARD_TILES:
            fa.launch_plan = lambda *a, tile=tile: planned(*a)._replace(tile=tile)
            row[f"blocks_tile_{tile}"] = b * h * -(-n // tile) * planned(
                "flash_attn_fwd", b, n, h, d, torch.bfloat16).chunks
            if checked:
                got_out, got_lse = fa.flash_attention_forward(q, k, v)
                bad = (outside(got_out, ref_out, 2e-3, 1e-2)
                       + outside(got_lse, ref_lse, 1e-4, 0))
                if bad:
                    raise AssertionError(f"{shape} tile {tile}: {bad} elements outside the bars")
            row[f"fwd_ms_tile_{tile}"] = time_ms(
                lambda: fa.flash_attention_forward(q, k, v), 20 if small else 5)
        fa.launch_plan = planned
        if checked:
            del ref_out, ref_lse
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
