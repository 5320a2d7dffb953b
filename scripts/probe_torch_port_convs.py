#!/usr/bin/env python3
"""Time every distinct convolution of the flagship UNet3D / VAE3D of
``mrijax_torch`` on one NVIDIA GPU, bf16, channels-last, batch 2.

    python3 scripts/probe_torch_port_convs.py

Each layer is built as the models build it (``mrijax_torch.models.blocks``)
and timed with CUDA events (3 warm-up calls, median of 10), once with
``torch.backends.cudnn.benchmark`` off and once with it on, and a third time
as a plain channels-first (NCDHW, contiguous) convolution with the same
weights. Prints the card's name and power limit first. The convolutions are cuDNN's, not the port's
kernels: the script exists to show which layer cuDNN serves badly.
"""

import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mrijax_torch.models.blocks import Conv3d, Downsample, Upsample  # noqa: E402

BF16 = torch.bfloat16
LAYERS = [
    ("unet in_conv 16->128 k3", lambda: Conv3d(16, 128, 3, padding=1, dtype=BF16), (2, 32, 40, 40, 16)),
    ("unet out_conv 128->16 k3", lambda: Conv3d(128, 16, 3, padding=1, dtype=BF16), (2, 32, 40, 40, 128)),
    ("unet res 128->128 k3 @51200", lambda: Conv3d(128, 128, 3, padding=1, dtype=BF16), (2, 32, 40, 40, 128)),
    ("unet res 256->128 k3 @51200", lambda: Conv3d(256, 128, 3, padding=1, dtype=BF16), (2, 32, 40, 40, 256)),
    ("unet skip 256->128 k1 @51200", lambda: Conv3d(256, 128, 1, dtype=BF16), (2, 32, 40, 40, 256)),
    ("unet down 128->256 k4 s2 @51200", lambda: Downsample(128, 256, BF16), (2, 32, 40, 40, 128)),
    ("unet res 256->256 k3 @6400", lambda: Conv3d(256, 256, 3, padding=1, dtype=BF16), (2, 16, 20, 20, 256)),
    ("unet down 256->512 k4 s2 @6400", lambda: Downsample(256, 512, BF16), (2, 16, 20, 20, 256)),
    ("unet res 512->512 k3 @800", lambda: Conv3d(512, 512, 3, padding=1, dtype=BF16), (2, 8, 10, 10, 512)),
    ("unet up 512->256 k4 s2 @800", lambda: Upsample(512, 256, BF16), (2, 8, 10, 10, 512)),
    ("unet up 256->128 k4 s2 @6400", lambda: Upsample(256, 128, BF16), (2, 16, 20, 20, 256)),
    ("vae from_latent 16->128 k3", lambda: Conv3d(16, 128, 3, padding=1, dtype=BF16), (2, 32, 40, 40, 16)),
    ("vae up 64->64 k4 s2 @51200", lambda: Upsample(64, 64, BF16), (2, 32, 40, 40, 64)),
    ("vae res 64->64 k3 @409600", lambda: Conv3d(64, 64, 3, padding=1, dtype=BF16), (2, 64, 80, 80, 64)),
    ("vae up 32->32 k4 s2 @409600", lambda: Upsample(32, 32, BF16), (2, 64, 80, 80, 32)),
    ("vae res 32->32 k3 @3276800", lambda: Conv3d(32, 32, 3, padding=1, dtype=BF16), (2, 128, 160, 160, 32)),
    ("vae out_conv 32->4 k3 @3276800", lambda: Conv3d(32, 4, 3, padding=1, dtype=BF16), (2, 128, 160, 160, 32)),
]


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
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
        check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    for name, make, shape in LAYERS:
        layer = make().cuda().to(memory_format=torch.channels_last_3d)
        x = torch.randn(shape, device="cuda", dtype=BF16)
        out_elems = None
        row = []
        for benchmark in (False, True):
            torch.backends.cudnn.benchmark = benchmark
            with torch.no_grad():
                row.append(time_ms(lambda: layer(x)))
                out_elems = layer(x).numel()
        # the same layer the usual PyTorch way: contiguous NCDHW input and weights
        torch.backends.cudnn.benchmark = False
        base = (torch.nn.ConvTranspose3d if isinstance(layer, torch.nn.ConvTranspose3d)
                else torch.nn.Conv3d)
        layer_cf = layer.to(memory_format=torch.contiguous_format)
        x_cf = x.permute(0, 4, 1, 2, 3).contiguous()
        with torch.no_grad():
            channels_first = time_ms(lambda: base.forward(layer_cf, x_cf))
        k = layer.kernel_size[0] ** 3
        flops = 2 * k * layer.in_channels * out_elems
        if isinstance(layer, Upsample):
            flops = 2 * k * layer.out_channels * x.numel()
        print(f"{name:34s} {row[0]:8.3f} ms  (cudnn.benchmark: {row[1]:8.3f} ms; "
              f"channels-first: {channels_first:8.3f} ms)  {flops / row[0] / 1e9:7.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
