#!/usr/bin/env python3
"""Time the ``conv3d_k4s2`` kernel of ``mrijax_torch`` against variants of
itself and against yardsticks, on one NVIDIA GPU.

    python3 scripts/probe_torch_conv3d_k4s2.py [--shapes main|all]

At the UNet3D's two ``Downsample`` shapes at batch 8 (``--shapes all``: also
at batch 32 and the VAE3D encoder's two at batch 1) it times, with CUDA
events (3 warm-up calls, median of 10 calls, a spin kernel before each so
that the launch latency is not in the time):

* the committed kernel with the plan ``launch_plan`` picks (``kernel``),
  held against the plain version first (the bar of ``chip_smoke.py``), and
  at every other compiled tile width (``tile_<n>``);
* ablations, copies of ``mrijax_torch/csrc/conv3d_k4s2.cu`` built beside it
  with one part changed, launched with the committed plan: ``lag1`` (a
  copying thread waits for its pieces of the stage before, fences them and
  arrives, in place of ``cp.async.mbarrier.arrive.noinc``), ``no_fence``
  (the multiplying threads' proxy fence after the full barrier cut); both
  still compute the convolution and are held to the bar; ``no_a`` /
  ``no_b`` (the A gather / the B tile's bulk copy cut), ``no_copies``
  (both cut: the barriers and products alone), ``no_products`` (the copies
  and barriers alone);
* yardsticks the port never calls: ``F.conv3d`` on the channels-last view
  (``library``, cuDNN) and ``torch.matmul`` of the same (M, K) by (K, N)
  bf16 GEMM on a prebuilt im2col matrix (``gemm``, cuBLAS).

It prints the card's name and power limit first and one JSON line per shape
with the operations bound (``kernels/conv3d.py::operations`` over 989
TFLOP/s).

    python3 scripts/probe_torch_conv3d_k4s2.py --wgrad

times instead the weight gradient of every convolution of the flagship
UNet3D at the training batch of 32 (bf16, channels-last), as autograd asks
the library for it (``aten.convolution_backward`` with only the weight's
gradient): the four stride-2 convolutions with kernel 4 (two ``Downsample``,
two ``Upsample``) and one 3x3x3 convolution of each level, and names the
kernels each call runs with their device time (``torch.profiler``). At the
four stride-2 convolutions it also times the port's weight-gradient kernel
(``conv3d_k4s2_wgrad``, which replaces that library call; ``port_ms``),
held to the plain version first, beside its operations bound.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mrijax_torch.kernels import _build  # noqa: E402
from mrijax_torch.kernels import conv3d as cv  # noqa: E402

PEAK_FLOPS = 989e12
MAIN = [(8, 32, 40, 40, 128, 256), (8, 16, 20, 20, 256, 512)]
MORE = [(32, 32, 40, 40, 128, 256), (32, 16, 20, 20, 256, 512),
        (1, 128, 160, 160, 64, 64), (1, 64, 80, 80, 128, 128)]

SOURCE = (Path(__file__).resolve().parent.parent / "mrijax_torch/csrc/conv3d_k4s2.cu").read_text()
ANNOUNCE = "            cp_async_arrive(full);  // once this thread's pieces have landed\n"
BULK = SOURCE[SOURCE.index("            if (tid == 0) {\n                mbar_expect_tx"):
              SOURCE.index("            const int k = kt * BK + 8 * c;")]
A_LOOP = "for (int j = 0; j < A_ROWS; ++j)\n                gather_piece("
NO_A = (A_LOOP, A_LOOP.replace("j < A_ROWS", "j < 0"))
NO_B = (BULK, "            if (tid == 0) mbar_arrive(full);\n")
# (edits, whether the variant still computes the convolution)
VARIANTS = {
    "lag1": ([(ANNOUNCE, """            mma::cp_async_commit();
            if (issued++ > 0) {
                mma::cp_async_wait<1>();
                wgmma::fence_proxy_async();
                mbar_arrive(last_full);
            }
            last_full = full;
"""), ("    int s = 0;  // slot to fill\n",
       "    int s = 0;  // slot to fill\n    int issued = 0;\n    uint32_t last_full = 0;\n"),
              ("    mma::cp_async_wait<0>();\n}\n", "    mma::cp_async_wait<0>();\n"
               "    wgmma::fence_proxy_async();\n    if (issued > 0) mbar_arrive(last_full);\n}\n")],
             True),
    "no_fence": ([("            wgmma::fence_proxy_async();  // the gathered A pieces", "            // ")],
                 True),
    "no_a": ([NO_A], False),
    "no_b": ([NO_B], False),
    "no_copies": ([NO_A, NO_B], False),
    "no_products": ([("                product<BN>(acc, ", "                if (0) product<BN>(acc, ")],
                    False),
}


def build_variants():
    """One library per variant, all ``nvcc`` started together."""
    out = _build.BUILD_DIR / "probe_conv3d"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        text = SOURCE
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        src, lib = out / f"conv3d_k4s2_{name}.cu", out / f"libconv3d_k4s2_{name}.so"
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


def time_ms(fn, repeats=10):
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


def operands(b, d, h, w, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, d, h, w, cin, device="cuda", generator=g).bfloat16()
    weight = (torch.randn(cout, cin, 4, 4, 4, device="cuda", generator=g)
              / (64 * cin) ** 0.5).bfloat16().contiguous(memory_format=torch.channels_last_3d)
    bias = (0.1 * torch.randn(cout, device="cuda", generator=g)).bfloat16()
    return x, weight, bias


def at_tile(x, weight, bias, tile_n):
    """The committed kernel at another tile width than the plan's."""
    b, d, h, w, cin = x.shape
    cout = weight.shape[0]
    m = b * (d // 2) * (h // 2) * (w // 2)
    tiles = -(-m // cv.TILE_M) * -(-cout // tile_n)
    grid = -(-tiles // -(-tiles // cv.SM_COUNT))
    y = torch.empty((b, d // 2, h // 2, w // 2, cout), dtype=x.dtype, device=x.device)
    b_tiles = cv.tile_weight(weight, tile_n)
    err = cv._library().conv3d_k4s2(
        x.data_ptr(), b_tiles.data_ptr(), bias.data_ptr(), y.data_ptr(), b, d, h, w, cin,
        *x.stride()[:4], cout, tile_n, grid, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"conv3d_k4s2 at tile {tile_n}")
    return y


def check(name, got, want, bar):
    """The bar of ``chip_smoke.py``: within half a bf16 ulp of the float32
    sum, plus 1e-4 of the largest output for another order of the sum."""
    torch.cuda.synchronize()
    bad = int(((got.float() - want).abs() > bar).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} elements miss the bar")


# (name, input (B, D, H, W, C) of the forward, weight shape, transposed): the
# flagship UNet3D's convolutions at the training batch of 32
WGRAD = [
    ("down0", (32, 32, 40, 40, 128), (256, 128, 4, 4, 4), False),
    ("down1", (32, 16, 20, 20, 256), (512, 256, 4, 4, 4), False),
    ("up0", (32, 16, 20, 20, 256), (256, 128, 4, 4, 4), True),
    ("up1", (32, 8, 10, 10, 512), (512, 256, 4, 4, 4), True),
    ("conv3_level0", (32, 32, 40, 40, 128), (128, 128, 3, 3, 3), False),
    ("conv3_level1", (32, 16, 20, 20, 256), (256, 256, 3, 3, 3), False),
    ("conv3_level2", (32, 8, 10, 10, 512), (512, 512, 3, 3, 3), False),
]


def weight_gradients():
    from torch.profiler import ProfilerActivity, profile

    for name, x_shape, w_shape, transposed in WGRAD:
        k = w_shape[-1]
        stride, pad = (2, 1) if k == 4 else (1, 1)
        x = torch.randn(x_shape, device="cuda").bfloat16().permute(0, 4, 1, 2, 3)
        w = torch.randn(w_shape, device="cuda").bfloat16().contiguous(
            memory_format=torch.channels_last_3d)
        conv = F.conv_transpose3d if transposed else F.conv3d
        y = conv(x, w, None, stride, pad)
        dy = torch.randn_like(y)

        def wgrad():
            torch.ops.aten.convolution_backward(dy, x, w, None, [stride] * 3, [pad] * 3, [1] * 3,
                                                transposed, [0] * 3, 1, [False, True, False])

        ms = time_ms(wgrad)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wgrad()
            torch.cuda.synchronize()
        kernels = {e.key[:90]: round(e.self_device_time_total / 1e3, 4)
                   for e in prof.key_averages() if e.self_device_time_total > 0}
        row = {"conv": name, "input": list(x_shape), "weight": list(w_shape),
               "transposed": transposed, "wgrad_ms": ms, "kernels_ms": kernels}
        if k == 4:
            # the port's kernel on the channels-last tensors: Downsample p = dy,
            # g = x; Upsample p = x, g = dy (the large side)
            x_cl, dy_cl = x.permute(0, 2, 3, 4, 1), dy.permute(0, 2, 3, 4, 1)
            p, g = (x_cl, dy_cl) if transposed else (dy_cl, x_cl)
            want = cv.conv3d_k4s2_wgrad_reference(p.float(), g.float())
            check(f"{name} wgrad", cv.conv3d_k4s2_wgrad(p, g), want,
                  2 ** -8 * want.abs() + 1e-4 * want.abs().max())
            del want
            row["port_ms"] = time_ms(lambda: cv.conv3d_k4s2_wgrad(p, g))
            row["bound_ms"] = cv.operations(g.shape, p.shape[-1], bias=False) / PEAK_FLOPS * 1e3
            m = p.numel() // p.shape[-1]
            row["plan"] = list(vars(cv.wgrad_plan(m, p.shape[-1], g.shape[-1])).values())
        print(json.dumps(row), flush=True)
        del x, w, y, dy
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", choices=("main", "all"), default="main")
    parser.add_argument("--wgrad", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    if args.wgrad:
        weight_gradients()
        return 0
    committed = cv._library()
    variants = {name: ctypes.CDLL(str(path)) for name, path in build_variants().items()}
    for lib in variants.values():
        lib.conv3d_k4s2.argtypes = committed.conv3d_k4s2.argtypes
        lib.conv3d_k4s2.restype = committed.conv3d_k4s2.restype
    for shape in MAIN + (MORE if args.shapes == "all" else []):
        x, weight, bias = operands(*shape)
        want = cv.conv3d_k4s2_reference(x.float(), weight.float(), bias.float())
        bar = 2 ** -8 * want.abs() + 1e-4 * want.abs().max()
        check(f"{shape} kernel", cv.conv3d_k4s2(x, weight, bias), want, bar)
        for tile_n in cv.TILE_N:
            check(f"{shape} tile {tile_n}", at_tile(x, weight, bias, tile_n), want, bar)
        for name, lib in variants.items():
            if VARIANTS[name][1]:
                _build._loaded["conv3d_k4s2"] = lib
                check(f"{shape} {name}", cv.conv3d_k4s2(x, weight, bias), want, bar)
        _build._loaded["conv3d_k4s2"] = committed
        del want, bar
        flops = cv.operations(shape[:5], shape[5])
        plan = cv.launch_plan(shape[0] * shape[1] * shape[2] * shape[3] // 8, shape[5])
        row = {"shape": list(shape), "plan": [plan.tile_n, plan.tiles, plan.waves, plan.grid],
               "bound_ms": flops / PEAK_FLOPS * 1e3,
               "kernel_ms": time_ms(lambda: cv.conv3d_k4s2(x, weight, bias))}
        for tile_n in cv.TILE_N:
            if tile_n != plan.tile_n:
                row[f"tile_{tile_n}_ms"] = time_ms(lambda: at_tile(x, weight, bias, tile_n))
        for name, lib in variants.items():
            _build._loaded["conv3d_k4s2"] = lib
            row[f"{name}_ms"] = time_ms(lambda: cv.conv3d_k4s2(x, weight, bias))
        _build._loaded["conv3d_k4s2"] = committed
        x_cf = x.permute(0, 4, 1, 2, 3)
        row["library_ms"] = time_ms(lambda: F.conv3d(x_cf, weight, bias, 2, 1))
        cols = cv.im2col(x)
        packed_t = cv.pack_weight(weight).t()
        row["gemm_ms"] = time_ms(lambda: torch.matmul(cols, packed_t))
        del cols
        row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
        print(json.dumps(row), flush=True)
        del x, weight, bias
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
