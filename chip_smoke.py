#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mrijax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, needs one card
    python3 chip_smoke.py --kernels-only   # build + compare + time the kernels
    python3 chip_smoke.py --profile        # also a torch.profiler breakdown

What it does, in order:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds every kernel of ``mrijax_torch/csrc`` with ``nvcc``;
2. calls each kernel's wrapper on CUDA tensors at the shapes the main path
   gives it (fp32 and bf16, plus ragged sizes) and holds the result against
   the kernel's plain PyTorch version on the same inputs;
3. times kernel, plain version and — as a yardstick only, the port never calls
   it — the one PyTorch call that computes the same function, with CUDA
   events (warm-up, then the median of ``REPEATS`` single calls, device time
   only), beside the least time the card could take (bytes / 3.35 TB/s or
   flops / peak rate), and the host's time to issue one wrapper call;
4. checks a small float32 pipeline on the card (kernels) against the same
   pipeline on the CPU (plain versions);
5. drives the main path at full width: the flagship ``UNet3D`` (base 128,
   mults (1, 2, 4), bottleneck attention with 4 heads of 128) and ``VAE3D``
   (base 32, 3 levels, 16 latent channels) in bf16 with seeded random weights
   through ``generate_3d_volumes`` — 2 volumes, 20 DDIM steps out of the
   T = 400 cosine schedule, decode to (2, 128, 160, 160, 4) — with the launch
   counts set to 0 just before and read just after.

Any miss raises: the script exits non-zero and prints no result line. It
exits non-zero at once where ``torch.cuda.is_available()`` is false. TF32 is
switched off for convolutions and matrix products, so float32 comparisons are
float32. The last line is ``{"ok": true, "device": {...}}``; the line before
names the card; the line before that is the ``{"kernels": [...]}`` record.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
from mrijax_torch.generate import generate_3d_volumes
from mrijax_torch.kernels import _build
from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.kernels import groupnorm as gn
from mrijax_torch.models import UNet3D, VAE3D
from mrijax_torch.models.blocks import Conv3d, Downsample, Upsample

SEED = 0
REPEATS = 15
SPIN_CYCLES = 2_000_000   # ~1 ms of spinning: longer than the host needs to issue any timed call
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; fp32 outside tensor cores

DDIM_STEPS = 20
NUM_VOLUMES = 2
LATENT_SPATIAL = (32, 40, 40)
LATENT_CHANNELS = 16
T_STEPS = 400
GROUPS = 8

# GroupNorm+SiLU call sites of the main path: (N, C) -> (calls per UNet3D
# forward, calls per VAE3D decode), from the topology of the two models.
GN_MAIN_PATH = {
    (51200, 128): (8, 3),
    (51200, 256): (1, 0),
    (6400, 256): (7, 0),
    (6400, 512): (1, 0),
    (800, 512): (11, 0),
    (800, 1024): (1, 0),
    (51200, 64): (0, 1),
    (409600, 64): (0, 3),
    (409600, 32): (0, 1),
    (3276800, 32): (0, 2),
}
GN_CALLS_PER_UNET = sum(u for u, _ in GN_MAIN_PATH.values())     # 29
GN_CALLS_PER_DECODE = sum(d for _, d in GN_MAIN_PATH.values())   # 10
GN_RAGGED = [(1000, 64), (333, 24)]   # ragged N; C=24 gives 3 channels a group (scalar loads)
GN_BIG = (3276800, 32)                # compared at B = 1, the others at B = 2
FLASH_MAIN = (NUM_VOLUMES, 800, 4, 128)
FLASH_OTHER = [(1, 1000, 2, 32), (1, 130, 3, 64)]
FLASH_LONG = (1, 51200, 4, 32)   # attention at full latent resolution (attention_levels=(0,))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median device time of one ``fn()`` in ms. Each sample puts a spin
    kernel on the stream first, so the host has issued all of ``fn``'s
    launches before the card reaches the start event: the time between the
    two events is the card's alone, without the host's launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_issue_us(fn, calls: int = 200) -> float:
    """Host time to issue one ``fn()`` in µs: ``calls`` back-to-back calls on
    the host clock, not waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def check_close(name, got, want, atol, rtol=0.0) -> float:
    """Raise unless |got - want| <= atol + rtol*|want| everywhere; returns the
    largest absolute difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{name}: got {got.dtype} {tuple(got.shape)}, want {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (g - w).abs_()
    worst = float(err.max())
    if bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{name}: max abs err {worst:.3e} exceeds atol {atol} + rtol {rtol}")
    return worst


# ------------------------------------------------------------------ phase 2/3


def gn_inputs(rng, b, n, c):
    x = torch.from_numpy(rng.standard_normal((b, n, c), dtype=np.float32)).cuda()
    x.mul_(1.5).add_(0.3)
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(c, dtype=np.float32)).cuda()
    bias = torch.from_numpy(0.1 * rng.standard_normal(c, dtype=np.float32)).cuda()
    return x, scale, bias


def compare_groupnorm(rng):
    """Both GroupNorm+SiLU kernels against their plain versions.

    Tolerances: float32 2e-5 absolute (the tolerance of the JAX package's own
    kernel test; the sums are taken in another order). bf16 outputs: 1e-2
    relative + 1e-5, one bf16 ulp — both sides compute in fp32 and round once,
    so they differ by at most the last bit. Statistics are fp32 for either
    input type and held to 2e-5.
    """

    worst = {"gn_silu_stats": {"float32": 0.0, "bfloat16": 0.0},
             "gn_silu_apply": {"float32": 0.0, "bfloat16": 0.0}}
    cases = [(2, n, c) for (n, c) in GN_MAIN_PATH if (n, c) != GN_BIG]
    cases += [(1, *GN_BIG)] + [(2, n, c) for n, c in GN_RAGGED]
    for b, n, c in cases:
        x32, scale, bias = gn_inputs(rng, b, n, c)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            key = str(dtype).replace("torch.", "")
            tag = f"groupnorm {key} ({b},{n},{c})"
            stats = gn.gn_silu_stats(x, GROUPS)
            e1 = check_close(f"{tag} stats", stats,
                             gn.gn_silu_stats_reference(x, GROUPS), atol=2e-5)
            y = gn.gn_silu_apply(x, stats, scale, bias)
            tol = dict(atol=2e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=1e-2)
            e2 = check_close(f"{tag} apply", y,
                             gn.gn_silu_apply_reference(x, stats, scale, bias), **tol)
            fused = gn.group_norm_silu_fused(x, scale, bias, GROUPS)
            check_close(f"{tag} fused", fused,
                        gn.group_norm_silu_reference(x, scale, bias, GROUPS), **tol)
            worst["gn_silu_stats"][key] = max(worst["gn_silu_stats"][key], e1)
            worst["gn_silu_apply"][key] = max(worst["gn_silu_apply"][key], e2)
            del x, stats, y, fused
        del x32
    torch.cuda.synchronize()
    print(f"compare groupnorm: {len(cases)} shapes x 2 dtypes ok, max abs err {json.dumps(worst)}")
    return worst


def flash_inputs(rng, shape, dtype):
    """q, k, v as strided slices of one (B, N, 3, H, Dh) buffer — the layout
    the attention block hands to the kernel."""
    b, n, h, d = shape
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d), dtype=np.float32))
    qkv = qkv.cuda().to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def compare_flash(rng):
    """The flash-attention kernel against its plain version.

    Tolerances: float32 1e-4 absolute on out and lse — the kernel sums over
    keys tile by tile against a running max, the plain version at once. bf16:
    lse (fp32 on both sides) 1e-4; out 2e-3 + 1e-2 relative — each side rounds
    its unnormalised probabilities to bf16 against another max (running vs
    final) and the output once more, a few bf16 ulps of an output of size
    ~0.1.
    """

    worst = {"float32": 0.0, "bfloat16": 0.0}
    shapes = [FLASH_MAIN] + FLASH_OTHER
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).replace("torch.", "")
            q, k, v = flash_inputs(rng, shape, dtype)
            out, lse = fa.flash_attention_forward(q, k, v)
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
            tol = dict(atol=1e-4) if dtype == torch.float32 else dict(atol=2e-3, rtol=1e-2)
            e = check_close(f"flash {key} {shape} out", out, ref_out, **tol)
            check_close(f"flash {key} {shape} lse", lse, ref_lse, atol=1e-4)
            worst[key] = max(worst[key], e)
    # N = 51 200: the plain version cannot hold N x N logits, but query rows
    # are independent, so it is run on chunks of the queries against all keys
    # (float32, 1e-5 on out: its values are of size ~0.01 at this length)
    q, k, v = flash_inputs(rng, FLASH_LONG, torch.float32)
    out, lse = fa.flash_attention_forward(q, k, v)
    heads = FLASH_LONG[2]
    for start in range(0, FLASH_LONG[1], 4096):
        rows = slice(start, start + 4096)
        ref_out, ref_lse = fa.flash_attention_reference(q[:, rows], k, v)
        e = check_close(f"flash float32 {FLASH_LONG} out rows {start}+", out[:, rows],
                        ref_out, atol=1e-5)
        check_close(f"flash float32 {FLASH_LONG} lse rows {start}+",
                    lse.view(heads, -1)[:, rows], ref_lse, atol=1e-4)
        worst["float32"] = max(worst["float32"], e)
    torch.cuda.synchronize()
    print(f"compare flash: {len(shapes)} shapes x 2 dtypes and float32 {FLASH_LONG} ok, "
          f"max abs err {json.dumps(worst)}")
    return worst


def time_groupnorm(rng):
    """Per main-path shape (bf16, B = 2): both kernels, their plain versions,
    the library yardsticks and the bytes bound."""

    rows = []
    for (n, c), (per_unet, per_decode) in GN_MAIN_PATH.items():
        b = NUM_VOLUMES
        x32, scale, bias = gn_inputs(rng, b, n, c)
        x = x32.to(torch.bfloat16)
        del x32
        stats = gn.gn_silu_stats(x, GROUPS)
        nbytes = x.numel() * x.element_size()
        # channels-first view of the same buffer for the library calls
        x_cf = x.view(b, n, 1, c).permute(0, 3, 1, 2)
        xg = x.view(b, n, GROUPS, c // GROUPS)
        row = {
            "shape": [b, n, c], "dtype": "bfloat16",
            "calls_per_unet_forward": per_unet, "calls_per_decode": per_decode,
            "stats_ms": time_ms(lambda: gn.gn_silu_stats(x, GROUPS)),
            "stats_plain_ms": time_ms(lambda: gn.gn_silu_stats_reference(x, GROUPS)),
            "stats_library_ms": time_ms(
                lambda: torch.var_mean(xg, dim=(1, 3), correction=0)),
            "stats_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "apply_ms": time_ms(lambda: gn.gn_silu_apply(x, stats, scale, bias)),
            "apply_plain_ms": time_ms(
                lambda: gn.gn_silu_apply_reference(x, stats, scale, bias)),
            "apply_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
            "fused_ms": time_ms(
                lambda: gn.group_norm_silu_fused(x, scale, bias, GROUPS)),
            "fused_plain_ms": time_ms(
                lambda: gn.group_norm_silu_reference(x, scale, bias, GROUPS)),
            "fused_library_ms": time_ms(
                lambda: F.silu(F.group_norm(x_cf, GROUPS, scale.to(x.dtype),
                                            bias.to(x.dtype), 1e-5))),
            "fused_bound_ms": 3 * nbytes / HBM_BYTES_PER_S * 1e3,
            "fused_host_issue_us": host_issue_us(
                lambda: gn.group_norm_silu_fused(x, scale, bias, GROUPS)),
        }
        rows.append(row)
        del x, stats, x_cf, xg
    print("groupnorm_times " + json.dumps(rows))
    return rows


def time_flash(rng):

    rows = []
    for shape, dtype in ((FLASH_MAIN, torch.bfloat16), (FLASH_MAIN, torch.float32),
                         (FLASH_OTHER[0], torch.bfloat16)):
        b, n, h, d = shape
        key = str(dtype).replace("torch.", "")
        q, k, v = flash_inputs(rng, shape, dtype)
        qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, Dh) views
        flops = 4 * b * h * n * n * d
        nbytes = 4 * b * n * h * d * q.element_size() + 4 * b * h * n
        t_flops = flops / PEAK_FLOPS[key] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "shape": list(shape), "dtype": key,
            "ms": time_ms(lambda: fa.flash_attention_forward(q, k, v)),
            "plain_ms": time_ms(lambda: fa.flash_attention_reference(q, k, v)),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            "bound_ms": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "host_issue_us": host_issue_us(lambda: fa.flash_attention_forward(q, k, v)),
        })
    print("flash_times " + json.dumps(rows))
    return rows


# -------------------------------------------------------------------- phase 4


def seeded_weights(model, seed):
    """Small-normal convolution and linear parameters from a seed; GroupNorm
    keeps scale 1 and bias 0. Values do not matter for timing."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dtype == torch.float32 and p.dim() == 1 and "norm" in name:
                continue
            p.copy_(0.02 * torch.randn(p.shape, generator=gen, dtype=torch.float32))
    return model


def small_pipeline_check():
    """A small float32 UNet3D + VAE3D through generate_3d_volumes on the card
    (kernels) and on the CPU (plain versions) from the same start noise.
    Tolerance 1e-3 absolute: float32 sums in another order, compounding over
    5 DDIM steps and the decoder."""

    unet = seeded_weights(UNet3D(in_channels=4, base_channels=16, channel_mults=(1, 2),
                                 time_emb_dim=32, num_heads=1), SEED + 1)
    vae = seeded_weights(VAE3D(in_channels=2, base_channels=16, num_down=2,
                               latent_channels=4), SEED + 2)
    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(20)))
    x_t = torch.from_numpy(
        np.random.default_rng(SEED).standard_normal((2, 8, 8, 8, 4), dtype=np.float32))
    kw = dict(num_volumes=2, latent_spatial=(8, 8, 8), latent_channels=4,
              ddim_steps=5, x_t=x_t)
    gn.launches.reset()
    fa.launches.reset()
    on_card = generate_3d_volumes(unet, vae, diffusion, device="cuda", **kw).cpu()
    counts = {**gn.launches.as_dict(), **fa.launches.as_dict()}
    if min(counts.values()) == 0:
        raise AssertionError(f"small pipeline skipped a kernel: {counts}")
    on_cpu = generate_3d_volumes(unet, vae, diffusion, device="cpu", **kw)
    err = check_close("small pipeline, card vs CPU", on_card, on_cpu, atol=1e-3)
    print(f"small pipeline (fp32, card kernels vs CPU plain): max abs err {err:.3e} ok")


def layout_check():
    """The convolutions must answer in channels-last memory, or every block
    would pay a hidden copy before the GroupNorm kernel."""

    x = torch.randn(1, 8, 10, 10, 64, device="cuda", dtype=torch.bfloat16)
    for mod in (Conv3d(64, 32, 3, padding=1, dtype=torch.bfloat16),
                Conv3d(64, 128, 1, dtype=torch.bfloat16),
                Downsample(64, 128, torch.bfloat16), Upsample(64, 32, torch.bfloat16)):
        mod = mod.cuda().to(memory_format=torch.channels_last_3d)
        base = (torch.nn.ConvTranspose3d if isinstance(mod, torch.nn.ConvTranspose3d)
                else torch.nn.Conv3d)
        with torch.no_grad():
            y = base.forward(mod, x.permute(0, 4, 1, 2, 3))
        if not y.permute(0, 2, 3, 4, 1).is_contiguous():
            raise AssertionError(
                f"{type(mod).__name__} answered with strides {y.stride()}: not channels-last")
    print("layout: Conv3d / Downsample / Upsample answer channels-last, no copy")


def build_flagship():
    """The flagship pair at full width, bf16, seeded random weights, on the card."""

    unet = seeded_weights(UNet3D(
        in_channels=LATENT_CHANNELS, base_channels=128, channel_mults=(1, 2, 4),
        use_attention=True, num_heads=4, time_emb_dim=256, dtype=torch.bfloat16,
    ), SEED + 1).cuda().eval()
    vae = seeded_weights(VAE3D(
        in_channels=4, base_channels=32, num_down=3, latent_channels=LATENT_CHANNELS,
        dtype=torch.bfloat16,
    ), SEED + 2).cuda().eval()
    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(T_STEPS))).to("cuda")
    return unet, vae, diffusion


def profile_main_path(unet, vae, diffusion):
    """``--profile``: where the device time of 5 DDIM steps and one decode
    goes, by kernel name, and how much of the wall time the card was busy."""
    shape = (NUM_VOLUMES, *LATENT_SPATIAL, LATENT_CHANNELS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    windows = {}
    with torch.no_grad():
        for name, fn in (
            ("ddim_5_steps", lambda: diffusion.ddim_sample(unet, shape, gen, num_steps=5)),
            ("decode", lambda: vae.decode_from_latent(
                torch.zeros(shape, device="cuda", dtype=torch.float32))),
        ):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rows = []
            for evt in prof.key_averages():
                dev_us = getattr(evt, "self_device_time_total",
                                 getattr(evt, "self_cuda_time_total", 0))
                if dev_us > 0 and evt.device_type.name != "CPU":
                    rows.append((dev_us / 1e3, evt.count, evt.key))
            rows.sort(reverse=True)
            busy_ms = sum(r[0] for r in rows)
            windows[name] = {
                "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
                "top": [{"ms": r[0], "count": r[1], "kernel": r[2][:90]} for r in rows[:14]],
            }
    print("profile " + json.dumps(windows))


def main_path(unet, vae, diffusion):

    n_params = sum(p.numel() for p in unet.parameters())

    # warm-up outside the count: cuDNN picks its algorithms, the allocator grows
    warm = torch.Generator(device="cuda").manual_seed(SEED + 3)
    generate_3d_volumes(unet, vae, diffusion, num_volumes=NUM_VOLUMES,
                        latent_spatial=LATENT_SPATIAL, latent_channels=LATENT_CHANNELS,
                        ddim_steps=2, generator=warm)
    torch.cuda.synchronize()

    # timed separately first, so that step and decode times are known apart
    shape = (NUM_VOLUMES, *LATENT_SPATIAL, LATENT_CHANNELS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        t0 = time.perf_counter()
        z = diffusion.ddim_sample(unet, shape, gen, num_steps=DDIM_STEPS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vae.decode_from_latent(z)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    del z

    # the counted run: the entry point a user calls, counts at 0 just before
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    gn.launches.reset()
    fa.launches.reset()
    t3 = time.perf_counter()
    vols = generate_3d_volumes(
        unet, vae, diffusion, num_volumes=NUM_VOLUMES, latent_spatial=LATENT_SPATIAL,
        latent_channels=LATENT_CHANNELS, ddim_steps=DDIM_STEPS, generator=gen,
    )
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    counts = {**gn.launches.as_dict(), **fa.launches.as_dict()}
    peak = torch.cuda.max_memory_allocated()

    want_gn = DDIM_STEPS * GN_CALLS_PER_UNET + GN_CALLS_PER_DECODE
    want = {"gn_silu_stats": want_gn, "gn_silu_apply": want_gn, "flash_attn_fwd": DDIM_STEPS}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if tuple(vols.shape) != (NUM_VOLUMES, 128, 160, 160, 4) or vols.dtype != torch.float32:
        raise AssertionError(f"output {vols.dtype} {tuple(vols.shape)}")
    if not vols.is_cuda or not bool(torch.isfinite(vols).all()):
        raise AssertionError("output not on the card or not finite")
    result = {
        "volumes": NUM_VOLUMES, "ddim_steps": DDIM_STEPS, "dtype": "bfloat16",
        "unet_params": n_params,
        "seconds_per_ddim_step": (t1 - t0) / DDIM_STEPS,
        "decode_seconds": t2 - t1,
        "generate_3d_volumes_seconds": t4 - t3,
        "peak_memory_bytes": peak,
        "launches": counts,
        "output_std": float(vols.std()),
    }
    print("main_path " + json.dumps(result))
    return result


# ----------------------------------------------------------------------- main


def kernel_records(gn_worst, flash_worst, gn_rows, flash_rows, counts):
    """One record per kernel, at its heaviest main-path shape in bf16."""
    big = max(gn_rows, key=lambda r: r["shape"][0] * r["shape"][1] * r["shape"][2])
    fl = flash_rows[0]
    src_gn = "mrijax_torch/csrc/groupnorm_silu.cu"
    return [
        {"name": "gn_silu_stats", "route": "cuda", "source": src_gn,
         "replaces": "mrijax/kernels/groupnorm_pallas.py:120",
         "launches": counts["gn_silu_stats"], "shape": big["shape"], "dtype": "bfloat16",
         "max_abs_err": gn_worst["gn_silu_stats"]["float32"],
         "max_abs_err_bf16": gn_worst["gn_silu_stats"]["bfloat16"],
         "ms": big["stats_ms"], "plain_ms": big["stats_plain_ms"],
         "bound_ms": big["stats_bound_ms"], "bound_by": "bytes",
         "library_ms": big["stats_library_ms"]},
        {"name": "gn_silu_apply", "route": "cuda", "source": src_gn,
         "replaces": "mrijax/kernels/groupnorm_pallas.py:135",
         "launches": counts["gn_silu_apply"], "shape": big["shape"], "dtype": "bfloat16",
         "max_abs_err": gn_worst["gn_silu_apply"]["float32"],
         "max_abs_err_bf16": gn_worst["gn_silu_apply"]["bfloat16"],
         "ms": big["apply_ms"], "plain_ms": big["apply_plain_ms"],
         "bound_ms": big["apply_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "mrijax_torch/csrc/flash_attention_fwd.cu",
         "replaces": "mrijax/kernels/flash_attention_pallas.py:162",
         "launches": counts["flash_attn_fwd"], "shape": fl["shape"], "dtype": fl["dtype"],
         "max_abs_err": flash_worst["float32"], "max_abs_err_bf16": flash_worst["bfloat16"],
         "ms": fl["ms"], "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
         "bound_by": fl["bound_by"], "library_ms": fl["library_ms"]},
    ]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after building, comparing and timing the kernels "
                             "(prints no result line)")
    parser.add_argument("--profile", action="store_true",
                        help="after the main path, print a torch.profiler breakdown "
                             "of 5 DDIM steps and one decode by kernel")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1


    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(libs))})")
    for name in sorted(libs):
        log = _build.build_log(name)
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill", log)]
        print(f"  ptxas {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers, at most {max(spills, default=0)} bytes spilled")

    rng = np.random.default_rng(SEED)
    gn_worst = compare_groupnorm(rng)
    flash_worst = compare_flash(rng)
    gn_rows = time_groupnorm(rng)
    flash_rows = time_flash(rng)
    torch.cuda.empty_cache()
    if args.kernels_only:
        return 0

    layout_check()
    small_pipeline_check()
    unet, vae, diffusion = build_flagship()
    result = main_path(unet, vae, diffusion)
    if args.profile:
        profile_main_path(unet, vae, diffusion)

    print(json.dumps({"kernels": kernel_records(
        gn_worst, flash_worst, gn_rows, flash_rows, result["launches"])}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
