#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mrijax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, needs one card
    python3 chip_smoke.py --kernels-only   # build + compare + time the kernels
    python3 chip_smoke.py --profile        # also torch.profiler breakdowns

What it does, in order:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, builds every kernel of ``mrijax_torch/csrc`` with ``nvcc``, and
   prints what ``ptxas`` says of the tensor-core kernels and how many ``HMMA``
   instructions ``cuobjdump -sass`` finds in the two flash-attention libraries
   and in each tensor-core kernel (none is a failure);
2. calls each kernel's wrapper on CUDA tensors at the shapes the main path
   gives it (fp32 and bf16, plus ragged sizes) and holds the result against
   the kernel's plain PyTorch version on the same inputs;
3. times kernel, plain version and — as a yardstick only, the port never calls
   it — the one PyTorch call that computes the same function, with CUDA
   events (warm-up, then the median of ``REPEATS`` single calls, device time
   only), beside the least time the card could take (bytes / 3.35 TB/s or
   flops / peak rate), and the host's time to issue one wrapper call; the
   flash kernels also at N = 51 200 (4 heads of 32), with the rate of the
   exponentials beside the operations bound; GroupNorm+SiLU also weighted by
   its calls in one generate call; with ``--profile``, checks under
   ``torch.profiler`` that a ``gn_silu_stats`` call is one kernel launch;
4. checks a small float32 pipeline on the card (kernels) against the same
   pipeline on the CPU (plain versions);
5. drives the generation path at full width: the flagship ``UNet3D`` (base
   128, mults (1, 2, 4), bottleneck attention with 4 heads of 128) and
   ``VAE3D`` (base 32, 3 levels, 16 latent channels) in bf16 with seeded random
   weights through ``generate_3d_volumes`` — 2 volumes, 20 DDIM steps out of
   the T = 400 cosine schedule, decode to (2, 128, 160, 160, 4) — with the
   launch counts set to 0 just before and read just after;
6. checks 3 cached-latent training steps of a narrow float32 UNet on the card
   (kernels, forward and backward) against the same steps on the CPU (plain
   versions);
7. drives the training path at full width: the flagship ``UNet3D`` with
   float32 parameters and bf16 compute, min-SNR loss, Adam lr 1e-4, EMA 0.999,
   batch 8 of seeded latents (8, 32, 40, 40, 16) through
   ``make_cached_latent_train_step`` — 2 warm-up steps, then 5 counted steps,
   once without rematerialisation and once with ``remat_levels=(0,)`` — again
   with the launch counts set to 0 just before the counted steps and read just
   after;
8. drives the same training through the runtime (``trainer_path``):
   ``preset_ddpm_3d_ldm`` through ``train.experiments._trainer`` and
   ``Trainer`` for 2 epochs of 3 train and 1 val batches, straight (run A) and
   with a real SIGUSR1 at epoch 1, step 0 followed by a resume from the
   checkpoint (run B), each with the launch counts set to 0 just before and
   read just after; checks exact counts, the same draws, states and learning
   rates of the two runs, and a bitwise ``restore_host`` of the last
   checkpoint, and prints seconds per step, bytes and seconds per save, and
   peak memory;
9. checks the 2D family small (``small_2d_check``): a float32 UNet2D through
   ``sample_2d`` (plain and guided), a 2.5D one through both pseudo-3D
   generators over a seeded subject of 6 slices, and 3 steps of
   ``make_diffusion_train_step``, on the card against the CPU;
10. drives the 2D serving path at full width (``path_2d``):
   ``preset_slice_cond_2d``'s UNet2D (base 64, mults (1, 2, 4, 8), bf16
   weights, T = 1000 linear) through ``sample_2d`` (64 images at 128², 20
   DDIM steps, plain and with guidance 3) and ``sample_pseudo3d_sweep`` (155
   slices, 10 DPM-Solver steps); then the 2.5D path (``path_25d``):
   ``preset_ddpm_25d``'s model over a seeded subject of 155 slices through
   ``generate_pseudo3d_real_context`` (one chunk, 20 DDIM steps) and
   ``generate_pseudo3d_hybrid`` (its first 8 slices, 10 steps, batch 1) —
   each call with the launch counts set to 0 just before and read just after,
   29 launches of each GroupNorm kernel per forward;
11. drives the 2D training path at full width (``train_path_2d``): both
   presets' models through ``make_diffusion_train_step`` at batch 64 (bf16
   compute, float32 parameters, Adam 2e-4, EMA 0.999, guidance dropout 0.1),
   2 warm-up and 5 counted steps each, the 2.5D batches with their context;
12. drives the data pipeline and the experiment drivers from BraTS files on
   disk (``driver_path``): 10 cases at 240×240×155 per modality (3 subjects
   written by ``data.synthetic``, copied under 7 more names), split with
   ``split_subjects`` / ``apply_split``, packed with ``pack_volumes`` and, on
   the card, ``pack_dataset`` and ``pack_multimodal_slices``; the loaders'
   host seconds per batch, raw NIfTI against packed; ``preprocess_slice_batch``
   and a small ``pack_latents`` on the card against the CPU; then
   ``run_experiment`` on ``configs/ddpm_3d_ldm_tuned.json`` (both stages,
   ``pack_latents`` of the 10 whole volumes, cut to 3 steps and 1 epoch a
   stage and a latent batch of 8), the same call again (both stages resume,
   the cache is reused), and on ``preset_slice_cond_2d`` and
   ``preset_ddpm_25d`` (batch 64, 3 steps). Each stage's steps and kernel
   launches are exact (counted from 0 at the stage's start), its losses
   finite; one train step a stage is profiled for the card's busy share.

The GroupNorm phases (2, 3) also take the UNet2D's seven (N, C) shapes:
compared at B = 2 and once at B = 310, timed at the presets' batch of 64 and
summed over one forward (``groupnorm_per_unet2d_forward``).

Any miss raises: the script exits non-zero and prints no result line. It
exits non-zero at once where ``torch.cuda.is_available()`` is false. TF32 is
switched off for convolutions and matrix products, so float32 comparisons are
float32. The last line is ``{"ok": true, "device": {...}}``; the line before
names the card; the line before that is the ``{"kernels": [...]}`` record,
and before it the ``driver_path`` line.
"""

import argparse
import copy
import dataclasses
import gc
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mrijax_torch.config import (
    ExperimentConfig,
    preset_ddpm_25d,
    preset_ddpm_3d_ldm,
    preset_slice_cond_2d,
)
from mrijax_torch.data import (
    BatchLoader,
    PackedSliceDataset,
    PackedVolumeDataset,
    SliceDataset2D,
    VolumeDataset3D,
    apply_split,
    nifti,
    pack_dataset,
    pack_latents,
    pack_multimodal_slices,
    pack_volumes,
    preprocess_slice_batch,
    split_subjects,
)
from mrijax_torch.data.packing import latent_cache_is_stale, latent_source_files, params_fingerprint
from mrijax_torch.data.synthetic import MODALITIES, write_synthetic_brats
from mrijax_torch.diffusion import (
    GaussianDiffusion,
    cosine_beta_schedule,
    linear_beta_schedule,
    make_schedule,
)
from mrijax_torch.generate import (
    generate_3d_volumes,
    generate_pseudo3d_hybrid,
    generate_pseudo3d_real_context,
    sample_2d,
    sample_pseudo3d_sweep,
)
from mrijax_torch.io import load_state
from mrijax_torch.kernels import _build
from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.kernels import groupnorm as gn
from mrijax_torch.models import UNet2D, UNet3D, VAE3D
from mrijax_torch.models.blocks import Conv3d, Downsample, Upsample
from mrijax_torch.obs import MetricsLogger, install_signal_handlers, reset_termination
from mrijax_torch.ops.attention import multi_head_self_attention
from mrijax_torch.ops.norms import group_norm_silu
from mrijax_torch.train import (
    Trainer,
    create_train_state,
    estimate_latent_scale_from_latents,
    fixed_validation_timesteps,
    make_cached_latent_eval_step,
    make_cached_latent_train_step,
    make_diffusion_train_step,
    sample_timesteps,
)
from mrijax_torch.train import experiments
from mrijax_torch.train.experiments import _trainer, build_diffusion, build_unet2d, build_unet3d

SEED = 0
REPEATS = 15
SPIN_CYCLES = 2_000_000   # ~1 ms of spinning: longer than the host needs to issue any timed call
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; fp32 outside tensor cores
EXP_PER_S = 132 * 16 * 1.98e9   # special-function units: 16 ex2 a clock on each of 132 SMs at the 1.98 GHz boost clock
LONG_REPEATS = 5                # timed calls at N = 51 200

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
GN_BIG = (3276800, 32)                # compared at B = 1; the others at B = 2 and, where the
                                      # UNet calls them, at the training batch
FLASH_MAIN = (NUM_VOLUMES, 800, 4, 128)
FLASH_OTHER = [(1, 1000, 2, 32), (1, 130, 3, 64), (1, 17, 2, 64)]   # the last: N smaller than a tile
FLASH_LONG = (1, 51200, 4, 32)   # attention at full latent resolution (attention_levels=(0,))

TRAIN_BATCH = 8
TRAIN_WARMUP_STEPS = 2
TRAIN_STEPS = 5
FLASH_TRAIN = (TRAIN_BATCH, 800, 4, 128)
ONE_ULP = dict(atol=1e-5, rtol=2 ** -7)    # bf16 dk and dv: rounded once
TWO_ULPS = dict(atol=1e-5, rtol=2 ** -6)   # bf16 dq: rounded twice, around the Dh^-1/2 multiply
GN_REMAT_LEVEL0_CALLS = 8         # 4 res blocks at level 0, two norms each, run again in the backward
GN_GRAD_SHAPES = [(51200, 128), (800, 512)]
GENERATION_KERNELS = ("gn_silu_stats", "gn_silu_apply", "flash_attn_fwd")

# The 2D and 2.5D families (presets slice_cond_2d and ddpm_25d): UNet2D base 64,
# mults (1, 2, 4, 8), time dim 256, at 128². GroupNorm+SiLU call sites of one
# forward: (N, C) -> calls, from the topology (down path at 128², 64², 32²;
# the bottleneck at 16²; the up path back; the head).
GN_UNET2D = {
    (16384, 128): 4,
    (4096, 256): 4,
    (1024, 512): 4,
    (256, 512): 4,
    (1024, 256): 4,
    (4096, 128): 4,
    (16384, 64): 5,
}
GN_CALLS_PER_UNET2D = sum(GN_UNET2D.values())   # 29
GN_2D_WIDEST_BATCH = (310, 16384, 64)    # the guided sweep's batch at the 8-channel groups
IMAGE_SIZE = 128
BATCH_2D = 64                     # the presets' batch: training and grid sampling
DDIM_STEPS_2D = 20
SWEEP_SLICES = 155
SWEEP_STEPS = 10                  # dpm
GUIDANCE = 3.0
HYBRID_SLICES = 8
HYBRID_STEPS = 10

TRAINER_EPOCHS = 2
TRAINER_TRAIN_BATCHES = 3
TRAINER_VAL_BATCHES = 1
PREEMPT_AT = (1, 0)               # (epoch, step) at which run B gets its SIGUSR1
RUN_TOL = 1e-3                    # relative: two runs of the same steps on the card

# The data pipeline and the experiment drivers (driver_path): a BraTS tree on
# disk through the packers and run_experiment, every family.
BRATS_SHAPE = (240, 240, 155)     # (H, W, D) of one BraTS modality
DRIVER_SUBJECTS = 3               # written (about 9 s of gzip each); the other cases copy them
DRIVER_CASES = 10
DRIVER_STEPS = 3                  # debug_max_steps of every stage
DRIVER_LATENT_BATCH = 8           # the tuned 32 needs >= 36 cases in the train split
DRIVER_VAL_FRACTION_2D = 0.25     # 64 of the 256 debug items: one full validation batch
TUNED_CONFIG = Path(__file__).resolve().parent / "configs" / "ddpm_3d_ldm_tuned.json"
# the flagship as the tuned recipe has it: VAE (base, levels, latent channels, remat),
# UNet (base, mults, attention, heads, remat levels, dtype), T, loss, cache_latents,
# nan_guard, patch
TUNED_MODEL = (32, 3, 16, True, 128, (1, 2, 4), True, 4, (0,), "bfloat16", 400, "min_snr",
               True, True, (128, 160, 160))
GN_VAE_FORWARD = 20               # VAE3D with 3 levels: 5 res blocks in the encoder, 5 in the
GN_VAE_ENCODE = 10                # decoder, two norms each (remat runs them again in the backward)
PREPROCESS_ATOL = 1e-5            # float32 per-slice statistics, card against CPU
PACK_LATENTS_ATOL = 1e-4          # a float32 VAE: kernels and cuDNN against the plain CPU versions
FINGERPRINT_RTOL = 1e-6           # the freshness bar of latent_cache_is_stale
SMALL_VAE_CUT = (63, 95, 94)      # (D, H, W) of the small pack_latents check: odd, so it pads


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, repeats: int = REPEATS, spin: int = SPIN_CYCLES) -> float:
    """Median device time of one ``fn()`` in ms. Each sample puts a spin
    kernel on the stream first, so the host has issued all of ``fn``'s
    launches before the card reaches the start event: the time between the
    two events is the card's alone, without the host's launch latency (as
    long as ``spin`` cycles outlast the host's issue of ``fn``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
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
    input type and held to 2e-5, and two calls must give bitwise the same
    statistics (the kernel sums in a fixed order; only its ticket is an
    atomic). Every main-path shape is compared at the batch the generation
    path gives it and, for the UNet's call sites, at the training batch as
    well; the UNet2D's seven shapes at B = 2 and at the presets' B = 64 (the
    training batch and the grid's), and its shapes with 8- and 64-channel
    groups also at the guided grid's B = 128 and the sweep's B = 155, and its
    8-channel groups once at the guided sweep's B = 310: the launch plans
    change with the batch (at B = 64 the stats kernel takes two blocks an SM,
    each looping over tens of slabs). Last, ``gn_far_from_zero``: x = 200 + 1.5·N(0, 1) at (2, 100, 64),
    where E[x²] − mean² cancels to 1/17 800 of E[x²]; kernel and plain
    version each hold the variance (rstd⁻² − eps) within 16·2⁻²⁴·E[x²] of
    the float64 variance (a few float32 ulps of E[x²]).
    """

    worst = {"gn_silu_stats": {"float32": 0.0, "bfloat16": 0.0},
             "gn_silu_apply": {"float32": 0.0, "bfloat16": 0.0}}
    cases = [(2, n, c) for (n, c) in GN_MAIN_PATH if (n, c) != GN_BIG]
    cases += [(1, *GN_BIG)] + [(2, n, c) for n, c in GN_RAGGED]
    cases += [(TRAIN_BATCH, n, c) for (n, c), (per_unet, _) in GN_MAIN_PATH.items() if per_unet]
    cases += [(2, n, c) for (n, c) in GN_UNET2D] + [GN_2D_WIDEST_BATCH]
    cases += [(BATCH_2D, n, c) for (n, c) in GN_UNET2D]
    cases += [(b, n, c) for b in (2 * BATCH_2D, SWEEP_SLICES) for (n, c) in GN_UNET2D
              if c // GROUPS in (8, 64)]
    for b, n, c in cases:
        x32, scale, bias = gn_inputs(rng, b, n, c)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            key = str(dtype).replace("torch.", "")
            tag = f"groupnorm {key} ({b},{n},{c})"
            stats = gn.gn_silu_stats(x, GROUPS)
            e1 = check_close(f"{tag} stats", stats,
                             gn.gn_silu_stats_reference(x, GROUPS), atol=2e-5)
            if not torch.equal(gn.gn_silu_stats(x, GROUPS), stats):
                raise AssertionError(f"{tag} stats: two calls differ")
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
    far = compare_groupnorm_far_from_zero(rng)
    torch.cuda.synchronize()
    print(f"compare groupnorm: {len(cases)} shapes x 2 dtypes ok, stats bitwise equal in two "
          f"calls, max abs err {json.dumps(worst)}")
    print("gn_far_from_zero " + json.dumps(far))
    return worst


def compare_groupnorm_far_from_zero(rng, shape=(2, 100, 64), offset=200.0):
    """The variance of ``gn_silu_stats`` and of its plain version where the
    mean is far from zero, against float64 sums (float32 input)."""
    b, n, c = shape
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    x.mul_(1.5).add_(offset)
    xg = x.double().view(b, n, GROUPS, c // GROUPS)
    ex2 = (xg * xg).mean(dim=(1, 3))
    var64 = ex2 - xg.mean(dim=(1, 3)) ** 2
    bar = 16 * 2.0 ** -24 * ex2
    out = {"shape": list(shape), "offset": offset, "bar": float(bar.max())}
    for name, stats in (("kernel", gn.gn_silu_stats(x, GROUPS)),
                        ("plain", gn.gn_silu_stats_reference(x, GROUPS))):
        err = (stats[:, 1].double() ** -2 - 1e-5 - var64).abs()
        if not bool((err <= bar).all()):
            raise AssertionError(f"far-from-zero mean: {name} variance off by {float(err.max()):.3e}, "
                                 f"bar {float(bar.max()):.3e}")
        out[f"{name}_var_err"] = float(err.max())
    return out


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
    shapes = [FLASH_MAIN, FLASH_TRAIN] + FLASH_OTHER
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
    # (float32: 1e-5 on out, its values are of size ~0.01 at this length;
    # bf16: the bar of the other shapes)
    heads = FLASH_LONG[2]
    for dtype, tol in ((torch.float32, dict(atol=1e-5)),
                       (torch.bfloat16, dict(atol=2e-3, rtol=1e-2))):
        key = str(dtype).replace("torch.", "")
        q, k, v = flash_inputs(rng, FLASH_LONG, dtype)
        out, lse = fa.flash_attention_forward(q, k, v)
        for start in range(0, FLASH_LONG[1], 4096):
            rows = slice(start, start + 4096)
            ref_out, ref_lse = fa.flash_attention_reference(q[:, rows], k, v)
            e = check_close(f"flash {key} {FLASH_LONG} out rows {start}+", out[:, rows],
                            ref_out, **tol)
            check_close(f"flash {key} {FLASH_LONG} lse rows {start}+",
                        lse.view(heads, -1)[:, rows], ref_lse, atol=1e-4)
            worst[key] = max(worst[key], e)
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.synchronize()
    print(f"compare flash: {len(shapes) + 1} shapes x 2 dtypes ({FLASH_LONG} among them) ok, "
          f"max abs err {json.dumps(worst)}")
    return worst


def flash_backward_inputs(rng, shape, dtype):
    """Strided q, k, v, the forward kernel's (out, lse), a random output
    gradient and Δ = rowsum(dO∘O)."""
    q, k, v = flash_inputs(rng, shape, dtype)
    out, lse = fa.flash_attention_forward(q, k, v)
    dout = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(dtype)
    return q, k, v, out, lse, dout, fa.flash_attention_delta(out, dout)


def compare_flash_backward(rng):
    """``flash_attn_bwd_dkv`` and ``flash_attn_bwd_dq`` against their plain
    versions, on the forward kernel's own (out, lse).

    Tolerances: float32 1e-4 absolute, the bar of the JAX package's gradient
    test — the kernels sum over query rows (keys) tile by tile, the plain
    versions at once. bf16 dk, dv: 1e-5 + 2**-7 relative, one bf16 ulp — both
    sides round float32 sums that differ at most in their last digits to bf16
    once, so a kernel that rounded anywhere else (p to bf16) is outside it.
    bf16 dq: 1e-5 + 2**-6 relative, two ulps — dq is rounded twice, around
    the Dh^-1/2 multiply, and two roundings of sums taken in another order
    land up to two ulps apart (a CPU emulation of the kernel's arithmetic,
    ``tests/test_torch_flash_tensorcore.py``, shows it with dU exact to 24
    bits); a single bf16 rounding of dU is outside even that. The elements of
    bf16 dq between the two bars are counted and printed.
    """

    worst = {name: {"float32": 0.0, "bfloat16": 0.0}
             for name in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")}
    beyond_one_ulp = {}

    def check_dq(tag, got, want, dtype):
        if dtype == torch.float32:
            return check_close(tag, got, want, atol=1e-4)
        err = (got.float() - want.float()).abs()
        beyond_one_ulp[tag] = [int((err > ONE_ULP["atol"] + ONE_ULP["rtol"] * want.float().abs()).sum()),
                               got.numel()]
        return check_close(tag, got, want, **TWO_ULPS)

    shapes = [FLASH_TRAIN, FLASH_MAIN] + FLASH_OTHER
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).replace("torch.", "")
            q, k, v, out, lse, dout, delta = flash_backward_inputs(rng, shape, dtype)
            tol = dict(atol=1e-4) if dtype == torch.float32 else ONE_ULP
            dk, dv = fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta)
            ref_dk, ref_dv = fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta)
            e = max(check_close(f"flash bwd {key} {shape} dk", dk, ref_dk, **tol),
                    check_close(f"flash bwd {key} {shape} dv", dv, ref_dv, **tol))
            worst["flash_attn_bwd_dkv"][key] = max(worst["flash_attn_bwd_dkv"][key], e)
            dq = fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta)
            ref_dq = fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta)
            e = check_dq(f"flash bwd {key} {shape} dq", dq, ref_dq, dtype)
            worst["flash_attn_bwd_dq"][key] = max(worst["flash_attn_bwd_dq"][key], e)
            # the differentiable front end to end: same kernels behind autograd
            qkv = torch.stack([q, k, v], dim=2).requires_grad_()
            got, = torch.autograd.grad(
                fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]), qkv, dout)
            check_close(f"flash autograd {key} {shape} dk, dv", got[:, :, 1:],
                        torch.stack([ref_dk, ref_dv], dim=2), **tol)
            check_dq(f"flash autograd {key} {shape} dq", got[:, :, 0], ref_dq, dtype)
    # N = 51 200: the plain versions run on blocks of 2048 query rows
    for dtype, tol in ((torch.float32, dict(atol=1e-4)), (torch.bfloat16, ONE_ULP)):
        key = str(dtype).replace("torch.", "")
        q, k, v, out, lse, dout, delta = flash_backward_inputs(rng, FLASH_LONG, dtype)
        dk, dv = fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta)
        dq = fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta)
        ref_dk, ref_dv = fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta, q_block=2048)
        ref_dq = fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta, q_block=2048)
        e = max(check_close(f"flash bwd {key} {FLASH_LONG} dk", dk, ref_dk, **tol),
                check_close(f"flash bwd {key} {FLASH_LONG} dv", dv, ref_dv, **tol))
        worst["flash_attn_bwd_dkv"][key] = max(worst["flash_attn_bwd_dkv"][key], e)
        e = check_dq(f"flash bwd {key} {FLASH_LONG} dq", dq, ref_dq, dtype)
        worst["flash_attn_bwd_dq"][key] = max(worst["flash_attn_bwd_dq"][key], e)
        del q, k, v, out, lse, dout, delta, dk, dv, dq, ref_dk, ref_dv, ref_dq
    # a reference of another build: autograd through the materialised
    # attention, which shares no code with the plain backward (float32, 1e-4)
    qkv = torch.stack(flash_inputs(rng, FLASH_MAIN, torch.float32), dim=2).requires_grad_()
    dout = torch.from_numpy(rng.standard_normal(FLASH_MAIN, dtype=np.float32)).cuda()
    got, want = (torch.autograd.grad(
        attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]), qkv, dout)[0]
        for attend in (fa.flash_attention, multi_head_self_attention))
    independent = check_close(f"flash autograd vs materialised attention {FLASH_MAIN}",
                              got, want, atol=1e-4)
    torch.cuda.synchronize()
    print(f"compare flash backward: {len(shapes) + 1} shapes x 2 dtypes ({FLASH_LONG} among them) ok, "
          f"max abs err {json.dumps(worst)}; against autograd through the materialised "
          f"attention {independent:.3e}")
    print("flash_dq_bf16_beyond_one_ulp " + json.dumps(beyond_one_ulp))
    return worst


def compare_groupnorm_autograd(rng):
    """Gradients of the GroupNorm+SiLU ``autograd.Function`` (kernels in the
    forward) against autograd through the plain composition, at two shapes of
    the training path. Tolerance 1e-4 absolute in float32, the bar of the JAX package's
    kernel test, plus 1e-5 relative for dscale and dbias, which are sums over
    B·N terms; bf16 1e-3 + 1e-2 relative (one bf16 ulp). The backward is the
    same plain composition on the same saved input, so the gradients agree far
    inside that."""

    worst = 0.0
    for n, c in GN_GRAD_SHAPES:
        x32, scale, bias = gn_inputs(rng, TRAIN_BATCH, n, c)
        dy32 = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, n, c), dtype=np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).replace("torch.", "")
            x, dy = x32.to(dtype).requires_grad_(), dy32.to(dtype)
            scale.requires_grad_()
            bias.requires_grad_()
            gn.launches.reset()
            y = gn.group_norm_silu_fused(x, scale, bias, GROUPS)
            if gn.launches.as_dict() != {"gn_silu_stats": 1, "gn_silu_apply": 1}:
                raise AssertionError(f"GroupNorm+SiLU under autograd launched {gn.launches.as_dict()}")
            got = torch.autograd.grad(y, (x, scale, bias), dy)
            want = torch.autograd.grad(group_norm_silu(x, GROUPS, scale, bias), (x, scale, bias), dy)
            tol = (dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32
                   else dict(atol=1e-3, rtol=1e-2))
            for name, g, w in zip(("dx", "dscale", "dbias"), got, want):
                e = check_close(f"groupnorm autograd {key} ({n},{c}) {name}", g, w, **tol)
                if name == "dx":
                    worst = max(worst, e)
    torch.cuda.synchronize()
    print(f"compare groupnorm autograd: {len(GN_GRAD_SHAPES)} shapes x 2 dtypes ok, "
          f"max abs err of dx {worst:.3e}")
    return worst


def groupnorm_row(rng, b, n, c):
    """Both kernels, their plain versions, the library yardsticks and the
    bytes bounds at one (b, n, c) shape, bf16."""
    x32, scale, bias = gn_inputs(rng, b, n, c)
    x = x32.to(torch.bfloat16)
    del x32
    stats = gn.gn_silu_stats(x, GROUPS)
    nbytes = x.numel() * x.element_size()
    # channels-first view of the same buffer for the library calls
    x_cf = x.view(b, n, 1, c).permute(0, 3, 1, 2)
    xg = x.view(b, n, GROUPS, c // GROUPS)
    return {
        "shape": [b, n, c], "dtype": "bfloat16",
        "stats_ms": time_ms(lambda: gn.gn_silu_stats(x, GROUPS)),
        "stats_plain_ms": time_ms(lambda: gn.gn_silu_stats_reference(x, GROUPS)),
        "stats_library_ms": time_ms(
            lambda: torch.var_mean(xg, dim=(1, 3), correction=0)),
        "stats_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "stats_host_issue_us": host_issue_us(lambda: gn.gn_silu_stats(x, GROUPS)),
        "apply_ms": time_ms(lambda: gn.gn_silu_apply(x, stats, scale, bias)),
        "apply_plain_ms": time_ms(
            lambda: gn.gn_silu_apply_reference(x, stats, scale, bias)),
        "apply_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
        # one read and one write of the same bytes: what the card takes
        # for apply's traffic alone (a yardstick, not the same function)
        "apply_copy_ms": time_ms(lambda: torch.empty_like(x).copy_(x)),
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
        "stats_plan": dataclasses.asdict(gn.launch_plan(n, c, GROUPS, x.element_size(), 16, b)),
        "apply_plan": dataclasses.asdict(gn.apply_plan(n, c, GROUPS, x.element_size())),
    }


GN_SUM_KEYS = ("stats_ms", "stats_bound_ms", "apply_ms", "apply_bound_ms", "apply_copy_ms")


def weighted(rows, calls):
    """Each timed quantity summed over ``calls(row)`` launches of its row."""
    out = {k: sum(r[k] * calls(r) for r in rows) for k in GN_SUM_KEYS}
    out["stats_above_bound_ms"] = out["stats_ms"] - out["stats_bound_ms"]
    out["apply_above_bound_ms"] = out["apply_ms"] - out["apply_bound_ms"]
    return out


def time_groupnorm(rng):
    """Per main-path shape (bf16, B = 2): both kernels, their plain versions,
    the library yardsticks and the bytes bound; then each summed over the
    calls of one generate call (``groupnorm_per_generate_call``). The same
    at the UNet2D's shapes at the presets' batch of 64, summed over one
    forward (``groupnorm_per_unet2d_forward``)."""

    rows = []
    for (n, c), (per_unet, per_decode) in GN_MAIN_PATH.items():
        row = groupnorm_row(rng, NUM_VOLUMES, n, c)
        row.update(calls_per_unet_forward=per_unet, calls_per_decode=per_decode)
        rows.append(row)
    # one generate call: 20 UNet forwards and one decode, each at batch 2
    per_call = weighted(rows, lambda r: DDIM_STEPS * r["calls_per_unet_forward"]
                        + r["calls_per_decode"])
    print("groupnorm_times " + json.dumps(rows))
    print("groupnorm_per_generate_call " + json.dumps(per_call))

    rows_2d = []
    for (n, c), calls in GN_UNET2D.items():
        row = groupnorm_row(rng, BATCH_2D, n, c)
        row["calls_per_unet2d_forward"] = calls
        rows_2d.append(row)
        torch.cuda.empty_cache()
    per_forward = weighted(rows_2d, lambda r: r["calls_per_unet2d_forward"])
    print("groupnorm_times_2d " + json.dumps(rows_2d))
    print("groupnorm_per_unet2d_forward " + json.dumps({"batch": BATCH_2D, **per_forward}))
    return rows, rows_2d


def profile_groupnorm_stats(rng, calls=10):
    """``--profile``: the kernels that ``calls`` calls of ``gn_silu_stats``
    launch at the most frequent and the largest main-path shape, by name,
    with device ms per call. One launch per call, or the run fails."""
    out = {}
    for n, c in ((800, 512), GN_BIG):
        x = gn_inputs(rng, NUM_VOLUMES, n, c)[0].to(torch.bfloat16)
        gn.gn_silu_stats(x, GROUPS)
        torch.cuda.synchronize()
        kernels = {}
        for _ in range(3):   # the profiler now and then records no kernel at all: ask again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    gn.gn_silu_stats(x, GROUPS)
                torch.cuda.synchronize()
            kernels = {evt.key[:80]: {"launches_per_call": evt.count / calls,
                                      "ms_per_call": getattr(evt, "self_device_time_total", 0)
                                      / 1e3 / calls}
                       for evt in prof.key_averages() if evt.device_type.name != "CPU"}
            if kernels:
                break
        if sum(k["launches_per_call"] for k in kernels.values()) != 1:
            raise AssertionError(f"gn_silu_stats at ({NUM_VOLUMES}, {n}, {c}) launched {kernels}")
        out[f"({NUM_VOLUMES}, {n}, {c})"] = kernels
        del x
    print("profile_gn_stats " + json.dumps(out))


def time_groupnorm_backward(rng):
    """Per UNet3D shape at the training batch (bf16): the fused forward (the
    two kernels) and the backward of the ``autograd.Function``, which is
    plain PyTorch — the recomputed composition and its gradient. With the
    calls per forward this gives the GroupNorm+SiLU share of a training step."""

    rows = []
    for (n, c), (per_unet, _) in GN_MAIN_PATH.items():
        if per_unet == 0:
            continue
        x32, scale, bias = gn_inputs(rng, TRAIN_BATCH, n, c)
        x = x32.to(torch.bfloat16).requires_grad_()
        dy = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, n, c), dtype=np.float32))
        dy = dy.cuda().to(torch.bfloat16)
        del x32
        leaves = (x, scale.requires_grad_(), bias.requires_grad_())
        y = gn.group_norm_silu_fused(*leaves, GROUPS)
        rows.append({
            "shape": [TRAIN_BATCH, n, c], "dtype": "bfloat16", "calls_per_unet_forward": per_unet,
            "forward_ms": time_ms(lambda: gn.group_norm_silu_fused(*leaves, GROUPS)),
            "backward_ms": time_ms(
                lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)),
        })
        del x, y, dy, leaves
    per_step = {k: sum(r[k] * r["calls_per_unet_forward"] for r in rows)
                for k in ("forward_ms", "backward_ms")}
    print("groupnorm_backward_times " + json.dumps({"per_train_step": per_step, "rows": rows}))
    return rows


def flash_plan_note(kernel, shape, dtype):
    plan = fa.launch_plan(kernel, *shape, dtype)
    return {"tile": plan.tile, "warps": plan.warps, "blocks": plan.blocks,
            "shared_bytes": plan.shared_bytes}


def time_flash(rng):
    """The forward kernel, its plain version, the library yardstick and the
    bound, per shape. At N = 51 200 the plain version cannot hold its logits
    (``plain_ms`` is null there), fewer calls are timed, and ``exp_ms`` is the
    time the card's special-function units need for the B·H·N² exponentials."""

    rows = []
    for shape, dtype, repeats in (
            (FLASH_MAIN, torch.bfloat16, REPEATS), (FLASH_MAIN, torch.float32, REPEATS),
            (FLASH_OTHER[0], torch.bfloat16, REPEATS), (FLASH_TRAIN, torch.bfloat16, REPEATS),
            (FLASH_LONG, torch.bfloat16, LONG_REPEATS)):
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
            "ms": time_ms(lambda: fa.flash_attention_forward(q, k, v), repeats),
            "plain_ms": (time_ms(lambda: fa.flash_attention_reference(q, k, v))
                         if shape != FLASH_LONG else None),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), repeats),
            "bound_ms": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "exp_ms": b * h * n * n / EXP_PER_S * 1e3,
            "host_issue_us": host_issue_us(lambda: fa.flash_attention_forward(q, k, v),
                                           calls=200 if shape != FLASH_LONG else 3),
            "plan": flash_plan_note("flash_attn_fwd", shape, dtype),
        })
    print("flash_times " + json.dumps(rows))
    return rows


def time_flash_backward(rng):
    """Both backward kernels, their plain versions, the bound and the library
    yardstick: ``F.scaled_dot_product_attention`` forward + backward less its
    forward, which computes dq, dk and dv together (the port never calls it).
    Bound by operations: dkv computes 4 tile products (8·B·H·N²·Dh flops), dq
    3 (6·B·H·N²·Dh), over the tensor-core rate of the input type — although
    three of dkv's four products and two of dq's three take float32 operands
    in the reference (p and dU are not rounded), so the bf16 rate is a bound
    that this arithmetic cannot reach: the tensor-core dkv issues 6 products'
    worth of ``mma`` for those 4. At N = 51 200 the plain versions are not
    timed and fewer calls are."""

    rows = []
    for shape, dtype, repeats in (
            (FLASH_TRAIN, torch.bfloat16, REPEATS), (FLASH_TRAIN, torch.float32, REPEATS),
            (FLASH_MAIN, torch.bfloat16, REPEATS), (FLASH_LONG, torch.bfloat16, LONG_REPEATS)):
        b, n, h, d = shape
        long = shape == FLASH_LONG
        key = str(dtype).replace("torch.", "")
        q, k, v, out, lse, dout, delta = flash_backward_inputs(rng, shape, dtype)
        qt, kt, vt = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (q, k, v))
        dout_t = dout.permute(0, 2, 1, 3)

        def sdpa_forward_backward():
            o = F.scaled_dot_product_attention(qt, kt, vt)
            torch.autograd.grad(o, (qt, kt, vt), dout_t)

        library_ms = (time_ms(sdpa_forward_backward, repeats)
                      - time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), repeats))
        tensor_bytes = b * n * h * d * q.element_size()
        stat_bytes = 2 * 4 * b * h * n
        row = {"shape": list(shape), "dtype": key, "library_ms": library_ms,
               "delta_ms": time_ms(lambda: fa.flash_attention_delta(out, dout)),
               "exp_ms": b * h * n * n / EXP_PER_S * 1e3,
               "dkv_plan": flash_plan_note("flash_attn_bwd_dkv", shape, dtype),
               "dq_plan": flash_plan_note("flash_attn_bwd_dq", shape, dtype)}
        for name, fn, ref, products, tensors in (
            ("dkv", fa.flash_attn_bwd_dkv, fa.flash_attn_bwd_dkv_reference, 4, 6),
            ("dq", fa.flash_attn_bwd_dq, fa.flash_attn_bwd_dq_reference, 3, 5),
        ):
            t_flops = products * 2 * b * h * n * n * d / PEAK_FLOPS[key] * 1e3
            t_bytes = (tensors * tensor_bytes + stat_bytes) / HBM_BYTES_PER_S * 1e3
            row.update({
                f"{name}_ms": time_ms(lambda: fn(q, k, v, dout, lse, delta), repeats),
                f"{name}_plain_ms": (None if long else
                                     time_ms(lambda: ref(q, k, v, dout, lse, delta))),
                f"{name}_bound_ms": max(t_flops, t_bytes),
                f"{name}_bound_by": "operations" if t_flops >= t_bytes else "bytes",
                f"{name}_host_issue_us": host_issue_us(
                    lambda: fn(q, k, v, dout, lse, delta), calls=3 if long else 200),
            })
        rows.append(row)
    print("flash_backward_times " + json.dumps(rows))
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
    reset_launch_counts()
    on_card = generate_3d_volumes(unet, vae, diffusion, device="cuda", **kw).cpu()
    counts = all_launch_counts()
    if min(counts[k] for k in GENERATION_KERNELS) == 0:
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


def profile_window(prof, wall_ms, top=14, host_top=0):
    """Device time by kernel name of one profiled window; with ``host_top``,
    also the host operators that took the most host time of their own."""
    rows, host = [], []
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue    # a record_function range (Optimizer.step) spans kernels counted already
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and evt.device_type.name != "CPU":
            rows.append((dev_us / 1e3, evt.count, evt.key))
        elif evt.device_type.name == "CPU" and evt.self_cpu_time_total > 0:
            host.append((evt.self_cpu_time_total / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    out = {
        "wall_ms_under_profiler": wall_ms, "device_busy_ms": sum(r[0] for r in rows),
        "top": [{"ms": r[0], "count": r[1], "kernel": r[2][:90]} for r in rows[:top]],
    }
    if host_top:
        out["host_ms"] = sum(r[0] for r in host)
        out["host_top"] = [{"ms": r[0], "count": r[1], "op": r[2][:60]} for r in host[:host_top]]
    return out


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
            windows[name] = profile_window(prof, wall_ms)
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
    reset_launch_counts()
    t3 = time.perf_counter()
    vols = generate_3d_volumes(
        unet, vae, diffusion, num_volumes=NUM_VOLUMES, latent_spatial=LATENT_SPATIAL,
        latent_channels=LATENT_CHANNELS, ddim_steps=DDIM_STEPS, generator=gen,
    )
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    counts = all_launch_counts()
    peak = torch.cuda.max_memory_allocated()

    want_gn = DDIM_STEPS * GN_CALLS_PER_UNET + GN_CALLS_PER_DECODE
    want = {"gn_silu_stats": want_gn, "gn_silu_apply": want_gn, "flash_attn_fwd": DDIM_STEPS,
            "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}   # no gradient when sampling
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


# ---------------------------------------------------------------- phases 6/7


def all_launch_counts():
    return {**gn.launches.as_dict(), **fa.launches.as_dict()}


def reset_launch_counts():
    gn.launches.reset()
    fa.launches.reset()


def small_training_check():
    """3 cached-latent Adam steps of a narrow float32 UNet3D with attention
    and level-0 rematerialisation: on the card (forward and backward kernels)
    and on the CPU (plain versions), from the same weights, latents, timesteps
    and noise. Tolerances: losses 1e-4 absolute (float32 sums in another
    order); final parameters 1e-3 relative L2 over all of them — Adam divides
    each gradient by its own running magnitude, so where a gradient is tiny a
    difference in its last digits becomes a difference of order lr."""

    steps, t_steps, lr = 3, 20, 1e-3
    kw = dict(in_channels=4, base_channels=16, channel_mults=(1, 2), time_emb_dim=32,
              num_heads=1, remat_levels=(0,))
    rng = np.random.default_rng(SEED + 4)
    batches = [{
        "latent": torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 4), dtype=np.float32)),
        "noise": torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 4), dtype=np.float32)),
        "t": torch.from_numpy(rng.integers(1, t_steps, size=2)),
    } for _ in range(steps)]
    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(t_steps)),
                                  loss_type="min_snr")
    runs = {}
    for device in ("cuda", "cpu"):
        unet = seeded_weights(UNet3D(**kw), SEED + 5)
        state = create_train_state(unet, lr, ema=True, device=device)
        step = make_cached_latent_train_step(unet, diffusion, ema_decay=0.9)
        reset_launch_counts()
        losses = []
        for batch in batches:
            state, loss = step(state, {"latent": batch["latent"]}, None, 0.7,
                               t=batch["t"], noise=batch["noise"])
            losses.append(loss)
        counts = all_launch_counts()
        if device == "cuda" and min(counts.values()) == 0:
            raise AssertionError(f"small training run skipped a kernel: {counts}")
        runs[device] = (torch.stack(losses).cpu(),
                        torch.cat([p.detach().flatten().cpu() for p in unet.parameters()]),
                        torch.cat([e.flatten().cpu() for e in state.ema_params.values()]))
    (loss_g, par_g, ema_g), (loss_c, par_c, ema_c) = runs["cuda"], runs["cpu"]
    loss_err = check_close("small training losses, card vs CPU", loss_g, loss_c, atol=1e-4)
    rel = float((par_g - par_c).norm() / par_c.norm())
    rel_ema = float((ema_g - ema_c).norm() / ema_c.norm())
    if not max(rel, rel_ema) < 1e-3:
        raise AssertionError(f"small training: parameters differ by {rel:.3e}, EMA by {rel_ema:.3e}")
    print(f"small training (fp32, 3 steps, card kernels vs CPU plain): max loss err "
          f"{loss_err:.3e}, parameter rel-L2 {rel:.3e}, EMA rel-L2 {rel_ema:.3e} ok")


def build_flagship_trainer(remat_levels):
    """The flagship UNet3D as it is trained: float32 parameters, bf16 compute,
    seeded weights, Adam lr 1e-4 and an EMA shadow, on the card."""
    unet = seeded_weights(UNet3D(
        in_channels=LATENT_CHANNELS, base_channels=128, channel_mults=(1, 2, 4),
        use_attention=True, num_heads=4, time_emb_dim=256, remat_levels=remat_levels,
        dtype=torch.bfloat16, param_dtype=torch.float32,
    ), SEED + 1).train()
    state = create_train_state(unet, 1e-4, ema=True)
    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(T_STEPS)),
                                  loss_type="min_snr").to("cuda")
    return unet, state, make_cached_latent_train_step(unet, diffusion, ema_decay=0.999)


def train_latents(seed=SEED + 6):
    rng = np.random.default_rng(seed)
    shape = (TRAIN_BATCH, *LATENT_SPATIAL, LATENT_CHANNELS)
    return {"latent": torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()}


def train_path():
    """The training path at full width, once without rematerialisation and
    once with ``remat_levels=(0,)``: launch counts per step, finite losses,
    float32 parameters that moved, and the same first loss for both (2e-3
    relative: the same bf16 forward, but the recomputed blocks' kernels are
    other launches and Adam has not stepped yet, so only kernel-order noise
    separates them — 0 is expected)."""

    batch = train_latents()
    result, first_loss, counts_by_setting = {}, {}, {}
    for tag, remat_levels in (("no_remat", None), ("remat_level0", (0,))):
        unet, state, step = build_flagship_trainer(remat_levels)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        losses = []
        for _ in range(TRAIN_WARMUP_STEPS):
            state, loss = step(state, batch, gen, 1.0)
            losses.append(loss)
        torch.cuda.synchronize()
        before = [p.detach().clone() for p in unet.parameters()]

        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, loss = step(state, batch, gen, 1.0)
            losses.append(loss)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = all_launch_counts()
        peak = torch.cuda.max_memory_allocated()

        gn_per_step = GN_CALLS_PER_UNET + (GN_REMAT_LEVEL0_CALLS if remat_levels else 0)
        want = {"gn_silu_stats": TRAIN_STEPS * gn_per_step,
                "gn_silu_apply": TRAIN_STEPS * gn_per_step,
                "flash_attn_fwd": TRAIN_STEPS, "flash_attn_bwd_dkv": TRAIN_STEPS,
                "flash_attn_bwd_dq": TRAIN_STEPS}
        if counts != want:
            raise AssertionError(f"train path {tag}: launch counts {counts}, expected {want}")
        losses = torch.stack(losses).cpu()
        if losses.dtype != torch.float32 or not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"train path {tag}: losses {losses.tolist()}")
        if state.step != TRAIN_WARMUP_STEPS + TRAIN_STEPS:
            raise AssertionError(f"train path {tag}: {state.step} optimizer updates")
        for name, p in unet.named_parameters():
            if p.dtype != torch.float32 or p.grad is None or p.grad.dtype != torch.float32:
                raise AssertionError(f"train path {tag}: {name} is not a float32 master parameter")
        moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, unet.parameters()))
        if moved != len(before):
            raise AssertionError(f"train path {tag}: only {moved} of {len(before)} parameters moved")
        first_loss[tag] = float(losses[0])
        counts_by_setting[tag] = counts
        result[tag] = {
            "seconds_per_step": seconds / TRAIN_STEPS,
            "latents_per_second": TRAIN_BATCH * TRAIN_STEPS / seconds,
            "peak_memory_bytes": peak,
            "launches_per_step": {k: v // TRAIN_STEPS for k, v in counts.items()},
            "losses": losses.tolist(),
        }
        del unet, state, step, before
        torch.cuda.empty_cache()
    a, b = first_loss["no_remat"], first_loss["remat_level0"]
    if not abs(a - b) <= 2e-3 * abs(a):
        raise AssertionError(f"first loss without remat {a} and with remat {b} differ")
    result.update({
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP_STEPS,
        "dtype": "bfloat16 compute, float32 parameters", "loss_type": "min_snr",
    })
    print("train_path " + json.dumps(result))
    return counts_by_setting, result


class LatentLoader:
    """In-memory latents on the card, as a loader of the trainer: ``set_epoch``,
    ``__len__``, ``batch_size``. Sends this process a real SIGUSR1 while it
    hands out the batch of (epoch, step) ``signal_at``."""

    def __init__(self, batches, signal_at=None):
        self.batches, self.signal_at = batches, signal_at
        self.batch_size = batches[0]["latent"].shape[0]
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, batch in enumerate(self.batches):
            if (self.epoch, i) == self.signal_at:
                os.kill(os.getpid(), signal.SIGUSR1)
            yield batch


def flat_state(state):
    """Parameters, EMA shadow and Adam moments, each as one float32 vector."""
    moments = [m for s in state.optimizer.state.values() for k, m in sorted(s.items())
               if k != "step"]
    return {"params": torch.cat([p.detach().flatten() for p in state.model.parameters()]),
            "ema": torch.cat([e.flatten() for e in state.ema_params.values()]),
            "adam": torch.cat([m.flatten() for m in moments])}


def compare_states(tag, got, want):
    """Relative L2 of parameters and EMA, and whether they are bitwise equal;
    raises beyond ``RUN_TOL`` (cuDNN's weight gradients need not be bitwise
    repeatable)."""
    out = {}
    for key in ("params", "ema"):
        rel = float((got[key] - want[key]).norm() / want[key].norm())
        out[f"{key}_rel_l2"] = rel
        out[f"{key}_bitwise"] = bool(torch.equal(got[key], want[key]))
        if not rel <= RUN_TOL:
            raise AssertionError(f"{tag}: {key} differ by {rel:.3e} (relative L2)")
    return out


def by_epoch(logger, key):
    """The last value the logger holds for each epoch (a re-run epoch logs again)."""
    return {m["step"]: m["value"] for m in logger.read_metrics() if m["key"] == key}


def trainer_path(bare_step):
    """Stage-2 training through the runtime at full width: ``preset_ddpm_3d_ldm``
    (2 epochs, EMA 0.999, 1 checkpoint kept), the flagship ``UNet3D`` with
    seeded weights, the closures of the JAX package's 3D driver
    (``latent_scale`` bound; the validation timestep from
    ``fixed_validation_timesteps(400, 8)`` by batch index) and ``_trainer``,
    over 3 train and 1 val batches of seeded latents on the card.

    Run A goes straight through. Run B gets a real SIGUSR1 at epoch 1, step 0:
    its checkpoint says ``epoch_complete`` False and leaves ``best/`` alone; a
    new trainer on the same directory, into weights made from another seed,
    resumes and runs epoch 1 again (the state saved at the signal holds the
    step that ran, so B applies one update more than A: the JAX package's
    semantics). Checks: exact launch counts of both runs; the same draws at
    epoch 1, step 0 in A, B and B's resume; A after its 4th update and B at
    the signal agree (``RUN_TOL``), so do B's end and B's preempted state
    carried on in memory through the same epoch; the same learning rates; the
    val loss of epoch 0 in A and B, and of epoch 1 in B and the carried-on run,
    within ``RUN_TOL``; ``restore_host`` of B's last checkpoint loaded into
    fresh weights equals B's end bitwise."""

    batches = [train_latents(SEED + 8 + k)
               for k in range(TRAINER_TRAIN_BATCHES + TRAINER_VAL_BATCHES)]
    train_batches, val_batches = batches[:TRAINER_TRAIN_BATCHES], batches[TRAINER_TRAIN_BATCHES:]
    latent_scale = estimate_latent_scale_from_latents(b["latent"] for b in train_batches)
    previous_handlers = {s: signal.getsignal(s) for s in (signal.SIGUSR1, signal.SIGTERM)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        cfg = preset_ddpm_3d_ldm(**{"train.epochs": TRAINER_EPOCHS, "train.ema_decay": 0.999,
                                    "train.max_checkpoints": 1, "train.checkpoint_dir": tmp,
                                    "train.seed": SEED})
        diffusion = build_diffusion(cfg.diffusion)
        t_grid = fixed_validation_timesteps(cfg.diffusion.timesteps, 8)

        def build(weight_seed):
            """A fresh state and the two closures of the 3D driver. The train
            step records the t it is about to draw (from a copy of the
            generator) and, on request, the state after a given call."""
            unet = seeded_weights(build_unet3d(cfg.unet), weight_seed).train()
            state = create_train_state(unet, cfg.train.learning_rate,
                                       ema=cfg.train.ema_decay is not None)
            ldm_step = make_cached_latent_train_step(
                unet, diffusion, t_min=cfg.diffusion.t_min, nan_guard=cfg.train.nan_guard,
                ema_decay=cfg.train.ema_decay)
            ldm_eval = make_cached_latent_eval_step(unet, diffusion)
            record = {"t": [], "snapshot_after": None, "snapshot": None}

            def train_step(state, batch, generator):
                probe = torch.Generator(device=generator.device)
                probe.set_state(generator.get_state())
                record["t"].append(sample_timesteps(probe, batch["latent"].shape[0],
                                                    diffusion.timesteps, cfg.diffusion.t_min))
                state, loss = ldm_step(state, batch, generator, latent_scale)
                if len(record["t"]) == record["snapshot_after"]:
                    record["snapshot"] = flat_state(state)
                return state, loss

            def eval_step(params, batch, generator, batch_index=0):
                t_fixed = t_grid[batch_index % len(t_grid)]
                return ldm_eval(params, batch, generator, latent_scale, t_fixed)

            return state, train_step, eval_step, record

        loggers = {}

        def trainer(run, train_step, eval_step, signal_at=None, checkpoints=True):
            """``_trainer`` over the in-memory loaders, its saves timed; one
            metrics log per run name (a resume appends to its run's)."""
            if run not in loggers:
                loggers[run] = MetricsLogger("chip_smoke", run_name=run,
                                             root=os.path.join(tmp, "runs"))
            logger = loggers[run]
            t = _trainer(cfg.train, ckpt_dir=f"{run}/ldm", logger=logger,
                         train_step=train_step, eval_step=eval_step,
                         train_loader=LatentLoader(train_batches, signal_at),
                         val_loader=LatentLoader(val_batches), prefix="ldm_",
                         extra=lambda: {"latent_scale": float(latent_scale)})
            saves = []
            save = t.ckpt.save

            def timed_save(step, *args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save(step, *args, **kw)
                saves.append({"step": step, "seconds": time.perf_counter() - t0,
                              "bytes": os.path.getsize(t.ckpt.directory / f"{step}.pt"),
                              "best": t.ckpt.best_step == step})

            t.ckpt.save = timed_save
            if not checkpoints:
                t.ckpt, t.resume = None, False
            return t, logger, saves

        per_unet = GN_CALLS_PER_UNET

        def want_counts(train_steps, val_steps):
            gn_calls = (train_steps + val_steps) * per_unet
            return {"gn_silu_stats": gn_calls, "gn_silu_apply": gn_calls,
                    "flash_attn_fwd": train_steps + val_steps,
                    "flash_attn_bwd_dkv": train_steps, "flash_attn_bwd_dq": train_steps}

        # ---- run A: straight through
        reset_termination()
        state_a, step_a, eval_a, rec_a = build(SEED + 1)
        rec_a["snapshot_after"] = TRAINER_TRAIN_BATCHES + 1      # after epoch 1, step 0
        trainer_a, log_a, saves_a = trainer("a", step_a, eval_a)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res_a = trainer_a.fit(state_a)
        torch.cuda.synchronize()
        seconds_a = time.perf_counter() - t0
        counts_a = all_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        steps_a = TRAINER_EPOCHS * TRAINER_TRAIN_BATCHES
        if counts_a != want_counts(steps_a, TRAINER_EPOCHS * TRAINER_VAL_BATCHES):
            raise AssertionError(f"trainer run A: launch counts {counts_a}")
        if (res_a.epochs_run, res_a.preempted, trainer_a.global_step, state_a.step) != (
                TRAINER_EPOCHS, False, steps_a, steps_a):
            raise AssertionError(f"trainer run A: {res_a.epochs_run} epochs, preempted "
                                 f"{res_a.preempted}, global step {trainer_a.global_step}")
        final_a, at_signal_a = flat_state(state_a), rec_a["snapshot"]
        del state_a, step_a, eval_a, trainer_a, res_a
        torch.cuda.empty_cache()

        # ---- run B: a real SIGUSR1 at epoch 1, step 0, then a resume
        install_signal_handlers()
        try:
            state_b, step_b, eval_b, rec_b = build(SEED + 1)
            trainer_b1, log_b, saves_b = trainer("b", step_b, eval_b, signal_at=PREEMPT_AT)
            torch.cuda.synchronize()
            reset_launch_counts()
            res_b1 = trainer_b1.fit(state_b)
            preempted_step = trainer_b1.global_step
            if not res_b1.preempted or preempted_step != TRAINER_TRAIN_BATCHES + 1:
                raise AssertionError(f"trainer run B: preempted {res_b1.preempted} at global "
                                     f"step {preempted_step}")
            _, extra = trainer_b1.ckpt.restore_host()
            if extra["epoch"] != PREEMPT_AT[0] or extra["epoch_complete"]:
                raise AssertionError(f"trainer run B: the preemption saved {extra}")
            if trainer_b1.ckpt.best_step != TRAINER_TRAIN_BATCHES or saves_b[-1]["best"]:
                raise AssertionError(f"trainer run B: best/ moved to {trainer_b1.ckpt.best_step} "
                                     "at the preemption")
            reset_termination()
            state_b2, step_b2, eval_b2, rec_b2 = build(SEED + 9)
            trainer_b2, _, saves_b2 = trainer("b", step_b2, eval_b2)
            res_b2 = trainer_b2.fit(state_b2)
            torch.cuda.synchronize()
            counts_b = all_launch_counts()
        finally:
            for s, handler in previous_handlers.items():
                signal.signal(s, handler)
        steps_b = TRAINER_TRAIN_BATCHES + 1 + TRAINER_TRAIN_BATCHES
        if counts_b != want_counts(steps_b, 2 * TRAINER_VAL_BATCHES):
            raise AssertionError(f"trainer run B: launch counts {counts_b}")
        if (trainer_b2.start_epoch, res_b2.epochs_run, res_b2.preempted, trainer_b2.global_step,
                state_b2.step) != (PREEMPT_AT[0], 1, False, steps_b, steps_b):
            raise AssertionError(f"trainer run B resumed at epoch {trainer_b2.start_epoch}, ran "
                                 f"{res_b2.epochs_run}, global step {trainer_b2.global_step}")

        # the same draws at epoch 1, step 0: A, B before the signal, B's resume
        first = {"a": rec_a["t"][TRAINER_TRAIN_BATCHES], "b": rec_b["t"][TRAINER_TRAIN_BATCHES],
                 "b_resumed": rec_b2["t"][0]}
        if not all(torch.equal(first["a"], v) for v in first.values()):
            raise AssertionError(f"draws at epoch 1, step 0 differ: {first}")
        agree = {"a_vs_b_at_signal": compare_states(
            "A after 4 updates vs B at the signal", flat_state(state_b), at_signal_a)}

        # B's end against B's preempted state carried on in memory
        carried, log_c, _ = trainer("c", step_b, eval_b, checkpoints=False)
        carried.start_epoch, carried.global_step = PREEMPT_AT[0], preempted_step
        res_c = carried.fit(state_b)
        final_b = flat_state(state_b2)
        agree["b_vs_carried_on"] = compare_states("B's end vs carried on", final_b,
                                                  flat_state(res_c.state))
        agree["a_vs_b_final_rel_l2"] = float((final_b["params"] - final_a["params"]).norm()
                                             / final_a["params"].norm())

        lr_a, lr_b = by_epoch(log_a, "ldm_lr"), by_epoch(log_b, "ldm_lr")
        val_a, val_b = by_epoch(log_a, "ldm_val_loss"), by_epoch(log_b, "ldm_val_loss")
        if lr_a != lr_b or sorted(val_a) != sorted(val_b):
            raise AssertionError(f"learning rates {lr_a} vs {lr_b}")
        # epoch 0 validates the same state in A and B; B's epoch 1 validates
        # one update more than A's, the same as the carried-on run's
        val_c = by_epoch(log_c, "ldm_val_loss")
        val_rel = {e: abs(val_b[e] - val_a[e]) / abs(val_a[e]) for e in val_a}
        val_rel_carried = abs(val_b[1] - val_c[1]) / abs(val_c[1])
        if not (val_rel[0] <= RUN_TOL and val_rel_carried <= RUN_TOL):
            raise AssertionError(f"val losses: A {val_a}, B {val_b}, carried on {val_c}")

        # the last checkpoint, read to the host and loaded into fresh weights
        payload, extra = trainer_b2.ckpt.restore_host()
        fresh, _, _, _ = build(SEED + 10)
        load_state(fresh, payload)
        got, want = flat_state(fresh), flat_state(state_b2)
        if not (all(torch.equal(got[k], want[k]) for k in want) and fresh.step == state_b2.step
                and fresh.optimizer.param_groups[0]["lr"]
                == state_b2.optimizer.param_groups[0]["lr"]):
            raise AssertionError("restore_host of B's last checkpoint is not B's end")
        if extra["latent_scale"] != float(latent_scale) or not extra["epoch_complete"]:
            raise AssertionError(f"B's last checkpoint holds {extra}")

        steps_per_s = by_epoch(log_a, "ldm_steps_per_s")
        saves = saves_a + saves_b + saves_b2
        result = {
            "preset": "ddpm_3d_ldm", "epochs": TRAINER_EPOCHS, "batch": TRAIN_BATCH,
            "train_batches": TRAINER_TRAIN_BATCHES, "val_batches": TRAINER_VAL_BATCHES,
            "latent_scale": latent_scale,
            "trainer_seconds_per_step": {e: 1 / v for e, v in steps_per_s.items()},
            "bare_seconds_per_step": bare_step,
            "epoch_time_s": by_epoch(log_a, "ldm_epoch_time_s"),
            "run_a_seconds": seconds_a,
            "checkpoint_bytes": saves_a[0]["bytes"],
            "seconds_per_save": [round(x["seconds"], 4) for x in saves],
            "saves": len(saves),
            "peak_memory_bytes_run_a": peak,
            "peak_mem_gib_logged": by_epoch(log_a, "ldm_peak_mem_gib"),
            "launches": {"a": counts_a, "b": counts_b},
            "lr": lr_a, "val_loss_a": val_a, "val_loss_b": val_b, "val_loss_rel": val_rel,
            "val_loss_rel_b_vs_carried_on": val_rel_carried,
            "agreement": agree, "t_at_epoch1_step0": first["a"].tolist(),
        }
        for logger in loggers.values():
            logger.finish()
    print("trainer_path " + json.dumps(result))
    return {"trainer_straight": counts_a, "trainer_preempted_resumed": counts_b}


def profile_train_path():
    """``--profile``: where the device time of 3 training steps goes, by
    kernel name, without rematerialisation."""
    batch = train_latents()
    unet, state, step = build_flagship_trainer(None)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for _ in range(TRAIN_WARMUP_STEPS):
        state, _ = step(state, batch, gen, 1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = step(state, batch, gen, 1.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print("profile_train " + json.dumps({"train_3_steps": profile_window(prof, wall_ms, top=24)}))


# ------------------------------------------------------- the 2D / 2.5D family


class SubjectSlices:
    """One subject's slices in memory, read as the 2.5D generators read a
    dataset (``volume_paths``, ``slice_tuples``, ``slice_radius``,
    ``__getitem__`` → numpy ``image`` / ``context`` / ``z_pos``): the real
    neighbours as context (the center slice past the subject's edges),
    dz-major and modality-minor; z = k / (depth − 1), ``depth`` the whole
    subject's (a leading part of a subject keeps its slices' positions)."""

    def __init__(self, volume, radius, depth=None):
        self.volume, self.slice_radius = volume, radius
        self.depth = depth or len(volume)
        self.volume_paths = ["subject"]
        self.slice_tuples = [("subject", k) for k in range(len(volume))]

    def __len__(self):
        return len(self.slice_tuples)

    def __getitem__(self, i):
        k, n, r = self.slice_tuples[i][1], len(self.volume), self.slice_radius
        neighbours = [self.volume[k + dz] if 0 <= k + dz < n else self.volume[k]
                      for dz in range(-r, r + 1) if dz]
        return {"image": self.volume[k], "context": np.concatenate(neighbours, axis=-1),
                "z_pos": np.float32(k / (self.depth - 1))}


def seeded_subject(seed, slices, size, modalities=4):
    """A subject of seeded values in [-1, 1] (model space), (S, H, W, 4)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(slices, size, size, modalities)).astype(np.float32)


def check_output(tag, out, shape):
    if tuple(out.shape) != tuple(shape) or out.dtype != torch.float32:
        raise AssertionError(f"{tag}: output {out.dtype} {tuple(out.shape)}, want {shape}")
    if not out.is_cuda or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: output not on the card or not finite")


def expect_gn(tag, counts, forwards):
    """Exactly 29 launches of each GroupNorm kernel per UNet2D forward, and
    no flash-attention launch (the UNet2D has no attention)."""
    want = {"gn_silu_stats": forwards * GN_CALLS_PER_UNET2D,
            "gn_silu_apply": forwards * GN_CALLS_PER_UNET2D,
            "flash_attn_fwd": 0, "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}
    if counts != want:
        raise AssertionError(f"{tag}: launch counts {counts}, expected {want}")


def small_2d_check():
    """A small float32 UNet2D (base 16, mults (1, 2), 32²) on the card
    (kernels) against the CPU (plain versions) from the same start:
    ``sample_2d`` with 5 DDIM steps, plain and guided; then a 2.5D model
    (radius 1) through ``generate_pseudo3d_real_context`` (chunks of 4 of 6
    slices) and ``generate_pseudo3d_hybrid`` over a seeded subject of 6
    slices; tolerance 1e-3 absolute (float32 sums in another order,
    compounding over the steps). Then 3 float32 ``make_diffusion_train_step``
    steps of the 2.5D model (EMA, guidance dropout with the mask given) on the
    card and on the CPU from the same weights and draws: losses 1e-4
    absolute, parameters 1e-3 relative L2, as ``small_training_check``."""

    size, steps = 32, 5
    diffusion = GaussianDiffusion(make_schedule(linear_beta_schedule(20)))
    rng = np.random.default_rng(SEED + 11)
    kw2d = dict(base_channels=16, channel_mults=(1, 2), time_emb_dim=32)
    errs = {}

    def both(tag, fn):
        reset_launch_counts()
        on_card = fn("cuda").cpu()
        counts = all_launch_counts()
        if min(counts["gn_silu_stats"], counts["gn_silu_apply"]) == 0:
            raise AssertionError(f"small 2D {tag} skipped a GroupNorm kernel: {counts}")
        errs[tag] = check_close(f"small 2D {tag}, card vs CPU", on_card, fn("cpu"), atol=1e-3)

    model = seeded_weights(UNet2D(**kw2d), SEED + 12)
    x_t = torch.from_numpy(rng.standard_normal((3, size, size, 1), dtype=np.float32))
    for tag, guidance in (("sample_2d", None), ("sample_2d_guided", 2.0)):
        both(tag, lambda dev: sample_2d(model, diffusion, num_samples=3, image_size=size,
                                        z_pos=0.4, ddim_steps=steps, x_t=x_t,
                                        guidance_scale=guidance, device=dev))

    kw25 = dict(in_channels=12, out_channels=4, **kw2d)
    model25 = seeded_weights(UNet2D(**kw25), SEED + 13)
    data = SubjectSlices(seeded_subject(SEED + 14, 6, size), radius=1)
    x_t = torch.from_numpy(rng.standard_normal((6, size, size, 4), dtype=np.float32))
    both("real_context", lambda dev: generate_pseudo3d_real_context(
        model25, diffusion, data, x_t=x_t, ddim_steps=steps, batch_size=4, device=dev))
    both("hybrid", lambda dev: generate_pseudo3d_hybrid(
        model25, diffusion, data, x_t=x_t, ddim_steps=steps, device=dev))

    batches = [{
        "image": torch.from_numpy(rng.uniform(-1, 1, (2, size, size, 4)).astype(np.float32)),
        "context": torch.from_numpy(rng.uniform(-1, 1, (2, size, size, 8)).astype(np.float32)),
        "z_pos": torch.from_numpy(rng.uniform(0, 1, 2).astype(np.float32)),
        "t": torch.from_numpy(rng.integers(0, 20, size=2)),
        "noise": torch.from_numpy(rng.standard_normal((2, size, size, 4), dtype=np.float32)),
        "drop": torch.tensor([k == 1, False]),
    } for k in range(3)]
    runs = {}
    for device in ("cuda", "cpu"):
        m = seeded_weights(UNet2D(**kw25), SEED + 15)
        state = create_train_state(m, 1e-3, ema=True, device=device)
        step = make_diffusion_train_step(m, diffusion, ema_decay=0.9, cond_dropout=0.1)
        reset_launch_counts()
        losses = []
        for b in batches:
            state, loss = step(state, {k: b[k] for k in ("image", "context", "z_pos")},
                               t=b["t"], noise=b["noise"], drop=b["drop"])
            losses.append(loss)
        if device == "cuda":
            counts = all_launch_counts()
            if min(counts["gn_silu_stats"], counts["gn_silu_apply"]) == 0:
                raise AssertionError(f"small 2D training skipped a GroupNorm kernel: {counts}")
        runs[device] = (torch.stack(losses).cpu(),
                        torch.cat([p.detach().flatten().cpu() for p in m.parameters()]))
    (loss_g, par_g), (loss_c, par_c) = runs["cuda"], runs["cpu"]
    errs["train_losses"] = check_close("small 2D training losses, card vs CPU", loss_g, loss_c,
                                       atol=1e-4)
    rel = float((par_g - par_c).norm() / par_c.norm())
    if not rel < 1e-3:
        raise AssertionError(f"small 2D training: parameters differ by {rel:.3e}")
    errs["train_params_rel_l2"] = rel
    print("small_2d_check " + json.dumps(errs))


def build_unet2d_for_sampling(cfg, seed):
    """A preset's UNet2D at full width from the fields of its ``unet``
    config, as a sampling copy holds it (as ``build_flagship`` does for 3D):
    bf16 compute with the convolutions' and linears' weights in bf16
    (``param_dtype=None``), GroupNorm affine in float32; seeded weights, on
    the card."""
    u = cfg.unet
    model = UNet2D(in_channels=u.in_channels, out_channels=u.out_channels,
                   base_channels=u.base_channels, channel_mults=u.channel_mults,
                   time_emb_dim=u.time_emb_dim, groups=u.groups, dtype=torch.bfloat16)
    return seeded_weights(model, seed).cuda().eval()


def unet2d_flops_per_image(model, in_channels):
    """Operations of one UNet2D forward of one 128² image: 2 per
    multiply-add of every convolution, transposed convolution and linear
    (the elementwise work is left out), counted by forward hooks over one
    forward at batch 1."""
    total = [0]

    def count(mod, inputs, out):
        k = 1
        for size in getattr(mod, "kernel_size", ()):
            k *= size
        if isinstance(mod, torch.nn.ConvTranspose2d):   # every input pixel meets k² outputs
            total[0] += 2 * inputs[0][..., 0].numel() * mod.in_channels * mod.out_channels * k
        elif isinstance(mod, torch.nn.Conv2d):          # every output pixel reads k² inputs
            total[0] += 2 * out[..., 0].numel() * mod.in_channels * mod.out_channels * k
        else:
            total[0] += 2 * out[..., 0].numel() * mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.zeros(1, IMAGE_SIZE, IMAGE_SIZE, in_channels, device="cuda"),
              torch.ones(1, dtype=torch.long, device="cuda"), torch.zeros(1, device="cuda"))
    for h in hooks:
        h.remove()
    return total[0]


def forward_bound_ms(batch, flops_per_image):
    """The least time of ``batch`` UNet2D forwards on the card: their
    operations over the bf16 tensor-core peak."""
    return batch * flops_per_image / PEAK_FLOPS["bfloat16"] * 1e3


def timed(fn):
    """``fn()`` between two synchronisations: (result, seconds, peak bytes,
    launch counts), the counts set to 0 just before. Unreachable objects are
    collected first, so that the peak holds no garbage of an earlier phase
    (``trainer_path``'s trainers sit in reference cycles with their models
    and optimizer state until a collection)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, torch.cuda.max_memory_allocated(), all_launch_counts()


def path_2d(profile_steps=False):
    """The 2D serving path at full width: ``preset_slice_cond_2d``'s UNet2D
    (35 377 985 parameters) from the preset's fields with seeded weights held
    in bf16, T = 1000 linear (``build_diffusion``). ``sample_2d`` of 64 images at
    128² with 20 DDIM steps, plain and with ``guidance_scale`` 3 (one forward
    of 128 a step); ``sample_pseudo3d_sweep`` of 155 slices with 10 DPM-Solver
    steps. Each call is warmed up once at 2 steps first (cuDNN picks its
    algorithms per batch size), then counted: exactly 29 launches of each
    GroupNorm kernel per forward. With ``profile_steps`` (``--profile``), the
    grid's device busy per step from ``torch.profiler`` over 5 DDIM steps
    (``profile_2d`` prints that window by kernel)."""

    cfg = preset_slice_cond_2d()
    model = build_unet2d_for_sampling(cfg, SEED + 16)
    diffusion = build_diffusion(cfg.diffusion).to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    flops = unet2d_flops_per_image(model, cfg.unet.in_channels)
    calls = {
        "grid": (DDIM_STEPS_2D, lambda steps, gen: sample_2d(
            model, diffusion, num_samples=BATCH_2D, image_size=IMAGE_SIZE, ddim_steps=steps,
            generator=gen), (BATCH_2D, IMAGE_SIZE, IMAGE_SIZE, 1)),
        "grid_guided": (DDIM_STEPS_2D, lambda steps, gen: sample_2d(
            model, diffusion, num_samples=BATCH_2D, image_size=IMAGE_SIZE, ddim_steps=steps,
            generator=gen, guidance_scale=GUIDANCE), (BATCH_2D, IMAGE_SIZE, IMAGE_SIZE, 1)),
        "sweep": (SWEEP_STEPS, lambda steps, gen: sample_pseudo3d_sweep(
            model, diffusion, num_slices=SWEEP_SLICES, image_size=IMAGE_SIZE, ddim_steps=steps,
            sampler="dpm", generator=gen), (SWEEP_SLICES, IMAGE_SIZE, IMAGE_SIZE, 1)),
    }
    result, counts_by_call = {"unet_params": n_params, "dtype": "bfloat16 weights and compute",
                              "timesteps": cfg.diffusion.timesteps,
                              "forward_gflop_per_image": flops / 1e9}, {}
    for name, (steps, call, shape) in calls.items():
        call(2, torch.Generator(device="cuda").manual_seed(SEED + 17))
        out, seconds, peak, counts = timed(
            lambda: call(steps, torch.Generator(device="cuda").manual_seed(SEED + 18)))
        expect_gn(f"path_2d {name}", counts, steps)
        check_output(f"path_2d {name}", out, shape)
        counts_by_call[f"path_2d_{name}"] = counts
        batch = shape[0] * (2 if name == "grid_guided" else 1)
        result[name] = {"batch": batch, "steps": steps, "seconds_per_call": seconds,
                        "seconds_per_step": seconds / steps,
                        "flop_bound_ms_per_step": forward_bound_ms(batch, flops),
                        "peak_memory_bytes": peak, "launches": counts,
                        "output_std": float(out.std())}
        del out
    window = None
    if profile_steps:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sample_2d(model, diffusion, num_samples=BATCH_2D, image_size=IMAGE_SIZE,
                      ddim_steps=5, generator=gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        window = profile_window(prof, wall_ms, top=16)
        result["grid"]["device_busy_ms_per_step"] = window["device_busy_ms"] / 5
        result["grid"]["device_busy_share"] = window["device_busy_ms"] / wall_ms
    print("path_2d " + json.dumps(result))
    return model, diffusion, counts_by_call, window


def path_25d(profile_slice=False):
    """The 2.5D serving path at full width: ``preset_ddpm_25d``'s UNet2D (20
    channels in, 4 out, radius 2) from the preset's fields, seeded weights
    held in bf16, T = 1000 linear, over a seeded in-memory subject of 155 slices at
    128². ``generate_pseudo3d_real_context`` denoises the whole subject as one
    chunk of 155 with 20 DDIM steps; ``generate_pseudo3d_hybrid`` the first 8
    slices (their context past slice 7 falls back to the center slice) with
    10 DDIM steps, batch 1: host-bound, so the host's µs to issue one forward
    are printed beside its device time and the wall time per forward. With
    ``profile_slice`` (``--profile``), one slice of the hybrid under
    ``torch.profiler``: device time by kernel and host time by operator."""

    cfg = preset_ddpm_25d()
    radius = cfg.data.slice_radius
    model = build_unet2d_for_sampling(cfg, SEED + 19)
    diffusion = build_diffusion(cfg.diffusion).to("cuda")
    volume = seeded_subject(SEED + 20, SWEEP_SLICES, IMAGE_SIZE)
    subject = SubjectSlices(volume, radius)
    head = SubjectSlices(volume[:HYBRID_SLICES], radius, depth=SWEEP_SLICES)
    flops = unet2d_flops_per_image(model, cfg.unet.in_channels)
    result, counts_by_call = {"unet_params": sum(p.numel() for p in model.parameters()),
                              "in_channels": cfg.unet.in_channels, "slice_radius": radius,
                              "forward_gflop_per_image": flops / 1e9}, {}

    generate_pseudo3d_real_context(model, diffusion, subject, ddim_steps=2)   # warm-up
    out, seconds, peak, counts = timed(lambda: generate_pseudo3d_real_context(
        model, diffusion, subject, ddim_steps=DDIM_STEPS_2D,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 21)))
    expect_gn("path_25d real_context", counts, DDIM_STEPS_2D)
    check_output("path_25d real_context", out, (SWEEP_SLICES, IMAGE_SIZE, IMAGE_SIZE, 4))
    counts_by_call["path_25d_real_context"] = counts
    result["real_context"] = {"slices": SWEEP_SLICES, "batch": SWEEP_SLICES,
                              "steps": DDIM_STEPS_2D, "seconds_per_call": seconds,
                              "seconds_per_step": seconds / DDIM_STEPS_2D,
                              "flop_bound_ms_per_step": forward_bound_ms(SWEEP_SLICES, flops),
                              "peak_memory_bytes": peak, "launches": counts}
    del out

    generate_pseudo3d_hybrid(model, diffusion, SubjectSlices(volume[:2], radius), ddim_steps=2)
    out, seconds, peak, counts = timed(lambda: generate_pseudo3d_hybrid(
        model, diffusion, head, ddim_steps=HYBRID_STEPS,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 22)))
    forwards = HYBRID_SLICES * HYBRID_STEPS
    expect_gn("path_25d hybrid", counts, forwards)
    check_output("path_25d hybrid", out, (HYBRID_SLICES, IMAGE_SIZE, IMAGE_SIZE, 4))
    counts_by_call["path_25d_hybrid"] = counts
    one = head[len(head) // 2]
    args = (torch.randn(1, IMAGE_SIZE, IMAGE_SIZE, 4, device="cuda"),
            torch.tensor([500], device="cuda"), torch.tensor([float(one["z_pos"])], device="cuda"),
            torch.from_numpy(one["context"])[None].cuda())
    with torch.no_grad():
        host_us = host_issue_us(lambda: model(*args), calls=10)
        device_ms = time_ms(lambda: model(*args), spin=20 * SPIN_CYCLES)
    result["hybrid"] = {"slices": HYBRID_SLICES, "batch": 1, "steps": HYBRID_STEPS,
                        "seconds_per_call": seconds, "wall_ms_per_forward": seconds / forwards * 1e3,
                        "host_issue_us_per_forward": host_us,
                        "device_ms_per_forward": device_ms, "peak_memory_bytes": peak,
                        "launches": counts}
    if profile_slice:
        one_slice = SubjectSlices(volume[:1], radius, depth=SWEEP_SLICES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate_pseudo3d_hybrid(model, diffusion, one_slice, ddim_steps=HYBRID_STEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        result["hybrid"]["profile_one_slice"] = profile_window(prof, wall_ms, top=6,
                                                               host_top=12)
    print("path_25d " + json.dumps(result))
    return counts_by_call


def train_batches_2d(cfg, seed):
    """A seeded batch of the presets' size on the card: images in [-1, 1],
    z positions in [0, 1], and the 2.5D context where the model takes one."""
    rng = np.random.default_rng(seed)
    out_ch, ctx_ch = cfg.unet.out_channels, cfg.unet.in_channels - cfg.unet.out_channels
    shape = (BATCH_2D, IMAGE_SIZE, IMAGE_SIZE)
    batch = {"image": rng.uniform(-1, 1, (*shape, out_ch)).astype(np.float32),
             "z_pos": rng.uniform(0, 1, BATCH_2D).astype(np.float32)}
    if ctx_ch:
        batch["context"] = rng.uniform(-1, 1, (*shape, ctx_ch)).astype(np.float32)
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def build_2d_trainer(cfg, seed):
    """A preset's UNet2D as it is trained: float32 parameters, bf16 compute,
    seeded weights, Adam at the preset's 2e-4 with an EMA shadow, on the card;
    the 2D step with EMA 0.999 and guidance dropout 0.1."""
    model = seeded_weights(build_unet2d(cfg.unet), seed).train()
    state = create_train_state(model, cfg.train.learning_rate, ema=True)
    step = make_diffusion_train_step(model, build_diffusion(cfg.diffusion), ema_decay=0.999,
                                     cond_dropout=0.1)
    return model, state, step


def train_path_2d():
    """``make_diffusion_train_step`` at full width and the presets' batch of
    64 at 128²: ``preset_slice_cond_2d`` (1 channel) and ``preset_ddpm_25d``
    (2.5D, the context in every batch). 2 warm-up steps, then 5 counted: 29
    launches of each GroupNorm kernel a step, finite float32 losses, float32
    master parameters that all moved."""

    result, counts_by_run = {}, {}
    for name, preset in (("slice_cond_2d", preset_slice_cond_2d),
                         ("ddpm_25d", preset_ddpm_25d)):
        cfg = preset()
        model, state, step = build_2d_trainer(cfg, SEED + 23)
        batch = train_batches_2d(cfg, SEED + 24)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
        losses = []
        for _ in range(TRAIN_WARMUP_STEPS):
            state, loss = step(state, batch, gen)
            losses.append(loss)
        torch.cuda.synchronize()
        before = [p.detach().clone() for p in model.parameters()]

        def run():
            nonlocal state
            for _ in range(TRAIN_STEPS):
                state, loss = step(state, batch, gen)
                losses.append(loss)

        _, seconds, peak, counts = timed(run)
        expect_gn(f"train_path_2d {name}", counts, TRAIN_STEPS)
        losses = torch.stack(losses).cpu()
        if losses.dtype != torch.float32 or not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"train_path_2d {name}: losses {losses.tolist()}")
        for pname, p in model.named_parameters():
            if p.dtype != torch.float32 or p.grad is None or p.grad.dtype != torch.float32:
                raise AssertionError(f"train_path_2d {name}: {pname} is not a float32 master "
                                     "parameter")
        moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, model.parameters()))
        if moved != len(before) or state.step != TRAIN_WARMUP_STEPS + TRAIN_STEPS:
            raise AssertionError(f"train_path_2d {name}: {moved} of {len(before)} parameters "
                                 f"moved in {state.step} updates")
        counts_by_run[f"train_{name}"] = counts
        result[name] = {"in_channels": cfg.unet.in_channels, "seconds_per_step": seconds / TRAIN_STEPS,
                        "images_per_second": BATCH_2D * TRAIN_STEPS / seconds,
                        "peak_memory_bytes": peak,
                        "launches_per_step": {k: v // TRAIN_STEPS for k, v in counts.items()},
                        "losses": losses.tolist()}
        del model, state, step, before, batch
        torch.cuda.empty_cache()
    result.update({"batch": BATCH_2D, "steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP_STEPS,
                   "dtype": "bfloat16 compute, float32 parameters", "learning_rate": 2e-4,
                   "ema_decay": 0.999, "cond_dropout": 0.1, "loss_type": "mse"})
    print("train_path_2d " + json.dumps(result))
    return counts_by_run


# ------------------------------------------- the data pipeline and the drivers


def write_brats_tree(root):
    """``root/raw``: ``DRIVER_CASES`` BraTS cases at 240×240×155 per modality.
    ``DRIVER_SUBJECTS`` distinct subjects are written by the port's
    ``write_synthetic_brats`` (one thread each: numpy and gzip release the
    interpreter lock), and case i gets the files of subject i mod 3."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(DRIVER_SUBJECTS) as pool:
        futures = [pool.submit(write_synthetic_brats, root / f"subject{k}", 1, BRATS_SHAPE,
                               SEED + 30 + k) for k in range(DRIVER_SUBJECTS)]
        written = [f.result() / "BraTS2021_00000" for f in futures]
    t_write = time.perf_counter() - t0
    raw = root / "raw"
    for i in range(DRIVER_CASES):
        case = f"BraTS2021_{i:05d}"
        (raw / case).mkdir(parents=True)
        for mod in MODALITIES:
            shutil.copyfile(written[i % DRIVER_SUBJECTS] / f"BraTS2021_00000_{mod}.nii.gz",
                            raw / case / f"{case}_{mod}.nii.gz")
    for k in range(DRIVER_SUBJECTS):
        shutil.rmtree(root / f"subject{k}")
    return raw, {"write_subjects": t_write, "copy_cases": time.perf_counter() - t0 - t_write}


def host_seconds_per_batch(dataset, batch_size, batches):
    """Host seconds for one shuffled batch of ``dataset`` (the loader's own
    work: decode, normalize, crop, stack; no prefetch, no copy to the card),
    averaged over ``batches`` batches."""
    it = iter(BatchLoader(dataset, batch_size, seed=SEED, prefetch=0, device_put=False))
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    seconds = (time.perf_counter() - t0) / batches
    it.close()
    return {"batch": batch_size, "batches": batches, "seconds_per_batch": seconds}


def small_data_checks(raw, vol_dir, tmp):
    """Card against CPU: ``preprocess_slice_batch`` over all 155 slices of one
    FLAIR volume at 128² (``PREPROCESS_ATOL``), and ``pack_latents`` of a
    narrow float32 VAE (base 8, 2 levels, seeded small weights) over the
    centre 63×95×94 of one packed case, which pads to the downsample grid: kernels
    and cuDNN on the card, plain versions on the CPU (``PACK_LATENTS_ATOL``);
    the two index.json files equal, fingerprints within 1e-12 relative."""
    flair = nifti.load(next(raw.rglob("*_flair.nii.gz")))
    slices = torch.from_numpy(np.ascontiguousarray(np.moveaxis(flair, -1, 0)))
    got = preprocess_slice_batch(slices.cuda(), IMAGE_SIZE).cpu()
    err_pre = check_close("preprocess_slice_batch, card vs CPU", got,
                          preprocess_slice_batch(slices, IMAGE_SIZE), atol=PREPROCESS_ATOL)

    index = json.loads((vol_dir / "index.json").read_text())
    first = index["files"][0]["path"]
    with np.load(vol_dir / first) as z:
        vol = z["volume"]
    starts = [max((d - c) // 2, 0) for d, c in zip(vol.shape[1:], SMALL_VAE_CUT)]
    cut = np.ascontiguousarray(vol[(slice(None),) + tuple(
        slice(a, a + c) for a, c in zip(starts, SMALL_VAE_CUT))])
    src = tmp / "one_case"
    (src / first).parent.mkdir(parents=True)
    np.savez(src / first, volume=cut)
    (src / "index.json").write_text(json.dumps({**index, "files": [
        {"path": first, "shape": list(cut.shape)}]}))
    vae = seeded_weights(VAE3D(4, 8, 2, 4), SEED + 33)
    reset_launch_counts()
    on_card = pack_latents(src, tmp / "lat_card", copy.deepcopy(vae).cuda(), device="cuda")
    counts = all_launch_counts()
    on_cpu = pack_latents(src, tmp / "lat_cpu", vae, device="cpu")
    want_gn = 6    # 3 res blocks in a 2-level encoder, two norms each
    if (counts["gn_silu_stats"], counts["gn_silu_apply"]) != (want_gn, want_gn):
        raise AssertionError(f"small pack_latents: launch counts {counts}")
    fp_card, fp_cpu = on_card.pop("params_fingerprint"), on_cpu.pop("params_fingerprint")
    if abs(fp_card - fp_cpu) > 1e-12 * fp_cpu or on_card != on_cpu:
        raise AssertionError(f"small pack_latents: index {on_card} vs {on_cpu}")
    lat = [torch.from_numpy(np.load(d / first)["latent"])
           for d in (tmp / "lat_card", tmp / "lat_cpu")]
    err_lat = check_close("pack_latents, card vs CPU", lat[0], lat[1], atol=PACK_LATENTS_ATOL)
    print(f"small data checks: preprocess_slice_batch max abs err {err_pre:.3e}, "
          f"pack_latents max abs err {err_lat:.3e} ok")
    return {"preprocess_slice_batch_max_abs_err": err_pre, "pack_latents_max_abs_err": err_lat,
            "pack_latents_latent_shape": list(lat[0].shape), "launches": counts}


class DriverProbe:
    """Wraps, for the time of a ``with`` block, what ``run_experiment`` calls
    in ``mrijax_torch.train.experiments``: every step factory (each step is
    timed between two synchronisations and counted as train or val of the
    stage running; one train step a stage runs under ``torch.profiler`` for
    the card's busy share), ``_trainer`` (each stage's ``fit``: launch counts
    set to 0 before it and read after it, seconds, peak memory) and
    ``pack_latents`` (the same). Stages are named by their checkpoint
    directory; ``profile_at`` maps the last part of that name to the index of
    the train step to profile."""

    TRAIN = ("make_vae_train_step", "make_cached_latent_train_step",
             "make_latent_diffusion_train_step", "make_diffusion_train_step")
    EVAL = ("make_vae_eval_step", "make_cached_latent_eval_step",
            "make_latent_diffusion_eval_step", "make_diffusion_eval_step")

    def __init__(self, profile_at):
        self.profile_at = profile_at
        self.stages, self.stage, self._saved = {}, None, {}

    def __enter__(self):
        for name in self.TRAIN + self.EVAL + ("_trainer", "pack_latents"):
            self._saved[name] = getattr(experiments, name)
        for name in self.TRAIN + self.EVAL:
            setattr(experiments, name, self._factory(name))
        setattr(experiments, "_trainer", self._trainer)
        setattr(experiments, "pack_latents", self._pack_latents)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(experiments, name, fn)

    def _factory(self, name):
        factory, kind = self._saved[name], "train" if name in self.TRAIN else "val"

        def make(*args, **kwargs):
            step = factory(*args, **kwargs)

            def timed_step(*a, **kw):
                rec = self.stages[self.stage]
                index = rec[f"{kind}_steps"]
                rec[f"{kind}_steps"] += 1
                prof = None
                if kind == "train" and index == self.profile_at.get(self.stage.split("/")[-1]):
                    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    prof.start()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a, **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                if prof is not None:
                    prof.stop()
                    window = profile_window(prof, seconds * 1e3, top=8)
                    busy = window["device_busy_ms"]
                    rec["profiled_step"] = {
                        "index": index, "wall_ms_under_profiler": seconds * 1e3,
                        "device_busy_ms": busy,
                        "device_busy_share": busy / (seconds * 1e3) if busy else None,
                        "top": window["top"]}
                else:
                    rec[f"{kind}_step_seconds"].append(seconds)
                return out

            return timed_step

        return make

    def _open(self, stage):
        self.stage = stage
        self.stages[stage] = {"train_steps": 0, "val_steps": 0, "train_step_seconds": [],
                              "val_step_seconds": []}
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        return time.perf_counter()

    def _close(self, t0):
        torch.cuda.synchronize()
        rec = self.stages[self.stage]
        rec.update(seconds=time.perf_counter() - t0, launches=all_launch_counts(),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
        self.stage = None

    def _trainer(self, cfg_train, *, ckpt_dir, **kwargs):
        trainer = self._saved["_trainer"](cfg_train, ckpt_dir=ckpt_dir, **kwargs)
        fit = trainer.fit

        def probed_fit(state):
            t0 = self._open(ckpt_dir)
            result = fit(state)
            self._close(t0)
            self.stages[ckpt_dir]["epochs_run"] = result.epochs_run
            return result

        trainer.fit = probed_fit
        return trainer

    def _pack_latents(self, *args, **kwargs):
        t0 = self._open("pack_latents")
        index = self._saved["pack_latents"](*args, **kwargs)
        self._close(t0)
        self.stages["pack_latents"]["volumes"] = len(index["files"])
        return index


def expect_stage(tag, rec, want_steps, per_train, per_val=None):
    """Exact steps and launches of one stage: ``per_train`` / ``per_val`` are
    the launches of one train / val step (kernel name → count)."""
    per_val = per_val or {}
    if (rec["train_steps"], rec["val_steps"]) != want_steps:
        raise AssertionError(f"{tag}: {rec['train_steps']} train and {rec['val_steps']} val "
                             f"steps, expected {want_steps}")
    n_t, n_v = want_steps
    want = {k: n_t * per_train.get(k, 0) + n_v * per_val.get(k, 0)
            for k in all_launch_counts()}
    if rec["launches"] != want:
        raise AssertionError(f"{tag}: launch counts {rec['launches']}, expected {want}")


def gn_calls(n):
    return {"gn_silu_stats": n, "gn_silu_apply": n}


def run_driver(cfg, tmp, profile_at):
    """``run_experiment(cfg)`` on the card under a ``DriverProbe``."""
    reset_termination()
    logger = MetricsLogger("chip_smoke", run_name=f"{cfg.family}-{cfg.name}",
                           root=str(tmp / "runs"))
    with DriverProbe(profile_at) as probe:
        result = experiments.run_experiment(cfg, logger=logger)
    logger.finish()
    return result, probe.stages, logger


def check_losses(tag, logger, keys):
    losses = {k: by_epoch(logger, k) for k in keys}
    if not all(v and all(np.isfinite(x) for x in v.values()) for v in losses.values()):
        raise AssertionError(f"{tag}: losses {losses}")
    return losses


def driver_3d(raw, vol_dir, tmp):
    """``configs/ddpm_3d_ldm_tuned.json`` (read by ``ExperimentConfig.from_json``,
    the model as it is) through ``run_experiment`` from the packed volumes, with
    these cuts: ``latent_batch_size`` 8, ``debug_fast`` with 3 steps and 1
    epoch in both stages, checkpoints in a temporary directory. Stage 1 trains
    the VAE at 128×160×160 (3 steps, 1 val), ``pack_latents`` encodes the 10
    whole volumes, stage 2 trains the UNet3D from latent crops of (8, 32, 40,
    40, 16) (9 train latents: 1 step; the 1 val latent makes no full batch).
    Then the same call again: both stages resume at their end, the cache is
    fresh and not packed again, and no step runs."""
    cfg = ExperimentConfig.from_json(TUNED_CONFIG)
    model = (cfg.vae.base_channels, cfg.vae.num_down, cfg.vae.latent_channels, cfg.vae.remat,
             cfg.unet.base_channels, cfg.unet.channel_mults, cfg.unet.use_attention,
             cfg.unet.num_heads, cfg.unet.remat_levels, cfg.unet.compute_dtype,
             cfg.diffusion.timesteps, cfg.diffusion.loss_type, cfg.train.cache_latents,
             cfg.train.nan_guard, tuple(cfg.data.patch_size))
    if model != TUNED_MODEL:
        raise AssertionError(f"the tuned recipe is not the flagship: {model}")
    ckpt = tmp / "ckpt"
    cfg.name = "tuned"
    cfg.data.root_dir, cfg.data.packed_dir = str(raw), str(vol_dir)
    cfg.data.latent_batch_size = DRIVER_LATENT_BATCH
    for t in (cfg.train, cfg.vae_train):
        t.debug_fast, t.debug_max_steps, t.epochs, t.checkpoint_dir = (
            True, DRIVER_STEPS, 1, str(ckpt))
    t0 = time.perf_counter()
    (vae_res, ldm_res, scale), stages, logger = run_driver(cfg, tmp, {"vae": 1, "ldm": 0})
    seconds = time.perf_counter() - t0
    run_dir = ckpt / cfg.family / cfg.name
    vae_stage, ldm_stage = stages[f"{cfg.family}/{cfg.name}/vae"], stages[
        f"{cfg.family}/{cfg.name}/ldm"]
    remat = GN_VAE_FORWARD if cfg.vae.remat else 0
    expect_stage("driver 3D stage 1", vae_stage, (DRIVER_STEPS, 1),
                 gn_calls(GN_VAE_FORWARD + remat), gn_calls(GN_VAE_FORWARD))
    packed_counts = stages["pack_latents"]["launches"]
    if (stages["pack_latents"]["volumes"] != DRIVER_CASES
            or packed_counts != {**dict.fromkeys(packed_counts, 0),
                                 **gn_calls(DRIVER_CASES * GN_VAE_ENCODE)}):
        raise AssertionError(f"driver 3D pack_latents: {stages['pack_latents']}")
    flash = {"flash_attn_fwd": 1, "flash_attn_bwd_dkv": 1, "flash_attn_bwd_dq": 1}
    expect_stage("driver 3D stage 2", ldm_stage, (1, 0),
                 {**gn_calls(GN_CALLS_PER_UNET + GN_REMAT_LEVEL0_CALLS), **flash},
                 {**gn_calls(GN_CALLS_PER_UNET), "flash_attn_fwd": 1})
    if (vae_res.epochs_run, ldm_res.epochs_run) != (1, 1) or not scale > 0:
        raise AssertionError(f"driver 3D: epochs {vae_res.epochs_run}, {ldm_res.epochs_run}, "
                             f"latent scale {scale}")
    losses = check_losses("driver 3D", logger, ("vae_train_loss", "vae_val_loss",
                                                "ldm_train_loss", "ldm_val_loss"))

    # the latent cache: one (Cz, d, h, w) latent of every whole volume
    idx_path = run_dir / "latent_cache" / "index.json"
    index = json.loads(idx_path.read_text())
    fp = params_fingerprint(vae_res.state.model)
    f = 2 ** (cfg.vae.num_down - 1)
    want_shape = [-(-BRATS_SHAPE[2] // f), BRATS_SHAPE[0] // f, BRATS_SHAPE[1] // f,
                  cfg.vae.latent_channels]
    if (index["kind"] != "latents3d" or index["downsample"] != f
            or index["source_files"] != latent_source_files(vol_dir)
            or [x["shape"] for x in index["files"]] != [want_shape] * DRIVER_CASES
            or not abs(index["params_fingerprint"] - fp) <= FINGERPRINT_RTOL * abs(fp)):
        raise AssertionError(f"driver 3D latent cache index: {index}")
    latent = np.load(idx_path.parent / index["files"][0]["path"])["latent"]
    if latent.shape != (want_shape[-1], *want_shape[:3]) or not np.isfinite(latent).all():
        raise AssertionError(f"driver 3D latent cache: {latent.shape}")

    # the same call again: resume, no repack, no step
    mtime = idx_path.stat().st_mtime_ns
    t0 = time.perf_counter()
    (vae_again, ldm_again, scale_again), again, _ = run_driver(cfg, tmp, {})
    resume_seconds = time.perf_counter() - t0
    if ("pack_latents" in again or idx_path.stat().st_mtime_ns != mtime
            or latent_cache_is_stale(idx_path, params_fingerprint(vae_again.state.model),
                                     latent_source_files(vol_dir))):
        raise AssertionError("driver 3D resume: the latent cache was packed again or is stale")
    for tag, rec in again.items():
        expect_stage(f"driver 3D resume {tag}", rec, (0, 0), {})
    if (vae_again.epochs_run, ldm_again.epochs_run) != (0, 0) or scale_again != scale:
        raise AssertionError(f"driver 3D resume: epochs {vae_again.epochs_run}, "
                             f"{ldm_again.epochs_run}, latent scale {scale_again} vs {scale}")
    print(f"driver 3D: stage 1 {vae_stage['train_steps']} + {vae_stage['val_steps']} steps, "
          f"{stages['pack_latents']['volumes']} volumes packed, stage 2 "
          f"{ldm_stage['train_steps']} + {ldm_stage['val_steps']} steps, resumed ok")
    result = {"config": "configs/ddpm_3d_ldm_tuned.json", "seconds": seconds,
              "resume_seconds": resume_seconds, "latent_scale": scale, "losses": losses,
              "trainer_seconds_per_step": {k: {e: 1 / v for e, v in by_epoch(logger, k).items()}
                                           for k in ("vae_steps_per_s", "ldm_steps_per_s")},
              "latent_cache": {"volumes": len(index["files"]), "shape": want_shape,
                               "params_fingerprint": index["params_fingerprint"],
                               "trained_vae_fingerprint": fp},
              "stages": {"vae": vae_stage, "pack_latents": stages["pack_latents"],
                         "ldm": ldm_stage},
              "resume": {k: {"train_steps": r["train_steps"], "launches": r["launches"]}
                         for k, r in again.items()}}
    counts = {"driver_3d_vae": vae_stage["launches"],
              "driver_3d_pack_latents": stages["pack_latents"]["launches"],
              "driver_3d_ldm": ldm_stage["launches"]}
    return result, counts


def driver_2d(raw, packed, tmp):
    """``preset_slice_cond_2d`` and ``preset_ddpm_25d`` at full width (batch 64,
    128²) through ``run_experiment`` from their packed shards: debug_fast with 3
    steps, 1 epoch, ``val_fraction`` 0.25 (64 of the 256 debug items: one
    full validation batch). 29 launches of each GroupNorm kernel a forward."""
    result, counts = {}, {}
    for preset, packed_dir in ((preset_slice_cond_2d, packed["slices"]),
                               (preset_ddpm_25d, packed["multimodal"])):
        cfg = preset(str(raw), **{
            "name": "preset", "data.packed_dir": str(packed_dir),
            "data.val_fraction": DRIVER_VAL_FRACTION_2D, "train.debug_fast": True,
            "train.debug_max_steps": DRIVER_STEPS, "train.epochs": 1,
            "train.checkpoint_dir": str(tmp / "ckpt")})
        t0 = time.perf_counter()
        res, stages, logger = run_driver(cfg, tmp, {"preset": 1})
        seconds = time.perf_counter() - t0
        rec = stages[f"{cfg.family}/preset"]
        expect_stage(f"driver {cfg.family}", rec, (DRIVER_STEPS, 1),
                     gn_calls(GN_CALLS_PER_UNET2D), gn_calls(GN_CALLS_PER_UNET2D))
        if res.epochs_run != 1:
            raise AssertionError(f"driver {cfg.family}: {res.epochs_run} epochs")
        losses = check_losses(f"driver {cfg.family}", logger, ("train_loss", "val_loss"))
        result[cfg.family] = {"seconds": seconds, "batch": cfg.data.batch_size,
                              "in_channels": cfg.unet.in_channels, "losses": losses,
                              "trainer_seconds_per_step": {
                                  e: 1 / v for e, v in by_epoch(logger, "steps_per_s").items()},
                              **rec}
        counts[f"driver_{cfg.family}"] = rec["launches"]
        del res
    return result, counts


def driver_path():
    """The data pipeline and the experiment drivers at full width from BraTS
    files on disk: the tree (``write_brats_tree``); ``split_subjects`` and
    ``apply_split`` over it; ``pack_volumes`` and, on the card,
    ``pack_dataset`` and ``pack_multimodal_slices`` over all 10 cases; the
    loaders' host seconds per batch, raw NIfTI against packed; the small
    card-against-CPU checks; then ``run_experiment`` of the 3D family on the
    tuned recipe (``driver_3d``) and of the 2D and 2.5D presets
    (``driver_2d``). Prints the ``driver_path`` line; returns the launch
    counts of every stage."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_driver_") as tmp_name:
        tmp = Path(tmp_name)
        raw, seconds = write_brats_tree(tmp)

        t0 = time.perf_counter()
        cases = sorted(p for p in raw.iterdir() if p.is_dir())
        split = split_subjects(cases, seed=42)
        placed = apply_split(raw, tmp / "split", seed=42, mode="symlink")
        n = {k: len(v) for k, v in placed.items()}
        if n != {"train": 8, "val": 1, "test": 1} or placed != split or len(
                list((tmp / "split" / "train").iterdir())) != 8:
            raise AssertionError(f"split of {len(cases)} cases: {n}")
        seconds["split"] = time.perf_counter() - t0

        packed = {"volumes": tmp / "volumes", "slices": tmp / "slices",
                  "multimodal": tmp / "multimodal"}
        for name, fn in (("pack_volumes", lambda: pack_volumes(raw, packed["volumes"])),
                         ("pack_dataset", lambda: pack_dataset(
                             raw, packed["slices"], image_size=IMAGE_SIZE)),
                         ("pack_multimodal_slices", lambda: pack_multimodal_slices(
                             raw, packed["multimodal"], image_size=IMAGE_SIZE))):
            t0 = time.perf_counter()
            index = fn()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            if len(index["files"]) != DRIVER_CASES:
                raise AssertionError(f"{name}: {len(index['files'])} files")
        print("driver path: tree and packs " + json.dumps(seconds))

        patch = tuple(ExperimentConfig.from_json(TUNED_CONFIG).data.patch_size)
        loaders = {
            "2d_raw_nifti": host_seconds_per_batch(SliceDataset2D(raw, IMAGE_SIZE), BATCH_2D, 1),
            "2d_packed": host_seconds_per_batch(PackedSliceDataset(packed["slices"]),
                                                BATCH_2D, 2),
            "3d_raw_nifti": host_seconds_per_batch(VolumeDataset3D(raw, patch), 1, 2),
            "3d_packed": host_seconds_per_batch(PackedVolumeDataset(packed["volumes"], patch),
                                                1, 2),
        }
        small = small_data_checks(raw, packed["volumes"], tmp)
        result_3d, counts_3d = driver_3d(raw, packed["volumes"], tmp)
        seconds["pack_latents"] = result_3d["stages"]["pack_latents"]["seconds"]
        result_2d, counts_2d = driver_2d(raw, packed, tmp)
    result = {
        "cases": DRIVER_CASES, "subjects_written": DRIVER_SUBJECTS,
        "modality_shape": list(BRATS_SHAPE), "seconds": seconds,
        "loader_host_seconds_per_batch": loaders, "small_checks": small,
        "ddpm_3d_ldm": result_3d, **result_2d,
        "cuts": ["data.latent_batch_size 8 (tuned: 32)", "debug_fast, debug_max_steps 3",
                 "epochs 1 in both stages", "10 cases, 7 of them copies of 3 subjects",
                 "checkpoint_dir a temporary directory",
                 "2D / 2.5D: val_fraction 0.25 (preset: 0.1)"],
        "phase_seconds": time.perf_counter() - t_phase,
    }
    print("driver_path " + json.dumps(result))
    return {**counts_3d, **counts_2d}


CUDA_CORE_BF16_FLOPS = 2 * PEAK_FLOPS["float32"]   # paired bf16 FMAs: the most without tensor cores


def profile_2d(model, sample_window):
    """``--profile``: the window of 5 DDIM steps of ``sample_2d`` (64 images)
    that ``path_2d`` took, by kernel name; the time and rate of each of the
    three stride-2 ``Downsample2D`` convolutions at batch 64 in bf16; and 3
    train steps of the 1-channel model (batch 64), by kernel name.

    A convolution whose rate is above what the CUDA cores can do in bf16
    (2 × 67 TFLOP/s) runs on tensor cores (``tensor_cores``); the kernel
    names of the sampling window say which families cuDNN picked."""

    windows = {"sample_2d_5_ddim_steps": sample_window}
    downs = []
    size = IMAGE_SIZE
    for block in model.downs:
        down = block["down"]
        x = torch.randn(BATCH_2D, size, size, down.in_channels, device="cuda",
                        dtype=torch.bfloat16)
        with torch.no_grad():
            ms = time_ms(lambda: down(x))
        flops = 2 * BATCH_2D * (size // 2) ** 2 * down.out_channels * down.in_channels * 16
        rate = flops / ms / 1e9
        downs.append({"input": [BATCH_2D, size, size, down.in_channels], "ms": ms,
                      "tflops_per_s": rate, "tensor_cores": rate * 1e12 > CUDA_CORE_BF16_FLOPS})
        size //= 2
        del x
    windows["downsample_2d"] = downs

    cfg = preset_slice_cond_2d()
    tmodel, state, step = build_2d_trainer(cfg, SEED + 23)
    batch = train_batches_2d(cfg, SEED + 24)
    tgen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    for _ in range(TRAIN_WARMUP_STEPS):
        state, _ = step(state, batch, tgen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = step(state, batch, tgen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    windows["train_2d_3_steps"] = profile_window(prof, wall_ms, top=24)
    windows["train_2d_3_steps"]["device_busy_share"] = (
        windows["train_2d_3_steps"]["device_busy_ms"] / wall_ms)
    print("profile_2d " + json.dumps(windows))
    del tmodel, state, step, batch
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------- main


def report_ptxas(name):
    """Registers and spills of one library's kernels as ``ptxas -v`` printed
    them: the worst over all, and a line for every tensor-core kernel."""
    entry, spills, rows = None, 0, []
    for line in _build.build_log(name).splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry, spills = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = max(int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            rows.append((entry, int(m.group(1)), spills))
            entry = None
    print(f"  ptxas {name}: {len(rows)} kernels, at most "
          f"{max((r[1] for r in rows), default=0)} registers, at most "
          f"{max((r[2] for r in rows), default=0)} bytes spilled")
    labels = ("Dh", "warps", "16-row fragments a warp")
    for entry, regs, spilled in rows:
        if m := re.search(r"(flash_(?:fwd|bwd_dkv|bwd_dq)_tc_kernel)I((?:Li\d+E)+)", entry):
            params = ", ".join(f"{label}={value}" for label, value in
                               zip(labels, re.findall(r"Li(\d+)E", m.group(2))))
            print(f"    {m.group(1)}<{params}>: {regs} registers, {spilled} bytes spilled")


TENSOR_CORE_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel", "flash_bwd_dq_tc_kernel")


def tensor_core_proof(libs):
    """Count the ``HMMA``/``HGMMA`` instructions in the machine code of the two
    flash-attention libraries and of each tensor-core kernel in them (all its
    instantiations together); a library or kernel without any did not get its
    tensor-core code."""
    cuobjdump = _build.cuda_tool("cuobjdump")
    counts = dict.fromkeys(("flash_attention_fwd", "flash_attention_bwd") + TENSOR_CORE_KERNELS, 0)
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        sass = subprocess.run([cuobjdump, "-sass", str(libs[name])], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        counts[name] = len(re.findall(r"\bHG?MMA\.", sass))
        for function in re.split(r"\n\s*Function : ", sass)[1:]:
            kernel = next((k for k in TENSOR_CORE_KERNELS if k in function.split("\n", 1)[0]), None)
            if kernel:
                counts[kernel] += len(re.findall(r"\bHG?MMA\.", function))
    print("tensor_core_instructions " + json.dumps(counts))
    if min(counts.values()) == 0:
        raise AssertionError(f"a flash-attention library or kernel holds no HMMA/HGMMA "
                             f"instruction: {counts}")


def kernel_records(gn_worst, flash_worst, bwd_worst, gn_rows, flash_rows, bwd_rows,
                   counts_by_path):
    """One record per kernel, at its heaviest main-path shape in bf16 (the
    flash kernels at the training batch).
    ``launches`` adds up the counted runs of every path (``counts_by_path``:
    path name → launch counts); ``launches_by_path`` keeps them apart."""
    big = max(gn_rows, key=lambda r: r["shape"][0] * r["shape"][1] * r["shape"][2])
    fl = next(r for r in flash_rows
              if r["dtype"] == "bfloat16" and tuple(r["shape"]) == FLASH_TRAIN)
    bw = bwd_rows[0]
    src_gn = "mrijax_torch/csrc/groupnorm_silu.cu"
    src_bwd = "mrijax_torch/csrc/flash_attention_bwd.cu"

    def launches(name):
        by_path = {path: counts[name] for path, counts in counts_by_path.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    return [
        {"name": "gn_silu_stats", "route": "cuda", "source": src_gn,
         "replaces": "mrijax/kernels/groupnorm_pallas.py:120",
         **launches("gn_silu_stats"), "shape": big["shape"], "dtype": "bfloat16",
         "max_abs_err": gn_worst["gn_silu_stats"]["float32"],
         "max_abs_err_bf16": gn_worst["gn_silu_stats"]["bfloat16"],
         "ms": big["stats_ms"], "plain_ms": big["stats_plain_ms"],
         "bound_ms": big["stats_bound_ms"], "bound_by": "bytes",
         "library_ms": big["stats_library_ms"]},
        {"name": "gn_silu_apply", "route": "cuda", "source": src_gn,
         "replaces": "mrijax/kernels/groupnorm_pallas.py:135",
         **launches("gn_silu_apply"), "shape": big["shape"], "dtype": "bfloat16",
         "max_abs_err": gn_worst["gn_silu_apply"]["float32"],
         "max_abs_err_bf16": gn_worst["gn_silu_apply"]["bfloat16"],
         "ms": big["apply_ms"], "plain_ms": big["apply_plain_ms"],
         "bound_ms": big["apply_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "mrijax_torch/csrc/flash_attention_fwd.cu",
         "replaces": "mrijax/kernels/flash_attention_pallas.py:162",
         **launches("flash_attn_fwd"), "shape": fl["shape"], "dtype": fl["dtype"],
         "max_abs_err": flash_worst["float32"], "max_abs_err_bf16": flash_worst["bfloat16"],
         "ms": fl["ms"], "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
         "bound_by": fl["bound_by"], "library_ms": fl["library_ms"]},
        # library_ms of the two backward kernels is one call that computes dq,
        # dk and dv together
        {"name": "flash_attn_bwd_dkv", "route": "cuda", "source": src_bwd,
         "replaces": "mrijax/kernels/flash_attention_pallas.py:332",
         **launches("flash_attn_bwd_dkv"), "shape": bw["shape"], "dtype": bw["dtype"],
         "max_abs_err": bwd_worst["flash_attn_bwd_dkv"]["float32"],
         "max_abs_err_bf16": bwd_worst["flash_attn_bwd_dkv"]["bfloat16"],
         "ms": bw["dkv_ms"], "plain_ms": bw["dkv_plain_ms"], "bound_ms": bw["dkv_bound_ms"],
         "bound_by": bw["dkv_bound_by"], "library_ms": bw["library_ms"]},
        {"name": "flash_attn_bwd_dq", "route": "cuda", "source": src_bwd,
         "replaces": "mrijax/kernels/flash_attention_pallas.py:358",
         **launches("flash_attn_bwd_dq"), "shape": bw["shape"], "dtype": bw["dtype"],
         "max_abs_err": bwd_worst["flash_attn_bwd_dq"]["float32"],
         "max_abs_err_bf16": bwd_worst["flash_attn_bwd_dq"]["bfloat16"],
         "ms": bw["dq_ms"], "plain_ms": bw["dq_plain_ms"], "bound_ms": bw["dq_bound_ms"],
         "bound_by": bw["dq_bound_by"], "library_ms": bw["library_ms"]},
    ]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after building, comparing and timing the kernels "
                             "(prints no result line)")
    parser.add_argument("--profile", action="store_true",
                        help="print torch.profiler breakdowns by kernel: gn_silu_stats "
                             "calls (one launch each), 5 DDIM steps and one decode, "
                             "3 training steps; 5 DDIM steps of sample_2d, the 2D "
                             "stride-2 convolutions and 3 2D training steps")
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
        report_ptxas(name)
    tensor_core_proof(libs)

    rng = np.random.default_rng(SEED)
    gn_worst = compare_groupnorm(rng)
    flash_worst = compare_flash(rng)
    bwd_worst = compare_flash_backward(rng)
    compare_groupnorm_autograd(rng)
    torch.cuda.empty_cache()
    gn_rows, _ = time_groupnorm(rng)
    if args.profile:
        profile_groupnorm_stats(rng)
    time_groupnorm_backward(rng)
    flash_rows = time_flash(rng)
    bwd_rows = time_flash_backward(rng)
    torch.cuda.empty_cache()
    if args.kernels_only:
        return 0

    layout_check()
    small_pipeline_check()
    unet, vae, diffusion = build_flagship()
    result = main_path(unet, vae, diffusion)
    if args.profile:
        profile_main_path(unet, vae, diffusion)
    del unet, vae
    torch.cuda.empty_cache()

    small_training_check()
    train_counts, train_result = train_path()
    trainer_counts = trainer_path(train_result["no_remat"]["seconds_per_step"])
    if args.profile:
        profile_train_path()
    torch.cuda.empty_cache()

    gc.collect()   # the trainers of trainer_path and their state on the card
    torch.cuda.empty_cache()
    small_2d_check()
    model_2d, _, counts_2d, sample_window = path_2d(profile_steps=args.profile)
    if args.profile:
        profile_2d(model_2d, sample_window)
    del model_2d
    torch.cuda.empty_cache()
    counts_25d = path_25d(profile_slice=args.profile)
    torch.cuda.empty_cache()
    counts_train_2d = train_path_2d()
    counts_driver = driver_path()

    counts_by_path = {"generate": result["launches"],
                      "train_no_remat": train_counts["no_remat"],
                      "train_remat_level0": train_counts["remat_level0"],
                      **trainer_counts, **counts_2d, **counts_25d, **counts_train_2d,
                      **counts_driver}
    print(json.dumps({"kernels": kernel_records(
        gn_worst, flash_worst, bwd_worst, gn_rows, flash_rows, bwd_rows, counts_by_path)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
