#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mrijax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, needs one card
    python3 chip_smoke.py --kernels-only   # build + compare + time the kernels
    python3 chip_smoke.py --profile        # also torch.profiler breakdowns

What it does, in order:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, builds every kernel of ``mrijax_torch/csrc`` with ``nvcc``, and
   prints what ``ptxas`` says of the tensor-core kernels and how many ``HMMA``
   (``mma.sync``) and ``HGMMA`` (``wgmma``) instructions ``cuobjdump -sass``
   finds in the two flash-attention libraries and in each tensor-core kernel
   (none is a failure, and so is an instance of a warpgroup kernel without
   ``HGMMA``; the float32 forward and backward kernels run three TF32 passes
   on ``wgmma`` and are two),
   with every warning ``ptxas`` gave (a serialized ``wgmma`` among them);
2. calls each kernel's wrapper on CUDA tensors at the shapes the main path
   gives it (fp32 and bf16, plus ragged sizes) and holds the result against
   the kernel's plain PyTorch version on the same inputs (the float32
   kernels also against a second launch, bit for bit);
3. times kernel, plain version and — as a yardstick only, the port never calls
   it — the one PyTorch call that computes the same function, with CUDA
   events (warm-up, then the median of ``REPEATS`` single calls, device time
   only), beside the least time the card could take (bytes / 3.35 TB/s or
   flops / peak rate; for the float32 kernels also at the 165 TFLOP/s of
   three TF32 passes on the tensor cores, ``*_bound_tc_ms``), and
   the host's time to issue one wrapper call; the
   flash kernels also at N = 51 200 (4 heads of 32), with the rate of the
   exponentials beside the operations bound; GroupNorm+SiLU also weighted by
   its calls in one generate call; with ``--profile``, checks under
   ``torch.profiler`` that a ``gn_silu_stats`` call is one kernel launch;
   the GroupNorm+SiLU backward's two kernels (``gn_silu_bwd_reduce``,
   ``gn_silu_bwd_apply``) at every main-path training shape
   (``gn_backward_shapes``: the UNet3D at B = 32 and 8, the UNet2D at 64,
   the VAE3D's largest at 1) against the float64 gradient, float32 and
   bf16, twice bitwise, and timed beside the plain route and the 3-pass
   bytes bound (``groupnorm_backward_times``, summed over a training step);
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
   versions), its launches counted in the ``kernels`` line
   (``train_fp32_small``: the float32 backward kernels' training path);
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
   finite; one train step a stage is profiled for the card's busy share;
13. scores the two 2D runs of phase 12 with the evaluation suite
   (``eval_path``, inside phase 12's temporary tree): ``config.json`` beside
   each run, Inception-v3 / ResNet-18 / AlexNet-LPIPS weight files from the
   random-initialised torchvision-layout replicas of
   ``tests/torch_replicas.py`` through the port's converters, then
   ``evaluate_runs`` with them (128 samples a run from the raw NIfTI files,
   batches of 64, DDIM-20, 64 diversity pairs, improved PR, split "all", the
   2.5D run on channel 3). Each report carries every pretrained-path metric,
   finite and unsuffixed; exactly 2320 launches of each GroupNorm kernel a
   run (29 a forward × 20 steps × 4 sampler calls). The networks and SSIM on
   the card against the CPU (features within 1e-4·max|f|, SSIM 1e-5), the
   time of a run split into sampling, each extractor, SSIM, the host
   statistics and the loader, the Inception forward against its bound, and
   the host time of Dice / HD95 on BraTS-shaped label maps.

14. drives every subcommand of ``python -m mrijax_torch.cli`` at full width
   (``cli_path``, inside phase 12's temporary tree, through ``cli.main`` in
   this process so that the launch counts see it): ``doctor``, ``split``,
   ``preprocess`` of the three families (bitwise phase 12's shards), ``train``
   of both 2D presets and of the tuned 3D recipe at phase 12's cuts (each
   stage's steps and launches exact; ``energy_*`` metrics from NVML with the
   average power in (0, the power limit]; ``info``; ``obs.analyze``),
   ``export``, ``sample`` in all six modes (each bitwise a direct call of the
   library with the documented generator on the exported weights, launches
   exact), ``export-aot`` and ``serve`` of the 2D and 3D runs (the ``.pt2``
   holds no weight; served batches bitwise the eager sampler's, launches
   twice the eager call's; export seconds, first-batch and steady-state
   seconds), ``eval`` and ``eval-multi`` with phase 13's weight files,
   ``eval-seg``, ``convert-features`` (bitwise phase 13's files) and
   ``import-torch`` of the torch twins' reference-layout checkpoints at the
   presets' widths, each imported run sampled.
15. drives ``mrijax_torch.parallel`` on the card in a world of one
   (``parallel_path``, inside phase 12's temporary tree): ``train`` through
   the CLI as rank 0 of a job of one (``--coordinator file://…``: steps,
   launches and rank 0's files) and ``sample --data-parallel`` under
   torchrun's variables (bitwise the plain ``sample``); then in an NCCL
   group of one, phase 7's flagship train step through the data-parallel
   all-reduce, with the state sharded (FSDP) and with the bottleneck
   attention sequence-parallel, each bitwise the one-device state with its
   launches; the flat gradient all-reduce against its bound; and
   ``generate_3d_volumes(mesh=…)`` bitwise the plain call with shard 0's
   generator.
16. drives the entry points, the examples and the job scripts
   (``entry_points_path``): ``graft_entry.entry()`` (one forward of the
   flagship at (1, 32, 40, 40, 16): 29 launches of each GroupNorm kernel and
   one of the flash forward, ms and peak bytes; the same ``fn`` against its
   CPU build on the card's weights at a small bf16 latent),
   ``graft_entry.dryrun_multichip(1)`` (a process of its own in an NCCL
   group of one, with the JAX bars) and its refusal of one card too many;
   the three ``examples/torch_*.py`` through ``main([..., "--device",
   "cuda"])`` in this process, launches counted (the 3D LDM's attention at
   Dh = 4 runs all three flash kernels); and the four ``scripts/torch_*.sh``
   as processes of their own (training on ``configs/slice_cond_2d_tiny_cpu.json``,
   sampling that run, preprocessing on the CPU, the multi-node script under
   ``torchrun --nproc_per_node 1``).
17. drives the flash kernels' column-chunk route at full width
   (``large_head_path``): a small float32 UNet3D with 1 head and attention
   at level 1 (Dh 144 and 288) on the card against the CPU, generating and
   training (those training launches in the ``kernels`` line as
   ``large_head_train_fp32_small``); then the flagship UNet3D at 1 head with
   ``attention_levels=(1,)``
   (Dh 512 at the bottleneck, N = 800; Dh 256 at level 1, N = 6400) through
   ``generate_3d_volumes`` (2 volumes, 20 DDIM steps, VAE3D decode) and 2 +
   5 cached-latent train steps at batch 8, launches exact; one forward of
   the flagship at 2 heads (Dh 256); s a step and a call and peak memory
   beside the 4-head flagship's of phases 5 and 7.
18. runs the port's bench (``bench_path``): ``mrijax_torch.bench.main`` in
   this process for every mode with ``--tiny`` on the card (each mode through
   the kernels on CUDA tensors, its launch counts set to 0 just before and
   read just after, in the ``kernels`` line as ``bench_*``), then the
   headline once with ``--smoke`` (full widths: batch 8, decode chunks of 4,
   5 DDIM steps); each JSON line checked as ``tests/test_torch_bench.py``
   checks it on the CPU, with ``device`` naming this card and ``mfu`` in
   (0, 1]; the phase's seconds against its budget of 90.

Phases 2 and 3 also hold the three flash kernels at head dims above 128
(``FLASH_LARGE_DH``: Dh 256, 512 and 1024, and 192 and 320, zero-padded to
256 and 384; ``FLASH_LARGE_DH_CHUNK``: Nq ≠ Nk at Dh 512), which they take
in column chunks (256 in the float32 backward and the three bf16 warpgroup
kernels, 128 at an odd multiple of 128; the float32 forward holds every
column up to Dh 512 and takes chunks of 512 above),
against their plain versions at the bars of Dh 128, one launch a wrapper
call, two launches of each kernel bitwise equal, and time them beside the
plain versions, ``F.scaled_dot_product_attention`` and the bound at the true
head dim, with the registers and spills ``ptxas`` gave each kernel and the
bytes each bf16 kernel copies from L2 into shared memory (``flash_large_dh_times``);
and GroupNorm+SiLU at 4096 and 8192 channels (``GN_WIDE_CHANNELS``), compared
and timed (``groupnorm_times_wide_channels``).

Phases 2 and 3 also hold the three flash kernels at head dims they are not
compiled for (``FLASH_SMALL_DH``: Dh 4, 8 and 16, zero-padded to 32 by the
wrappers) against their plain versions, fp32 and bf16, and time them
through the wrappers and at the padded head dim alone, beside the bound at
the true head dim and ``F.scaled_dot_product_attention``
(``flash_small_dh_times``).

Phases 2 and 3 also hold the three flash kernels at Nq ≠ Nk (the
sequence-parallel chunks ``FLASH_CHUNKS``, q of N/d rows against k, v of N
rows) against their plain versions and, stacked and summed over the chunks,
against the full kernels, and time them (``flash_chunk_times``).

Phases 2 and 3 end with the 3D stride-2 convolution kernels (``conv3d_path``):
each instance holds ``HGMMA``; at the forward's main-path calls
(``CONV_SHAPES``: the UNet3D's two ``Downsample``s at batch 8 and 32, its two
``Upsample`` input gradients at 32 with the output gradient a slice of a
concatenation's, the VAE3D encoder's two ``Downsample``s) one launch, held
against the plain version in float32 (``conv3d_bar``) and timed beside its
operations bound, the plain version's one call and ``F.conv3d``
(``library_ms``); likewise the weight-gradient kernel at its calls
(``WGRAD_SHAPES``: the UNet3D's two ``Downsample``s and two ``Upsample``s at
batch 32, the VAE3D encoder's two ``Downsample``s) beside the library's
weight-only ``convolution_backward``, and twice bitwise; the ``Upsample``
input gradient through the module; 2 launches a bf16 UNet3D forward and 2
more in its backward, and 4 of the weight kernel in the backward
(``conv3d_k4s2_times``). Phases 5 and 7 hold the flagship to the same counts
(40 generating and no weight gradient; 20 and 20 in 5 train steps).

Phase 3 also prints the host time to issue one GroupNorm+SiLU pair and one
flash forward through the ``torch.library`` custom ops (the route of the
exported programs) beside the direct route that eager callers take.

The GroupNorm phases (2, 3) also take the UNet2D's seven (N, C) shapes:
compared at B = 2 and once at B = 310, timed at the presets' batch of 64 and
summed over one forward (``groupnorm_per_unet2d_forward``).

Any miss raises: the script exits non-zero and prints no result line. It
exits non-zero at once where ``torch.cuda.is_available()`` is false. TF32 is
switched off for convolutions and matrix products, so float32 comparisons are
float32. The last line is ``{"ok": true, "device": {...}}``; the line before
names the card; the line before that is the ``{"kernels": [...]}`` record,
and before it the script's total seconds and the ``bench_path`` line.
"""

import argparse
import ast
import contextlib
import copy
import dataclasses
import gc
import importlib.util
import inspect
import io
import json
import math
import os
import re
import shutil
import signal
import socket
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

from mrijax_torch import aot, cli, graft_entry, parallel
from mrijax_torch import bench as port_bench
from mrijax_torch import generate as generate_module
from mrijax_torch.config import (
    ExperimentConfig,
    _apply_overrides,
    preset_ddpm_25d,
    preset_ddpm_3d_ldm,
    preset_slice_cond_2d,
)
from mrijax_torch.data import (
    BatchLoader,
    MultiModalSliceDataset25D,
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
    Vae3dDiagnostics,
    generate_3d_volumes,
    generate_pseudo3d_hybrid,
    generate_pseudo3d_real_context,
    sample_2d,
    sample_pseudo3d_sweep,
)
from mrijax_torch.evals import features as eval_features
from mrijax_torch.evals import frechet as eval_frechet
from mrijax_torch.evals import harness as eval_harness
from mrijax_torch.evals import multi as eval_multi
from mrijax_torch.evals import (
    FeatureExtractor,
    InceptionFeatureExtractor,
    LPIPSDistance,
    ResNet18FeatureExtractor,
    dice_per_label,
    evaluate_runs,
    hd95_per_label,
    ms_ssim,
    ssim,
)
from mrijax_torch.io import (
    convert_inception_v3,
    convert_lpips_alex,
    convert_resnet18,
    load_params_npz,
    load_state,
    save_params_npz,
)
from mrijax_torch.kernels import _build
from mrijax_torch.kernels import conv3d as cv
from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.kernels import groupnorm as gn
from mrijax_torch.models import UNet2D, UNet3D, VAE3D
from mrijax_torch.models.blocks import Conv3d, Downsample, Upsample
from mrijax_torch.obs import MetricsLogger, analyze, install_signal_handlers, reset_termination
from mrijax_torch.obs.energy import NvmlPowerSensor
from mrijax_torch.ops.attention import multi_head_self_attention
from mrijax_torch.ops.norms import group_norm_silu
from mrijax_torch.parallel import shard_train_state
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
from mrijax_torch.train.experiments import (
    _trainer,
    build_diffusion,
    build_unet2d,
    build_unet3d,
    build_vae3d,
)

SEED = 0
REPEATS = 15
SPIN_CYCLES = 2_000_000   # ~1 ms of spinning: longer than the host needs to issue any timed call
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, each way
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; fp32 outside tensor cores
# fp32-grade products on the tensor cores: three TF32 passes (hi.hi + hi.lo +
# lo.hi) at the 495 TFLOP/s of one: the float32 backward kernels' arithmetic
TF32X3_FLOPS = 495e12 / 3
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
# sequence-parallel chunks: q of N/d rows against k, v of N rows, at the chunks a
# model axis of 2 and of 4 gives the training bottleneck, and of 2 the full latent
FLASH_CHUNKS = [((8, 400, 4, 128), (8, 800, 4, 128)),
                ((8, 200, 4, 128), (8, 800, 4, 128)),
                ((1, 25600, 4, 32), (1, 51200, 4, 32))]

# head dims the kernels are not compiled for, which the wrappers zero-pad to the
# next compiled one (32): the bottleneck of examples/torch_scaled_3d_ldm.py (4^3
# tokens, 16 channels in 4 heads: Dh 4) at its training batch of 2 and its
# sampling batch of 1, that of the dry run of mrijax_torch.graft_entry (16
# channels in 2 heads: Dh 8), Dh 16 at a ragged N, and Dh 4 over several tiles
FLASH_SMALL_DH = [(2, 64, 4, 4), (1, 64, 4, 4), (1, 64, 2, 8), (2, 130, 2, 16),
                  (1, 1000, 4, 4)]
# the dry run's bottleneck split over a model axis of 2: q of 32 rows against 64 keys
FLASH_SMALL_DH_CHUNK = ((1, 32, 2, 8), (1, 64, 2, 8))

# head dims above 128, which the kernels take in column chunks: the
# flagship's bottleneck (512 channels, 800 tokens) with 2 heads at the
# generation and the training batch, with 1 head, its level-1 attention
# (256 channels, 6400 tokens) with 1 head at the training and the
# generation batch, 1024 columns, and two head dims the wrappers zero-pad
# (192 -> 256 at a ragged N, 320 -> 384)
FLASH_LARGE_DH = [(2, 800, 2, 256), (8, 800, 2, 256), (8, 800, 1, 512), (8, 6400, 1, 256),
                  (2, 6400, 1, 256), (2, 800, 1, 1024), (2, 130, 1, 192), (1, 64, 1, 320)]
# the 1-head bottleneck split over a model axis of 2
FLASH_LARGE_DH_CHUNK = ((8, 400, 1, 512), (8, 800, 1, 512))
# GroupNorm+SiLU above the 3840 channels of the stats kernel's default shared
# memory: a UNet2D of base 256, mults (1, 2, 4, 8) concatenates 2048 + 2048
# channels in its deepest up block
GN_WIDE_CHANNELS = [(2, 256, 4096), (64, 256, 4096), (2, 64, 8192)]

TRAIN_BATCH = 8
TRAIN_WARMUP_STEPS = 2
TRAIN_STEPS = 5
PARALLEL_STEPS = 3   # phase 15's counted steps, after TRAIN_WARMUP_STEPS
FLASH_TRAIN = (TRAIN_BATCH, 800, 4, 128)
ONE_ULP = dict(atol=1e-5, rtol=2 ** -7)    # bf16 dk and dv: rounded once
TWO_ULPS = dict(atol=1e-5, rtol=2 ** -6)   # bf16 dq: rounded twice, around the Dh^-1/2 multiply
GN_REMAT_LEVEL0_CALLS = 8         # 4 res blocks at level 0, two norms each, run again in the backward
GN_TRAIN_BATCH_3D = 32            # the batch of the 3D training cells of benchmark_h100
GENERATION_KERNELS = ("gn_silu_stats", "gn_silu_apply", "flash_attn_fwd")
# The 3D stride-2 convolution kernel's main-path calls: (name, input (B, D, H,
# W, Cin), Cout, bias): the UNet3D's two Downsamples at the generation batch
# of 8 and the training batch of 32, the input gradients of its two Upsamples
# at 32 (the output gradient is a slice of the concatenation's, read through
# its strides; no bias), the VAE3D encoder's two Downsamples at one volume.
CONV_SHAPES = [
    ("unet_down0_b8", (8, 32, 40, 40, 128), 256, True),
    ("unet_down1_b8", (8, 16, 20, 20, 256), 512, True),
    ("unet_down0_b32", (32, 32, 40, 40, 128), 256, True),
    ("unet_down1_b32", (32, 16, 20, 20, 256), 512, True),
    ("unet_up0_dx_b32", (32, 32, 40, 40, 128), 256, False),
    ("unet_up1_dx_b32", (32, 16, 20, 20, 256), 512, False),
    ("vae_down0_b1", (1, 128, 160, 160, 64), 64, True),
    ("vae_down1_b1", (1, 64, 80, 80, 128), 128, True),
]
CONV_PER_UNET_FORWARD = 2    # the UNet3D's Downsamples
CONV_PER_UNET_BACKWARD = 2   # the input gradients of its Upsamples
# the weight-gradient kernel's calls: (name, the large side's (B, D, H, W, Cg),
# Cp, transposed); Downsample p = dy, g = x; Upsample p = x, g = dy, a slice
# of the concatenation's gradient as in the UNet's backward
WGRAD_SHAPES = [
    ("unet_down0_dw_b32", (32, 32, 40, 40, 128), 256, False),
    ("unet_down1_dw_b32", (32, 16, 20, 20, 256), 512, False),
    ("unet_up0_dw_b32", (32, 32, 40, 40, 128), 256, True),
    ("unet_up1_dw_b32", (32, 16, 20, 20, 256), 512, True),
    ("vae_down0_dw_b1", (1, 128, 160, 160, 64), 64, False),
    ("vae_down1_dw_b1", (1, 64, 80, 80, 128), 128, False),
]
WGRAD_PER_UNET_BACKWARD = 4  # the weight gradients of its Downsamples and Upsamples

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
    each looping over tens of slabs). ``GN_WIDE_CHANNELS``: 4096 and 8192
    channels, where the stats launch raises its shared-memory limit above
    the default 48 KB. Last, ``gn_far_from_zero``: x = 200 + 1.5·N(0, 1) at (2, 100, 64),
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
    cases += GN_WIDE_CHANNELS
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
    ~0.1. At every shape a second launch of the float32 kernel must give the
    same bits (out and lse).
    """

    def same_again(tag, q, k, v, out, lse):
        again = fa.flash_attention_forward(q, k, v)
        if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
            raise AssertionError(f"flash {tag}: a second launch gave other bits")

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
            if dtype == torch.float32:
                same_again(f"{key} {shape}", q, k, v, out, lse)
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
        if dtype == torch.float32:
            same_again(f"{key} {FLASH_LONG}", q, k, v, out, lse)
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
          f"float32 bitwise from launch to launch, max abs err {json.dumps(worst)}")
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
    bf16 dq between the two bars are counted and printed. At every shape a
    second launch of each kernel must give the same bits.
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
            again = (*fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta),
                     fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta))
            if not all(torch.equal(a, b) for a, b in zip(again, (dk, dv, dq))):
                raise AssertionError(f"flash bwd {key} {shape}: two launches of a kernel differ")
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
        again = (*fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta),
                 fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta))
        if not all(torch.equal(a, b) for a, b in zip(again, (dk, dv, dq))):
            raise AssertionError(f"flash bwd {key} {FLASH_LONG}: two launches of a kernel differ")
        del q, k, v, out, lse, dout, delta, dk, dv, dq, ref_dk, ref_dv, ref_dq, again
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
    print(f"compare flash backward: {len(shapes) + 1} shapes x 2 dtypes ({FLASH_LONG} among them) ok "
          f"and bitwise from launch to launch, "
          f"max abs err {json.dumps(worst)}; against autograd through the materialised "
          f"attention {independent:.3e}")
    print("flash_dq_bf16_beyond_one_ulp " + json.dumps(beyond_one_ulp))
    return worst


def _rows_by_block(fn, n, block):
    """``fn(rows)`` over blocks of ``block`` query rows, concatenated along N."""
    return [fn(slice(s, min(s + block, n))) for s in range(0, n, block)]


def compare_flash_chunks(rng):
    """The three flash kernels at Nq ≠ Nk — the chunks of query rows that
    sequence parallelism gives each rank, against all keys — at
    ``FLASH_CHUNKS`` in both dtypes.

    Each chunk's forward and backward is held against the plain versions on
    the same chunk (at N = 51 200 on blocks of query rows) at phases 2–3's
    bars. Then, as sequence parallelism assembles them: the chunks' outputs
    and lse stacked along N against the full kernel's (same bars), the
    chunks' dQ stacked against the full dq (two bf16 ulps) and their dK, dV
    summed in float32 against the full dk, dv — held to one bf16 ulp of the
    sum of the chunks' magnitudes, since every chunk's dK is rounded once on
    its own (float32: 1e-4)."""

    worst = {name: {"float32": 0.0, "bfloat16": 0.0}
             for name in ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")}
    rows = []
    for q_shape, kv_shape in FLASH_CHUNKS:
        nq, nk = q_shape[1], kv_shape[1]
        block = 4096 if nk > 10000 else None
        heads = q_shape[2]
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).replace("torch.", "")
            fwd_tol = dict(atol=1e-4) if dtype == torch.float32 else dict(atol=2e-3, rtol=1e-2)
            if dtype == torch.float32 and block:
                fwd_tol = dict(atol=1e-5)
            bwd_tol = dict(atol=1e-4) if dtype == torch.float32 else ONE_ULP
            dq_tol = dict(atol=1e-4) if dtype == torch.float32 else TWO_ULPS
            q, k, v = flash_inputs(rng, kv_shape, dtype)
            full_out, full_lse = fa.flash_attention_forward(q, k, v)
            dout = torch.from_numpy(rng.standard_normal(kv_shape, dtype=np.float32)).cuda().to(dtype)
            full_delta = fa.flash_attention_delta(full_out, dout)
            full_dk, full_dv = fa.flash_attn_bwd_dkv(q, k, v, dout, full_lse, full_delta)
            full_dq = fa.flash_attn_bwd_dq(q, k, v, dout, full_lse, full_delta)
            outs, lses, dqs, dks, dvs = [], [], [], [], []
            for c0 in range(0, nk, nq):
                tag = f"flash chunk {key} q{q_shape} of kv{kv_shape} rows {c0}+"
                qc, gc_ = q[:, c0:c0 + nq], dout[:, c0:c0 + nq]
                out, lse = fa.flash_attention_forward(qc, k, v)
                delta = fa.flash_attention_delta(out, gc_)
                dk, dv = fa.flash_attn_bwd_dkv(qc, k, v, gc_, lse, delta)
                dq = fa.flash_attn_bwd_dq(qc, k, v, gc_, lse, delta)
                if block is None:
                    ref_out, ref_lse = fa.flash_attention_reference(qc, k, v)
                    e = check_close(f"{tag} out", out, ref_out, **fwd_tol)
                    check_close(f"{tag} lse", lse, ref_lse, atol=1e-4)
                else:
                    e = 0.0
                    for r in range(0, nq, block):
                        sl = slice(r, r + block)
                        ref_out, ref_lse = fa.flash_attention_reference(qc[:, sl], k, v)
                        e = max(e, check_close(f"{tag} out rows {r}+", out[:, sl], ref_out,
                                               **fwd_tol))
                        check_close(f"{tag} lse rows {r}+", lse.view(heads, -1)[:, sl],
                                    ref_lse, atol=1e-4)
                    del ref_out, ref_lse
                worst["flash_attn_fwd"][key] = max(worst["flash_attn_fwd"][key], e)
                qb = 2048 if block else None
                ref_dk, ref_dv = fa.flash_attn_bwd_dkv_reference(qc, k, v, gc_, lse, delta,
                                                                 q_block=qb)
                ref_dq = fa.flash_attn_bwd_dq_reference(qc, k, v, gc_, lse, delta, q_block=qb)
                e = max(check_close(f"{tag} dk", dk, ref_dk, **bwd_tol),
                        check_close(f"{tag} dv", dv, ref_dv, **bwd_tol))
                worst["flash_attn_bwd_dkv"][key] = max(worst["flash_attn_bwd_dkv"][key], e)
                e = check_close(f"{tag} dq", dq, ref_dq, **dq_tol)
                worst["flash_attn_bwd_dq"][key] = max(worst["flash_attn_bwd_dq"][key], e)
                del ref_dk, ref_dv, ref_dq
                outs.append(out)
                lses.append(lse.view(q_shape[0], heads, -1))
                dqs.append(dq)
                dks.append(dk)
                dvs.append(dv)
            tag = f"flash chunks {key} {nk // nq} x q{q_shape} of kv{kv_shape}"
            check_close(f"{tag} stacked out", torch.cat(outs, 1), full_out, **fwd_tol)
            check_close(f"{tag} stacked lse", torch.cat(lses, 2).reshape(full_lse.shape),
                        full_lse, atol=1e-4)
            check_close(f"{tag} stacked dq", torch.cat(dqs, 1), full_dq, **dq_tol)
            sums = {}
            for name, parts, want in (("dk", dks, full_dk), ("dv", dvs, full_dv)):
                got = torch.stack([x.float() for x in parts]).sum(0)
                scale = torch.stack([x.float().abs() for x in parts]).sum(0)
                err = (got - want.float()).abs()
                bar = bwd_tol["atol"] + bwd_tol.get("rtol", 0.0) * scale
                if not bool((err <= bar).all()):
                    raise AssertionError(f"{tag} summed {name}: max err {float(err.max()):.3e}")
                sums[name] = float(err.max())
            rows.append({"q": list(q_shape), "kv": list(kv_shape), "dtype": key,
                         "chunks": nk // nq, "summed_dk_dv_max_abs_err": sums})
            del q, k, v, dout, full_out, full_lse, full_delta, full_dk, full_dv, full_dq
            del outs, lses, dqs, dks, dvs
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print("flash_chunks_compare " + json.dumps({"worst": worst, "assembled": rows}))
    return worst


def time_flash_chunks(rng):
    """The three kernels at each Nq ≠ Nk chunk in bf16: kernel, plain (not
    at N = 51 200), library (``F.scaled_dot_product_attention`` on the chunk;
    backward: forward + backward less forward, one call for dq, dk, dv) and
    the bound: operations 4·B·H·Nq·Nk·Dh (forward), 8· (dkv), 6· (dq) over
    the bf16 tensor-core rate, or bytes (q, out and their stats at Nq rows,
    k, v at Nk rows; the backward its operands and outputs)."""

    rows = []
    for q_shape, kv_shape in FLASH_CHUNKS:
        b, nq, h, d = q_shape
        nk = kv_shape[1]
        long = nk > 10000
        repeats = LONG_REPEATS if long else REPEATS
        dtype, key = torch.bfloat16, "bfloat16"
        q, k, v = flash_inputs(rng, kv_shape, dtype)
        q = q[:, :nq]
        out, lse = fa.flash_attention_forward(q, k, v)
        dout = torch.from_numpy(rng.standard_normal(q_shape, dtype=np.float32)).cuda().to(dtype)
        delta = fa.flash_attention_delta(out, dout)
        el = q.element_size()
        qt, kt, vt = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (q, k, v))
        dout_t = dout.permute(0, 2, 1, 3)

        def sdpa_fb():
            o = F.scaled_dot_product_attention(qt, kt, vt)
            torch.autograd.grad(o, (qt, kt, vt), dout_t)

        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), repeats)
        row = {"q": list(q_shape), "kv": list(kv_shape), "dtype": key,
               "library_backward_ms": time_ms(sdpa_fb, repeats) - sdpa_ms}
        q_bytes, kv_bytes, stat = b * nq * h * d * el, b * nk * h * d * el, 4 * b * h * nq
        for name, fn, ref, products, nbytes, lib in (
            ("fwd", lambda: fa.flash_attention_forward(q, k, v),
             lambda: fa.flash_attention_reference(q, k, v), 2,
             2 * q_bytes + 2 * kv_bytes + stat, sdpa_ms),
            ("dkv", lambda: fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta),
             lambda: fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta), 4,
             2 * q_bytes + 4 * kv_bytes + 2 * stat, None),
            ("dq", lambda: fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta),
             lambda: fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta), 3,
             3 * q_bytes + 2 * kv_bytes + 2 * stat, None),
        ):
            t_flops = products * 2 * b * h * nq * nk * d / PEAK_FLOPS[key] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            row.update({f"{name}_ms": time_ms(fn, repeats),
                        f"{name}_plain_ms": None if long else time_ms(ref),
                        f"{name}_bound_ms": max(t_flops, t_bytes),
                        f"{name}_bound_by": "operations" if t_flops >= t_bytes else "bytes"})
            if lib is not None:
                row[f"{name}_library_ms"] = lib
        rows.append(row)
        del q, k, v, out, lse, dout, delta, qt, kt, vt
        torch.cuda.empty_cache()
    print("flash_chunk_times " + json.dumps(rows))
    return rows


def compare_flash_head_dims(rng, cases, label):
    """The three flash kernels at head dims they do not take in one piece —
    ``cases`` of (q shape, kv shape): below 32 the wrappers zero-pad to 32,
    above 128 the kernels take Dh in column chunks (192 and 320 zero-padded
    to 256 and 384 first) — against their plain versions at the
    TRUE head dim, both dtypes, at phases 2–3's bars: out and lse (float32
    1e-4; bf16 out 2e-3 + 1e-2 relative, lse 1e-4), dk and dv (float32 1e-4,
    bf16 one ulp), dq (float32 1e-4, bf16 two ulps), and, where Nq = Nk, the
    gradients of ``flash_attention`` through autograd (the ``_FlashAttention``
    path of training). Each wrapper call must be one launch of its kernel, and
    a second launch of each kernel must give the same bits."""
    worst = {name: {"float32": 0.0, "bfloat16": 0.0}
             for name in ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")}
    for q_shape, kv_shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).replace("torch.", "")
            fwd_tol = dict(atol=1e-4) if dtype == torch.float32 else dict(atol=2e-3, rtol=1e-2)
            bwd_tol = dict(atol=1e-4) if dtype == torch.float32 else ONE_ULP
            dq_tol = dict(atol=1e-4) if dtype == torch.float32 else TWO_ULPS
            tag = f"flash {label} {key} q{q_shape} kv{kv_shape}"
            q, k, v = flash_inputs(rng, kv_shape, dtype)
            q = q[:, :q_shape[1]]
            reset_launch_counts()
            out, lse = fa.flash_attention_forward(q, k, v)
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
            e = check_close(f"{tag} out", out, ref_out, **fwd_tol)
            check_close(f"{tag} lse", lse, ref_lse, atol=1e-4)
            worst["flash_attn_fwd"][key] = max(worst["flash_attn_fwd"][key], e)
            del ref_out, ref_lse
            dout = torch.from_numpy(rng.standard_normal(q_shape, dtype=np.float32)).cuda().to(dtype)
            delta = fa.flash_attention_delta(out, dout)
            dk, dv = fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta)
            ref_dk, ref_dv = fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                                             q_block=1600)
            e = max(check_close(f"{tag} dk", dk, ref_dk, **bwd_tol),
                    check_close(f"{tag} dv", dv, ref_dv, **bwd_tol))
            worst["flash_attn_bwd_dkv"][key] = max(worst["flash_attn_bwd_dkv"][key], e)
            dq = fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta)
            ref_dq = fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta, q_block=1600)
            e = check_close(f"{tag} dq", dq, ref_dq, **dq_tol)
            worst["flash_attn_bwd_dq"][key] = max(worst["flash_attn_bwd_dq"][key], e)
            counts = all_launch_counts()
            if any(counts[name] != 1 for name in worst):
                raise AssertionError(f"{tag}: launches {counts}, expected one of each")
            again = (*fa.flash_attention_forward(q, k, v),
                     *fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta),
                     fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta))
            if not all(torch.equal(a, b) for a, b in zip(again, (out, lse, dk, dv, dq))):
                raise AssertionError(f"{tag}: two launches of a kernel differ")
            del again
            if q_shape == kv_shape:
                qkv = torch.stack([q, k, v], dim=2).requires_grad_()
                got, = torch.autograd.grad(
                    fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]), qkv, dout)
                check_close(f"{tag} autograd dk, dv", got[:, :, 1:],
                            torch.stack([ref_dk, ref_dv], dim=2), **bwd_tol)
                check_close(f"{tag} autograd dq", got[:, :, 0], ref_dq, **dq_tol)
                del qkv, got
            del q, k, v, out, lse, dout, delta, dk, dv, dq, ref_dk, ref_dv, ref_dq
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"compare flash {label}: {len(cases)} shapes x 2 dtypes ok (kernel head dims "
          f"{sorted({fa.kernel_head_dim(kv[3]) for _, kv in cases})}), "
          f"max abs err {json.dumps(worst)}")
    return worst


def time_flash_small_dh(rng):
    """The three kernels at the small head dims, through their wrappers (the
    zero-padding copies and the cut included, as the models call them), and
    at the padded head dim alone (``*_padded_kernel_ms``: the launch on
    operands padded beforehand), beside the plain versions, the library
    (``F.scaled_dot_product_attention``; backward: forward + backward less
    forward) and the bound of the work at the TRUE head dim: operations
    4·B·H·N²·Dh (forward), 8· (dkv), 6· (dq) over the rate of the input type,
    or the bytes of the operands and outputs read and written once."""
    rows = []
    for shape in FLASH_SMALL_DH:
        for dtype in (torch.float32, torch.bfloat16):
            b, n, h, d = shape
            key = str(dtype).replace("torch.", "")
            q, k, v = flash_inputs(rng, shape, dtype)
            out, lse = fa.flash_attention_forward(q, k, v)
            dout = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(dtype)
            delta = fa.flash_attention_delta(out, dout)
            size = fa.kernel_head_dim(d)
            qp, kp, vp, dp_ = (F.pad(t, (0, size - d)) for t in (q, k, v, dout))
            scale = d ** -0.5
            qt, kt, vt = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (q, k, v))
            dout_t = dout.permute(0, 2, 1, 3)

            def sdpa_fb():
                o = F.scaled_dot_product_attention(qt, kt, vt)
                torch.autograd.grad(o, (qt, kt, vt), dout_t)

            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            el = q.element_size()
            t_bytes, stat = b * n * h * d * el, 4 * b * h * n
            row = {"shape": list(shape), "dtype": key, "kernel_head_dim": size,
                   "library_backward_ms": time_ms(sdpa_fb) - sdpa_ms}
            dkv_out = [torch.empty_like(kp), torch.empty_like(kp)]
            dq_out = [torch.empty_like(qp)]
            for name, fn, padded, ref, products, nbytes, lib in (
                ("fwd", lambda: fa.flash_attention_forward(q, k, v),
                 lambda: fa._launch_forward(qp, kp, vp, scale),
                 lambda: fa.flash_attention_reference(q, k, v), 2,
                 4 * t_bytes + stat, sdpa_ms),
                ("dkv", lambda: fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta),
                 lambda: fa._launch_backward("flash_attn_bwd_dkv", qp, kp, vp, dp_, lse,
                                             delta, dkv_out, scale),
                 lambda: fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta), 4,
                 6 * t_bytes + 2 * stat, None),
                ("dq", lambda: fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta),
                 lambda: fa._launch_backward("flash_attn_bwd_dq", qp, kp, vp, dp_, lse,
                                             delta, dq_out, scale),
                 lambda: fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta), 3,
                 5 * t_bytes + 2 * stat, None),
            ):
                t_flops = products * 2 * b * h * n * n * d / PEAK_FLOPS[key] * 1e3
                t_mem = nbytes / HBM_BYTES_PER_S * 1e3
                row.update({f"{name}_ms": time_ms(fn),
                            f"{name}_padded_kernel_ms": time_ms(padded),
                            f"{name}_plain_ms": time_ms(ref),
                            f"{name}_bound_ms": max(t_flops, t_mem),
                            f"{name}_bound_by": "operations" if t_flops >= t_mem else "bytes",
                            **tensor_core_bound(name, products * 2 * b * h * n * n * d, t_mem,
                                                key)})
                if lib is not None:
                    row[f"{name}_library_ms"] = lib
            rows.append(row)
    print("flash_small_dh_times " + json.dumps(rows))
    return rows


def time_flash_large_dh(rng):
    """The three kernels at the head dims above 128, through their wrappers
    (as the models call them: the zero-padding copies at 192 and 320
    included), beside the plain versions, the library
    (``F.scaled_dot_product_attention``; backward: forward + backward less
    forward, one call for dq, dk and dv) and the bound of the work at the
    TRUE head dim: operations 4·B·H·Nq·Nk·Dh (forward), 8· (dkv), 6· (dq)
    over the rate of the input type, or the bytes of the operands and outputs
    read and written once. ``plan``: the launch (``chunks`` blocks along the
    grid's column axis). bf16 rows also carry the registers and spill bytes
    of the wide kernel that ran (``*_ptxas``; the forward's instance of its
    block's warpgroups) and the bytes it copies from L2 into shared memory
    (``*_l2_bytes``), and for ``dkv`` and ``dq`` the time of the operations
    with P and dU entering as two bf16 terms, 1.5 and 4/3 times the
    operations (``*_split_floor_ms``). float32 rows carry the bound of
    fp32-grade products on the tensor cores as well (``*_bound_tc_ms``) and
    the registers and spills of the instance of each kernel that ran
    (``*_ptxas``)."""
    rows = []
    ptxas = wide_ptxas()
    cases = [(shape, shape) for shape in FLASH_LARGE_DH] + [FLASH_LARGE_DH_CHUNK]
    for q_shape, kv_shape in cases:
        for dtype in (torch.bfloat16, torch.float32):
            b, nq, h, d = q_shape
            nk = kv_shape[1]
            key = str(dtype).replace("torch.", "")
            heavy = b * h * nq * nk * d >= 8 * 800 * 800 * 512 or dtype == torch.float32
            repeats = LONG_REPEATS if heavy else REPEATS
            q, k, v = flash_inputs(rng, kv_shape, dtype)
            q = q[:, :nq]
            out, lse = fa.flash_attention_forward(q, k, v)
            dout = torch.from_numpy(rng.standard_normal(q_shape, dtype=np.float32)).cuda().to(dtype)
            delta = fa.flash_attention_delta(out, dout)
            qt, kt, vt = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (q, k, v))
            dout_t = dout.permute(0, 2, 1, 3)

            def sdpa_fb():
                o = F.scaled_dot_product_attention(qt, kt, vt)
                torch.autograd.grad(o, (qt, kt, vt), dout_t)

            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), repeats)
            el = q.element_size()
            q_bytes, kv_bytes, stat = b * nq * h * d * el, b * nk * h * d * el, 4 * b * h * nq
            row = {"q": list(q_shape), "kv": list(kv_shape), "dtype": key,
                   "kernel_head_dim": fa.kernel_head_dim(d),
                   "library_backward_ms": time_ms(sdpa_fb, repeats) - sdpa_ms}
            kd = fa.kernel_head_dim(d)
            for name, kernel, fn, ref, products, nbytes, lib in (
                ("fwd", "flash_attn_fwd", lambda: fa.flash_attention_forward(q, k, v),
                 lambda: fa.flash_attention_reference(q, k, v), 2,
                 2 * q_bytes + 2 * kv_bytes + stat, sdpa_ms),
                ("dkv", "flash_attn_bwd_dkv",
                 lambda: fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta),
                 lambda: fa.flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                                         q_block=1600), 4,
                 2 * q_bytes + 4 * kv_bytes + 2 * stat, None),
                ("dq", "flash_attn_bwd_dq",
                 lambda: fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta),
                 lambda: fa.flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta,
                                                        q_block=1600), 3,
                 3 * q_bytes + 2 * kv_bytes + 2 * stat, None),
            ):
                t_flops = products * 2 * b * h * nq * nk * d / PEAK_FLOPS[key] * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                rows_of = nk if kernel == "flash_attn_bwd_dkv" else nq
                row.update({f"{name}_ms": time_ms(fn, repeats),
                            f"{name}_plain_ms": time_ms(ref, repeats),
                            f"{name}_bound_ms": max(t_flops, t_bytes),
                            f"{name}_bound_by": "operations" if t_flops >= t_bytes else "bytes",
                            f"{name}_plan": flash_plan_note(kernel, (b, rows_of, h, kd), dtype),
                            **tensor_core_bound(name, products * 2 * b * h * nq * nk * d,
                                                t_bytes, key)})
                if lib is not None:
                    row[f"{name}_library_ms"] = lib
            if dtype == torch.float32:
                row["fwd_ptxas"] = ptxas.get(f32_fwd_instance(kd))
                for name, dkv in (("dkv", True), ("dq", False)):
                    row[f"{name}_ptxas"] = ptxas.get(f32_instance(dkv, kd))
            if dtype == torch.bfloat16:
                tile = fa.launch_plan("flash_attn_fwd", b, nq, h, kd, dtype).tile
                row["fwd_ptxas"] = ptxas.get(f"flash_fwd_wide_tc_kernel<{tile // 64}>")
                row["fwd_l2_bytes"] = wide_forward_copy_bytes(b, nq, nk, h, kd, tile)
                for name, kernel, products, split in (("dkv", "flash_attn_bwd_dkv", 4, 1.5),
                                                      ("dq", "flash_attn_bwd_dq", 3, 4 / 3)):
                    row[f"{name}_ptxas"] = ptxas.get(f"flash_bwd_{name}_wide_tc_kernel")
                    row[f"{name}_split_floor_ms"] = (
                        split * products * 2 * b * h * nq * nk * d / PEAK_FLOPS[key] * 1e3)
                    row[f"{name}_l2_bytes"] = wide_backward_copy_bytes(kernel, b, nq, nk, h, kd)
            rows.append(row)
            del q, k, v, out, lse, dout, delta, qt, kt, vt
            torch.cuda.empty_cache()
    print("flash_large_dh_times " + json.dumps(rows))
    return rows


def gn_silu_float64(x, scale, bias, groups=GROUPS, eps=1e-5):
    """GroupNorm+SiLU in float64: the plain composition's arithmetic
    (``ops.norms.group_norm_silu`` casts to float32 first)."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    return F.silu(((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * scale + bias)


def gn_backward_shapes():
    """(B, N, C) -> calls per training step of each GroupNorm+SiLU backward
    of the main paths: the UNet3D's sites at the training cells' batch of 32
    and phase 7's ``TRAIN_BATCH``, the UNet2D's at ``BATCH_2D``, and the
    VAE3D's largest at one volume (``None``: not a UNet call)."""
    shapes = {}
    for b in (GN_TRAIN_BATCH_3D, TRAIN_BATCH):
        shapes.update({(b, n, c): per_unet for (n, c), (per_unet, _) in GN_MAIN_PATH.items()
                       if per_unet})
    shapes.update({(BATCH_2D, n, c): calls for (n, c), calls in GN_UNET2D.items()})
    shapes[(1, *GN_BIG)] = None
    return shapes


def relative_error(got, want):
    """max |got − want| over max |want|."""
    return float((got.double() - want).abs().max() / want.abs().max())


def compare_groupnorm_backward(rng):
    """The GroupNorm+SiLU ``autograd.Function`` on the card (forward and
    backward kernels) at every main-path backward shape, float32 and bf16,
    against the float64 gradient of the same function on the same inputs
    (max error over max value, dx, dscale and dbias): float32 within 1e-5;
    bf16 no further from float64 than the plain composition's own gradient
    (``ops.norms.group_norm_silu``, which rounds to bf16 before the SiLU).
    One launch of each of the four kernels, and a second forward and
    backward bitwise equal."""
    worst = {"float32": {}, "bfloat16": {}}
    names = ("dx", "dscale", "dbias")
    for b, n, c in gn_backward_shapes():
        x32, scale, bias = gn_inputs(rng, b, n, c)
        dy32 = torch.from_numpy(rng.standard_normal((b, n, c), dtype=np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).replace("torch.", "")
            tag = f"groupnorm backward {key} ({b},{n},{c})"
            x, dy = x32.to(dtype), dy32.to(dtype)
            leaves = [t.double().requires_grad_() for t in (x, scale, bias)]
            want = torch.autograd.grad(gn_silu_float64(*leaves), leaves, dy.double())
            del leaves
            leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]

            def kernels():
                y = gn.group_norm_silu_fused(*leaves, GROUPS)
                return torch.autograd.grad(y, leaves, dy)

            reset_launch_counts()
            got = kernels()
            if gn.launches.as_dict() != {**gn_calls(1), **gn_bwd_calls(1)}:
                raise AssertionError(f"{tag}: launches {gn.launches.as_dict()}")
            if not all(torch.equal(a, g) for a, g in zip(kernels(), got)):
                raise AssertionError(f"{tag}: two launches differ")
            errs = [relative_error(g, w) for g, w in zip(got, want)]
            if dtype == torch.float32:
                bars = [1e-5] * 3
            else:
                plain = torch.autograd.grad(group_norm_silu(leaves[0], GROUPS, *leaves[1:]),
                                            leaves, dy)
                bars = [relative_error(g, w) for g, w in zip(plain, want)]
                del plain
            for name, e, bar in zip(names, errs, bars):
                if not e <= bar:
                    raise AssertionError(f"{tag} {name}: relative error {e:.3e} above {bar:.3e}")
                worst[key][name] = max(worst[key].get(name, 0.0), e)
            del x, dy, want, got, leaves
        del x32, dy32
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print("compare_groupnorm_backward " + json.dumps(
        {"shapes": len(gn_backward_shapes()), "max_relative_error": worst}))
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
        # the same pair through the two custom ops (the exported programs' route)
        "fused_op_host_issue_us": host_issue_us(
            lambda: gn.gn_silu_apply_op(x, gn.gn_silu_stats_op(x, GROUPS, 1e-5), scale, bias)),
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
    rows_wide = []
    for b, n, c in GN_WIDE_CHANNELS:
        row = groupnorm_row(rng, b, n, c)
        row["stats_shared_bytes"] = gn.launch_plan(n, c, GROUPS, 2, 16, b).shared_bytes(c)
        rows_wide.append(row)
    print("groupnorm_times_wide_channels " + json.dumps(rows_wide))
    return rows, rows_2d, rows_wide


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


def gn_backward_kernel_ms(fn, calls=5):
    """Device ms a call of each GroupNorm+SiLU backward kernel under
    ``torch.profiler`` (``calls`` calls of ``fn``), or {} where the profiler
    recorded none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {name: sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                      if name in e.key) / 1e3 / calls
            for name in ("gn_silu_bwd_reduce", "gn_silu_bwd_apply")}


def time_groupnorm_backward(rng):
    """Per main-path backward shape in bf16 (the training batches, ``B``
    first; ``gn_backward_shapes`` at B = 32, 64 and 1): the backward kernels
    (``gn_silu_backward`` on the forward's stats; each kernel's share under
    the profiler), the plain route (the composition run again under autograd
    and differentiated, as the CPU takes it) and the bound: one read of x
    and dy and one write of dx (3 passes) at 3.35 TB/s. Summed over one
    training step at each family's batch (``per_train_step``)."""
    rows = []
    for (b, n, c), calls in gn_backward_shapes().items():
        if b == TRAIN_BATCH and b != GN_TRAIN_BATCH_3D:
            continue
        x32, scale, bias = gn_inputs(rng, b, n, c)
        x = x32.to(torch.bfloat16)
        dy = torch.from_numpy(rng.standard_normal((b, n, c), dtype=np.float32)).cuda()
        dy = dy.to(torch.bfloat16)
        del x32
        stats = gn.gn_silu_stats(x, GROUPS)
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]

        def plain():
            with torch.enable_grad():
                y = group_norm_silu(leaves[0], GROUPS, *leaves[1:])
            return torch.autograd.grad(y, leaves, dy)

        kernels = lambda: gn.gn_silu_backward(x, dy, stats, scale, bias)  # noqa: E731
        rows.append({
            "shape": [b, n, c], "dtype": "bfloat16", "calls_per_step": calls,
            "ms": time_ms(kernels), "plain_ms": time_ms(plain),
            "bound_ms": 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3,
            "kernel_ms": gn_backward_kernel_ms(kernels),
            "host_issue_us": host_issue_us(kernels),
            "plan": dataclasses.asdict(gn.backward_plan(b, n, c, GROUPS, x.element_size())),
        })
        del x, dy, stats, leaves
        torch.cuda.empty_cache()
    per_step = {str(batch): {k: sum(r[k] * r["calls_per_step"] for r in rows
                                    if r["shape"][0] == batch and r["calls_per_step"])
                             for k in ("ms", "plain_ms", "bound_ms")}
                for batch in (GN_TRAIN_BATCH_3D, BATCH_2D)}
    print("groupnorm_backward_times " + json.dumps({"per_train_step": per_step, "rows": rows}))
    return rows


# ------------------------------------------------ phase 2/3: conv3d_k4s2


def conv3d_bar(want):
    """The bar of the bf16 convolution kernel against its plain version
    computed in float32 from the same bf16 operands: the kernel rounds its
    fp32 sum once to bf16, so it lies within half a bf16 ulp (2^-8 relative)
    of the plain float32 sum, plus 1e-4 of the largest output for the two
    sums' different order (the tensor cores' fp32 accumulation included)."""
    return 2 ** -8 * want.abs() + 1e-4 * want.abs().max()


def check_conv3d(name, got, want):
    """Raise unless ``got`` (bf16) meets ``conv3d_bar``; returns the largest
    error relative to the largest output."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: got {got.dtype} {tuple(got.shape)}, want {tuple(want.shape)}")
    err = (got.float() - want).abs()
    if not bool(torch.isfinite(err).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    beyond = int((err > conv3d_bar(want)).sum())
    if beyond:
        raise AssertionError(f"{name}: {beyond} elements beyond the bar, max abs err "
                             f"{float(err.max()):.3e}")
    return float(err.max() / want.abs().max())


def conv3d_operands(index, x_shape, c_out, bias, strided):
    """Seeded bf16 operands; ``strided``: x is the first half of the
    channels of a tensor twice as wide, as a concatenation's gradient is."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 50 + index)
    b, d, h, w, c_in = x_shape
    x = torch.randn(b, d, h, w, 2 * c_in if strided else c_in, device="cuda", generator=g)
    x = x.bfloat16()[..., :c_in]
    weight = (torch.randn(c_out, c_in, 4, 4, 4, device="cuda", generator=g)
              / (64 * c_in) ** 0.5).bfloat16().contiguous(memory_format=torch.channels_last_3d)
    b_ = (0.1 * torch.randn(c_out, device="cuda", generator=g)).bfloat16() if bias else None
    return x, weight, b_


def conv3d_path():
    """The 3D stride-2 convolution kernels: their instances hold ``HGMMA``;
    at each main-path call (``CONV_SHAPES``, ``WGRAD_SHAPES``) one launch,
    held against the plain version in float32 (``conv3d_bar``) and timed
    beside its operations bound, the plain version's one call and the
    library's call (``library_ms``, cuDNN, the yardstick only); the weight
    kernel twice, bitwise; the ``Upsample`` input gradient through the
    module against the plain version; launches of a UNet3D: 2 a forward, 2
    more and 4 of the weight kernel in its backward."""
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                           str(_build.build_all()["conv3d_k4s2"])],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    functions = re.split(r"\n\s*Function : ", sass)[1:]
    for kernel in ("conv3d_k4s2_kernel", "conv3d_k4s2_wgrad_kernel"):
        hgmma = [len(re.findall(r"\bHGMMA\.", f)) for f in functions if kernel in f]
        if len(hgmma) != len(cv.TILE_N) or min(hgmma) == 0:
            raise AssertionError(f"{kernel} instances' HGMMA counts {hgmma}")
    rows = {}
    for i, (name, x_shape, c_out, bias) in enumerate(CONV_SHAPES):
        x, weight, b = conv3d_operands(i, x_shape, c_out, bias, strided=not bias)
        cv.launches.reset()
        got = cv.conv3d_k4s2(x, weight, b)
        if cv.launches["conv3d_k4s2"] != 1:
            raise AssertionError(f"{name}: {cv.launches['conv3d_k4s2']} launches")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cv.conv3d_k4s2_reference(x.float(), weight.float(), None if b is None else b.float())
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rel = check_conv3d(name, got, want)
        del got, want
        x_cf = x.permute(0, 4, 1, 2, 3)
        flops = cv.operations(x_shape, c_out, bias)
        rows[name] = {
            "shape": list(x_shape), "c_out": c_out, "plan": dataclasses.asdict(
                cv.launch_plan(x_shape[0] * math.prod(cv.output_spatial(x_shape[1:4])), c_out)),
            "max_rel_err": rel, "kernel_ms": time_ms(lambda: cv.conv3d_k4s2(x, weight, b)),
            "plain_ms": plain_ms,
            "library_ms": time_ms(lambda: F.conv3d(x_cf, weight, b, 2, 1)),
            "bound_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3, "operations": flops,
        }
        rows[name]["x_bound"] = rows[name]["kernel_ms"] / rows[name]["bound_ms"]
        del x, x_cf, weight, b
        torch.cuda.empty_cache()

    for i, (name, g_shape, c_p, transposed) in enumerate(WGRAD_SHAPES):
        g, _, _ = conv3d_operands(70 + i, g_shape, c_p, False, strided=transposed)
        b = g_shape[0]
        small = cv.output_spatial(g_shape[1:4])
        p = torch.randn(b, *small, c_p, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 80 + i))
        p = p.bfloat16()
        cv.launches.reset()
        got = cv.conv3d_k4s2_wgrad(p, g)
        if cv.launches["conv3d_k4s2_wgrad"] != 1:
            raise AssertionError(f"{name}: {cv.launches['conv3d_k4s2_wgrad']} launches")
        if not torch.equal(got, cv.conv3d_k4s2_wgrad(p, g)):
            raise AssertionError(f"{name}: two calls differ")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cv.conv3d_k4s2_wgrad_reference(p.float(), g.float())
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rel = check_conv3d(name, got, want)
        del got, want
        # the library call the kernel replaces: (dy, x) channels-first views
        dy_cf, x_cf = ((g, p) if transposed else (p, g))
        dy_cf, x_cf = dy_cf.permute(0, 4, 1, 2, 3), x_cf.permute(0, 4, 1, 2, 3)
        w_lib = torch.empty(c_p, g_shape[-1], 4, 4, 4, dtype=torch.bfloat16, device="cuda")
        w_lib = w_lib.contiguous(memory_format=torch.channels_last_3d)
        flops = cv.operations(g_shape, c_p, bias=False)
        plan = cv.wgrad_plan(b * math.prod(small), c_p, g_shape[-1])
        rows[name] = {
            "g_shape": list(g_shape), "c_p": c_p, "transposed": transposed,
            "plan": dataclasses.asdict(plan), "max_rel_err": rel,
            "kernel_ms": time_ms(lambda: cv.conv3d_k4s2_wgrad(p, g)), "plain_ms": plain_ms,
            "library_ms": time_ms(lambda: torch.ops.aten.convolution_backward(
                dy_cf, x_cf, w_lib, None, [2] * 3, [1] * 3, [1] * 3, transposed, [0] * 3, 1,
                [False, True, False])),
            "bound_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3, "operations": flops,
        }
        rows[name]["x_bound"] = rows[name]["kernel_ms"] / rows[name]["bound_ms"]
        del g, p, dy_cf, x_cf, w_lib
        torch.cuda.empty_cache()

    # the Upsample's input gradient through the module, the output gradient a
    # slice of a concatenation's; weight and bias gradients are the library's
    up = Upsample(256, 128, dtype=torch.bfloat16).cuda().to(memory_format=torch.channels_last_3d)
    g = torch.Generator(device="cuda").manual_seed(SEED + 60)
    x = torch.randn(2, 16, 20, 20, 256, device="cuda", generator=g).bfloat16().requires_grad_()
    skip = torch.randn(2, 32, 40, 40, 128, device="cuda", generator=g).bfloat16()
    dz = torch.randn(2, 32, 40, 40, 256, device="cuda", generator=g).bfloat16()
    cv.launches.reset()
    torch.cat([up(x), skip], dim=-1).backward(dz)
    if cv.launches["conv3d_k4s2"] != 1:
        raise AssertionError(f"Upsample backward: {cv.launches['conv3d_k4s2']} launches")
    want = cv.conv3d_k4s2_reference(dz[..., :128].float(), up.weight.detach().float())
    rows["upsample_module_dx"] = {"max_rel_err": check_conv3d("Upsample dx", x.grad, want)}
    del up, x, skip, dz, want

    unet = UNet3D(in_channels=LATENT_CHANNELS, base_channels=32, channel_mults=(1, 2, 4),
                  time_emb_dim=32, num_heads=1, dtype=torch.bfloat16,
                  param_dtype=torch.float32).cuda()
    latent = torch.randn(2, 8, 8, 8, LATENT_CHANNELS, device="cuda", generator=g)
    t = torch.tensor([3, 200], device="cuda")
    cv.launches.reset()
    with torch.no_grad():
        unet(latent, t)
    forward = cv.launches["conv3d_k4s2"]
    cv.launches.reset()
    loss = unet(latent, t).square().mean()
    loss.backward()
    both, wgrad = cv.launches["conv3d_k4s2"], cv.launches["conv3d_k4s2_wgrad"]
    if (forward, both) != (CONV_PER_UNET_FORWARD, CONV_PER_UNET_FORWARD + CONV_PER_UNET_BACKWARD):
        raise AssertionError(f"UNet3D conv3d_k4s2 launches: {forward} a forward, {both} a "
                             f"forward and backward")
    if wgrad != WGRAD_PER_UNET_BACKWARD:
        raise AssertionError(f"UNet3D conv3d_k4s2_wgrad launches: {wgrad} a backward")
    if not all(bool(torch.isfinite(p.grad).all()) for p in unet.parameters()):
        raise AssertionError("UNet3D gradients are not finite")
    rows["unet3d_launches"] = {"forward": forward, "forward_and_backward": both,
                               "weight_gradients": wgrad}
    print("conv3d_k4s2_times " + json.dumps(rows))
    return rows


def tensor_core_bound(name, flops, t_bytes, key):
    """``{name}_bound_tc_ms`` of a float32 flash kernel (``fwd``, ``dkv``,
    ``dq``): the larger of its flops over the rate of fp32-grade products on
    the tensor cores (``TF32X3_FLOPS``) and ``t_bytes`` ms, beside the
    CUDA-core bound that ``PEAK_FLOPS`` gives; nothing for bf16."""
    if key != "float32" or name not in ("fwd", "dkv", "dq"):
        return {}
    return {f"{name}_bound_tc_ms": max(flops / TF32X3_FLOPS * 1e3, t_bytes)}


def flash_plan_note(kernel, shape, dtype):
    plan = fa.launch_plan(kernel, *shape, dtype)
    return {"tile": plan.tile, "warps": plan.warps, "blocks": plan.blocks,
            "shared_bytes": plan.shared_bytes}


def time_flash(rng):
    """The forward kernel, its plain version, the library yardstick and the
    bound, per shape. At N = 51 200 the plain version cannot hold its logits
    (``plain_ms`` is null there), fewer calls are timed, and ``exp_ms`` is the
    time the card's special-function units need for the B·H·N² exponentials.
    ``bound_tc_ms``: the bound of three TF32 passes on the tensor cores
    (float32 rows; null for bf16)."""

    rows = []
    for shape, dtype, repeats in (
            (FLASH_MAIN, torch.bfloat16, REPEATS), (FLASH_MAIN, torch.float32, REPEATS),
            (FLASH_OTHER[0], torch.bfloat16, REPEATS), (FLASH_TRAIN, torch.bfloat16, REPEATS),
            (FLASH_TRAIN, torch.float32, REPEATS),
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
            "op_host_issue_us": host_issue_us(lambda: fa.flash_attn_fwd_op(q, k, v),
                                              calls=200 if shape != FLASH_LONG else 3),
            "plan": flash_plan_note("flash_attn_fwd", shape, dtype),
            "bound_tc_ms": tensor_core_bound("fwd", flops, t_bytes, key).get("fwd_bound_tc_ms"),
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
    worth of ``mma`` for those 4. float32: ``*_bound_ms`` at the 67 TFLOP/s of
    the CUDA cores, ``*_bound_tc_ms`` at the 165 TFLOP/s of fp32-grade
    products on the tensor cores (three TF32 passes, ``TF32X3_FLOPS``), the
    kernels' arithmetic. At N = 51 200 the plain versions are not timed and
    fewer calls are."""

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
                **tensor_core_bound(name, products * 2 * b * h * n * n * d, t_bytes, key),
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


def build_flagship(num_heads=4, attention_levels=()):
    """The flagship pair at full width, bf16, seeded random weights, on the card
    (``num_heads`` and ``attention_levels``: phase 17's variants)."""

    unet = seeded_weights(UNet3D(
        in_channels=LATENT_CHANNELS, base_channels=128, channel_mults=(1, 2, 4),
        use_attention=True, num_heads=num_heads, attention_levels=attention_levels,
        time_emb_dim=256, dtype=torch.bfloat16,
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
    want = {**gn_calls(want_gn), **gn_bwd_calls(0), "flash_attn_fwd": DDIM_STEPS,
            "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}   # no gradient when sampling
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if (cv.launches["conv3d_k4s2"], cv.launches["conv3d_k4s2_wgrad"]) != (
            DDIM_STEPS * CONV_PER_UNET_FORWARD, 0):
        raise AssertionError(f"conv3d_k4s2 launches {cv.launches.as_dict()}, expected "
                             f"{DDIM_STEPS * CONV_PER_UNET_FORWARD} and no weight gradient")
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
    cv.launches.reset()


def small_training_check():
    """3 cached-latent Adam steps of a narrow float32 UNet3D with attention
    and level-0 rematerialisation: on the card (forward and backward kernels)
    and on the CPU (plain versions), from the same weights, latents, timesteps
    and noise. Returns the card run's launch counts (the float32 backward
    kernels' training path). Tolerances: losses 1e-4 absolute (float32 sums in another
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
        if device == "cuda":
            card_counts = counts
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
          f"{loss_err:.3e}, parameter rel-L2 {rel:.3e}, EMA rel-L2 {rel_ema:.3e} ok, "
          f"launches {json.dumps(card_counts)}")
    return card_counts


def build_flagship_trainer(remat_levels, mesh=None, sp_mesh=None, num_heads=4,
                           attention_levels=()):
    """The flagship UNet3D as it is trained: float32 parameters, bf16 compute,
    seeded weights, Adam lr 1e-4 and an EMA shadow, on the card. ``mesh``:
    the step's data-parallel mesh; ``sp_mesh``: the attention's token axis
    split over its ``model`` axis; ``num_heads``, ``attention_levels``: phase
    17's variant."""
    unet = seeded_weights(UNet3D(
        in_channels=LATENT_CHANNELS, base_channels=128, channel_mults=(1, 2, 4),
        use_attention=True, num_heads=num_heads, attention_levels=attention_levels,
        time_emb_dim=256, remat_levels=remat_levels,
        dtype=torch.bfloat16, param_dtype=torch.float32,
        sp_axis="model" if sp_mesh is not None else None, mesh=sp_mesh,
    ), SEED + 1).train()
    state = create_train_state(unet, 1e-4, ema=True)
    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(T_STEPS)),
                                  loss_type="min_snr").to("cuda")
    return unet, state, make_cached_latent_train_step(unet, diffusion, ema_decay=0.999,
                                                      mesh=mesh)


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
        want = {**gn_calls(TRAIN_STEPS * gn_per_step),
                **gn_bwd_calls(TRAIN_STEPS * GN_CALLS_PER_UNET),
                "flash_attn_fwd": TRAIN_STEPS, "flash_attn_bwd_dkv": TRAIN_STEPS,
                "flash_attn_bwd_dq": TRAIN_STEPS}
        if counts != want:
            raise AssertionError(f"train path {tag}: launch counts {counts}, expected {want}")
        want_conv = {"conv3d_k4s2": TRAIN_STEPS * (CONV_PER_UNET_FORWARD + CONV_PER_UNET_BACKWARD),
                     "conv3d_k4s2_wgrad": TRAIN_STEPS * WGRAD_PER_UNET_BACKWARD}
        if cv.launches.as_dict() != want_conv:
            raise AssertionError(f"train path {tag}: conv3d_k4s2 launches "
                                 f"{cv.launches.as_dict()}, expected {want_conv}")
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
                    "gn_silu_bwd_reduce": train_steps * per_unet,
                    "gn_silu_bwd_apply": train_steps * per_unet,
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


def expect_gn(tag, counts, forwards, backwards=0):
    """Exactly 29 launches of each GroupNorm kernel per UNet2D forward (of
    each backward kernel per backward), and no flash-attention launch (the
    UNet2D has no attention)."""
    want = {**gn_calls(forwards * GN_CALLS_PER_UNET2D),
            **gn_bwd_calls(backwards * GN_CALLS_PER_UNET2D),
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
        expect_gn(f"train_path_2d {name}", counts, TRAIN_STEPS, backwards=TRAIN_STEPS)
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


def gn_bwd_calls(n):
    return {"gn_silu_bwd_reduce": n, "gn_silu_bwd_apply": n}


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


def driver_3d_cuts(raw, vol_dir, ckpt):
    """``driver_path``'s cuts of the tuned recipe as dotted overrides: the data
    on disk, latent batch 8, ``debug_fast`` with 3 steps and 1 epoch in both
    stages, checkpoints under ``ckpt``."""
    return {"data.root_dir": str(raw), "data.packed_dir": str(vol_dir),
            "data.latent_batch_size": DRIVER_LATENT_BATCH,
            **{f"{t}.{k}": v for t in ("train", "vae_train") for k, v in (
                ("debug_fast", True), ("debug_max_steps", DRIVER_STEPS), ("epochs", 1),
                ("checkpoint_dir", str(ckpt)))}}


def expect_driver_3d(tag, stages, cfg):
    """Exact steps and launches of the three stages of the tuned recipe at
    ``driver_path``'s cuts: stage 1 takes ``DRIVER_STEPS`` train and 1 val step
    (the VAE rematerialised in the backward), ``pack_latents`` encodes every
    case, stage 2 takes 1 train step (9 train latents) and no val step.
    Returns the stage-1 and stage-2 records."""
    vae_stage, ldm_stage = stages[f"{cfg.family}/{cfg.name}/vae"], stages[
        f"{cfg.family}/{cfg.name}/ldm"]
    remat = GN_VAE_FORWARD if cfg.vae.remat else 0
    expect_stage(f"{tag} stage 1", vae_stage, (DRIVER_STEPS, 1),
                 {**gn_calls(GN_VAE_FORWARD + remat), **gn_bwd_calls(GN_VAE_FORWARD)},
                 gn_calls(GN_VAE_FORWARD))
    packed_counts = stages["pack_latents"]["launches"]
    if (stages["pack_latents"]["volumes"] != DRIVER_CASES
            or packed_counts != {**dict.fromkeys(packed_counts, 0),
                                 **gn_calls(DRIVER_CASES * GN_VAE_ENCODE)}):
        raise AssertionError(f"{tag} pack_latents: {stages['pack_latents']}")
    flash = {"flash_attn_fwd": 1, "flash_attn_bwd_dkv": 1, "flash_attn_bwd_dq": 1}
    expect_stage(f"{tag} stage 2", ldm_stage, (1, 0),
                 {**gn_calls(GN_CALLS_PER_UNET + GN_REMAT_LEVEL0_CALLS),
                  **gn_bwd_calls(GN_CALLS_PER_UNET), **flash},
                 {**gn_calls(GN_CALLS_PER_UNET), "flash_attn_fwd": 1})
    return vae_stage, ldm_stage


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
    _apply_overrides(cfg, driver_3d_cuts(raw, vol_dir, ckpt))
    t0 = time.perf_counter()
    (vae_res, ldm_res, scale), stages, logger = run_driver(cfg, tmp, {"vae": 1, "ldm": 0})
    seconds = time.perf_counter() - t0
    run_dir = ckpt / cfg.family / cfg.name
    vae_stage, ldm_stage = expect_driver_3d("driver 3D", stages, cfg)
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


def expect_driver_2d(tag, rec):
    """Exact steps and launches of a 2D / 2.5D run at ``driver_path``'s cuts:
    ``DRIVER_STEPS`` train and 1 val step of 29 launches of each GroupNorm
    kernel (and a train step of each backward kernel)."""
    expect_stage(tag, rec, (DRIVER_STEPS, 1),
                 {**gn_calls(GN_CALLS_PER_UNET2D), **gn_bwd_calls(GN_CALLS_PER_UNET2D)},
                 gn_calls(GN_CALLS_PER_UNET2D))


DRIVER_2D_CUTS = {"data.val_fraction": DRIVER_VAL_FRACTION_2D, "train.debug_fast": True,
                  "train.debug_max_steps": DRIVER_STEPS, "train.epochs": 1}


def driver_2d(raw, packed, tmp):
    """``preset_slice_cond_2d`` and ``preset_ddpm_25d`` at full width (batch 64,
    128²) through ``run_experiment`` from their packed shards: debug_fast with 3
    steps, 1 epoch, ``val_fraction`` 0.25 (64 of the 256 debug items: one
    full validation batch). 29 launches of each GroupNorm kernel a forward.
    Returns the results, the launch counts and each family's (config, run
    directory)."""
    result, counts, runs = {}, {}, {}
    for preset, packed_dir in ((preset_slice_cond_2d, packed["slices"]),
                               (preset_ddpm_25d, packed["multimodal"])):
        cfg = preset(str(raw), **{
            "name": "preset", "data.packed_dir": str(packed_dir), **DRIVER_2D_CUTS,
            "train.checkpoint_dir": str(tmp / "ckpt")})
        t0 = time.perf_counter()
        res, stages, logger = run_driver(cfg, tmp, {"preset": 1})
        seconds = time.perf_counter() - t0
        rec = stages[f"{cfg.family}/preset"]
        expect_driver_2d(f"driver {cfg.family}", rec)
        if res.epochs_run != 1:
            raise AssertionError(f"driver {cfg.family}: {res.epochs_run} epochs")
        losses = check_losses(f"driver {cfg.family}", logger, ("train_loss", "val_loss"))
        result[cfg.family] = {"seconds": seconds, "batch": cfg.data.batch_size,
                              "in_channels": cfg.unet.in_channels, "losses": losses,
                              "trainer_seconds_per_step": {
                                  e: 1 / v for e, v in by_epoch(logger, "steps_per_s").items()},
                              **rec}
        counts[f"driver_{cfg.family}"] = rec["launches"]
        runs[cfg.family] = (cfg, Path(cfg.train.checkpoint_dir) / cfg.family / cfg.name)
        del res
    return result, counts, runs


def driver_path(train_seconds):
    """The data pipeline and the experiment drivers at full width from BraTS
    files on disk: the tree (``write_brats_tree``); ``split_subjects`` and
    ``apply_split`` over it; ``pack_volumes`` and, on the card,
    ``pack_dataset`` and ``pack_multimodal_slices`` over all 10 cases; the
    loaders' host seconds per batch, raw NIfTI against packed; the small
    card-against-CPU checks; then ``run_experiment`` of the 3D family on the
    tuned recipe (``driver_3d``) and of the 2D and 2.5D presets
    (``driver_2d``). Prints the ``driver_path`` line; then, while the
    temporary tree still exists, ``eval_path`` scores the two 2D runs. Returns
    the launch counts of every stage and of each scored run."""
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
        result_2d, counts_2d, runs_2d = driver_2d(raw, packed, tmp)
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
        # the evaluation suite scores the two runs while their directory lives
        counts_eval = eval_path(tmp, runs_2d)
        counts_cli = cli_path(tmp, raw, packed)
        counts_parallel = parallel_path(tmp, raw, packed, train_seconds)
    return {**counts_3d, **counts_2d, **counts_eval, **counts_cli, **counts_parallel}


# ------------------------------------------------------------ the evaluation suite

EVAL_SAMPLES = 128                # the protocol's 1000, cut
EVAL_BATCH = 64
EVAL_DDIM_STEPS = 20              # the protocol's full-T ancestral sampling, cut
EVAL_PAIRS = 64
EVAL_CHANNEL_25D = 3
EVAL_CALLS = 4                    # two real batches of 64, then the two diversity draws
EVAL_FEATURE_REL = 1e-4           # card against CPU, TF32 off: |Δ| ≤ 1e-4·max|f|
EVAL_SSIM_ATOL = 1e-5
EVAL_CHECK_IMAGES = 4
EVAL_KEYS = ("fid", "kid_mean", "kid_std", "fid_per_z_bin", "diversity_ssim_mean",
             "diversity_lpips_mean", "improved_precision", "improved_recall", "memorization")
REPLICAS = Path(__file__).resolve().parent / "tests" / "torch_replicas.py"


def load_replicas():
    """``tests/torch_replicas.py``: torch modules with torchvision's and
    lpips' state_dict layouts (Inception-v3, ResNet-18, AlexNet-LPIPS) and
    ``randomize_``, which draws every weight and BatchNorm statistic."""
    spec = importlib.util.spec_from_file_location("torch_replicas", REPLICAS)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_eval_weights(tmp):
    """The three pretrained-path weight files: each random-initialised
    replica converted by the port's ``convert_*`` and saved with
    ``save_params_npz``. Returns (paths, the converted trees, seconds)."""
    replicas = load_replicas()
    paths, trees = {}, {}
    t0 = time.perf_counter()
    for i, (kind, make, convert) in enumerate((
            ("inception", replicas.InceptionV3Trunk, convert_inception_v3),
            ("resnet18", replicas.ResNet18Trunk, convert_resnet18),
            ("lpips", replicas.LPIPSAlexReplica, convert_lpips_alex))):
        trees[kind] = convert(replicas.randomize_(make(), seed=SEED + 40 + i).state_dict())
        paths[kind] = tmp / "eval_weights" / f"{kind}.npz"
        save_params_npz(paths[kind], trees[kind])
    return paths, trees, time.perf_counter() - t0


class EvalProbe:
    """Wraps, for the time of a ``with`` block, what ``evaluate_runs`` calls:
    ``_evaluate_one`` (one record a run: launch counts set to 0 before it and
    read after it, seconds, peak memory), the sampler (``ddim_sample``,
    between two synchronisations), each extractor's and LPIPS' call (the
    same), SSIM, the host statistics of the harness (FID accumulation and
    distances, KID, precision/recall, memorization) and the loader's host
    work (``BatchLoader._host_batch``: read, preprocess, stack)."""

    HOST_MATH = ("frechet_distance", "kid_from_features", "improved_precision_recall",
                 "memorization_stats")

    def __init__(self):
        self.runs, self.run, self._saved = {}, None, []

    def _patch(self, owner, name, wrapper):
        original = getattr(owner, name)
        self._saved.append((owner, name, original))
        setattr(owner, name, wrapper(original))

    def __enter__(self):
        self._patch(eval_multi, "_evaluate_one", self._one)
        self._patch(GaussianDiffusion, "ddim_sample", lambda f: self._synced(f, "sampling"))
        self._patch(eval_features._Embedder, "__call__",
                    lambda f: self._synced(f, "features", by_type=True))
        self._patch(LPIPSDistance, "__call__",
                    lambda f: self._synced(f, "features", by_type=True))
        self._patch(eval_harness, "ssim", lambda f: self._synced(f, "ssim"))
        self._patch(eval_frechet.FidAccumulator, "update",
                    lambda f: self._host(f, "fid_accumulate"))
        for name in self.HOST_MATH:
            self._patch(eval_harness, name, lambda f, n=name: self._host(f, n))
        self._patch(BatchLoader, "_host_batch", lambda f: self._host(f, "loader"))
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)

    def _add(self, key, seconds, images=None):
        rec = self.runs[self.run].setdefault(key, {"calls": 0, "seconds": 0.0})
        rec["calls"] += 1
        rec["seconds"] += seconds
        if images is not None:
            rec["images"] = rec.get("images", 0) + images

    def _synced(self, fn, key, by_type=False):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if by_type:   # an extractor: args[0] is the extractor, args[1] the images
                self._add(f"{key}:{type(args[0]).__name__}", time.perf_counter() - t0,
                          images=int(args[1].shape[0]))
            else:
                self._add(key, time.perf_counter() - t0)
            return out
        return wrapped

    def _host(self, fn, key):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._add(key, time.perf_counter() - t0)
            return out
        return wrapped

    def _one(self, fn):
        def wrapped(rc, fe, out_path, **kwargs):
            self.run = Path(out_path).name.removesuffix(".metrics.json")
            self.runs[self.run] = {}
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = fn(rc, fe, out_path, **kwargs)
            torch.cuda.synchronize()
            self.runs[self.run].update(seconds=time.perf_counter() - t0,
                                       launches=all_launch_counts(),
                                       peak_memory_bytes=torch.cuda.max_memory_allocated())
            return out
        return wrapped


def all_finite(value) -> bool:
    if isinstance(value, dict):
        return all(all_finite(v) for v in value.values())
    if isinstance(value, list):
        return all(all_finite(v) for v in value)
    if isinstance(value, str):
        return True
    return bool(np.isfinite(value))


def check_eval_report(name, report):
    """Every key of the pretrained path, none with ``_rand``, every number
    finite, 128 samples, improved PR in ResNet-18 space."""
    missing = [k for k in EVAL_KEYS if k not in report]
    labeled = [k for k in report if "_rand" in k]
    if (missing or labeled or report["num_samples"] != EVAL_SAMPLES
            or report.get("improved_pr_feature_space") != "resnet18"
            or not all_finite(report)):
        raise AssertionError(f"eval {name}: missing {missing}, labeled {labeled}, "
                             f"report {json.dumps(report)[:2000]}")


def conv_flops(net, x):
    """Operations of one forward of ``net`` on ``x``: 2 per multiply-add of
    every ``nn.Conv2d`` (the pools, ReLUs and concatenations are left out),
    counted by forward hooks."""
    total = [0]

    def count(mod, inputs, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += 2 * out.numel() * mod.in_channels // mod.groups * k

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    return total[0]


def eval_card_vs_cpu(trees):
    """The networks and SSIM on the card against the same functions on the
    CPU, on a few seeded images at 128²: Inception (resized to 299),
    ResNet-18 and ``ConvFeatureNet`` features and LPIPS within
    ``EVAL_FEATURE_REL``·max|f|; ``ssim`` at 128² and ``ms_ssim`` with 5
    levels at 176² within ``EVAL_SSIM_ATOL``."""
    rng = np.random.default_rng(SEED + 44)
    x = rng.uniform(-1, 1, size=(EVAL_CHECK_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 1)).astype(np.float32)
    y = rng.uniform(-1, 1, size=x.shape).astype(np.float32)
    makers = {
        "inception": lambda d: InceptionFeatureExtractor(params=trees["inception"], device=d),
        "resnet18": lambda d: ResNet18FeatureExtractor(params=trees["resnet18"], device=d),
        "conv_feature_net": lambda d: FeatureExtractor(device=d),
    }
    errs = {}

    def relative(name, got, want):
        """The worst difference over the largest |f| (the bar's unit)."""
        scale = float(want.abs().max())
        err = check_close(f"eval {name}, card vs CPU", got, want, atol=EVAL_FEATURE_REL * scale)
        errs[name] = {"max_abs_err": err, "max_abs": scale, "relative": err / scale}

    for name, make in makers.items():
        relative(f"{name} features", make("cuda")(x).cpu(), make("cpu")(x))
    relative("lpips", LPIPSDistance(params=trees["lpips"], device="cuda")(x, y).cpu(),
             LPIPSDistance(params=trees["lpips"], device="cpu")(x, y))
    for name, fn, size, kw in (("ssim", ssim, IMAGE_SIZE, {}),
                               ("ms_ssim", ms_ssim, 176, {"levels": 5})):
        a = rng.uniform(0, 1, size=(EVAL_CHECK_IMAGES, size, size, 1)).astype(np.float32)
        b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
        errs[name] = check_close(f"eval {name}, card vs CPU",
                                 fn(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(),
                                    data_range=1.0, **kw).cpu(),
                                 fn(a, b, data_range=1.0, **kw), atol=EVAL_SSIM_ATOL)
    print("eval card vs CPU: " + ", ".join(
        f"{k} {v['relative']:.3e}·max|f|" if isinstance(v, dict) else f"{k} {v:.3e}"
        for k, v in errs.items())
          + f" (features <= {EVAL_FEATURE_REL}·max|f|, SSIM <= {EVAL_SSIM_ATOL}) ok")
    return errs


def inception_forward(trees):
    """The Inception trunk alone at a batch of 64 on ImageNet-normalised
    299² input: ms per batch (``time_ms``) against its multiply-adds over the
    float32 peak (TF32 is off)."""
    net = InceptionFeatureExtractor(params=trees["inception"], device="cuda").net
    x = torch.randn(EVAL_BATCH, 299, 299, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(SEED + 45))
    flops = conv_flops(net, x[:1])
    with torch.no_grad():
        ms = time_ms(lambda: net(x), repeats=5)
    return {"batch": EVAL_BATCH, "ms": ms, "gflop_per_image": flops / 1e9,
            "bound_ms": EVAL_BATCH * flops / PEAK_FLOPS["float32"] * 1e3,
            "bound_by": "operations (float32)"}


def brats_label_maps():
    """A pair of seeded BraTS-shaped 240×240×155 label maps: nested blobs of
    labels 2, 1, 4, the second (the prediction) shifted."""
    rng = np.random.default_rng(SEED + 46)
    grids = np.ogrid[tuple(slice(0, n) for n in BRATS_SHAPE)]
    maps = []
    for shift in (0, 3):
        lab = np.zeros(BRATS_SHAPE, np.uint8)
        for label, radius in ((2, 40.0), (1, 22.0), (4, 10.0)):
            c = [n / 2 + shift + rng.uniform(-4, 4) for n in BRATS_SHAPE]
            lab[sum((g - ci) ** 2 for g, ci in zip(grids, c)) <= radius ** 2] = label
        maps.append(lab)
    return maps


def segmentation_host_seconds():
    """``dice_per_label`` and ``hd95_per_label`` on ``brats_label_maps``,
    host seconds each."""
    maps = brats_label_maps()
    t0 = time.perf_counter()
    dice = dice_per_label(*maps)
    t1 = time.perf_counter()
    hd = hd95_per_label(*maps)
    t2 = time.perf_counter()
    if not (all(0 < v < 1 for v in dice.values()) and all(np.isfinite(v) for v in hd.values())):
        raise AssertionError(f"segmentation metrics: dice {dice}, hd95 {hd}")
    return {"shape": list(BRATS_SHAPE), "dice_seconds": t1 - t0, "hd95_seconds": t2 - t1,
            "dice": dice, "hd95": hd}


def eval_path(tmp, runs):
    """The evaluation suite on the two full-width 2D runs ``driver_2d`` just
    trained (``runs``: family → (config, run directory)): ``config.json``
    written beside each run's checkpoints, as the CLI's ``train`` does; the
    three weights files (``write_eval_weights``); then ``evaluate_runs`` with
    them — 128 samples a run in batches of 64, DDIM-20, 64 diversity pairs,
    improved PR on, split "all", the 2.5D run scored on channel 3 — under an
    ``EvalProbe``. Checks each report (``check_eval_report``), the summary
    and exactly 29 × 20 × 4 = 2320 launches of each GroupNorm kernel a run;
    then the networks on the card against the CPU, the Inception forward
    against its bound and the segmentation metrics' host time. Prints the
    ``eval_path`` line; returns each run's launch counts."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    for cfg, run_dir in runs.values():
        cfg.to_json(run_dir / "config.json")
    paths, trees, weights_seconds = write_eval_weights(tmp)
    run_configs = [{"run_dir": str(run_dir), "name": family, "num_samples": EVAL_SAMPLES,
                    "batch_size": EVAL_BATCH, "ddim_steps": EVAL_DDIM_STEPS,
                    "diversity_pairs": EVAL_PAIRS, "compute_pr": True, "split": "all",
                    **({"eval_channel": EVAL_CHANNEL_25D} if family == "ddpm_25d" else {})}
                   for family, (_, run_dir) in runs.items()]
    out = tmp / "eval"
    t0 = time.perf_counter()
    with EvalProbe() as probe:
        summary = evaluate_runs(run_configs, out, inception_weights=str(paths["inception"]),
                                resnet18_weights=str(paths["resnet18"]),
                                lpips_weights=str(paths["lpips"]), progress=False)
    eval_seconds = time.perf_counter() - t0
    if set(summary) != set(runs) or any("error" in v for v in summary.values()):
        raise AssertionError(f"evaluate_runs summary: {summary}")
    if json.loads((out / "summary.json").read_text()) != summary:
        raise AssertionError("summary.json differs from the returned summary")
    per_run, counts = {}, {}
    for family in runs:
        report = json.loads((out / f"{family}.metrics.json").read_text())
        check_eval_report(family, report)
        rec = probe.runs[family]
        expect_gn(f"eval {family}", rec["launches"], EVAL_CALLS * EVAL_DDIM_STEPS)
        counts[f"eval_{family}"] = rec["launches"]
        if rec["sampling"]["calls"] != EVAL_CALLS:
            raise AssertionError(f"eval {family}: {rec['sampling']['calls']} sampler calls")
        feats = {k.split(":", 1)[1]: {**v, "ms_per_batch_of_64": v["seconds"] / v["images"]
                                      * EVAL_BATCH * 1e3}
                 for k, v in rec.items() if k.startswith("features:")}
        host = {k: rec[k]["seconds"] for k in ("fid_accumulate",) + EvalProbe.HOST_MATH}
        accounted = (rec["sampling"]["seconds"] + sum(v["seconds"] for v in feats.values())
                     + rec["ssim"]["seconds"] + sum(host.values()) + rec["loader"]["seconds"])
        per_run[family] = {
            "seconds": rec["seconds"], "sampling_seconds": rec["sampling"]["seconds"],
            "sampling_seconds_per_step": rec["sampling"]["seconds"] / (EVAL_CALLS
                                                                       * EVAL_DDIM_STEPS),
            "features": feats, "ssim_seconds": rec["ssim"]["seconds"],
            "host_math_seconds": host,
            "frechet_distance_calls": rec["frechet_distance"]["calls"],
            "loader": {"batches": rec["loader"]["calls"], "seconds": rec["loader"]["seconds"],
                       "seconds_per_batch": rec["loader"]["seconds"] / rec["loader"]["calls"]},
            "other_seconds": rec["seconds"] - accounted,
            "peak_memory_bytes": rec["peak_memory_bytes"], "launches": rec["launches"],
            "headline": summary[family],
        }
    print(f"eval: {', '.join(runs)} scored, {EVAL_CALLS * EVAL_DDIM_STEPS * GN_CALLS_PER_UNET2D} "
          "launches of each GroupNorm kernel a run, reports complete and finite ok")
    errs = eval_card_vs_cpu(trees)
    result = {
        "runs": per_run, "evaluate_runs_seconds": eval_seconds,
        "weights_seconds": weights_seconds, "card_vs_cpu_max_abs_err": errs,
        "inception_forward": inception_forward(trees),
        "segmentation": segmentation_host_seconds(),
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
        "cuts": [f"{EVAL_SAMPLES} samples a run (protocol: 1000)",
                 f"DDIM-{EVAL_DDIM_STEPS} (protocol: full-T ancestral)",
                 'split "all" (protocol: the test split, 1 case of these 10)',
                 "random-initialised torchvision-layout weights (protocol: ImageNet)"],
        "phase_seconds": time.perf_counter() - t_phase,
    }
    print("eval_path " + json.dumps(result))
    return counts


# ----------------------------------------------------------- the command line

CLI_SEED = 0
CLI_GRID = 64                      # images of `sample --mode grid` and of a served 2D batch
CLI_VOLUMES = 2                    # volumes of `sample --mode volume3d` and of a served 3D batch
CLI_HYBRID_STEPS = 10
CLI_SERVE_BATCHES = 2
TWIN_SOURCES = {"test_torch_parity.py": ("TorchSinPosEmb", "TorchResBlock", "TorchDown",
                                         "TorchUp", "TorchRefUNet"),
                "test_torch_parity_3d.py": ("TRes3D", "TAttn3D", "TSinEmb", "TUNet3D",
                                            "TEnc3D", "TDec3D", "TVAE3D")}


class _Tee(io.TextIOBase):
    """Writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


class CliRun:
    """``mrijax_torch.cli.main`` in this process, one call at a time: the
    launch counts set to 0 just before a call and read just after, its
    seconds and peak memory, and what it printed (echoed)."""

    def __init__(self):
        self.calls = {}

    def __call__(self, name, *argv):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        text = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, text)):
            rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - t0,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "launches": all_launch_counts()}
        if rc != 0:
            raise AssertionError(f"cli {name}: exit code {rc}")
        if name in self.calls:
            raise AssertionError(f"cli {name}: called twice")
        self.calls[name] = rec
        return rec, text.getvalue()


class Captured:
    """Wraps, for the time of a ``with`` block, ``mrijax_torch.generate.<name>``
    (and the diagnostics' methods) to keep what they return to the CLI."""

    def __init__(self, *names):
        self.names, self.out, self._saved = names, {}, {}

    def __enter__(self):
        for name in self.names:
            self._saved[name] = fn = getattr(generate_module, name)
            setattr(generate_module, name, self._keep(name, fn))
        return self

    def _keep(self, name, fn):
        def wrapped(*args, **kwargs):
            self.out.setdefault(name, []).append(fn(*args, **kwargs))
            return self.out[name][-1]
        return wrapped

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(generate_module, name, fn)


def expect_same(tag, got, want):
    """Bitwise equality of what the CLI computed and a direct library call."""
    if got.shape != want.shape or not torch.equal(got, want):
        diff = ((got.float() - want.float()).abs().max().item()
                if got.shape == want.shape else "shape")
        raise AssertionError(f"cli {tag}: differs from the direct library call by {diff}")


def expect_launches(tag, counts, gn, flash=0):
    want = {**dict.fromkeys(counts, 0), **gn_calls(gn), "flash_attn_fwd": flash}
    if counts != want:
        raise AssertionError(f"cli {tag}: launch counts {counts}, expected {want}")


def npz_model(model, path):
    """``model`` on the card holding the weights of an ``export`` npz."""
    weights, meta = load_params_npz(path)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()}, strict=True)
    return model.cuda().eval(), meta


def load_twins():
    """The torch twins of the reference topology, from the test files that
    hold the JAX converters against them: their class definitions only,
    executed over torch (the files' JAX imports are not run)."""
    ns = {"torch": torch, "tnn": torch.nn, "F": F, "math": math, "np": np}
    for name, classes in TWIN_SOURCES.items():
        path = REPLICAS.parent / name
        body = [n for n in ast.parse(path.read_text()).body
                if isinstance(n, ast.ClassDef) and n.name in classes]
        exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


def serve_seconds(text):
    """First-batch and steady-state seconds from ``serve``'s last line."""
    first = float(re.search(r"([0-9.]+)s first batch", text).group(1))
    steady = float(re.search(r"([0-9.]+)s/batch steady-state", text).group(1))
    return first, steady


def energy_metrics(run_name, family):
    path = Path("runs") / family / run_name / "metrics.jsonl"
    return {r["key"]: r["value"] for r in map(json.loads, path.read_text().splitlines())
            if r["key"].startswith("energy_")}


def cli_train(run, tag, argv, tmp, family, power_limit):
    """``train`` under a ``DriverProbe``; ``config.json``, the energy metrics
    (NVML: power in (0, limit]) and ``analyze_run`` of the metrics."""
    with DriverProbe({}) as probe:
        rec, _ = run(tag, "train", *argv)
    # the probe sets the counts to 0 at each stage's start: the call's are their sum
    rec["launches"] = {k: sum(st["launches"][k] for st in probe.stages.values())
                       for k in rec["launches"]}
    run_dir = tmp / "cli_ckpt" / family / "cli"
    cfg = ExperimentConfig.from_json(run_dir / "config.json")
    energy = energy_metrics("cli", family)
    if not (0 < energy["energy_avg_power_w"] <= power_limit and energy["energy_energy_joules"] > 0
            and 0 < energy["energy_device_busy_s"] <= energy["energy_runtime_s"]):
        raise AssertionError(f"cli {tag}: energy {energy}")
    report = analyze.analyze_run(Path("runs") / family / "cli")
    run(f"info_{family}", "info", "--run-dir", run_dir)
    rec.update(stages={name: {k: v for k, v in st.items() if not k.endswith("_step_seconds")}
                       for name, st in probe.stages.items()},
               energy=energy, analyze={k: v for k, v in report.items() if isinstance(v, dict)})
    return cfg, run_dir


def cli_path(tmp, raw, packed):
    """Every subcommand of ``python -m mrijax_torch.cli`` at full width, in
    this process (``cli.main``), inside ``driver_path``'s temporary tree:

    ``doctor``; ``split --dry-run`` and ``split``; ``preprocess`` of the three
    families (bitwise the shards ``driver_path`` packed); ``train`` of
    ``preset_slice_cond_2d``, ``preset_ddpm_25d`` (batch 64) and
    ``configs/ddpm_3d_ldm_tuned.json`` (both stages, ``pack_latents``) at
    ``driver_path``'s cuts, each stage's steps and launches exact, the energy
    metrics from NVML, ``info`` and ``analyze_run``; ``export`` of each run;
    ``sample`` in every mode, bitwise a direct call of the library with the
    documented generator on the exported weights, launches exact;
    ``export-aot`` and ``serve`` (2D: 64 images, 3D: 2 volumes, 20 DDIM
    steps, 2 batches): batch 0 bitwise ``sample``'s, batch 1 bitwise the
    library's, launches twice the eager call's, no weight in the file;
    ``eval`` and ``eval-multi`` with the replica weight files of
    ``eval_path`` (its report keys); ``eval-seg``, ``convert-features``
    (bitwise ``eval_path``'s files) and ``import-torch`` of the torch twins'
    checkpoints at the presets' widths, each run sampled. Prints the
    ``cli_path`` line; returns each call's launch counts."""
    t_phase = time.perf_counter()
    run, cwd = CliRun(), os.getcwd()
    os.chdir(tmp)   # the metrics logger writes runs/ under the working directory
    try:
        result = _cli_path(run, tmp, raw, packed)
    finally:
        os.chdir(cwd)
    result.update(calls=run.calls, phase_seconds=time.perf_counter() - t_phase)
    print("cli_path " + json.dumps(result))
    return {f"cli_{name}": rec["launches"] for name, rec in run.calls.items()
            if any(rec["launches"].values())}


def _cli_path(run, tmp, raw, packed):
    power_limit = NvmlPowerSensor(torch.cuda.current_device()).power_limit_w()
    out, checks = tmp / "cli_out", {}
    _, text = run("doctor", "doctor")
    if "kernel library groupnorm_silu: built" not in text:
        raise AssertionError("cli doctor: the kernel libraries are not reported as built")

    # split and preprocess against driver_path's
    for dry in (True, False):
        _, text = run(f"split{'_dry_run' if dry else ''}", "split", "--src", raw,
                      "--out-root", tmp / "cli_split", "--mode", "symlink",
                      *(["--dry-run"] if dry else []))
        if text.splitlines()[-1] != "{'train': 8, 'val': 1, 'test': 1}":
            raise AssertionError(f"cli split: {text.splitlines()[-1]}")
    if sorted(p.name for p in (tmp / "cli_split" / "train").iterdir()) != sorted(
            p.name for p in (tmp / "split" / "train").iterdir()):
        raise AssertionError("cli split: another train split than driver_path's")
    for family, key in (("2d", "slices"), ("25d", "multimodal"), ("3d", "volumes")):
        dst = tmp / f"cli_packed_{family}"
        run(f"preprocess_{family}", "preprocess", "--root-dir", raw, "--output-dir", dst,
            "--family", family, "--image-size", IMAGE_SIZE)
        index = json.loads((dst / "index.json").read_text())
        if index != json.loads((packed[key] / "index.json").read_text()):
            raise AssertionError(f"cli preprocess {family}: another index than driver_path's")
        for entry in index["files"]:
            with np.load(dst / entry["path"]) as got, np.load(packed[key] / entry["path"]) as want:
                if got.files != want.files or not all(np.array_equal(got[k], want[k])
                                                       for k in want.files):
                    raise AssertionError(f"cli preprocess {family}: {entry['path']} differs")
    checks["preprocess"] = "bitwise driver_path's shards, all three families"

    # train, export
    ckpt = tmp / "cli_ckpt"
    cuts = [f"{k}={json.dumps(v)}" for k, v in DRIVER_2D_CUTS.items()]
    runs = {}
    for preset, key in (("slice_cond_2d", "slices"), ("ddpm_25d", "multimodal")):
        cfg, run_dir = cli_train(run, f"train_{preset}", [
            "--preset", preset, "--root-dir", raw, "--name", "cli", "--set",
            f"data.packed_dir={packed[key]}", f"train.checkpoint_dir={ckpt}", *cuts],
            tmp, preset, power_limit)
        expect_driver_2d(f"cli train {preset}", run.calls[f"train_{preset}"]["stages"][
            f"{preset}/cli"])
        runs[preset] = (cfg, run_dir)
    cfg, run_dir = cli_train(run, "train_ddpm_3d_ldm", [
        "--config", TUNED_CONFIG, "--name", "cli", "--set",
        *(f"{k}={json.dumps(v)}" for k, v in driver_3d_cuts(raw, packed["volumes"],
                                                              ckpt).items())],
        tmp, "ddpm_3d_ldm", power_limit)
    expect_driver_3d("cli train 3D", run.calls["train_ddpm_3d_ldm"]["stages"], cfg)
    runs["ddpm_3d_ldm"] = (cfg, run_dir)
    npz = {}
    for family, (cfg, run_dir) in runs.items():
        npz[family] = out / f"{family}.npz"
        run(f"export_{family}", "export", "--run-dir", run_dir, "--out", npz[family])

    # sample in every mode against the library on the exported weights
    gen = lambda b=0: eval_harness.call_generator(CLI_SEED, b, device="cuda")  # noqa: E731
    cfg2, dir2 = runs["slice_cond_2d"]
    model2, _ = npz_model(build_unet2d(cfg2.unet), npz["slice_cond_2d"])
    diff2 = build_diffusion(cfg2.diffusion)
    grid_kw = dict(num_samples=CLI_GRID, image_size=cfg2.data.image_size,
                   ddim_steps=DDIM_STEPS_2D)
    samples, mode_seconds = {}, {}
    for tag, argv, fn, kw, forwards in (
            ("grid", ["--num-samples", CLI_GRID, "--ddim-steps", DDIM_STEPS_2D], "sample_2d",
             grid_kw, DDIM_STEPS_2D),
            ("grid_guided", ["--num-samples", CLI_GRID, "--ddim-steps", DDIM_STEPS_2D,
                             "--guidance-scale", GUIDANCE], "sample_2d",
             {**grid_kw, "guidance_scale": GUIDANCE}, DDIM_STEPS_2D),
            ("sweep", ["--mode", "sweep", "--num-slices", SWEEP_SLICES, "--ddim-steps",
                       SWEEP_STEPS, "--sampler", "dpm"], "sample_pseudo3d_sweep",
             dict(num_slices=SWEEP_SLICES, image_size=cfg2.data.image_size, ddim_steps=SWEEP_STEPS,
                  sampler="dpm"), SWEEP_STEPS)):
        with Captured(fn) as cap:
            rec, _ = run(f"sample_{tag}", "sample", "--run-dir", dir2, "--seed", CLI_SEED,
                         "--out-dir", out / tag, *argv)
        expect_launches(f"sample {tag}", rec["launches"], forwards * GN_CALLS_PER_UNET2D)
        samples[tag] = cap.out[fn][0]
        expect_same(f"sample {tag}", samples[tag], getattr(generate_module, fn)(
            model2, diff2, generator=gen(), **kw))
    cfg25, dir25 = runs["ddpm_25d"]
    model25, _ = npz_model(build_unet2d(cfg25.unet), npz["ddpm_25d"])
    diff25 = build_diffusion(cfg25.diffusion)
    ds25 = MultiModalSliceDataset25D(raw, cfg25.data.image_size, cfg25.data.slice_radius)
    subject = len(generate_module._subject_slices(ds25, 0))
    for tag, steps, fn in (("pseudo3d-real", DDIM_STEPS_2D, "generate_pseudo3d_real_context"),
                           ("pseudo3d-hybrid", CLI_HYBRID_STEPS, "generate_pseudo3d_hybrid")):
        with Captured(fn) as cap:
            rec, _ = run(f"sample_{tag}", "sample", "--run-dir", dir25, "--mode", tag,
                         "--ddim-steps", steps, "--seed", CLI_SEED, "--out-dir", out / tag)
        forwards = steps * (1 if tag == "pseudo3d-real" else subject)
        expect_launches(f"sample {tag}", rec["launches"], forwards * GN_CALLS_PER_UNET2D)
        rec["unet2d_forwards"] = forwards
        expect_same(f"sample {tag}", cap.out[fn][0], getattr(generate_module, fn)(
            model25, diff25, ds25, 0, generator=gen(), ddim_steps=steps))
    cfg3, dir3 = runs["ddpm_3d_ldm"]
    unet3, meta3 = npz_model(build_unet3d(cfg3.unet), npz["ddpm_3d_ldm"])
    vae3, _ = npz_model(build_vae3d(cfg3.vae), npz["ddpm_3d_ldm"].with_suffix(".vae.npz"))
    diff3, scale = build_diffusion(cfg3.diffusion), meta3["latent_scale"]
    with Captured("generate_3d_volumes") as cap:
        rec, _ = run("sample_volume3d", "sample", "--run-dir", dir3, "--mode", "volume3d",
                     "--num-samples", CLI_VOLUMES, "--ddim-steps", DDIM_STEPS,
                     "--seed", CLI_SEED, "--out-dir", out / "volume3d")
    # latent_shape_for encodes one dummy patch: one encoder pass more
    expect_launches("sample volume3d", rec["launches"],
                    DDIM_STEPS * GN_CALLS_PER_UNET + GN_CALLS_PER_DECODE + GN_VAE_ENCODE,
                    DDIM_STEPS)
    samples["volume3d"] = cap.out["generate_3d_volumes"][0]
    expect_same("sample volume3d", samples["volume3d"], generate_3d_volumes(
        unet3, vae3, diff3, num_volumes=CLI_VOLUMES, latent_spatial=LATENT_SPATIAL,
        latent_channels=LATENT_CHANNELS, latent_scale=scale, generator=gen(),
        ddim_steps=DDIM_STEPS))
    rec, text = run("sample_diagnostics", "sample", "--run-dir", dir3, "--mode", "diagnostics",
                    "--seed", CLI_SEED, "--out-dir", out / "diagnostics")
    report = json.loads((out / "diagnostics" / "diagnostics.json").read_text())
    # the probes' defaults: a stride-1 DDIM from each noising t, then num_ts ε probes
    ts = [min(t, cfg3.diffusion.timesteps - 1) for t in inspect.signature(
        Vae3dDiagnostics.noising_roundtrip).parameters["ts"].default]
    forwards = sum(ts) + inspect.signature(
        Vae3dDiagnostics.eps_mse_by_t).parameters["num_ts"].default
    expect_launches("sample diagnostics", rec["launches"],
                    forwards * GN_CALLS_PER_UNET + (1 + len(ts)) * GN_CALLS_PER_DECODE
                    + 4 * GN_VAE_ENCODE, forwards)
    rec["unet3d_forwards"] = forwards
    ds3 = VolumeDataset3D(raw, cfg3.data.patch_size, random_crop=False)
    real = torch.from_numpy(np.stack([ds3[i]["volume"] for i in range(2)])).cuda()
    diag = Vae3dDiagnostics(unet3, vae3, diff3, latent_scale=scale)
    g = gen()
    want = json.loads(json.dumps({
        "recon_l1": diag.reconstruction(real)[1], "latent_stats": diag.latent_stats(real),
        "noising_roundtrip_l1": {str(k): v for k, v in diag.noising_roundtrip(real, generator=g).items()},
        "eps_mse_by_t": {str(k): v for k, v in diag.eps_mse_by_t(real, generator=g).items()}}))
    if report != want:
        raise AssertionError(f"cli sample diagnostics: {report} against the library's {want}")
    del real, diag, ds3
    checks["sample"] = "bitwise the library on the exported weights, every mode"

    # export-aot and serve
    serving = {}
    for family, n, steps, sample_tag in (("slice_cond_2d", CLI_GRID, DDIM_STEPS_2D, "grid"),
                                         ("ddpm_3d_ldm", CLI_VOLUMES, DDIM_STEPS, "volume3d")):
        program = out / f"{family}.pt2"
        rec, text = run(f"export_aot_{family}", "export-aot", "--run-dir", runs[family][1],
                        "--out", program, "--num-samples", n, "--ddim-steps", steps)
        export_seconds = float(re.search(r"exported in ([0-9.]+)s", text).group(1))
        size, largest = aot.file_bytes(program)
        weight_bytes = os.path.getsize(npz[family]) + (
            os.path.getsize(npz[family].with_suffix(".vae.npz")) if family == "ddpm_3d_ldm" else 0)
        if largest > 1024:
            raise AssertionError(f"cli export-aot {family}: {largest} bytes of tensor data in "
                                 "the file")
        served = out / f"served_{family}"
        rec_s, text = run(f"serve_{family}", "serve", "--program", program, "--weights",
                          npz[family], "--out", served, "--batches", CLI_SERVE_BATCHES,
                          "--seed", CLI_SEED)
        eager = run.calls[f"sample_{sample_tag}"]["launches"]
        if family == "ddpm_3d_ldm":   # sample's latent_shape_for adds one encode
            eager = {**eager, **gn_calls(eager["gn_silu_stats"] - GN_VAE_ENCODE)}
            batches = [torch.from_numpy(np.stack([nifti.load(served / f"b{b:03d}_v{j}.nii.gz")
                                                  for j in range(n)]))
                       for b in range(CLI_SERVE_BATCHES)]
            direct = lambda g: generate_3d_volumes(  # noqa: E731
                unet3, vae3, diff3, num_volumes=n, latent_spatial=LATENT_SPATIAL,
                latent_channels=LATENT_CHANNELS, latent_scale=scale, generator=g,
                ddim_steps=steps)
        else:
            batches = [torch.from_numpy(np.load(served / f"b{b:03d}.npz")["samples"])
                       for b in range(CLI_SERVE_BATCHES)]
            direct = lambda g: sample_2d(model2, diff2, generator=g, **grid_kw)  # noqa: E731
        if rec_s["launches"] != {k: CLI_SERVE_BATCHES * v for k, v in eager.items()}:
            raise AssertionError(f"cli serve {family}: launches {rec_s['launches']} against "
                                 f"{CLI_SERVE_BATCHES} × {eager}")
        expect_same(f"serve {family} batch 0", batches[0], samples[sample_tag].cpu())
        expect_same(f"serve {family} batch 1", batches[1], direct(gen(1)).cpu())
        first, steady = serve_seconds(text)
        serving[family] = {
            "export_seconds": export_seconds,
            "pt2_bytes": size, "largest_tensor_bytes_in_file": largest,
            "weights_npz_bytes": weight_bytes, "batch": n, "ddim_steps": steps,
            "serve_first_batch_seconds": first, "serve_steady_seconds_per_batch": steady,
            "sample_seconds": run.calls[f"sample_{sample_tag}"]["seconds"]}
    checks["serve"] = "batch 0 bitwise sample's, batch 1 bitwise the library's"
    del model2, model25, unet3, vae3
    gc.collect()
    torch.cuda.empty_cache()

    # eval and eval-multi with eval_path's weight files
    weights = {k: tmp / "eval_weights" / f"{k}.npz" for k in ("inception", "resnet18", "lpips")}
    weight_args = ["--inception-weights", weights["inception"], "--resnet18-weights",
                   weights["resnet18"], "--lpips-weights", weights["lpips"]]
    keys = set(json.loads((tmp / "eval" / "slice_cond_2d.metrics.json").read_text()))
    rec, _ = run("eval", "eval", "--run-dir", dir2, "--num-samples", EVAL_SAMPLES,
                 "--batch-size", EVAL_BATCH, "--ddim-steps", EVAL_DDIM_STEPS, "--pr",
                 "--split", "all", "--diversity-pairs", EVAL_PAIRS, "--out",
                 out / "eval.json", *weight_args)
    report = json.loads((out / "eval.json").read_text())
    check_eval_report("cli eval", report)
    if set(report) != keys | {"sampler", "sampler_is_reference_protocol"}:
        raise AssertionError(f"cli eval: keys {sorted(set(report) ^ keys)} differ from eval_path's")
    expect_gn("cli eval", rec["launches"], EVAL_CALLS * EVAL_DDIM_STEPS)
    (out / "runs.json").write_text(json.dumps([
        {"run_dir": str(d), "name": f, "num_samples": EVAL_SAMPLES, "batch_size": EVAL_BATCH,
         "ddim_steps": EVAL_DDIM_STEPS, "diversity_pairs": EVAL_PAIRS, "compute_pr": True,
         "split": "all", **({"eval_channel": EVAL_CHANNEL_25D} if f == "ddpm_25d" else {})}
        for f, (_, d) in runs.items() if f != "ddpm_3d_ldm"]))
    rec, _ = run("eval_multi", "eval-multi", "--config", out / "runs.json", "--out-dir",
                 out / "eval_multi", *weight_args)
    for family in ("slice_cond_2d", "ddpm_25d"):
        report = json.loads((out / "eval_multi" / f"{family}.metrics.json").read_text())
        check_eval_report(f"cli eval-multi {family}", report)
        if set(report) != keys:
            raise AssertionError(f"cli eval-multi {family}: keys differ from eval_path's")
    expect_gn("cli eval-multi", rec["launches"], 2 * EVAL_CALLS * EVAL_DDIM_STEPS)
    summary = json.loads((out / "eval_multi" / "summary.json").read_text())
    if set(summary) != {"slice_cond_2d", "ddpm_25d"} or any("error" in v for v in summary.values()):
        raise AssertionError(f"cli eval-multi: summary {summary}")

    # eval-seg, convert-features, import-torch
    pred, target = brats_label_maps()[::-1]
    for name, lab in (("pred", pred), ("target", target)):
        nifti.save(out / f"{name}.nii.gz", lab)
    run("eval_seg", "eval-seg", "--pred", out / "pred.nii.gz", "--target", out / "target.nii.gz",
        "--out", out / "seg.json")
    seg = json.loads((out / "seg.json").read_text())
    want = dice_per_label(pred.astype(np.int32), target.astype(np.int32))
    if seg["mean_dice"] != {str(k): float(v) for k, v in want.items()}:
        raise AssertionError(f"cli eval-seg: {seg['mean_dice']} against {want}")
    replicas = load_replicas()
    for i, (kind, make, arch) in enumerate((
            ("inception", replicas.InceptionV3Trunk, "inception_v3"),
            ("resnet18", replicas.ResNet18Trunk, "resnet18"),
            ("lpips", replicas.LPIPSAlexReplica, "lpips_alex"))):
        pth = out / f"{kind}.pth"
        torch.save(replicas.randomize_(make(), seed=SEED + 40 + i).state_dict(), pth)
        run(f"convert_features_{arch}", "convert-features", "--checkpoint", pth, "--arch", arch,
            "--out", out / f"{kind}.npz")
        got, _ = load_params_npz(out / f"{kind}.npz")
        want, _ = load_params_npz(weights[kind])
        flat = lambda t, p="": [x for k in sorted(t) for x in (  # noqa: E731
            flat(t[k], f"{p}{k}/") if isinstance(t[k], dict) else [(p + k, t[k])])]
        if [k for k, _ in flat(got)] != [k for k, _ in flat(want)] or not all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for (_, a), (_, b) in zip(flat(got), flat(want))):
            raise AssertionError(f"cli convert-features {arch}: not eval_path's file")
    twins = load_twins()
    c2, c3 = preset_slice_cond_2d(), preset_ddpm_3d_ldm()
    torch.manual_seed(SEED + 50)
    twin2 = twins["TorchRefUNet"](img_channels=1, base=c2.unet.base_channels,
                                  mults=c2.unet.channel_mults, tdim=c2.unet.time_emb_dim)
    torch.save({**{f"model.{k}": v for k, v in twin2.state_dict().items()},
                "betas": torch.linspace(1e-4, 0.02, c2.diffusion.timesteps)}, out / "ref2d.pt")
    twin_vae = twins["TVAE3D"](cin=c3.vae.in_channels, base=c3.vae.base_channels,
                               num_down=c3.vae.num_down, latent=c3.vae.latent_channels)
    twin_unet = twins["TUNet3D"](cin=c3.unet.in_channels, base=c3.unet.base_channels,
                                 mults=c3.unet.channel_mults, tdim=c3.unet.time_emb_dim,
                                 heads=c3.unet.num_heads)
    torch.save(twin_vae.state_dict(), out / "vae3d_final.pt")
    torch.save({"state_dict": twin_unet.state_dict()}, out / "3d_ldm_diffusion_best.pt")
    del twin2, twin_vae, twin_unet
    run("import_torch_2d", "import-torch", "--checkpoint", out / "ref2d.pt",
        "--out", out / "imported_2d")
    rec, _ = run("sample_imported_2d", "sample", "--run-dir", out / "imported_2d",
                 "--num-samples", CLI_GRID, "--ddim-steps", DDIM_STEPS_2D,
                 "--out-dir", out / "imported_2d_samples")
    expect_launches("sample imported 2D", rec["launches"], DDIM_STEPS_2D * GN_CALLS_PER_UNET2D)
    run("import_torch_3d", "import-torch", "--preset", "ddpm_3d_ldm", "--checkpoint",
        out / "3d_ldm_diffusion_best.pt", "--vae-checkpoint", out / "vae3d_final.pt",
        "--latent-scale", "1.5", "--out", out / "imported_3d")
    rec, _ = run("sample_imported_3d", "sample", "--run-dir", out / "imported_3d", "--mode",
                 "volume3d", "--num-samples", CLI_VOLUMES, "--ddim-steps", DDIM_STEPS,
                 "--out-dir", out / "imported_3d_samples")
    expect_launches("sample imported 3D", rec["launches"],
                    DDIM_STEPS * GN_CALLS_PER_UNET + GN_CALLS_PER_DECODE + GN_VAE_ENCODE,
                    DDIM_STEPS)
    for tag in ("imported_2d_samples/grid.png", "imported_3d_samples/volume0.nii.gz"):
        if not (out / tag).exists():
            raise AssertionError(f"cli sample of an imported run wrote no {tag}")
    checks["imports"] = "the torch twins at the presets' widths, sampled"
    return {"checks": checks, "serving": serving, "power_limit_w": power_limit,
            "hybrid_slices": subject,
            "cuts": ["train: driver_path's (3 steps, 1 epoch a stage, latent batch 8, "
                     "val_fraction 0.25 for 2D / 2.5D)",
                     f"sample: {DDIM_STEPS_2D} DDIM steps (2D grid), {SWEEP_STEPS} DPM (sweep), "
                     f"{CLI_HYBRID_STEPS} DDIM (hybrid), {DDIM_STEPS} DDIM (3D) of T",
                     f"eval: {EVAL_SAMPLES} samples, DDIM-{EVAL_DDIM_STEPS}, split all, "
                     "random replica weights",
                     "import-torch: random torch twins of the reference topology"]}


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


# ------------------------------------------------------ parallelism (phase 15)

PARALLEL_SAMPLE_SEED = 11


def parallel_flagship_run(tag, mesh=None, sp_mesh=None, fsdp_mesh=None):
    """``TRAIN_WARMUP_STEPS`` + ``PARALLEL_STEPS`` steps of phase 7's
    flagship (no remat) on the same latents and draws: the final state, s a
    step and the counted steps' launches."""
    batch = train_latents()
    unet, state, step = build_flagship_trainer(None, mesh=mesh, sp_mesh=sp_mesh)
    if fsdp_mesh is not None:
        state, _ = shard_train_state(fsdp_mesh, state)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for _ in range(TRAIN_WARMUP_STEPS):
        state, _ = step(state, batch, gen, 1.0)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(PARALLEL_STEPS):
        state, loss = step(state, batch, gen, 1.0)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / PARALLEL_STEPS
    counts = all_launch_counts()
    flat = flat_state(state)
    flat["adam"] = flat["adam"].clone()
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"parallel {tag}: loss {float(loss)}")
    del unet, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return flat, seconds, counts


def expect_bitwise_state(tag, got, want):
    """Parameters, EMA shadow and Adam moments bitwise equal; otherwise the
    largest difference of each is the finding, and the check fails."""
    diffs = {k: float((got[k] - want[k]).abs().max()) for k in ("params", "ema", "adam")}
    if any(diffs.values()):
        raise AssertionError(f"parallel {tag}: not bitwise the one-device state, "
                             f"max abs differences {diffs}")


def parallel_cli(tmp, raw, packed):
    """(f) ``train`` of ``preset_slice_cond_2d`` at ``driver_path``'s cuts as
    rank 0 of a job of one (``--coordinator file://… --num-processes 1
    --process-id 0``: the CLI makes the NCCL group and destroys it), steps and
    launches exact, rank 0's files written; then ``sample --data-parallel``
    of the run under torchrun's variables (a group of one over
    ``tcp://localhost``, the sharded path), bitwise the plain ``sample``."""
    run, cwd = CliRun(), os.getcwd()
    os.chdir(tmp)
    try:
        ckpt, rdv = tmp / "mp_ckpt", tmp / "mp_rendezvous"
        with DriverProbe({}) as probe:
            run("train_mp", "train", "--preset", "slice_cond_2d", "--root-dir", raw,
                "--name", "mp", "--set", f"data.packed_dir={packed['slices']}",
                f"train.checkpoint_dir={ckpt}",
                *(f"{k}={json.dumps(v)}" for k, v in DRIVER_2D_CUTS.items()),
                "--coordinator", f"file://{rdv}", "--num-processes", 1, "--process-id", 0)
        if torch.distributed.is_initialized():
            raise AssertionError("cli train: the group it made is still up")
        expect_driver_2d("parallel cli train", probe.stages["slice_cond_2d/mp"])
        run_dir = ckpt / "slice_cond_2d" / "mp"
        written = sorted(str(p.relative_to(tmp)) for p in [run_dir / "config.json",
                         *run_dir.glob("*.pt"), tmp / "runs/slice_cond_2d/mp/metrics.jsonl"]
                         if p.exists())
        if len(written) < 3:
            raise AssertionError(f"cli train as rank 0: wrote only {written}")
        argv = ["sample", "--run-dir", run_dir, "--mode", "grid", "--num-samples", CLI_GRID,
                "--ddim-steps", DDIM_STEPS, "--seed", CLI_SEED]
        with Captured("sample_2d") as plain:
            run("sample_mp_plain", *argv, "--out-dir", tmp / "mp_plain")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port)}
        os.environ.update(env)
        try:
            with Captured("sample_2d") as sharded:
                rec, text = run("sample_mp_data_parallel", *argv, "--data-parallel",
                                "--out-dir", tmp / "mp_sharded")
        finally:
            for k in env:
                del os.environ[k]
            parallel.shutdown()
        if "data-parallel sampling over 1 processes" not in text:
            raise AssertionError("cli sample --data-parallel did not take the sharded path")
        expect_same("sample --data-parallel", sharded.out["sample_2d"][0],
                    plain.out["sample_2d"][0])
        expect_launches("sample --data-parallel", rec["launches"],
                        GN_CALLS_PER_UNET2D * DDIM_STEPS)
    finally:
        os.chdir(cwd)
    return run.calls, written


def parallel_path(tmp, raw, packed, phase7_seconds):
    """Phase 15: ``mrijax_torch.parallel`` on the card, in a world of one.

    (f) first: the CLI across a group it makes itself (``parallel_cli``).
    Then an NCCL group of size one (``file://`` rendezvous in ``tmp``) for:
    (a) phase 7's flagship train step (batch 8) through the data-parallel
    gradient all-reduce, ``TRAIN_WARMUP_STEPS`` + ``PARALLEL_STEPS`` steps,
    launches and state (parameters, EMA, Adam) bitwise the one-device run's;
    the flat all-reduce of the 136 482 704 float32 gradients timed on the
    group of one (no byte crosses a link), beside the NVLink bound of a ring
    over 2 and 4 cards; (b) the same steps with the state sharded
    (``shard_train_state``; the step reads the layout from the state), bitwise; (c) the same steps with
    the bottleneck attention sequence-parallel over a (1, 1) ("data",
    "model") mesh, bitwise, one launch of each flash kernel a step; (d)
    ``generate_3d_volumes(mesh=…)`` (2 volumes, 20 DDIM steps) bitwise the
    plain call with shard 0's generator. The group is destroyed at the end.
    Prints the ``parallel_path`` line; returns the launch counts."""
    t_phase = time.perf_counter()
    cli_calls, written = parallel_cli(tmp, raw, packed)
    parallel.initialize(f"file://{tmp / 'phase15_rendezvous'}", 1, 0, required=True,
                        device="cuda")
    try:
        result, counts = _parallel_path()
    finally:
        parallel.shutdown()
    result.update({
        "cli": {name: {k: v for k, v in rec.items() if k != "peak_memory_bytes"}
                for name, rec in cli_calls.items()},
        "cli_files_of_rank0": written, "phase7_seconds_per_step": phase7_seconds,
        "phase_seconds": time.perf_counter() - t_phase})
    print("parallel_path " + json.dumps(result))
    return {**counts, **{f"parallel_cli_{name}": rec["launches"]
                         for name, rec in cli_calls.items()}}


def _parallel_path():
    mesh = parallel.make_mesh(("data",))
    sp_mesh = parallel.make_mesh(("data", "model"), (1, 1))
    if torch.distributed.get_backend() != "nccl" or torch.distributed.get_world_size() != 1:
        raise AssertionError("phase 15 needs an NCCL group of one")
    want, ref_s, ref_counts = parallel_flagship_run("one device")
    if min(ref_counts.values()) == 0:
        raise AssertionError(f"parallel: the one-device step skipped a kernel: {ref_counts}")
    result, counts_by_run = {"one_device_seconds_per_step": ref_s}, {}
    for tag, kw in (("data_parallel", dict(mesh=mesh)),
                    ("fsdp", dict(mesh=mesh, fsdp_mesh=mesh)),
                    ("sequence_parallel", dict(mesh=sp_mesh, sp_mesh=sp_mesh))):
        got, sec, counts = parallel_flagship_run(tag, **kw)
        if counts != ref_counts:
            raise AssertionError(f"parallel {tag}: launches {counts}, one device {ref_counts}")
        expect_bitwise_state(tag, got, want)
        result[tag] = {"seconds_per_step": sec, "bitwise": True,
                       "launches_per_step": {k: v // PARALLEL_STEPS for k, v in counts.items()}}
        counts_by_run[f"parallel_{tag}"] = counts
        del got
    del want
    # the flat all-reduce of the flagship's gradients, alone. On a group of
    # one no byte crosses a link, so this times the call's own cost; across
    # d cards a ring sends 2(d-1)/d of the bytes each way over NVLink, whose
    # bound is printed for d = 2 and 4 and cannot be measured on one card
    with torch.device("meta"):
        n = sum(p.numel() for p in UNet3D(
            in_channels=LATENT_CHANNELS, base_channels=128, channel_mults=(1, 2, 4),
            use_attention=True, num_heads=4, time_emb_dim=256).parameters())
    flat = torch.ones(n, dtype=torch.float32, device="cuda")
    group = mesh.get_group("data")
    result["all_reduce"] = {
        "elements": n, "bytes": 4 * n, "ranks": 1,
        "one_rank_ms": time_ms(lambda: torch.distributed.all_reduce(flat, group=group)),
        "link_bound_ms": {str(d): 2 * (d - 1) / d * 4 * n / NVLINK_BYTES_PER_S * 1e3
                          for d in (2, 4)},
        "link_ms": "not measured (one card)"}
    del flat
    # (d) sharded sampling
    unet, vae, diffusion = build_flagship()
    common = dict(num_volumes=NUM_VOLUMES, latent_spatial=LATENT_SPATIAL,
                  latent_channels=LATENT_CHANNELS, ddim_steps=DDIM_STEPS, device="cuda")
    reset_launch_counts()
    plain = generate_3d_volumes(unet, vae, diffusion, generator=parallel.shard_generator(
        PARALLEL_SAMPLE_SEED, 0, device="cuda"), **common)
    plain_counts = all_launch_counts()
    reset_launch_counts()
    t0 = time.perf_counter()
    sharded = generate_3d_volumes(unet, vae, diffusion, mesh=mesh, seed=PARALLEL_SAMPLE_SEED,
                                  **common)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = all_launch_counts()
    if counts != plain_counts or min(counts[k] for k in GENERATION_KERNELS) == 0:
        raise AssertionError(f"parallel sampling: launches {counts}, plain {plain_counts}")
    if not torch.equal(sharded, plain):
        raise AssertionError("parallel sampling: not bitwise the plain call with shard 0's "
                             f"generator (max abs {float((sharded - plain).abs().max())})")
    if not bool(torch.isfinite(sharded).all()):
        raise AssertionError("parallel sampling: non-finite volumes")
    result["sharded_sample"] = {"volumes": NUM_VOLUMES, "ddim_steps": DDIM_STEPS,
                                "seconds": seconds, "bitwise": True,
                                "shape": list(sharded.shape)}
    counts_by_run["parallel_sharded_sample"] = counts
    del unet, vae, sharded, plain
    gc.collect()
    torch.cuda.empty_cache()
    result.update(world_size=1, backend="nccl", steps=PARALLEL_STEPS,
                  warmup_steps=TRAIN_WARMUP_STEPS, batch=TRAIN_BATCH)
    return result, counts_by_run


# ------------------------- entry points, examples and job scripts (phase 16)

REPO = Path(__file__).resolve().parent
ENTRY_SMALL_LATENT = (1, 8, 8, 8, 16)    # the card-against-CPU check of entry's fn
ENTRY_T = 7
ENTRY_REPEATS = 5
BF16_ULP = 2 ** -7                       # of a value in [1, 2)
ENTRY_LAUNCHES = {**gn_calls(GN_CALLS_PER_UNET), **gn_bwd_calls(0),
                  "flash_attn_fwd": 1, "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}
SCRIPT_CONFIG = REPO / "configs" / "slice_cond_2d_tiny_cpu.json"
SCRIPT_TIMEOUT_S = 600
# what torchrun, SLURM or an earlier run may have left in the environment
RANK_VARIABLES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                  "MASTER_PORT", "MRIJAX_MULTIHOST")


def entry_check():
    """``graft_entry.entry()`` on the card: one call of ``fn`` launches the
    GroupNorm kernels 29 times each and the flash forward once; its output is
    finite; ms a forward (host and card, median of ``ENTRY_REPEATS``) and the
    peak memory of one; then ``fn`` at a small bf16 latent against the same
    ``fn`` built on the CPU with the card's weights copied there (the plain
    versions): the largest difference within 4 bf16 ulps of the output's
    largest value, the mean within 1."""
    gc.collect()
    torch.cuda.empty_cache()
    fn, (params, latent, t) = graft_entry.entry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    out = fn(params, latent, t)
    torch.cuda.synchronize()
    counts = all_launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    if counts != ENTRY_LAUNCHES:
        raise AssertionError(f"entry: launches {counts}, want {ENTRY_LAUNCHES}")
    if (tuple(out.shape) != tuple(latent.shape) or out.dtype != torch.float32
            or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"entry: output {out.dtype} {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    walls = []
    for _ in range(ENTRY_REPEATS):
        t0 = time.perf_counter()
        fn(params, latent, t)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    x = torch.from_numpy(np.random.default_rng(SEED + 16).standard_normal(
        ENTRY_SMALL_LATENT, dtype=np.float32)).bfloat16()
    tt = torch.tensor([ENTRY_T])
    got = fn(params, x.cuda(), tt.cuda()).cpu()
    fn_cpu, _ = graft_entry.entry(device="cpu")
    want = fn_cpu({k: v.cpu() for k, v in params.items()}, x, tt)
    scale = float(want.abs().max())
    err = (got - want).abs()
    if not (float(err.max()) <= 4 * BF16_ULP * scale and float(err.mean()) <= BF16_ULP * scale):
        raise AssertionError(f"entry: card against CPU max {float(err.max()):.3e}, mean "
                             f"{float(err.mean()):.3e} at output scale {scale:.3e}")
    result = {"parameters": sum(p.numel() for p in params.values()),
              "latent": list(latent.shape), "launches": counts,
              "ms_per_forward": statistics.median(walls), "ms_per_forward_all": walls,
              "peak_memory_bytes": peak,
              "card_vs_cpu": {"latent": list(ENTRY_SMALL_LATENT), "max_abs_err": float(err.max()),
                              "mean_abs_err": float(err.mean()), "output_max": scale}}
    del fn, params, latent, out, fn_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return counts, result


def dryrun_check():
    """``graft_entry.dryrun_multichip(1)``: its one rank is a process of its
    own in an NCCL group of one, checked against the run without a mesh with
    the JAX bars; and the "need" error one card past the count."""
    t0 = time.perf_counter()
    out = graft_entry.dryrun_multichip(1)
    seconds = time.perf_counter() - t0
    if out["mesh"] != [1, 1]:
        raise AssertionError(f"dryrun_multichip(1): mesh {out['mesh']}")
    n = torch.cuda.device_count() + 1
    try:
        graft_entry.dryrun_multichip(n)
    except AssertionError as e:
        if f"need {n} devices, have {n - 1}" not in str(e):
            raise
    else:
        raise AssertionError(f"dryrun_multichip({n}) did not refuse")
    return {"seconds": seconds, **out}


def _load_example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def examples_check(tmp, tree):
    """Each ``examples/torch_*.py`` through its ``main([..., "--device",
    "cuda"])`` in this process, in ``tmp``, with the launch counts set to 0
    just before and read just after: the explorer launches nothing, the 2D
    DDPM the GroupNorm kernels only, the 3D LDM all five (its bottleneck
    attention at Dh = 4); losses finite, files written."""
    results, counts_by_run = {}, {}
    cwd, tempdir = os.getcwd(), tempfile.tempdir
    os.chdir(tmp)
    tempfile.tempdir = str(tmp)
    try:
        for name, argv in (
                ("torch_explore_dataset", ["--root", tree, "--max-subjects", 2]),
                ("torch_minimal_2d_ddpm", ["--out", tmp / "grid.png", "--device", "cuda"]),
                ("torch_scaled_3d_ldm", ["--out-dir", tmp / "ldm", "--device", "cuda"])):
            module = _load_example(name)
            gc.collect()
            torch.cuda.synchronize()
            text = io.StringIO()
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(_Tee(sys.stdout, text)):
                rc = module.main([str(a) for a in argv])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = all_launch_counts()
            if rc != 0:
                raise AssertionError(f"{name}: exit code {rc}")
            results[name] = {"seconds": seconds, "launches": counts}
            counts_by_run[f"example_{name[len('torch_'):]}"] = counts
            printed = text.getvalue()
            if name == "torch_explore_dataset":
                if any(counts.values()) or "aggregate nonzero-intensity" not in printed:
                    raise AssertionError(f"{name}: launches {counts}")
            elif name == "torch_minimal_2d_ddpm":
                losses = [float(x) for x in re.findall(r"^epoch \d+: loss (\S+) ", printed, re.M)]
                if (len(losses) != 2 or not all(map(math.isfinite, losses))
                        or not (tmp / "grid.png").stat().st_size):
                    raise AssertionError(f"{name}: losses {losses}")
                if (counts["gn_silu_stats"] == 0 or counts["gn_silu_stats"] != counts["gn_silu_apply"]
                        or any(counts[k] for k in fa.launches.as_dict())):
                    raise AssertionError(f"{name}: launches {counts}")
                results[name]["epoch_losses"] = losses
            else:
                scale = float(re.search(r"latent_scale=(\S+)", printed).group(1))
                losses = [float(x) for x in re.findall(r"train (\S+) val", printed)]
                if (not math.isfinite(scale) or len(losses) != 2
                        or not all(map(math.isfinite, losses))
                        or not (tmp / "ldm" / "vol0.png").stat().st_size):
                    raise AssertionError(f"{name}: latent scale {scale}, losses {losses}")
                if (min(counts.values()) == 0
                        or counts["flash_attn_bwd_dkv"] != counts["flash_attn_bwd_dq"]):
                    raise AssertionError(f"{name}: launches {counts}")
                if torch.distributed.is_initialized():
                    raise AssertionError(f"{name}: its group of one is still up")
                results[name].update(latent_scale=scale, stage_losses=losses,
                                     head_dim=4, kernel_head_dim=fa.kernel_head_dim(4))
    finally:
        os.chdir(cwd)
        tempfile.tempdir = tempdir
    return results, counts_by_run


def scripts_check(tmp, tree):
    """The four ``scripts/torch_*.sh`` as a scheduler would start them, each
    its own process on the card (``python`` and ``torchrun`` are this
    interpreter): ``torch_training_job.sh`` on ``configs/slice_cond_2d_tiny_cpu.json``
    and ``tree``, ``torch_sampling_job.sh`` on that run (grid, 5 DDIM
    steps), ``torch_preprocess_job.sh`` (on the CPU), and
    ``torch_training_job_multihost.sh`` under ``torchrun --nproc_per_node 1``
    with explicit variables and a ``localhost`` endpoint. Each must exit 0
    and write what it writes; their log directories and ``runs/`` entries
    are removed afterwards."""
    shims = tmp / "bin"
    shims.mkdir()
    for name, command in (("python", f'exec "{sys.executable}" "$@"'),
                          ("torchrun", f'exec "{sys.executable}" -m torch.distributed.run "$@"')):
        (shims / name).write_text(f"#!/bin/sh\n{command}\n")
        (shims / name).chmod(0o755)
    job = f"chip_smoke_{os.getpid()}"
    env = {k: v for k, v in os.environ.items()
           if k not in RANK_VARIABLES and not k.startswith("SLURM_")}
    env.update(PATH=f"{shims}{os.pathsep}{env.get('PATH', '')}", SLURM_JOB_ID=job)
    scripts, logs = REPO / "scripts", REPO / "scripts" / "logs"
    names = {"train": f"{job}_train", "multihost": f"{job}_mh"}
    results = {}

    def run(tag, script, log, *args, **extra):
        t0 = time.perf_counter()
        proc = subprocess.run(["bash", str(scripts / script), *map(str, args)],
                              env={**env, **extra}, capture_output=True, text=True,
                              timeout=SCRIPT_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        out = "".join(p.read_text() for p in sorted(log.glob("*.out")))
        err = "".join(p.read_text() for p in sorted(log.glob("*.err")))
        if proc.returncode != 0:
            raise AssertionError(f"{script}: exit code {proc.returncode}\n{proc.stderr[-2000:]}\n"
                                 f"--- log\n{out[-2000:]}\n{err[-4000:]}")
        results[tag] = {"seconds": seconds, "exit_code": proc.returncode}
        return out

    try:
        common = ["--root-dir", tree]
        out = run("training_job", "torch_training_job.sh", logs / "train" / job, SCRIPT_CONFIG,
                  *common, "--name", names["train"],
                  "--set", f"train.checkpoint_dir={tmp / 'ckpt'}")
        run_dir = tmp / "ckpt" / "slice_cond_2d" / names["train"]
        losses = [float(x) for x in re.findall(r"train (\S+) val", out)]
        if (not (run_dir / "config.json").exists() or not list(run_dir.glob("*.pt"))
                or not losses or not all(map(math.isfinite, losses))):
            raise AssertionError(f"torch_training_job.sh: run {sorted(run_dir.glob('*'))}, "
                                 f"losses {losses}")
        results["training_job"]["epoch_losses"] = losses
        shutil.rmtree(logs / "train" / job)
        run("sampling_job", "torch_sampling_job.sh", logs / "sample" / job, run_dir,
            "--mode", "grid", "--num-samples", 8, "--ddim-steps", 5,
            "--out-dir", tmp / "samples")
        if not (tmp / "samples" / "grid.png").stat().st_size:
            raise AssertionError("torch_sampling_job.sh wrote no grid")
        out = run("preprocess_job", "torch_preprocess_job.sh", logs / "preprocess" / job,
                  tree, tmp / "packed", 16)
        if "[cli] packed" not in out or not list((tmp / "packed").iterdir()):
            raise AssertionError(f"torch_preprocess_job.sh: {out[-1000:]}")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        run("training_job_multihost", "torch_training_job_multihost.sh", logs / "train" / job,
            SCRIPT_CONFIG, *common, "--name", names["multihost"],
            "--set", f"train.checkpoint_dir={tmp / 'ckpt_mh'}",
            MRIJAX_NODE_RANK="0", MRIJAX_NNODES="1", MRIJAX_GPUS_PER_NODE="1",
            MRIJAX_COORD=f"localhost:{port}")
        mh_dir = tmp / "ckpt_mh" / "slice_cond_2d" / names["multihost"]
        if not (mh_dir / "config.json").exists() or not list(mh_dir.glob("*.pt")):
            raise AssertionError(f"torch_training_job_multihost.sh: run {sorted(mh_dir.glob('*'))}")
    finally:
        for kind in ("train", "sample", "preprocess"):
            shutil.rmtree(logs / kind / job, ignore_errors=True)
        for name in names.values():
            shutil.rmtree(REPO / "runs" / "slice_cond_2d" / name, ignore_errors=True)
    return results


def entry_points_path():
    """Phase 16: ``mrijax_torch.graft_entry``, the examples and the job
    scripts on the card (``entry_check``, ``dryrun_check``,
    ``examples_check``, ``scripts_check``) over a synthetic BraTS tree of 3
    subjects at 32×32×20 in a temporary directory. Prints the
    ``entry_points_path`` line; returns the launch counts of the counted
    in-process runs."""
    t_phase = time.perf_counter()
    if torch.distributed.is_initialized():
        raise AssertionError("phase 16 starts with a process group still up")
    entry_counts, result = entry_check()
    counts_by_run = {"entry": entry_counts}
    result = {"entry": result, "dryrun_multichip_1": dryrun_check()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp_name:
        tmp = Path(tmp_name)
        tree = write_synthetic_brats(tmp / "tree", num_subjects=3, shape=(32, 32, 20))
        result["examples"], example_counts = examples_check(tmp, tree)
        counts_by_run.update(example_counts)
        result["scripts"] = scripts_check(tmp, tree)
    result["phase_seconds"] = time.perf_counter() - t_phase
    print("entry_points_path " + json.dumps(result))
    return counts_by_run


# ----------------------------------------------------------------------- main


# -------------------------------------------------------------------- phase 17

LARGE_HEAD_LEVELS = (1,)     # attention also at level 1: 256 channels, 16·20·20 = 6400 tokens
FLASH_PER_LARGE_HEAD_UNET = 3   # the bottleneck (Dh 512) and level 1 down and up (Dh 256)


def small_large_head_check():
    """A small float32 UNet3D with 1 head and attention at level 1 (base 72:
    Dh 144 at level 1 and 288 at the bottleneck, both zero-padded and run in
    128-column chunks) on the card against the CPU: ``generate_3d_volumes``
    with a small VAE3D (5 DDIM steps, 1e-3 as in ``small_pipeline_check``),
    then 2 cached-latent Adam steps (losses 1e-4, parameters 1e-3 relative
    L2, as in ``small_training_check``)."""
    kw = dict(in_channels=4, base_channels=72, channel_mults=(1, 2, 4), time_emb_dim=32,
              num_heads=1, attention_levels=LARGE_HEAD_LEVELS)
    unet = seeded_weights(UNet3D(**kw), SEED + 11)
    vae = seeded_weights(VAE3D(in_channels=2, base_channels=16, num_down=2, latent_channels=4),
                         SEED + 12)
    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(20)))
    rng = np.random.default_rng(SEED + 13)
    x_t = torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 4), dtype=np.float32))
    gen_kw = dict(num_volumes=2, latent_spatial=(8, 8, 8), latent_channels=4, ddim_steps=5,
                  x_t=x_t)
    reset_launch_counts()
    on_card = generate_3d_volumes(unet, vae, diffusion, device="cuda", **gen_kw).cpu()
    counts = all_launch_counts()
    if counts["flash_attn_fwd"] != 5 * FLASH_PER_LARGE_HEAD_UNET:
        raise AssertionError(f"small large-head pipeline: launches {counts}")
    on_cpu = generate_3d_volumes(unet, vae, diffusion, device="cpu", **gen_kw)
    gen_err = check_close("small large-head pipeline, card vs CPU", on_card, on_cpu, atol=1e-3)

    batches = [{"latent": torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 4), dtype=np.float32)),
                "noise": torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 4), dtype=np.float32)),
                "t": torch.from_numpy(rng.integers(1, 20, size=2))} for _ in range(2)]
    train_diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(20)), loss_type="min_snr")
    runs = {}
    for device in ("cuda", "cpu"):
        model = seeded_weights(UNet3D(**kw), SEED + 14)
        state = create_train_state(model, 1e-3, ema=False, device=device)
        step = make_cached_latent_train_step(model, train_diffusion)
        reset_launch_counts()
        losses = []
        for batch in batches:
            state, loss = step(state, {"latent": batch["latent"]}, None, 0.7,
                               t=batch["t"], noise=batch["noise"])
            losses.append(loss)
        counts = all_launch_counts()
        flash = ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")
        if device == "cuda" and any(counts[k] != len(batches) * FLASH_PER_LARGE_HEAD_UNET
                                    for k in flash):
            raise AssertionError(f"small large-head training: launches {counts}")
        if device == "cuda":
            train_counts = counts
        runs[device] = (torch.stack(losses).cpu(),
                        torch.cat([p.detach().flatten().cpu() for p in model.parameters()]))
    (loss_g, par_g), (loss_c, par_c) = runs["cuda"], runs["cpu"]
    loss_err = check_close("small large-head training losses, card vs CPU", loss_g, loss_c,
                           atol=1e-4)
    rel = float((par_g - par_c).norm() / par_c.norm())
    if not rel < 1e-3:
        raise AssertionError(f"small large-head training: parameters differ by {rel:.3e}")
    return {"generate_max_abs_err": gen_err, "train_loss_max_abs_err": loss_err,
            "train_parameter_rel_l2": rel, "train_launches": train_counts}


def large_head_path(four_heads_generate, four_heads_train):
    """Phase 17: the flagship UNet3D at 1 head with attention at level 1 as
    well (``attention_levels=(1,)``): every forward runs the bottleneck at
    Dh 512 (N = 800) and level 1 down and up at Dh 256 (N = 6400), the flash
    kernels' column-chunk route. After ``small_large_head_check``:
    ``generate_3d_volumes`` (2 volumes, 20 DDIM steps, the flagship VAE3D
    decode) and 2 + 5 cached-latent train steps at batch 8, each with the
    launch counts set to 0 just before and read just after and held exact
    (29 GroupNorm pairs and 3 flash forwards a forward; 3 + 3 + 3 flash
    launches a step); one forward of the flagship at 2 heads (Dh 256 at the
    bottleneck). s a step, s a call and peak memory beside the 4-head
    flagship's of phases 5 and 7 of this run."""
    phase_t0 = time.perf_counter()
    small = small_large_head_check()
    unet, vae, diffusion = build_flagship(num_heads=1, attention_levels=LARGE_HEAD_LEVELS)
    shape = (NUM_VOLUMES, *LATENT_SPATIAL, LATENT_CHANNELS)
    warm = torch.Generator(device="cuda").manual_seed(SEED + 3)
    generate_3d_volumes(unet, vae, diffusion, num_volumes=NUM_VOLUMES,
                        latent_spatial=LATENT_SPATIAL, latent_channels=LATENT_CHANNELS,
                        ddim_steps=2, generator=warm)
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diffusion.ddim_sample(unet, shape, gen, num_steps=DDIM_STEPS)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / DDIM_STEPS
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    vols = generate_3d_volumes(unet, vae, diffusion, num_volumes=NUM_VOLUMES,
                               latent_spatial=LATENT_SPATIAL, latent_channels=LATENT_CHANNELS,
                               ddim_steps=DDIM_STEPS, generator=gen)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    gen_counts = all_launch_counts()
    gen_peak = torch.cuda.max_memory_allocated()
    want_gn = DDIM_STEPS * GN_CALLS_PER_UNET + GN_CALLS_PER_DECODE
    want = {**gn_calls(want_gn), **gn_bwd_calls(0),
            "flash_attn_fwd": DDIM_STEPS * FLASH_PER_LARGE_HEAD_UNET,
            "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}
    if gen_counts != want:
        raise AssertionError(f"large-head generation: launch counts {gen_counts}, expected {want}")
    check_output("large-head generation", vols, (NUM_VOLUMES, 128, 160, 160, 4))
    del unet, vae, vols
    torch.cuda.empty_cache()

    # the flagship at 2 heads: one forward, Dh 256 at the bottleneck
    two, _, _ = build_flagship(num_heads=2)
    x = torch.from_numpy(np.random.default_rng(SEED + 15).standard_normal(
        shape, dtype=np.float32)).cuda()
    t = torch.full((NUM_VOLUMES,), T_STEPS // 2, dtype=torch.long, device="cuda")
    with torch.no_grad():
        two(x, t)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = two(x, t)
        torch.cuda.synchronize()
        two_s = time.perf_counter() - t0
    two_counts = all_launch_counts()
    want = {**gn_calls(GN_CALLS_PER_UNET), **gn_bwd_calls(0),
            "flash_attn_fwd": 1, "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}
    if two_counts != want:
        raise AssertionError(f"2-head forward: launch counts {two_counts}, expected {want}")
    check_output("2-head forward", out, shape)
    del two, x, out
    torch.cuda.empty_cache()

    batch = train_latents()
    model, state, step = build_flagship_trainer(None, num_heads=1,
                                                attention_levels=LARGE_HEAD_LEVELS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    losses = []
    for _ in range(TRAIN_WARMUP_STEPS):
        state, loss = step(state, batch, gen, 1.0)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, batch, gen, 1.0)
        losses.append(loss)
    torch.cuda.synchronize()
    train_s = (time.perf_counter() - t0) / TRAIN_STEPS
    train_counts = all_launch_counts()
    train_peak = torch.cuda.max_memory_allocated()
    want = {**gn_calls(TRAIN_STEPS * GN_CALLS_PER_UNET),
            **gn_bwd_calls(TRAIN_STEPS * GN_CALLS_PER_UNET),
            **{name: TRAIN_STEPS * FLASH_PER_LARGE_HEAD_UNET for name in
               ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")}}
    if train_counts != want:
        raise AssertionError(f"large-head training: launch counts {train_counts}, expected {want}")
    losses = torch.stack(losses).cpu()
    if not bool(torch.isfinite(losses).all()) or state.step != TRAIN_WARMUP_STEPS + TRAIN_STEPS:
        raise AssertionError(f"large-head training: losses {losses.tolist()}, {state.step} updates")
    del model, state, step
    torch.cuda.empty_cache()

    result = {
        "model": "flagship UNet3D, 1 head, attention at the bottleneck and level 1",
        "head_dims": {"bottleneck": 512, "level_1": 256},
        "card_vs_cpu": small,
        "seconds_per_ddim_step": step_s, "generate_3d_volumes_seconds": call_s,
        "generate_peak_memory_bytes": gen_peak, "generate_launches": gen_counts,
        "two_heads_forward_seconds": two_s, "two_heads_forward_launches": two_counts,
        "train_seconds_per_step": train_s, "train_peak_memory_bytes": train_peak,
        "train_launches_per_step": {k: v // TRAIN_STEPS for k, v in train_counts.items()},
        "train_losses": losses.tolist(),
        "four_heads": {
            "seconds_per_ddim_step": four_heads_generate["seconds_per_ddim_step"],
            "generate_3d_volumes_seconds": four_heads_generate["generate_3d_volumes_seconds"],
            "generate_peak_memory_bytes": four_heads_generate["peak_memory_bytes"],
            "train_seconds_per_step": four_heads_train["no_remat"]["seconds_per_step"],
            "train_peak_memory_bytes": four_heads_train["no_remat"]["peak_memory_bytes"]},
        "phase_seconds": time.perf_counter() - phase_t0,
    }
    print("large_head_path " + json.dumps(result))
    return {"large_head_generate": gen_counts, "large_head_two_heads_forward": two_counts,
            "large_head_train": train_counts,
            "large_head_train_fp32_small": small["train_launches"]}


# ------------------------------------------------------------------ phase 18

BENCH_GN = ("gn_silu_stats", "gn_silu_apply")
BENCH_GN_TRAIN = BENCH_GN + ("gn_silu_bwd_reduce", "gn_silu_bwd_apply")
BENCH_FLASH_BWD = ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")
BENCH_SAMPLE_3D = BENCH_GN + ("flash_attn_fwd",)
BENCH_TRAIN_3D = BENCH_GN_TRAIN + ("flash_attn_fwd",) + BENCH_FLASH_BWD
# argv of a mode → (metric, lines, the kernels it launches; the others it must not)
BENCH_MODES = [
    ((), "3d_ldm_volume_sampling_throughput", 1, BENCH_SAMPLE_3D),
    (("--train",), "3d_ldm_train_step_time", 1, BENCH_TRAIN_3D),
    (("--train-cached",), "3d_ldm_cached_train_throughput", 1, BENCH_TRAIN_3D),
    (("--train-cached-sweep",), "3d_ldm_cached_train_throughput", 5, BENCH_TRAIN_3D),
    (("--train-vae",), "vae3d_train_throughput", 1, BENCH_GN_TRAIN),
    (("--train-vae-sweep",), "vae3d_train_throughput", 6, BENCH_GN_TRAIN),
    (("--train-2d",), "slice_cond_2d_train_step_time", 1, BENCH_GN_TRAIN),
    (("--train-25d",), "ddpm_25d_train_step_time", 1, BENCH_GN_TRAIN),
    (("--train-2d-profile",), "slice_cond_2d_train_profile", 5, BENCH_GN_TRAIN),
    (("--sample-2d",), "slice_cond_2d_sampling_throughput", 1, BENCH_GN),
    (("--sample-2d", "--steps", "3", "--sampler", "dpm"), "slice_cond_2d_sampling_throughput",
     1, BENCH_GN),
    (("--sample-2d-sweep",), "slice_cond_2d_sampling_ladder", 9, BENCH_GN),
    (("--input-pipeline",), "input_pipeline_2d", 5, BENCH_GN_TRAIN),
    (("--eval-2d",), "eval_2d_throughput", 2, BENCH_GN),
    (("--sweep",), "3d_ldm_sampling_sweep", 6, BENCH_SAMPLE_3D),
    (("--smoke",), "3d_ldm_volume_sampling_throughput", 1, BENCH_SAMPLE_3D),
]
BENCH_PHASE_BUDGET_S = 90


def check_bench_line(tag, line, metric, card):
    """One line of ``mrijax_torch.bench`` on the card: its metric, the card
    it names, finite positive times, counted operations and an ``mfu`` in
    (0, 1] (none for a loader's host-only rate)."""
    host_only = line.get("variant", "").endswith("_host_only")
    dev = line["device"]
    problems = []
    if line["metric"] != metric:
        problems.append(f"metric {line['metric']}")
    if not isinstance(dev, dict) or dev["name"] != torch.cuda.get_device_name(0) \
            or dev["nvidia_smi"] != card or dev["count"] != torch.cuda.device_count():
        problems.append(f"device {dev}")
    if line["build_secs"] is None or line["cuda"] != torch.version.cuda:
        problems.append(f"build_secs {line['build_secs']}, cuda {line['cuda']}")
    times = [line["value"], *line["run_secs"]]
    if not all(isinstance(x, (int, float)) and math.isfinite(x) and x > 0 for x in times):
        problems.append(f"value / run_secs {times}")
    if host_only:
        if line["mfu"] is not None:
            problems.append(f"host-only mfu {line['mfu']}")
    elif not (line["flops"] and 0 < line["mfu"] <= 1 and line["peak_gb"] > 0):
        problems.append(f"flops {line['flops']}, mfu {line['mfu']}, peak_gb {line['peak_gb']}")
    if problems:
        raise AssertionError(f"bench {tag}: {'; '.join(problems)}: {line}")


def bench_path(card):
    """Phase 18: every mode of ``mrijax_torch.bench`` through its ``main``
    with ``--tiny`` on the card, then the headline with ``--smoke`` (batch 8,
    decode chunks of 4, 5 DDIM steps at full width). Each mode's launch
    counts are set to 0 just before and read just after; the kernels of its
    path must launch and no other."""
    phase_t0 = time.perf_counter()
    counts, summary = {}, {}
    for argv, metric, n_lines, kernels in BENCH_MODES:
        tag = " ".join(argv) or "headline"
        out = io.StringIO()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        reset_launch_counts()
        with contextlib.redirect_stdout(out):
            rc = port_bench.main([*argv] if "--smoke" in argv else [*argv, "--tiny"])
        got = all_launch_counts()
        seconds = time.perf_counter() - t0
        lines = [json.loads(x) for x in out.getvalue().splitlines()]
        if rc != 0 or len(lines) != n_lines:
            raise AssertionError(f"bench {tag}: exit {rc}, {len(lines)} lines, expected {n_lines}")
        for line in lines:
            print("bench " + json.dumps(line))
            check_bench_line(tag, line, metric, card)
        silent = [k for k in kernels if got[k] == 0]
        stray = [k for k, v in got.items() if k not in kernels and v]
        if silent or stray:
            raise AssertionError(f"bench {tag}: launch counts {got}: {silent} launched no "
                                 f"time, {stray} launched")
        if "--smoke" in argv:
            line = lines[0]
            want = {"batch": 8, "decode_chunk": 4, "ddim_steps": 5, "scale": "smoke"}
            if {k: line[k] for k in want} != want:
                raise AssertionError(f"bench --smoke: {line}")
            summary["smoke_headline"] = {k: line[k] for k in (
                "value", "secs_per_ddim_step", "decode_secs", "peak_gb", "mfu", "setup_secs")}
        name = "bench_" + ("_".join(a.lstrip("-").replace("-", "_") for a in argv) or "headline")
        counts[name] = got
        summary[name] = {"seconds": seconds, "lines": len(lines)}
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - phase_t0
    print("bench_path " + json.dumps({"phase_seconds": seconds,
                                       "budget_seconds": BENCH_PHASE_BUDGET_S, **summary}))
    return counts


def ptxas_rows(name):
    """(entry, registers, spill bytes) of one library's kernels as ``ptxas
    -v`` printed them."""
    entry, spills, rows = None, 0, []
    for line in _build.build_log(name).splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry, spills = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = max(int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            rows.append((entry, int(m.group(1)), spills))
            entry = None
    return rows


def wide_backward_copy_bytes(kernel, b, nq, nk, h, d):
    """Bytes the bf16 backward kernels above Dh 128 copy from L2 into shared
    memory in one launch (the loads of ``csrc/flash_attention_bwd.cu``,
    namespace ``wide``): per chunk of 256 columns (the last may be 128) and
    block of 64 own rows, the chunk's own rows once, then for every tile of
    64 rows of the other side the tile's chunk columns of two tensors, the
    other columns of all four tensors (own rows and tile) and, in dkv, the
    tile's lse and delta."""
    dkv = kernel == "flash_attn_bwd_dkv"
    own_rows, other_rows = (nk, nq) if dkv else (nq, nk)
    total = 0
    for c0 in range(0, d, fa.BACKWARD_CHUNK):
        width = min(fa.BACKWARD_CHUNK, d - c0)
        per_tile = 2 * 64 * width * 2 + 4 * 64 * (d - width) * 2 + (2 * 64 * 4 if dkv else 0)
        total += b * h * -(-own_rows // 64) * (2 * 64 * width * 2 + -(-other_rows // 64) * per_tile)
    return total


def wide_forward_copy_bytes(b, nq, nk, h, d, tile):
    """Bytes the bf16 forward kernel above Dh 128 copies from L2 into shared
    memory in one launch (the loads of ``csrc/flash_attention_fwd.cu``,
    namespace ``wide``): per chunk of 256 columns (the last may be 128) and
    block of ``tile`` query rows, the rows' q of the chunk once, then for
    every tile of 64 keys the chunk's columns of K and V and the other
    columns of K and of the rows' q."""
    total = 0
    for c0 in range(0, d, fa.BACKWARD_CHUNK):
        width = min(fa.BACKWARD_CHUNK, d - c0)
        per_tile = 2 * 64 * width * 2 + (64 + tile) * (d - width) * 2
        total += b * h * -(-nq // tile) * (tile * width * 2 + -(-nk // 64) * per_tile)
    return total


def wide_ptxas():
    """Registers and spill bytes of the three bf16 kernels above Dh 128, by
    kernel name (the forward's by its warpgroups a block, ``<1>`` and
    ``<2>``), and of every instance of the float32 backward kernel
    (``f32_instance``)."""
    names = {}
    for entry, regs, spilled in (ptxas_rows("flash_attention_fwd")
                                 + ptxas_rows("flash_attention_bwd")):
        if m := re.search(r"flash_fwd_wide_tc_kernelILi(\d)E", entry):
            name = f"flash_fwd_wide_tc_kernel<{m.group(1)}>"
        elif m := re.search(r"flash_bwd_d(?:kv|q)_wide_tc_kernel", entry):
            name = m.group(0)
        elif m := F32_ENTRY.search(entry):
            name = f32_name(*m.groups())
        elif m := F32_FWD_ENTRY.search(entry):
            name = f32_fwd_name(*m.groups())
        else:
            continue
        names[name] = {"registers": regs, "spill_bytes": spilled}
    return names


# flash_bwd_f32_kernel<DKV, DH, CW> in a mangled entry name
F32_ENTRY = re.compile(r"flash_bwd_f32_kernelILb(\d)ELi(\d+)ELi(\d+)E")


def f32_name(dkv, dh, cw):
    dh = ">= 384" if dh == "0" else dh
    return f"flash_bwd_f32_kernel<{'dkv' if dkv == '1' else 'dq'}, Dh {dh}, chunk {cw}>"


# flash_fwd_f32_kernel<OWN, DH, CW> in a mangled entry name
F32_FWD_ENTRY = re.compile(r"flash_fwd_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)E")


def f32_fwd_name(own, dh, cw):
    dh = "> 512" if dh == "0" else dh
    return f"flash_fwd_f32_kernel<{own} rows, Dh {dh}, chunk {cw}>"


def f32_fwd_instance(kd):
    """The float32 forward instance that runs at kernel head dim ``kd``
    (``csrc/flash_attention_fwd.cu::dispatch_f32``)."""
    plan = fa.launch_plan("flash_attn_fwd", 1, 1, 1, kd, torch.float32)
    return f32_fwd_name(str(plan.tile), str(kd if plan.chunks == 1 else 0),
                        str(kd // plan.chunks))


def f32_instance(dkv, kd):
    """The float32 backward instance that runs at kernel head dim ``kd``
    (``csrc/flash_attention_bwd.cu::dispatch_f32``)."""
    dh, cw = (kd, kd) if kd <= 256 else (0, 256 if kd % 256 == 0 else 128)
    return f32_name("1" if dkv else "0", str(dh), str(cw))


def report_ptxas(name):
    """Registers and spills of one library's kernels as ``ptxas -v`` printed
    them: the worst over all, a line for every tensor-core kernel, and every
    warning (a serialized ``wgmma`` among them)."""
    rows = ptxas_rows(name)
    for line in _build.build_log(name).splitlines():
        if "warning" in line.lower():
            print(f"  {name}: {line.strip()}")
    print(f"  ptxas {name}: {len(rows)} kernels, at most "
          f"{max((r[1] for r in rows), default=0)} registers, at most "
          f"{max((r[2] for r in rows), default=0)} bytes spilled")
    labels = ("Dh", "warps", "16-row fragments a warp")
    for entry, regs, spilled in rows:
        if m := re.search(r"(flash_(?:fwd|bwd_dkv|bwd_dq)_tc_kernel)I((?:Li\d+E)+)", entry):
            params = ", ".join(f"{label}={value}" for label, value in
                               zip(labels, re.findall(r"Li(\d+)E", m.group(2))))
            print(f"    {m.group(1)}<{params}>: {regs} registers, {spilled} bytes spilled")
        elif m := F32_ENTRY.search(entry) or F32_FWD_ENTRY.search(entry):
            label = (f32_name if m.re is F32_ENTRY else f32_fwd_name)(*m.groups())
            print(f"    {label} (three TF32 passes, wgmma): {regs} registers, "
                  f"{spilled} bytes spilled")
        elif m := re.search(r"\d(flash_[a-z_]*wide[a-z_]*_kernel)", entry):
            chunks = "256-column chunks, wgmma" if "tc" in m.group(1) else "128-column chunks"
            if wgs := re.search(r"wide_tc_kernelILi(\d)E", entry):
                chunks += f", {wgs.group(1)} warpgroup(s) of 64 rows"
            print(f"    {m.group(1)}{'<float>' if 'If' in entry else ''} (Dh > 128, "
                  f"{chunks}): {regs} registers, {spilled} bytes spilled")


WGMMA_KERNELS = ("flash_fwd_wide_tc_kernel", "flash_bwd_dkv_wide_tc_kernel",
                 "flash_bwd_dq_wide_tc_kernel", "flash_bwd_f32_kernel", "flash_fwd_f32_kernel")
TENSOR_CORE_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
                       "flash_bwd_dq_tc_kernel") + WGMMA_KERNELS


def tensor_core_proof(libs):
    """Count the ``HMMA`` (``mma.sync``) and ``HGMMA`` (``wgmma``)
    instructions in the machine code of the two flash-attention libraries
    and of each tensor-core kernel in them (all its instantiations
    together); a library or kernel without any did not get its tensor-core
    code, and an instance of a warpgroup kernel (``WGMMA_KERNELS``) without
    ``HGMMA`` not its warpgroup products."""
    cuobjdump = _build.cuda_tool("cuobjdump")
    counts = {name: {"HMMA": 0, "HGMMA": 0}
              for name in ("flash_attention_fwd", "flash_attention_bwd") + TENSOR_CORE_KERNELS}

    without = []   # instances of a warpgroup kernel without HGMMA

    def add(name, sass):
        for op in ("HMMA", "HGMMA"):
            counts[name][op] += len(re.findall(rf"\b{op}\.", sass))

    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        sass = subprocess.run([cuobjdump, "-sass", str(libs[name])], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        add(name, sass)
        for function in re.split(r"\n\s*Function : ", sass)[1:]:
            kernel = next((k for k in TENSOR_CORE_KERNELS if k in function.split("\n", 1)[0]), None)
            if kernel:
                add(kernel, function)
                if kernel in WGMMA_KERNELS and not re.search(r"\bHGMMA\.", function):
                    without.append(function.split("\n", 1)[0].strip())
    print("tensor_core_instructions " + json.dumps(counts))
    if min(sum(c.values()) for c in counts.values()) == 0:
        raise AssertionError(f"a flash-attention library or kernel holds no HMMA/HGMMA "
                             f"instruction: {counts}")
    if min(counts[k]["HGMMA"] for k in WGMMA_KERNELS) == 0 or without:
        raise AssertionError(f"a warpgroup kernel holds no HGMMA instruction: {counts}, "
                             f"instances without: {without}")


def kernel_records(gn_worst, flash_worst, bwd_worst, gn_rows, flash_rows, bwd_rows,
                   counts_by_path, chunk_worst, chunk_rows, small_worst, small_rows,
                   large_worst, large_rows, gn_wide_rows, gn_bwd_worst, gn_bwd_rows):
    """One record per kernel, at its heaviest main-path shape in bf16 (the
    flash kernels at the training batch).
    ``launches`` adds up the counted runs of every path (``counts_by_path``:
    path name → launch counts); ``launches_by_path`` keeps them apart. The
    flash kernels also carry their Nq ≠ Nk chunks (``nq_ne_nk``: max abs
    error by dtype and the bf16 times of phase 3) and the head dims they are
    not compiled for (``small_head_dims``: padded to ``kernel_head_dim``,
    max abs error by dtype and the times of ``time_flash_small_dh``) and the
    head dims above 128 (``large_head_dims``: run in column chunks, max abs
    error by dtype and the times of ``time_flash_large_dh``); the two backward
    kernels and the forward their float32 times at the training batch
    (``float32``, with the tensor-core bound of three TF32 passes beside the
    CUDA-core one);
    ``gn_silu_stats`` and ``gn_silu_apply`` their times at 4096 and 8192
    channels (``wide_channels``); the GroupNorm+SiLU backward's two kernels
    one record (``gn_silu_bwd``, launches of ``gn_silu_bwd_reduce``, each
    ``gn_silu_bwd_apply`` with it) at its heaviest UNet shape, errors relative
    to the float64 gradient's largest value."""
    big = max(gn_rows, key=lambda r: r["shape"][0] * r["shape"][1] * r["shape"][2])
    fl = next(r for r in flash_rows
              if r["dtype"] == "bfloat16" and tuple(r["shape"]) == FLASH_TRAIN)
    fl32 = next(r for r in flash_rows
                if r["dtype"] == "float32" and tuple(r["shape"]) == FLASH_TRAIN)
    bw = bwd_rows[0]
    bw32 = next(r for r in bwd_rows if r["dtype"] == "float32")
    src_gn = "mrijax_torch/csrc/groupnorm_silu.cu"
    src_bwd = "mrijax_torch/csrc/flash_attention_bwd.cu"
    gb = max((r for r in gn_bwd_rows if r["calls_per_step"]),
             key=lambda r: r["shape"][0] * r["shape"][1] * r["shape"][2])

    def launches(name):
        by_path = {path: counts[name] for path, counts in counts_by_path.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def chunks(name, prefix):
        return {"nq_ne_nk": {
            "max_abs_err": chunk_worst[name],
            "times": [{"q": r["q"], "kv": r["kv"], "ms": r[f"{prefix}_ms"],
                       "plain_ms": r[f"{prefix}_plain_ms"], "bound_ms": r[f"{prefix}_bound_ms"],
                       "bound_by": r[f"{prefix}_bound_by"],
                       "library_ms": r.get(f"{prefix}_library_ms", r["library_backward_ms"])}
                      for r in chunk_rows]}}

    def small(name, prefix):
        return {"small_head_dims": {
            "max_abs_err": small_worst[name],
            "times": [{"shape": r["shape"], "dtype": r["dtype"],
                       "padded_to": r["kernel_head_dim"], "ms": r[f"{prefix}_ms"],
                       "padded_kernel_ms": r[f"{prefix}_padded_kernel_ms"],
                       "plain_ms": r[f"{prefix}_plain_ms"], "bound_ms": r[f"{prefix}_bound_ms"],
                       "bound_by": r[f"{prefix}_bound_by"],
                       "library_ms": r.get(f"{prefix}_library_ms", r["library_backward_ms"])}
                      for r in small_rows]}}

    def large(name, prefix):
        return {"large_head_dims": {
            "max_abs_err": large_worst[name],
            "times": [{"q": r["q"], "kv": r["kv"], "dtype": r["dtype"],
                       "kernel_head_dim": r["kernel_head_dim"], "ms": r[f"{prefix}_ms"],
                       "plain_ms": r[f"{prefix}_plain_ms"], "bound_ms": r[f"{prefix}_bound_ms"],
                       "bound_by": r[f"{prefix}_bound_by"],
                       "bound_tc_ms": r.get(f"{prefix}_bound_tc_ms"),
                       "library_ms": r.get(f"{prefix}_library_ms", r["library_backward_ms"])}
                      for r in large_rows]}}

    def float32(prefix):
        # the float32 kernel at the training batch: bound_ms at the CUDA
        # cores' rate, bound_tc_ms at that of three TF32 passes
        return {"float32": {
            "shape": bw32["shape"], "ms": bw32[f"{prefix}_ms"],
            "plain_ms": bw32[f"{prefix}_plain_ms"], "library_ms": bw32["library_ms"],
            "bound_ms": bw32[f"{prefix}_bound_ms"], "bound_tc_ms": bw32[f"{prefix}_bound_tc_ms"],
            "bound_by": bw32[f"{prefix}_bound_by"]}}

    def wide(prefix, library):
        return {"wide_channels": [
            {"shape": r["shape"], "ms": r[f"{prefix}_ms"], "plain_ms": r[f"{prefix}_plain_ms"],
             "bound_ms": r[f"{prefix}_bound_ms"], "bound_by": "bytes",
             "library_ms": r[f"{prefix}_library_ms"] if library else None}
            for r in gn_wide_rows]}

    return [
        {"name": "gn_silu_stats", "route": "cuda", "source": src_gn,
         "replaces": "mrijax/kernels/groupnorm_pallas.py:120",
         **launches("gn_silu_stats"), "shape": big["shape"], "dtype": "bfloat16",
         "max_abs_err": gn_worst["gn_silu_stats"]["float32"],
         "max_abs_err_bf16": gn_worst["gn_silu_stats"]["bfloat16"],
         "ms": big["stats_ms"], "plain_ms": big["stats_plain_ms"],
         "bound_ms": big["stats_bound_ms"], "bound_by": "bytes",
         "library_ms": big["stats_library_ms"], **wide("stats", True)},
        {"name": "gn_silu_apply", "route": "cuda", "source": src_gn,
         "replaces": "mrijax/kernels/groupnorm_pallas.py:135",
         **launches("gn_silu_apply"), "shape": big["shape"], "dtype": "bfloat16",
         "max_abs_err": gn_worst["gn_silu_apply"]["float32"],
         "max_abs_err_bf16": gn_worst["gn_silu_apply"]["bfloat16"],
         "ms": big["apply_ms"], "plain_ms": big["apply_plain_ms"],
         "bound_ms": big["apply_bound_ms"], "bound_by": "bytes",
         "library_ms": None, **wide("apply", False)},
        {"name": "gn_silu_bwd", "route": "cuda", "source": src_gn, "replaces": None,
         **launches("gn_silu_bwd_reduce"), "shape": gb["shape"], "dtype": "bfloat16",
         "max_rel_err": gn_bwd_worst["float32"], "max_rel_err_bf16": gn_bwd_worst["bfloat16"],
         "ms": gb["ms"], "plain_ms": gb["plain_ms"], "bound_ms": gb["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "mrijax_torch/csrc/flash_attention_fwd.cu",
         "replaces": "mrijax/kernels/flash_attention_pallas.py:162",
         **launches("flash_attn_fwd"), "shape": fl["shape"], "dtype": fl["dtype"],
         "max_abs_err": flash_worst["float32"], "max_abs_err_bf16": flash_worst["bfloat16"],
         "ms": fl["ms"], "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
         "bound_by": fl["bound_by"], "library_ms": fl["library_ms"],
         **chunks("flash_attn_fwd", "fwd"), **small("flash_attn_fwd", "fwd"),
         **large("flash_attn_fwd", "fwd"),
         "float32": {"shape": fl32["shape"], "ms": fl32["ms"], "plain_ms": fl32["plain_ms"],
                     "library_ms": fl32["library_ms"], "bound_ms": fl32["bound_ms"],
                     "bound_tc_ms": fl32["bound_tc_ms"], "bound_by": fl32["bound_by"]}},
        # library_ms of the two backward kernels is one call that computes dq,
        # dk and dv together
        {"name": "flash_attn_bwd_dkv", "route": "cuda", "source": src_bwd,
         "replaces": "mrijax/kernels/flash_attention_pallas.py:332",
         **launches("flash_attn_bwd_dkv"), "shape": bw["shape"], "dtype": bw["dtype"],
         "max_abs_err": bwd_worst["flash_attn_bwd_dkv"]["float32"],
         "max_abs_err_bf16": bwd_worst["flash_attn_bwd_dkv"]["bfloat16"],
         "ms": bw["dkv_ms"], "plain_ms": bw["dkv_plain_ms"], "bound_ms": bw["dkv_bound_ms"],
         "bound_by": bw["dkv_bound_by"], "library_ms": bw["library_ms"],
         **chunks("flash_attn_bwd_dkv", "dkv"), **small("flash_attn_bwd_dkv", "dkv"),
         **large("flash_attn_bwd_dkv", "dkv"), **float32("dkv")},
        {"name": "flash_attn_bwd_dq", "route": "cuda", "source": src_bwd,
         "replaces": "mrijax/kernels/flash_attention_pallas.py:358",
         **launches("flash_attn_bwd_dq"), "shape": bw["shape"], "dtype": bw["dtype"],
         "max_abs_err": bwd_worst["flash_attn_bwd_dq"]["float32"],
         "max_abs_err_bf16": bwd_worst["flash_attn_bwd_dq"]["bfloat16"],
         "ms": bw["dq_ms"], "plain_ms": bw["dq_plain_ms"], "bound_ms": bw["dq_bound_ms"],
         "bound_by": bw["dq_bound_by"], "library_ms": bw["library_ms"],
         **chunks("flash_attn_bwd_dq", "dq"), **small("flash_attn_bwd_dq", "dq"),
         **large("flash_attn_bwd_dq", "dq"), **float32("dq")},
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

    script_t0 = time.perf_counter()
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
    chunk_worst = compare_flash_chunks(rng)
    small_worst = compare_flash_head_dims(
        rng, [(shape, shape) for shape in FLASH_SMALL_DH] + [FLASH_SMALL_DH_CHUNK], "small Dh")
    large_worst = compare_flash_head_dims(
        rng, [(shape, shape) for shape in FLASH_LARGE_DH] + [FLASH_LARGE_DH_CHUNK], "large Dh")
    gn_bwd_worst = compare_groupnorm_backward(rng)
    torch.cuda.empty_cache()
    gn_rows, _, gn_wide_rows = time_groupnorm(rng)
    if args.profile:
        profile_groupnorm_stats(rng)
    gn_bwd_rows = time_groupnorm_backward(rng)
    flash_rows = time_flash(rng)
    bwd_rows = time_flash_backward(rng)
    chunk_rows = time_flash_chunks(rng)
    small_rows = time_flash_small_dh(rng)
    large_rows = time_flash_large_dh(rng)
    torch.cuda.empty_cache()
    conv3d_path()
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

    counts_fp32_train = small_training_check()
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
    counts_driver = driver_path(train_result["no_remat"]["seconds_per_step"])
    counts_entry = entry_points_path()
    counts_large_head = large_head_path(result, train_result)
    counts_bench = bench_path(card)

    counts_by_path = {"generate": result["launches"],
                      "train_no_remat": train_counts["no_remat"],
                      "train_remat_level0": train_counts["remat_level0"],
                      **trainer_counts, **counts_2d, **counts_25d, **counts_train_2d,
                      **counts_driver, **counts_entry, **counts_large_head, **counts_bench,
                      "train_fp32_small": counts_fp32_train}
    print(f"chip_smoke total: {time.perf_counter() - script_t0:.1f} s")
    print(json.dumps({"kernels": kernel_records(
        gn_worst, flash_worst, bwd_worst, gn_rows, flash_rows, bwd_rows, counts_by_path,
        chunk_worst, chunk_rows, small_worst, small_rows, large_worst, large_rows,
        gn_wide_rows, gn_bwd_worst, gn_bwd_rows)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
