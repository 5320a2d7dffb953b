"""Benchmarks of the port on one NVIDIA GPU: the counterpart of ``bench.py``.

    python3 -m mrijax_torch.bench                       # headline: 3D volume sampling
    python3 -m mrijax_torch.bench --train-cached        # one mode a call
    python3 -m mrijax_torch.bench --sample-2d --steps 50 --sampler dpm
    python3 -m mrijax_torch.bench --smoke               # full widths, few steps and runs
    python3 -m mrijax_torch.bench --tiny --device cpu --train-2d   # small widths, CPU

Every mode of ``bench.py::main`` has a counterpart under the same flag,
prints its JSON lines under the same ``metric`` names and drives the port's
own entry points, with ``bench.py``'s flagship widths and protocols as the
defaults:

* the headline (no flag), ``3d_ldm_volume_sampling_throughput``:
  ``ddim_sample``, then ``VAE3D.decode_from_latent`` ``DECODE_CHUNK`` volumes
  at a time (``sample_volumes``);
* ``--train``, ``3d_ldm_train_step_time``: ``make_latent_diffusion_train_step``;
* ``--train-cached`` and ``--train-cached-sweep`` (a line a rung),
  ``3d_ldm_cached_train_throughput``: ``make_cached_latent_train_step``;
* ``--train-vae`` and ``--train-vae-sweep``, ``vae3d_train_throughput``:
  ``make_vae_train_step``;
* ``--train-2d`` / ``--train-25d``, ``slice_cond_2d_train_step_time`` /
  ``ddpm_25d_train_step_time``, and ``--train-2d-profile``,
  ``slice_cond_2d_train_profile`` (the rows ``per_step_readback``,
  ``chained``, ``fwd_only``, ``fwd_bwd``, ``chained_b128``):
  ``make_diffusion_train_step``;
* ``--sample-2d [--steps N --sampler S]``,
  ``slice_cond_2d_sampling_throughput``: ``p_sample_loop_auto`` (T = 1000
  ancestral), or ``fast_sample`` with ``--steps``; ``--sample-2d-sweep``,
  ``slice_cond_2d_sampling_ladder``: batch 64/128/256 × {ancestral, DDIM-50,
  DPM-20};
* ``--input-pipeline``, ``input_pipeline_2d``: ``BatchLoader`` over
  ``PackedSliceDataset`` and ``SliceDataset2D``;
* ``--eval-2d``, ``eval_2d_throughput``: ``evaluate_conditional_2d`` with a
  random-init ``InceptionFeatureExtractor``;
* ``--sweep``, ``3d_ldm_sampling_sweep``: ``sample_volumes`` with
  ``fast_sample``.

Every line also carries, beside ``bench.py``'s own keys:

* ``device``: the card's name (``torch.cuda.get_device_name``), the device
  count, the line ``nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader`` prints for it and the power limit in W; ``"cpu"``
  on the CPU;
* ``torch`` and ``cuda``: the versions;
* ``source``: a content hash of ``mrijax_torch/**/*.py`` and
  ``mrijax_torch/csrc/*``, which stands in for the commit (a copy of the tree
  need not be a git checkout);
* ``scale``: ``"full"``, ``"smoke"`` (``--smoke``: full widths, step and run
  counts cut) or ``"tiny"`` (``--tiny``: small widths too);
* ``batch``, ``build_secs`` (the ``nvcc`` build, ``_build.build_all()``;
  null on the CPU), ``setup_secs`` (models, weights, data and the warm-up);
* ``run_secs``: each timed run's seconds; ``value`` keeps their mean (in the
  unit ``bench.py`` gives it);
* ``flops``: the operations of the timed work a run, counted from shapes, and
  ``mfu``: flops / seconds / 989e12 (the bf16 dense tensor-core peak of an
  H100 SXM at 700 W; the card's limit is in ``device``), null off the card,
  as ``bench.py::_mfu`` is null off the TPU; ``peak_gb``, the most device
  memory the mode held (``torch.cuda.max_memory_allocated``), null on the CPU.

The headline also carries ``ddim_steps`` (the model calls of one run),
``secs_per_ddim_step`` (the denoise's seconds over them), ``decode_secs`` and
``decode_chunk``.

**Timing** is ``bench.py``'s protocol: one warm-up call, then its number of
timed runs (2 for sampling, 4 for the 3D train steps, 6 for 2D; the chained
rows one run of 20 steps). Each run is timed by the host clock and ends in
``torch.cuda.synchronize()``, which takes the place of ``bench.py``'s
``float(...)`` read-back. ``bench.py``'s "T = 400 DDIM" is 399 model calls
(``ddim_timestep_sequence(400)`` over T = 400 runs 399 → 1); the lines count
what runs.

**Operations** (``forward_flops``): forward hooks over one call at batch 1,
scaled by the batch — 2 per multiply-add of every convolution tap that meets
the input (XLA's cost-analysis convention; a transposed convolution: every
input position and tap whose output lies inside the output), 1 per bias add,
2 per multiply-add of every ``Linear``, and 4·B·H·Nq·Nk·Dh for the two
attention products, which no hook sees inside the flash kernels. The
elementwise work (GroupNorm, SiLU, adds, softmax) is left out. A train step
counts 3 forwards plus the forward of every block the backward recomputes
(``recomputed_flops``: the blocks entered twice in one forward and
backward), the recompute counted as in ``bench.py``'s cost analysis of a
remat step: hardware operations, not model operations.

**Random streams**: one ``torch.Generator`` a run on the device, seeded from
``numpy.random.SeedSequence((SEED, run))`` (``evals.harness.call_generator``;
the warm-up draws from ``(SEED,)``), in place of ``PRNGKey`` and ``fold_in``.
Weights are small normals from ``SEED`` (GroupNorm scale 1, bias 0) and the
data ``numpy.random.default_rng`` draws as ``bench.py`` makes them.

**Failures.** Only the sweep rungs ``bench.py`` marks "possible OOM" (batch
48 of ``--train-cached-sweep``) catch, and only
``torch.cuda.OutOfMemoryError``: they print ``value: null`` and the error.
Every other error raises and the run exits non-zero. ``--device`` defaults to
``cuda`` and raises where there is no card (``_device.require_device``);
``--device cpu`` runs the kernels' plain versions, for the tests. No mode
falls back to a plain version or to the CPU.

**No counterpart, by design** (TPU or tunnel machinery, or a TPU-era
estimate that is no target for the port):

* the compile cache and ``_client_cache_worth_it``: no XLA compile; the
  kernels are built once into ``mrijax_torch/_build``;
* ``_export_cached``: nothing is traced, so there is no trace to keep;
* ``_calibrate_session``, ``session_tflops`` and ``calibration_secs``: a
  yardstick for the tunnel's session-to-session spread;
* the tunnel retry in ``__main__``;
* ``setup_client_secs`` and ``setup_worker_secs``: the tunnel's client and
  worker halves of the set-up; ``build_secs`` and ``setup_secs`` instead;
* ``BASELINE_VOL_PER_S`` and ``vs_baseline``, ``V5E_BF16_PEAK_FLOPS``: a
  TPU-era estimate of the reference and the TPU's peak;
* ``ancestral_segments_for_backend``: an eager loop is one execution a step,
  so nothing is cut into segments;
* the ``chained_pallas_off`` row: no switch routes CUDA tensors to the plain
  versions, and none may exist.
"""

import argparse
import dataclasses
import gc
import hashlib
import itertools
import json
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from statistics import fmean
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from mrijax_torch._device import require_device
from mrijax_torch.diffusion import (
    GaussianDiffusion,
    cosine_beta_schedule,
    linear_beta_schedule,
    make_schedule,
)
from mrijax_torch.evals.harness import call_generator
from mrijax_torch.models import UNet2D, UNet3D, VAE3D
from mrijax_torch.models.blocks import AttentionBlock3D, _Conv, _Upsample
from mrijax_torch.train.state import create_train_state
from mrijax_torch.train.steps import sample_timesteps

PACKAGE = Path(__file__).resolve().parent
PEAK_FLOPS = 989e12   # bf16 dense tensor-core peak of one H100 SXM (data sheet, 700 W)
T_STEPS = 400         # the 3D cosine schedule
T_2D = 1000           # the 2D linear schedule
SEED = 0              # of the weights and the random streams
BF16 = torch.bfloat16


# ------------------------------------------------------------------- sizes


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths, batches and counts of every mode. ``FULL`` is ``bench.py``'s;
    ``step_cap`` and ``run_cap`` cut the step and run counts (``--smoke``,
    ``--tiny``)."""

    unet3d: Dict               # UNet3D widths (its ``in_channels`` is the latent's)
    vae3d: Dict                # VAE3D widths
    latent: Tuple[int, ...]    # (D, H, W) of the latent
    batch_3d: int              # BATCH
    decode_chunk: int          # DECODE_CHUNK
    cached_batch: int
    # (batch, remat, remat_levels, possible OOM)
    cached_sweep: Tuple[Tuple[int, bool, Optional[Tuple[int, ...]], bool], ...]
    vae_sweep: Tuple[Tuple[int, bool, int], ...]         # (batch, remat, grad_accum)
    sweep_3d: Tuple[Tuple[int, int, int, str], ...]      # (batch, chunk, steps, sampler)
    unet2d: Dict               # UNet2D widths
    image_size: int
    batch_2d: int
    pipeline_subjects: int
    pipeline_shape: Tuple[int, int, int]   # (H, W, D) of a synthetic volume
    eval_fast: Tuple[int, int]             # (samples, diversity pairs), DPM-20
    eval_protocol: int                     # samples, full-T ancestral
    inception_size: int
    step_cap: Optional[int] = None
    run_cap: Optional[int] = None

    def steps(self, n: int) -> int:
        return n if self.step_cap is None else min(n, self.step_cap)

    def runs(self, n: int) -> int:
        return n if self.run_cap is None else min(n, self.run_cap)

    @property
    def volume(self) -> Tuple[int, ...]:
        """(D, H, W, C) of a full-resolution volume."""
        f = 2 ** (self.vae3d["num_down"] - 1)
        return (*(f * n for n in self.latent), self.vae3d["in_channels"])


FULL = Sizes(
    unet3d=dict(in_channels=16, base_channels=128, channel_mults=(1, 2, 4), num_heads=4),
    vae3d=dict(in_channels=4, base_channels=32, num_down=3, latent_channels=16),
    latent=(32, 40, 40), batch_3d=8, decode_chunk=4, cached_batch=32,
    cached_sweep=((32, True, None, False), (32, False, (0,), False),
                  (16, False, (0,), False), (48, False, (0,), True), (48, True, None, True)),
    vae_sweep=((1, True, 1), (4, True, 4), (8, True, 8), (8, True, 4), (2, True, 1),
               (1, False, 1)),
    sweep_3d=((8, 4, T_STEPS, "ddim"), (16, 4, T_STEPS, "ddim"), (16, 2, T_STEPS, "ddim"),
              (8, 4, 50, "ddim"), (8, 4, 20, "dpm"), (8, 4, 50, "dpm")),
    unet2d=dict(base_channels=64, channel_mults=(1, 2, 4, 8)),
    image_size=128, batch_2d=64, pipeline_subjects=6, pipeline_shape=(128, 128, 80),
    eval_fast=(256, 32), eval_protocol=64, inception_size=299,
)
SMOKE = dataclasses.replace(FULL, step_cap=5, run_cap=1)
TINY = Sizes(
    unet3d=dict(in_channels=4, base_channels=8, channel_mults=(1, 2), num_heads=2,
                time_emb_dim=16),
    vae3d=dict(in_channels=2, base_channels=8, num_down=2, latent_channels=4),
    latent=(4, 8, 8), batch_3d=2, decode_chunk=1, cached_batch=2,
    cached_sweep=((2, True, None, False), (2, False, (0,), False), (1, False, (0,), False),
                  (3, False, (0,), True), (3, True, None, True)),
    vae_sweep=FULL.vae_sweep,
    sweep_3d=((2, 1, T_STEPS, "ddim"), (4, 1, T_STEPS, "ddim"), (4, 2, T_STEPS, "ddim"),
              (2, 1, 50, "ddim"), (2, 1, 20, "dpm"), (2, 1, 50, "dpm")),
    unet2d=dict(base_channels=8, channel_mults=(1, 2), time_emb_dim=16),
    image_size=16, batch_2d=4, pipeline_subjects=2, pipeline_shape=(32, 32, 20),
    eval_fast=(8, 2), eval_protocol=4, inception_size=75, step_cap=2, run_cap=1,
)
SCALES = {"full": FULL, "smoke": SMOKE, "tiny": TINY}


# -------------------------------------------------------------- operations


def _axis_pairs(n_in: int, n_out: int, k: int, stride: int, pad: int, dil: int,
                transposed: bool) -> int:
    """Along one axis, the (position, tap) pairs of a convolution that meet
    the input: for a convolution (output, tap) pairs whose input position
    lies inside the input, for a transposed one (input, tap) pairs whose
    output position lies inside the output."""
    if transposed:
        return sum(1 for i in range(n_in) for j in range(k)
                   if 0 <= i * stride - pad + j * dil < n_out)
    return sum(1 for o in range(n_out) for j in range(k)
               if 0 <= o * stride - pad + j * dil < n_in)


def _conv_flops(mod: nn.modules.conv._ConvNd, x: torch.Tensor, y: torch.Tensor) -> int:
    if isinstance(mod.padding, str):
        raise ValueError(f"{type(mod).__name__}: padding {mod.padding!r} is not counted")
    # the port's convolutions take channels-last activations, torch's own channels-first
    last = isinstance(mod, (_Conv, _Upsample))
    sp_in = x.shape[1:-1] if last else x.shape[2:]
    sp_out = y.shape[1:-1] if last else y.shape[2:]
    transposed = isinstance(mod, nn.modules.conv._ConvTransposeNd)
    pairs = 1
    for a, (n_in, n_out) in enumerate(zip(sp_in, sp_out)):
        pairs *= _axis_pairs(n_in, n_out, mod.kernel_size[a], mod.stride[a], mod.padding[a],
                             mod.dilation[a], transposed)
    macs = x.shape[0] * pairs * mod.in_channels * mod.out_channels // mod.groups
    return 2 * macs + (0 if mod.bias is None else y.numel())


def _layer_flops(mod: nn.Module, x: torch.Tensor, y: torch.Tensor) -> int:
    if isinstance(mod, nn.modules.conv._ConvNd):
        return _conv_flops(mod, x, y)
    if isinstance(mod, nn.Linear):
        rows = x.numel() // mod.in_features
        return 2 * rows * mod.in_features * mod.out_features + (
            0 if mod.bias is None else rows * mod.out_features)
    # AttentionBlock3D: q′kᵀ and P·V over all tokens; its linears count themselves
    b, c = x.shape[0], x.shape[-1]
    n = x[0, ..., 0].numel()
    return 4 * b * n * n * c


COUNTED = (nn.modules.conv._ConvNd, nn.Linear, AttentionBlock3D)


def _flops_by_layer(module: nn.Module, call: Callable[[], object]) -> Dict[nn.Module, int]:
    """Operations of each counted layer of ``module`` in one ``call()``
    (under ``no_grad``)."""
    by_layer: Dict[nn.Module, int] = Counter()

    def hook(mod, args, out):
        by_layer[mod] += _layer_flops(mod, args[0], out)

    hooks = [m.register_forward_hook(hook) for m in module.modules() if isinstance(m, COUNTED)]
    try:
        with torch.no_grad():
            call()
    finally:
        for h in hooks:
            h.remove()
    return by_layer


def forward_flops(module: nn.Module, call: Callable[[], object]) -> int:
    """Operations of one ``call()`` that runs ``module`` (or part of it):
    2 per multiply-add of every convolution tap that meets the input, 1 per
    bias add, 2 per multiply-add of every ``Linear`` and 4·B·H·Nq·Nk·Dh for
    each attention block's two products. Elementwise work is left out."""
    return int(sum(_flops_by_layer(module, call).values()))


def recomputed_flops(module: nn.Module, call: Callable[[], torch.Tensor]) -> int:
    """Operations a backward recomputes under remat: the forward of every
    block of ``module`` that is entered twice in one forward of ``call()``
    and the backward of its output's sum (outermost such blocks only).
    Leaves ``module``'s ``.grad`` unset."""
    entries: Counter = Counter()
    hooks = [m.register_forward_pre_hook(lambda mod, args: entries.update([mod]))
             for m in module.modules()]
    try:
        with torch.enable_grad():
            call().float().sum().backward()
    finally:
        for h in hooks:
            h.remove()
    module.zero_grad(set_to_none=True)
    twice = {m for m, n in entries.items() if n >= 2}
    inner = {c for m in twice for c in m.modules() if c is not m}
    by_layer = _flops_by_layer(module, call)
    return int(sum(by_layer[layer] for m in twice - inner for layer in m.modules()
                   if layer in by_layer))


# ---------------------------------------------------------------- the run


def source_fingerprint() -> str:
    """Content hash of the port's Python sources and its CUDA/C++ sources."""
    h = hashlib.sha256()
    files = sorted([*PACKAGE.rglob("*.py"), *(PACKAGE / "csrc").glob("*")])
    for p in files:
        rel = p.relative_to(PACKAGE)
        if p.is_file() and "_build" not in rel.parts:
            h.update(str(rel).encode() + b"\0" + p.read_bytes())
    return h.hexdigest()[:16]


def describe_device(dev: torch.device) -> Union[str, Dict]:
    """The card as ``torch`` and ``nvidia-smi`` name it, with its power
    limit; ``"cpu"`` for the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    line = out[dev.index] if dev.index < len(out) else out[0]
    return {"name": torch.cuda.get_device_name(dev), "count": torch.cuda.device_count(),
            "nvidia_smi": line, "power_limit_w": float(line.rsplit(",", 1)[1].split()[0])}


class Bench:
    """One run of the bench: its device and sizes, and what every line it
    prints shares."""

    def __init__(self, device: torch.device, scale: str = "full"):
        self.device = device
        self.on_card = device.type == "cuda"
        self.sizes = SCALES[scale]
        build_secs = None
        if self.on_card:
            from mrijax_torch.kernels import _build

            t0 = time.perf_counter()
            _build.build_all()
            build_secs = time.perf_counter() - t0
        self.common = {"device": describe_device(device), "torch": torch.__version__,
                       "cuda": torch.version.cuda, "source": source_fingerprint(),
                       "scale": scale, "build_secs": build_secs}

    def emit(self, row: dict) -> None:
        print(json.dumps({**row, **self.common}), flush=True)

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def generator(self, *stream: int) -> torch.Generator:
        return call_generator(SEED, *stream, device=self.device)

    def mfu(self, flops: Optional[float], secs: float) -> Optional[float]:
        if not self.on_card or flops is None:
            return None
        return flops / secs / PEAK_FLOPS

    def start(self) -> float:
        """Start of a mode (or a rung): garbage of the last one collected,
        the peak memory reset; returns the host clock."""
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        return time.perf_counter()

    def peak_gb(self) -> Optional[float]:
        return torch.cuda.max_memory_allocated(self.device) / 1e9 if self.on_card else None

    def timed(self, fn: Callable[[int], object], n: int) -> List[float]:
        """Seconds of ``fn(0)`` … ``fn(n - 1)``, each between two
        synchronisations."""
        secs = []
        for i in range(n):
            self.sync()
            t0 = time.perf_counter()
            fn(i)
            self.sync()
            secs.append(time.perf_counter() - t0)
        return secs

    def row(self, secs: Sequence[float], flops: Optional[float], **kw) -> dict:
        """The keys a line's timing gives: ``run_secs``, ``flops`` (a run),
        ``mfu`` and ``peak_gb``."""
        return {**kw, "run_secs": list(secs), "flops": flops,
                "mfu": self.mfu(flops, fmean(secs)), "peak_gb": self.peak_gb()}


def seeded_weights(model: nn.Module, seed: int) -> nn.Module:
    """Small-normal parameters from ``seed``; GroupNorm keeps scale 1 and
    bias 0. Values do not matter for timing."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dtype == torch.float32 and p.dim() == 1 and "norm" in name:
                continue
            p.copy_(0.02 * torch.randn(p.shape, generator=gen, dtype=torch.float32))
    return model


def _normal(shape, dtype) -> torch.Tensor:
    """``np.random.default_rng(0).normal(size=shape)``, as ``bench.py``
    makes its batches, in ``dtype``."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


# ----------------------------------------------------------- 3D sampling


def decode_in_chunks(vae: VAE3D, z: torch.Tensor, chunk: int) -> torch.Tensor:
    """``vae.decode_from_latent`` ``chunk`` latents at a time into one
    output, as ``bench.py:338-342`` decodes with ``lax.map``: the decode at
    full resolution sets the memory peak."""
    if z.shape[0] % chunk:
        raise ValueError(f"batch {z.shape[0]} is not divisible by the decode chunk {chunk}")
    out = None
    with torch.no_grad():
        for i in range(0, z.shape[0], chunk):
            v = vae.decode_from_latent(z[i:i + chunk])
            if out is None:
                out = v.new_empty((z.shape[0], *v.shape[1:]))
            out[i:i + chunk] = v
    return out


def sample_volumes(unet: UNet3D, vae: VAE3D, diffusion: GaussianDiffusion,
                   shape: Sequence[int], generator: Optional[torch.Generator] = None, *,
                   num_steps: int, decode_chunk: int, sampler: str = "ddim",
                   x_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bench.py:330-342`` (and ``:1317-1329`` with a sampler): denoise a
    latent of ``shape`` from ``x_t`` or from noise of ``generator``, then
    decode ``decode_chunk`` volumes at a time."""
    z = diffusion.fast_sample(unet, shape, generator, num_steps=num_steps, sampler=sampler,
                              x_t=x_t)
    return decode_in_chunks(vae, z, decode_chunk)


def build_unet3d(b: Bench, *, train: bool, remat: bool = False,
                 remat_levels: Optional[Sequence[int]] = None) -> UNet3D:
    """The flagship UNet3D in bf16: float32 master weights to train,
    bf16 weights to sample (as a sampling copy holds them)."""
    unet = UNet3D(**b.sizes.unet3d, use_attention=True, remat=remat, remat_levels=remat_levels,
                  dtype=BF16, param_dtype=torch.float32 if train else None)
    return seeded_weights(unet, SEED + 1).to(b.device)


def build_vae3d(b: Bench, *, train: bool = True, remat: bool = False) -> VAE3D:
    vae = VAE3D(**b.sizes.vae3d, dtype=BF16, remat=remat,
                param_dtype=torch.float32 if train else None)
    return seeded_weights(vae, SEED + 2).to(b.device)


def _latent_shape(b: Bench, batch: int) -> Tuple[int, ...]:
    return (batch, *b.sizes.latent, b.sizes.unet3d["in_channels"])


def _zeros(shape, dtype, b: Bench) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=b.device)


def _t(batch: int, b: Bench) -> torch.Tensor:
    return torch.ones(batch, dtype=torch.long, device=b.device)


def unet3d_flops(b: Bench, unet: UNet3D) -> int:
    """Operations of one UNet3D forward of one latent."""
    return forward_flops(unet, lambda: unet(_zeros(_latent_shape(b, 1), BF16, b), _t(1, b)))


def decode_flops(b: Bench, vae: VAE3D) -> int:
    """Operations of decoding one latent."""
    return forward_flops(vae, lambda: vae.decode_from_latent(
        _zeros((1, *b.sizes.latent, b.sizes.vae3d["latent_channels"]), BF16, b)))


def _sampling_pipeline(b: Bench):
    unet = build_unet3d(b, train=False).eval()
    vae = build_vae3d(b, train=False).eval()
    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(T_STEPS)))
    return unet, vae, diffusion


def _model_calls(diffusion: GaussianDiffusion, steps: int) -> int:
    return len(diffusion.ddim_timestep_sequence(steps))


def bench_headline(b: Bench) -> None:
    """``bench.py``'s headline: ``BATCH`` volumes, T = 400 DDIM over the
    latent, decode in chunks of ``DECODE_CHUNK``; 2 timed runs after a
    warm-up. Each run's denoise and decode are timed apart."""
    s = b.sizes
    t_setup = b.start()
    unet, vae, diffusion = _sampling_pipeline(b)
    steps = s.steps(T_STEPS)
    calls = _model_calls(diffusion, steps)
    shape = _latent_shape(b, s.batch_3d)
    flops = (calls * s.batch_3d * unet3d_flops(b, unet)
             + s.batch_3d * decode_flops(b, vae))
    split = []

    def run(generator):
        z = diffusion.ddim_sample(unet, shape, generator, num_steps=steps)
        b.sync()
        t0 = time.perf_counter()
        vols = decode_in_chunks(vae, z, s.decode_chunk)
        b.sync()
        split.append(time.perf_counter() - t0)
        return vols

    _check_volumes(run(b.generator()), (s.batch_3d, *s.volume))
    setup = time.perf_counter() - t_setup
    split.clear()
    secs = b.timed(lambda i: run(b.generator(i)), s.runs(2))
    dt = fmean(secs)
    decode = fmean(split)
    b.emit(b.row(
        secs, flops,
        metric="3d_ldm_volume_sampling_throughput",
        value=s.batch_3d / dt,
        unit=(f"volumes/sec (T={T_STEPS} DDIM + VAE decode, batch {s.batch_3d}, "
              f"{'x'.join(map(str, s.volume))} out)"),
        secs_per_volume=dt / s.batch_3d, setup_secs=setup,
        pipeline_tflops=flops / 1e12, batch=s.batch_3d, decode_chunk=s.decode_chunk,
        ddim_steps=calls, secs_per_ddim_step=(dt - decode) / calls, decode_secs=decode,
    ))


def _check_volumes(vols: torch.Tensor, shape) -> None:
    if tuple(vols.shape) != tuple(shape) or not bool(torch.isfinite(vols).all()):
        raise RuntimeError(f"sampled volumes {tuple(vols.shape)}, finite "
                           f"{bool(torch.isfinite(vols).all())}; expected {tuple(shape)}")


def bench_sweep(b: Bench) -> None:
    """``--sweep``: batch × decode chunk × steps × sampler of the sampling
    pipeline in one process, one line a config."""
    s = b.sizes
    unet, vae, diffusion = _sampling_pipeline(b)
    per_latent, per_decode = unet3d_flops(b, unet), decode_flops(b, vae)
    for batch, chunk, steps, sampler in s.sweep_3d:
        t_setup = b.start()
        steps = s.steps(steps)
        shape = _latent_shape(b, batch)

        def run(generator):
            return sample_volumes(unet, vae, diffusion, shape, generator,
                                  num_steps=steps, decode_chunk=chunk, sampler=sampler)

        _check_volumes(run(b.generator()), (batch, *s.volume))
        setup = time.perf_counter() - t_setup
        secs = b.timed(lambda i: run(b.generator(i)), s.runs(2))
        dt = fmean(secs)
        calls = _model_calls(diffusion, steps)
        flops = batch * (calls * per_latent + per_decode)
        b.emit(b.row(
            secs, flops, metric="3d_ldm_sampling_sweep", batch=batch, decode_chunk=chunk,
            ddim_steps=calls, sampler=sampler, value=batch / dt, unit="volumes/sec",
            secs_per_volume=dt / batch, setup_secs=setup,
        ))


# ------------------------------------------------------------ 3D training


def _train_flops(model: nn.Module, call: Callable[[], torch.Tensor], batch: int) -> int:
    """A train step of ``batch``: 3 forwards and the recomputed blocks, from
    one forward and backward of ``call()`` at batch 1."""
    return batch * (3 * forward_flops(model, call) + recomputed_flops(model, call))


def _min_snr_diffusion() -> GaussianDiffusion:
    return GaussianDiffusion(make_schedule(cosine_beta_schedule(T_STEPS)), loss_type="min_snr")


def _train_steps(b: Bench, step: Callable[[int, Optional[torch.Generator]], object],
                 runs: int, t_setup: float):
    """A warm-up step (stream ``(SEED,)``), then ``runs`` timed steps, each
    with its own stream: (seconds of each, setup seconds)."""
    step(0, b.generator())
    b.sync()
    setup = time.perf_counter() - t_setup
    return b.timed(lambda i: step(i, b.generator(i)), runs), setup


def bench_train_step(b: Bench) -> None:
    """``--train``: frozen-VAE encode of one full-resolution volume, min-SNR
    loss, backward, Adam 1e-4."""
    from mrijax_torch.train.steps import make_latent_diffusion_train_step

    s = b.sizes
    t_setup = b.start()
    unet = build_unet3d(b, train=True)
    vae = build_vae3d(b, train=True).eval()
    state = create_train_state(unet, 1e-4, device=b.device)
    train_step = make_latent_diffusion_train_step(unet, vae, _min_snr_diffusion())
    batch = {"volume": _normal((1, *s.volume), BF16).to(b.device)}
    flops = forward_flops(vae, lambda: vae.encode_to_latent(batch["volume"])) + _train_flops(
        unet, lambda: unet(_zeros(_latent_shape(b, 1), torch.float32, b), _t(1, b)), 1)
    secs, setup = _train_steps(
        b, lambda i, g: train_step(state, batch, g, 1.0), s.runs(4), t_setup)
    dt = fmean(secs)
    b.emit(b.row(
        secs, flops, metric="3d_ldm_train_step_time", value=dt,
        unit=(f"sec/step (bs=1 volume {'x'.join(map(str, s.volume))}, "
              "frozen-VAE encode + min-SNR + Adam)"),
        steps_per_s=1.0 / dt, step_tflops=flops / 1e12, batch=1, setup_secs=setup,
    ))


def bench_train_step_cached(b: Bench, batch: Optional[int] = None, remat: bool = False,
                            remat_levels: Optional[Sequence[int]] = (0,)) -> None:
    """``--train-cached``: the stage-2 step on cached latents at batch 32
    with selective rematerialisation of the level-0 blocks."""
    from mrijax_torch.train.steps import make_cached_latent_train_step

    s = b.sizes
    batch = s.cached_batch if batch is None else batch
    t_setup = b.start()
    unet = build_unet3d(b, train=True, remat=remat, remat_levels=remat_levels)
    state = create_train_state(unet, 1e-4, device=b.device)
    train_step = make_cached_latent_train_step(unet, _min_snr_diffusion())
    latents = {"latent": _normal(_latent_shape(b, batch), torch.float32).to(b.device)}
    flops = _train_flops(
        unet, lambda: unet(_zeros(_latent_shape(b, 1), torch.float32, b), _t(1, b)), batch)
    secs, setup = _train_steps(
        b, lambda i, g: train_step(state, latents, g, 1.0), s.runs(4), t_setup)
    dt = fmean(secs)
    tag = (f", remat levels {tuple(remat_levels)}" if remat_levels is not None
           else (", remat" if remat else ""))
    b.emit(b.row(
        secs, flops, metric="3d_ldm_cached_train_throughput", value=batch / dt,
        unit=(f"volumes/sec trained (batch {batch} cached latents "
              f"{'x'.join(map(str, _latent_shape(b, batch)[1:]))}, min-SNR + Adam{tag})"),
        sec_per_step=dt, step_tflops=flops / 1e12, batch=batch, remat=remat,
        remat_levels=None if remat_levels is None else list(remat_levels), setup_secs=setup,
    ))


def bench_train_cached_sweep(b: Bench) -> None:
    """``--train-cached-sweep``: batch × remat in one process; the rungs
    that may run out of memory come last and print a failed line instead."""
    for batch, remat, levels, may_oom in b.sizes.cached_sweep:
        error = None
        try:
            bench_train_step_cached(b, batch, remat, levels)
        except torch.cuda.OutOfMemoryError as e:
            if not may_oom:
                raise
            error = str(e)[:200]
        if error is not None:
            b.start()   # the failed rung's tensors are garbage now
            b.emit({"metric": "3d_ldm_cached_train_throughput", "batch": batch,
                    "remat": remat, "remat_levels": list(levels) if levels else None,
                    "value": None, "error": error, "mfu": None})


def bench_train_vae(b: Bench, batch: int = 1, remat: bool = True, grad_accum: int = 1) -> None:
    """``--train-vae``: the stage-1 step, L1 + 1e-4·KL on full-resolution
    volumes, Adam 1e-4; ``grad_accum`` microbatches a step."""
    from mrijax_torch.train.steps import make_vae_train_step

    s = b.sizes
    t_setup = b.start()
    vae = build_vae3d(b, train=True, remat=remat)
    state = create_train_state(vae, 1e-4, device=b.device)
    train_step = make_vae_train_step(vae, grad_accum=grad_accum)
    volumes = {"volume": _normal((batch, *s.volume), BF16).to(b.device)}
    one = _zeros((1, *s.volume), BF16, b)
    flops = _train_flops(vae, lambda: vae.decode(vae.encode(one)[0]), batch)
    secs, setup = _train_steps(
        b, lambda i, g: train_step(state, volumes, g), s.runs(4), t_setup)
    dt = fmean(secs)
    b.emit(b.row(
        secs, flops, metric="vae3d_train_throughput", value=batch / dt,
        unit=(f"volumes/sec trained (batch {batch} full-res {'x'.join(map(str, s.volume))}, "
              f"L1+KL + Adam{', remat' if remat else ''}"
              + (f", grad_accum {grad_accum}" if grad_accum > 1 else "") + ")"),
        sec_per_step=dt, step_tflops=flops / 1e12, batch=batch, remat=remat,
        grad_accum=grad_accum, setup_secs=setup,
    ))


def bench_train_vae_sweep(b: Bench) -> None:
    """``--train-vae-sweep``: batch × remat × accumulation in one process."""
    for batch, remat, accum in b.sizes.vae_sweep:
        bench_train_vae(b, batch, remat, accum)


# ---------------------------------------------------------------- 2D / 2.5D


def build_unet2d(b: Bench, *, train: bool, context: bool = False) -> UNet2D:
    """The 2D (1 channel) or 2.5D (4 channels + 16 of context) UNet at
    ``bench.py``'s widths, bf16."""
    x_ch, ctx_ch = (4, 16) if context else (1, 0)
    model = UNet2D(in_channels=x_ch + ctx_ch, out_channels=x_ch, **b.sizes.unet2d,
                   dtype=BF16, param_dtype=torch.float32 if train else None)
    return seeded_weights(model, SEED + 3).to(b.device)


def unet2d_flops(b: Bench, model: UNet2D, context: bool = False) -> int:
    """Operations of one UNet2D forward of one image."""
    size, x_ch = b.sizes.image_size, model.out_conv.out_channels
    ctx = _zeros((1, size, size, 16), BF16, b) if context else None
    return forward_flops(model, lambda: model(
        _zeros((1, size, size, x_ch), BF16, b), _t(1, b), _zeros((1,), torch.float32, b), ctx))


def _batch_2d(b: Bench, bs: int, context: bool = False) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(0)
    size, x_ch = b.sizes.image_size, 4 if context else 1
    batch = {"image": rng.normal(size=(bs, size, size, x_ch)).astype(np.float32),
             "z_pos": rng.uniform(size=(bs,)).astype(np.float32)}
    if context:
        batch["context"] = rng.normal(size=(bs, size, size, 16)).astype(np.float32)
    return {k: torch.from_numpy(v).to(b.device) for k, v in batch.items()}


def _linear_diffusion() -> GaussianDiffusion:
    return GaussianDiffusion(make_schedule(linear_beta_schedule(T_2D)))


def _train_2d(b: Bench, context: bool = False):
    from mrijax_torch.train.steps import make_diffusion_train_step

    model = build_unet2d(b, train=True, context=context)
    state = create_train_state(model, 2e-4, device=b.device)
    diffusion = _linear_diffusion()
    return model, state, diffusion, make_diffusion_train_step(model, diffusion)


def bench_train_2d(b: Bench, context: bool = False) -> None:
    """``--train-2d`` / ``--train-25d``: the DDPM step at batch 64, 128²,
    T = 1000 linear, MSE, Adam 2e-4."""
    s = b.sizes
    bs, size, x_ch = s.batch_2d, s.image_size, 4 if context else 1
    t_setup = b.start()
    model, state, _, train_step = _train_2d(b, context)
    batch = _batch_2d(b, bs, context)
    flops = 3 * bs * unet2d_flops(b, model, context)
    secs, setup = _train_steps(b, lambda i, g: train_step(state, batch, g), s.runs(6), t_setup)
    dt = fmean(secs)
    fam = "ddpm_25d" if context else "slice_cond_2d"
    b.emit(b.row(
        secs, flops, metric=f"{fam}_train_step_time", value=dt,
        unit=(f"sec/step (bs={bs} {size}x{size}x{x_ch}"
              f"{' + 16ch context' if context else ''}, T={T_2D} linear, MSE + Adam)"),
        images_per_s=bs / dt, step_tflops=flops / 1e12, batch=bs, setup_secs=setup,
    ))


def bench_train_2d_profile(b: Bench) -> None:
    """``--train-2d-profile``: the 2D train step's time taken apart —
    ``per_step_readback`` (a synchronisation every step), ``chained`` (20
    steps, one synchronisation), ``fwd_only`` and ``fwd_bwd`` (the loss
    alone, and with its backward, no optimizer; chained), ``chained_b128``
    (double batch)."""
    s = b.sizes
    bs, size = s.batch_2d, s.image_size
    t_setup = b.start()
    model, state, diffusion, train_step = _train_2d(b)
    batch = _batch_2d(b, bs)
    per_image = unet2d_flops(b, model)
    chain = s.steps(20)

    def emit(name, secs, per_run, flops, rows):
        dt = fmean(secs) / per_run
        b.emit(b.row(
            [x / per_run for x in secs], flops, metric="slice_cond_2d_train_profile",
            measurement=name, value=dt, unit=f"sec/step (bs={rows}, {size}x{size}x1)",
            images_per_s=rows / dt, step_tflops=flops / 1e12, batch=rows,
            steps_per_run=per_run, setup_secs=setup,
        ))

    def chained(fn, n):
        """``fn(i)`` once to warm up, then ``n`` times and one synchronisation."""
        fn(0)
        return b.timed(lambda _: [fn(i) for i in range(n)], 1)

    secs, setup = _train_steps(b, lambda i, g: train_step(state, batch, g), s.runs(6), t_setup)
    emit("per_step_readback", secs, 1, 3 * bs * per_image, bs)
    emit("chained", chained(lambda i: train_step(state, batch, b.generator(i)), chain),
         chain, 3 * bs * per_image, bs)

    def loss(i):
        g = b.generator(i)
        t = sample_timesteps(g, bs, diffusion.timesteps, 0)
        noise = torch.randn(batch["image"].shape, generator=g, device=b.device)
        return diffusion.to(b.device).p_losses(
            lambda x, tt: model(x, tt, batch["z_pos"]), batch["image"], t, noise)

    with torch.no_grad():
        emit("fwd_only", chained(loss, chain), chain, bs * per_image, bs)

    def fwd_bwd(i):
        model.zero_grad(set_to_none=True)
        loss(i).backward()

    emit("fwd_bwd", chained(fwd_bwd, chain), chain, 3 * bs * per_image, bs)
    big = _batch_2d(b, 2 * bs)
    emit("chained_b128", chained(lambda i: train_step(state, big, b.generator(i)), chain),
         chain, 3 * 2 * bs * per_image, 2 * bs)


def _ancestral(b: Bench, diffusion: GaussianDiffusion, model_fn, shape, g) -> torch.Tensor:
    """The T = 1000 ancestral protocol (``p_sample_loop_auto``), or its last
    ``step_cap`` steps where counts are cut."""
    n = b.sizes.steps(T_2D)
    if n == T_2D:
        return diffusion.p_sample_loop_auto(model_fn, shape, g)
    return diffusion.p_sample_loop(model_fn, shape, g, start_t=n - 1)


def _sampler_2d(b: Bench, model: UNet2D, diffusion: GaussianDiffusion, bs: int,
                steps: Optional[int], sampler: str):
    """``fn(z_pos, generator)`` → (bs, size, size, 1) images, and the model
    calls a call makes: the ancestral protocol without ``steps``, else
    ``fast_sample``."""
    shape = (bs, b.sizes.image_size, b.sizes.image_size, 1)
    if steps is None:
        def fn(z_pos, g):
            return _ancestral(b, diffusion, lambda x, t: model(x, t, z_pos), shape, g)

        return fn, b.sizes.steps(T_2D)
    steps = b.sizes.steps(steps)

    def fn(z_pos, g):
        return diffusion.fast_sample(lambda x, t: model(x, t, z_pos), shape, g,
                                     num_steps=steps, sampler=sampler)

    return fn, _model_calls(diffusion, steps)


def _sampling_model_2d(b: Bench):
    return build_unet2d(b, train=False).eval(), _linear_diffusion()


def bench_sample_2d(b: Bench, steps: Optional[int] = None, sampler: str = "ddim") -> None:
    """``--sample-2d``: 64 slices at 128²; by default the T = 1000
    ancestral protocol, with ``steps`` the strided fast path."""
    s = b.sizes
    bs, size = s.batch_2d, s.image_size
    t_setup = b.start()
    model, diffusion = _sampling_model_2d(b)
    z_pos = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(bs,)).astype(np.float32)).to(b.device)
    fn, calls = _sampler_2d(b, model, diffusion, bs, steps, sampler)
    flops = calls * bs * unet2d_flops(b, model)
    fn(z_pos, b.generator())
    b.sync()
    setup = time.perf_counter() - t_setup
    secs = b.timed(lambda i: fn(z_pos, b.generator(i)), s.runs(2))
    dt = fmean(secs)
    mode = (f"{sampler}-{calls}" if steps is not None
            else f"ancestral {calls} of T={T_2D} (reference protocol)")
    b.emit(b.row(
        secs, flops, metric="slice_cond_2d_sampling_throughput", value=bs / dt,
        unit=f"slices/sec (batch {bs} @ {size}², {mode})", secs_per_batch=dt,
        pipeline_tflops=flops / 1e12, batch=bs, model_calls=calls, setup_secs=setup,
    ))


def bench_sample_2d_ladder(b: Bench) -> None:
    """``--sample-2d-sweep``: batch 64/128/256 × {T = 1000 ancestral,
    DDIM-50, DPM-Solver++(2M)-20} in one process; the ancestral rungs timed
    once, the fast ones twice."""
    s = b.sizes
    model, diffusion = _sampling_model_2d(b)
    per_image = unet2d_flops(b, model)
    rng = np.random.default_rng(0)
    for bs in (s.batch_2d, 2 * s.batch_2d, 4 * s.batch_2d):
        for sampler, steps in (("ancestral", None), ("ddim", 50), ("dpm", 20)):
            t_setup = b.start()
            z_pos = torch.from_numpy(rng.uniform(size=(bs,)).astype(np.float32)).to(b.device)
            fn, calls = _sampler_2d(b, model, diffusion, bs, steps, sampler)
            fn(z_pos, b.generator())
            b.sync()
            setup = time.perf_counter() - t_setup
            n = s.runs(1 if steps is None else 2)
            secs = b.timed(lambda i: fn(z_pos, b.generator(i)), n)
            dt = fmean(secs)
            b.emit(b.row(
                secs, calls * bs * per_image, metric="slice_cond_2d_sampling_ladder",
                batch=bs, sampler=(f"{sampler}-{calls}" if steps is not None
                                   else f"ancestral-T{T_2D}"),
                value=bs / dt, unit=f"slices/sec ({s.image_size}²)", secs_per_batch=dt,
                timed_runs=n, model_calls=calls, setup_secs=setup,
            ))


# ---------------------------------------------------------- input pipeline


def bench_input_pipeline(b: Bench) -> None:
    """``--input-pipeline``: the 2D train step at batch 64 fed from
    device-resident batches, from ``BatchLoader`` over packed shards and over
    the NIfTI files themselves (``live_loader``), and each loader's host-only
    rate (batches made, no step). Data: synthetic BraTS volumes at
    128×128×80."""
    from mrijax_torch.data import BatchLoader, PackedSliceDataset, SliceDataset2D
    from mrijax_torch.data.packing import pack_dataset
    from mrijax_torch.data.synthetic import write_synthetic_brats

    s = b.sizes
    bs, size = s.batch_2d, s.image_size
    t_setup = b.start()
    with tempfile.TemporaryDirectory(prefix="mrijax_torch_inpipe_") as tmp:
        root = write_synthetic_brats(Path(tmp) / "brats", num_subjects=s.pipeline_subjects,
                                     shape=s.pipeline_shape, seed=0)
        pack_dataset(root, Path(tmp) / "packed", image_size=size, use_device=False)
        model, state, _, train_step = _train_2d(b)
        per_step = 3 * bs * unet2d_flops(b, model)
        resident = _batch_2d(b, bs)
        train_step(state, resident, b.generator())   # warm-up (cuDNN picks its algorithms)
        b.sync()
        setup = time.perf_counter() - t_setup
        n_steps = s.steps(24)

        def timed_steps(batches):
            """``n_steps`` steps over ``batches``, one synchronisation at the end."""
            def run(_):
                for i, batch in enumerate(itertools.islice(batches, n_steps)):
                    train_step(state, batch, b.generator(i))
            return b.timed(run, 1)

        def emit(tag, secs):
            dt = secs[0]
            b.emit(b.row(
                secs, n_steps * per_step, metric="input_pipeline_2d", variant=tag,
                value=n_steps * bs / dt, unit=f"images/sec (bs={bs} @ {size}², steps={n_steps})",
                secs_per_step=dt / n_steps, batch=bs, setup_secs=setup,
            ))

        emit("device_resident", timed_steps(itertools.repeat(resident)))
        for tag, ds in (("packed_loader", PackedSliceDataset(Path(tmp) / "packed")),
                        ("live_loader", SliceDataset2D(root, size))):
            host = BatchLoader(ds, bs, shuffle=True, drop_last=True, seed=0, prefetch=2,
                               device_put=False)
            if len(host) == 0:
                raise ValueError(f"{tag}: {len(ds)} slices make no batch of {bs}")
            t0 = time.perf_counter()
            made = sum(1 for _ in itertools.islice(_forever(host), n_steps))
            host_dt = time.perf_counter() - t0
            b.emit({"metric": "input_pipeline_2d", "variant": f"{tag}_host_only",
                    "value": made * bs / host_dt,
                    "unit": f"images/sec produced (bs={bs}, no device work)",
                    "batch": bs, "run_secs": [host_dt], "flops": None, "mfu": None,
                    "peak_gb": b.peak_gb(), "setup_secs": setup})
            loader = BatchLoader(ds, bs, shuffle=True, drop_last=True, seed=0, prefetch=2,
                                 device=b.device)
            emit(tag, timed_steps(_forever(loader)))


def _forever(loader):
    while True:
        yield from loader


# -------------------------------------------------------------------- evals


class _CountingExtractor:
    """A feature extractor that adds its operations to ``meter`` a call."""

    def __init__(self, fe, per_image: int, meter: List[int]):
        self.fe, self.per_image, self.meter = fe, per_image, meter
        self.dim, self.metric_suffix = fe.dim, fe.metric_suffix

    def __call__(self, images):
        self.meter[0] += self.per_image * images.shape[0]
        return self.fe(images)


def bench_eval_2d(b: Bench) -> None:
    """``--eval-2d``: ``evaluate_conditional_2d`` with a random-init
    Inception-v3 trunk over synthetic real batches at 128²: fast mode (256
    samples, DPM-Solver++(2M)-20, 32 diversity pairs) and protocol mode (64
    samples, the T = 1000 ancestral loop). The sampler's model and the trunk
    run once first, for cuDNN's choice of algorithms."""
    from mrijax_torch.evals import InceptionFeatureExtractor
    from mrijax_torch.evals.harness import evaluate_conditional_2d

    s = b.sizes
    bs, size = s.batch_2d, s.image_size
    t_setup = b.start()
    model, diffusion = _sampling_model_2d(b)
    per_image = unet2d_flops(b, model)
    fe = InceptionFeatureExtractor(image_size=s.inception_size, device=b.device)
    per_feature = forward_flops(fe.net, lambda: fe(_zeros((1, size, size, 1), torch.float32, b)))
    with torch.no_grad():
        model(_zeros((bs, size, size, 1), BF16, b), _t(bs, b), _zeros((bs,), torch.float32, b))
        fe(_zeros((bs, size, size, 1), torch.float32, b))
    b.sync()
    setup = time.perf_counter() - t_setup
    rng = np.random.default_rng(7)

    def real_batches(n_batches):
        for _ in range(n_batches):
            yield {"image": np.clip(rng.normal(size=(bs, size, size, 1)), -1, 1).astype(np.float32),
                   "z_pos": rng.uniform(size=(bs,)).astype(np.float32)}

    meter = [0]

    def make_sample_fn(steps):
        def sample_fn(batch, g):
            z = batch["z_pos"]
            shape = (z.shape[0], size, size, 1)

            def model_fn(x, t):
                meter[0] += per_image * x.shape[0]
                return model(x, t, z)

            if steps is None:
                return _ancestral(b, diffusion, model_fn, shape, g)
            return diffusion.fast_sample(model_fn, shape, g, num_steps=s.steps(steps),
                                         sampler="dpm")

        return sample_fn

    fast, pairs = s.eval_fast
    for tag, steps, n_samples, div_pairs in (
        ("dpm-20 (fast mode)", 20, fast, pairs),
        (f"ancestral-T{T_2D} (reference protocol)", None, s.eval_protocol, 0),
    ):
        meter[0] = 0
        reports = []
        secs = b.timed(lambda _: reports.append(evaluate_conditional_2d(
            make_sample_fn(steps), real_batches(-(-n_samples // bs)),
            feature_extractor=_CountingExtractor(fe, per_feature, meter),
            num_samples=n_samples, num_diversity_pairs=div_pairs, seed=SEED,
            metadata={"sampler": tag}, device=b.device)), 1)
        report = reports[0]
        dt = secs[0]
        b.emit(b.row(
            secs, meter[0], metric="eval_2d_throughput", sampler=tag, value=n_samples / dt,
            unit=(f"eval samples/sec (batch {bs} @ {size}², sampling + 2x inception features "
                  "+ streaming FID/KID)"),
            num_samples=n_samples, eval_seconds=dt, fid_rand=float(report["fid_rand"]),
            kid_rand_mean=float(report["kid_rand_mean"]), batch=bs, setup_secs=setup,
        ))


# --------------------------------------------------------------------- main


MODES = {
    "--sweep": bench_sweep,
    "--train": bench_train_step,
    "--train-cached-sweep": bench_train_cached_sweep,
    "--train-vae-sweep": bench_train_vae_sweep,
    "--train-vae": bench_train_vae,
    "--train-cached": bench_train_step_cached,
    "--sample-2d-sweep": bench_sample_2d_ladder,
    "--input-pipeline": bench_input_pipeline,
    "--eval-2d": bench_eval_2d,
    "--sample-2d": bench_sample_2d,
    "--train-2d-profile": bench_train_2d_profile,
    "--train-2d": bench_train_2d,
    "--train-25d": lambda b: bench_train_2d(b, context=True),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Benchmarks of mrijax_torch (the counterpart of bench.py); one JSON "
                    "line per measurement. Without a mode flag: the headline, 3D volume "
                    "sampling.")
    modes = ap.add_mutually_exclusive_group()
    for flag in MODES:
        modes.add_argument(flag, action="store_true")
    ap.add_argument("--steps", type=int, default=None,
                    help="--sample-2d: the strided fast path with N steps")
    ap.add_argument("--sampler", default=None,
                    help="--sample-2d --steps N: ddim (default) or dpm")
    scale = ap.add_mutually_exclusive_group()
    scale.add_argument("--smoke", action="store_true",
                       help="full widths, at most 5 steps and 1 timed run")
    scale.add_argument("--tiny", action="store_true",
                       help="small widths, at most 2 steps and 1 timed run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu (the tests)")
    args = ap.parse_args(argv)
    if (args.steps is not None or args.sampler is not None) and not args.sample_2d:
        ap.error("--steps and --sampler apply to --sample-2d only")
    if args.sampler is not None and args.steps is None:
        ap.error("--sampler only applies to the strided fast path; add --steps N (the "
                 "default mode is the T=1000 ancestral reference protocol)")

    dev = require_device(args.device)
    b = Bench(dev, "tiny" if args.tiny else "smoke" if args.smoke else "full")
    chosen = [flag for flag in MODES if getattr(args, flag[2:].replace("-", "_"))]
    if not chosen:
        bench_headline(b)
    elif chosen[0] == "--sample-2d":
        bench_sample_2d(b, args.steps, args.sampler or "ddim")
    else:
        MODES[chosen[0]](b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
