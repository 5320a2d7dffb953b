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
   after.

Any miss raises: the script exits non-zero and prints no result line. It
exits non-zero at once where ``torch.cuda.is_available()`` is false. TF32 is
switched off for convolutions and matrix products, so float32 comparisons are
float32. The last line is ``{"ok": true, "device": {...}}``; the line before
names the card; the line before that is the ``{"kernels": [...]}`` record.
"""

import argparse
import dataclasses
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
from mrijax_torch.ops.attention import multi_head_self_attention
from mrijax_torch.ops.norms import group_norm_silu
from mrijax_torch.train import create_train_state, make_cached_latent_train_step

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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median device time of one ``fn()`` in ms. Each sample puts a spin
    kernel on the stream first, so the host has issued all of ``fn``'s
    launches before the card reaches the start event: the time between the
    two events is the card's alone, without the host's launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
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
    input type and held to 2e-5, and two calls must give bitwise the same
    statistics (the kernel sums in a fixed order; only its ticket is an
    atomic). Every main-path shape is compared at the batch the generation
    path gives it and, for the UNet's call sites, at the training batch as
    well. Last, ``gn_far_from_zero``: x = 200 + 1.5·N(0, 1) at (2, 100, 64),
    where E[x²] − mean² cancels to 1/17 800 of E[x²]; kernel and plain
    version each hold the variance (rstd⁻² − eps) within 16·2⁻²⁴·E[x²] of
    the float64 variance (a few float32 ulps of E[x²]).
    """

    worst = {"gn_silu_stats": {"float32": 0.0, "bfloat16": 0.0},
             "gn_silu_apply": {"float32": 0.0, "bfloat16": 0.0}}
    cases = [(2, n, c) for (n, c) in GN_MAIN_PATH if (n, c) != GN_BIG]
    cases += [(1, *GN_BIG)] + [(2, n, c) for n, c in GN_RAGGED]
    cases += [(TRAIN_BATCH, n, c) for (n, c), (per_unet, _) in GN_MAIN_PATH.items() if per_unet]
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


def time_groupnorm(rng):
    """Per main-path shape (bf16, B = 2): both kernels, their plain versions,
    the library yardsticks and the bytes bound; then each summed over the
    calls of one generate call (``groupnorm_per_generate_call``)."""

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
        rows.append(row)
        del x, stats, x_cf, xg
    # one generate call: 20 UNet forwards and one decode, each at batch 2
    per_call = {k: sum(r[k] * (DDIM_STEPS * r["calls_per_unet_forward"] + r["calls_per_decode"])
                       for r in rows)
                for k in ("stats_ms", "stats_bound_ms", "apply_ms", "apply_bound_ms",
                          "apply_copy_ms")}
    per_call["stats_above_bound_ms"] = per_call["stats_ms"] - per_call["stats_bound_ms"]
    per_call["apply_above_bound_ms"] = per_call["apply_ms"] - per_call["apply_bound_ms"]
    print("groupnorm_times " + json.dumps(rows))
    print("groupnorm_per_generate_call " + json.dumps(per_call))
    return rows


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


def profile_window(prof, wall_ms, top=14):
    """Device time by kernel name of one profiled window."""
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and evt.device_type.name != "CPU":
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    return {
        "wall_ms_under_profiler": wall_ms, "device_busy_ms": sum(r[0] for r in rows),
        "top": [{"ms": r[0], "count": r[1], "kernel": r[2][:90]} for r in rows[:top]],
    }


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


def train_latents():
    rng = np.random.default_rng(SEED + 6)
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
    return counts_by_setting


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
                   generate_counts, train_counts):
    """One record per kernel, at its heaviest main-path shape in bf16 (the
    flash kernels at the training batch).
    ``launches`` adds up the counted runs of both main paths;
    ``launches_by_path`` keeps them apart."""
    big = max(gn_rows, key=lambda r: r["shape"][0] * r["shape"][1] * r["shape"][2])
    fl = next(r for r in flash_rows
              if r["dtype"] == "bfloat16" and tuple(r["shape"]) == FLASH_TRAIN)
    bw = bwd_rows[0]
    src_gn = "mrijax_torch/csrc/groupnorm_silu.cu"
    src_bwd = "mrijax_torch/csrc/flash_attention_bwd.cu"

    def launches(name):
        by_path = {"generate": generate_counts[name],
                   "train_no_remat": train_counts["no_remat"][name],
                   "train_remat_level0": train_counts["remat_level0"][name]}
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
                             "calls (one launch each), 5 DDIM steps and one decode, then "
                             "3 training steps")
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
    gn_rows = time_groupnorm(rng)
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
    train_counts = train_path()
    if args.profile:
        profile_train_path()

    print(json.dumps({"kernels": kernel_records(
        gn_worst, flash_worst, bwd_worst, gn_rows, flash_rows, bwd_rows,
        result["launches"], train_counts)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
