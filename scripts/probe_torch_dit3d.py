#!/usr/bin/env python3
"""The DiT-XL/2 denoiser of ``mrijax_torch`` (``models/dit3d.py``) at its
published widths on one NVIDIA GPU, over the flagship's 32 × 40 × 40 × 16
latent (6400 tokens), with random weights from a fixed seed.

    python3 scripts/probe_torch_dit3d.py [--gen] [--train] [--out FILE]

``--gen`` (bf16 weights, as the generation cell holds them): one forward at
batch 4 against the plain float32 reference (``models/dit3d_reference.py``,
TF32 off), the worst sample's relative error; the median of 10 forwards
between CUDA events; the flash forward alone at the padded shape; a
profiled forward's ten largest kernels and its three spans, and a profiled
forward's time with the spans recording and with them replaced by the
no-op.

``--train``: ``make_cached_latent_train_step`` at full width, float32
master weights, bf16 compute, every block recomputed in the backward
(``remat``), Adam at 1e-4: 3 steps at batch 8 with their times, the
``train.*`` and ``dit.*`` spans of the last two (profiled) and the peak
memory; then one step's loss and gradients at batch 2 against autograd
through the reference on the same inputs (each block recomputed in its
backward too): the loss gap and the worst and median leaf's
‖g − g_ref‖ / ‖g_ref‖.

With neither flag both run. The card's name and power limit come first;
one JSON line a part, also appended to ``--out``.
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mrijax_torch.diffusion import (  # noqa: E402
    GaussianDiffusion, linear_beta_schedule, make_schedule)
from mrijax_torch.kernels import flash_attention as fa  # noqa: E402
from mrijax_torch.models import DiT3D, dit3d  # noqa: E402
from mrijax_torch.models import dit3d_reference as ref  # noqa: E402
from mrijax_torch.obs.profiling import spans  # noqa: E402
from mrijax_torch.train.state import create_train_state  # noqa: E402
from mrijax_torch.train.steps import make_cached_latent_train_step  # noqa: E402

LATENT = (32, 40, 40, 16)
DEV = torch.device("cuda")


def seeded(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Weights N(0, 1/fan_in), biases N(0, 0.02²), in place."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            std = p.shape[-1] ** -0.5 if p.dim() > 1 else 0.02
            p.copy_(torch.randn(p.shape, generator=g, device=DEV) * std)
    return model


def timed_ms(fn, n: int = 10) -> float:
    fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_rows(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double().flatten(1), want.double().flatten(1)
    return float(((g - w).norm(dim=1) / w.norm(dim=1)).max())


def span_ms(prefix: str):
    got = spans(prefix)
    return {name: round(sum(s.stream_ms for s in got if s.name == name), 4)
            for name in sorted({s.name for s in got})}


def top_kernels(prof, n: int = 10):
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0]
    return [[k[:90], round(ms, 4)] for k, ms in sorted(rows, key=lambda r: -r[1])[:n]]


def gen_part() -> dict:
    with DEV:
        net = seeded(DiT3D(dtype=torch.bfloat16)).eval()
    p = {k: v.detach().float() for k, v in net.named_parameters()}
    g = torch.Generator(device=DEV).manual_seed(1)
    x = torch.randn((4, *LATENT), generator=g, device=DEV)
    t = torch.tensor([999, 600, 250, 3], device=DEV)
    out = {"part": "gen"}
    with torch.no_grad():
        eps = net(x, t)
        want = ref.dit3d_forward(p, x, t, patch=2, heads=16)
        out["rel_err_vs_reference"] = rel_rows(eps, want)
        del want, p
        out["forward_ms_b4"] = timed_ms(lambda: net(x, t))
        q = torch.randn((4, 6400, 16, 72), device=DEV, dtype=torch.bfloat16)
        out["flash_fwd_ms_b4_dh72"] = timed_ms(lambda: fa.flash_attention_forward(q, q, q))
        qp = torch.randn((4, 6400, 16, 128), device=DEV, dtype=torch.bfloat16)
        out["flash_fwd_ms_b4_dh128"] = timed_ms(lambda: fa.flash_attention_forward(qp, qp, qp))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            net(x, t)
            torch.cuda.synchronize()
        out["spans_ms"] = span_ms("dit.")
        out["top_kernels_ms"] = top_kernels(prof)
        # a profiled forward between events with the spans recording, and
        # with the module's spans replaced by the no-op
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            out["profiled_forward_ms_spans_on"] = timed_ms(lambda: net(x, t), 5)
        recording, dit3d.span = dit3d.span, lambda *a, **k: contextlib.nullcontext()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                out["profiled_forward_ms_spans_off"] = timed_ms(lambda: net(x, t), 5)
        finally:
            dit3d.span = recording
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def train_part() -> dict:
    torch.cuda.reset_peak_memory_stats()
    with DEV:
        net = seeded(DiT3D(remat=True, dtype=torch.bfloat16, param_dtype=torch.float32))
    p0 = {k: v.detach().clone() for k, v in net.named_parameters()}
    diffusion = GaussianDiffusion(make_schedule(linear_beta_schedule(1000)), loss_type="mse")
    state = create_train_state(net, 1e-4, device=DEV)
    step = make_cached_latent_train_step(net, diffusion, t_min=0)
    g = torch.Generator(device=DEV).manual_seed(2)
    out = {"part": "train"}

    def batch(n):
        return (torch.randn((n, *LATENT), generator=g, device=DEV),
                torch.randint(0, 1000, (n,), generator=g, device=DEV),
                torch.randn((n, *LATENT), generator=g, device=DEV))

    times, losses = [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i in range(3):
        z, t, noise = batch(8)
        if i == 1:
            prof.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = step(state, {"latent": z}, None, 1.0, t=t, noise=noise)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    prof.stop()
    out.update(step_ms_b8=times, losses=losses, spans_ms_2_steps=span_ms("train."),
               dit_spans_ms_2_steps=span_ms("dit."), top_kernels_ms=top_kernels(prof, 12),
               peak_gb_b8=torch.cuda.max_memory_allocated() / 1e9)
    del prof

    # one step at batch 2 from the initial weights against the reference
    with torch.no_grad():
        for k, v in net.named_parameters():
            v.copy_(p0[k])
    state = create_train_state(net, 1e-4, device=DEV)
    z, t, noise = batch(2)
    _, loss = step(state, {"latent": z}, None, 1.0, t=t, noise=noise)
    grads_p = {k: v.grad.detach().double() for k, v in net.named_parameters()}
    del state
    net.zero_grad(set_to_none=True)
    params = {k: v.requires_grad_(True) for k, v in p0.items()}
    acp = diffusion.schedule.alphas_cumprod.to(DEV)[t].reshape(-1, 1, 1, 1, 1)
    x_t = acp.sqrt() * z + (1 - acp).sqrt() * noise
    loss_r = (ref.dit3d_forward(params, x_t, t, patch=2, heads=16, remat=True)
              - noise).square().mean()
    grads_r = torch.autograd.grad(loss_r, list(params.values()))
    diffs = sorted(float((grads_p[k] - gr.double()).norm() / gr.double().norm().clamp_min(1e-30))
                   for k, gr in zip(params, grads_r))
    loss_r = float(loss_r.detach())
    out.update(loss_gap_b2=abs(float(loss) - loss_r) / abs(loss_r),
               grad_diff_worst_b2=diffs[-1], grad_diff_median_b2=diffs[len(diffs) // 2])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gen", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_dit3d: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    ref.set_precision()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    parts = [p for p, on in ((gen_part, args.gen), (train_part, args.train)) if on]
    for part in parts or [gen_part, train_part]:
        line = json.dumps(part())
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
