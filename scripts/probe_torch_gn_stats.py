#!/usr/bin/env python3
"""Time the ``gn_silu_stats`` kernel of ``mrijax_torch`` against variants of
itself, on one NVIDIA GPU.

    python3 scripts/probe_torch_gn_stats.py            # ablations
    python3 scripts/probe_torch_gn_stats.py --profile  # kernels a call launches

At the ten main-path shapes (bf16, batch 2) the ablations time, with CUDA
events (3 warm-up calls, median of 20 calls, a spin kernel before each so
that the launch latency is not in the time):

* the committed kernel with the plan ``launch_plan`` picks (``plan``), and
  with each number of loads a thread it is compiled for (``rows_R``) and
  with 1, 2 and 4 blocks of the batch per SM (``per_sm_K``), the other fields
  as the plan gives them;
* ``two_launches``: the same per-block partials, then a second kernel (one
  block per batch entry) that sums them, in place of the last block's
  ticket;
* at N = 800 and 6 400, ``cluster_8`` and ``cluster_16``: one thread-block
  cluster of 8 or 16 blocks per batch entry whose first block sums the
  others' partials through distributed shared memory, no ticket;
* cut-down copies of the committed source, launched with the committed plan
  and not checked (their statistics are not the function): ``no_finalize``
  (the last block of a batch entry does not sum the partials), ``no_ticket``
  (no fence, no ``atomicAdd``: each block writes its partial and stops);
* ``var_mean`` (``torch.var_mean``, the library yardstick) and ``torch_copy``
  (``Tensor.copy_`` of the same bytes: one read and one write).

Every variant is held against the plain version (2e-5) and, for the
committed kernel, two calls against each other (bitwise). The variants are
built from ``mrijax_torch/csrc/groupnorm_silu.cu`` itself (included into one
more source with ``nvcc``), bf16 with 16-byte vectors only.

``--profile`` runs 20 calls of ``gn_silu_stats`` at each shape under
``torch.profiler`` and prints, per shape, each kernel the calls launched with
its launches and device time per call: it needs only ``gn_silu_stats`` and so
also splits an older tree's time into its kernels.

It prints the card's name and power limit first and one JSON line per shape
with the bytes bound (one read over 3.35 TB/s).
"""

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mrijax_torch.kernels import _build  # noqa: E402
from mrijax_torch.kernels import groupnorm as gn  # noqa: E402

SHAPES = [(2, 51200, 128), (2, 51200, 256), (2, 6400, 256), (2, 6400, 512), (2, 800, 512),
          (2, 800, 1024), (2, 51200, 64), (2, 409600, 64), (2, 409600, 32), (2, 3276800, 32)]
GROUPS = 8
EPS = 1e-5
HBM_BYTES_PER_S = 3.35e12
CLUSTERS = (8, 16)
SOURCE = (_build.CSRC_DIR / "groupnorm_silu.cu").read_text()
CUTS = {
    "no_finalize": [("    finalize_entry<true>(entry, s.blocks, s, stats + b * 2 * s.G);\n", "")],
    "no_ticket": [("""        __threadfence();
        last = atomicAdd(counters + b, 1) == s.blocks - 1;
        __threadfence();""", "        last = false;")],
}

VARIANTS = r"""
#include <cooperative_groups.h>

#include "groupnorm_silu.cu"

namespace cg = cooperative_groups;

namespace {

template <int R>
__global__ void __launch_bounds__(256)
pass_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ partials, StatsShape s) {
    extern __shared__ float smem[];
    const long long b = blockIdx.y;
    block_partial<__nv_bfloat16, 8, R>(x + b * s.N * s.C, s, blockIdx.x, smem,
                                       partials + (b * s.blocks + blockIdx.x) * 2 * s.G);
}

__global__ void __launch_bounds__(256)
finalize_kernel(const float* __restrict__ partials, float* __restrict__ stats, StatsShape s) {
    const long long b = blockIdx.x;
    finalize_entry<false>(partials + b * s.blocks * 2 * s.G, s.blocks, s, stats + b * 2 * s.G);
}

template <int R, int CL>
__global__ void __launch_bounds__(256)
cluster_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ stats, StatsShape s) {
    extern __shared__ float smem[];
    __shared__ float partial[16];       // (2, G) for G = 8
    __shared__ float all[CL * 16];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const long long b = blockIdx.y;
    block_partial<__nv_bfloat16, 8, R>(x + b * s.N * s.C, s, rank, smem, partial);
    cluster.sync();
    if (rank == 0) {
        const int tid = threadIdx.y * blockDim.x + threadIdx.x;
        for (int i = tid; i < CL * 16; i += blockDim.x * blockDim.y)
            all[i] = cluster.map_shared_rank(partial, i / 16)[i % 16];
        __syncthreads();
        finalize_entry<false>(all, CL, s, stats + b * 2 * s.G);
    }
    cluster.sync();   // the others' shared memory stays until rank 0 has read it
}

template <int R>
int two_launches(const void* x, float* partials, float* stats, StatsShape s, long long B,
                 int tx, int ty, cudaStream_t stream) {
    const size_t smem = sizeof(float) * 2 * ((size_t)ty * tx * 8 + s.C);
    pass_kernel<R><<<dim3(s.blocks, B), dim3(tx, ty), smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), partials, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finalize_kernel<<<(unsigned)B, 256, 0, stream>>>(partials, stats, s);
    return (int)cudaGetLastError();
}

template <int R, int CL>
int launch_cluster(const void* x, float* stats, StatsShape s, long long B, int tx, int ty,
            cudaStream_t stream) {
    if (CL > 8) {
        cudaError_t err = cudaFuncSetAttribute(
            cluster_kernel<R, CL>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL, (unsigned)B);
    cfg.blockDim = dim3(tx, ty);
    cfg.dynamicSmemBytes = sizeof(float) * 2 * ((size_t)ty * tx * 8 + s.C);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_kernel<R, CL>, xb, stats, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <int R>
int cluster_of(int cl, const void* x, float* stats, StatsShape s, long long B, int tx, int ty,
               cudaStream_t stream) {
    switch (cl) {
        case 8: return launch_cluster<R, 8>(x, stats, s, B, tx, ty, stream);
        case 16: return launch_cluster<R, 16>(x, stats, s, B, tx, ty, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int probe_two_launches(const void* x, void* partials, void* stats, long long B,
                                  long long N, int C, int G, int tx, int ty, int R,
                                  int blocks, double count, double eps, void* stream) {
    const StatsShape s{N, C, G, blocks, (float)count, (float)eps};
    float* p = static_cast<float*>(partials);
    float* st = static_cast<float*>(stats);
    cudaStream_t cs = static_cast<cudaStream_t>(stream);
    switch (R) {
        case 1: return two_launches<1>(x, p, st, s, B, tx, ty, cs);
        case 2: return two_launches<2>(x, p, st, s, B, tx, ty, cs);
        case 4: return two_launches<4>(x, p, st, s, B, tx, ty, cs);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" int probe_cluster(const void* x, void* stats, long long B, long long N, int C,
                             int G, int tx, int ty, int R, int cl, double count, double eps,
                             void* stream) {
    const StatsShape s{N, C, G, cl, (float)count, (float)eps};
    float* st = static_cast<float*>(stats);
    cudaStream_t cs = static_cast<cudaStream_t>(stream);
    if (G != 8) return (int)cudaErrorInvalidValue;
    switch (R) {
        case 1: return cluster_of<1>(cl, x, st, s, B, tx, ty, cs);
        case 2: return cluster_of<2>(cl, x, st, s, B, tx, ty, cs);
        case 4: return cluster_of<4>(cl, x, st, s, B, tx, ty, cs);
    }
    return (int)cudaErrorInvalidValue;
}
"""


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def build_variants():
    """The variants' library and one library per cut-down copy, all ``nvcc``
    started together."""
    out = _build.BUILD_DIR / "probe_gn_stats"
    out.mkdir(parents=True, exist_ok=True)
    texts = {"variants": VARIANTS}
    for name, edits in CUTS.items():
        text = SOURCE
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"cut {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        src, lib = out / f"gn_stats_{name}.cu", out / f"libgn_stats_{name}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    v = libs.pop("variants")
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    v.probe_two_launches.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, d, d, p]
    v.probe_cluster.argtypes = [p, p, ll, ll, i, i, i, i, i, i, d, d, p]
    return v, libs


def time_ms(fn, repeats=20):
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


def inputs(rng, b, n, c):
    x = torch.from_numpy(rng.standard_normal((b, n, c), dtype=np.float32)).cuda()
    return x.mul_(1.5).add_(0.3).bfloat16()


def profile_calls(calls=20):
    """Kernels that ``gn_silu_stats`` launches, per shape: launches and device
    ms per call."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    for b, n, c in SHAPES:
        x = inputs(rng, b, n, c)
        for _ in range(3):
            gn.gn_silu_stats(x, GROUPS)
        torch.cuda.synchronize()
        kernels = {}
        for _ in range(3):   # the profiler now and then records no kernel at all: ask again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    gn.gn_silu_stats(x, GROUPS)
                torch.cuda.synchronize()
            for evt in prof.key_averages():
                dev_us = getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0))
                if dev_us > 0 and evt.device_type.name != "CPU":
                    kernels[evt.key[:80]] = {"launches_per_call": evt.count / calls,
                                             "ms_per_call": dev_us / 1e3 / calls}
            if kernels:
                break
        print("stats_profile " + json.dumps({"shape": [b, n, c], "kernels": kernels}), flush=True)
        del x


def variant(plan, n, b, rows_per_thread, per_sm=None):
    """The committed plan with another number of loads a thread or of blocks
    per SM, the other fields as ``launch_plan`` derives them."""
    slabs = -(-n // (plan.ty * rows_per_thread))
    if per_sm is None:
        per_sm = 1 if slabs * b <= gn.STATS_SLABS_PER_SM * gn.SM_COUNT else gn.STATS_BLOCKS_PER_SM
    return dataclasses.replace(plan, rows_per_thread=rows_per_thread, slabs=slabs,
                               blocks=min(slabs, -(-per_sm * gn.SM_COUNT // b)))


def check(name, got, want, first=None):
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0, msg=name)
    if first is not None and not torch.equal(got, first):
        raise AssertionError(f"{name}: two calls differ")


def ablations():
    variants, cuts = build_variants()
    committed = _build.library("groupnorm_silu")
    rng = np.random.default_rng(0)
    for b, n, c in SHAPES:
        x = inputs(rng, b, n, c)
        want = gn.gn_silu_stats_reference(x, GROUPS)
        count = float(n * (c // GROUPS))
        stream = torch.cuda.current_stream().cuda_stream
        plan = gn.launch_plan(n, c, GROUPS, 2, 16, b)
        row = {"shape": [b, n, c],
               "plan": {**dataclasses.asdict(plan), "slabs_per_block": plan.slabs_per_block},
               "bound_ms": x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3}
        first = gn.gn_silu_stats(x, GROUPS)
        check("plan", gn.gn_silu_stats(x, GROUPS), want, first)
        row["plan_ms"] = time_ms(lambda: gn.gn_silu_stats(x, GROUPS))
        for r in gn.STATS_ROWS_PER_THREAD[::-1]:
            p = variant(plan, n, b, r)
            check(f"rows {r}", gn._launch_stats(x, GROUPS, EPS, p), want)
            row[f"rows_{r}_ms"] = time_ms(lambda: gn._launch_stats(x, GROUPS, EPS, p))
        for k in (1, 2, 4):
            p = variant(plan, n, b, plan.rows_per_thread, per_sm=k)
            check(f"per_sm {k}", gn._launch_stats(x, GROUPS, EPS, p), want)
            row[f"per_sm_{k}_blocks"] = p.blocks
            row[f"per_sm_{k}_ms"] = time_ms(lambda: gn._launch_stats(x, GROUPS, EPS, p))
        partials = torch.empty(b * plan.blocks * 2 * GROUPS, device="cuda")
        stats = torch.empty(b, 2, GROUPS, device="cuda")

        def two():
            _build.check_launch(variants.probe_two_launches(
                x.data_ptr(), partials.data_ptr(), stats.data_ptr(), b, n, c, GROUPS,
                plan.tx, plan.ty, plan.rows_per_thread, plan.blocks, count, EPS, stream),
                "two launches")

        two()
        check("two_launches", stats, want)
        row["two_launches_ms"] = time_ms(two)
        if n <= 6400:
            for cl in CLUSTERS:
                def clustered(cl=cl):
                    _build.check_launch(variants.probe_cluster(
                        x.data_ptr(), stats.data_ptr(), b, n, c, GROUPS, plan.tx, plan.ty,
                        plan.rows_per_thread, cl, count, EPS, stream), f"cluster {cl}")

                stats.zero_()
                clustered()
                check(f"cluster_{cl}", stats, want)
                row[f"cluster_{cl}_ms"] = time_ms(clustered)
        for name, lib in cuts.items():
            _build._loaded["groupnorm_silu"] = lib
            row[f"{name}_ms"] = time_ms(lambda: gn.gn_silu_stats(x, GROUPS))
        _build._loaded["groupnorm_silu"] = committed
        xg = x.view(b, n, GROUPS, c // GROUPS)
        row["var_mean_ms"] = time_ms(lambda: torch.var_mean(xg, dim=(1, 3), correction=0))
        row["torch_copy_ms"] = time_ms(lambda: torch.empty_like(x).copy_(x))
        print("stats_ablation " + json.dumps(row), flush=True)
        del x, xg, want, first, partials, stats


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="only list the kernels each call launches, under torch.profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(card())
    if args.profile:
        profile_calls()
    else:
        ablations()
    return 0


if __name__ == "__main__":
    sys.exit(main())
