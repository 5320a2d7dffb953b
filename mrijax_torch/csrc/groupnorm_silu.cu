// Fused GroupNorm + SiLU over channels-last activations (B, N, C): the
// forward (gn_silu_stats, gn_silu_apply) and, below it, the backward
// (gn_silu_bwd_reduce, gn_silu_bwd_apply), which replaces no TPU kernel.
//
// Replaces the two TPU kernels of mrijax/kernels/groupnorm_pallas.py:
//   gn_silu_stats  <- _stats_kernel   (per-(batch, group) sum x and sum x^2)
//   gn_silu_apply  <- _apply_kernel   (normalise, affine, SiLU, cast)
//
// Bound on an H100: bytes. The op does a handful of flops per element, so
// the least time is two reads and one write of the activation over the
// memory rate; the design only has to keep every access a wide coalesced
// one and keep intermediates out of device memory.
//
// What the design does about it:
// * gn_silu_stats is one launch that fills the card. A block of tx vector
//   columns by ty rows takes slabs of ty * R rows of one batch entry, slabs
//   `blocks` apart, and each thread issues its R independent 16-byte loads
//   (R a compile-time 2 or 4) before any addition.
//   kernels/groupnorm.py::launch_plan takes R = 4 where that still gives
//   the card a slab per SM, and a grid of at most two blocks per SM: one
//   wave, no tail of a few blocks on an idle card. One load a thread never
//   measured faster than two, a second finalize launch and thread-block
//   clusters slower than the ticket (PERF.md).
// * Its vectors are 16 bytes wherever C and the pointer allow, also across a
//   group boundary (C = 32 in bf16: a vector holds two groups of 4
//   channels): a thread keeps per-channel sums of x and x^2 for the VEC
//   channels of its vector column, the column sum of the TPU kernel, and
//   at the end adds the channels of each group it holds. The block then
//   reduces rows (shuffles inside a warp, then shared memory across warps)
//   and the group pieces of a row, all as trees, into one (2, G) partial.
// * The TPU kernel carried its sums across a sequential grid axis in VMEM.
//   Blocks here run in any order, so each writes its partial, and the block
//   that draws the last ticket of its batch entry (one atomicAdd on a
//   counter) sums that entry's partials and writes mean and 1/std. Only the
//   ticket is an atomic: every sum is taken in a fixed order, so results
//   are identical from run to run. The last block sets the counter back to
//   0, so the wrapper's cached workspace needs no memset per call.
// * Sums are trees, not long chains: at |mean| >> std, E[x^2] - mean^2
//   cancels, and a long serial fp32 chain would make that worse. A thread
//   adds its slab sums in runs of kChain and then the runs, so no chain is
//   longer than kChain + slabs / kChain. Products
//   and sums are __fmul_rn / __fadd_rn, never contracted into an FMA, so a
//   plain-PyTorch emulation (tests/test_torch_gn_stats.py) repeats them.
// * The apply pass keeps enough loads in flight to fill the card at the
//   UNet's small shapes: each thread issues a compile-time number R (1 or
//   2) of independent loads of one vector column before any arithmetic,
//   and kernels/groupnorm.py::apply_plan takes the largest R that still
//   gives every SM a block of each batch entry (one vector a thread at
//   (800, 512)). 4 loads a thread measured slower than 2 at every
//   main-path shape but the largest, where they tie (PERF.md, PR 4). Its vectors are 16 bytes wherever C and the pointer allow,
//   also across a group boundary (C = 32 in bf16: 4 channels a group): each
//   channel carries its own mean, rstd * gamma and beta, as the TPU kernel
//   broadcasts the group statistics to channels. The block computes them
//   once into shared memory while its loads are in flight, and each thread
//   reads its columns' in 16-byte pieces: computed by every thread from
//   global memory they cost as much as the SiLU (PERF.md, PR 4).
//   y = (x - mean) * (rstd * gamma) + beta: mean is subtracted before the
//   scaling, which does not cancel when |mean| >> std.
// * The one-hot (C, G) matmul of the TPU kernel was a way to reduce over
//   lanes on the matrix unit; here channels of a group are contiguous in a
//   row, so the reduction is a few shared-memory adds.
// * Offsets are 64-bit: the decoder's activations exceed 2^31 elements' worth
//   of bytes.
//
// Statistics are fp32 whatever the input type; variance is E[x^2] - mean^2
// (clamped at 0), count = N * C / G, as in the TPU kernel.

#include "common.cuh"

namespace {

constexpr int kMaxGroups = 128;  // kernels/groupnorm.py::MAX_GROUPS
constexpr int kChain = 32;       // kernels/groupnorm.py::SLAB_CHAIN

struct StatsShape {
    long long N;
    int C, G;
    int blocks;        // blocks, and partials, per batch entry
    float count, eps;  // N * C / G; the variance's epsilon
};

// Per (kind, group) pair p < pairs: the sum over j < count of
// src[p * pair_stride + j * item_stride]. The block's threads split into
// groups of L lanes, L the largest power of two up to 32 that gives every
// pair its lanes; lane l adds j = l, l + L, ... in that order (loads eight
// at a time, all in flight), then the L lanes add their results as a tree
// (shuffles inside one warp). out[p] gets the total. kL2: src is global
// memory written by other blocks of this launch, read through L2. Every
// thread of the block must call it; the block is a whole number of warps.
template <bool kL2>
__device__ __forceinline__ void pair_sums(const float* src, int pairs,
                                          long long pair_stride,
                                          long long item_stride, int count,
                                          float* out) {
    constexpr int kLoads = 8;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    int L = 32;
    while (L > 1 && L * pairs > nthreads) L /= 2;
    for (int p0 = 0; p0 < pairs; p0 += nthreads / L) {
        const int p = p0 + tid / L;
        const int lane = tid % L;
        float v = 0.f;
        if (p < pairs) {
            const float* q = src + p * pair_stride;
            for (int j0 = lane; j0 < count; j0 += kLoads * L) {
                float t[kLoads];
#pragma unroll
                for (int u = 0; u < kLoads; ++u) {
                    const int j = j0 + u * L;
                    t[u] = j < count ? (kL2 ? __ldcg(q + j * item_stride)
                                            : q[j * item_stride])
                                     : 0.f;
                }
#pragma unroll
                for (int u = 0; u < kLoads; ++u) v = __fadd_rn(v, t[u]);
            }
        }
        for (int off = L / 2; off >= 1; off /= 2)
            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (p < pairs && lane == 0) out[p] = v;
    }
}

// One block's (2, G) partial of batch entry xb: row 0 the group sums of x,
// row 1 of x^2, written to out (global or shared memory). Thread (x, y) of
// the tx by ty block walks vector column col = pass * tx + x and, in slab
// s = block, block + blocks, ..., rows s * ty * R + r * ty + y (r < R): the
// R loads first, then their sum as a tree, added to a run of at most kChain
// slab sums per channel; each run is then added to the thread's sums. Then,
// as trees: the thread's adjacent channels while they lie in one group (a
// vector holds whole groups or lies in one: kernels/groupnorm.py::
// launch_plan), the rows of a warp (shuffles), the warps' rows (shared
// memory), the pieces of each group (pair_sums). smem: [2][ty / rows a
// warp][tx * VEC] row sums, then [2][C] sums of group pieces.
template <typename T, int VEC, int R>
__device__ __forceinline__ void block_partial(const T* __restrict__ xb,
                                              const StatsShape& s, int block,
                                              float* smem, float* out) {
    const int tx = blockDim.x, ty = blockDim.y;
    const int x = threadIdx.x, y = threadIdx.y;
    const int cols = s.C / VEC;
    const int cpg = s.C / s.G;
    const int piece = cpg < VEC ? cpg : VEC;  // channels summed in a thread
    const int pieces = VEC / piece;           // group pieces a vector holds
    const int rows_w = tx < 32 ? 32 / tx : 1; // rows a warp holds
    const int slots = ty / rows_w;            // warps' rows left after shuffles
    const int width = tx * pieces;
    float* red = smem;                        // [2][slots][width]
    float* chsum = smem + 2 * slots * tx * VEC;  // [2][cols * pieces]
    const int row_pieces = cols * pieces;
    const long long slab_rows = (long long)ty * R;
    const long long slabs = (s.N + slab_rows - 1) / slab_rows;

    for (int col0 = 0; col0 < cols; col0 += tx) {
        const int col = col0 + x;
        // slab sums go into run[] kChain at a time, each run then into sum[]
        float sum[VEC], sq[VEC], run[VEC], run_sq[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum[i] = sq[i] = run[i] = run_sq[i] = 0.f;
        if (col < cols) {
            const T* xc = xb + (long long)col * VEC;
            int in_run = 0;
            for (long long slab = block; slab < slabs; slab += s.blocks) {
                const long long row0 = slab * slab_rows + y;
                // the R loads first, all in flight together
                Pack<T, VEC> p[R];
                bool ok[R];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const long long row = row0 + (long long)r * ty;
                    ok[r] = row < s.N;
                    if (ok[r])
                        p[r] = *reinterpret_cast<const Pack<T, VEC>*>(xc + row * s.C);
                }
                float f[R][VEC], q[R][VEC];
#pragma unroll
                for (int r = 0; r < R; ++r) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        f[r][i] = ok[r] ? to_float<T>(p[r].v[i]) : 0.f;
                        q[r][i] = __fmul_rn(f[r][i], f[r][i]);
                    }
                }
#pragma unroll
                for (int w = R / 2; w >= 1; w /= 2) {
#pragma unroll
                    for (int r = 0; r < w; ++r) {
#pragma unroll
                        for (int i = 0; i < VEC; ++i) {
                            f[r][i] = __fadd_rn(f[r][i], f[r + w][i]);
                            q[r][i] = __fadd_rn(q[r][i], q[r + w][i]);
                        }
                    }
                }
#pragma unroll
                for (int i = 0; i < VEC; ++i) {
                    run[i] = __fadd_rn(run[i], f[0][i]);
                    run_sq[i] = __fadd_rn(run_sq[i], q[0][i]);
                }
                if (++in_run == kChain) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        sum[i] = __fadd_rn(sum[i], run[i]);
                        sq[i] = __fadd_rn(sq[i], run_sq[i]);
                        run[i] = run_sq[i] = 0.f;
                    }
                    in_run = 0;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            sum[i] = __fadd_rn(sum[i], run[i]);
            sq[i] = __fadd_rn(sq[i], run_sq[i]);
        }
        // adjacent channels of one group, pairwise: pieces of 2, 4, ... channels
#pragma unroll
        for (int w = 1; w < VEC; w *= 2) {
            if (w < piece) {
#pragma unroll
                for (int i = 0; i < VEC / (2 * w); ++i) {
                    sum[i] = __fadd_rn(sum[2 * i], sum[2 * i + 1]);
                    sq[i] = __fadd_rn(sq[2 * i], sq[2 * i + 1]);
                }
            }
        }
        // the rows of a warp: lanes x + k * tx hold column x
        for (int off = 16; off >= tx; off /= 2) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                if (i < pieces) {
                    sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], off));
                    sq[i] = __fadd_rn(sq[i], __shfl_xor_sync(0xffffffffu, sq[i], off));
                }
            }
        }
        const int slot = y / rows_w;
        if (y % rows_w == 0) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                if (i < pieces) {
                    red[slot * width + x * pieces + i] = sum[i];
                    red[(slots + slot) * width + x * pieces + i] = sq[i];
                }
            }
        }
        __syncthreads();
        // the warps' rows, by the threads of slot 0: a tree over slots
        if (y == 0 && col < cols) {
            for (int k = 0; k < 2 * pieces; ++k) {
                const int kind = k / pieces, i = k % pieces;
                float v[8];  // slots: 8, or ty <= 8 where a warp holds one row
#pragma unroll
                for (int t = 0; t < 8; ++t)
                    v[t] = t < slots ? red[(kind * slots + t) * width + x * pieces + i] : 0.f;
#pragma unroll
                for (int h = 4; h >= 1; h /= 2) {
                    if (h < slots) {
#pragma unroll
                        for (int t = 0; t < h; ++t) v[t] = __fadd_rn(v[t], v[t + h]);
                    }
                }
                chsum[kind * row_pieces + col * pieces + i] = v[0];
            }
        }
        __syncthreads();
    }
    // the pieces of each group: chsum[kind][g * per_group + j] is pair
    // kind * G + g, item j
    const int per_group = row_pieces / s.G;
    pair_sums<false>(chsum, 2 * s.G, per_group, 1, per_group, out);
}

// Sums the `parts` (2, G) partials of one batch entry (src[j * 2G + pair])
// in a fixed order and writes its stats (2, G): row 0 the mean, row 1
// 1/sqrt(var + eps). kL2 as for pair_sums.
template <bool kL2>
__device__ __forceinline__ void finalize_entry(const float* src, int parts,
                                               const StatsShape& s,
                                               float* __restrict__ stats) {
    __shared__ float tot[2 * kMaxGroups];
    pair_sums<kL2>(src, 2 * s.G, 1, 2 * s.G, parts, tot);
    __syncthreads();
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int g = tid; g < s.G; g += blockDim.x * blockDim.y) {
        const float mean = __fdiv_rn(tot[g], s.count);
        const float var = fmaxf(
            __fsub_rn(__fdiv_rn(tot[s.G + g], s.count), __fmul_rn(mean, mean)), 0.f);
        stats[g] = mean;
        stats[s.G + g] = 1.f / sqrtf(__fadd_rn(var, s.eps));
    }
}

// gn_silu_stats: grid (blocks, B), block (tx, ty). partials: (B, blocks, 2,
// G) scratch; counters: B int32, 0 on entry and left 0 on exit.
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(256)
gn_silu_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                     int* __restrict__ counters, float* __restrict__ stats,
                     StatsShape s) {
    extern __shared__ float smem[];
    __shared__ bool last;
    const long long b = blockIdx.y;
    const int block = blockIdx.x;
    float* entry = partials + b * s.blocks * 2 * s.G;
    block_partial<T, VEC, R>(x + b * s.N * s.C, s, block, smem,
                             entry + (long long)block * 2 * s.G);
    // as a grid barrier of cooperative groups: the block's partial is out
    // before its ticket is drawn, and the last block reads the others' after
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        __threadfence();
        last = atomicAdd(counters + b, 1) == s.blocks - 1;
        __threadfence();
    }
    __syncthreads();
    if (!last) return;
    finalize_entry<true>(entry, s.blocks, s, stats + b * 2 * s.G);
    if (threadIdx.x == 0 && threadIdx.y == 0) counters[b] = 0;
}

// gn_silu_apply: a block of blockDim.x = tx vector columns by blockDim.y = ty
// rows; each thread takes R rows ty apart in one vector column. Grid: row
// chunks of ty * R rows, batch entries, column chunks of tx vector columns.
struct ApplyShape {
    long long N;
    int C, G;
};

// VEC consecutive floats of shared memory, 16 bytes at a time where VEC
// allows (the arrays start at multiples of 4 floats then).
template <int VEC>
__device__ __forceinline__ void load_channels(const float* src,
                                              float (&dst)[VEC]) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
            const float4 t = *reinterpret_cast<const float4*>(src + i);
            dst[i] = t.x;
            dst[i + 1] = t.y;
            dst[i + 2] = t.z;
            dst[i + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[i] = src[i];
    }
}

template <typename T, int VEC, int R>
__global__ void __launch_bounds__(256)
gn_silu_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     ApplyShape s) {
    extern __shared__ float params[];  // [3][tx * VEC]: mean, rstd * gamma, beta
    const int col = blockIdx.z * blockDim.x + threadIdx.x;
    const bool col_ok = col * VEC < s.C;
    const long long row0 =
        (long long)blockIdx.x * blockDim.y * R + threadIdx.y;
    const long long b = blockIdx.y;
    const long long base = b * s.N * s.C + (long long)col * VEC;

    // the R loads first, all in flight together
    Pack<T, VEC> p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const long long row = row0 + (long long)r * blockDim.y;
        if (col_ok && row < s.N)
            p[r] = *reinterpret_cast<const Pack<T, VEC>*>(x + base + row * s.C);
    }

    // meanwhile the block computes each of its channels' parameters once
    const int nch = blockDim.x * VEC;
    const int ch0 = blockIdx.z * nch;
    const int cpg = s.C / s.G;
    const float* st = stats + b * 2 * s.G;
    for (int j = threadIdx.y * blockDim.x + threadIdx.x;
         j < nch && ch0 + j < s.C; j += blockDim.x * blockDim.y) {
        const int c = ch0 + j;
        const int g = c / cpg;
        params[j] = st[g];
        params[nch + j] = st[s.G + g] * gamma[c];
        params[2 * nch + j] = beta[c];
    }
    __syncthreads();
    if (!col_ok) return;

    float mean[VEC], a[VEC], be[VEC];
    const float* own = params + threadIdx.x * VEC;
    load_channels<VEC>(own, mean);
    load_channels<VEC>(own + nch, a);
    load_channels<VEC>(own + 2 * nch, be);

#pragma unroll
    for (int r = 0; r < R; ++r) {
        const long long row = row0 + (long long)r * blockDim.y;
        if (row >= s.N) continue;
        Pack<T, VEC> o;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            const float v = (to_float<T>(p[r].v[i]) - mean[i]) * a[i] + be[i];
            o.v[i] = from_float<T>(v / (1.f + expf(-v)));
        }
        *reinterpret_cast<Pack<T, VEC>*>(y + base + row * s.C) = o;
    }
}

// ------------------------------------------------------------------ backward
//
// The gradient of y = silu(a), a = (x - mean) * (rstd * gamma) + beta (the
// forward's apply), with x^ = (x - mean) * rstd, s = sigmoid(a) and
// g = dy * s * (1 + a * (1 - s)):
//   dbeta_c  = sum over (b, n) of g
//   dgamma_c = sum over (b, n) of g * x^
//   dx       = rstd * (g * gamma - m1 - x^ * m2),
// m1 and m2 the means over a (b, group) of g * gamma and g * gamma * x^.
// No TPU kernel: the JAX package's custom_vjp differentiates the plain
// composition, and so did the port, with ~15 float32 passes a call.
//
// Bound on an H100: bytes, as the forward. The least traffic is one read of
// x and dy and one write of dx; the two passes here read x and dy twice.
// * gn_silu_bwd_reduce takes the forward's (B, 2, G) stats (saved by the
//   autograd.Function), so no statistic is computed again. Its blocks cut a
//   batch entry into slabs as gn_silu_stats does (kernels/groupnorm.py::
//   backward_plan): each thread issues R loads of x and R of dy before any
//   arithmetic, forms g and g * (x - mean) in registers and keeps
//   per-channel sums of its vector column (runs of kChain slab sums); at
//   most 128 registers, so that two blocks share an SM. The block reduces its
//   rows (shuffles, then a tree over the warps' rows) into one (2, C)
//   partial. The last block of a batch entry (a ticket, as in the stats
//   kernel) sums the entry's partials in block order into S (2, C) and
//   writes m1, m2 (2, G); the last entry to finish sums S over the batch in
//   entry order into dbeta, dgamma. Every sum has a fixed order and only the
//   tickets are atomics: two calls give the same bits.
// * gn_silu_bwd_apply is gn_silu_apply's layout (apply_plan) with a second
//   input: per-channel mean, rstd * gamma, beta, rstd * m1, rstd^2 * m2 in
//   shared memory once a block, then dx = g * (rstd * gamma) - rstd * m1 -
//   (x - mean) * (rstd^2 * m2) per element.

struct BwdShape {
    long long N;
    int C, G;
    int blocks;   // blocks, and (2, C) partials, per batch entry
    int batch;    // B
    float count;  // N * C / G
};

// g of one element (the chain rule through SiLU), a computed as the
// forward's apply computes it. The sigmoid takes the fast exponential and
// divide (a few ulps; expf and an IEEE divide made both kernels as much ALU
// work as memory traffic on an H100): a gradient, not an output that the
// forward's bits have to match.
__device__ __forceinline__ float silu_grad(float xm, float dy, float rg, float be) {
    const float a = xm * rg + be;
    const float s = __fdividef(1.f, 1.f + __expf(-a));
    return dy * s * (1.f + a * (1.f - s));
}

// One block's (2, C) partial of batch entry (xb, dyb): row 0 the
// per-channel sums of g, row 1 of g * (x - mean) (rstd * that is the sum of
// g * x^: the finalize multiplies), written to out. Thread (x, y)
// walks vector column col = pass * tx + x and the rows of block_partial:
// slabs block, block + blocks, ... of ty * R rows; the R rows of a slab as a
// tree, slab sums in runs of kChain, then the runs. Then, as trees, the rows
// of a warp (shuffles) and the warps' rows (red: [2][slots][tx * VEC]).
template <typename T, int VEC, int R>
__device__ __forceinline__ void block_grad_partial(
    const T* __restrict__ xb, const T* __restrict__ dyb,
    const float* __restrict__ st, const float* __restrict__ gamma,
    const float* __restrict__ beta, const BwdShape& s, int block, float* red,
    float* out) {
    const int tx = blockDim.x, ty = blockDim.y;
    const int x = threadIdx.x, y = threadIdx.y;
    const int cols = s.C / VEC;
    const int cpg = s.C / s.G;
    const int rows_w = tx < 32 ? 32 / tx : 1;  // rows a warp holds
    const int slots = ty / rows_w;             // warps' rows left after shuffles
    const int width = tx * VEC;
    const long long slab_rows = (long long)ty * R;
    const long long slabs = (s.N + slab_rows - 1) / slab_rows;

    for (int col0 = 0; col0 < cols; col0 += tx) {
        const int col = col0 + x;
        float sum[2][VEC], run[2][VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
            sum[0][i] = sum[1][i] = run[0][i] = run[1][i] = 0.f;
        if (col < cols) {
            float mean[VEC], rg[VEC], be[VEC];
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                const int c = col * VEC + i;
                const int g = c / cpg;
                mean[i] = st[g];
                rg[i] = st[s.G + g] * gamma[c];
                be[i] = beta[c];
            }
            const T* xc = xb + (long long)col * VEC;
            const T* dc = dyb + (long long)col * VEC;
            int in_run = 0;
            for (long long slab = block; slab < slabs; slab += s.blocks) {
                const long long row0 = slab * slab_rows + y;
                // the 2R loads first, all in flight together
                Pack<T, VEC> px[R], pd[R];
                bool ok[R];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const long long row = row0 + (long long)r * ty;
                    ok[r] = row < s.N;
                    if (ok[r]) {
                        px[r] = *reinterpret_cast<const Pack<T, VEC>*>(xc + row * s.C);
                        pd[r] = *reinterpret_cast<const Pack<T, VEC>*>(dc + row * s.C);
                    }
                }
                float f[2][R][VEC];
#pragma unroll
                for (int r = 0; r < R; ++r) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        f[0][r][i] = f[1][r][i] = 0.f;
                        if (ok[r]) {
                            const float xm = to_float<T>(px[r].v[i]) - mean[i];
                            const float gg =
                                silu_grad(xm, to_float<T>(pd[r].v[i]), rg[i], be[i]);
                            f[0][r][i] = gg;
                            f[1][r][i] = __fmul_rn(gg, xm);
                        }
                    }
                }
#pragma unroll
                for (int w = R / 2; w >= 1; w /= 2) {
#pragma unroll
                    for (int r = 0; r < w; ++r) {
#pragma unroll
                        for (int i = 0; i < VEC; ++i) {
                            f[0][r][i] = __fadd_rn(f[0][r][i], f[0][r + w][i]);
                            f[1][r][i] = __fadd_rn(f[1][r][i], f[1][r + w][i]);
                        }
                    }
                }
#pragma unroll
                for (int i = 0; i < VEC; ++i) {
                    run[0][i] = __fadd_rn(run[0][i], f[0][0][i]);
                    run[1][i] = __fadd_rn(run[1][i], f[1][0][i]);
                }
                if (++in_run == kChain) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        sum[0][i] = __fadd_rn(sum[0][i], run[0][i]);
                        sum[1][i] = __fadd_rn(sum[1][i], run[1][i]);
                        run[0][i] = run[1][i] = 0.f;
                    }
                    in_run = 0;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            sum[0][i] = __fadd_rn(sum[0][i], run[0][i]);
            sum[1][i] = __fadd_rn(sum[1][i], run[1][i]);
        }
        // the rows of a warp: lanes x + k * tx hold column x
        for (int off = 16; off >= tx; off /= 2) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                sum[0][i] = __fadd_rn(sum[0][i], __shfl_xor_sync(0xffffffffu, sum[0][i], off));
                sum[1][i] = __fadd_rn(sum[1][i], __shfl_xor_sync(0xffffffffu, sum[1][i], off));
            }
        }
        const int slot = y / rows_w;
        if (y % rows_w == 0) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                red[slot * width + x * VEC + i] = sum[0][i];
                red[(slots + slot) * width + x * VEC + i] = sum[1][i];
            }
        }
        __syncthreads();
        // the warps' rows, by the threads of slot 0: a tree over slots
        if (y == 0 && col < cols) {
            for (int k = 0; k < 2 * VEC; ++k) {
                const int kind = k / VEC, i = k % VEC;
                float v[8];  // slots: 8, or ty <= 8 where a warp holds one row
#pragma unroll
                for (int t = 0; t < 8; ++t)
                    v[t] = t < slots ? red[(kind * slots + t) * width + x * VEC + i] : 0.f;
#pragma unroll
                for (int h = 4; h >= 1; h /= 2) {
                    if (h < slots) {
#pragma unroll
                        for (int t = 0; t < h; ++t) v[t] = __fadd_rn(v[t], v[t + h]);
                    }
                }
                out[kind * s.C + col * VEC + i] = v[0];
            }
        }
        __syncthreads();
    }
}

// gn_silu_bwd_reduce: grid (blocks, B), block (tx, ty). partials: (B,
// blocks, 2, C) scratch; counters: B + 1 int32, 0 on entry and left 0 on
// exit; sums: (B, 2, C) S; means: (B, 2, G) m1, m2; dparams: (2, C) dbeta,
// dgamma. smem: [2][slots][tx * VEC] row sums, then [2][C].
// At most 128 registers a thread: two blocks an SM, as backward_plan
// launches them.
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(256, 2)
gn_silu_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ stats,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          float* __restrict__ partials, int* __restrict__ counters,
                          float* __restrict__ sums, float* __restrict__ means,
                          float* __restrict__ dparams, BwdShape s) {
    extern __shared__ float smem[];
    __shared__ float msum[2 * kMaxGroups];
    __shared__ bool last;
    const long long b = blockIdx.y;
    const int block = blockIdx.x;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    const int c2 = 2 * s.C;
    const int rows_w = blockDim.x < 32 ? 32 / blockDim.x : 1;
    float* tot = smem + 2 * (blockDim.y / rows_w) * blockDim.x * VEC;  // [2][C]
    float* entry = partials + b * s.blocks * c2;
    block_grad_partial<T, VEC, R>(x + b * s.N * s.C, dy + b * s.N * s.C,
                                  stats + b * 2 * s.G, gamma, beta, s, block,
                                  smem, entry + (long long)block * c2);
    // the ticket of the batch entry, as in gn_silu_stats_kernel
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        last = atomicAdd(counters + b, 1) == s.blocks - 1;
        __threadfence();
    }
    __syncthreads();
    if (!last) return;
    pair_sums<true>(entry, c2, 1, c2, s.blocks, tot);
    __syncthreads();
    const int cpg = s.C / s.G;
    const float* rstd = stats + b * 2 * s.G + s.G;
    for (int j = tid; j < c2; j += nthreads) {
        const int c = j % s.C;
        if (j >= s.C) tot[j] = __fmul_rn(tot[j], rstd[c / cpg]);   // sum of g * x^
        sums[b * c2 + j] = tot[j];
        tot[j] = __fmul_rn(tot[j], gamma[c]);
    }
    __syncthreads();
    // gamma * S over the channels of each group: tot[kind][g * cpg + j] is
    // pair kind * G + g, item j
    pair_sums<false>(tot, 2 * s.G, cpg, 1, cpg, msum);
    __syncthreads();
    for (int p = tid; p < 2 * s.G; p += nthreads)
        means[b * 2 * s.G + p] = __fdiv_rn(msum[p], s.count);
    // the last batch entry to finish sums S over the batch in entry order
    __syncthreads();
    if (tid == 0) {
        counters[b] = 0;
        __threadfence();
        last = atomicAdd(counters + s.batch, 1) == s.batch - 1;
        __threadfence();
    }
    __syncthreads();
    if (!last) return;
    pair_sums<true>(sums, c2, 1, c2, s.batch, dparams);
    if (tid == 0) counters[s.batch] = 0;
}

// gn_silu_bwd_apply: gn_silu_apply's grid and block, x and dy in, dx out.
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(256)
gn_silu_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ stats,
                         const float* __restrict__ means,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ dx,
                         ApplyShape s) {
    // [5][tx * VEC]: mean, rstd * gamma, beta, rstd * m1, rstd^2 * m2
    extern __shared__ float params[];
    const int col = blockIdx.z * blockDim.x + threadIdx.x;
    const bool col_ok = col * VEC < s.C;
    const long long row0 =
        (long long)blockIdx.x * blockDim.y * R + threadIdx.y;
    const long long b = blockIdx.y;
    const long long base = b * s.N * s.C + (long long)col * VEC;

    // the 2R loads first, all in flight together
    Pack<T, VEC> px[R], pd[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const long long row = row0 + (long long)r * blockDim.y;
        if (col_ok && row < s.N) {
            px[r] = *reinterpret_cast<const Pack<T, VEC>*>(x + base + row * s.C);
            pd[r] = *reinterpret_cast<const Pack<T, VEC>*>(dy + base + row * s.C);
        }
    }

    // meanwhile the block computes each of its channels' parameters once
    const int nch = blockDim.x * VEC;
    const int ch0 = blockIdx.z * nch;
    const int cpg = s.C / s.G;
    const float* st = stats + b * 2 * s.G;
    const float* m = means + b * 2 * s.G;
    for (int j = threadIdx.y * blockDim.x + threadIdx.x;
         j < nch && ch0 + j < s.C; j += blockDim.x * blockDim.y) {
        const int c = ch0 + j;
        const int g = c / cpg;
        const float rs = st[s.G + g];
        params[j] = st[g];
        params[nch + j] = rs * gamma[c];
        params[2 * nch + j] = beta[c];
        params[3 * nch + j] = rs * m[g];
        params[4 * nch + j] = rs * rs * m[s.G + g];
    }
    __syncthreads();
    if (!col_ok) return;

    float mean[VEC], rg[VEC], be[VEC], rm1[VEC], rrm2[VEC];
    const float* own = params + threadIdx.x * VEC;
    load_channels<VEC>(own, mean);
    load_channels<VEC>(own + nch, rg);
    load_channels<VEC>(own + 2 * nch, be);
    load_channels<VEC>(own + 3 * nch, rm1);
    load_channels<VEC>(own + 4 * nch, rrm2);

#pragma unroll
    for (int r = 0; r < R; ++r) {
        const long long row = row0 + (long long)r * blockDim.y;
        if (row >= s.N) continue;
        Pack<T, VEC> o;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            const float xm = to_float<T>(px[r].v[i]) - mean[i];
            const float gg = silu_grad(xm, to_float<T>(pd[r].v[i]), rg[i], be[i]);
            o.v[i] = from_float<T>(gg * rg[i] - rm1[i] - xm * rrm2[i]);
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + base + row * s.C) = o;
    }
}

// Dynamic shared memory a stats launch gets without asking: 48 KB less the
// kernel's static tot[] and flag.
constexpr size_t kStatsDefaultSmem =
    48 * 1024 - sizeof(float) * 2 * kMaxGroups - 16;

template <typename T, int VEC, int R>
int launch_stats_rows(const void* x, float* partials, int* counters,
                      float* stats, StatsShape s, long long B, int tx, int ty,
                      cudaStream_t stream) {
    const dim3 grid((unsigned)s.blocks, (unsigned)B);
    const int slots = tx < 32 ? ty * tx / 32 : ty;
    const size_t smem = sizeof(float) * 2 * ((size_t)slots * tx * VEC + s.C);
    auto kernel = gn_silu_stats_kernel<T, VEC, R>;
    // above 3840 channels the [2][C] group-piece sums need more than the
    // default: raise the kernel's limit (up to the 227 KB a block may have)
    if (smem > kStatsDefaultSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, dim3(tx, ty), smem, stream>>>(
        static_cast<const T*>(x), partials, counters, stats, s);
    return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_stats(int rows_per_thread, const void* x, float* partials,
                 int* counters, float* stats, StatsShape s, long long B,
                 int tx, int ty, cudaStream_t stream) {
#define GN_STATS_ROWS(R)                                                      \
    launch_stats_rows<T, VEC, R>(x, partials, counters, stats, s, B, tx, ty, \
                                 stream)
    switch (rows_per_thread) {
        case 2: return GN_STATS_ROWS(2);
        case 4: return GN_STATS_ROWS(4);
    }
#undef GN_STATS_ROWS
    return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC, int R>
int launch_apply_rows(const void* x, const float* stats, const float* gamma,
                      const float* beta, void* y, ApplyShape s, long long B,
                      int tx, int ty, int row_chunks, int col_chunks,
                      cudaStream_t stream) {
    const dim3 grid((unsigned)row_chunks, (unsigned)B, (unsigned)col_chunks);
    const size_t smem = sizeof(float) * 3 * tx * VEC;
    gn_silu_apply_kernel<T, VEC, R><<<grid, dim3(tx, ty), smem, stream>>>(
        static_cast<const T*>(x), stats, gamma, beta, static_cast<T*>(y), s);
    return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_apply(int rows_per_thread, const void* x, const float* stats,
                 const float* gamma, const float* beta, void* y, ApplyShape s,
                 long long B, int tx, int ty, int row_chunks, int col_chunks,
                 cudaStream_t stream) {
#define GN_APPLY_ROWS(R)                                                      \
    launch_apply_rows<T, VEC, R>(x, stats, gamma, beta, y, s, B, tx, ty,     \
                                 row_chunks, col_chunks, stream)
    switch (rows_per_thread) {
        case 1: return GN_APPLY_ROWS(1);
        case 2: return GN_APPLY_ROWS(2);
    }
#undef GN_APPLY_ROWS
    return (int)cudaErrorInvalidValue;
}

struct BwdBuffers {
    const float *stats, *gamma, *beta;
    float *partials;
    int* counters;
    float *sums, *means, *dparams;
};

template <typename T, int VEC, int R>
int launch_bwd_reduce_rows(const void* x, const void* dy, BwdBuffers w,
                           BwdShape s, int tx, int ty, cudaStream_t stream) {
    const dim3 grid((unsigned)s.blocks, (unsigned)s.batch);
    const int slots = tx < 32 ? ty * tx / 32 : ty;
    const size_t smem = sizeof(float) * 2 * ((size_t)slots * tx * VEC + s.C);
    auto kernel = gn_silu_bwd_reduce_kernel<T, VEC, R>;
    // the same static shared memory as gn_silu_stats_kernel: above 3840
    // channels the [2][C] sums need the limit raised
    if (smem > kStatsDefaultSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, dim3(tx, ty), smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), w.stats, w.gamma,
        w.beta, w.partials, w.counters, w.sums, w.means, w.dparams, s);
    return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd_reduce(int rows_per_thread, const void* x, const void* dy,
                      BwdBuffers w, BwdShape s, int tx, int ty,
                      cudaStream_t stream) {
    if (rows_per_thread == 2)
        return launch_bwd_reduce_rows<T, VEC, 2>(x, dy, w, s, tx, ty, stream);
    return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC, int R>
int launch_bwd_apply_rows(const void* x, const void* dy, const float* stats,
                          const float* means, const float* gamma,
                          const float* beta, void* dx, ApplyShape s,
                          long long B, int tx, int ty, int row_chunks,
                          int col_chunks, cudaStream_t stream) {
    const dim3 grid((unsigned)row_chunks, (unsigned)B, (unsigned)col_chunks);
    const size_t smem = sizeof(float) * 5 * tx * VEC;
    gn_silu_bwd_apply_kernel<T, VEC, R><<<grid, dim3(tx, ty), smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), stats, means,
        gamma, beta, static_cast<T*>(dx), s);
    return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd_apply(int rows_per_thread, const void* x, const void* dy,
                     const float* stats, const float* means,
                     const float* gamma, const float* beta, void* dx,
                     ApplyShape s, long long B, int tx, int ty,
                     int row_chunks, int col_chunks, cudaStream_t stream) {
#define GN_BWD_APPLY_ROWS(R)                                                  \
    launch_bwd_apply_rows<T, VEC, R>(x, dy, stats, means, gamma, beta, dx, s, \
                                     B, tx, ty, row_chunks, col_chunks,      \
                                     stream)
    switch (rows_per_thread) {
        case 1: return GN_BWD_APPLY_ROWS(1);
        case 2: return GN_BWD_APPLY_ROWS(2);
    }
#undef GN_BWD_APPLY_ROWS
    return (int)cudaErrorInvalidValue;
}

// Calls FN<T, VEC>(args...) for the runtime (dtype, vec) pair.
#define GN_DISPATCH(FN, ...)                                                  \
    do {                                                                      \
        if (dtype == MRI_DTYPE_F32) {                                         \
            switch (vec) {                                                    \
                case 1: return FN<float, 1>(__VA_ARGS__);                     \
                case 2: return FN<float, 2>(__VA_ARGS__);                     \
                case 4: return FN<float, 4>(__VA_ARGS__);                     \
            }                                                                 \
        } else if (dtype == MRI_DTYPE_BF16) {                                 \
            switch (vec) {                                                    \
                case 1: return FN<__nv_bfloat16, 1>(__VA_ARGS__);             \
                case 2: return FN<__nv_bfloat16, 2>(__VA_ARGS__);             \
                case 4: return FN<__nv_bfloat16, 4>(__VA_ARGS__);             \
                case 8: return FN<__nv_bfloat16, 8>(__VA_ARGS__);             \
            }                                                                 \
        }                                                                     \
        return (int)cudaErrorInvalidValue;                                    \
    } while (0)

}  // namespace

// Both entries return the cudaError_t of the launch (0 on success). They
// launch on `stream`, do not synchronise and allocate nothing.

// gn_silu_stats takes the fields of kernels/groupnorm.py::launch_plan: a
// block of tx * ty threads (a whole number of warps) takes slabs of
// ty * rows_per_thread rows (2 or 4 loads a thread), `blocks` blocks a
// batch entry. partials holds B * blocks * 2 * G floats; counters B int32
// zeros, which the kernel leaves zero.
extern "C" int gn_silu_stats(const void* x, void* partials, void* counters,
                             void* stats, int dtype, int vec, long long B,
                             long long N, int C, int G, int tx, int ty,
                             int rows_per_thread, int blocks, double count,
                             double eps, void* stream) {
    const StatsShape s{N, C, G, blocks, (float)count, (float)eps};
    GN_DISPATCH(launch_stats, rows_per_thread, x, static_cast<float*>(partials),
                static_cast<int*>(counters), static_cast<float*>(stats), s, B,
                tx, ty, static_cast<cudaStream_t>(stream));
}

// gn_silu_apply takes the fields of kernels/groupnorm.py::apply_plan: a
// block of tx * ty threads covers tx vector columns and ty * rows_per_thread
// rows (1 or 2 rows a thread); row_chunks * col_chunks blocks cover one
// batch entry.
extern "C" int gn_silu_apply(const void* x, const void* stats,
                             const void* gamma, const void* beta, void* y,
                             int dtype, int vec, long long B, long long N,
                             int C, int G, int tx, int ty, int rows_per_thread,
                             int row_chunks, int col_chunks, void* stream) {
    const ApplyShape s{N, C, G};
    GN_DISPATCH(launch_apply, rows_per_thread, x,
                static_cast<const float*>(stats),
                static_cast<const float*>(gamma),
                static_cast<const float*>(beta), y, s, B, tx, ty, row_chunks,
                col_chunks, static_cast<cudaStream_t>(stream));
}

// gn_silu_bwd_reduce takes the reduce fields of kernels/groupnorm.py::
// backward_plan (a block of tx * ty threads takes slabs of ty * 2 rows,
// `blocks` blocks a batch entry) and the forward's stats (B, 2, G).
// partials holds B * blocks * 2 * C floats; counters B + 1 int32 zeros,
// which the kernel leaves zero; it writes sums (B, 2, C), means (B, 2, G:
// m1, m2) and dparams (2, C: dbeta, dgamma).
extern "C" int gn_silu_bwd_reduce(const void* x, const void* dy,
                                  const void* stats, const void* gamma,
                                  const void* beta, void* partials,
                                  void* counters, void* sums, void* means,
                                  void* dparams, int dtype, int vec,
                                  long long B, long long N, int C, int G,
                                  int tx, int ty, int rows_per_thread,
                                  int blocks, double count, void* stream) {
    const BwdShape s{N, C, G, blocks, (int)B, (float)count};
    const BwdBuffers w{static_cast<const float*>(stats),
                       static_cast<const float*>(gamma),
                       static_cast<const float*>(beta),
                       static_cast<float*>(partials),
                       static_cast<int*>(counters),
                       static_cast<float*>(sums),
                       static_cast<float*>(means),
                       static_cast<float*>(dparams)};
    GN_DISPATCH(launch_bwd_reduce, rows_per_thread, x, dy, w, s, tx, ty,
                static_cast<cudaStream_t>(stream));
}

// gn_silu_bwd_apply takes the apply fields of backward_plan (apply_plan's
// layout) and the means that gn_silu_bwd_reduce wrote; dx has x's dtype.
extern "C" int gn_silu_bwd_apply(const void* x, const void* dy,
                                 const void* stats, const void* means,
                                 const void* gamma, const void* beta, void* dx,
                                 int dtype, int vec, long long B, long long N,
                                 int C, int G, int tx, int ty,
                                 int rows_per_thread, int row_chunks,
                                 int col_chunks, void* stream) {
    const ApplyShape s{N, C, G};
    GN_DISPATCH(launch_bwd_apply, rows_per_thread, x, dy,
                static_cast<const float*>(stats),
                static_cast<const float*>(means),
                static_cast<const float*>(gamma),
                static_cast<const float*>(beta), dx, s, B, tx, ty, row_chunks,
                col_chunks, static_cast<cudaStream_t>(stream));
}
