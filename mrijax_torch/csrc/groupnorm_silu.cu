// Fused GroupNorm + SiLU over channels-last activations (B, N, C), forward.
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
// * In the stats pass each thread owns one vector column (VEC consecutive
//   channels that lie in one group) and walks rows, so a warp reads
//   consecutive 4..16-byte pieces of a row.
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
// * The TPU kernel carried its sums across a sequential grid axis in VMEM.
//   Blocks here run in any order, so the stats pass writes one partial per
//   (batch, row-chunk) and a tiny second kernel sums the partials in a fixed
//   order. No atomics: results are identical from run to run.
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

struct GnShape {
    long long B, N;
    int C, G;
    int tx, ty;          // thread grid: tx vector columns by ty rows per pass
    int rows_per_chunk;  // rows of one batch entry handled by one block
    int chunks;          // blocks per batch entry
};

template <typename T, int VEC>
__global__ void gn_silu_stats_kernel(const T* __restrict__ x,
                                     float* __restrict__ partials, GnShape s) {
    extern __shared__ float red[];  // [2][ty][cols]
    const int cols = s.C / VEC;
    const int cpv = (s.C / s.G) / VEC;  // vector columns per group
    const int tid = threadIdx.x;
    const int x_id = tid % s.tx;
    const int y_id = tid / s.tx;
    const long long b = blockIdx.y;
    const long long chunk = blockIdx.x;
    const long long row0 = chunk * s.rows_per_chunk;
    const long long row1 = min(row0 + (long long)s.rows_per_chunk, s.N);
    const T* xb = x + b * s.N * s.C;

    for (int col = x_id; col < cols; col += s.tx) {
        float sum = 0.f, sumsq = 0.f;
        for (long long r = row0 + y_id; r < row1; r += s.ty) {
            const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
                xb + r * s.C + (long long)col * VEC);
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                const float f = to_float<T>(p.v[i]);
                sum += f;
                sumsq += f * f;
            }
        }
        red[y_id * cols + col] = sum;
        red[(s.ty + y_id) * cols + col] = sumsq;
    }
    __syncthreads();

    for (int g = tid; g < s.G; g += blockDim.x) {
        float sum = 0.f, sumsq = 0.f;
        for (int y = 0; y < s.ty; ++y) {
            for (int c = g * cpv; c < (g + 1) * cpv; ++c) {
                sum += red[y * cols + c];
                sumsq += red[(s.ty + y) * cols + c];
            }
        }
        float* out = partials + (b * s.chunks + chunk) * 2 * s.G;
        out[g] = sum;
        out[s.G + g] = sumsq;
    }
}

// Sums the (B, chunks, 2, G) partials in a fixed order and writes
// stats (B, 2, G): row 0 the mean, row 1 1/sqrt(var + eps).
constexpr int FIN_THREADS = 256;

__global__ void gn_silu_finalize_kernel(const float* __restrict__ partials,
                                        float* __restrict__ stats, int chunks,
                                        int G, float count, float eps) {
    __shared__ float fin[2][FIN_THREADS];
    const int tid = threadIdx.x;
    const int ty = FIN_THREADS / G;
    const int g = tid % G;
    const int y = tid / G;
    const long long b = blockIdx.x;
    const float* p = partials + b * chunks * 2 * G;
    if (y < ty) {
        float sum = 0.f, sumsq = 0.f;
        for (long long ch = y; ch < chunks; ch += ty) {
            sum += p[(ch * 2) * G + g];
            sumsq += p[(ch * 2 + 1) * G + g];
        }
        fin[0][tid] = sum;
        fin[1][tid] = sumsq;
    }
    __syncthreads();
    if (tid < G) {
        float sum = 0.f, sumsq = 0.f;
        for (int yy = 0; yy < ty; ++yy) {
            sum += fin[0][yy * G + tid];
            sumsq += fin[1][yy * G + tid];
        }
        const float mean = sum / count;
        const float var = fmaxf(sumsq / count - mean * mean, 0.f);
        stats[(b * 2) * G + tid] = mean;
        stats[(b * 2 + 1) * G + tid] = 1.f / sqrtf(var + eps);
    }
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

template <typename T, int VEC>
int launch_stats(const void* x, float* partials, float* stats, GnShape s,
                 double count, double eps, cudaStream_t stream) {
    const dim3 grid((unsigned)s.chunks, (unsigned)s.B);
    const int cols = s.C / VEC;
    const size_t smem = sizeof(float) * 2 * s.ty * cols;
    gn_silu_stats_kernel<T, VEC><<<grid, s.tx * s.ty, smem, stream>>>(
        static_cast<const T*>(x), partials, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gn_silu_finalize_kernel<<<(unsigned)s.B, FIN_THREADS, 0, stream>>>(
        partials, stats, s.chunks, s.G, (float)count, (float)eps);
    return (int)cudaGetLastError();
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

extern "C" int gn_silu_stats(const void* x, void* partials, void* stats,
                             int dtype, int vec, long long B, long long N,
                             int C, int G, int tx, int ty, int rows_per_chunk,
                             int chunks, double count, double eps,
                             void* stream) {
    const GnShape s{B, N, C, G, tx, ty, rows_per_chunk, chunks};
    GN_DISPATCH(launch_stats, x, static_cast<float*>(partials),
                static_cast<float*>(stats), s, count, eps,
                static_cast<cudaStream_t>(stream));
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
