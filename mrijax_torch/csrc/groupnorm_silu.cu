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
// * Each thread owns one vector column (VEC consecutive channels that lie in
//   one group) and walks rows, so a warp reads consecutive 4..16-byte pieces
//   of a row and the per-channel gamma/beta and the group's mean/rstd are
//   loaded once per thread, not once per element.
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

template <typename T, int VEC>
__global__ void gn_silu_apply_kernel(const T* __restrict__ x,
                                     const float* __restrict__ stats,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     T* __restrict__ y, GnShape s) {
    const int cols = s.C / VEC;
    const int cpg = s.C / s.G;
    const int tid = threadIdx.x;
    const int x_id = tid % s.tx;
    const int y_id = tid / s.tx;
    const long long b = blockIdx.y;
    const long long row0 = (long long)blockIdx.x * s.rows_per_chunk;
    const long long row1 = min(row0 + (long long)s.rows_per_chunk, s.N);
    const float* st = stats + b * 2 * s.G;

    for (int col = x_id; col < cols; col += s.tx) {
        const int c0 = col * VEC;
        const int g = c0 / cpg;
        const float mean = st[g];
        const float rstd = st[s.G + g];
        float ga[VEC], be[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            ga[i] = gamma[c0 + i];
            be[i] = beta[c0 + i];
        }
        for (long long r = row0 + y_id; r < row1; r += s.ty) {
            const long long off = (b * s.N + r) * s.C + c0;
            const Pack<T, VEC> p =
                *reinterpret_cast<const Pack<T, VEC>*>(x + off);
            Pack<T, VEC> o;
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                const float v =
                    (to_float<T>(p.v[i]) - mean) * rstd * ga[i] + be[i];
                o.v[i] = from_float<T>(v / (1.f + expf(-v)));
            }
            *reinterpret_cast<Pack<T, VEC>*>(y + off) = o;
        }
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

template <typename T, int VEC>
int launch_apply(const void* x, const float* stats, const float* gamma,
                 const float* beta, void* y, GnShape s, cudaStream_t stream) {
    const dim3 grid((unsigned)s.chunks, (unsigned)s.B);
    gn_silu_apply_kernel<T, VEC><<<grid, s.tx * s.ty, 0, stream>>>(
        static_cast<const T*>(x), stats, gamma, beta, static_cast<T*>(y), s);
    return (int)cudaGetLastError();
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

extern "C" int gn_silu_apply(const void* x, const void* stats,
                             const void* gamma, const void* beta, void* y,
                             int dtype, int vec, long long B, long long N,
                             int C, int G, int tx, int ty, int rows_per_chunk,
                             int chunks, void* stream) {
    const GnShape s{B, N, C, G, tx, ty, rows_per_chunk, chunks};
    GN_DISPATCH(launch_apply, x, static_cast<const float*>(stats),
                static_cast<const float*>(gamma),
                static_cast<const float*>(beta), y, s,
                static_cast<cudaStream_t>(stream));
}
