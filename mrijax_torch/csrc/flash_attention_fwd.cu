// Flash-attention forward (online softmax over KV tiles), with logsumexp.
//
// Replaces the TPU kernel _flash_kernel of
// mrijax/kernels/flash_attention_pallas.py (driven by _flash_forward_lse).
//
// Bound on an H100: operations. The work is 4*B*H*N^2*Dh flops against
// 4 tensors of B*N*H*Dh elements; at the bottleneck shape of the flagship
// UNet3D (N = 800, Dh = 128, bf16) the flops over the tensor-core rate take
// longer than the bytes over the memory rate. This first version computes
// both products with plain fp32 FMAs from shared memory, so it is far from
// that bound; it is written to be right, to keep the N x N matrix out of
// device memory, and to leave a clear place for mma/wgmma later.
//
// What the design does:
// * One block per (batch*head, tile of BQ query rows). The TPU kernel carried
//   running max / sum / accumulator across a sequential KV grid axis in VMEM;
//   here a loop inside the block walks the KV tiles and the running values
//   stay in registers.
// * 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
//   ty + 16*i (i < 4). For S = q'k^T it owns key columns tx + 16*j (j < 4);
//   for acc += P V it owns a few columns of Dh. The 16 threads that share a
//   row are the lanes of a half warp, so row max and row sum are four
//   shuffles, and the alpha rescale needs no shared memory.
// * Tiles are held in shared memory as fp32 with row pitch Dh + 4, so that
//   the float4 reads along Dh of 8 neighbouring rows fall into distinct banks.
// * q, k and v are read through their strides in (B, N, H, Dh): the slices
//   of the fused qkv projection are used as they are, without a transpose
//   copy. The ragged last tile is masked in the kernel (keys beyond N get
//   -1e30, their K/V rows are zero-filled), so nothing is padded.
// * q is scaled by Dh^-1/2 and rounded to the input type when the tile is
//   loaded — the same place the TPU version rounds it. P is rounded to the
//   input type before the PV product, as there; the row sum uses the
//   unrounded fp32 values.

#include "common.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block
constexpr int LDP = BK + 4;
constexpr float NEG_INF = -1e30f;

struct Strides {
    long long b, n, h;  // in elements; the last dimension has stride 1
};

template <int DH>
constexpr size_t flash_smem_bytes() {
    return sizeof(float) * (BQ * (DH + 4) + BK * (DH + 4) + BK * DH + BQ * LDP);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int N, int H, Strides qs,
                      Strides ks, Strides vs, float scale) {
    constexpr int LD = DH + 4;
    // columns of Dh owned by a thread in the PV product: NJ pieces of CW
    constexpr int CW = DH >= 64 ? 4 : DH / 16;
    constexpr int NJ = DH / (16 * CW);
    static_assert(CW == 4 || CW == 2, "Dh must be 32 or a multiple of 64");
    static_assert(NJ * CW * 16 == DH, "Dh must be 32 or a multiple of 64");

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;            // [BQ][LD]  q', fp32
    float* Ks = Qs + BQ * LD;    // [BK][LD]
    float* Vs = Ks + BK * LD;    // [BK][DH]
    float* Ps = Vs + BK * DH;    // [BQ][LDP]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int q0 = blockIdx.x * BQ;

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;

    for (int e = tid; e < BQ * DH; e += NT) {
        const int r = e / DH, d = e % DH;
        const int n = q0 + r;
        float x = 0.f;
        if (n < N) x = round_to<T>(to_float<T>(qb[n * qs.n + d]) * scale);
        Qs[r * LD + d] = x;
    }

    float m[4], l[4], acc[4][NJ * CW];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NJ * CW; ++c) acc[i][c] = 0.f;
    }

    for (int k0 = 0; k0 < N; k0 += BK) {
        // the previous tile's readers are done (first pass: orders the Q store)
        __syncthreads();
        for (int e = tid; e < BK * DH; e += NT) {
            const int r = e / DH, d = e % DH;
            const int n = k0 + r;
            float kx = 0.f, vx = 0.f;
            if (n < N) {
                kx = to_float<T>(kb[n * ks.n + d]);
                vx = to_float<T>(vb[n * vs.n + d]);
            }
            Ks[r * LD + d] = kx;
            Vs[r * DH + d] = vx;
        }
        __syncthreads();

        // S = q' k^T for rows ty + 16 i, keys tx + 16 j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

#pragma unroll 2
        for (int d = 0; d < DH; d += 4) {
            float4 qa[4], ka[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qa[i] = *reinterpret_cast<const float4*>(
                    &Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                ka[j] = *reinterpret_cast<const float4*>(
                    &Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
                    s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
                    s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
                    s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
                }
        }

        // mask keys beyond N (only the last tile has any)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (k0 + tx + 16 * j >= N) {
#pragma unroll
                for (int i = 0; i < 4; ++i) s[i][j] = NEG_INF;
            }

        // online softmax update; P goes to shared memory for the PV product
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mc = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
            mc = half_warp_max(mc);
            const float mn = fmaxf(m[i], mc);
            const float alpha = expf(m[i] - mn);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - mn);
                rs += p;
                Ps[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(p);
            }
            rs = half_warp_sum(rs);
            l[i] = alpha * l[i] + rs;
            m[i] = mn;
#pragma unroll
            for (int c = 0; c < NJ * CW; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

        // acc += P V for rows ty + 16 i, columns tx*CW + 16*CW*jj + w
#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            float pa[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 t = *reinterpret_cast<const float4*>(
                    &Ps[(ty + 16 * i) * LDP + kk]);
                pa[i][0] = t.x;
                pa[i][1] = t.y;
                pa[i][2] = t.z;
                pa[i][3] = t.w;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
                for (int jj = 0; jj < NJ; ++jj) {
                    const float* vp =
                        &Vs[(kk + u) * DH + tx * CW + 16 * CW * jj];
                    float vv[CW];
                    if constexpr (CW == 4) {
                        const float4 t = *reinterpret_cast<const float4*>(vp);
                        vv[0] = t.x;
                        vv[1] = t.y;
                        vv[2] = t.z;
                        vv[3] = t.w;
                    } else {
                        const float2 t = *reinterpret_cast<const float2*>(vp);
                        vv[0] = t.x;
                        vv[1] = t.y;
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int w = 0; w < CW; ++w)
                            acc[i][jj * CW + w] =
                                fmaf(pa[i][u], vv[w], acc[i][jj * CW + w]);
                }
            }
        }
    }

    // every valid row has seen at least one valid key, so l >= 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = q0 + ty + 16 * i;
        if (n >= N) continue;
        T* orow = out + (((long long)b * N + n) * H + h) * DH;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int w = 0; w < CW; ++w) {
                const int col = tx * CW + 16 * CW * jj + w;
                orow[col] = from_float<T>(acc[i][jj * CW + w] / l[i]);
            }
        if (tx == 0) lse[(long long)bh * N + n] = m[i] + logf(l[i]);
    }
}

template <typename T, int DH>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int N, int H, Strides qs, Strides ks,
                 Strides vs, float scale, cudaStream_t stream) {
    auto kernel = flash_attn_fwd_kernel<T, DH>;
    constexpr size_t smem = flash_smem_bytes<DH>();
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((unsigned)((N + BQ - 1) / BQ), (unsigned)(B * H));
    kernel<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, N, H, qs, ks, vs,
        scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int N, int H, Strides qs, Strides ks,
                Strides vs, float scale, cudaStream_t stream) {
    switch (Dh) {
        case 32:
            return launch_flash<T, 32>(q, k, v, out, lse, B, N, H, qs, ks, vs,
                                       scale, stream);
        case 64:
            return launch_flash<T, 64>(q, k, v, out, lse, B, N, H, qs, ks, vs,
                                       scale, stream);
        case 128:
            return launch_flash<T, 128>(q, k, v, out, lse, B, N, H, qs, ks, vs,
                                        scale, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: (B, N, H, Dh) read through (batch, token, head) strides given in
// elements, last dimension contiguous. out: contiguous (B, N, H, Dh) of the
// input type. lse: contiguous fp32 (B*H, N). Returns the cudaError_t of the
// launch (0 on success); launches on `stream`, does not synchronise,
// allocates nothing.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int dtype, int B, int N,
                              int H, int Dh, long long qsb, long long qsn,
                              long long qsh, long long ksb, long long ksn,
                              long long ksh, long long vsb, long long vsn,
                              long long vsh, double scale, void* stream) {
    const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh};
    float* lse_f = static_cast<float*>(lse);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == MRI_DTYPE_F32)
        return dispatch_dh<float>(Dh, q, k, v, out, lse_f, B, N, H, qs, ks, vs,
                                  (float)scale, st);
    if (dtype == MRI_DTYPE_BF16)
        return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, out, lse_f, B, N, H, qs,
                                          ks, vs, (float)scale, st);
    return (int)cudaErrorInvalidValue;
}
