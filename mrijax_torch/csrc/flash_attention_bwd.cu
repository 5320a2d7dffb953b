// Flash-attention backward: dK/dV (KV-major) and dQ (Q-major), from the
// saved output statistics.
//
// Replaces the TPU kernels _dkv_kernel and _dq_kernel of
// mrijax/kernels/flash_attention_pallas.py (driven by _flash_backward).
//
// Bound on an H100: operations. flash_attn_bwd_dkv computes four tile
// products (S = q'k^T, dP = dO v^T, dV += P^T dO, dK += dU^T q'),
// 8*B*H*N^2*Dh flops; flash_attn_bwd_dq three (S, dP, dQ' += dU k),
// 6*B*H*N^2*Dh flops, each against a handful of tensors of B*N*H*Dh
// elements. At the bottleneck shape of the flagship UNet3D (N = 800,
// Dh = 128) the flops take longer than the bytes at any rate the card has.
// No atomics anywhere: every output element is summed by one thread in a
// fixed order, so results are identical from run to run.
//
// The notes below are of the kernels for Dh = 32, 64 and 128. Above 128 each
// type has column-chunk kernels of its own: see "float32, Dh above 128" and
// "bfloat16, Dh above 128" (warpgroup products, wgmma.cuh) further down.
//
// flash_attn_bwd_dkv, bfloat16 -> flash_bwd_dkv_tc_kernel, on the tensor
// cores (mma.sync.aligned.m16n8k16 fed by ldmatrix; see flash_attention_fwd.cu
// for why not wgmma):
// * A block owns 16 * NWARPS keys of one (batch, head); a warp owns 16 keys
//   and both of their (16, Dh) fp32 accumulators (128 registers a thread at
//   Dh = 128). A block is 4 warps, 64 keys: it reads all of Q and dO of
//   its (batch, head) from L2, so a smaller tile moves more bytes per flop
//   (2 warps measured slower even where they alone fill the card, 8 warps no
//   faster), and the accumulators leave no registers for a second fragment
//   of keys a warp. The K and V tile is loaded once; a loop walks the Q / dO
//   tiles of 64 rows, two stages each, filled by cp.async while the previous
//   tile is multiplied.
// * The tile is computed transposed, S^T = k q'^T and dP^T = v dO^T (rows =
//   keys), so P^T and dU^T leave the tensor cores in the register layout of
//   an A operand for dV += P^T dO and dK += dU^T q': no transposed write to
//   shared memory. lse and delta are then per column: each Q tile's 64
//   values of both are staged in shared memory beside it.
// * Registers: the 64 rows of a Q tile are taken 32 at a time, so S^T and
//   dP^T are 16 + 16 registers beside the 128 of the accumulators; the K and
//   V operand fragments are re-read with ldmatrix instead of being held.
// * The TPU kernel runs dV and dK with fp32 P and dU (Precision.HIGHEST).
//   Here each is split into two bf16 terms, hi = bf16(x), lo = bf16(x - hi)
//   (16 significant bits, relative error about 2^-17), and each product is
//   issued twice: 6 mma per 4 of a single-rounding kernel. A single bf16
//   rounding of P is outside the one-bf16-ulp bar dk and dv are held to.
// * q' = round(q * Dh^-1/2) to bf16 is made by one pass over the Q tile in
//   shared memory, each thread on the chunks its own copies brought (so one
//   barrier serves copy and scaling); lse is multiplied by log2(e) the same
//   way and P = ex2.approx(S^T log2(e) - lse log2(e)).
// * bf16 tiles with pitch Dh + 8 (see mma.cuh): 104 KB at Dh = 128 with 64
//   keys, two blocks per SM. Rows beyond N are zero-filled by the copies:
//   a query row beyond N has q' = dO = 0 and lse = delta = 0, so P = 1 there
//   is finite and multiplies zeros; a key beyond N only feeds its own dK / dV
//   row, which is not stored. lse and delta are never read past N.
// * dK and dV are staged through the warp's own (dead) K and V rows and
//   written 16 bytes a lane.
//
// flash_attn_bwd_dq, bfloat16 -> flash_bwd_dq_tc_kernel, the dkv design
// turned Q-major:
// * A block owns 64 query rows of one (batch, head), 4 warps of 16; a warp
//   holds one (16, Dh) fp32 accumulator of dQ' (64 registers at Dh = 128).
//   q' and dO of the block are staged once (q' scaled in shared memory by
//   the threads that copied it); each lane keeps lse * log2(e) and delta of
//   its two rows (g, g + 8) in registers. A loop walks the K / V tiles of
//   64 keys in two cp.async stages, 32 keys at a time.
// * S = q' k^T and dP = dO v^T are not transposed here: K and V are the B
//   operand as [n][k] (plain ldmatrix), and dU = P o (dP - delta) leaves the
//   tensor cores in the register layout of the A operand of dQ' += dU k,
//   whose B operand K is read as [k][n] with ldmatrix.trans.
// * The TPU kernel runs dQ' with fp32 dU (Precision.HIGHEST); dU is split
//   into two bf16 terms as in dkv: 4 mma per 3 of a single-rounding kernel.
//   A key beyond N has zero-filled K and V but P = exp(-lse), so it is set
//   to 0 in the ragged tile before it can meet a large lse.
// * The epilogue rounds dQ' to bf16, multiplies by Dh^-1/2 in fp32 and
//   rounds again (the TPU wrapper's two casts), staged through the warp's
//   own q' rows and written 16 bytes a lane. Two roundings of sums taken in
//   another order can land two bf16 ulps apart: that, not the split, sets
//   the bar dq is held to.
// * Shared memory q', dO and 2 stages of K and V, bf16 with pitch Dh + 8:
//   104 KB at Dh = 128, two blocks per SM.
//
// flash_attn_bwd_dkv and flash_attn_bwd_dq, float32 -> fp32 FMAs from shared
// memory (the TPU kernels run fp32 at Precision.HIGHEST):
// * In dkv one block owns one (batch*head, tile of BK keys) and walks over
//   the Q tiles, holding the dK and dV tiles in registers; in dq one block
//   owns one (batch*head, tile of BQ queries) and walks over the KV tiles.
// * Both share one device function for the (BQ, BK) piece of
//   P = exp(q'k^T - lse) and dU = P o (dO v^T - delta): 256 threads as a
//   16 x 16 grid, thread (ty, tx) owns rows ty + 16 i and keys tx + 16 j.
// * P and dU stay fp32 for the products that consume them. The dQ epilogue
//   rounds dQ' to the input type, multiplies by Dh^-1/2 in fp32 and rounds
//   again, which is what the TPU wrapper's two casts do.
// * For the two products whose summed index is the query row (dV, dK), P and
//   dU are written to shared memory transposed, so that the inner loop reads
//   four rows' worth with one float4.
// * Tiles are fp32 in shared memory with row pitch Dh + 4 (float4 reads of 8
//   neighbouring rows fall into distinct banks). At Dh = 128 dkv needs 166 KB
//   and dq 149 KB of dynamic shared memory: one block per SM.
// * All operands are read through (batch, token, head) strides; the ragged
//   last tile is masked in the kernel (rows and keys beyond N give P = 0).

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block
constexpr int LDP = 64 + 4;  // pitch of the (64, 64) P / dU tiles

struct Strides {
    long long b, n, h;  // in elements; the last dimension has stride 1
};

template <int DH>
constexpr size_t dkv_smem_bytes() {
    return sizeof(float) * (2 * BK * (DH + 4) + 2 * BQ * (DH + 4) + 2 * BK * LDP);
}

template <int DH>
constexpr size_t dq_smem_bytes() {
    return sizeof(float) * (2 * BK * (DH + 4) + 2 * BQ * (DH + 4) + BQ * LDP);
}

// 64 rows x DH of a (B, N, H, Dh) tensor, starting at token row0, into shared
// memory as fp32 with pitch DH + 4; rows beyond N become zero. With SCALED the
// values are multiplied by `scale` and rounded to T (the q' of the forward).
template <typename T, int DH, bool SCALED>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long stride_n, int row0, int N,
                                          float scale, int tid) {
    constexpr int LD = DH + 4;
    for (int e = tid; e < 64 * DH; e += NT) {
        const int r = e / DH, d = e % DH;
        const int n = row0 + r;
        float x = 0.f;
        if (n < N) {
            x = to_float<T>(base[n * stride_n + d]);
            if (SCALED) x = round_to<T>(x * scale);
        }
        dst[r * LD + d] = x;
    }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two tiles of
// pitch DH + 4.
template <int DH>
__device__ __forceinline__ void tile_dot_add(const float* A, const float* B,
                                             int tx, int ty,
                                             float (&acc)[4][4]) {
    constexpr int LD = DH + 4;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            b[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
                acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
                acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
                acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
            }
    }
}

// The same from acc = 0.
template <int DH>
__device__ __forceinline__ void tile_dot_rows(const float* A, const float* B,
                                              int tx, int ty,
                                              float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    tile_dot_add<DH>(A, B, tx, ty, acc);
}

// P = exp(S - lse) and dU = P o (dP - delta) in place, from the thread's
// 4 x 4 pieces of S (in p) and dP (in du): query rows q0 + ty + 16 i, keys
// k0 + tx + 16 j. Rows and keys beyond N give 0.
__device__ __forceinline__ void finish_p_and_du(const float (&lse_r)[4],
                                                const float (&delta_r)[4],
                                                int q0, int k0, int NQ, int NK,
                                                int tx, int ty, float (&p)[4][4],
                                                float (&du)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const bool row_ok = q0 + ty + 16 * i < NQ;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const bool ok = row_ok && (k0 + tx + 16 * j < NK);
            const float pv = ok ? expf(p[i][j] - lse_r[i]) : 0.f;
            p[i][j] = pv;
            du[i][j] = pv * (du[i][j] - delta_r[i]);
        }
    }
}

// The thread's 4 x 4 piece of P = exp(q'k^T - lse) and dU = P o (dO v^T -
// delta): query rows q0 + ty + 16 i, keys k0 + tx + 16 j. Rows and keys
// beyond N give 0.
template <int DH>
__device__ __forceinline__ void p_and_du(const float* Qs, const float* Ks,
                                         const float* Vs, const float* dOs,
                                         const float (&lse_r)[4],
                                         const float (&delta_r)[4], int q0,
                                         int k0, int NQ, int NK, int tx, int ty,
                                         float (&p)[4][4], float (&du)[4][4]) {
    tile_dot_rows<DH>(Qs, Ks, tx, ty, p);    // S
    tile_dot_rows<DH>(dOs, Vs, tx, ty, du);  // dP
    finish_p_and_du(lse_r, delta_r, q0, k0, NQ, NK, tx, ty, p, du);
}

// lse and delta of the thread's four query rows (0 beyond N).
__device__ __forceinline__ void load_row_stats(const float* lse,
                                               const float* delta,
                                               long long row_base, int q0,
                                               int N, int ty,
                                               float (&lse_r)[4],
                                               float (&delta_r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = q0 + ty + 16 * i;
        lse_r[i] = n < N ? lse[row_base + n] : 0.f;
        delta_r[i] = n < N ? delta[row_base + n] : 0.f;
    }
}

// CW consecutive floats from shared memory (CW is 4 or 2).
template <int CW>
__device__ __forceinline__ void load_cols(const float* src, float (&dst)[CW]) {
    if constexpr (CW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(src);
        dst[0] = t.x;
        dst[1] = t.y;
        dst[2] = t.z;
        dst[3] = t.w;
    } else {
        const float2 t = *reinterpret_cast<const float2*>(src);
        dst[0] = t.x;
        dst[1] = t.y;
    }
}

// dV[key][d] += sum_row P[row][key] dO[row][d] and dK[key][d] += sum_row
// dU[row][key] q'[row][d] for keys ty + 16 i, columns tx*CW + 16*CW*jj + w,
// from the transposed P and dU tiles and q', dO tiles of pitch LD.
template <int LD, int CW, int NJ>
__device__ __forceinline__ void fma_dkv(const float* PT, const float* dUT,
                                        const float* dOs, const float* Qs,
                                        int tx, int ty,
                                        float (&acc_dk)[4][NJ * CW],
                                        float (&acc_dv)[4][NJ * CW]) {
#pragma unroll 1
    for (int rr = 0; rr < BQ; rr += 4) {
        float pa[4][4], ua[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            load_cols<4>(&PT[(ty + 16 * i) * LDP + rr], pa[i]);
            load_cols<4>(&dUT[(ty + 16 * i) * LDP + rr], ua[i]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) {
                const int col = tx * CW + 16 * CW * jj;
                float gv[CW], qv[CW];
                load_cols<CW>(&dOs[(rr + u) * LD + col], gv);
                load_cols<CW>(&Qs[(rr + u) * LD + col], qv);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int w = 0; w < CW; ++w) {
                        acc_dv[i][jj * CW + w] =
                            fmaf(pa[i][u], gv[w], acc_dv[i][jj * CW + w]);
                        acc_dk[i][jj * CW + w] =
                            fmaf(ua[i][u], qv[w], acc_dk[i][jj * CW + w]);
                    }
            }
        }
    }
}

// dQ'[row][d] += sum_key dU[row][key] k[key][d] for rows ty + 16 i, columns
// tx*CW + 16*CW*jj + w, from the dU tile and a K tile of pitch LD.
template <int LD, int CW, int NJ>
__device__ __forceinline__ void fma_dq(const float* dUs, const float* Ks, int tx,
                                       int ty, float (&acc)[4][NJ * CW]) {
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
        float ua[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            load_cols<4>(&dUs[(ty + 16 * i) * LDP + kk], ua[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) {
                float kv[CW];
                load_cols<CW>(&Ks[(kk + u) * LD + tx * CW + 16 * CW * jj], kv);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int w = 0; w < CW; ++w)
                        acc[i][jj * CW + w] =
                            fmaf(ua[i][u], kv[w], acc[i][jj * CW + w]);
            }
        }
    }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int NQ, int NK, int H, Strides qs,
                          Strides ks, Strides vs, Strides gs, float scale) {
    constexpr int LD = DH + 4;
    // columns of Dh owned by a thread in the dK / dV tiles: NJ pieces of CW
    constexpr int CW = DH >= 64 ? 4 : DH / 16;
    constexpr int NJ = DH / (16 * CW);
    constexpr int NC = NJ * CW;
    static_assert(CW == 4 || CW == 2,
                  "one-piece instances take Dh 32, 64 or 128; a larger Dh runs "
                  "in 128-column chunks (flash_attn_bwd_dkv_wide_kernel)");
    static_assert(NC * 16 == DH,
                  "one-piece instances take Dh 32, 64 or 128; a larger Dh runs "
                  "in 128-column chunks (flash_attn_bwd_dkv_wide_kernel)");

    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;             // [BK][LD]
    float* Vs = Ks + BK * LD;     // [BK][LD]
    float* Qs = Vs + BK * LD;     // [BQ][LD]  q', fp32
    float* dOs = Qs + BQ * LD;    // [BQ][LD]
    float* PT = dOs + BQ * LD;    // [BK][LDP] P transposed: PT[key][row]
    float* dUT = PT + BK * LDP;   // [BK][LDP] dU transposed

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int k0 = blockIdx.x * BK;
    const long long row_base = (long long)bh * NQ;

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    const T* gb = dout + b * gs.b + h * gs.h;

    load_tile<T, DH, false>(Ks, kb, ks.n, k0, NK, 1.f, tid);
    load_tile<T, DH, false>(Vs, vb, vs.n, k0, NK, 1.f, tid);

    // the thread's piece of the dK and dV tiles: keys ty + 16 i, columns
    // tx*CW + 16*CW*jj + w
    float acc_dk[4][NC], acc_dv[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            acc_dk[i][c] = 0.f;
            acc_dv[i][c] = 0.f;
        }

    for (int q0 = 0; q0 < NQ; q0 += BQ) {
        // the previous tile's readers of Qs, dOs, PT and dUT are done
        __syncthreads();
        load_tile<T, DH, true>(Qs, qb, qs.n, q0, NQ, scale, tid);
        load_tile<T, DH, false>(dOs, gb, gs.n, q0, NQ, 1.f, tid);
        float lse_r[4], delta_r[4];
        load_row_stats(lse, delta, row_base, q0, NQ, ty, lse_r, delta_r);
        __syncthreads();

        float p[4][4], du[4][4];
        p_and_du<DH>(Qs, Ks, Vs, dOs, lse_r, delta_r, q0, k0, NQ, NK, tx, ty, p, du);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                PT[(tx + 16 * j) * LDP + ty + 16 * i] = p[i][j];
                dUT[(tx + 16 * j) * LDP + ty + 16 * i] = du[i][j];
            }
        __syncthreads();

        fma_dkv<LD, CW, NJ>(PT, dUT, dOs, Qs, tx, ty, acc_dk, acc_dv);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = k0 + ty + 16 * i;
        if (n >= NK) continue;
        const long long row = (((long long)b * NK + n) * H + h) * DH;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int w = 0; w < CW; ++w) {
                const int col = tx * CW + 16 * CW * jj + w;
                dk[row + col] = from_float<T>(acc_dk[i][jj * CW + w]);
                dv[row + col] = from_float<T>(acc_dv[i][jj * CW + w]);
            }
    }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int NQ, int NK, int H, Strides qs, Strides ks, Strides vs,
                         Strides gs, float scale) {
    constexpr int LD = DH + 4;
    constexpr int CW = DH >= 64 ? 4 : DH / 16;
    constexpr int NJ = DH / (16 * CW);
    constexpr int NC = NJ * CW;
    static_assert(CW == 4 || CW == 2,
                  "one-piece instances take Dh 32, 64 or 128; a larger Dh runs "
                  "in 128-column chunks (flash_attn_bwd_dq_wide_kernel)");
    static_assert(NC * 16 == DH,
                  "one-piece instances take Dh 32, 64 or 128; a larger Dh runs "
                  "in 128-column chunks (flash_attn_bwd_dq_wide_kernel)");

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;             // [BQ][LD]  q', fp32
    float* dOs = Qs + BQ * LD;    // [BQ][LD]
    float* Ks = dOs + BQ * LD;    // [BK][LD]
    float* Vs = Ks + BK * LD;     // [BK][LD]
    float* dUs = Vs + BK * LD;    // [BQ][LDP] dU[row][key]

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
    const T* gb = dout + b * gs.b + h * gs.h;

    load_tile<T, DH, true>(Qs, qb, qs.n, q0, NQ, scale, tid);
    load_tile<T, DH, false>(dOs, gb, gs.n, q0, NQ, 1.f, tid);
    float lse_r[4], delta_r[4];
    load_row_stats(lse, delta, (long long)bh * NQ, q0, NQ, ty, lse_r, delta_r);

    // the thread's piece of the dQ' tile: rows ty + 16 i, columns
    // tx*CW + 16*CW*jj + w
    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < NK; k0 += BK) {
        // the previous tile's readers are done (first pass: nothing to wait for)
        __syncthreads();
        load_tile<T, DH, false>(Ks, kb, ks.n, k0, NK, 1.f, tid);
        load_tile<T, DH, false>(Vs, vb, vs.n, k0, NK, 1.f, tid);
        __syncthreads();

        float p[4][4], du[4][4];
        p_and_du<DH>(Qs, Ks, Vs, dOs, lse_r, delta_r, q0, k0, NQ, NK, tx, ty, p, du);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                dUs[(ty + 16 * i) * LDP + tx + 16 * j] = du[i][j];
        __syncthreads();

        fma_dq<LD, CW, NJ>(dUs, Ks, tx, ty, acc);
    }

    // dQ = Dh^-1/2 * dQ': dQ' is rounded to the input type, scaled in fp32 and
    // rounded again, as the TPU wrapper's two casts do.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = q0 + ty + 16 * i;
        if (n >= NQ) continue;
        const long long row = (((long long)b * NQ + n) * H + h) * DH;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int w = 0; w < CW; ++w) {
                const int col = tx * CW + 16 * CW * jj + w;
                dq[row + col] =
                    from_float<T>(round_to<T>(acc[i][jj * CW + w]) * scale);
            }
    }
}

// ------------------------------------------------ float32, Dh above 128
//
// As in flash_attention_fwd.cu, a head dim above 128 is zero-padded by the
// wrapper to a multiple of WIDE = 128 and a block owns ONE chunk of WIDE
// output columns (grid z): dK and dV (or dQ') of 64 keys (rows) x 128
// columns keep the 16 x 16 thread grid's 2 x 32 (32) registers at any Dh.
// S and dP are summed over all of Dh, a piece of WIDE columns of each of
// q', K, dO and V at a time through the four tiles of the Dh = 128 layout;
// the pieces are taken in the order chunk + 1, ..., chunk (mod pieces), so
// that the block's own columns of q' and dO (dkv) or of K (dq) are in
// shared memory when the products that need them run. Every chunk
// recomputes P and dU: Dh / 128 times the S and dP work of one pass.

constexpr int WIDE = 128;   // columns of a piece and of a chunk

template <typename T>
__global__ void __launch_bounds__(NT)
flash_attn_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int NQ,
                               int NK, int H, int DH, Strides qs, Strides ks,
                               Strides vs, Strides gs, float scale) {
    constexpr int LD = WIDE + 4;
    constexpr int CW = 4;
    constexpr int NJ = WIDE / (16 * CW);
    constexpr int NC = NJ * CW;

    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;             // [BK][LD]  pieces of K, V, q', dO
    float* Vs = Ks + BK * LD;     // [BK][LD]
    float* Qs = Vs + BK * LD;     // [BQ][LD]
    float* dOs = Qs + BQ * LD;    // [BQ][LD]
    float* PT = dOs + BQ * LD;    // [BK][LDP] P transposed: PT[key][row]
    float* dUT = PT + BK * LDP;   // [BK][LDP] dU transposed

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int k0 = blockIdx.x * BK;
    const int chunk = blockIdx.z;
    const int pieces = DH / WIDE;
    const long long row_base = (long long)bh * NQ;

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    const T* gb = dout + b * gs.b + h * gs.h;

    float acc_dk[4][NC], acc_dv[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            acc_dk[i][c] = 0.f;
            acc_dv[i][c] = 0.f;
        }

    for (int q0 = 0; q0 < NQ; q0 += BQ) {
        float p[4][4], du[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) p[i][j] = du[i][j] = 0.f;
        for (int c = 1; c <= pieces; ++c) {
            const int col = (chunk + c) % pieces * WIDE;
            // the readers of the last piece (and of PT, dUT) are done
            __syncthreads();
            load_tile<T, WIDE, false>(Ks, kb + col, ks.n, k0, NK, 1.f, tid);
            load_tile<T, WIDE, false>(Vs, vb + col, vs.n, k0, NK, 1.f, tid);
            load_tile<T, WIDE, true>(Qs, qb + col, qs.n, q0, NQ, scale, tid);
            load_tile<T, WIDE, false>(dOs, gb + col, gs.n, q0, NQ, 1.f, tid);
            __syncthreads();
            tile_dot_add<WIDE>(Qs, Ks, tx, ty, p);    // S
            tile_dot_add<WIDE>(dOs, Vs, tx, ty, du);  // dP
        }
        float lse_r[4], delta_r[4];
        load_row_stats(lse, delta, row_base, q0, NQ, ty, lse_r, delta_r);
        finish_p_and_du(lse_r, delta_r, q0, k0, NQ, NK, tx, ty, p, du);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                PT[(tx + 16 * j) * LDP + ty + 16 * i] = p[i][j];
                dUT[(tx + 16 * j) * LDP + ty + 16 * i] = du[i][j];
            }
        __syncthreads();

        // the chunk's columns: Qs and dOs hold its piece (the last one)
        fma_dkv<LD, CW, NJ>(PT, dUT, dOs, Qs, tx, ty, acc_dk, acc_dv);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = k0 + ty + 16 * i;
        if (n >= NK) continue;
        const long long row = (((long long)b * NK + n) * H + h) * DH + chunk * WIDE;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int w = 0; w < CW; ++w) {
                const int col = tx * CW + 16 * CW * jj + w;
                dk[row + col] = from_float<T>(acc_dk[i][jj * CW + w]);
                dv[row + col] = from_float<T>(acc_dv[i][jj * CW + w]);
            }
    }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_attn_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dq,
                              int NQ, int NK, int H, int DH, Strides qs,
                              Strides ks, Strides vs, Strides gs, float scale) {
    constexpr int LD = WIDE + 4;
    constexpr int CW = 4;
    constexpr int NJ = WIDE / (16 * CW);
    constexpr int NC = NJ * CW;

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;             // [BQ][LD]  pieces of q', dO, K, V
    float* dOs = Qs + BQ * LD;    // [BQ][LD]
    float* Ks = dOs + BQ * LD;    // [BK][LD]
    float* Vs = Ks + BK * LD;     // [BK][LD]
    float* dUs = Vs + BK * LD;    // [BQ][LDP] dU[row][key]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int q0 = blockIdx.x * BQ;
    const int chunk = blockIdx.z;
    const int pieces = DH / WIDE;

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    const T* gb = dout + b * gs.b + h * gs.h;

    float lse_r[4], delta_r[4];
    load_row_stats(lse, delta, (long long)bh * NQ, q0, NQ, ty, lse_r, delta_r);

    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < NK; k0 += BK) {
        float p[4][4], du[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) p[i][j] = du[i][j] = 0.f;
        for (int c = 1; c <= pieces; ++c) {
            const int col = (chunk + c) % pieces * WIDE;
            __syncthreads();  // the readers of the last piece (and of dUs) are done
            load_tile<T, WIDE, true>(Qs, qb + col, qs.n, q0, NQ, scale, tid);
            load_tile<T, WIDE, false>(dOs, gb + col, gs.n, q0, NQ, 1.f, tid);
            load_tile<T, WIDE, false>(Ks, kb + col, ks.n, k0, NK, 1.f, tid);
            load_tile<T, WIDE, false>(Vs, vb + col, vs.n, k0, NK, 1.f, tid);
            __syncthreads();
            tile_dot_add<WIDE>(Qs, Ks, tx, ty, p);    // S
            tile_dot_add<WIDE>(dOs, Vs, tx, ty, du);  // dP
        }
        finish_p_and_du(lse_r, delta_r, q0, k0, NQ, NK, tx, ty, p, du);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                dUs[(ty + 16 * i) * LDP + tx + 16 * j] = du[i][j];
        __syncthreads();

        // the chunk's columns: Ks holds its piece (the last one)
        fma_dq<LD, CW, NJ>(dUs, Ks, tx, ty, acc);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = q0 + ty + 16 * i;
        if (n >= NQ) continue;
        const long long row = (((long long)b * NQ + n) * H + h) * DH + chunk * WIDE;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int w = 0; w < CW; ++w) {
                const int col = tx * CW + 16 * CW * jj + w;
                dq[row + col] =
                    from_float<T>(round_to<T>(acc[i][jj * CW + w]) * scale);
            }
    }
}

// ---------------------------------------------------------------- bfloat16

using mma::bf16;

constexpr int TC_BQ = 64;  // query rows per tile of the tensor-core kernel
constexpr int TC_QH = 32;  // of which this many are multiplied at a time
constexpr int TC_WARPS = 4;  // warps per block, 16 keys each

template <int DH, int NWARPS>
constexpr size_t dkv_tc_smem_bytes() {
    return sizeof(bf16) * (2 * 16 * NWARPS + 4 * TC_BQ) * (DH + mma::PAD) +
           sizeof(float) * 4 * TC_BQ;
}

// One stage of the Q-side operands, at shared byte addresses: the q and dO
// tiles of TC_BQ rows and the rows' lse and delta (stats[0..TC_BQ) and
// stats[TC_BQ..2 TC_BQ)); everything beyond N is zero-filled.
template <int DH, int NT>
__device__ __forceinline__ void load_q_stage(uint32_t Qst, uint32_t dOst,
                                             uint32_t stats, const bf16* qb,
                                             long long q_stride_n,
                                             const bf16* gb,
                                             long long g_stride_n,
                                             const float* lse_row,
                                             const float* delta_row, int q0,
                                             int N, int tid) {
    mma::load_tile_async<TC_BQ, DH, NT>(Qst, qb, q_stride_n, q0, N, tid);
    mma::load_tile_async<TC_BQ, DH, NT>(dOst, gb, g_stride_n, q0, N, tid);
    for (int e = tid; e < 2 * TC_BQ; e += NT) {
        const int n = q0 + (e & (TC_BQ - 1));
        const bool ok = n < N;
        const float* src = (e < TC_BQ ? lse_row : delta_row) + (ok ? n : 0);
        mma::cp_async_4_zfill(stats + e * 4, src, ok);
    }
}

// mma::scale_own_chunks for one stage of dkv's Q-side operands, and the lse
// values the thread brought become lse * log2(e).
template <int DH, int NT>
__device__ __forceinline__ void finish_q_stage(bf16* Qst, float* stats,
                                               float scale, int tid) {
    mma::scale_own_chunks<TC_BQ, DH, NT>(Qst, scale, tid);
    for (int e = tid; e < TC_BQ; e += NT) stats[e] *= mma::LOG2E;
}

// Two products whose B operands come from rows of one tile stage: c0 +=
// A0 B0^T and c1 += A1 B1^T over KD k-steps of 16, for the warp's 16 rows
// of A0, A1 (ldmatrix at a0, a1) against N rows of B0, B1 (ldmatrix at b0,
// b1; both tiles of pitch LD). S^T = K q'^T and dP^T = V dO^T in dkv; S =
// q' K^T and dP = dO V^T in dq.
template <int KD, int N, int LD>
__device__ __forceinline__ void tc_two_products(uint32_t a0, uint32_t a1,
                                                uint32_t b0, uint32_t b1,
                                                float (&c0)[N / 8][4],
                                                float (&c1)[N / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
        uint32_t x0[4], x1[4];
        mma::ldmatrix_x4(x0, a0 + kk * 32);
        mma::ldmatrix_x4(x1, a1 + kk * 32);
#pragma unroll
        for (int nb = 0; nb < N / 16; ++nb) {
            const uint32_t off = (nb * 16 * LD + kk * 16) * 2;
            uint32_t r[4];
            mma::ldmatrix_x4(r, b0 + off);
            mma::mma_bf16(c0[2 * nb], x0, r[0], r[1]);
            mma::mma_bf16(c0[2 * nb + 1], x0, r[2], r[3]);
            mma::ldmatrix_x4(r, b1 + off);
            mma::mma_bf16(c1[2 * nb], x1, r[0], r[1]);
            mma::mma_bf16(c1[2 * nb + 1], x1, r[2], r[3]);
        }
    }
}

// dV += P^T dO and dK += dU^T q' over N query rows: P^T and dU^T, in the
// accumulator layout that is the A operand's, as two bf16 terms; dO and q'
// read transposed from g_t and q_t (the lane's addresses, pitch LD).
template <int KD, int N, int LD>
__device__ __forceinline__ void tc_dkv_accumulate(const float (&sT)[N / 8][4],
                                                  const float (&dpT)[N / 8][4],
                                                  uint32_t g_t, uint32_t q_t,
                                                  float (&acc_dk)[2 * KD][4],
                                                  float (&acc_dv)[2 * KD][4]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t ph[4], pl[4], uh[4], ul[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // a0, a1 from fragment 2 kk; a2, a3 from fragment 2 kk + 1
            const int jn = 2 * kk + (i >> 1);
            const int e = 2 * (i & 1);
            mma::split_bf16(sT[jn][e], sT[jn][e + 1], ph[i], pl[i]);
            mma::split_bf16(dpT[jn][e], dpT[jn][e + 1], uh[i], ul[i]);
        }
#pragma unroll
        for (int nd2 = 0; nd2 < KD; ++nd2) {
            const uint32_t off = (kk * 16 * LD + nd2 * 16) * 2;
            uint32_t r[4];
            mma::ldmatrix_x4_trans(r, g_t + off);
            mma::mma_bf16(acc_dv[2 * nd2], ph, r[0], r[1]);
            mma::mma_bf16(acc_dv[2 * nd2], pl, r[0], r[1]);
            mma::mma_bf16(acc_dv[2 * nd2 + 1], ph, r[2], r[3]);
            mma::mma_bf16(acc_dv[2 * nd2 + 1], pl, r[2], r[3]);
            mma::ldmatrix_x4_trans(r, q_t + off);
            mma::mma_bf16(acc_dk[2 * nd2], uh, r[0], r[1]);
            mma::mma_bf16(acc_dk[2 * nd2], ul, r[0], r[1]);
            mma::mma_bf16(acc_dk[2 * nd2 + 1], uh, r[2], r[3]);
            mma::mma_bf16(acc_dk[2 * nd2 + 1], ul, r[2], r[3]);
        }
    }
}

// P = exp(S - lse) and dU = P o (dP - delta), in place in dp, for the
// lane's rows g, g + 8 (lse2 = lse * log2(e), dl = delta) and N keys from
// key0; a key beyond NK (zero-filled, S = 0) gets P = 0, whatever lse is.
template <int N>
__device__ __forceinline__ void tc_p_du_rows(const float (&s)[N / 8][4],
                                             float (&dp)[N / 8][4],
                                             const float (&lse2)[2],
                                             const float (&dl)[2], int key0,
                                             int NK, int t) {
    const bool ragged = key0 + N > NK;
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float p = mma::fast_exp2(fmaf(s[jn][e], mma::LOG2E, -lse2[e >> 1]));
            if (ragged && key0 + 8 * jn + 2 * t + (e & 1) >= NK) p = 0.f;
            dp[jn][e] = p * (dp[jn][e] - dl[e >> 1]);
        }
}

// dQ' += dU K over N keys: dU as two bf16 terms, K read transposed from k_t
// (the lane's address, pitch LD).
template <int KD, int N, int LD>
__device__ __forceinline__ void tc_dq_accumulate(const float (&dp)[N / 8][4],
                                                 uint32_t k_t,
                                                 float (&acc)[2 * KD][4]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t uh[4], ul[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // a0, a1 from fragment 2 kk; a2, a3 from fragment 2 kk + 1
            const int jn = 2 * kk + (i >> 1);
            const int e = 2 * (i & 1);
            mma::split_bf16(dp[jn][e], dp[jn][e + 1], uh[i], ul[i]);
        }
#pragma unroll
        for (int nd2 = 0; nd2 < KD; ++nd2) {
            uint32_t r[4];
            mma::ldmatrix_x4_trans(r, k_t + (kk * 16 * LD + nd2 * 16) * 2);
            mma::mma_bf16(acc[2 * nd2], uh, r[0], r[1]);
            mma::mma_bf16(acc[2 * nd2], ul, r[0], r[1]);
            mma::mma_bf16(acc[2 * nd2 + 1], uh, r[2], r[3]);
            mma::mma_bf16(acc[2 * nd2 + 1], ul, r[2], r[3]);
        }
    }
}

template <int DH, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int NQ, int NK, int H, Strides qs,
                        Strides ks, Strides vs, Strides gs, float scale) {
    constexpr int BKT = 16 * NWARPS;  // keys per block
    constexpr int NT = 32 * NWARPS;
    constexpr int LD = DH + mma::PAD;
    constexpr int KD = DH / 16;       // k-steps over Dh
    constexpr int ND = DH / 8;        // 8-column fragments of dK and dV
    constexpr int TILE = TC_BQ * LD;  // elements of one Q or dO stage

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);      // [BKT][LD]
    bf16* Vs = Ks + BKT * LD;                          // [BKT][LD]
    bf16* Qs = Vs + BKT * LD;                          // [2][TC_BQ][LD]  q'
    bf16* dOs = Qs + 2 * TILE;                         // [2][TC_BQ][LD]
    float* stats = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][2 TC_BQ]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int k0 = blockIdx.x * BKT;

    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;
    const bf16* gb = dout + b * gs.b + h * gs.h;
    const float* lse_row = lse + (long long)bh * NQ;
    const float* delta_row = delta + (long long)bh * NQ;

    const uint32_t q_tiles = mma::smem_addr(Qs);
    const uint32_t g_tiles = mma::smem_addr(dOs);
    const uint32_t stat_rows = mma::smem_addr(stats);
    mma::load_tile_async<BKT, DH, NT>(mma::smem_addr(Ks), kb, ks.n, k0, NK, tid);
    mma::load_tile_async<BKT, DH, NT>(mma::smem_addr(Vs), vb, vs.n, k0, NK, tid);
    load_q_stage<DH, NT>(q_tiles, g_tiles, stat_rows, qb, qs.n, gb, gs.n,
                         lse_row, delta_row, 0, NQ, tid);
    mma::cp_async_commit();

    // the warp's 16 keys x Dh of dK and dV
    float acc_dk[ND][4], acc_dv[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc_dk[nd][e] = 0.f;
            acc_dv[nd][e] = 0.f;
        }

    // A operands of S^T and dP^T: the warp's rows of K and V
    const uint32_t k_addr =
        mma::smem_addr(Ks + warp * 16 * LD) + mma::a_offset(lane, LD);
    const uint32_t v_addr =
        mma::smem_addr(Vs + warp * 16 * LD) + mma::a_offset(lane, LD);
    // B operands: q' and dO as [n][k] for S^T and dP^T, and transposed as
    // [k][n] for dK and dV
    const uint32_t q_b = q_tiles + mma::b_offset(lane, LD);
    const uint32_t g_b = g_tiles + mma::b_offset(lane, LD);
    const uint32_t q_t = q_tiles + mma::a_offset(lane, LD);
    const uint32_t g_t = g_tiles + mma::a_offset(lane, LD);

    const int ntiles = (NQ + TC_BQ - 1) / TC_BQ;
    for (int j = 0; j < ntiles; ++j) {
        const int stage = j & 1;
        // the other stage's readers finished at the end of the last pass
        if (j + 1 < ntiles)
            load_q_stage<DH, NT>(q_tiles + (stage ^ 1) * TILE * 2,
                                 g_tiles + (stage ^ 1) * TILE * 2,
                                 stat_rows + (stage ^ 1) * 2 * TC_BQ * 4, qb,
                                 qs.n, gb, gs.n, lse_row, delta_row,
                                 (j + 1) * TC_BQ, NQ, tid);
        mma::cp_async_commit();  // possibly empty: keeps the group count even
        mma::cp_async_wait<1>();  // tile j has landed, tile j + 1 may fly
        const float* st = stats + stage * 2 * TC_BQ;
        finish_q_stage<DH, NT>(Qs + stage * TILE,
                               stats + stage * 2 * TC_BQ, scale, tid);
        __syncthreads();

        const uint32_t stage_bytes = stage * TILE * 2;
#pragma unroll 1
        for (int half = 0; half < TC_BQ / TC_QH; ++half) {
            const uint32_t rows = stage_bytes + half * TC_QH * LD * 2;
            // S^T and dP^T: 16 keys x 32 queries, fragment jn holds queries
            // 8 jn .. 8 jn + 7 of this half
            float sT[4][4], dpT[4][4];
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    sT[jn][e] = 0.f;
                    dpT[jn][e] = 0.f;
                }
            tc_two_products<KD, TC_QH, LD>(k_addr, v_addr, q_b + rows, g_b + rows,
                                           sT, dpT);

            // P^T = exp(S^T - lse) and dU^T = P^T o (dP^T - delta), in place;
            // lse and delta belong to the column (the query row)
#pragma unroll
            for (int jn = 0; jn < 4; ++jn) {
                const int c = half * TC_QH + 8 * jn + 2 * t;
                const float2 lse2 = *reinterpret_cast<const float2*>(st + c);
                const float2 dl =
                    *reinterpret_cast<const float2*>(st + TC_BQ + c);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = mma::fast_exp2(
                        fmaf(sT[jn][e], mma::LOG2E, (e & 1) ? -lse2.y : -lse2.x));
                    sT[jn][e] = p;
                    dpT[jn][e] = p * (dpT[jn][e] - ((e & 1) ? dl.y : dl.x));
                }
            }

            tc_dkv_accumulate<KD, TC_QH, LD>(sT, dpT, g_t + rows, q_t + rows, acc_dk,
                                             acc_dv);
        }
        __syncthreads();  // this stage may be refilled in the next pass
    }

    // dk and dv, rounded once, staged through the warp's own K and V rows (no
    // other warp ever read them), then written as 16-byte pieces of rows
    bf16* Kw = Ks + warp * 16 * LD;
    bf16* Vw = Vs + warp * 16 * LD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
        const int col = nd * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(&Kw[g * LD + col]) =
            mma::pack_bf16(acc_dk[nd][0], acc_dk[nd][1]);
        *reinterpret_cast<uint32_t*>(&Kw[(g + 8) * LD + col]) =
            mma::pack_bf16(acc_dk[nd][2], acc_dk[nd][3]);
        *reinterpret_cast<uint32_t*>(&Vw[g * LD + col]) =
            mma::pack_bf16(acc_dv[nd][0], acc_dv[nd][1]);
        *reinterpret_cast<uint32_t*>(&Vw[(g + 8) * LD + col]) =
            mma::pack_bf16(acc_dv[nd][2], acc_dv[nd][3]);
    }
    __syncwarp();
    constexpr int CPR = DH / 8;
    for (int e = lane; e < 16 * CPR; e += 32) {
        const int r = e / CPR, c = e % CPR;
        const int n = k0 + warp * 16 + r;
        if (n >= NK) continue;
        const long long at = (((long long)b * NK + n) * H + h) * DH + c * 8;
        *reinterpret_cast<uint4*>(dk + at) =
            *reinterpret_cast<const uint4*>(&Kw[r * LD + c * 8]);
        *reinterpret_cast<uint4*>(dv + at) =
            *reinterpret_cast<const uint4*>(&Vw[r * LD + c * 8]);
    }
}

constexpr int DQ_KT = 64;  // keys per K / V tile of the tensor-core dq kernel
constexpr int DQ_KH = 32;  // of which this many are multiplied at a time

template <int DH>
constexpr size_t dq_tc_smem_bytes() {
    return sizeof(bf16) * (2 * 16 * TC_WARPS + 4 * DQ_KT) * (DH + mma::PAD);
}

template <int DH>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int NQ, int NK, int H, Strides qs, Strides ks, Strides vs,
                       Strides gs, float scale) {
    constexpr int BQT = 16 * TC_WARPS;  // query rows per block
    constexpr int NT = 32 * TC_WARPS;
    constexpr int LD = DH + mma::PAD;
    constexpr int KD = DH / 16;         // k-steps over Dh
    constexpr int ND = DH / 8;          // 8-column fragments of dQ'
    constexpr int TILE = DQ_KT * LD;    // elements of one K or V stage

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQT][LD]  q'
    bf16* dOs = Qs + BQT * LD;                     // [BQT][LD]
    bf16* Ks = dOs + BQT * LD;                     // [2][DQ_KT][LD]
    bf16* Vs = Ks + 2 * TILE;                      // [2][DQ_KT][LD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int q0 = blockIdx.x * BQT;

    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;
    const bf16* gb = dout + b * gs.b + h * gs.h;

    const uint32_t k_tiles = mma::smem_addr(Ks);
    const uint32_t v_tiles = mma::smem_addr(Vs);
    mma::load_tile_async<BQT, DH, NT>(mma::smem_addr(Qs), qb, qs.n, q0, NQ, tid);
    mma::load_tile_async<BQT, DH, NT>(mma::smem_addr(dOs), gb, gs.n, q0, NQ, tid);
    mma::cp_async_commit();
    mma::load_tile_async<DQ_KT, DH, NT>(k_tiles, kb, ks.n, 0, NK, tid);
    mma::load_tile_async<DQ_KT, DH, NT>(v_tiles, vb, vs.n, 0, NK, tid);
    mma::cp_async_commit();

    // lse * log2(e) and delta of the lane's rows g and g + 8 (0 beyond NQ)
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int n = q0 + warp * 16 + g + 8 * i;
        const bool ok = n < NQ;
        lse2[i] = ok ? lse[(long long)bh * NQ + n] * mma::LOG2E : 0.f;
        dl[i] = ok ? delta[(long long)bh * NQ + n] : 0.f;
    }

    // the warp's 16 query rows x Dh of dQ'
    float acc[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

    mma::cp_async_wait<1>();  // q and dO have landed, K / V tile 0 may fly
    mma::scale_own_chunks<BQT, DH, NT>(Qs, scale, tid);  // published by the first barrier

    // A operands of S and dP: the warp's rows of q' and dO; B operands: K and
    // V as [n][k] for S and dP, K as [k][n] for dQ'
    const uint32_t q_a =
        mma::smem_addr(Qs + warp * 16 * LD) + mma::a_offset(lane, LD);
    const uint32_t g_a =
        mma::smem_addr(dOs + warp * 16 * LD) + mma::a_offset(lane, LD);
    const uint32_t k_b = k_tiles + mma::b_offset(lane, LD);
    const uint32_t v_b = v_tiles + mma::b_offset(lane, LD);
    const uint32_t k_t = k_tiles + mma::a_offset(lane, LD);

    const int ntiles = (NK + DQ_KT - 1) / DQ_KT;
    for (int j = 0; j < ntiles; ++j) {
        const int stage = j & 1;
        // the other stage's readers finished at the end of the last pass
        if (j + 1 < ntiles) {
            const uint32_t other = (stage ^ 1) * TILE * 2;
            mma::load_tile_async<DQ_KT, DH, NT>(k_tiles + other, kb, ks.n,
                                                (j + 1) * DQ_KT, NK, tid);
            mma::load_tile_async<DQ_KT, DH, NT>(v_tiles + other, vb, vs.n,
                                                (j + 1) * DQ_KT, NK, tid);
        }
        mma::cp_async_commit();  // possibly empty: keeps the group count even
        mma::cp_async_wait<1>();  // tile j has landed, tile j + 1 may fly
        __syncthreads();

        const uint32_t stage_bytes = stage * TILE * 2;
#pragma unroll 1
        for (int half = 0; half < DQ_KT / DQ_KH; ++half) {
            const uint32_t keys = stage_bytes + half * DQ_KH * LD * 2;
            // S and dP: 16 rows x DQ_KH keys, fragment jn holds keys
            // 8 jn .. 8 jn + 7 of this half
            float s[DQ_KH / 8][4], dp[DQ_KH / 8][4];
#pragma unroll
            for (int jn = 0; jn < DQ_KH / 8; ++jn)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    s[jn][e] = 0.f;
                    dp[jn][e] = 0.f;
                }
            tc_two_products<KD, DQ_KH, LD>(q_a, g_a, k_b + keys, v_b + keys, s, dp);

            tc_p_du_rows<DQ_KH>(s, dp, lse2, dl, j * DQ_KT + half * DQ_KH, NK, t);
            tc_dq_accumulate<KD, DQ_KH, LD>(dp, k_t + keys, acc);
        }
        __syncthreads();  // this stage may be refilled in the next pass
    }

    // dQ = Dh^-1/2 * dQ': rounded to bf16, scaled in fp32 and rounded again
    // (the TPU wrapper's two casts), staged through the warp's own q' rows
    // (no other warp ever read them), then written as 16-byte pieces of rows
    bf16* Qw = Qs + warp * 16 * LD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
        const int col = nd * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(&Qw[g * LD + col]) = mma::pack_bf16(
            round_to<bf16>(acc[nd][0]) * scale, round_to<bf16>(acc[nd][1]) * scale);
        *reinterpret_cast<uint32_t*>(&Qw[(g + 8) * LD + col]) = mma::pack_bf16(
            round_to<bf16>(acc[nd][2]) * scale, round_to<bf16>(acc[nd][3]) * scale);
    }
    __syncwarp();
    constexpr int CPR = DH / 8;
    for (int e = lane; e < 16 * CPR; e += 32) {
        const int r = e / CPR, c = e % CPR;
        const int n = q0 + warp * 16 + r;
        if (n >= NQ) continue;
        const long long at = (((long long)b * NQ + n) * H + h) * DH + c * 8;
        *reinterpret_cast<uint4*>(dq + at) =
            *reinterpret_cast<const uint4*>(&Qw[r * LD + c * 8]);
    }
}

// ----------------------------------------------- bfloat16, Dh above 128
//
// flash_bwd_dkv_wide_tc_kernel and flash_bwd_dq_wide_tc_kernel: the TPU's
// _dkv_kernel and _dq_kernel for Dh = 128 P, P >= 2, on Hopper's warpgroup
// products (wgmma.mma_async, see wgmma.cuh).
//
// Bound: operations. dkv does 8 B H Nq Nk Dh flops, dq 6 B H Nq Nk Dh, over
// the 989 TFLOP/s of bf16; P and dU enter dV, dK and dQ' as two bf16 terms
// (hi = bf16(x), lo = bf16(x - hi): 16 significant bits, which keeps the
// TPU's Precision.HIGHEST within the bars), so the products the card must
// issue are 1.5 times (dkv) and 4/3 times (dq) that.
//
// A block owns 64 keys (dkv) or 64 query rows (dq) of one (batch, head) and
// one chunk of CHUNK = 256 output columns (grid z; at Dh 384 the last chunk
// is 128 wide). It is 8 warps, two warpgroups; warpgroup w owns output
// columns 128 w .. 128 w + 127 of the chunk, with the Dh = 128 kernels'
// accumulators (dK and dV: 128 fp32 registers a thread; dQ': 64). What the
// design does about what held the earlier 128-column-chunk kernels back:
// * The logits once per tile pair. Each warpgroup computes S^T = K q'^T and
//   dP^T = V dO^T (dkv) or S = q' K^T and dP = dO V^T (dq) for its half of
//   the other side's 64 rows (m64n32k16, fp32), summed over all of Dh; P =
//   exp(S - lse) and dU = P o (dP - delta) stay fp32 in its registers and go
//   to shared memory as bf16 hi and lo tiles, which both warpgroups read as
//   the A operand of dV += P^T dO, dK += dU^T q' or dQ' += dU K
//   (m64n128k16, B read MN-major from the tile the logits read K-major).
//   At Dh 256 a tile pair costs 6 (dkv) or 4 (dq) units of one full-Dh
//   product, where the 128-column chunks issued 8 and 6.
// * Own rows staged once. K and V (dkv) or q' and dO (dq), the chunk's
//   columns, are copied once per block (64 KB at Dh 256). The other side
//   streams through a ring of two 64 KB slots of 64-row tiles: the copies
//   (cp.async) of slot u + 1 are issued while the logits of slot u run, one
//   block barrier a slot; lse and delta of a dkv tile arrive in the slot
//   beside it. Above Dh 256 the logits also need the columns outside the
//   chunk: those come as pieces of 128 columns, own rows and other side
//   together in a slot (the own rows' are re-read from L2, the chunk's
//   never), before the slot that holds the tile's chunk. L2 -> shared bytes
//   a launch at (8, 6400, 1, 256): dkv 800 blocks x (64 KB + 100 tiles x
//   64.5 KB) = 5.3 GB, dq 5.3 GB, against 31.5 GB each for the 128-column
//   chunks (1600 blocks x 400 pieces x 48 KB).
// * 64-row tiles on wgmma. A product is one warpgroup instruction over 64
//   rows and 32 or 128 columns; the operands are read from shared memory
//   in the 128-byte swizzle, without ldmatrix. Two barriers a tile at Dh
//   256 (one more for each piece above).
// Shared memory: own rows 64 KB, two slots 128 KB, P and dU tiles 32 KB
// (dkv; dq: dU 16 KB), lse and delta 1 KB, and 1 KB to align the swizzle:
// 226 KB (dkv) and 209 KB (dq), one block an SM.
// Measured at (8, 6400, 1, 256) on an H100 SXM at 700 W
// (scripts/probe_torch_flash_wide_bwd.py): dkv 2.6 ms, dq 1.8 ms, 2.5 and 2.6
// times the bound with the split. Leaving one phase out saves 0.44 / 0.35 ms
// (copies), 0.59 / 0.57 (logits), 0.23 / 0.11 (P and dU stores) and 0.61 /
// 0.26 (dV, dK, dQ'): the two warpgroups work in step, so the phases add up,
// and the logits' m64n32 products read 3 KB of shared memory per 32 K
// multiply-adds. Overlapping them (a producer warp, warpgroups a tile
// apart) is what is left.
// Numerics are those of the Dh <= 128 kernels: q' = round(q Dh^-1/2) made
// in shared memory by the threads that copied it, P = ex2.approx(S log2 e -
// lse log2 e), the two-term split, dQ' rounded, times Dh^-1/2, rounded.
// Rows beyond N are zero-filled: a query row beyond Nq has q' = dO = 0 and
// lse = delta = 0 (P = 1 times zeros); a key beyond Nk gets P = 0 in dq and
// feeds only its own, unstored, dK and dV rows in dkv. No atomics: every
// output element is summed by one thread in a fixed order.
namespace wide {

constexpr int ROWS = 64;          // own rows of a block; rows of a tile of the other side
constexpr int CHUNK = 256;        // output columns of a block
constexpr int PIECE = 128;        // columns of a piece outside the chunk
constexpr int THREADS = 256;      // two warpgroups
constexpr uint32_t BB = wgmma::BLOCK_BYTES;
constexpr uint32_t OWN_BYTES = 8 * BB;    // two tensors x CHUNK columns
constexpr uint32_t SLOT_BYTES = 8 * BB;   // the same, or four tensors x PIECE columns
constexpr uint32_t STATS_BYTES = 2 * ROWS * 4;
constexpr uint32_t ALIGN = 1024;          // the swizzle repeats every 1024 bytes
constexpr uint32_t OWN = 0, SLOTS = OWN_BYTES, TILES = SLOTS + 2 * SLOT_BYTES;
constexpr size_t dkv_smem_bytes = ALIGN + TILES + 4 * BB + 2 * STATS_BYTES;
constexpr size_t dq_smem_bytes = ALIGN + TILES + 2 * BB;
constexpr int STAGE_LD = CHUNK + mma::PAD;   // pitch of the output staging rows

// A block's chunk, and the pieces of the other columns in the order they
// are streamed (ascending, the chunk skipped); a tile of the other side is
// `units` slots: the pieces, then the chunk.
struct Chunk {
    int c0, width, nb, pieces, units;
    __device__ Chunk(int chunk, int DH)
        : c0(chunk * CHUNK), width(min(CHUNK, DH - chunk * CHUNK)),
          nb(width / wgmma::BLOCK_COLS), pieces((DH - width) / PIECE),
          units(pieces + 1) {}
    __device__ int piece_col(int p) const { return p * PIECE < c0 ? p * PIECE : p * PIECE + width; }
};

// The 1024-byte-aligned shared window: (shared byte address, generic pointer).
struct Smem {
    uint32_t addr;
    unsigned char* ptr;
};
__device__ __forceinline__ Smem aligned_smem(unsigned char* raw) {
    const uint32_t a = mma::smem_addr(raw);
    const uint32_t off = ((a + ALIGN - 1) & ~(ALIGN - 1)) - a;
    return Smem{a + off, raw + off};
}

// Issues c0 += A0 B0^T and c1 += A1 B1^T over nb 64-column blocks
// (K-major): A0, A1 64 rows; B0, B1 the warpgroup's 32 rows, from row
// 32 wg. With `first` the sums start from zero (the products' scale-d, no
// register writes). wait_logits() waits for them.
__device__ __forceinline__ void issue_logits(float (&c0)[4][4], float (&c1)[4][4],
                                             uint32_t a0, uint32_t b0, uint32_t a1,
                                             uint32_t b1, int nb, int wg, bool first) {
    b0 += wg * 32 * 128;
    b1 += wg * 32 * 128;
    wgmma::fence_operand(c0);
    wgmma::fence_operand(c1);
    wgmma::fence();
#pragma unroll 1
    for (int i = 0; i < nb; ++i)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const uint32_t off = i * BB + s * 32;
            const int keep = !first || i > 0 || s > 0;
            wgmma::m64n32k16(c0, wgmma::desc_k(a0 + off), wgmma::desc_k(b0 + off), keep);
            wgmma::m64n32k16(c1, wgmma::desc_k(a1 + off), wgmma::desc_k(b1 + off), keep);
        }
    wgmma::commit();
}

__device__ __forceinline__ void wait_logits(float (&c0)[4][4], float (&c1)[4][4]) {
    wgmma::wait<0>();
    wgmma::fence_operand(c0);
    wgmma::fence_operand(c1);
}

// acc += (hi + lo) B over 64 rows of depth: hi and lo [64][64] tiles
// (K-major) at a and a + BB, B two blocks (128 columns, MN-major) at b.
// Issues; the caller commits and waits.
__device__ __forceinline__ void accumulate(float (&acc)[16][4], uint32_t a, uint32_t b) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        const uint64_t bd = wgmma::desc_mn(b + s * 16 * 128);
        wgmma::m64n128k16_mn(acc, wgmma::desc_k(a + s * 32), bd);
        wgmma::m64n128k16_mn(acc, wgmma::desc_k(a + BB + s * 32), bd);
    }
}

// Rows (r, r + 8) of a fragment x[0..1], x[2..3] as bf16 hi and lo terms
// into the [64][64] tiles at `hi` and `hi + BB`, column c.
__device__ __forceinline__ void store_split(unsigned char* hi, const float (&x)[4], int r,
                                            int c) {
    uint32_t h, l;
    mma::split_bf16(x[0], x[1], h, l);
    *reinterpret_cast<uint32_t*>(hi + wgmma::swizzled(r, c)) = h;
    *reinterpret_cast<uint32_t*>(hi + BB + wgmma::swizzled(r, c)) = l;
    mma::split_bf16(x[2], x[3], h, l);
    *reinterpret_cast<uint32_t*>(hi + wgmma::swizzled(r + 8, c)) = h;
    *reinterpret_cast<uint32_t*>(hi + BB + wgmma::swizzled(r + 8, c)) = l;
}

// The warpgroup's 64 x 128 accumulator, rounded (ROUND2: to bf16, times
// scale, to bf16 again), into row-major staging rows of pitch STAGE_LD.
template <bool ROUND2>
__device__ __forceinline__ void stage_rows(bf16* st, const float (&acc)[16][4], int r,
                                           int col, int t, float scale) {
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
        const int c = col + jn * 8 + 2 * t;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            x[e] = ROUND2 ? round_to<bf16>(acc[jn][e]) * scale : acc[jn][e];
        *reinterpret_cast<uint32_t*>(&st[r * STAGE_LD + c]) = mma::pack_bf16(x[0], x[1]);
        *reinterpret_cast<uint32_t*>(&st[(r + 8) * STAGE_LD + c]) = mma::pack_bf16(x[2], x[3]);
    }
}

// Staged rows [64][width] to a contiguous (B, N, H, DH) output, 16 bytes a
// thread, rows from row0 below N only.
__device__ __forceinline__ void write_rows(bf16* out, const bf16* st, int b, int h, int H,
                                           int N, int DH, int row0, int c0, int width,
                                           int tid) {
    const int cpr = width / 8;
    for (int e = tid; e < ROWS * cpr; e += THREADS) {
        const int r = e / cpr, c = e % cpr;
        const int n = row0 + r;
        if (n >= N) continue;
        const long long at = (((long long)b * N + n) * H + h) * DH + c0 + c * 8;
        *reinterpret_cast<uint4*>(out + at) =
            *reinterpret_cast<const uint4*>(&st[r * STAGE_LD + c * 8]);
    }
}

}  // namespace wide

__global__ void __launch_bounds__(wide::THREADS, 1)
flash_bwd_dkv_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int NQ, int NK, int H, int DH,
                             Strides qs, Strides ks, Strides vs, Strides gs,
                             float scale) {
    using namespace wide;
    // own: K blocks 0-3, V 4-7; a slot: the tile's q' 0-3 and dO 4-7, or a
    // piece's K 0-1, V 2-3, q' 4-5, dO 6-7; tiles: P hi, P lo, dU hi, dU lo
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Smem sm = aligned_smem(smem_raw);
    const uint32_t own = sm.addr + OWN, slots = sm.addr + SLOTS, tiles = sm.addr + TILES;
    const uint32_t stats = tiles + 4 * BB;

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int r0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);  // fragment row
    const int t = tid & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int k0 = blockIdx.x * ROWS;
    const Chunk ch(blockIdx.z, DH);

    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;
    const bf16* gb = dout + b * gs.b + h * gs.h;
    const float* lse_row = lse + (long long)bh * NQ;
    const float* delta_row = delta + (long long)bh * NQ;

    const int ntiles = (NQ + ROWS - 1) / ROWS;
    const int total = ntiles * ch.units;
    auto load_unit = [&](int u) {
        const int j = u / ch.units, p = u % ch.units;
        const uint32_t slot = slots + (u & 1) * SLOT_BYTES;
        if (p < ch.pieces) {
            const int col = ch.piece_col(p);
            wgmma::load_blocks(slot, kb, ks.n, k0, NK, col, 2, tid);
            wgmma::load_blocks(slot + 2 * BB, vb, vs.n, k0, NK, col, 2, tid);
            wgmma::load_blocks(slot + 4 * BB, qb, qs.n, j * ROWS, NQ, col, 2, tid);
            wgmma::load_blocks(slot + 6 * BB, gb, gs.n, j * ROWS, NQ, col, 2, tid);
            return;
        }
        wgmma::load_blocks(slot, qb, qs.n, j * ROWS, NQ, ch.c0, ch.nb, tid);
        wgmma::load_blocks(slot + 4 * BB, gb, gs.n, j * ROWS, NQ, ch.c0, ch.nb, tid);
        if (tid < 2 * ROWS) {
            const int n = j * ROWS + (tid & (ROWS - 1));
            const bool ok = n < NQ;
            const float* src = (tid < ROWS ? lse_row : delta_row) + (ok ? n : 0);
            mma::cp_async_4_zfill(stats + (u & 1) * STATS_BYTES + tid * 4, src, ok);
        }
    };
    wgmma::load_blocks(own, kb, ks.n, k0, NK, ch.c0, ch.nb, tid);
    wgmma::load_blocks(own + 4 * BB, vb, vs.n, k0, NK, ch.c0, ch.nb, tid);
    load_unit(0);
    mma::cp_async_commit();

    float acc_dk[16][4], acc_dv[16][4], sT[4][4], dpT[4][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.f;

    int u = 0;  // slot of the stream: tile j, piece p
    for (int j = 0; j < ntiles; ++j) {
        uint32_t slot = slots;
        for (int p = 0; p <= ch.pieces; ++p, ++u) {
            const bool chunk_slot = p == ch.pieces;
            slot = slots + (u & 1) * SLOT_BYTES;
            mma::cp_async_wait<0>();  // slot u (and on the first pass the own rows) landed
            wgmma::scale_blocks(sm.ptr + (slot - sm.addr) + (chunk_slot ? 0 : 4 * BB),
                                chunk_slot ? ch.nb : 2, scale, tid);
            wgmma::wait<0>();  // the last tile's dV and dK products, which read slot u - 1
            wgmma::fence_operand(acc_dv);
            wgmma::fence_operand(acc_dk);
            wgmma::fence_proxy_async();
            __syncthreads();  // ... for all; slot u - 1's readers are done
            // S^T = K q'^T, dP^T = V dO^T: the chunk's columns from the own
            // rows and the tile, or a piece's from the slot alone; slot u + 1
            // is copied into slot u - 1 while they run
            issue_logits(sT, dpT, chunk_slot ? own : slot, chunk_slot ? slot : slot + 4 * BB,
                         chunk_slot ? own + 4 * BB : slot + 2 * BB,
                         slot + (chunk_slot ? 4 : 6) * BB, chunk_slot ? ch.nb : 2, wg, p == 0);
            if (u + 1 < total) load_unit(u + 1);
            mma::cp_async_commit();
            wait_logits(sT, dpT);
        }

        // P^T = exp(S^T - lse), dU^T = P^T o (dP^T - delta): rows are keys,
        // columns the warpgroup's queries 32 wg + 8 jn + 2 t (+1). They go to
        // registers of their own: only the products write the accumulators (a
        // first version that wrote them here and zeroed them under a branch
        // had its products serialized by ptxas, warning C7520).
        const float* st = reinterpret_cast<const float*>(sm.ptr + (stats - sm.addr) +
                                                         ((u - 1) & 1) * STATS_BYTES);
        unsigned char* tp = sm.ptr + (tiles - sm.addr);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
            const int c = 32 * wg + 8 * jn + 2 * t;
            const float2 l = *reinterpret_cast<const float2*>(st + c);
            const float2 dl = *reinterpret_cast<const float2*>(st + ROWS + c);
            const float l0 = l.x * mma::LOG2E, l1 = l.y * mma::LOG2E;
            float pv[4], du[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                pv[e] = mma::fast_exp2(fmaf(sT[jn][e], mma::LOG2E, (e & 1) ? -l1 : -l0));
                du[e] = pv[e] * (dpT[jn][e] - ((e & 1) ? dl.y : dl.x));
            }
            store_split(tp, pv, r0, c);
            store_split(tp + 2 * BB, du, r0, c);
        }
        wgmma::fence_proxy_async();
        __syncthreads();  // both halves of P and dU are in place

        // dV += P^T dO and dK += dU^T q' over the warpgroup's 128 columns
        // (at a chunk 128 wide the second warpgroup's are not stored)
        wgmma::fence_operand(acc_dv);
        wgmma::fence_operand(acc_dk);
        wgmma::fence();
        accumulate(acc_dv, tiles, slot + (4 + 2 * wg) * BB);
        accumulate(acc_dk, tiles + 2 * BB, slot + 2 * wg * BB);
        wgmma::commit();  // waited for at the next slot, while its copies land
    }
    wgmma::wait<0>();
    wgmma::fence_operand(acc_dv);
    wgmma::fence_operand(acc_dk);

    // dk and dv, rounded once, staged through the slots (every product and
    // copy is done), then written 16 bytes a thread
    __syncthreads();
    bf16* st_k = reinterpret_cast<bf16*>(sm.ptr + SLOTS);
    bf16* st_v = st_k + ROWS * STAGE_LD;
    if (wg * 128 < ch.width) {
        stage_rows<false>(st_k, acc_dk, r0, 128 * wg, t, 1.f);
        stage_rows<false>(st_v, acc_dv, r0, 128 * wg, t, 1.f);
    }
    __syncthreads();
    write_rows(dk, st_k, b, h, H, NK, DH, k0, ch.c0, ch.width, tid);
    write_rows(dv, st_v, b, h, H, NK, DH, k0, ch.c0, ch.width, tid);
}

__global__ void __launch_bounds__(wide::THREADS, 1)
flash_bwd_dq_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, bf16* __restrict__ dq,
                            int NQ, int NK, int H, int DH, Strides qs, Strides ks,
                            Strides vs, Strides gs, float scale) {
    using namespace wide;
    // own: q' blocks 0-3, dO 4-7; a slot: the tile's K 0-3 and V 4-7, or a
    // piece's q' 0-1, dO 2-3, K 4-5, V 6-7; tiles: dU hi, dU lo
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Smem sm = aligned_smem(smem_raw);
    const uint32_t own = sm.addr + OWN, slots = sm.addr + SLOTS, tiles = sm.addr + TILES;

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int r0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
    const int t = tid & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int q0 = blockIdx.x * ROWS;
    const Chunk ch(blockIdx.z, DH);

    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;
    const bf16* gb = dout + b * gs.b + h * gs.h;

    const int ntiles = (NK + ROWS - 1) / ROWS;
    const int total = ntiles * ch.units;
    auto load_unit = [&](int u) {
        const int j = u / ch.units, p = u % ch.units;
        const uint32_t slot = slots + (u & 1) * SLOT_BYTES;
        if (p < ch.pieces) {
            const int col = ch.piece_col(p);
            wgmma::load_blocks(slot, qb, qs.n, q0, NQ, col, 2, tid);
            wgmma::load_blocks(slot + 2 * BB, gb, gs.n, q0, NQ, col, 2, tid);
            wgmma::load_blocks(slot + 4 * BB, kb, ks.n, j * ROWS, NK, col, 2, tid);
            wgmma::load_blocks(slot + 6 * BB, vb, vs.n, j * ROWS, NK, col, 2, tid);
            return;
        }
        wgmma::load_blocks(slot, kb, ks.n, j * ROWS, NK, ch.c0, ch.nb, tid);
        wgmma::load_blocks(slot + 4 * BB, vb, vs.n, j * ROWS, NK, ch.c0, ch.nb, tid);
    };
    wgmma::load_blocks(own, qb, qs.n, q0, NQ, ch.c0, ch.nb, tid);
    wgmma::load_blocks(own + 4 * BB, gb, gs.n, q0, NQ, ch.c0, ch.nb, tid);
    load_unit(0);
    mma::cp_async_commit();

    // lse * log2(e) and delta of the fragment's rows r0 and r0 + 8 (0 beyond NQ)
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int n = q0 + r0 + 8 * i;
        const bool ok = n < NQ;
        lse2[i] = ok ? lse[(long long)bh * NQ + n] * mma::LOG2E : 0.f;
        dl[i] = ok ? delta[(long long)bh * NQ + n] : 0.f;
    }

    float acc[16][4], s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

    int u = 0;
    for (int j = 0; j < ntiles; ++j) {
        uint32_t slot = slots;
        for (int p = 0; p <= ch.pieces; ++p, ++u) {
            const bool chunk_slot = p == ch.pieces;
            slot = slots + (u & 1) * SLOT_BYTES;
            mma::cp_async_wait<0>();
            if (u == 0) wgmma::scale_blocks(sm.ptr + OWN, ch.nb, scale, tid);
            if (!chunk_slot) wgmma::scale_blocks(sm.ptr + (slot - sm.addr), 2, scale, tid);
            wgmma::wait<0>();  // the last tile's dQ' products, which read slot u - 1
            wgmma::fence_operand(acc);
            wgmma::fence_proxy_async();
            __syncthreads();
            // S = q' K^T, dP = dO V^T: the chunk's columns from the own rows
            // and the tile, or a piece's from the slot alone; slot u + 1 is
            // copied while they run
            issue_logits(s, dp, chunk_slot ? own : slot, chunk_slot ? slot : slot + 4 * BB,
                         chunk_slot ? own + 4 * BB : slot + 2 * BB,
                         slot + (chunk_slot ? 4 : 6) * BB, chunk_slot ? ch.nb : 2, wg, p == 0);
            if (u + 1 < total) load_unit(u + 1);
            mma::cp_async_commit();
            wait_logits(s, dp);
        }

        // dU = P o (dP - delta): rows are the block's queries, columns the
        // warpgroup's keys j * 64 + 32 wg + 8 jn + 2 t (+1); a key beyond NK
        // gets P = 0
        const int key0 = j * ROWS + 32 * wg;
        unsigned char* tp = sm.ptr + (tiles - sm.addr);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
            float du[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float pv = mma::fast_exp2(fmaf(s[jn][e], mma::LOG2E, -lse2[e >> 1]));
                if (key0 + 8 * jn + 2 * t + (e & 1) >= NK) pv = 0.f;
                du[e] = pv * (dp[jn][e] - dl[e >> 1]);
            }
            store_split(tp, du, r0, 32 * wg + 8 * jn + 2 * t);
        }
        wgmma::fence_proxy_async();
        __syncthreads();

        // dQ' += dU K over the warpgroup's 128 columns
        wgmma::fence_operand(acc);
        wgmma::fence();
        accumulate(acc, tiles, slot + 2 * wg * BB);
        wgmma::commit();  // waited for at the next slot
    }
    wgmma::wait<0>();
    wgmma::fence_operand(acc);

    // dQ = Dh^-1/2 * dQ' (two roundings), staged through the slots
    __syncthreads();
    bf16* st_q = reinterpret_cast<bf16*>(sm.ptr + SLOTS);
    if (wg * 128 < ch.width) stage_rows<true>(st_q, acc, r0, 128 * wg, t, scale);
    __syncthreads();
    write_rows(dq, st_q, b, h, H, NQ, DH, q0, ch.c0, ch.width, tid);
}

struct Args {
    const void *q, *k, *v, *dout;
    const float *lse, *delta;
    int B, NQ, NK, H;
    Strides qs, ks, vs, gs;
    float scale;
    cudaStream_t stream;
};

template <typename Kernel>
int raise_smem_limit(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
int launch_dkv_fma(const Args& a, void* dk, void* dv) {
    auto kernel = flash_attn_bwd_dkv_kernel<float, DH>;
    constexpr size_t smem = dkv_smem_bytes<DH>();
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const dim3 grid((unsigned)((a.NK + BK - 1) / BK), (unsigned)(a.B * a.H));
    kernel<<<grid, NT, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.NQ,
        a.NK, a.H, a.qs, a.ks, a.vs, a.gs, a.scale);
    return (int)cudaGetLastError();
}

template <int DH, int NWARPS>
int launch_dkv_tc(const Args& a, void* dk, void* dv) {
    auto kernel = flash_bwd_dkv_tc_kernel<DH, NWARPS>;
    constexpr size_t smem = dkv_tc_smem_bytes<DH, NWARPS>();
    constexpr int BKT = 16 * NWARPS;
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const dim3 grid((unsigned)((a.NK + BKT - 1) / BKT), (unsigned)(a.B * a.H));
    kernel<<<grid, NWARPS * 32, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
        a.delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.NQ, a.NK, a.H,
        a.qs, a.ks, a.vs, a.gs, a.scale);
    return (int)cudaGetLastError();
}

template <int DH>
int launch_dq_fma(const Args& a, void* dq) {
    auto kernel = flash_attn_bwd_dq_kernel<float, DH>;
    constexpr size_t smem = dq_smem_bytes<DH>();
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const dim3 grid((unsigned)((a.NQ + BQ - 1) / BQ), (unsigned)(a.B * a.H));
    kernel<<<grid, NT, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(dq), a.NQ, a.NK, a.H, a.qs, a.ks, a.vs,
        a.gs, a.scale);
    return (int)cudaGetLastError();
}

template <int DH>
int launch_dq_tc(const Args& a, void* dq) {
    auto kernel = flash_bwd_dq_tc_kernel<DH>;
    constexpr size_t smem = dq_tc_smem_bytes<DH>();
    constexpr int BQT = 16 * TC_WARPS;
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const dim3 grid((unsigned)((a.NQ + BQT - 1) / BQT), (unsigned)(a.B * a.H));
    kernel<<<grid, TC_WARPS * 32, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
        a.delta, static_cast<bf16*>(dq), a.NQ, a.NK, a.H, a.qs, a.ks, a.vs, a.gs,
        a.scale);
    return (int)cudaGetLastError();
}

// Above 128 (a multiple of WIDE): a block per (64 keys or query rows,
// (batch, head), chunk of `chunk` output columns); `rows` is NK for dkv, NQ
// for dq.
template <typename T, typename Kernel, typename... Outs>
int launch_wide(Kernel kernel, size_t smem, int threads, int chunk, int rows,
                const Args& a, int Dh, Outs... outs) {
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const dim3 grid((unsigned)((rows + 63) / 64), (unsigned)(a.B * a.H),
                    (unsigned)((Dh + chunk - 1) / chunk));
    kernel<<<grid, threads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
        static_cast<T*>(outs)..., a.NQ, a.NK, a.H, Dh, a.qs, a.ks, a.vs, a.gs,
        a.scale);
    return (int)cudaGetLastError();
}

bool wide_head_dim(int Dh) { return Dh > WIDE && Dh % WIDE == 0; }

// float32: the FMA kernel, BK keys per block.
int dispatch_dkv_fma(int Dh, const Args& a, void* dk, void* dv) {
    switch (Dh) {
        case 32: return launch_dkv_fma<32>(a, dk, dv);
        case 64: return launch_dkv_fma<64>(a, dk, dv);
        case 128: return launch_dkv_fma<128>(a, dk, dv);
    }
    if (wide_head_dim(Dh))
        return launch_wide<float>(flash_attn_bwd_dkv_wide_kernel<float>,
                                  dkv_smem_bytes<WIDE>(), NT, WIDE, a.NK, a, Dh, dk, dv);
    return (int)cudaErrorInvalidValue;
}

// bfloat16: the tensor-core kernel, TC_WARPS warps of 16 keys per block.
int dispatch_dkv_tc(int Dh, const Args& a, void* dk, void* dv) {
    switch (Dh) {
        case 32: return launch_dkv_tc<32, TC_WARPS>(a, dk, dv);
        case 64: return launch_dkv_tc<64, TC_WARPS>(a, dk, dv);
        case 128: return launch_dkv_tc<128, TC_WARPS>(a, dk, dv);
    }
    if (wide_head_dim(Dh))
        return launch_wide<bf16>(flash_bwd_dkv_wide_tc_kernel, wide::dkv_smem_bytes,
                                 wide::THREADS, wide::CHUNK, a.NK, a, Dh, dk, dv);
    return (int)cudaErrorInvalidValue;
}

// float32: the FMA kernel, BQ query rows per block.
int dispatch_dq_fma(int Dh, const Args& a, void* dq) {
    switch (Dh) {
        case 32: return launch_dq_fma<32>(a, dq);
        case 64: return launch_dq_fma<64>(a, dq);
        case 128: return launch_dq_fma<128>(a, dq);
    }
    if (wide_head_dim(Dh))
        return launch_wide<float>(flash_attn_bwd_dq_wide_kernel<float>,
                                  dq_smem_bytes<WIDE>(), NT, WIDE, a.NQ, a, Dh, dq);
    return (int)cudaErrorInvalidValue;
}

// bfloat16: the tensor-core kernel, TC_WARPS warps of 16 query rows per block.
int dispatch_dq_tc(int Dh, const Args& a, void* dq) {
    switch (Dh) {
        case 32: return launch_dq_tc<32>(a, dq);
        case 64: return launch_dq_tc<64>(a, dq);
        case 128: return launch_dq_tc<128>(a, dq);
    }
    if (wide_head_dim(Dh))
        return launch_wide<bf16>(flash_bwd_dq_wide_tc_kernel, wide::dq_smem_bytes,
                                 wide::THREADS, wide::CHUNK, a.NQ, a, Dh, dq);
    return (int)cudaErrorInvalidValue;
}

// strides: 12 values in elements, (batch, token, head) of q, k, v and dout.
Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int N, int Nk,
               int H, const long long* strides, double scale, void* stream) {
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.dout = dout;
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.B = B;
    a.NQ = N;
    a.NK = Nk;
    a.H = H;
    a.qs = Strides{strides[0], strides[1], strides[2]};
    a.ks = Strides{strides[3], strides[4], strides[5]};
    a.vs = Strides{strides[6], strides[7], strides[8]};
    a.gs = Strides{strides[9], strides[10], strides[11]};
    a.scale = (float)scale;
    a.stream = static_cast<cudaStream_t>(stream);
    return a;
}

}  // namespace

// q and dout: (B, N, H, Dh), k and v: (B, Nk, H, Dh), of one type, read
// through the (batch, token, head) strides in `strides` (a host array of 12
// values in elements: q, k, v, dout), last dimension contiguous; in bfloat16
// every row start must be 16-byte aligned. lse, delta: contiguous fp32
// (B*H, N), the forward's logsumexp and rowsum(dO o O). dk, dv: contiguous
// (B, Nk, H, Dh), dq: contiguous (B, N, H, Dh), of the input type. Dh: 32,
// 64, 128 or a multiple of 128 (the wrapper zero-pads the others). A block
// owns 64 keys (dkv) or 64 query rows (dq) in either type, and above
// Dh = 128 one chunk of output columns: 128 in float32, 256 in bfloat16
// (the last 128 wide where Dh is an odd multiple of 128). Both entries
// choose their kernel by dtype, here: float32 runs the FMA kernel, bfloat16
// the tensor-core kernel; neither stands in for the other.
// Each entry returns the cudaError_t of its launch (0 on success); launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int dtype, int B, int N, int Nk, int H,
                                  int Dh,
                                  const long long* strides, double scale,
                                  void* stream) {
    const Args a = make_args(q, k, v, dout, lse, delta, B, N, Nk, H, strides,
                             scale, stream);
    if (dtype == MRI_DTYPE_F32) return dispatch_dkv_fma(Dh, a, dk, dv);
    if (dtype == MRI_DTYPE_BF16) return dispatch_dkv_tc(Dh, a, dk, dv);
    return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int dtype, int B,
                                 int N, int Nk, int H, int Dh,
                                 const long long* strides, double scale,
                                 void* stream) {
    const Args a = make_args(q, k, v, dout, lse, delta, B, N, Nk, H, strides,
                             scale, stream);
    if (dtype == MRI_DTYPE_F32) return dispatch_dq_fma(Dh, a, dq);
    if (dtype == MRI_DTYPE_BF16) return dispatch_dq_tc(Dh, a, dq);
    return (int)cudaErrorInvalidValue;
}
