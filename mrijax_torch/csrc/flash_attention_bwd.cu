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
// The bfloat16 notes below are of the kernels for Dh = 32, 64 and 128; above
// 128 bf16 has column-chunk kernels of its own ("bfloat16, Dh above 128",
// warpgroup products, wgmma.cuh, further down). The float32 kernel (notes
// after the bf16 ones) takes every head dim.
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
// flash_attn_bwd_dkv and flash_attn_bwd_dq, float32 -> flash_bwd_f32_kernel
// (namespace f32), one kernel for both, on Hopper's warpgroup products:
// * What bounds it: operations. The TPU kernels run fp32 at
//   Precision.HIGHEST (six bf16 passes on the matrix unit); here every
//   product is three TF32 passes on wgmma (k = 8): x = hi + lo with hi = x
//   truncated to TF32 (13 low mantissa bits cleared) and lo = x - hi, of
//   which the tensor cores read the TF32 part (x to 2^-20), and A B = hi_a
//   hi_b + hi_a lo_b + lo_a hi_b, the lo lo term (2^-20 relative) dropped.
//   That is fp32-grade work at 495 / 3 = 165 TFLOP/s, against 67 on the CUDA
//   cores. One TF32 pass (2^-10 relative) misses the 1e-4 bar dk, dv and dq
//   are held to (tests/test_torch_flash_f32_tensorcore.py emulates both).
//   On the card the integer and float work around the products (splitting
//   fragments, their addresses, P and dU) weighs as much as the products:
//   rounding hi and lo with cvt.rna.tf32 instead of a bit mask made both
//   kernels about 20 % slower.
// * For 32-bit types wgmma reads no operand transposed from shared memory:
//   both must be K-major (the summed index along the row). So every product
//   takes its A operand from registers, where a fragment can be read in any
//   order, and its B operand from tiles written K-major by the threads that
//   make them. The block owns OWN = 32 rows (keys in dkv, query rows in dq)
//   and streams the other side in tiles of 64 rows (query rows, keys):
//     logits  S = X1 O1^T, dP = X2 O2^T   (M: the tile's 64 rows, N: own 32)
//     dkv     dV^T += dO^T P, dK^T += q'^T dU   (M: 64 columns of Dh)
//     dq      dQ'^T += K^T dU^T               (M: 64 columns of Dh)
//   with X1, X2 = q', dO (dkv) or K, V (dq) and O1, O2 = K, V or q', dO.
//   The tile's rows come raw (cp.async, 4 bytes an element) and are split
//   into tf32 terms in registers as each A fragment is read, rows for the
//   logits, columns for the transposed products; the own rows are split once
//   into hi and lo tiles (B of the logits), P and dU into hi and lo tiles
//   [own][tile row] (B of the other products). Outputs are accumulated
//   transposed (rows: columns of Dh) and written 8 bytes a thread.
// * Two warpgroups: the first computes S, the second dP; they trade halves
//   through shared memory and each makes P and dU of 16 own columns; then
//   both accumulate, each its 64 columns of dV and dK or dQ' (at Dh 64 and
//   32 one takes dV, the other dK). A tile slot is copied while the one
//   before it is multiplied (a ring of two).
// * Inside a group of 8 the summed index of a B tile is stored evens first
//   (2i at i, 2i + 1 at 4 + i), the order in which the A fragment (k = t,
//   t + 4) takes it, so a thread reads each A pair with one 8-byte load; the
//   transposed fragments take columns 2g, 2g + 1 as rows g, g + 8 of the
//   warp, so the results' columns are paired too. Shared tiles are rows of
//   128 bytes (32 floats) in the 128-byte swizzle: no bank conflicts beyond
//   two wavefronts a warp.
// * Dh 32, 64, 128 in one piece: the own rows' terms (64 KB at 128) stay for
//   the whole block, a slot holds the tile's two tensors (64 KB), the P and
//   dU terms 32 KB (dq: dU's, 16 KB), dkv's lse and delta of two tiles 1 KB:
//   226 KB (dq 209 KB), one block an SM. Above 128 (a multiple of 128) a
//   tile comes in Dh / 64 units of 64 logit columns, then in units of the
//   block's output columns for the transposed products. At Dh 256 the own
//   rows' terms stay for the block (128 KB) and a unit carries the tile
//   alone (32 KB: dkv's accumulating units 64 columns of both tensors, dq's
//   128 of K). Above that the own rows' terms do not fit: a block owns a
//   chunk of 256 output columns (grid z; 128 where Dh is an odd multiple of
//   128), a logit unit carries the own rows' 64 columns too, split anew
//   into one of two buffers, an accumulating unit 128 columns, and every
//   chunk recomputes the logits (twice at Dh 512). Cutting each phase out
//   in turn (scripts/probe_torch_flash_f32_bwd.py) shows them adding up:
//   copies, logits, P and dU, products, none hidden behind another.
// * P = 2^(S log2 e - lse log2 e) on the special-function unit (2^-22
//   relative); rows or keys beyond N give P = 0. dq: dQ' times Dh^-1/2 in
//   fp32 (the TPU wrapper's two casts are identities in
//   fp32). No atomics: every output element is summed by one thread in a
//   fixed order, so launches agree bit for bit.

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"
#include "tf32.cuh"

namespace {

struct Strides {
    long long b, n, h;  // in elements; the last dimension has stride 1
};

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

// ---------------------------------------------------------------- float32
//
// flash_bwd_f32_kernel: the design notes at the top of the file.
namespace f32 {

using namespace tf32;   // TILE: rows of a tile of the other side; THREADS, ROW

constexpr int OWN = 32;          // own rows of a block: keys (dkv), query rows (dq)
constexpr int PIECE = 64;        // logit columns of a unit above Dh 128
constexpr int CHUNK = 128;       // output columns of an accumulating unit above Dh 128
constexpr uint32_t TERM = OWN * TILE * 4;   // a P or dU term, [own][tile row]

// Shared memory of one instance (DH = 0: above 128, but 256), in bytes from
// a 1024-byte boundary: the own rows' terms (DH = 0: two buffers of a
// piece's), the P and dU terms, two slots, dkv's lse and delta of two tiles.
template <bool DKV, int DH>
struct Layout {
    static constexpr int W = DH && DH <= 128 ? DH : PIECE;   // logit columns of a unit
    static constexpr uint32_t own_t = OWN * (DH ? DH : PIECE) * 4;   // one own term
    static constexpr uint32_t x_t = TILE * W * 4;      // one tensor of a tile's unit
    static constexpr uint32_t slot = DH ? 2 * x_t : 2 * TILE * CHUNK * 4;
    static constexpr uint32_t own = 0, tiles = 4 * own_t * (DH ? 1 : 2);
    static constexpr uint32_t slots = tiles + (DKV ? 4 : 2) * TERM;
    static constexpr uint32_t stat = slots + 2 * slot;
    static constexpr size_t bytes = 1024 + stat + (DKV ? 2 * 2 * TILE * 4 : 0);
};

// c = (first ? 0 : c) + (x times mul) O^T over W columns: x the tile's rows
// r, r + 8 (raw), O's hi and lo terms (OWN rows, blocks of 32 columns) at
// bhi, blo. BATCH k-steps a batch, the next batch's fragments made while the
// last one's products run.
template <int W, int BATCH>
__device__ __forceinline__ void logits(float (&c)[4][4], const unsigned char* x, float mul,
                                       uint32_t bhi, uint32_t blo, int r, int t, bool first) {
    constexpr int BATCHES = W / 8 / BATCH;
    Frag f[2][BATCH];
    wgmma::fence_operand(c);
#pragma unroll
    for (int bt = 0; bt < BATCHES; ++bt) {
#pragma unroll
        for (int s = 0; s < BATCH; ++s) frag_rows(f[bt & 1][s], x, r, bt * BATCH + s, t, mul);
        wgmma::fence();
#pragma unroll
        for (int s = 0; s < BATCH; ++s) {
            const int kk = bt * BATCH + s;
            const uint32_t off = (kk >> 2) * (OWN * ROW) + (kk & 3) * 32;
            mma3(c, f[bt & 1][s], bhi + off, blo + off, !first || kk > 0);
        }
        wgmma::commit();
        wgmma::wait<1>();
    }
    wgmma::wait<0>();
    wgmma::fence_operand(c);
}

// One transposed product of a warpgroup: A from the tile at x (times mul,
// columns d, d + 1), B the P or dU terms at hi, lo.
struct Item {
    const unsigned char* x;
    float mul;
    int d;
    uint32_t hi, lo;
};

// acc[i] += (item i's tile)^T (its terms) over the tile's 64 rows, BATCH
// k-steps a batch.
template <int NI, int BATCH>
__device__ __forceinline__ void accumulate_t(float (&acc)[NI][4][4], const Item (&it)[NI], int t) {
    constexpr int BATCHES = TILE / 8 / BATCH;
    Frag f[2][BATCH][NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) wgmma::fence_operand(acc[i]);
#pragma unroll
    for (int bt = 0; bt < BATCHES; ++bt) {
#pragma unroll
        for (int s = 0; s < BATCH; ++s)
#pragma unroll
            for (int i = 0; i < NI; ++i)
                frag_cols(f[bt & 1][s][i], it[i].x, it[i].d, bt * BATCH + s, t, it[i].mul);
        wgmma::fence();
#pragma unroll
        for (int s = 0; s < BATCH; ++s) {
            const int kk = bt * BATCH + s;
            const uint32_t off = (kk >> 2) * (OWN * ROW) + (kk & 3) * 32;
#pragma unroll
            for (int i = 0; i < NI; ++i)
                mma3(acc[i], f[bt & 1][s][i], it[i].hi + off, it[i].lo + off, 1);
        }
        wgmma::commit();
        wgmma::wait<1>();
    }
    wgmma::wait<0>();
#pragma unroll
    for (int i = 0; i < NI; ++i) wgmma::fence_operand(acc[i]);
}

}  // namespace f32

// DKV: dK and dV (out0, out1), else dQ (out0). DH: 32, 64 or 128 (CW =
// DH); 256 (CW = 256: the own rows' terms stay, the tile comes in pieces);
// or 0 for another multiple of 128 above it (Dh): a block then owns a chunk
// of CW = 128 or 256 output columns, one or two accumulating units a tile.
template <bool DKV, int DH, int CW>
__global__ void __launch_bounds__(f32::THREADS, 1)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ out0, float* __restrict__ out1, int NQ, int NK, int H,
                     int Dh, Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
    using namespace f32;
    constexpr bool RES = DH == 256;               // own terms resident, the tile in pieces
    constexpr bool WIDE = DH == 0 || RES;         // the tile in units of 64 logit columns
    constexpr int W = WIDE ? PIECE : DH;          // logit columns of a unit
    // output columns of an accumulating unit (at Dh 256 dkv's units carry
    // 64 columns of both tensors, dq's 128 of one)
    constexpr int CU = !WIDE ? DH : RES && DKV ? PIECE : CHUNK;
    constexpr int A = WIDE ? CW / CU : 1;         // accumulating units a tile
    constexpr int NI = DKV && CU == 128 ? 2 : 1;  // transposed products a warpgroup a unit
    // k-steps a batch: with several units' accumulators, two in the logits
    // and one in the transposed products (four and two spilled registers)
    constexpr int LB = A > 1 ? 2 : 4, AB = A > 1 ? 1 : 2;
    static_assert(WIDE ? CW == 128 || CW == 256 : CW == DH, "a chunk of 128 or 256 columns");
    using LY = Layout<DKV, DH>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const wide::Smem sm = wide::aligned_smem(smem_raw);
    const uint32_t slots = sm.addr + LY::slots;
    unsigned char* const own_p = sm.ptr + LY::own;
    unsigned char* const tp = sm.ptr + LY::tiles;   // dkv: P hi, P lo, dU hi, dU lo; dq: dU hi, lo
    const uint32_t terms = sm.addr + LY::tiles;
    const float* const stats = reinterpret_cast<const float*>(sm.ptr + LY::stat);

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int wq = (tid & 127) >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int r = 16 * wq + g;   // the fragments' tile row (and r + 8)
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int own0 = blockIdx.x * OWN;
    const int c0 = WIDE ? blockIdx.z * CW : 0;
    const int DHT = WIDE ? Dh : DH;
    const int n_own = DKV ? NK : NQ, n_oth = DKV ? NQ : NK;

    const float* qb = q + b * qs.b + h * qs.h;
    const float* kb = k + b * ks.b + h * ks.h;
    const float* vb = v + b * vs.b + h * vs.h;
    const float* gb = dout + b * gs.b + h * gs.h;
    // own rows O1 (for S), O2 (for dP); the other side's tiles X1, X2
    const float* o1 = DKV ? kb : qb;
    const float* o2 = DKV ? vb : gb;
    const float* x1 = DKV ? qb : kb;
    const float* x2 = DKV ? gb : vb;
    const long long o1n = DKV ? ks.n : qs.n, o2n = DKV ? vs.n : gs.n;
    const long long x1n = DKV ? qs.n : ks.n, x2n = DKV ? gs.n : vs.n;
    const float o1mul = DKV ? 1.f : scale, x1mul = DKV ? scale : 1.f;
    const float* lse_row = lse + (long long)bh * NQ;
    const float* delta_row = delta + (long long)bh * NQ;

    // dkv: lse and delta of tile j's rows into stats slot j & 1
    auto load_stats = [&](int j) {
        if (DKV && tid < 2 * TILE) {
            const int n = j * TILE + (tid & (TILE - 1));
            const bool ok = n < NQ;
            const float* src = (tid < TILE ? lse_row : delta_row) + (ok ? n : 0);
            mma::cp_async_4_zfill(sm.addr + LY::stat + (j & 1) * 2 * TILE * 4 + tid * 4, src, ok);
        }
    };
    // dq: lse * log2(e) and delta of the fragments' own columns 8 jn + 2t (+1)
    float lse2_own[4][2], dl_own[4][2];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int n = own0 + 8 * jn + 2 * t + e;
            const bool ok = !DKV && n < NQ;
            lse2_own[jn][e] = ok ? lse_row[n] * mma::LOG2E : 0.f;
            dl_own[jn][e] = ok ? delta_row[n] : 0.f;
        }

    // the transposed products of this warpgroup (dkv: dV from X2 and P, dK
    // from X1 and dU; dq: dQ' from X1 and dU) on the tile at xt (X1, then
    // X2 x_acc bytes on): rows dcol, dcol + 1 of the unit's columns. Where
    // dcol >= CU (Dh 32; dq's second warpgroup at Dh 64 and 32) the rows are
    // computed from columns inside the tile and not stored.
    const int dcol = (DKV && CU < 128 ? 0 : 64 * wg) + 16 * wq + 2 * g;
    auto items = [&](const unsigned char* xt, uint32_t x_acc, Item (&it)[NI]) {
        const int d = dcol & (CU - 1);
        const Item dv{xt + x_acc, 1.f, d, terms, terms + TERM};
        const Item dk{xt, x1mul, d, terms + (DKV ? 2 : 0) * TERM, terms + (DKV ? 3 : 1) * TERM};
        if constexpr (NI == 2) {
            it[0] = dv;
            it[1] = dk;
        } else {
            it[0] = DKV && wg == 0 ? dv : dk;
        }
    };

    float acc[A][NI][4][4], c[4][4];
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[a][i][jn][e] = 0.f;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[jn][e] = 0.f;

    // P = exp(S - lse) and dU = P o (dP - delta) of tile j (rows row0 ..)
    // from the logits in c (warpgroup 0: S, warpgroup 1: dP, at the same
    // fragment positions), to their hi and lo terms [own][kpos(tile row)].
    // Warpgroup w finishes own columns 16 w .. 16 w + 15 (jn = 2w, 2w + 1):
    // first each hands the other the half it does not finish, at the places
    // where that half's dU terms go (S at dU hi, dP at dU lo; the thread that
    // reads a value writes its dU there), then both finish their halves.
    auto p_and_du = [&](int j) {
        const int row0 = j * TILE;
        const float* st = stats + (j & 1) * 2 * TILE;
        unsigned char* const du_hi = tp + (DKV ? 2 : 0) * TERM;
        unsigned char* const du_lo = du_hi + TERM;
        unsigned char* const handed = wg ? du_lo : du_hi;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int rr = r + 8 * (e >> 1), col = 8 * (jj + 2 - 2 * wg) + 2 * t + (e & 1);
                *reinterpret_cast<float*>(handed + at(OWN, col, kpos(rr))) =
                    wg ? c[jj][e] : c[jj + 2][e];
            }
        __syncthreads();  // the halves handed over
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int rr = r + 8 * (e >> 1), col = 8 * (jj + 2 * wg) + 2 * t + (e & 1);
                const uint32_t o = at(OWN, col, kpos(rr));
                const float mine = wg ? c[jj + 2][e] : c[jj][e];
                const float s = wg ? *reinterpret_cast<const float*>(du_hi + o) : mine;
                const float dp = wg ? mine : *reinterpret_cast<const float*>(du_lo + o);
                const float l2 = DKV ? st[rr] * mma::LOG2E
                                     : (wg ? lse2_own[jj + 2][e & 1] : lse2_own[jj][e & 1]);
                const float dl = DKV ? st[TILE + rr]
                                     : (wg ? dl_own[jj + 2][e & 1] : dl_own[jj][e & 1]);
                const bool ok = row0 + rr < n_oth && own0 + col < n_own;
                const float p = ok ? mma::fast_exp2(fmaf(s, mma::LOG2E, -l2)) : 0.f;
                uint32_t hi, lo;
                if (DKV) {
                    split(p, hi, lo);
                    *reinterpret_cast<uint32_t*>(tp + o) = hi;
                    *reinterpret_cast<uint32_t*>(tp + TERM + o) = lo;
                }
                split(p * (dp - dl), hi, lo);
                *reinterpret_cast<uint32_t*>(du_hi + o) = hi;
                *reinterpret_cast<uint32_t*>(du_lo + o) = lo;
            }
        wgmma::fence_proxy_async();
        __syncthreads();  // P and dU are in place
    };

    const int ntiles = (n_oth + TILE - 1) / TILE;
    if constexpr (!WIDE) {
        // the own rows, raw, into slot 1 (free until tile 1 is copied) and
        // tile 0 into slot 0
        const uint32_t raw = slots + LY::slot;
        copy_rows<OWN, W>(raw, o1, o1n, own0, n_own, 0, tid);
        copy_rows<OWN, W>(raw + LY::own_t, o2, o2n, own0, n_own, 0, tid);
        auto load_tile = [&](int j) {
            const uint32_t slot = slots + (j & 1) * LY::slot;
            copy_rows<TILE, W>(slot, x1, x1n, j * TILE, n_oth, 0, tid);
            copy_rows<TILE, W>(slot + LY::x_t, x2, x2n, j * TILE, n_oth, 0, tid);
            load_stats(j);
        };
        load_tile(0);
        mma::cp_async_commit();
        int j = 0;
        do {
            mma::cp_async_wait<0>();
            if (j == 0) {
                const unsigned char* rp = sm.ptr + LY::slots + LY::slot;
                split_own<W, OWN>(own_p, own_p + LY::own_t, rp, o1mul, tid);
                split_own<W, OWN>(own_p + 2 * LY::own_t, own_p + 3 * LY::own_t, rp + LY::own_t, 1.f, tid);
            }
            wgmma::fence_proxy_async();
            __syncthreads();  // the tile (and the own terms) in place; slot j - 1 free
            if (j + 1 < ntiles) load_tile(j + 1);
            mma::cp_async_commit();
            const unsigned char* xt = sm.ptr + LY::slots + (j & 1) * LY::slot;
            logits<W, 4>(c, xt + wg * LY::x_t, wg ? 1.f : x1mul, sm.addr + 2 * wg * LY::own_t,
                      sm.addr + (2 * wg + 1) * LY::own_t, r, t, true);
            p_and_du(j);
            Item it[NI];
            items(xt, LY::x_t, it);
            accumulate_t<NI, 2>(acc[0], it, t);
        } while (++j < ntiles);
    } else {
        // a tile is `pieces` units of 64 logit columns (the tile's X1, X2
        // and, but at Dh 256, the own O1, O2, raw), then A units of CU of the
        // chunk's columns of the tile (X1, and in dkv X2, x_acc bytes on)
        const int pieces = Dh / PIECE;
        const uint32_t x_acc = TILE * CU * 4;
        auto load_piece = [&](int u, int j, int p) {
            const uint32_t slot = slots + (u & 1) * LY::slot;
            copy_rows<TILE, PIECE>(slot, x1, x1n, j * TILE, n_oth, p * PIECE, tid);
            copy_rows<TILE, PIECE>(slot + LY::x_t, x2, x2n, j * TILE, n_oth, p * PIECE, tid);
            if (!RES) {
                copy_rows<OWN, PIECE>(slot + 2 * LY::x_t, o1, o1n, own0, n_own, p * PIECE, tid);
                copy_rows<OWN, PIECE>(slot + 2 * LY::x_t + LY::own_t, o2, o2n, own0, n_own,
                                      p * PIECE, tid);
            }
            if (p == 0) load_stats(j);
        };
        auto load_cols = [&](int u, int j, int a) {
            const uint32_t slot = slots + (u & 1) * LY::slot;
            const int col = c0 + a * CU;
            copy_rows<TILE, CU>(slot, x1, x1n, j * TILE, n_oth, col, tid);
            if (DKV) copy_rows<TILE, CU>(slot + x_acc, x2, x2n, j * TILE, n_oth, col, tid);
        };
        if constexpr (RES) {
            // Dh 256: the own rows, raw, through the two slots, and their
            // terms once for the block (128 KB)
            copy_rows<OWN, DH>(slots, o1, o1n, own0, n_own, 0, tid);
            copy_rows<OWN, DH>(slots + LY::slot, o2, o2n, own0, n_own, 0, tid);
            mma::cp_async_commit();
            mma::cp_async_wait<0>();
            split_own<DH, OWN>(own_p, own_p + LY::own_t, sm.ptr + LY::slots, o1mul, tid);
            split_own<DH, OWN>(own_p + 2 * LY::own_t, own_p + 3 * LY::own_t,
                          sm.ptr + LY::slots + LY::slot, 1.f, tid);
            __syncthreads();  // the raw rows read: the slots are free
        }
        load_piece(0, 0, 0);
        mma::cp_async_commit();
        int u = 0, j = 0;
        do {
            int p = 0;
            do {
                mma::cp_async_wait<0>();
                const unsigned char* sp = sm.ptr + LY::slots + (u & 1) * LY::slot;
                if (!RES) {
                    // the own terms of this piece, into buffer u & 1 (its
                    // last readers, unit u - 2's logits, are done)
                    unsigned char* ob = own_p + (u & 1) * 4 * LY::own_t;
                    split_own<PIECE, OWN>(ob, ob + LY::own_t, sp + 2 * LY::x_t, o1mul, tid);
                    split_own<PIECE, OWN>(ob + 2 * LY::own_t, ob + 3 * LY::own_t,
                                     sp + 2 * LY::x_t + LY::own_t, 1.f, tid);
                }
                wgmma::fence_proxy_async();
                __syncthreads();  // unit u in place; slot u - 1 free
                if (p + 1 < pieces) load_piece(u + 1, j, p + 1);
                else load_cols(u + 1, j, 0);
                mma::cp_async_commit();
                // the own terms' columns of this piece (Dh 256: 2 p blocks on)
                const uint32_t oa = sm.addr + LY::own +
                                    (RES ? p * 2 * OWN * ROW : (u & 1) * 4 * LY::own_t);
                logits<PIECE, LB>(c, sp + wg * LY::x_t, wg ? 1.f : x1mul, oa + 2 * wg * LY::own_t,
                                  oa + (2 * wg + 1) * LY::own_t, r, t, p == 0);
                ++u;
            } while (++p < pieces);
            mma::cp_async_wait<0>();  // accumulating unit 0 (published by p_and_du's barriers)
            p_and_du(j);
#pragma unroll
            for (int a = 0; a < A; ++a) {
                if (a > 0) {
                    mma::cp_async_wait<0>();
                    __syncthreads();  // unit a in place; unit a - 1's slot free
                }
                if (a + 1 < A) load_cols(u + 1, j, a + 1);
                else if (j + 1 < ntiles) load_piece(u + 1, j + 1, 0);
                mma::cp_async_commit();
                Item it[NI];
                items(sm.ptr + LY::slots + (u & 1) * LY::slot, x_acc, it);
                accumulate_t<NI, AB>(acc[a], it, t);
                ++u;
            }
        } while (++j < ntiles);
    }

    // the transposed accumulators: rows dcol and dcol + 1 of unit a's
    // columns, columns the own rows 8 jn + 2t (+1); dq times Dh^-1/2
    const float omul = DKV ? 1.f : scale;
    if (dcol >= CU) return;
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
        for (int i = 0; i < NI; ++i) {
            float* out = DKV && (NI == 2 ? i == 0 : wg == 0) ? out1 : out0;
            const int d = c0 + a * CU + dcol;
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = own0 + 8 * jn + 2 * t + e;
                    if (n >= n_own) continue;
                    const long long o = (((long long)b * n_own + n) * H + h) * DHT + d;
                    *reinterpret_cast<float2*>(out + o) =
                        make_float2(acc[a][i][jn][e] * omul, acc[a][i][jn][e + 2] * omul);
                }
        }
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

// bfloat16 above 128 (a multiple of 128): a block per (64 keys or query rows,
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

bool wide_head_dim(int Dh) { return Dh > 128 && Dh % 128 == 0; }

// float32: flash_bwd_f32_kernel, f32::OWN keys (dkv) or query rows (dq) a
// block, above 128 one chunk of CW columns a block (grid z).
template <bool DKV, int DH, int CW = DH>
int launch_f32(const Args& a, int Dh, void* out0, void* out1) {
    auto kernel = flash_bwd_f32_kernel<DKV, DH, CW>;
    constexpr size_t smem = f32::Layout<DKV, DH>::bytes;
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const int rows = DKV ? a.NK : a.NQ;
    const dim3 grid((unsigned)((rows + f32::OWN - 1) / f32::OWN), (unsigned)(a.B * a.H),
                    (unsigned)(DH ? 1 : Dh / CW));
    kernel<<<grid, f32::THREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(out0), static_cast<float*>(out1), a.NQ, a.NK, a.H, Dh, a.qs, a.ks,
        a.vs, a.gs, a.scale);
    return (int)cudaGetLastError();
}

template <bool DKV>
int dispatch_f32(int Dh, const Args& a, void* out0, void* out1) {
    switch (Dh) {
        case 32: return launch_f32<DKV, 32>(a, Dh, out0, out1);
        case 64: return launch_f32<DKV, 64>(a, Dh, out0, out1);
        case 128: return launch_f32<DKV, 128>(a, Dh, out0, out1);
    }
    if (Dh == 256) return launch_f32<DKV, 256, 256>(a, Dh, out0, out1);
    if (wide_head_dim(Dh) && Dh % 256 == 0) return launch_f32<DKV, 0, 256>(a, Dh, out0, out1);
    if (wide_head_dim(Dh)) return launch_f32<DKV, 0, 128>(a, Dh, out0, out1);
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
// every row start must be 16-byte aligned (both types are read in 16-byte
// copies). lse, delta: contiguous fp32 (B*H, N), the forward's logsumexp
// and rowsum(dO o O). dk, dv: contiguous (B, Nk, H, Dh), dq: contiguous
// (B, N, H, Dh), of the input type. Dh: 32, 64, 128 or a multiple of 128
// (the wrapper zero-pads the others). A block owns 64 keys (dkv) or 64
// query rows (dq) in bfloat16, 32 in float32, and above Dh = 128 one chunk
// of output columns: 128 in float32, 256 in bfloat16 (the last 128 wide
// where Dh is an odd multiple of 128). Both entries choose their kernel by
// dtype, here: float32 runs flash_bwd_f32_kernel (three TF32 passes on
// wgmma), bfloat16 the bf16 tensor-core kernels; neither stands in for the
// other.
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
    if (dtype == MRI_DTYPE_F32) return dispatch_f32<true>(Dh, a, dk, dv);
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
    if (dtype == MRI_DTYPE_F32) return dispatch_f32<false>(Dh, a, dq, nullptr);
    if (dtype == MRI_DTYPE_BF16) return dispatch_dq_tc(Dh, a, dq);
    return (int)cudaErrorInvalidValue;
}
