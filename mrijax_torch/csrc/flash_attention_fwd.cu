// Flash-attention forward (online softmax over KV tiles), with logsumexp.
//
// Replaces the TPU kernel _flash_kernel of
// mrijax/kernels/flash_attention_pallas.py (driven by _flash_forward_lse).
//
// Bound on an H100: operations. The work is 4*B*H*N^2*Dh flops against
// 4 tensors of B*N*H*Dh elements; at the bottleneck shape of the flagship
// UNet3D (N = 800, Dh = 128, bf16) the flops over the tensor-core rate take
// longer than the bytes over the memory rate. Two more rates sit beside that
// bound. A block reads all of K and V of its (batch, head) from L2, so R
// query rows a block mean 2*R flops per byte that an SM pulls in: at 64 rows
// that alone caps an SM at half its tensor-core rate. And at Dh = 32 the
// softmax between the two products (max, fma, ex2, sum, round: some 200
// instructions a warp for every 32 mma) keeps the schedulers busier than the
// tensor cores; the N^2 exponentials themselves are not the limit.
//
// Two hand-written kernels live here, chosen by dtype in the C entry:
//
// bfloat16 -> flash_fwd_tc_kernel, on the tensor cores.
// * mma.sync.aligned.m16n8k16 (bf16 operands, fp32 accumulators) fed by
//   ldmatrix, with the FlashAttention-2 register layout. Chosen over wgmma:
//   a warp works on its own rows with no warpgroup-wide synchronisation, P
//   stays in the registers its accumulator left it in, and K and V tiles can
//   stay plain padded rows instead of the descriptor layouts wgmma reads.
//   Its price: every warp re-reads the K and V tile from shared memory, and
//   mma.sync does not reach the rate of wgmma.
// * A block is 4 warps; a warp owns MT fragments of 16 query rows. The
//   wrapper's launch plan picks 64 rows a block (MT = 1) or 128 (MT = 2):
//   with MT = 2 every K and V fragment read from shared memory feeds two
//   products and the block pulls half the bytes per flop from L2, at the
//   price of 255 registers at Dh = 128 (the Q fragments are then re-read from
//   shared memory at every tile instead of being held). Blocks of 32 rows
//   (2 warps), tried for grids smaller than the card, measured slower and
//   are not compiled: the critical path of a warp is the same, the L2
//   traffic doubles.
// * S = q'k^T for 16 rows x 64 keys is 8 accumulator fragments in registers;
//   running max and sum are per row, reduced over the 4 lanes that share a
//   row with two shuffles (the sum only once, at the end); the fragment of P,
//   rounded to bf16, IS the A operand of P V.
// * Tiles stay bf16 in shared memory with pitch Dh + 8 (see mma.cuh): a
//   64 x 128 tile is 17 KB, Q plus two stages of K and V 87 or 104 KB, two
//   blocks an SM. cp.async (16 bytes a thread, zero-fill beyond N) brings
//   K tile j + 2 and V tile j + 1 while tile j is multiplied: K's stage is
//   free as soon as every warp has its S, so K runs a tile further ahead than
//   V and both copies get a whole tile's time to land. They are issued right
//   behind the S products, not before them: a warp stalls while the memory
//   system takes a tile's worth of copies, and there the tensor cores are
//   busy meanwhile. One barrier per tile orders arrival and reuse (see the
//   loop).
// * q' = round(q * Dh^-1/2) to bf16 is made once, by each warp on its own
//   rows of the Q tile in shared memory.
// * exp is ex2.approx with log2(e) folded into an fma; max and lse stay in
//   natural units. The row sum uses the unrounded fp32 P, as on the TPU.
// * Strided q, k, v, ragged N (keys beyond N get -1e30, rows beyond N are
//   computed on zeros and not stored): as before. The output tile is staged
//   through the warp's own (dead) Q rows and written 16 bytes a lane.
//
// float32 -> flash_attn_fwd_kernel, fp32 FMAs from shared memory (the TPU
// kernel runs fp32 at Precision.HIGHEST, which bf16 tensor cores do not give):
// * One block per (batch*head, tile of BQ query rows); a loop inside the
//   block walks the KV tiles, running max / sum / accumulator in registers.
// * 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
//   ty + 16*i (i < 4). For S = q'k^T it owns key columns tx + 16*j (j < 4);
//   for acc += P V it owns a few columns of Dh. The 16 threads that share a
//   row are the lanes of a half warp, so row max and row sum are four
//   shuffles, and the alpha rescale needs no shared memory.
// * Tiles are held in shared memory as fp32 with row pitch Dh + 4, so that
//   the float4 reads along Dh of 8 neighbouring rows fall into distinct banks.
// * q is scaled by Dh^-1/2 when the tile is loaded; P goes through shared
//   memory for the PV product.

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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

// s[i][j] += q'[ty + 16 i] . k[tx + 16 j] over W columns of two fp32 tiles
// of pitch LD.
template <int LD, int W>
__device__ __forceinline__ void fma_logits(const float* Qs, const float* Ks,
                                           int tx, int ty, float (&s)[4][4]) {
#pragma unroll 2
    for (int d = 0; d < W; d += 4) {
        float4 qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            ka[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
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
}

// Keys beyond NK get -inf (only the last tile has any), then the online
// softmax update of rows ty + 16 i: P, rounded to T, goes to Ps for the P V
// product; running max m and sum l advance and acc is rescaled.
template <typename T, int NC>
__device__ __forceinline__ void fma_softmax(float (&s)[4][4], int k0, int NK,
                                            float (&m)[4], float (&l)[4],
                                            float (&acc)[4][NC], float* Ps,
                                            int tx, int ty) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j >= NK) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i][j] = NEG_INF;
        }
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
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
}

// acc += P V for rows ty + 16 i, columns tx*CW + 16*CW*jj + w of a V tile
// of pitch LDV.
template <int LDV, int CW, int NJ>
__device__ __forceinline__ void fma_pv(const float* Ps, const float* Vs, int tx,
                                       int ty, float (&acc)[4][NJ * CW]) {
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
                const float* vp = &Vs[(kk + u) * LDV + tx * CW + 16 * CW * jj];
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

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int NQ, int NK, int H, Strides qs,
                      Strides ks, Strides vs, float scale) {
    constexpr int LD = DH + 4;
    // columns of Dh owned by a thread in the PV product: NJ pieces of CW
    constexpr int CW = DH >= 64 ? 4 : DH / 16;
    constexpr int NJ = DH / (16 * CW);
    static_assert(CW == 4 || CW == 2,
                  "one-piece instances take Dh 32, 64 or 128; a larger Dh runs "
                  "in 128-column chunks (flash_attn_fwd_wide_kernel)");
    static_assert(NJ * CW * 16 == DH,
                  "one-piece instances take Dh 32, 64 or 128; a larger Dh runs "
                  "in 128-column chunks (flash_attn_fwd_wide_kernel)");

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
        if (n < NQ) x = round_to<T>(to_float<T>(qb[n * qs.n + d]) * scale);
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

    for (int k0 = 0; k0 < NK; k0 += BK) {
        // the previous tile's readers are done (first pass: orders the Q store)
        __syncthreads();
        for (int e = tid; e < BK * DH; e += NT) {
            const int r = e / DH, d = e % DH;
            const int n = k0 + r;
            float kx = 0.f, vx = 0.f;
            if (n < NK) {
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
        fma_logits<LD, DH>(Qs, Ks, tx, ty, s);
        fma_softmax<T, NJ * CW>(s, k0, NK, m, l, acc, Ps, tx, ty);
        __syncthreads();
        fma_pv<DH, CW, NJ>(Ps, Vs, tx, ty, acc);
    }

    // every valid row has seen at least one valid key, so l >= 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = q0 + ty + 16 * i;
        if (n >= NQ) continue;
        T* orow = out + (((long long)b * NQ + n) * H + h) * DH;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int w = 0; w < CW; ++w) {
                const int col = tx * CW + 16 * CW * jj + w;
                orow[col] = from_float<T>(acc[i][jj * CW + w] / l[i]);
            }
        if (tx == 0) lse[(long long)bh * NQ + n] = m[i] + logf(l[i]);
    }
}

// ---------------------------------------------------------------- bfloat16

using mma::bf16;

constexpr int TC_BN = 64;  // keys per tile of the tensor-core kernel

template <int DH, int NWARPS, int MT>
constexpr size_t flash_tc_smem_bytes() {
    return sizeof(bf16) * (16 * MT * NWARPS + 4 * TC_BN) * (DH + mma::PAD);
}

// Keys beyond NK get -inf (only the last tile has any), then the online
// softmax on the S fragments of MT row fragments (rows g and g + 8 of each):
// running max m, the lane's share l of the row sum, accumulators o
// rescaled; S becomes the unrounded P.
template <int MT, int ND>
__device__ __forceinline__ void tc_softmax(float (&s)[MT][8][4], int k0, int NK,
                                           int t, float (&m)[MT][2],
                                           float (&l)[MT][2],
                                           float (&o)[MT][ND][4]) {
    if (k0 + TC_BN > NK) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int jn = 0; jn < 8; ++jn)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (k0 + 8 * jn + 2 * t + (e & 1) >= NK)
                        s[mt][jn][e] = NEG_INF;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mc = NEG_INF;
#pragma unroll
            for (int jn = 0; jn < 8; ++jn)
                mc = fmaxf(mc, fmaxf(s[mt][jn][2 * r], s[mt][jn][2 * r + 1]));
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
            const float mn = fmaxf(m[mt][r], mc);
            const float alpha =
                mma::fast_exp2((m[mt][r] - mn) * mma::LOG2E);
            const float mn2 = mn * mma::LOG2E;
            float rs = 0.f;
#pragma unroll
            for (int jn = 0; jn < 8; ++jn) {
                const float p0 = mma::fast_exp2(
                    fmaf(s[mt][jn][2 * r], mma::LOG2E, -mn2));
                const float p1 = mma::fast_exp2(
                    fmaf(s[mt][jn][2 * r + 1], mma::LOG2E, -mn2));
                rs += p0 + p1;
                s[mt][jn][2 * r] = p0;
                s[mt][jn][2 * r + 1] = p1;
            }
            l[mt][r] = alpha * l[mt][r] + rs;
            m[mt][r] = mn;
#pragma unroll
            for (int nd = 0; nd < ND; ++nd) {
                o[mt][nd][2 * r] *= alpha;
                o[mt][nd][2 * r + 1] *= alpha;
            }
        }
    }
}

// o += P V over one tile of TC_BN keys: the S fragments, rounded to bf16,
// are the A operand; a V fragment (ldmatrix.trans at v_addr, the lane's
// address in a tile of pitch LD) serves all MT row fragments.
template <int MT, int KD, int LD>
__device__ __forceinline__ void tc_pv(const float (&s)[MT][8][4], uint32_t v_addr,
                                      float (&o)[MT][2 * KD][4]) {
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            a[mt][0] = mma::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
            a[mt][1] = mma::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
            a[mt][2] =
                mma::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
            a[mt][3] =
                mma::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int nd2 = 0; nd2 < KD; ++nd2) {
            uint32_t r[4];
            mma::ldmatrix_x4_trans(r, v_addr + (kk * 16 * LD + nd2 * 16) * 2);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                mma::mma_bf16(o[mt][2 * nd2], a[mt], r[0], r[1]);
                mma::mma_bf16(o[mt][2 * nd2 + 1], a[mt], r[2], r[3]);
            }
        }
    }
}

template <int DH, int NWARPS, int MT>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int NQ, int NK, int H, Strides qs,
                    Strides ks, Strides vs, float scale) {
    constexpr int WM = 16 * MT;       // query rows per warp: MT fragments of 16
    constexpr int BM = WM * NWARPS;   // query rows per block
    constexpr int NT = 32 * NWARPS;
    constexpr int LD = DH + mma::PAD;
    constexpr int KD = DH / 16;       // k-steps over Dh
    constexpr int ND = DH / 8;        // 8-column fragments of the output
    constexpr int CPR = DH / 8;       // 16-byte chunks per row
    constexpr int TILE = TC_BN * LD;  // elements of one K or V stage
    // the Q fragments stay in registers where there is room beside the
    // accumulators; else they are re-read from shared memory at every tile
    constexpr bool Q_IN_REGS = MT * DH <= 128;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
    bf16* Ks = Qs + BM * LD;                       // [2][TC_BN][LD]
    bf16* Vs = Ks + 2 * TILE;                      // [2][TC_BN][LD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int q0 = blockIdx.x * BM;

    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;

    const uint32_t k_tiles = mma::smem_addr(Ks);
    const uint32_t v_tiles = mma::smem_addr(Vs);
    const int ntiles = (NK + TC_BN - 1) / TC_BN;
    mma::load_tile_async<BM, DH, NT>(mma::smem_addr(Qs), qb, qs.n, q0, NQ, tid);
    mma::load_tile_async<TC_BN, DH, NT>(k_tiles, kb, ks.n, 0, NK, tid);
    mma::cp_async_commit();
    if (ntiles > 1)
        mma::load_tile_async<TC_BN, DH, NT>(k_tiles + TILE * 2, kb, ks.n, TC_BN,
                                            NK, tid);
    mma::load_tile_async<TC_BN, DH, NT>(v_tiles, vb, vs.n, 0, NK, tid);
    mma::cp_async_commit();

    // Q and K tile 0 have landed (K tile 1 and V tile 0 may still be in
    // flight): the warp turns its own rows into q' = round(q * scale) in place.
    mma::cp_async_wait<1>();
    __syncthreads();
    bf16* Qw = Qs + warp * WM * LD;
    for (int e = lane; e < WM * CPR; e += 32) {
        uint4* at = reinterpret_cast<uint4*>(Qw + (e / CPR) * LD + (e % CPR) * 8);
        uint4 x = *at;
        x.x = mma::scale_round_bf16(x.x, scale);
        x.y = mma::scale_round_bf16(x.y, scale);
        x.z = mma::scale_round_bf16(x.z, scale);
        x.w = mma::scale_round_bf16(x.w, scale);
        *at = x;
    }
    __syncwarp();
    const uint32_t q_addr = mma::smem_addr(Qw) + mma::a_offset(lane, LD);
    uint32_t qf[Q_IN_REGS ? MT : 1][Q_IN_REGS ? KD : 1][4];
    if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)
                mma::ldmatrix_x4(qf[mt][kk],
                                 q_addr + (mt * 16 * LD + kk * 16) * 2);
    }

    // per fragment of 16 rows: rows g (index 0) and g + 8 (index 1)
    float m[MT][2], l[MT][2];  // l: this lane's share of the row sum
    float o[MT][ND][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        m[mt][0] = m[mt][1] = NEG_INF;
        l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][nd][e] = 0.f;
    }

    const uint32_t k_lane = k_tiles + mma::b_offset(lane, LD);
    const uint32_t v_lane = v_tiles + mma::a_offset(lane, LD);

    // The pipeline, with two stages each of K and V and one barrier a tile:
    //   S(j)   reads K tile j, which the barrier of pass j - 1 made visible;
    //   wait + barrier: the copies issued in pass j - 1 (K tile j + 1, V tile
    //       j) have landed and are visible to all, every warp is done with
    //       K tile j (its stage is free) and with V tile j - 1 (likewise);
    //   the copies of K tile j + 2 and V tile j + 1 go out, behind the S
    //       products just issued: a warp that issues a tile's worth of copies
    //       waits until the memory system has taken them, and the tensor
    //       cores work meanwhile; each copy has a whole tile's time to land;
    //   softmax(j), then P V(j) reads V tile j.
    for (int j = 0; j < ntiles; ++j) {
        const int stage = j & 1;
        const int k0 = j * TC_BN;
        const uint32_t k_addr = k_lane + stage * TILE * 2;
        const uint32_t v_addr = v_lane + stage * TILE * 2;

        // S = q' k^T: 16 MT rows x 64 keys; fragment jn holds keys
        // 8 jn .. 8 jn + 7. A K fragment serves all MT row fragments.
        float s[MT][8][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int jn = 0; jn < 8; ++jn)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[mt][jn][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            uint32_t kf[4][4];
#pragma unroll
            for (int nb = 0; nb < 4; ++nb)
                mma::ldmatrix_x4(kf[nb], k_addr + (nb * 16 * LD + kk * 16) * 2);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                uint32_t qa[4];
                if constexpr (Q_IN_REGS) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) qa[i] = qf[mt][kk][i];
                } else {
                    mma::ldmatrix_x4(qa, q_addr + (mt * 16 * LD + kk * 16) * 2);
                }
#pragma unroll
                for (int nb = 0; nb < 4; ++nb) {
                    mma::mma_bf16(s[mt][2 * nb], qa, kf[nb][0], kf[nb][1]);
                    mma::mma_bf16(s[mt][2 * nb + 1], qa, kf[nb][2], kf[nb][3]);
                }
            }
        }

        mma::cp_async_wait<0>();
        __syncthreads();
        if (j + 2 < ntiles)
            mma::load_tile_async<TC_BN, DH, NT>(k_tiles + stage * TILE * 2, kb,
                                                ks.n, k0 + 2 * TC_BN, NK, tid);
        if (j + 1 < ntiles)
            mma::load_tile_async<TC_BN, DH, NT>(
                v_tiles + (stage ^ 1) * TILE * 2, vb, vs.n, k0 + TC_BN, NK, tid);
        mma::cp_async_commit();

        tc_softmax<MT, ND>(s, k0, NK, t, m, l, o);
        tc_pv<MT, KD, LD>(s, v_addr, o);
    }

    // out = acc / l, staged through the warp's own Q rows (no other warp ever
    // reads them), then written as 16-byte pieces of contiguous rows; every
    // valid row has seen at least one valid key, so l >= 1
    const int row0 = q0 + warp * WM;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float sum = l[mt][r];
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            bf16* orow = Qw + (mt * 16 + g + 8 * r) * LD + 2 * t;
#pragma unroll
            for (int nd = 0; nd < ND; ++nd)
                *reinterpret_cast<uint32_t*>(orow + nd * 8) = mma::pack_bf16(
                    o[mt][nd][2 * r] / sum, o[mt][nd][2 * r + 1] / sum);
            const int n = row0 + mt * 16 + g + 8 * r;
            if (t == 0 && n < NQ)
                lse[(long long)bh * NQ + n] = m[mt][r] + logf(sum);
        }
    }
    __syncwarp();
    for (int e = lane; e < WM * CPR; e += 32) {
        const int r = e / CPR, c = e % CPR;
        const int n = row0 + r;
        if (n < NQ)
            *reinterpret_cast<uint4*>(
                out + (((long long)b * NQ + n) * H + h) * DH + c * 8) =
                *reinterpret_cast<const uint4*>(&Qw[r * LD + c * 8]);
    }
}

// ------------------------------------------------------- Dh above 128
//
// The wrapper zero-pads a head dim above 128 to a multiple of WIDE = 128.
// Both types take Dh in column chunks: a block owns a tile of query rows and
// ONE chunk of output columns (grid z), so its fp32 accumulator fits the
// register file at any Dh; it computes the logits over all of Dh and P V for
// its own chunk of V only. Every chunk computes the same logits and lse;
// chunk 0 writes lse. float32: chunks of WIDE, below; bfloat16: chunks of
// 256 on warpgroup products, flash_fwd_wide_tc_kernel further down.

constexpr int WIDE = 128;                  // columns of a piece and of a chunk (fp32)

// float32: 256 threads as in flash_attn_fwd_kernel; one piece of q' and of
// K at a time (plain loads, two barriers a piece), then the chunk of V into
// K's tile for the P V product.
constexpr size_t flash_wide_smem_bytes() {
    return sizeof(float) * (BQ * (WIDE + 4) + BK * (WIDE + 4) + BQ * LDP);
}

template <typename T>
__device__ __forceinline__ void load_wide_piece(float* dst, const T* base,
                                                long long stride_n, int row0,
                                                int N, float scale, bool scaled,
                                                int tid) {
    constexpr int LD = WIDE + 4;
    for (int e = tid; e < 64 * WIDE; e += NT) {
        const int r = e / WIDE, d = e % WIDE;
        const int n = row0 + r;
        float x = 0.f;
        if (n < N) {
            x = to_float<T>(base[n * stride_n + d]);
            if (scaled) x = round_to<T>(x * scale);
        }
        dst[r * LD + d] = x;
    }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_attn_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int NQ, int NK, int H,
                           int DH, Strides qs, Strides ks, Strides vs,
                           float scale) {
    constexpr int LD = WIDE + 4;
    constexpr int CW = 4;                  // columns a thread owns per piece
    constexpr int NJ = WIDE / (16 * CW);   // pieces of CW columns
    constexpr int NC = NJ * CW;

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;            // [BQ][LD]  a piece of q', fp32
    float* Ks = Qs + BQ * LD;    // [BK][LD]  a piece of K, then the chunk of V
    float* Ps = Ks + BK * LD;    // [BQ][LDP]

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
    const T* vb = v + b * vs.b + h * vs.h + chunk * WIDE;

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    for (int k0 = 0; k0 < NK; k0 += BK) {
        // S = q' k^T over all of Dh, a piece of WIDE columns at a time
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int c = 0; c < pieces; ++c) {
            __syncthreads();  // the readers of the last piece (or of V) are done
            load_wide_piece<T>(Qs, qb + c * WIDE, qs.n, q0, NQ, scale, true, tid);
            load_wide_piece<T>(Ks, kb + c * WIDE, ks.n, k0, NK, 1.f, false, tid);
            __syncthreads();
            fma_logits<LD, WIDE>(Qs, Ks, tx, ty, s);
        }
        fma_softmax<T, NC>(s, k0, NK, m, l, acc, Ps, tx, ty);
        __syncthreads();  // K's tile is free, P is visible
        load_wide_piece<T>(Ks, vb, vs.n, k0, NK, 1.f, false, tid);
        __syncthreads();
        fma_pv<LD, CW, NJ>(Ps, Ks, tx, ty, acc);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = q0 + ty + 16 * i;
        if (n >= NQ) continue;
        T* orow = out + (((long long)b * NQ + n) * H + h) * DH + chunk * WIDE;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int w = 0; w < CW; ++w) {
                const int col = tx * CW + 16 * CW * jj + w;
                orow[col] = from_float<T>(acc[i][jj * CW + w] / l[i]);
            }
        if (chunk == 0 && tx == 0) lse[(long long)bh * NQ + n] = m[i] + logf(l[i]);
    }
}

// bfloat16: flash_fwd_wide_tc_kernel, the TPU's _flash_kernel for Dh =
// 128 P, P >= 2, on Hopper's warpgroup products (wgmma.mma_async, see
// wgmma.cuh).
//
// Bound: operations, 4 B H Nq Nk Dh flops over the 989 TFLOP/s of bf16.
//
// A block owns 64 WG query rows of one (batch, head), WG = 1 or 2
// warpgroups of 64 rows, and one chunk of CHUNK = 256 output columns (grid
// z; at an odd multiple of 128 the last chunk is 128 wide). The wrapper's
// launch plan takes 64 rows where those blocks fit the card in one wave,
// else 128: a block of 128 rows measured 1.2-1.3 times the time of one of
// 64 on an H100. A warpgroup holds its 64 rows x 256 columns of fp32
// accumulator: 128 registers a thread. What the design does about what
// held the earlier kernel (128-column chunks on mma.sync, q' streamed with
// K) back:
// * The logits once a chunk. S = q' K^T over all of Dh is computed once per
//   tile by each warpgroup for its rows: at Dh 256 once in all, where
//   128-column chunks computed it twice (four times at Dh 512).
// * q' staged once. The block's rows of the chunk's columns are copied once,
//   scaled and rounded in place by the threads that copied them, and stay
//   resident for every KV tile (WG x 32 KB). K and V stream through a ring
//   of two 64 KB slots of 64-key tiles of the chunk's columns: the copies
//   (cp.async) of slot u + 1 are issued while the logits of slot u run, one
//   block barrier a slot. Above Dh 256 the logits also need the columns
//   outside the chunk: those come as pieces of 128 columns, K's and the
//   block's q's together in a slot (q re-read from L2 and scaled each
//   time), before the slot that holds the tile's chunk of K and V.
//   L2 -> shared bytes a launch at (8, 6400, 1, 256): 400 blocks of 128
//   rows x (64 KB + 100 tiles x 64 KB) = 2.65 GB, against 13.1 GB for the
//   128-column chunks.
// * Products on wgmma. S is m64n64k16, q' and K both K-major from shared
//   memory, fp32, its first k16 step with scale-d 0; P, rounded to bf16 in
//   registers, is the register A operand of O += P V (m64n256k16, V read
//   MN-major with the transpose flag from the slot the logits read K
//   from). Two warpgroups share each K and V tile: the 128-row block pulls
//   half the L2 bytes per flop of the 64-row one.
// The softmax (wide::softmax) does the arithmetic of the Dh <= 128
// kernel's tc_softmax: running max and sum per row (the 4 lanes of a row
// reduce with two shuffles), exponentials as ex2.approx with log2 e folded
// into an fma, the row sum of the unrounded fp32 P, the accumulator
// rescaled in registers between two batches of products. Shared memory: q' WG x 32 KB, two 64 KB slots and 1 KB to align
// the swizzle: 161 KB (64 rows) or 193 KB (128 rows), one block an SM. Rows
// beyond Nq are zero-filled, computed and not stored; keys beyond Nk are
// zero-filled and get -1e30 before the max. No atomics.
namespace wide {

constexpr int KEYS = 64;                  // keys of a tile; rows of a warpgroup
constexpr int CHUNK = 256;                // output columns of a block
constexpr int PIECE = 128;                // columns of a piece outside the chunk
constexpr uint32_t BB = wgmma::BLOCK_BYTES;
constexpr uint32_t SLOT_BYTES = 8 * BB;   // K and V of a tile, or a piece of K and q
constexpr uint32_t ALIGN = 1024;          // the swizzle repeats every 1024 bytes
constexpr int STAGE_LD = CHUNK + mma::PAD;   // pitch of the output staging rows

template <int WG>
constexpr size_t smem_bytes() {
    return ALIGN + WG * 4 * BB + 2 * SLOT_BYTES;
}

// A block's chunk, and the pieces of the other columns in the order they
// are streamed (ascending, the chunk skipped); a KV tile is `units` slots:
// the pieces, then the chunk.
struct Chunk {
    int c0, width, nb, pieces, units;
    __device__ Chunk(int chunk, int DH)
        : c0(chunk * CHUNK), width(min(CHUNK, DH - chunk * CHUNK)),
          nb(width / wgmma::BLOCK_COLS), pieces((DH - width) / PIECE),
          units(pieces + 1) {}
    __device__ int piece_col(int p) const { return p * PIECE < c0 ? p * PIECE : p * PIECE + width; }
};

// Issues s = A B^T over nb 64-column blocks (K-major): A the warpgroup's 64
// rows of q', B 64 keys. With `first` the sum starts from zero (scale-d, no
// register writes). Commits; the caller waits.
__device__ __forceinline__ void issue_logits(float (&s)[8][4], uint32_t a, uint32_t b,
                                             int nb, bool first) {
    wgmma::fence_operand(s);
    wgmma::fence();
#pragma unroll 1
    for (int i = 0; i < nb; ++i)
#pragma unroll
        for (int st = 0; st < 4; ++st) {
            const uint32_t off = i * BB + st * 32;
            const int keep = !first || i > 0 || st > 0;
            wgmma::m64n64k16(s, wgmma::desc_k(a + off), wgmma::desc_k(b + off), keep);
        }
    wgmma::commit();
}

// The online softmax of one tile for the fragment's rows (index 0: r0,
// 1: r0 + 8), reading the logits without writing them (the products'
// accumulator is written by products alone; writing it in place makes
// ptxas serialize them): keys beyond NK count as -1e30, m and this lane's
// share l of the row sum advance, o is rescaled, and P = 2^(S log2 e -
// m log2 e), rounded to bf16, leaves as the A fragments pa[kk] of keys
// 16 kk .. 16 kk + 15; the sum is of the unrounded P.
__device__ __forceinline__ void softmax(const float (&s)[8][4], int k0, int NK, int t,
                                        float (&m)[2], float (&l)[2], float (&o)[32][4],
                                        uint32_t (&pa)[4][4]) {
    float x[8][4];
    const bool ragged = k0 + KEYS > NK;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            x[jn][e] = ragged && k0 + 8 * jn + 2 * t + (e & 1) >= NK ? NEG_INF : s[jn][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float mc = NEG_INF;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) mc = fmaxf(mc, fmaxf(x[jn][2 * r], x[jn][2 * r + 1]));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
        const float mn = fmaxf(m[r], mc);
        const float alpha = mma::fast_exp2((m[r] - mn) * mma::LOG2E);
        const float mn2 = mn * mma::LOG2E;
        float rs = 0.f;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
            x[jn][2 * r] = mma::fast_exp2(fmaf(x[jn][2 * r], mma::LOG2E, -mn2));
            x[jn][2 * r + 1] = mma::fast_exp2(fmaf(x[jn][2 * r + 1], mma::LOG2E, -mn2));
            rs += x[jn][2 * r] + x[jn][2 * r + 1];
        }
        l[r] = alpha * l[r] + rs;
        m[r] = mn;
#pragma unroll
        for (int nd = 0; nd < 32; ++nd) {
            o[nd][2 * r] *= alpha;
            o[nd][2 * r + 1] *= alpha;
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = mma::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
        pa[kk][1] = mma::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
        pa[kk][2] = mma::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
        pa[kk][3] = mma::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    }
}

}  // namespace wide

template <int WG>
__global__ void __launch_bounds__(128 * WG, 1)
flash_fwd_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int NQ, int NK, int H, int DH,
                         Strides qs, Strides ks, Strides vs, float scale) {
    using namespace wide;
    constexpr int T = 128 * WG;          // threads
    constexpr int BM = KEYS * WG;        // query rows of the block
    // own: q' of warpgroup w's rows, blocks 4 w .. 4 w + 3; a slot: the
    // tile's K 0-3 and V 4-7, or a piece's K 0-1 and q of warpgroup w's rows
    // 2 + 2 w .. 3 + 2 w
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = mma::smem_addr(smem_raw);
    const uint32_t pad = ((raw + ALIGN - 1) & ~(ALIGN - 1)) - raw;
    unsigned char* base = smem_raw + pad;
    const uint32_t own = raw + pad, slots = own + WG * 4 * BB;

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int r0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);  // fragment row
    const int t = tid & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int q0 = blockIdx.x * BM;
    const Chunk ch(blockIdx.z, DH);

    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;

    const int ntiles = (NK + KEYS - 1) / KEYS;
    const int total = ntiles * ch.units;
    auto load_unit = [&](int u) {
        const int j = u / ch.units, p = u % ch.units;
        const uint32_t slot = slots + (u & 1) * SLOT_BYTES;
        if (p < ch.pieces) {
            const int col = ch.piece_col(p);
            wgmma::load_blocks<T>(slot, kb, ks.n, j * KEYS, NK, col, 2, tid);
            for (int w = 0; w < WG; ++w)
                wgmma::load_blocks<T>(slot + (2 + 2 * w) * BB, qb, qs.n, q0 + KEYS * w, NQ,
                                      col, 2, tid);
            return;
        }
        wgmma::load_blocks<T>(slot, kb, ks.n, j * KEYS, NK, ch.c0, ch.nb, tid);
        wgmma::load_blocks<T>(slot + 4 * BB, vb, vs.n, j * KEYS, NK, ch.c0, ch.nb, tid);
    };
    for (int w = 0; w < WG; ++w)
        wgmma::load_blocks<T>(own + 4 * w * BB, qb, qs.n, q0 + KEYS * w, NQ, ch.c0, ch.nb, tid);
    load_unit(0);
    mma::cp_async_commit();

    // rows r0 (index 0) and r0 + 8 (index 1) of the warpgroup; l: this
    // lane's share of the row sum; pa: P of the tile as the A operand of
    // P V, one k16 step of keys a row
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[32][4], s[8][4];
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

    const uint32_t own_q = own + 4 * wg * BB;
    // Both loops run at least once (NK >= 1; a tile ends with its chunk):
    // a path around one would carry the accumulator, or its zeros, past a
    // wait on P V without a product, and ptxas would serialize the products.
    int u = 0;  // slot of the stream: tile j, piece p
    int j = 0;
    do {
        uint32_t slot;
        int p = 0;
        do {
            const bool chunk_slot = p == ch.pieces;
            slot = slots + (u & 1) * SLOT_BYTES;
            mma::cp_async_wait<0>();  // slot u (and on the first pass q') landed
            if (u == 0)
                for (int w = 0; w < WG; ++w)
                    wgmma::scale_blocks<T>(base + 4 * w * BB, ch.nb, scale, tid);
            if (!chunk_slot)
                for (int w = 0; w < WG; ++w)
                    wgmma::scale_blocks<T>(base + (slot - own) + (2 + 2 * w) * BB, 2, scale,
                                           tid);
            wgmma::wait<0>();  // the last tile's P V, which reads slot u - 1
            wgmma::fence_operand(o);
            wgmma::fence_operand(pa);
            wgmma::fence_proxy_async();
            __syncthreads();  // ... for all; slot u - 1's readers are done
            // S (+)= q' K^T over the chunk's columns (own q', the tile's K)
            // or a piece's (both from the slot); slot u + 1 is copied into
            // slot u - 1 while the products run
            issue_logits(s, chunk_slot ? own_q : slot + (2 + 2 * wg) * BB, slot,
                         chunk_slot ? ch.nb : 2, p == 0);
            if (u + 1 < total) load_unit(u + 1);
            mma::cp_async_commit();
            wgmma::wait<0>();
            wgmma::fence_operand(s);
            ++u;
        } while (p++ < ch.pieces);

        softmax(s, j * KEYS, NK, t, m, l, o, pa);
        // O += P V over the chunk's columns (at a chunk 128 wide the upper
        // half reads stale blocks of the slot into columns never stored)
        wgmma::fence_operand(o);
        wgmma::fence_operand(pa);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma::m64n256k16_rs_mn(o, pa[kk],
                                    wgmma::desc_mn(slot + 4 * BB + kk * 16 * 128));
        wgmma::commit();  // waited for at the next slot, while its copies land
    } while (++j < ntiles);
    wgmma::wait<0>();
    wgmma::fence_operand(o);

    // out = o / l (one division a row, then products), staged through the
    // slots (every product and copy is done), then 16-byte pieces of the
    // chunk's columns; every valid row has seen a valid key, so l >= 1
    __syncthreads();
    bf16* st = reinterpret_cast<bf16*>(base + WG * 4 * BB);
    const int row = KEYS * wg + r0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / sum;
        bf16* srow = st + (row + 8 * r) * STAGE_LD + 2 * t;
#pragma unroll
        for (int jn = 0; jn < 32; ++jn)
            *reinterpret_cast<uint32_t*>(srow + jn * 8) =
                mma::pack_bf16(o[jn][2 * r] * inv, o[jn][2 * r + 1] * inv);
        const int n = q0 + row + 8 * r;
        if (ch.c0 == 0 && t == 0 && n < NQ)
            lse[(long long)bh * NQ + n] = m[r] + logf(sum);
    }
    __syncthreads();
    const int cpr = ch.width / 8;
    for (int e = tid; e < BM * cpr; e += T) {
        const int r = e / cpr, c = e % cpr;
        const int n = q0 + r;
        if (n < NQ)
            *reinterpret_cast<uint4*>(out + (((long long)b * NQ + n) * H + h) * DH + ch.c0 +
                                      c * 8) =
                *reinterpret_cast<const uint4*>(&st[r * STAGE_LD + c * 8]);
    }
}

struct Args {
    const void *q, *k, *v;
    void* out;
    float* lse;
    int B, NQ, NK, H;
    Strides qs, ks, vs;
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
int launch_fma(const Args& a) {
    auto kernel = flash_attn_fwd_kernel<float, DH>;
    constexpr size_t smem = flash_smem_bytes<DH>();
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const dim3 grid((unsigned)((a.NQ + BQ - 1) / BQ), (unsigned)(a.B * a.H));
    kernel<<<grid, NT, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse,
        a.NQ, a.NK, a.H, a.qs, a.ks, a.vs, a.scale);
    return (int)cudaGetLastError();
}

template <int DH, int NWARPS, int MT>
int launch_tc(const Args& a) {
    auto kernel = flash_fwd_tc_kernel<DH, NWARPS, MT>;
    constexpr size_t smem = flash_tc_smem_bytes<DH, NWARPS, MT>();
    constexpr int BM = 16 * MT * NWARPS;
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const dim3 grid((unsigned)((a.NQ + BM - 1) / BM), (unsigned)(a.B * a.H));
    kernel<<<grid, NWARPS * 32, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lse, a.NQ, a.NK,
        a.H, a.qs, a.ks, a.vs, a.scale);
    return (int)cudaGetLastError();
}

// Above 128 (a multiple of WIDE): a block per (tile of query rows, (batch,
// head), chunk of `chunk` output columns).
template <typename Kernel, typename... KArgs>
int launch_wide(Kernel kernel, size_t smem, int rows, int threads, int chunk, const Args& a,
                int Dh, KArgs... kargs) {
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const dim3 grid((unsigned)((a.NQ + rows - 1) / rows), (unsigned)(a.B * a.H),
                    (unsigned)((Dh + chunk - 1) / chunk));
    kernel<<<grid, threads, smem, a.stream>>>(kargs..., a.NQ, a.NK, a.H, Dh, a.qs,
                                              a.ks, a.vs, a.scale);
    return (int)cudaGetLastError();
}

// bfloat16 above 128: WG warpgroups of 64 query rows a block.
template <int WG>
int launch_wide_tc(const Args& a, int Dh) {
    return launch_wide(flash_fwd_wide_tc_kernel<WG>, wide::smem_bytes<WG>(), 64 * WG,
                       128 * WG, wide::CHUNK, a, Dh, static_cast<const bf16*>(a.q),
                       static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                       static_cast<bf16*>(a.out), a.lse);
}

bool wide_head_dim(int Dh) { return Dh > WIDE && Dh % WIDE == 0; }

// float32: the FMA kernel, whose tile is fixed at BQ rows.
int dispatch_fma(int Dh, int tile, const Args& a) {
    if (tile != BQ) return (int)cudaErrorInvalidValue;
    switch (Dh) {
        case 32: return launch_fma<32>(a);
        case 64: return launch_fma<64>(a);
        case 128: return launch_fma<128>(a);
    }
    if (wide_head_dim(Dh))
        return launch_wide(flash_attn_fwd_wide_kernel<float>, flash_wide_smem_bytes(),
                           BQ, NT, WIDE, a, Dh, static_cast<const float*>(a.q),
                           static_cast<const float*>(a.k),
                           static_cast<const float*>(a.v),
                           static_cast<float*>(a.out), a.lse);
    return (int)cudaErrorInvalidValue;
}

// 4 warps of 16 rows (tile 64) or of 32 rows (tile 128), as the wrapper's
// launch plan asks.
template <int DH>
int dispatch_tc_tile(int tile, const Args& a) {
    switch (tile) {
        case 64: return launch_tc<DH, 4, 1>(a);
        case 128: return launch_tc<DH, 4, 2>(a);
    }
    return (int)cudaErrorInvalidValue;
}

// bfloat16: the tensor-core kernel, `tile` query rows per block (64 or 128,
// also above Dh = 128).
int dispatch_tc(int Dh, int tile, const Args& a) {
    switch (Dh) {
        case 32: return dispatch_tc_tile<32>(tile, a);
        case 64: return dispatch_tc_tile<64>(tile, a);
        case 128: return dispatch_tc_tile<128>(tile, a);
    }
    if (wide_head_dim(Dh)) {
        switch (tile) {
            case 64: return launch_wide_tc<1>(a, Dh);
            case 128: return launch_wide_tc<2>(a, Dh);
        }
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, N, H, Dh); k, v: (B, Nk, H, Dh) (a block of N query rows against all
// Nk keys, as sequence-parallel attention asks); read through (batch, token,
// head) strides given in elements, last dimension contiguous; for bfloat16
// every row start must be 16-byte aligned. out: contiguous (B, N, H, Dh) of
// the input type. lse: contiguous fp32 (B*H, N). `tile` is the number of query
// rows per block from the wrapper's launch plan: 64 or 128 for bfloat16 (at
// any Dh), 64 for float32. Dh: 32, 64, 128 or a multiple of 128 (the wrapper
// zero-pads the others).
// The kernel is chosen by dtype, here: float32 runs the FMA kernel, bfloat16
// the tensor-core kernel; neither stands in for the other. Returns the
// cudaError_t of the launch (0 on success); launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int dtype, int B, int N,
                              int Nk, int H, int Dh, int tile, long long qsb,
                              long long qsn, long long qsh, long long ksb,
                              long long ksn, long long ksh, long long vsb,
                              long long vsn, long long vsh, double scale,
                              void* stream) {
    const Args a{q, k, v, out, static_cast<float*>(lse), B, N, Nk, H,
                 Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh},
                 Strides{vsb, vsn, vsh}, (float)scale,
                 static_cast<cudaStream_t>(stream)};
    if (dtype == MRI_DTYPE_F32) return dispatch_fma(Dh, tile, a);
    if (dtype == MRI_DTYPE_BF16) return dispatch_tc(Dh, tile, a);
    return (int)cudaErrorInvalidValue;
}
