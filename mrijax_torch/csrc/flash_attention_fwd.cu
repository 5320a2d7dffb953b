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
// float32 -> flash_fwd_f32_kernel (namespace f32), on Hopper's warpgroup
// products, at every head dim:
// * What bounds it: operations. The TPU kernel runs fp32 at
//   Precision.HIGHEST; here both products are three TF32 passes on wgmma
//   (tf32.cuh: x = hi + lo, hi = x with its 13 low mantissa bits cleared,
//   A B = hi hi + hi lo + lo hi in fp32): 4 B H Nq Nk Dh flops at 495 / 3 =
//   165 TFLOP/s, against 67 on the CUDA cores. One TF32 pass, what
//   allow_tf32 gives, is another function and misses the 1e-4 bar
//   (tests/test_torch_flash_f32_forward.py emulates both).
// * flash_bwd_f32_kernel's dq design turned into the forward. A block owns
//   OWN query rows of one (batch, head) (64 up to Dh 256, 32 above: the
//   q' terms and O^T must fit), two warpgroups, and streams the keys in
//   tiles of 64. Both products run transposed, A from registers split as
//   it is read, B from K-major tiles:
//     logits  S^T  = K q'^T    (M: the tile's 64 keys, N: the own rows)
//     P V     O^T += V^T P^T   (M: 64 columns of Dh,   N: the own rows)
//   B of the logits is q' = fp32(q Dh^-1/2) split once into resident hi
//   and lo terms [own][kpos(column)]; B of P V is P's terms [own][kpos(key)].
// * The warpgroups halve both products: the logits along what they sum
//   (each warpgroup half of every unit's columns; the two partial S^T meet
//   in shared memory and are added), P V along what it writes (each
//   warpgroup 64 of every 128 columns; at Dh 32 and 64 both compute the
//   unit's columns and each stores its half).
// * The softmax runs on the rows of that shared tile: the partial S^T sit
//   at the P terms' places, and 256 / OWN consecutive threads take an own
//   row, 64 OWN / 256 keys each, so its max and sum are two or three
//   shuffles and no warp waits for another. Keys beyond Nk get -1e30 before
//   the max; P = 2^(S log2 e - m log2 e) on ex2, split into P's terms in
//   place; l sums the unrounded P in a fixed order; alpha = 2^((m_old - m)
//   log2 e) goes through shared memory to the O^T columns.
// * A tile's V^T P^T is summed from zero in the tensor cores and added to
//   O^T by an fma in registers, O^T = alpha O^T + V^T P^T: the tensor
//   cores' fp32 additions are not rounded to nearest, so a sum over all keys
//   kept inside them drifts with N, and at N = 51 200 out missed its 1e-5
//   bar on an H100 (scripts/probe_torch_flash_f32_fwd.py builds that
//   variant, sum_in_tensor_cores). The products share one accumulator with
//   the logits, which are dead by then.
// * O^T stays in registers, CW OWN / 256 a thread (32 at Dh 128, 64 at 256
//   and 512), so up to Dh 512 a block holds every output column and the
//   logits are computed once. Above 512 the resident q' terms no longer fit beside
//   the ring and O^T not in the registers: a block owns a chunk of CW = 512
//   output columns (256 or 128 where Dh is no multiple of 512; grid z), q's
//   rows come with K's in every logit unit and are split anew, and every
//   chunk recomputes the logits.
// * K and V come raw (cp.async, 4 bytes an element) through a ring of R
//   slots (2 to 4, as many as fit) in units of 64 keys x min(Dh, 128)
//   columns: Dh / 128 logit units of K, then CW / 128 P V units of V a
//   tile, one block barrier a unit and one between the partial logits and
//   the softmax. Shared memory at Dh 128: q' terms 64 KB, four 32 KB slots,
//   P's terms 32 KB, alpha and l, 1 KB to align the swizzle: 226 KB, one
//   block an SM.
// * out = O / l and lse = m + log(max(l, 1e-30)) (chunk 0). Rows beyond Nq
//   are zero-filled, computed and not stored. No atomics: every output is
//   summed by one thread in a fixed order, so launches agree bit for bit.

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"
#include "tf32.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
    long long b, n, h;  // in elements; the last dimension has stride 1
};

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
// bfloat16 takes it in column chunks: a block owns a tile of query rows and
// ONE chunk of 256 output columns (grid z), so its fp32 accumulator fits
// the register file at any Dh; it computes the logits over all of Dh and
// P V for its own chunk of V only. Every chunk computes the same logits and
// lse; chunk 0 writes lse. float32 is flash_fwd_f32_kernel, further down.

constexpr int WIDE = 128;                  // the multiple a head dim above 128 is padded to

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

// ---------------------------------------------------------------- float32
//
// flash_fwd_f32_kernel: the design notes at the top of the file.
namespace f32 {

using namespace tf32;   // TILE: keys of a tile; THREADS, ROW

constexpr int UNIT = 128;          // columns of a unit above Dh 128
constexpr int MAX_SMEM = 232448;   // shared bytes a block may ask for

// Own query rows of a block at head dim DH (0: above 512).
constexpr int own_rows(int dh) { return dh && dh <= 256 ? 64 : 32; }

// Shared memory of one instance (DH = 0: above 512, q streamed), in bytes
// from a 1024-byte boundary: the q' terms (streamed: two buffers of a
// unit's), a ring of R slots of units, the P terms, alpha and l of the own
// rows.
template <int OWN, int DH>
struct Layout {
    static constexpr bool RES = DH > 0;                              // q' terms resident
    static constexpr int UW = RES && DH < UNIT ? DH : UNIT;          // columns of a unit
    static constexpr uint32_t own_t = OWN * (RES ? DH : UW) * 4;     // one q' term
    static constexpr uint32_t kv = TILE * UW * 4;                    // K or V of a unit
    static constexpr uint32_t slot = kv + (RES ? 0 : OWN * UW * 4);  // streamed: and q's rows
    static constexpr uint32_t term = OWN * TILE * 4;                 // a P term, [own][key]
    static constexpr uint32_t own = 0, slots = (RES ? 2 : 4) * own_t;
    static constexpr int rest = MAX_SMEM - 1024 - (int)slots - 2 * (int)term - 8 * OWN;
    static constexpr int R = rest / (int)slot < 4 ? rest / (int)slot : 4;   // slots of the ring
    static constexpr uint32_t p = slots + R * slot, alpha = p + 2 * term, l = alpha + 4 * OWN;
    static constexpr size_t bytes = 1024 + l + 4 * OWN;
    static_assert(R >= 2 && bytes <= MAX_SMEM, "a ring of two slots at least");
    static_assert(!RES || R * slot >= own_t, "q's rows come in through the slots");
};

// c (+)= S^T over one logit unit: the unit's K rows r, r + 8 (raw, split as
// read) times the q' terms at bhi, blo, over this warpgroup's half of the
// unit's UW columns, k-steps kb0 on of the terms' (blocks of 32 columns, NF
// 8 rows). With `first` the sum starts from zero. B k-steps a batch (fewer
// where Dh is UW), the next batch's fragments made while the last one's
// products run.
template <int NF, int UW, int B>
__device__ __forceinline__ void logits(float (&c)[NF][4], const unsigned char* x, uint32_t bhi,
                                       uint32_t blo, int kb0, int r, int t, int wg, bool first) {
    constexpr int STEPS = UW / 16, BATCH = STEPS < B ? STEPS : B, BATCHES = STEPS / BATCH;
    constexpr uint32_t BLOCK = NF * 8 * ROW;
    Frag f[2][BATCH];
    wgmma::fence_operand(c);
#pragma unroll
    for (int bt = 0; bt < BATCHES; ++bt) {
#pragma unroll
        for (int s = 0; s < BATCH; ++s)
            frag_rows(f[bt & 1][s], x, r, wg * STEPS + bt * BATCH + s, t, 1.f);
        wgmma::fence();
#pragma unroll
        for (int s = 0; s < BATCH; ++s) {
            const int kk = kb0 + wg * STEPS + bt * BATCH + s;
            const uint32_t off = (kk >> 2) * BLOCK + (kk & 3) * 32;
            mma3(c, f[bt & 1][s], bhi + off, blo + off, !first || bt * BATCH + s > 0);
        }
        wgmma::commit();
        wgmma::wait<1>();
    }
    wgmma::wait<0>();
    wgmma::fence_operand(c);
}

// o = V^T P^T over one tile of 64 keys, summed from zero: A the V unit's
// columns d, d + 1 (raw, split as read), B the P terms at phi, plo; BATCH
// k-steps a batch.
template <int NF, int BATCH>
__device__ __forceinline__ void pv(float (&o)[NF][4], const unsigned char* x, int d, uint32_t phi,
                                   uint32_t plo, int t) {
    constexpr int BATCHES = TILE / 8 / BATCH;
    constexpr uint32_t BLOCK = NF * 8 * ROW;
    Frag f[2][BATCH];
    wgmma::fence_operand(o);
#pragma unroll
    for (int bt = 0; bt < BATCHES; ++bt) {
#pragma unroll
        for (int s = 0; s < BATCH; ++s) frag_cols(f[bt & 1][s], x, d, bt * BATCH + s, t, 1.f);
        wgmma::fence();
#pragma unroll
        for (int s = 0; s < BATCH; ++s) {
            const int kk = bt * BATCH + s;
            const uint32_t off = (kk >> 2) * BLOCK + (kk & 3) * 32;
            mma3(o, f[bt & 1][s], phi + off, plo + off, kk > 0);
        }
        wgmma::commit();
        wgmma::wait<1>();
    }
    wgmma::wait<0>();
    wgmma::fence_operand(o);
}

// The key that position x of a [own][kpos(key)] row holds (kpos inverted).
__device__ __forceinline__ int key_at(int x) {
    return (x & ~7) | ((x & 3) << 1) | ((x >> 2) & 1);
}

}  // namespace f32

// OWN query rows a block. DH: 32, 64, 128, 256, 384 or 512 (CW = DH: the
// q' terms resident, every output column); or 0 above 512 (Dh): a block
// owns a chunk of CW = 512, 256 or 128 output columns (grid z), q streamed.
template <int OWN, int DH, int CW>
__global__ void __launch_bounds__(f32::THREADS, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int NQ, int NK, int H, int Dh, Strides qs,
                     Strides ks, Strides vs, float scale) {
    using namespace f32;
    using LY = Layout<OWN, DH>;
    constexpr bool RES = LY::RES;
    constexpr int UW = LY::UW, R = LY::R;
    constexpr int NF = OWN / 8;          // 8-column fragments of the own rows
    constexpr int NP = CW / UW;          // P V units a tile: a 64-column block of O^T each
    constexpr int HALF = UW / 2;         // a warpgroup's columns of a unit
    constexpr int TPC = THREADS / OWN;   // softmax threads of an own row
    constexpr int KPT = TILE / TPC;      // keys of a softmax thread
    constexpr int BATCH = NP > 1 ? 2 : 4;   // k-steps a batch of products (registers)
    static_assert(RES ? CW == DH : CW % UNIT == 0, "a chunk of whole units");

    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = mma::smem_addr(smem_raw);
    const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
    unsigned char* const sp = smem_raw + pad;
    const uint32_t sa = raw + pad;
    float* const alpha_s = reinterpret_cast<float*>(sp + LY::alpha);
    float* const l_s = reinterpret_cast<float*>(sp + LY::l);

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int wq = (tid & 127) >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int r = 16 * wq + g;    // the fragments' key (and r + 8)
    // the softmax thread's own row, and its keys' places KPT sq .. in the terms
    const int scol = tid / TPC, sq = tid % TPC;
    // O^T rows of this warpgroup in a P V unit: columns dcol, dcol + 1 of
    // the unit (wrapped below 128: computed, stored from one warpgroup)
    const int dloc = 16 * wq + 2 * g, dcol = (wg * HALF + dloc) % UW;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int own0 = blockIdx.x * OWN;
    const int c0 = RES ? 0 : blockIdx.z * CW;
    const int DHT = RES ? DH : Dh;
    const int NL = DHT / UW;             // logit units a tile
    const int per_tile = NL + NP;
    const int ntiles = (NK + TILE - 1) / TILE, total = ntiles * per_tile;

    const float* qb = q + b * qs.b + h * qs.h;
    const float* kb = k + b * ks.b + h * ks.h;
    const float* vb = v + b * vs.b + h * vs.h;

    // unit u of the stream: of tile u / per_tile a logit unit (K's columns
    // of the unit; streamed: q's too) or a P V unit (V's columns of the chunk)
    auto load_unit = [&](int u) {
        if (u >= total) return;
        const int j = u / per_tile, w = u - j * per_tile;
        const uint32_t slot = sa + LY::slots + (u % R) * LY::slot;
        if (w < NL) {
            copy_rows<TILE, UW>(slot, kb, ks.n, j * TILE, NK, w * UW, tid);
            if constexpr (!RES)
                copy_rows<OWN, UW>(slot + LY::kv, qb, qs.n, own0, NQ, w * UW, tid);
        } else {
            copy_rows<TILE, UW>(slot, vb, vs.n, j * TILE, NK, c0 + (w - NL) * UW, tid);
        }
    };
    if constexpr (RES) {
        // the own rows, raw, through the slots, and their terms once for the block
        copy_rows<OWN, DH>(sa + LY::slots, qb, qs.n, own0, NQ, 0, tid);
        mma::cp_async_commit();
        mma::cp_async_wait<0>();
        split_own<DH, OWN>(sp + LY::own, sp + LY::own + LY::own_t, sp + LY::slots, scale, tid);
        __syncthreads();  // the raw rows read: the slots are free
    }
#pragma unroll
    for (int u = 0; u < R - 1; ++u) {
        load_unit(u);
        mma::cp_async_commit();
    }

    // O^T, and the products' accumulator: a tile's partial logits, then its
    // V^T P^T of one unit, summed from zero in the tensor cores and added to
    // O^T in registers, so that no sum runs longer than a tile inside them
    // (their fp32 additions are not rounded to nearest)
    float o[NP][NF][4], c[NF][4];
#pragma unroll
    for (int a = 0; a < NP; ++a)
#pragma unroll
        for (int jn = 0; jn < NF; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[a][jn][e] = 0.f;
#pragma unroll
    for (int jn = 0; jn < NF; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[jn][e] = 0.f;
    float m = NEG_INF, l = 0.f;   // the softmax thread's own row

    unsigned char* const part = sp + LY::p;   // P hi; P lo LY::term on
    // Every loop runs at least once (NK >= 1, NL >= 1): a path around one
    // would carry an accumulator past a wait without a product, and ptxas
    // would serialize the products.
    int u = 0, j = 0;
    do {
        int lu = 0;
        do {
            mma::cp_async_wait<R - 2>();  // unit u landed
            const unsigned char* x = sp + LY::slots + (u % R) * LY::slot;
            uint32_t bq = sa + LY::own;
            int kb0 = lu * (UW / 8);
            if constexpr (!RES) {
                // this unit's q' terms, into buffer u & 1 (its last readers,
                // unit u - 2's products, are done)
                unsigned char* ob = sp + LY::own + (u & 1) * 2 * LY::own_t;
                split_own<UW, OWN>(ob, ob + LY::own_t, x + LY::kv, scale, tid);
                bq += (u & 1) * 2 * LY::own_t;
                kb0 = 0;
            }
            wgmma::fence_proxy_async();
            __syncthreads();  // unit u in place; slot u - 1 free
            load_unit(u + R - 1);
            mma::cp_async_commit();
            logits<NF, UW, BATCH>(c, x, bq, bq + LY::own_t, kb0, r, t, wg, lu == 0);
            ++u;
        } while (++lu < NL);

        // The two partial S^T, [own][kpos(key)]: warpgroup 0's at the P hi
        // term, 1's at P lo (their last readers, the last tile's P V, are
        // done); then the softmax thread of own row scol takes the places
        // KPT sq .. KPT sq + KPT - 1 of its row in both, adds them, and
        // writes P's terms there.
#pragma unroll
        for (int jn = 0; jn < NF; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                *reinterpret_cast<float*>(part + wg * LY::term +
                                          at(OWN, 8 * jn + 2 * t + (e & 1), kpos(r + 8 * (e >> 1)))) =
                    c[jn][e];
        __syncthreads();  // the partial logits in place
        {
            const int k0 = j * TILE;
            float s[KPT];
#pragma unroll
            for (int i = 0; i < KPT / 4; ++i) {
                const uint32_t o4 = at(OWN, scol, sq * KPT + 4 * i);
                const float4 s0 = *reinterpret_cast<const float4*>(part + o4);
                const float4 s1 = *reinterpret_cast<const float4*>(part + LY::term + o4);
                s[4 * i] = s0.x + s1.x;
                s[4 * i + 1] = s0.y + s1.y;
                s[4 * i + 2] = s0.z + s1.z;
                s[4 * i + 3] = s0.w + s1.w;
            }
            if (k0 + TILE > NK) {
#pragma unroll
                for (int e = 0; e < KPT; ++e)
                    if (k0 + key_at(sq * KPT + e) >= NK) s[e] = NEG_INF;
            }
            float mc = NEG_INF;
#pragma unroll
            for (int e = 0; e < KPT; ++e) mc = fmaxf(mc, s[e]);
#pragma unroll
            for (int off = 1; off < TPC; off <<= 1)
                mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
            const float mn = fmaxf(m, mc);
            const float alpha = mma::fast_exp2((m - mn) * mma::LOG2E);
            const float mn2 = mn * mma::LOG2E;
            float rs = 0.f;
#pragma unroll
            for (int i = 0; i < KPT / 4; ++i) {
                uint32_t hi[4], lo[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float pe = mma::fast_exp2(fmaf(s[4 * i + e], mma::LOG2E, -mn2));
                    rs += pe;
                    split(pe, hi[e], lo[e]);
                }
                const uint32_t o4 = at(OWN, scol, sq * KPT + 4 * i);
                *reinterpret_cast<uint4*>(part + o4) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
                *reinterpret_cast<uint4*>(part + LY::term + o4) =
                    make_uint4(lo[0], lo[1], lo[2], lo[3]);
            }
#pragma unroll
            for (int off = 1; off < TPC; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l = alpha * l + rs;
            m = mn;
            if (sq == 0) alpha_s[scol] = alpha;
            wgmma::fence_proxy_async();
        }

#pragma unroll
        for (int a = 0; a < NP; ++a) {
            mma::cp_async_wait<R - 2>();  // unit u landed
            __syncthreads();  // ... for all; P and alpha in place; slot u - 1 free
            load_unit(u + R - 1);
            mma::cp_async_commit();
            pv<NF, BATCH>(c, sp + LY::slots + (u % R) * LY::slot, dcol, sa + LY::p,
                          sa + LY::p + LY::term, t);
            // O^T = alpha O^T + the tile's, per column (own rows 8 jn + 2t, + 1)
#pragma unroll
            for (int jn = 0; jn < NF; ++jn) {
                const float2 al = *reinterpret_cast<const float2*>(alpha_s + 8 * jn + 2 * t);
                o[a][jn][0] = fmaf(o[a][jn][0], al.x, c[jn][0]);
                o[a][jn][1] = fmaf(o[a][jn][1], al.y, c[jn][1]);
                o[a][jn][2] = fmaf(o[a][jn][2], al.x, c[jn][2]);
                o[a][jn][3] = fmaf(o[a][jn][3], al.y, c[jn][3]);
            }
            ++u;
        }
    } while (++j < ntiles);

    // lse of the own rows (chunk 0), l for the division; out = O / l as
    // 8-byte pieces (columns dcol, dcol + 1) of the rows below Nq; every
    // valid row has seen a valid key, so l >= 1
    if (sq == 0) {
        l_s[scol] = l;
        const int n = own0 + scol;
        if (c0 == 0 && n < NQ) lse[(long long)bh * NQ + n] = m + logf(fmaxf(l, 1e-30f));
    }
    __syncthreads();
    if (dloc >= HALF) return;
#pragma unroll
    for (int a = 0; a < NP; ++a) {
        const int d = c0 + a * UW + dcol;
#pragma unroll
        for (int jn = 0; jn < NF; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int n = own0 + 8 * jn + 2 * t + e;
                if (n >= NQ) continue;
                const float lv = l_s[8 * jn + 2 * t + e];
                *reinterpret_cast<float2*>(out + (((long long)b * NQ + n) * H + h) * DHT + d) =
                    make_float2(o[a][jn][e] / lv, o[a][jn][e + 2] / lv);
            }
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

// float32: flash_fwd_f32_kernel, OWN query rows a block; above Dh 512 one
// chunk of CW output columns a block (grid z).
template <int OWN, int DH, int CW = DH>
int launch_f32(const Args& a, int Dh) {
    auto kernel = flash_fwd_f32_kernel<OWN, DH, CW>;
    constexpr size_t smem = f32::Layout<OWN, DH>::bytes;
    if (int err = raise_smem_limit(kernel, smem)) return err;
    const dim3 grid((unsigned)((a.NQ + OWN - 1) / OWN), (unsigned)(a.B * a.H),
                    (unsigned)(DH ? 1 : Dh / CW));
    kernel<<<grid, f32::THREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.NQ, a.NK, a.H, Dh,
        a.qs, a.ks, a.vs, a.scale);
    return (int)cudaGetLastError();
}

int dispatch_f32(int Dh, const Args& a) {
    using f32::own_rows;
    switch (Dh) {
        case 32: return launch_f32<own_rows(32), 32>(a, Dh);
        case 64: return launch_f32<own_rows(64), 64>(a, Dh);
        case 128: return launch_f32<own_rows(128), 128>(a, Dh);
        case 256: return launch_f32<own_rows(256), 256>(a, Dh);
        case 384: return launch_f32<own_rows(384), 384>(a, Dh);
        case 512: return launch_f32<own_rows(512), 512>(a, Dh);
    }
    if (wide_head_dim(Dh)) {
        if (Dh % 512 == 0) return launch_f32<own_rows(0), 0, 512>(a, Dh);
        if (Dh % 256 == 0) return launch_f32<own_rows(0), 0, 256>(a, Dh);
        return launch_f32<own_rows(0), 0, 128>(a, Dh);
    }
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
// rows per block of the bfloat16 kernels from the wrapper's launch plan: 64
// or 128 (at any Dh); float32 does not read it (its rows are
// f32::own_rows(Dh)). Dh: 32, 64, 128 or a multiple of 128 (the wrapper
// zero-pads the others).
// The kernel is chosen by dtype, here: float32 runs flash_fwd_f32_kernel
// (three TF32 passes on wgmma), bfloat16 flash_fwd_tc_kernel at Dh <= 128
// and flash_fwd_wide_tc_kernel above; neither type stands in for the other.
// Returns the cudaError_t of the launch (0 on success); launches on
// `stream`, does not synchronise, allocates nothing.
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
    if (dtype == MRI_DTYPE_F32) return dispatch_f32(Dh, a);
    if (dtype == MRI_DTYPE_BF16) return dispatch_tc(Dh, tile, a);
    return (int)cudaErrorInvalidValue;
}
