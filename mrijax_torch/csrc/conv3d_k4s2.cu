// 3D convolution with kernel 4, stride 2 and padding 1 on channels-last
// bfloat16 activations, as an implicit GEMM on Hopper's warpgroup products.
//
// Replaces no TPU kernel. The JAX package leaves this convolution to XLA
// (mrijax/models/blocks.py: Downsample, and the transposed convolution of
// Upsample), and the port left it to cuDNN, which has no tensor-core engine
// for it in 3D: its implicit_convolveNd_sgemm ran the UNet3D's two
// Downsamples ~58x from their bound, half of a DDIM step of 3D generation
// (PERF.md). The kernel computes
//
//   y[b, o, n] = bias[n] + sum over k = (kd, kh, kw) and c of
//                x[b, 2 o - 1 + k, c] * w[n, c, k]
//
// (o = (od, oh, ow); taps that fall outside the input read 0). That is the
// forward of mrijax_torch.models.blocks.Downsample and also the input
// gradient of Upsample: the input gradient of a transposed convolution is
// this convolution of the output gradient with the same weight, its two
// channel axes read the other way round, not flipped.
//
// Bound on an H100: operations. At the UNet3D's widths and batch 8 the two
// Downsamples do 322 GFLOP (every tap; 289 without the padding taps) on
// 130 MB of activations and 21 MB of weights: 0.29 ms at 989 TFLOP/s
// against 0.05 ms of bytes at 3.35 TB/s. What the design has to keep up with
// instead is the copies from L2: every tile reads its 128 rows' gathered
// inputs and the whole weight column of its BN channels, 48 KB a k-step of
// 64 at BN 256, ~47 bytes a clock an SM at the full tensor-core rate.
// Copies alone (the products cut out) took 86 % of the kernel's time when
// both operands went through cp.async, the weight's the larger share
// (PERF.md, section 6); so the weight tile travels as one bulk copy.
//
// Design:
// * GEMM view: M = B Do Ho Wo output voxels, N = Cout, K = 64 Cin, with K
//   ordered (kd, kh, kw, c). B of the product is the weight as a (Cout, 4,
//   4, 4, Cin) bf16 matrix, K-major: the channels_last_3d layout the models
//   keep their weights in. The wrapper lays it out once a call as the
//   stages hold it: (Cout / BN tiles, K / 64 k-steps, BN rows, 64), each
//   row's 16-byte pieces in the 128-byte swizzle of wgmma.cuh, rows past
//   Cout zero (one gather of 4.2 MB and 16.8 MB at the UNet's widths).
// * A tile is 128 output voxels by 64 of K. Cin is a multiple of 8, so each
//   16-byte piece of a tile row is 8 channels of one input voxel at one
//   tap (where Cin is a multiple of 64, the whole 128-byte row is). The
//   gather is one 16-byte cp.async a piece, zero-filled where the tap falls
//   in the padding or the row lies past M. The input is read through its
//   batch and spatial strides (channel stride 1), so a slice of a
//   concatenation's gradient needs no copy.
// * Warp-specialised, 3 warpgroups: warpgroup 0 copies (8 gathered A pieces
//   a thread and a stage; thread 0 also the stage's B tile, BN x 128 bytes,
//   as one cp.async.bulk); warpgroups 1 and 2 each multiply 64 of the 128
//   rows by all BN columns with wgmma m64nBNk16, both operands K-major from
//   shared memory, fp32 accumulators in registers (128 a thread at BN 256).
//   BN is 256, 128 or 64, the smallest that covers Cout up to 256.
// * A ring of STAGES = 4 stages (A 16 KB + B BN x 128 bytes: 192 KB at BN
//   256), with a full and an empty mbarrier a stage. A stage is full when
//   each copying thread's pieces have landed (cp.async.mbarrier.arrive.noinc:
//   the thread does not wait for them) and the bulk copy's bytes have; a
//   multiplying thread waits on it, fences for the async proxy the products
//   read through (the A pieces were written by cp.async), issues the stage's
//   four k16 products, waits until the products of the stage before have
//   retired (wgmma.wait_group 1) and arrives on that stage's empty barrier.
// * Persistent tiles: the wrapper launches ceil(tiles / waves) blocks with
//   waves = ceil(tiles / SMs), so every block takes the same number of tiles
//   (blockIdx.x, + gridDim.x, ...); the copying warpgroup loads the next
//   tile's stages while the others run the epilogue.
// * Epilogue: the bias added in fp32, one rounding to bf16, two channels a
//   thread stored into the contiguous (B, Do, Ho, Wo, Cout) output; rows
//   past M and channels past Cout are not stored.
//
// The weight gradient (conv3d_k4s2_wgrad, below) replaces no TPU kernel
// either: XLA differentiates the convolution in the JAX package, and the
// port left it to cuDNN, whose wgrad_alg1_nd_float_engine ran it on CUDA
// cores at ~2 % of peak: 115 ms of a ~317 ms flagship UNet3D training step
// at batch 32, the step's largest operation (PERF.md). It computes, for
// both call sites,
//
//   dW[n, (kd, kh, kw, c)] = sum over small-side voxels o of
//                            P[o, n] * G[2 o - 1 + k, c]     (padding reads 0)
//
// Downsample: P = dy (B, Do, Ho, Wo, Cout), G = x, dW (Cout, 4, 4, 4, Cin),
// the weight's channels_last_3d layout. Upsample (transposed): P = x, its
// input, G = dy, dW (Cin, 4, 4, 4, Cout), read as (Cin, Cout, 4, 4, 4).
//
// Bound on an H100: operations, 2 Cp 64 Cg M: 2.58 TFLOP for the flagship's
// four stride-2 convolutions at batch 32, 2.6 ms at 989 TFLOP/s. As in the
// forward, copies from L2 are what the design has to keep up with.
//
// Design (the forward's, with the roles of the operands turned round):
// * GEMM view: rows (kd, kh, kw, c) of G's channels, 64 Cg of them in
//   tiles of 128; columns P's channels in tiles of BN (64 / 128 / 256, the
//   smallest that covers Cp up to 256); the sum runs over the M voxels of
//   the small side in stages of 64. In shared memory both operands are 64
//   voxels by channels, channels contiguous: wgmma reads both MN-major.
// * A stage of G (the rows) is the forward's gather with the loops turned
//   round: a copying thread holds 8 channels at one tap in each of the
//   tile's two 64-column blocks and 4 voxel rows, whose coordinates it
//   steps by 64 voxels a stage with carries (no division in the loop).
// * A stage of P (the columns) is a plain 2D tile of an (M, Cp) matrix:
//   one TMA box of 64 channels by 64 voxels per 64 columns, issued by one
//   thread, swizzled by the copy engine, zero past M: the copying threads
//   spend nothing on it and go to the gather.
// * Ring, warpgroups, barriers and persistent walk as in the forward.
// * Filling 132 SMs: the output is small beside the sum (64 tiles at the
//   flagship's first level against 3200 stages), so wgrad_plan cuts each
//   tile's sum into `split` parts of whole stages where tiles alone leave
//   SMs idle. A part writes its fp32 sums to a workspace and takes an
//   integer ticket; the tile's last part adds the parts in order 0, 1, ...
//   and rounds once to bf16. No float atomics: two calls give the same
//   bits.

#include <cuda.h>    // CUtensorMap and its enums only: the encoder is looked up at run time
#include <dlfcn.h>

#include <cstdint>

#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;          // output voxels a tile: two multiplying warpgroups of 64
constexpr int BK = 64;           // K a stage: one 128-byte row of every operand row
constexpr int STAGES = 4;
constexpr int THREADS = 384;     // warpgroup 0 copies, warpgroups 1 and 2 multiply
constexpr int COPIERS = 128;
constexpr int MULTIPLIERS = 256;
constexpr uint32_t A_BYTES = BM * 128;
constexpr uint32_t ALIGN = 1024;  // the 128-byte swizzle repeats every 1024 bytes

template <int BN>
struct Layout {
    static constexpr uint32_t B_BYTES = BN * 128;
    static constexpr uint32_t STAGE = A_BYTES + B_BYTES;
    static constexpr uint32_t BARRIERS = STAGES * STAGE;  // full[STAGES], then empty[STAGES]
    static constexpr size_t bytes = BARRIERS + 2 * STAGES * 8 + ALIGN;
};

struct Params {
    const bf16* x;      // (B, D, H, W, C) through the strides below
    const bf16* w;      // (n_tiles, K / 64, BN, 64): the B tile of every stage, swizzled
    const bf16* bias;   // (N,) or null
    bf16* y;            // (M, N) contiguous
    long long sb, sd, sh, sw;   // strides of x in elements; the channel stride is 1
    int D, H, W, C;
    int Do, Ho, Wo;
    int M, N, K;
    int n_tiles, tiles;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the barrier with this parity has completed (on a
// fresh barrier the phase of parity 1 counts as completed).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// Arrive on the barrier and expect `bytes` more of bulk copies on it.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

// One bulk copy (the tensor memory accelerator, no tensor map) of `bytes`
// from global memory to shared memory, counted on the barrier as it lands.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// Arrive on the barrier once every cp.async this thread has issued so far
// has landed (the arrival is one of the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// d (+)= A B, m64nBNk16; both operands K-major, or with MN set both MN-major
template <int BN, int MN = 0>
__device__ __forceinline__ void product(float (&d)[BN / 8][4], uint64_t a, uint64_t b,
                                        int scale_d) {
    if constexpr (BN == 256) {
        wgmma::m64n256k16<MN, MN>(d, a, b, scale_d);
    } else if constexpr (BN == 128) {
        wgmma::m64n128k16<MN, MN>(d, a, b, scale_d);
    } else {
        wgmma::m64n64k16<MN, MN>(d, a, b, scale_d);
    }
}

// The gather of both kernels: 16 bytes (8 channels) of the input voxel (id,
// ih, iw), `at` elements past x, into shared byte address dst; zero-filled
// where the voxel lies outside the D x H x W input.
__device__ __forceinline__ void gather_piece(uint32_t dst, const bf16* x, long long at, int id,
                                             int ih, int iw, int D, int H, int W) {
    const bool ok = (unsigned)id < (unsigned)D && (unsigned)ih < (unsigned)H &&
                    (unsigned)iw < (unsigned)W;
    mma::cp_async_16_zfill(dst, ok ? x + at : x, ok);
}

// Warpgroup 0: thread tid gathers the 16-byte piece c = tid % 8 of A tile
// rows r0 + 16 j (j < 8), r0 = tid / 8, into every stage; all those rows
// share one swizzle phase (r0 % 8). Thread 0 also brings the stage's B tile,
// BN x 128 bytes laid out in the wrapper as the stage holds it, with one bulk
// copy that counts its bytes on the stage's full barrier.
template <int BN>
__device__ __forceinline__ void copy_stages(const Params& p, uint32_t base, uint32_t bars,
                                            int tid) {
    constexpr int A_ROWS = BM / 16;
    constexpr uint32_t STAGE = Layout<BN>::STAGE, B_BYTES = Layout<BN>::B_BYTES;
    const int c = tid & 7, r0 = tid >> 3;
    const uint32_t piece = r0 * 128 + ((c ^ (r0 & 7)) << 4);
    const int KT = p.K / BK;
    int s = 0;  // slot to fill
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * BM, nt = tile % p.n_tiles;
        const bf16* b_src = p.w + (long long)nt * KT * (BN * BK);
        // each row's first input voxel (2 o - 1), and its offset
        long long off[A_ROWS];
        int id0[A_ROWS], ih0[A_ROWS], iw0[A_ROWS];
#pragma unroll
        for (int j = 0; j < A_ROWS; ++j) {
            int m = m0 + r0 + 16 * j;
            if (m < p.M) {
                const int ow = m % p.Wo;
                m /= p.Wo;
                const int oh = m % p.Ho;
                m /= p.Ho;
                const int od = m % p.Do, b = m / p.Do;
                id0[j] = 2 * od - 1;
                ih0[j] = 2 * oh - 1;
                iw0[j] = 2 * ow - 1;
                off[j] = b * p.sb + id0[j] * p.sd + ih0[j] * p.sh + iw0[j] * p.sw;
            } else {  // past M: every tap lies outside, the row is zero-filled
                id0[j] = -8;
                ih0[j] = iw0[j] = 0;
                off[j] = 0;
            }
        }
        int kt = 0;
        do {
            const uint32_t full = bars + 8 * s;
            mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);  // the products have freed slot s
            const uint32_t a_dst = base + s * STAGE + piece;
            if (tid == 0) {
                mbar_expect_tx(full, B_BYTES);
                bulk_copy(base + s * STAGE + A_BYTES, b_src + (long long)kt * (BN * BK), B_BYTES,
                          full);
            }
            const int k = kt * BK + 8 * c;
            const int tap = k / p.C, ci = k - tap * p.C;
            const int kd = tap >> 4, kh = (tap >> 2) & 3, kw = tap & 3;
            const long long tap_off = kd * p.sd + kh * p.sh + kw * p.sw + ci;
#pragma unroll
            for (int j = 0; j < A_ROWS; ++j)
                gather_piece(a_dst + j * 16 * 128, p.x, off[j] + tap_off, id0[j] + kd,
                             ih0[j] + kh, iw0[j] + kw, p.D, p.H, p.W);
            cp_async_arrive(full);  // once this thread's pieces have landed
            if (++s == STAGES) {
                s = 0;
                phase ^= 1;
            }
        } while (++kt < KT);
    }
    mma::cp_async_wait<0>();
}

// Warpgroups 1 and 2: warpgroup 1 + h multiplies rows 64 h .. 64 h + 63 of
// every tile by its BN columns and stores them.
template <int BN>
__device__ __forceinline__ void multiply_tiles(const Params& p, uint32_t base, uint32_t bars,
                                               int tid) {
    constexpr int NF = BN / 8;
    constexpr uint32_t STAGE = Layout<BN>::STAGE;
    const int h = (tid - COPIERS) >> 7;
    const int i = tid & 127;
    const int row = 16 * (i >> 5) + ((i & 31) >> 2);  // accumulator rows row, row + 8
    const int col = 2 * (i & 3);                        // columns 8 j + col, + 1
    const int KT = p.K / BK;
    int s = 0;
    uint32_t phase = 0;
    float acc[NF][4];
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * BM, n0 = (tile % p.n_tiles) * BN;
        int kt = 0, prev = 0;
        do {
            mbar_wait(bars + 8 * s, phase);
            wgmma::fence_proxy_async();  // the gathered A pieces were written by cp.async
            const uint32_t a = base + s * STAGE + h * 64 * 128;
            const uint32_t b = base + s * STAGE + A_BYTES;
            wgmma::fence_operand(acc);
            wgmma::fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                product<BN>(acc, wgmma::desc_k(a + 32 * kk), wgmma::desc_k(b + 32 * kk),
                            kt > 0 || kk > 0);
            wgmma::commit();
            wgmma::wait<1>();  // the stage before has been read: free its slot
            wgmma::fence_operand(acc);
            if (kt > 0) mbar_arrive(bars + 8 * (STAGES + prev));
            prev = s;
            if (++s == STAGES) {
                s = 0;
                phase ^= 1;
            }
        } while (++kt < KT);
        wgmma::wait<0>();
        wgmma::fence_operand(acc);
        mbar_arrive(bars + 8 * (STAGES + prev));

        const int m_top = m0 + 64 * h + row, m_bot = m_top + 8;
        bf16* y_top = p.y + (long long)m_top * p.N;
        bf16* y_bot = p.y + (long long)m_bot * p.N;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
            const int n = n0 + 8 * j + col;
            if (n < p.N) {  // N is a multiple of 8: n + 1 < N too
                float b0 = 0.f, b1 = 0.f;
                if (p.bias) {
                    b0 = __bfloat162float(p.bias[n]);
                    b1 = __bfloat162float(p.bias[n + 1]);
                }
                if (m_top < p.M)
                    *reinterpret_cast<uint32_t*>(y_top + n) =
                        mma::pack_bf16(acc[j][0] + b0, acc[j][1] + b1);
                if (m_bot < p.M)
                    *reinterpret_cast<uint32_t*>(y_bot + n) =
                        mma::pack_bf16(acc[j][2] + b0, acc[j][3] + b1);
            }
        }
    }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1) conv3d_k4s2_kernel(const Params p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = mma::smem_addr(smem_raw);
    const uint32_t base = (raw + ALIGN - 1) & ~(ALIGN - 1);
    const uint32_t bars = base + Layout<BN>::BARRIERS;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bars + 8 * s, COPIERS + 1);               // full: + thread 0's bytes
            mbar_init(bars + 8 * (STAGES + s), MULTIPLIERS);    // empty
        }
    }
    __syncthreads();
    if (tid < COPIERS)
        copy_stages<BN>(p, base, bars, tid);
    else
        multiply_tiles<BN>(p, base, bars, tid);
}

template <int BN>
int launch(const Params& p, int grid, cudaStream_t stream) {
    auto kernel = conv3d_k4s2_kernel<BN>;
    constexpr size_t smem = Layout<BN>::bytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------ weight gradient

struct WgradParams {
    CUtensorMap p_map;  // P as an (M, Cp) matrix: boxes of 64 channels by 64 voxels, 128-byte swizzle
    const bf16* g;      // (B, D, H, W, Cg) through the strides below
    bf16* out;          // (Cp, K) contiguous, K = 64 Cg ordered (kd, kh, kw, c)
    float4* ws;         // split > 1: (units, BN / 8, MULTIPLIERS) partial sums
    int* tickets;       // split > 1: (tiles,) zeros
    long long sb, sd, sh, sw;   // strides of g in elements; the channel stride is 1
    int D, H, W, Cg;
    int Do, Ho, Wo;
    int M, Cp, K;
    int n_tiles, tiles, split, units, steps;
    int step_w, step_h, step_d, step_b;  // a stage's 64 voxels in the radix (Wo, Ho, Do, B)
};

template <int BN>
struct WgradLayout {
    static constexpr uint32_t FLAG = Layout<BN>::BARRIERS + 2 * STAGES * 8;
    static constexpr size_t bytes = Layout<BN>::bytes + 16;
};

// One box of the tensor map (64 channels from column x, 64 voxels from row
// y) into shared memory at dst, in the 128-byte swizzle, counted on the
// barrier as it lands; rows and columns past the matrix read 0.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
        : "memory");
}

// First k-step (of 64 voxels) of part `part` of a tile's sum.
__device__ __forceinline__ int part_start(const WgradParams& p, int part) {
    return (int)((long long)part * p.steps / p.split);
}

// Voxel (b, d, h, w) of the small side moved 64 voxels on: one carry a digit,
// every digit of the step being below its radix.
__device__ __forceinline__ void next_stage(const WgradParams& p, int& b, int& d, int& h, int& w) {
    w += p.step_w;
    int carry = w >= p.Wo;
    if (carry) w -= p.Wo;
    h += p.step_h + carry;
    carry = h >= p.Ho;
    if (carry) h -= p.Ho;
    d += p.step_d + carry;
    carry = d >= p.Do;
    if (carry) d -= p.Do;
    b += p.step_b + carry;
}

// Warpgroup 0 of the weight gradient. Thread tid gathers chunk c = tid % 8
// of rows r0 + 16 j (j < 4), r0 = tid / 8, in both 64-column blocks of the
// G stage: 8 channels at one tap a block, fixed for the unit, of the input
// voxel 2 o - 1 + tap of each row's voxel o; the rows' voxels move 64 on a
// stage. Thread 0 also brings the stage's P rows, one TMA box of 64
// channels a block of BN.
template <int BN>
__device__ __forceinline__ void wgrad_copy(const WgradParams& p, uint32_t base, uint32_t bars,
                                           int tid) {
    constexpr int ROWS = BK / 16;
    constexpr uint32_t STAGE = Layout<BN>::STAGE;
    const int c = tid & 7, r0 = tid >> 3;
    const uint32_t piece = r0 * 128 + ((c ^ (r0 & 7)) << 4);
    int s = 0;  // the slot to fill next
    uint32_t phase = 0;
    for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x) {
        const int tile = unit / p.split, part = unit - tile * p.split;
        const int mt = tile / p.n_tiles, nt = tile - mt * p.n_tiles;
        const int kt1 = part_start(p, part + 1);
        const int boxes = (min(BN, p.Cp - nt * BN) + 63) / 64;
        long long tap_off[2];
        int kd[2], kh[2], kw[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = mt * BM + 64 * e + 8 * c;
            const int tap = col / p.Cg, ch = col - tap * p.Cg;
            kd[e] = tap >> 4;
            kh[e] = (tap >> 2) & 3;
            kw[e] = tap & 3;
            tap_off[e] = kd[e] * p.sd + kh[e] * p.sh + kw[e] * p.sw + ch;
        }
        int kt = part_start(p, part);
        int ob[ROWS], od[ROWS], oh[ROWS], ow[ROWS];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            int m = kt * BK + r0 + 16 * j;
            ow[j] = m % p.Wo;
            m /= p.Wo;
            oh[j] = m % p.Ho;
            m /= p.Ho;
            od[j] = m % p.Do;
            ob[j] = m / p.Do;
        }
        do {
            const uint32_t full = bars + 8 * s;
            mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);  // the products have freed slot s
            const uint32_t stage = base + s * STAGE;
            if (tid == 0) {
                mbar_expect_tx(full, boxes * wgmma::BLOCK_BYTES);
                for (int i = 0; i < boxes; ++i)
                    tma_load_2d(stage + A_BYTES + i * wgmma::BLOCK_BYTES, &p.p_map,
                                nt * BN + 64 * i, kt * BK, full);
            }
#pragma unroll
            for (int j = 0; j < ROWS; ++j) {
                // past M every tap lies outside: the row is zero-filled
                const int id = kt * BK + r0 + 16 * j < p.M ? 2 * od[j] - 1 : -8;
                const int ih = 2 * oh[j] - 1, iw = 2 * ow[j] - 1;
                const long long off = ob[j] * p.sb + id * p.sd + ih * p.sh + iw * p.sw;
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    gather_piece(stage + e * wgmma::BLOCK_BYTES + j * 16 * 128 + piece, p.g,
                                 off + tap_off[e], id + kd[e], ih + kh[e], iw + kw[e], p.D, p.H,
                                 p.W);
                next_stage(p, ob[j], od[j], oh[j], ow[j]);
            }
            cp_async_arrive(full);  // this thread's 8 pieces, once they have landed
            if (++s == STAGES) {
                s = 0;
                phase ^= 1;
            }
        } while (++kt < kt1);
    }
    mma::cp_async_wait<0>();  // nothing of this thread's in flight at exit
}

// Rows r and r + 8, columns n and n + 1 of the product (acc[j] order),
// rounded once into the (Cp, K) output: column n is its row n.
__device__ __forceinline__ void store_grad(const WgradParams& p, int r, int n, float4 v) {
    if (n >= p.Cp) return;  // Cp is a multiple of 8: n + 1 < Cp too
    bf16* o = p.out + (long long)n * p.K + r;
    o[0] = __float2bfloat16_rn(v.x);
    o[p.K] = __float2bfloat16_rn(v.y);
    o[8] = __float2bfloat16_rn(v.z);
    o[p.K + 8] = __float2bfloat16_rn(v.w);
}

__device__ __forceinline__ void multipliers_sync() {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Warpgroups 1 and 2 of the weight gradient: warpgroup 1 + h multiplies
// rows 64 h .. 64 h + 63 of each unit's tile (the G block h) by its BN
// columns over the unit's voxels, both operands MN-major. A unit that holds
// a whole tile's sum stores it; else it writes its part to the workspace
// and takes a ticket, and the tile's last part to arrive sums every part in
// order 0, 1, ... and stores: the same bits whoever comes last.
template <int BN>
__device__ __forceinline__ void wgrad_multiply(const WgradParams& p, uint32_t base,
                                               uint32_t bars, uint32_t flag, int tid) {
    constexpr int NF = BN / 8;
    constexpr uint32_t STAGE = Layout<BN>::STAGE;
    const int t = tid - COPIERS;
    const int h = t >> 7;
    const int i = t & 127;
    const int row = 16 * (i >> 5) + ((i & 31) >> 2);  // accumulator rows row, row + 8
    const int col = 2 * (i & 3);                        // columns 8 j + col, + 1
    int s = 0;
    uint32_t phase = 0;
    float acc[NF][4];
    for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x) {
        const int tile = unit / p.split, part = unit - tile * p.split;
        const int mt = tile / p.n_tiles, nt = tile - mt * p.n_tiles;
        const int kt0 = part_start(p, part), kt1 = part_start(p, part + 1);
        int kt = kt0, prev = 0;
        do {
            mbar_wait(bars + 8 * s, phase);
            wgmma::fence_proxy_async();  // the G pieces came by cp.async
            const uint32_t a = base + s * STAGE + h * wgmma::BLOCK_BYTES;
            const uint32_t b = base + s * STAGE + A_BYTES;
            wgmma::fence_operand(acc);
            wgmma::fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                product<BN, 1>(acc, wgmma::desc_mn(a + kk * 16 * 128),
                               wgmma::desc_mn(b + kk * 16 * 128), kt > kt0 || kk > 0);
            wgmma::commit();
            wgmma::wait<1>();  // the stage before has been read: free its slot
            wgmma::fence_operand(acc);
            if (kt > kt0) mbar_arrive(bars + 8 * (STAGES + prev));
            prev = s;
            if (++s == STAGES) {
                s = 0;
                phase ^= 1;
            }
        } while (++kt < kt1);
        wgmma::wait<0>();
        wgmma::fence_operand(acc);
        mbar_arrive(bars + 8 * (STAGES + prev));

        const int r = mt * BM + 64 * h + row, n0 = nt * BN + col;
        if (p.split == 1) {
#pragma unroll
            for (int j = 0; j < NF; ++j)
                store_grad(p, r, n0 + 8 * j,
                           make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
            continue;
        }
        float4* mine = p.ws + (long long)unit * NF * MULTIPLIERS + t;
#pragma unroll
        for (int j = 0; j < NF; ++j)
            __stcg(mine + j * MULTIPLIERS,
                   make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
        __threadfence();
        multipliers_sync();
        if (t == 0) {
            const int last = atomicAdd(p.tickets + tile, 1) == p.split - 1;
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(flag), "r"(last) : "memory");
        }
        multipliers_sync();
        int last;
        asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(last) : "r"(flag) : "memory");
        if (!last) continue;
        __threadfence();
        const float4* parts = p.ws + (long long)tile * p.split * NF * MULTIPLIERS + t;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
            float4 v = __ldcg(parts + j * MULTIPLIERS);
            for (int q = 1; q < p.split; ++q) {
                const float4 u = __ldcg(parts + (q * NF + j) * MULTIPLIERS);
                v.x += u.x;
                v.y += u.y;
                v.z += u.z;
                v.w += u.w;
            }
            store_grad(p, r, n0 + 8 * j, v);
        }
    }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv3d_k4s2_wgrad_kernel(const __grid_constant__ WgradParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = mma::smem_addr(smem_raw);
    const uint32_t base = (raw + ALIGN - 1) & ~(ALIGN - 1);
    const uint32_t bars = base + Layout<BN>::BARRIERS;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bars + 8 * s, COPIERS + 1);               // full: + thread 0's bytes
            mbar_init(bars + 8 * (STAGES + s), MULTIPLIERS);    // empty
        }
    }
    __syncthreads();
    if (tid < COPIERS)
        wgrad_copy<BN>(p, base, bars, tid);
    else
        wgrad_multiply<BN>(p, base, bars, base + WgradLayout<BN>::FLAG, tid);
}

template <int BN>
int launch_wgrad(const WgradParams& p, int grid, cudaStream_t stream) {
    auto kernel = conv3d_k4s2_wgrad_kernel<BN>;
    constexpr size_t smem = WgradLayout<BN>::bytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, from the driver library the runtime has
// loaded (the library links only the runtime).
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* driver = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
        if (driver != nullptr)
            fn = reinterpret_cast<EncodeTiled>(dlsym(driver, "cuTensorMapEncodeTiled"));
    }
    return fn;
}

}  // namespace

// x: bf16 (B, D, H, W, C) read through element strides (sb, sd, sh, sw),
// channel stride 1, every voxel's row 16-byte aligned; w: bf16, the weight
// as (N, 64 C) with K ordered (kd, kh, kw, c), laid out in B tiles of
// tile_n rows (kernels/conv3d.py::tile_weight): (ceil(N / tile_n), C,
// tile_n, 64), piece q of row r at position q ^ (r % 8), rows past N zero,
// 16-byte aligned; bias: bf16 (N,) or null; y: bf16
// contiguous (B, Do, Ho, Wo, N) with Do = D / 2 (rounded down; D, H, W >= 2).
// C and N multiples of 8. tile_n: 256, 128 or 64 output channels a tile;
// grid: blocks, each walking the tiles blockIdx.x, + grid, ... (the wrapper's
// launch plan). Returns the cudaError_t of the launch (0 on success);
// launches on `stream`, does not synchronise, allocates nothing.
extern "C" int conv3d_k4s2(const void* x, const void* w, const void* bias, void* y, int B,
                           int D, int H, int W, int C, long long sb, long long sd,
                           long long sh, long long sw, int N, int tile_n, int grid,
                           void* stream) {
    if (B < 1 || D < 2 || H < 2 || W < 2 || C < 8 || C % 8 || N < 8 || N % 8 || grid < 1 ||
        (tile_n != 256 && tile_n != 128 && tile_n != 64))
        return (int)cudaErrorInvalidValue;
    Params p;
    p.x = static_cast<const bf16*>(x);
    p.w = static_cast<const bf16*>(w);
    p.bias = static_cast<const bf16*>(bias);
    p.y = static_cast<bf16*>(y);
    p.sb = sb;
    p.sd = sd;
    p.sh = sh;
    p.sw = sw;
    p.D = D;
    p.H = H;
    p.W = W;
    p.C = C;
    p.Do = D / 2;
    p.Ho = H / 2;
    p.Wo = W / 2;
    p.M = B * p.Do * p.Ho * p.Wo;
    p.N = N;
    p.K = 64 * C;
    p.n_tiles = (N + tile_n - 1) / tile_n;
    p.tiles = (p.M + BM - 1) / BM * p.n_tiles;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (tile_n) {
        case 256: return launch<256>(p, grid, s);
        case 128: return launch<128>(p, grid, s);
        case 64: return launch<64>(p, grid, s);
    }
    return (int)cudaErrorInvalidValue;
}

// The weight gradient of the same convolution, as
//
//   out[n, (tap, c)] = sum over voxels o of the small side of
//                      p[o, n] * g[2 o - 1 + tap, c]     (taps outside read 0)
//
// g: bf16 (B, D, H, W, Cg) read through element strides (sb, sd, sh, sw),
// channel stride 1, every voxel's row 16-byte aligned; p: bf16 (B, Do, Ho,
// Wo, Cp) as an (M, Cp) matrix of row pitch p_row elements (a multiple of
// 8, 16-byte aligned), Do = D / 2 (rounded down; D, H, W >= 2); out: bf16
// contiguous (Cp, 4, 4, 4, Cg). Cg and Cp multiples of 8. tile_n: 256, 128
// or 64 columns (channels of p) a tile; split: the parts each tile's sum
// over the M voxels is cut into (at most M / 64 rounded up), with split > 1
// a float32 workspace of units x 128 tile_n floats (units = tiles x split,
// 16-byte aligned) and `tickets`, one zeroed int a tile; grid: blocks, each
// walking the units blockIdx.x, + grid, ... (the wrapper's wgrad_plan).
// Returns the cudaError_t of the launch (0 on success); launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int conv3d_k4s2_wgrad(const void* g, const void* p_rows, void* out, void* ws,
                                 void* tickets, int B, int D, int H, int W, int Cg, long long sb,
                                 long long sd, long long sh, long long sw, long long p_row, int Cp,
                                 int tile_n, int split, int grid, void* stream) {
    if (B < 1 || D < 2 || H < 2 || W < 2 || Cg < 8 || Cg % 8 || Cp < 8 || Cp % 8 ||
        p_row < Cp || p_row % 8 || split < 1 || grid < 1 ||
        (split > 1 && (ws == nullptr || tickets == nullptr)) ||
        (tile_n != 256 && tile_n != 128 && tile_n != 64))
        return (int)cudaErrorInvalidValue;
    WgradParams p;
    p.g = static_cast<const bf16*>(g);
    p.out = static_cast<bf16*>(out);
    p.ws = static_cast<float4*>(ws);
    p.tickets = static_cast<int*>(tickets);
    p.sb = sb;
    p.sd = sd;
    p.sh = sh;
    p.sw = sw;
    p.D = D;
    p.H = H;
    p.W = W;
    p.Cg = Cg;
    p.Do = D / 2;
    p.Ho = H / 2;
    p.Wo = W / 2;
    const long long m = (long long)B * p.Do * p.Ho * p.Wo;
    if (m > 0x7fffffffLL - BK) return (int)cudaErrorInvalidValue;
    p.M = (int)m;
    p.Cp = Cp;
    p.K = 64 * Cg;
    p.n_tiles = (Cp + tile_n - 1) / tile_n;
    p.tiles = p.K / BM * p.n_tiles;
    p.split = split;
    p.units = p.tiles * split;
    p.steps = (p.M + BK - 1) / BK;
    if (split > p.steps) return (int)cudaErrorInvalidValue;
    int q = BK;
    p.step_w = q % p.Wo;
    q /= p.Wo;
    p.step_h = q % p.Ho;
    q /= p.Ho;
    p.step_d = q % p.Do;
    p.step_b = q / p.Do;

    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorSharedObjectInitFailed;
    const cuuint64_t dims[2] = {(cuuint64_t)Cp, (cuuint64_t)p.M};
    const cuuint64_t pitch[1] = {(cuuint64_t)p_row * sizeof(bf16)};
    const cuuint32_t box[2] = {64, BK};
    const cuuint32_t unit_strides[2] = {1, 1};
    if (encode(&p.p_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p_rows), dims,
               pitch, box, unit_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (tile_n) {
        case 256: return launch_wgrad<256>(p, grid, st);
        case 128: return launch_wgrad<128>(p, grid, st);
        case 64: return launch_wgrad<64>(p, grid, st);
    }
    return (int)cudaErrorInvalidValue;
}
