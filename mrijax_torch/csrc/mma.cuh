// Tensor-core building blocks shared by the bf16 flash-attention kernels:
// 16-byte asynchronous copies into padded shared-memory tiles, ldmatrix
// fragment loads, the m16n8k16 bf16 mma with fp32 accumulation, and the
// conversions between accumulator and operand fragments.
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col (g = lane / 4,
// t = lane % 4), each operand register holding two bf16, low half first:
//   A (16 x 16, row major): a0 = (g, 2t..2t+1)      a1 = (g + 8, 2t..2t+1)
//                           a2 = (g, 2t+8..2t+9)    a3 = (g + 8, 2t+8..2t+9)
//   B (16 x 8, col major):  b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32):       c0 = (g, 2t)  c1 = (g, 2t+1)
//                           c2 = (g + 8, 2t)  c3 = (g + 8, 2t+1)
// Two neighbouring C fragments (columns 16 kk .. 16 kk + 15) therefore hold
// exactly the elements of one A fragment: an accumulator tile becomes the A
// operand of the next product by rounding in registers, with no trip through
// shared memory.
//
// Shared-memory tiles are rows of DH bf16 with a pitch of DH + 8 elements
// (16 bytes of padding). The pitch in 16-byte chunks is then odd (5, 9, 17
// for DH = 32, 64, 128), so the 8 rows that one ldmatrix phase reads fall
// into 8 distinct groups of 4 banks: no bank conflicts, for plain and for
// transposed loads, without a swizzle.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace mma {

typedef __nv_bfloat16 bf16;

constexpr int PAD = 8;              // bf16 elements of padding per tile row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1. `dst` is a shared-memory byte
// address; both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :
                 : "r"(dst), "l"(src)
                 : "memory");
}

// The same with a predicate: with !valid nothing is read and the 16 bytes are
// zero-filled.
__device__ __forceinline__ void cp_async_16_zfill(uint32_t dst, const void* src,
                                                  bool valid) {
    const int bytes = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(dst), "l"(src), "r"(bytes)
                 : "memory");
}

// 4 bytes global -> shared (zero-filled with !valid).
__device__ __forceinline__ void cp_async_4_zfill(uint32_t dst, const void* src,
                                                 bool valid) {
    const int bytes = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :
                 : "r"(dst), "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// How NT threads share the 16-byte chunks of a ROWS x DH bf16 tile: a thread
// owns one chunk column, c = tid % CPR, of the rows tid / CPR + i * RSTEP.
template <int ROWS, int DH, int NT>
struct TileCopy {
    static constexpr int CPR = DH / 8;      // chunks per row
    static constexpr int RSTEP = NT / CPR;  // rows between a thread's chunks
    static constexpr int ITER = ROWS / RSTEP;
    static constexpr int LD = DH + PAD;
    static_assert(NT % CPR == 0 && ROWS % RSTEP == 0 && ITER >= 1,
                  "the threads must tile the rows evenly");
};

// ROWS x DH bf16 of a (B, N, H, Dh) tensor, tokens row0 .. row0 + ROWS - 1 of
// one (batch, head), into the shared tile at byte address `dst` (pitch
// DH + PAD) with 16-byte asynchronous copies issued by NT threads; rows beyond
// N are zero-filled and not read. A thread computes one source address and
// steps it by a constant, and a tile that lies inside N takes a path without
// predicates: at one or two warps a scheduler the address arithmetic, not the
// copy, is what a block waits for. After cp_async_wait a thread may touch the
// chunks it copied (see TileCopy) before any barrier. `base` may point at a
// window of DH columns inside longer rows: stride_n is the row pitch.
template <int ROWS, int DH, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* base,
                                                long long stride_n, int row0,
                                                int N, int tid) {
    typedef TileCopy<ROWS, DH, NT> TC;
    const int r0 = row0 + tid / TC::CPR;
    const int c = tid % TC::CPR;
    const uint32_t d0 = dst + ((tid / TC::CPR) * TC::LD + c * 8) * 2;
    const bf16* src = base + (long long)r0 * stride_n + c * 8;
    const long long step = TC::RSTEP * stride_n;
    if (row0 + ROWS <= N) {
#pragma unroll
        for (int i = 0; i < TC::ITER; ++i)
            cp_async_16(d0 + i * TC::RSTEP * TC::LD * 2, src + i * step);
    } else {
#pragma unroll
        for (int i = 0; i < TC::ITER; ++i) {
            const bool ok = r0 + i * TC::RSTEP < N;
            cp_async_16_zfill(d0 + i * TC::RSTEP * TC::LD * 2,
                              ok ? src + i * step : base, ok);
        }
    }
}

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8. Register j receives matrix j: row g, columns 2t..2t+1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// The same, each matrix transposed: register j receives rows 2t..2t+1 of
// column g of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// Per-lane byte offsets, inside a tile of pitch LD elements, of the ldmatrix
// row addresses for a 16 x 16 block whose top-left corner is the tile origin.
//
// a_offset: A operand from a [m][k] tile (registers a0..a3), and also the
//   transposed B operand from a [k][n] tile (ldmatrix_x4_trans gives b0, b1 of
//   columns 0..7 and b0, b1 of columns 8..15).
// b_offset: B operand from a [n][k] tile (plain ldmatrix_x4 gives b0, b1 of
//   rows 0..7 and b0, b1 of rows 8..15).
__device__ __forceinline__ uint32_t a_offset(int lane, int ld) {
    return static_cast<uint32_t>(((lane & 15) * ld + (lane >> 4) * 8) * 2);
}
__device__ __forceinline__ uint32_t b_offset(int lane, int ld) {
    return static_cast<uint32_t>(
        (((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8) * 2);
}

// c += a b, one 16 x 8 x 16 bf16 product on the tensor cores, fp32 sum.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// round(x * scale) to bf16 for both halves of a register: the q' of the
// forward, computed in fp32 and rounded once.
__device__ __forceinline__ uint32_t scale_round_bf16(uint32_t x, float scale) {
    const float2 f = unpack_bf16(x);
    return pack_bf16(f.x * scale, f.y * scale);
}

// After its own copies of a ROWS x DH q tile (load_tile_async with the same
// ROWS, DH, NT) have landed, a thread turns the chunks it brought into
// q' = round(q * scale); a barrier then publishes them.
template <int ROWS, int DH, int NT>
__device__ __forceinline__ void scale_own_chunks(bf16* Qst, float scale,
                                                 int tid) {
    typedef TileCopy<ROWS, DH, NT> TC;
    uint4* chunk = reinterpret_cast<uint4*>(Qst + (tid / TC::CPR) * TC::LD +
                                            (tid % TC::CPR) * 8);
#pragma unroll
    for (int i = 0; i < TC::ITER; ++i) {
        uint4* at = chunk + i * (TC::RSTEP * TC::LD / 8);
        uint4 x = *at;
        x.x = scale_round_bf16(x.x, scale);
        x.y = scale_round_bf16(x.y, scale);
        x.z = scale_round_bf16(x.z, scale);
        x.w = scale_round_bf16(x.w, scale);
        *at = x;
    }
}

// Two-term bf16 split of a pair of floats: hi = bf16(x), lo = bf16(x - hi).
// x - hi is exact in fp32, so hi + lo carries 16 significant bits of x
// (relative error about 2^-17); a product with a bf16 matrix issued once with
// hi and once with lo, summed in fp32, is fp32-grade.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
    hi = pack_bf16(x0, x1);
    const float2 h = unpack_bf16(hi);
    lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// 2^x on the special-function unit (relative error about 2^-22).
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

}  // namespace mma
