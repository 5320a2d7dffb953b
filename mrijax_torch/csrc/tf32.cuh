// Float32-grade products on Hopper's tensor cores, shared by the float32
// flash kernels (flash_fwd_f32_kernel in flash_attention_fwd.cu,
// flash_bwd_f32_kernel in flash_attention_bwd.cu): three TF32 passes of
// wgmma.mma_async m64nNk8 (N = 32 or 64), A from registers, B from shared
// memory.
//
// x = hi + lo with hi = x truncated to TF32 (13 low mantissa bits cleared)
// and lo = x - hi, of which the tensor cores read the TF32 part (x to
// 2^-20); A B = hi_a hi_b + hi_a lo_b + lo_a hi_b, summed in fp32, the lo lo
// term (2^-20 relative) dropped: fp32-grade work at 495 / 3 = 165 TFLOP/s.
// wgmma reads no 32-bit operand transposed from shared memory, so A comes
// from registers (a fragment read in any order, split as it is read) and B
// from tiles written K-major by the threads that make them.
//
// Shared tiles are rows of 128 bytes (32 floats) in the 128-byte swizzle,
// a tile of R rows kept as blocks of 32 columns, [R rows][128 bytes] each.
// Inside a group of 8 the summed index of a B tile is stored evens first
// (2i at i, 2i + 1 at 4 + i), the order in which an A fragment (k = t,
// t + 4) takes it, so a thread reads each A pair with one 8-byte load.
#pragma once

#include <cstdint>

#include "mma.cuh"
#include "wgmma.cuh"

namespace tf32 {

constexpr int TILE = 64;         // rows of a streamed tile
constexpr int THREADS = 256;     // two warpgroups
constexpr uint32_t ROW = 128;    // bytes of a tile row: 32 floats

// Byte offset of (row r, column c) in a tile of `rows` rows kept as blocks
// of 32 columns, [rows][128 bytes] each, in the 128-byte swizzle.
__device__ __forceinline__ uint32_t at(int rows, int r, int c) {
    return (c >> 5) * rows * ROW + r * ROW + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

// Where a B tile keeps index x of the summed dimension: in each group of 8
// the even ones first (2i at i, 2i + 1 at 4 + i), as the A fragments take them.
__device__ __forceinline__ int kpos(int x) {
    return (x & ~7) | ((x & 1) << 2) | ((x & 7) >> 1);
}

// x = hi + lo as the TF32 products read them: hi = x with its 13 low
// mantissa bits cleared (a TF32 value, used as it is), lo = x - hi (exact in
// fp32), of which the tensor cores use the TF32 part, within 2^-10 of lo:
// hi + lo is x to 2^-20.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xFFFFE000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// An A fragment of m64nNk8 tf32 (rows g, g + 8 of the warp's 16; k t, t + 4)
// as hi and lo terms.
struct Frag {
    uint32_t hi[4], lo[4];
};

// d = A B + (scale_d ? d : 0): A (64 x 8) from registers, B (8 x 32) K-major
// at descriptor b.
__device__ __forceinline__ void m64n32k8(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d = A B + (scale_d ? d : 0): A (64 x 8) from registers, B (8 x 64) K-major
// at descriptor b.
__device__ __forceinline__ void m64n64k8(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d += A B in three TF32 passes, B's hi and lo terms at shared bhi, blo.
__device__ __forceinline__ void mma3(float (&d)[4][4], const Frag& a, uint32_t bhi,
                                     uint32_t blo, int keep) {
    const uint64_t h = wgmma::desc_k(bhi), l = wgmma::desc_k(blo);
    m64n32k8(d, a.hi, h, keep);
    m64n32k8(d, a.hi, l, 1);
    m64n32k8(d, a.lo, h, 1);
}

__device__ __forceinline__ void mma3(float (&d)[8][4], const Frag& a, uint32_t bhi,
                                     uint32_t blo, int keep) {
    const uint64_t h = wgmma::desc_k(bhi), l = wgmma::desc_k(blo);
    m64n64k8(d, a.hi, h, keep);
    m64n64k8(d, a.hi, l, 1);
    m64n64k8(d, a.lo, h, 1);
}

__device__ __forceinline__ float2 ld2(const unsigned char* p) {
    return *reinterpret_cast<const float2*>(p);
}

// The fragment of k-step kk over a tile's columns (times mul), for tile rows
// r and r + 8: columns 8 kk + 2t and + 1 as k t and t + 4.
__device__ __forceinline__ void frag_rows(Frag& f, const unsigned char* x, int r, int kk, int t,
                                          float mul) {
    const int c = kk * 8 + 2 * t;
    const float2 u = ld2(x + at(TILE, r, c)), w = ld2(x + at(TILE, r + 8, c));
    split(u.x * mul, f.hi[0], f.lo[0]);
    split(w.x * mul, f.hi[1], f.lo[1]);
    split(u.y * mul, f.hi[2], f.lo[2]);
    split(w.y * mul, f.hi[3], f.lo[3]);
}

// The fragment of k-step kk over a tile's rows of the transposed tile (times
// mul): columns d and d + 1 as rows g and g + 8, rows 8 kk + 2t and + 1 as k
// t and t + 4.
__device__ __forceinline__ void frag_cols(Frag& f, const unsigned char* x, int d, int kk, int t,
                                          float mul) {
    const int r = kk * 8 + 2 * t;
    const float2 u = ld2(x + at(TILE, r, d)), w = ld2(x + at(TILE, r + 1, d));
    split(u.x * mul, f.hi[0], f.lo[0]);
    split(u.y * mul, f.hi[1], f.lo[1]);
    split(w.x * mul, f.hi[2], f.lo[2]);
    split(w.y * mul, f.hi[3], f.lo[3]);
}

// ROWS rows x WC columns of a (B, N, H, Dh) operand from column col0 of row
// row0 on, into a tile at shared address dst, 16-byte cp.async; rows beyond
// N are zero-filled and not read.
template <int ROWS, int WC>
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* base, long long stride_n,
                                          int row0, int N, int col0, int tid) {
    constexpr int CPR = WC / 4, EACH = ROWS * CPR / THREADS;
    static_assert(EACH * THREADS == ROWS * CPR, "the threads must share the chunks evenly");
#pragma unroll
    for (int i = 0; i < EACH; ++i) {
        const int e = tid + i * THREADS, r = e / CPR, c = e % CPR * 4;
        const bool ok = row0 + r < N;
        const float* src = ok ? base + (long long)(row0 + r) * stride_n + col0 + c : base;
        mma::cp_async_16_zfill(dst + at(ROWS, r, c), src, ok);
    }
}

// After its own copies of copy_rows<ROWS, WC>(raw) landed, a thread writes
// the chunks it brought, times mul, as hi and lo terms at their kpos columns.
template <int WC, int ROWS>
__device__ __forceinline__ void split_own(unsigned char* hi, unsigned char* lo,
                                          const unsigned char* raw, float mul, int tid) {
    constexpr int CPR = WC / 4, EACH = ROWS * CPR / THREADS;
#pragma unroll
    for (int i = 0; i < EACH; ++i) {
        const int e = tid + i * THREADS, r = e / CPR, c = e % CPR * 4;
        const float4 x = *reinterpret_cast<const float4*>(raw + at(ROWS, r, c));
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            uint32_t h, l;
            split(xs[j] * mul, h, l);
            const uint32_t o = at(ROWS, r, kpos(c + j));
            *reinterpret_cast<uint32_t*>(hi + o) = h;
            *reinterpret_cast<uint32_t*>(lo + o) = l;
        }
    }
}

}  // namespace tf32
