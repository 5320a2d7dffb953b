// Hopper warpgroup products (wgmma.mma_async, sm_90a) for the bf16 flash
// kernels above Dh 128 (the forward and both backward kernels) and the 3D
// stride-2 convolution and its weight gradient (conv3d_k4s2.cu), and the
// shared-memory layout they read.
//
// Operand tiles are bf16 in the 128-byte swizzle: a tile of R rows is cut
// into blocks of 64 columns, each [R rows][128 bytes] with 16-byte chunk c of
// row r at r * 128 + ((c ^ r % 8) * 16), every block 1024-byte aligned. The
// same block is read two ways:
// * K-major (the summed index runs along the row): A or B of a product whose
//   depth is the tile's columns. 8-row groups lie 1024 bytes apart (SBO); a
//   k16 step moves the start address by 32 bytes inside the 128-byte row.
// * MN-major (the summed index runs down the rows): B (or A) of a product
//   whose depth is the tile's rows, read with the transpose flag. 8-row
//   groups of the depth lie 1024 bytes apart (SBO), blocks of 64 output
//   columns (rows of A) BLOCK_BYTES apart (LBO); a k16 step moves the start
//   by 16 rows.
//
// Accumulator layout of m64nNk16 (f32), for thread i of the warpgroup, warp
// w = i / 32, g = i % 32 / 4, t = i % 4: d[j][0..1] = rows 16 w + g,
// columns 8 j + 2 t .. 8 j + 2 t + 1; d[j][2..3] = the same columns of row
// 16 w + g + 8: the mma.sync m16n8 layout of a warp's 16 rows, N / 8 times.
//
// A product is asynchronous: fence() before a batch (it orders the
// registers' earlier writes), commit() after it, wait<0>() before the
// accumulators are read; fence_operand() keeps the compiler from moving
// reads or writes of the accumulators across those points. Shared memory
// written by ordinary stores (or cp.async) is made visible to the products
// by fence_proxy_async() in every writing thread, then a barrier.
#pragma once

#include <cstdint>

#include "mma.cuh"

namespace wgmma {

typedef __nv_bfloat16 bf16;

constexpr int BLOCK_COLS = 64;                       // bf16 columns of a block
constexpr uint32_t BLOCK_BYTES = 64 * 128;           // a block of 64 rows
constexpr uint32_t GROUP_BYTES = 8 * 128;            // 8 rows of a block

__device__ __forceinline__ void fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R][4]) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[R][4]) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
           static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}
// K-major operand at `addr` (LBO is not read for a swizzled K-major layout)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
    return desc(addr, 16, GROUP_BYTES);
}
// MN-major operand at `addr`: output columns in blocks BLOCK_BYTES apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
    return desc(addr, BLOCK_BYTES, GROUP_BYTES);
}

// Byte offset of (row r, column c) inside a block.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
    return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// 64 rows x 64 nb bf16 columns, from column col0 of rows row0 .. row0 + 63
// of a (B, N, H, Dh) operand (`base` at its (batch, head), row pitch
// stride_n), into nb consecutive blocks at shared byte address dst, with
// 16-byte cp.async by T threads: thread i copies chunk i % 8 of rows
// i / 8 + k T / 8 (k < 512 / T) of every block (all in one swizzle phase,
// T / 8 rows apart). Rows beyond N are zero-filled and not read.
template <int T = 256>
__device__ __forceinline__ void load_blocks(uint32_t dst, const bf16* base,
                                            long long stride_n, int row0, int N,
                                            int col0, int nb, int tid) {
    const int r = tid >> 3, c = tid & 7;
    const uint32_t d0 = dst + r * 128 + ((c ^ (r & 7)) << 4);
    if constexpr (T == 256) {
        // rows r and r + 32, written out: the machine code the backward
        // kernels were measured with (the loop below compiles differently)
        const bool ok0 = row0 + r < N, ok1 = row0 + r + 32 < N;
        const bf16* s0 = ok0 ? base + (long long)(row0 + r) * stride_n + col0 + c * 8 : base;
        const bf16* s1 = ok1 ? base + (long long)(row0 + r + 32) * stride_n + col0 + c * 8 : base;
        for (int i = 0; i < nb; ++i) {
            mma::cp_async_16_zfill(d0 + i * BLOCK_BYTES, ok0 ? s0 + i * BLOCK_COLS : base, ok0);
            mma::cp_async_16_zfill(d0 + i * BLOCK_BYTES + 32 * 128,
                                   ok1 ? s1 + i * BLOCK_COLS : base, ok1);
        }
    } else {
        constexpr int STEP = T / 8, EACH = 64 / STEP;
        bool ok[EACH];
        const bf16* s[EACH];
#pragma unroll
        for (int k = 0; k < EACH; ++k) {
            ok[k] = row0 + r + k * STEP < N;
            s[k] = ok[k] ? base + (long long)(row0 + r + k * STEP) * stride_n + col0 + c * 8
                         : base;
        }
        for (int i = 0; i < nb; ++i)
#pragma unroll
            for (int k = 0; k < EACH; ++k)
                mma::cp_async_16_zfill(d0 + i * BLOCK_BYTES + k * STEP * 128,
                                       ok[k] ? s[k] + i * BLOCK_COLS : base, ok[k]);
    }
}

// After its own copies of load_blocks<T>(..., nb, tid) into `tile` (a
// generic pointer to dst) have landed, a thread turns the chunks it brought
// into q' = round(q * scale).
template <int T = 256>
__device__ __forceinline__ void scale_blocks(unsigned char* tile, int nb, float scale,
                                             int tid) {
    constexpr int STEP = T / 8, EACH = 64 / STEP;
    const int r = tid >> 3, c = tid & 7;
    unsigned char* at = tile + r * 128 + ((c ^ (r & 7)) << 4);
    for (int i = 0; i < nb; ++i)
#pragma unroll
        for (int k = 0; k < EACH; ++k) {
            uint4* x = reinterpret_cast<uint4*>(at + i * BLOCK_BYTES + k * STEP * 128);
            uint4 v = *x;
            v.x = mma::scale_round_bf16(v.x, scale);
            v.y = mma::scale_round_bf16(v.y, scale);
            v.z = mma::scale_round_bf16(v.z, scale);
            v.w = mma::scale_round_bf16(v.w, scale);
            *x = v;
        }
}

// A (64 x 16) K-major at descriptor a, B (16 x 32) K-major at b:
// d = A B + (scale_d ? d : 0)
__device__ __forceinline__ void m64n32k16(float (&d)[4][4], uint64_t a, uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(scale_d));
}

// A (64 x 16) at descriptor a, B (16 x 64) at b, each K-major or, with TA /
// TB set, MN-major (the transpose flags): d = A B + (scale_d ? d : 0)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void m64n64k16(float (&d)[8][4], uint64_t a, uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d += A B: A (64 x 16) from registers, each warp's 16 rows in the
// mma.sync m16n8k16 A-fragment layout (mma.cuh); B (16 x 256) MN-major at b.
__device__ __forceinline__ void m64n256k16_rs_mn(float (&d)[32][4], const uint32_t (&a)[4],
                                                 uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B: A (64 x 16) K-major at descriptor a, B (16 x 128) MN-major at b.
__device__ __forceinline__ void m64n128k16_mn(float (&d)[16][4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(1));
}

// A (64 x 16) at descriptor a, B (16 x 128) at b, each K-major or, with TA /
// TB set, MN-major (the transpose flags): d = A B + (scale_d ? d : 0)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void m64n128k16(float (&d)[16][4], uint64_t a, uint64_t b,
                                           int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// A (64 x 16) at descriptor a, B (16 x 256) at b, each K-major or, with TA /
// TB set, MN-major (the transpose flags): d = A B + (scale_d ? d : 0)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void m64n256k16(float (&d)[32][4], uint64_t a, uint64_t b,
                                           int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

}  // namespace wgmma
