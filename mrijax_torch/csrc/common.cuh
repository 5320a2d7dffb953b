// Helpers shared by the hand-written kernels of mrijax_torch.
//
// The kernels are compiled for sm_90a into shared libraries with a plain C
// interface (no PyTorch headers) and loaded with ctypes by
// mrijax_torch/kernels/_build.py. Element types are selected by a small
// integer code that the Python wrappers pass in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes — must match mrijax_torch/kernels/_build.py::DTYPE_CODES
#define MRI_DTYPE_F32 0
#define MRI_DTYPE_BF16 1

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// Round a float to the nearest value representable in T (identity for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
    return to_float<T>(from_float<T>(v));
}

// VEC elements of T moved by one load/store instruction (4, 8 or 16 bytes).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};
