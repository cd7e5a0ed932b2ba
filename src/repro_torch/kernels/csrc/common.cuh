// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every kernel file exposes plain C entry points that take raw device
// pointers, sizes and the CUDA stream, launch on that stream, and return
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch. Nothing here allocates or synchronises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with repro_torch/kernels/build.py
enum ReproDtype { kReproF32 = 0, kReproBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// round to nearest even, as torch's and XLA's f32 -> bf16 casts do
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__host__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }
