// Helpers of the streaming kernels (B1's streaming products in
// grouped_ffn.cu, B4's streaming kernel in moe_megakernel.cu, B5 and B6 in
// flash_decode.cu).
//
// Device side: the mbarrier and bulk-copy wrappers of a ring of shared
// memory stages that one producer warp fills with cp.async.bulk (global ->
// shared, completing on an mbarrier), and shared-memory loads that widen
// bf16 to f32. Host side: the resident-block count of a persistent
// grid and what the card reports for one compiled kernel.
#pragma once

#include "common.cuh"

__device__ __forceinline__ int ceil_div_d(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spins until the phase of parity ``parity`` of ``bar`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// four adjacent values of shared memory as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// one 16-byte word (4 f32 or 8 bf16) held in registers, as f32
__device__ __forceinline__ void word_f32(const uint4& t, float (&v)[4]) {
  v[0] = __uint_as_float(t.x); v[1] = __uint_as_float(t.y);
  v[2] = __uint_as_float(t.z); v[3] = __uint_as_float(t.w);
}

__device__ __forceinline__ void word_f32(const uint4& t, float (&v)[8]) {
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 16 bytes of shared memory (4 f32 or 8 bf16) as f32
template <typename T, int V>
__device__ __forceinline__ void load16(const T* p, float (&v)[V]) {
  word_f32(*reinterpret_cast<const uint4*>(p), v);
}

// resident blocks of a persistent kernel of ``threads`` threads over the
// whole card, after raising its shared-memory limit to ``bytes``
template <typename K>
int resident_blocks(K kernel, int threads, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// What the device reports for one kernel: info = {registers per thread,
// shared memory per block (static + dynamic) in bytes, local (spill) bytes
// per thread, resident blocks per SM}
inline int fill_info(const void* fn, int dyn_smem, int threads, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, dyn_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes) + dyn_smem;
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = per_sm;
  return 0;
}
