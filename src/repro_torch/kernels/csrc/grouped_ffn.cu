// B1 grouped matmul: out[e] = x[e] @ w[e] for every expert e,
// x (E, C, D), w (E, D, F) -> out (E, C, F), f32 accumulation, output in
// the input dtype.
//
// Replaces repro/kernels/grouped_ffn.py::_gmm_impl / _kernel. The TPU
// kernel walks grid (E, C/bc, F/bf, D/bd) with the D axis sequential and
// an f32 VMEM accumulator; blocks are exact divisors of the shape
// (platform.py::fit_block). Here a block owns one (BM x 64) output tile of
// one expert, loops over D inside the block in steps of 16 through shared
// memory and keeps its accumulator in registers; ragged tile edges are
// masked, so any C, D and F work, C = 1 (one decode token per expert)
// included.
//
// What bounds it on the H100: on the serving path C is 1 to 4 rows, so
// every expert's weight matrix is read once for a handful of rows and the
// kernel is bound by the bytes of w. BM adapts to C (16 rows for C <= 16,
// 64 above) so that small C does not pay for 64-row tiles of arithmetic.
// It runs on the CUDA cores in f32; wgmma and TMA come later.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kBN = 64;         // 16 threads x 4 columns
constexpr int kBK = 16;

template <typename T, int TM>   // BM = 16 * TM rows, TM rows per thread
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                      int C, int D, int F) {
  constexpr int BM = 16 * TM;
  __shared__ float As[kBK][BM + 4];    // A tile stored k-major: As[k][m]
  __shared__ float Bs[kBK][kBN + 4];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const T* xe = x + static_cast<size_t>(e) * C * D;
  const T* we = w + static_cast<size_t>(e) * D * F;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column group: columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // row group: rows ty*TM .. ty*TM+TM-1

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    // A tile: BM x 16 values, TM per thread, neighbouring threads on
    // neighbouring k of one row
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int idx = tid + i * kThreads;
      const int mm = idx / kBK, kk = idx % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < C && gk < D) ? to_f32(xe[static_cast<size_t>(gm) * D + gk]) : 0.f;
    }
    // B tile: 16 x 64 values, 4 per thread, neighbouring threads on
    // neighbouring columns of one row of w
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = idx / kBN, nn = idx % kBN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < D && gn < F) ? to_f32(we[static_cast<size_t>(gk) * F + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= C) continue;
    T* orow = out + (static_cast<size_t>(e) * C + gm) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < F) orow[gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch_grouped_matmul(const void* x, const void* w, void* out, int E, int C, int D, int F,
                           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (C <= 16) {
    const dim3 grid(ceil_div(F, kBN), ceil_div(C, 16), E);
    grouped_matmul_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xp, wp, op, C, D, F);
  } else {
    const dim3 grid(ceil_div(F, kBN), ceil_div(C, 64), E);
    grouped_matmul_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xp, wp, op, C, D, F);
  }
}

}  // namespace

extern "C" int repro_grouped_matmul(const void* x, const void* w, void* out, int E, int C, int D,
                                    int F, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kReproF32) {
    launch_grouped_matmul<float>(x, w, out, E, C, D, F, st);
  } else if (dtype == kReproBF16) {
    launch_grouped_matmul<__nv_bfloat16>(x, w, out, E, C, D, F, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
