// B1 grouped matmul: out[e] = A[e] @ B[e] for every expert e, f32
// accumulation, output in the input dtype. One kernel serves the forward
// and both backward products, reading a transposed operand in place
// through its layout (no transposed copy is made):
//
//   forward  out = x  @ w     A = x  (E, C, D)            B = w  (E, D, F)
//   dx       dx  = dy @ w^T   A = dy (E, C, F)            B = w^T, read from w (E, D, F)
//   dw       dw  = x^T @ dy   A = x^T, read from x (E, C, D)   B = dy (E, C, F)
//
// Replaces repro/kernels/grouped_ffn.py::_gmm_impl / _kernel, and its
// custom VJP _gmm_bwd, which runs the same Pallas kernel on
// jnp.swapaxes'd operands. The TPU kernel walks grid (E, C/bc, F/bf,
// D/bd) with the D axis sequential and an f32 VMEM accumulator; blocks
// are exact divisors of the shape (platform.py::fit_block). Here a block
// owns one (BM x 64) output tile of one expert, loops over the reduction
// axis inside the block in steps of 16 through shared memory and keeps its
// accumulator in registers; ragged tile edges are masked, so any sizes
// work, C = 1 (one decode token per expert) included. A transposed operand
// is loaded with neighbouring threads on its contiguous axis, so every
// layout reads whole 64-byte runs.
//
// What bounds it on the H100: on the serving and training paths C is 1 to
// 8 rows, so the forward and dx read every expert's weight matrix once for
// a handful of rows, and dw writes one (e.g. 537 MB of f32 for
// (128, 512, 2048)) from a reduction over only C rows: all three are bound
// by the bytes of the weight-sized operand. BM adapts to M (16 rows for
// M <= 16, 64 above) so that small C does not pay for 64-row tiles of
// arithmetic. It runs on the CUDA cores in f32; wgmma and TMA come later.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kBN = 64;         // 16 threads x 4 columns
constexpr int kBK = 16;

// TM rows per thread (BM = 16 * TM). A_T: A[m][k] = a[k * M + m] (else
// a[m * K + k]). B_T: B[k][n] = b[n * K + k] (else b[k * N + n]).
template <typename T, int TM, bool A_T, bool B_T>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                      int M, int K, int N) {
  constexpr int BM = 16 * TM;
  __shared__ float As[kBK][BM + 4];    // A tile stored k-major: As[k][m]
  __shared__ float Bs[kBK][kBN + 4];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const T* ae = a + static_cast<size_t>(e) * M * K;
  const T* be = b + static_cast<size_t>(e) * K * N;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column group: columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // row group: rows ty*TM .. ty*TM+TM-1

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: BM x 16 values, TM per thread, neighbouring threads on A's
    // contiguous axis (k, or m when A is read transposed)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int idx = tid + i * kThreads;
      const int mm = A_T ? idx % BM : idx / kBK;
      const int kk = A_T ? idx / BM : idx % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < K)
        v = to_f32(A_T ? ae[static_cast<size_t>(gk) * M + gm] : ae[static_cast<size_t>(gm) * K + gk]);
      As[kk][mm] = v;
    }
    // B tile: 16 x 64 values, 4 per thread, neighbouring threads on B's
    // contiguous axis (n, or k when B is read transposed)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = B_T ? idx % kBK : idx / kBN;
      const int nn = B_T ? idx / kBK : idx % kBN;
      const int gk = k0 + kk, gn = n0 + nn;
      float v = 0.f;
      if (gk < K && gn < N)
        v = to_f32(B_T ? be[static_cast<size_t>(gn) * K + gk] : be[static_cast<size_t>(gk) * N + gn]);
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
    T* orow = out + (static_cast<size_t>(e) * M + gm) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) orow[gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, bool A_T, bool B_T>
void launch_grouped_matmul(const void* a, const void* b, void* out, int E, int M, int K, int N,
                           cudaStream_t stream) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  if (M <= 16) {
    const dim3 grid(ceil_div(N, kBN), ceil_div(M, 16), E);
    grouped_matmul_kernel<T, 1, A_T, B_T><<<grid, kThreads, 0, stream>>>(ap, bp, op, M, K, N);
  } else {
    const dim3 grid(ceil_div(N, kBN), ceil_div(M, 64), E);
    grouped_matmul_kernel<T, 4, A_T, B_T><<<grid, kThreads, 0, stream>>>(ap, bp, op, M, K, N);
  }
}

template <bool A_T, bool B_T>
int dispatch_dtype(const void* a, const void* b, void* out, int E, int M, int K, int N, int dtype,
                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kReproF32) {
    launch_grouped_matmul<float, A_T, B_T>(a, b, out, E, M, K, N, st);
  } else if (dtype == kReproBF16) {
    launch_grouped_matmul<__nv_bfloat16, A_T, B_T>(a, b, out, E, M, K, N, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (E, C, F) = x (E, C, D) @ w (E, D, F)
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* out, int E, int C, int D,
                                    int F, int dtype, void* stream) {
  return dispatch_dtype<false, false>(x, w, out, E, C, D, F, dtype, stream);
}

// dx (E, C, D) = dy (E, C, F) @ w^T, w (E, D, F) read transposed in place
extern "C" int repro_grouped_matmul_dx(const void* dy, const void* w, void* dx, int E, int C,
                                       int D, int F, int dtype, void* stream) {
  return dispatch_dtype<false, true>(dy, w, dx, E, C, F, D, dtype, stream);
}

// dw (E, D, F) = x^T @ dy, x (E, C, D) read transposed in place, dy (E, C, F)
extern "C" int repro_grouped_matmul_dw(const void* x, const void* dy, void* dw, int E, int C,
                                       int D, int F, int dtype, void* stream) {
  return dispatch_dtype<true, false>(x, dy, dw, E, D, C, F, dtype, stream);
}
