// B4 fused MoE FFN: gather + expert FFN + weighted scatter in one launch.
//
//   for every slot s = e * C + c of expert e:
//     row   = x[clip(slot_token[s], 0, T - 1)]                 (f32)
//     h     = act(row @ w_in[e])            ungated, or
//     h     = act(row @ w_gate[e]) * (row @ w_in[e])          gated
//     out[clip(slot_token[s])] += wslot[s] * (h @ w_out[e])    (f32)
//
// Replaces repro/kernels/moe_megakernel.py::_fused_impl / _make_kernel.
// The TPU kernel runs a SEQUENTIAL grid (E, F/bf) and carries a (T, d) f32
// accumulator in VMEM from the first grid step to the last. Hopper's blocks
// run concurrently in no fixed order, so that design does not carry over.
// Here one block owns one (expert, tile of up to BR = 8 or 16 slot rows):
//   1. the block gathers its rows of x through slot_token into shared
//      memory (f32), clipped to [0, T) as the TPU kernel does;
//   2. it loops over f in blocks of kBF = 512 columns INSIDE the block:
//      h = act(rows @ w_in[:, blk]) in f32 into shared memory, then
//      acc (BR x d, f32, registers) += h @ w_out[blk, :]; so each slot's
//      output row is complete before it leaves the block;
//   3. it scatters wslot[s] * acc[c] into a zeroed (T, d) f32 buffer with
//      atomicAdd. The wrapper casts that buffer once to the output dtype.
// Slots whose weight is 0 (empty, dropped, or never kept) are skipped at
// the scatter: the TPU kernel adds 0 * row for them, which is the same for
// finite values. With top-1 each token owns at most one kept slot, so no
// two additions meet and the result is deterministic; with k = 2 a token's
// two contributions meet in the atomics in either order (f32 rounding of
// one addition).
//
// What bounds it on the H100: every expert's w_in (and w_gate) and w_out
// are read once, 2 x E x d x f x 4 bytes = 1.07 GB for zcode-m3-base at
// (128, 512, 2048) f32, against 4 x E x C x d x f FLOPs (4.3 GFLOP at
// C = 8): bytes, ~0.32 ms at 3.35 TB/s. At C = 8, E = 128 the grid is 128
// blocks on 132 SMs. Each thread owns one column per phase, so weight rows
// are read coalesced and exactly once per block; the k loops are unrolled
// so several loads are in flight per thread. No TMA, cp.async or wgmma yet.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBF = kThreads;     // f columns per block of the f loop

enum Act { kGelu = 0, kSilu = 1 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kSilu) return v / (1.f + __expf(-v));
  // jax.nn.gelu's default: the tanh approximation
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(u));
}

// BR slot rows per block; NC output columns of d per thread (d <= NC * kThreads)
template <typename T, int BR, int NC, bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
fused_moe_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
                 const T* __restrict__ w_gate, const T* __restrict__ w_out,
                 const int32_t* __restrict__ slot_token, const float* __restrict__ wslot,
                 float* __restrict__ out, int n_tokens, int C, int D, int F, int act) {
  extern __shared__ float smem[];
  float* xs = smem;              // [BR][D]  gathered rows, f32
  float* hs = smem + BR * D;     // [BR][kBF] activations of one f block

  const int e = blockIdx.y;
  const int c0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const size_t wofs = static_cast<size_t>(e) * D * F;
  const T* wi = w_in + wofs;
  const T* wg = GATED ? w_gate + wofs : nullptr;
  const T* wo = w_out + wofs;

  // 1. gather
  for (int r = 0; r < BR; ++r) {
    const int c = c0 + r;
    if (c < C) {
      const int t = clamp_index(slot_token[e * C + c], n_tokens);
      const T* src = x + static_cast<size_t>(t) * D;
      for (int i = tid; i < D; i += kThreads) xs[r * D + i] = to_f32(src[i]);
    } else {
      for (int i = tid; i < D; i += kThreads) xs[r * D + i] = 0.f;
    }
  }

  float acc[NC][BR];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[j][r] = 0.f;
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += kBF) {
    // 2a. h = act(rows @ w_in[:, f0 + tid]) (gated: act(rows @ w_gate) * (rows @ w_in))
    const int col = f0 + tid;
    float hv[BR], gv[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) hv[r] = gv[r] = 0.f;
    if (col < F) {
#pragma unroll 8
      for (int k = 0; k < D; ++k) {
        const float a = to_f32(wi[static_cast<size_t>(k) * F + col]);
        const float g = GATED ? to_f32(wg[static_cast<size_t>(k) * F + col]) : 0.f;
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          const float xv = xs[r * D + k];
          hv[r] += xv * a;
          if (GATED) gv[r] += xv * g;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BR; ++r)
      hs[r * kBF + tid] = GATED ? activate(gv[r], act) * hv[r] : activate(hv[r], act);
    __syncthreads();

    // 2b. acc += h @ w_out[f0 : f0 + nf, :]
    const int nf = min(kBF, F - f0);
#pragma unroll 8
    for (int kk = 0; kk < nf; ++kk) {
      const T* wrow = wo + static_cast<size_t>(f0 + kk) * D;
      float w[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int dcol = tid + j * kThreads;
        w[j] = dcol < D ? to_f32(wrow[dcol]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float h = hs[r * kBF + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j][r] += h * w[j];
      }
    }
    __syncthreads();   // hs is rewritten by the next f block
  }

  // 3. weighted scatter into the token rows
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const int c = c0 + r;
    if (c >= C) continue;
    const int s = e * C + c;
    const float wt = wslot[s];
    if (wt == 0.f) continue;
    float* orow = out + static_cast<size_t>(clamp_index(slot_token[s], n_tokens)) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int dcol = tid + j * kThreads;
      if (dcol < D) atomicAdd(orow + dcol, wt * acc[j][r]);
    }
  }
}

template <typename T, int BR, int NC, bool GATED>
cudaError_t launch(const void* x, const void* w_in, const void* w_gate, const void* w_out,
                   const int32_t* slot_token, const float* wslot, float* out, int n_tokens,
                   int E, int C, int D, int F, int act, cudaStream_t stream) {
  auto kernel = fused_moe_kernel<T, BR, NC, GATED>;
  const size_t smem = static_cast<size_t>(BR) * (D + kBF) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(ceil_div(C, BR), E);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in), static_cast<const T*>(w_gate),
      static_cast<const T*>(w_out), slot_token, wslot, out, n_tokens, C, D, F, act);
  return cudaGetLastError();
}

template <typename T, int BR, int NC>
cudaError_t by_gated(bool gated, const void* x, const void* w_in, const void* w_gate,
                     const void* w_out, const int32_t* st, const float* ws, float* out, int n,
                     int E, int C, int D, int F, int act, cudaStream_t stream) {
  return gated ? launch<T, BR, NC, true>(x, w_in, w_gate, w_out, st, ws, out, n, E, C, D, F, act,
                                         stream)
               : launch<T, BR, NC, false>(x, w_in, w_gate, w_out, st, ws, out, n, E, C, D, F, act,
                                          stream);
}

template <typename T>
cudaError_t by_shape(bool gated, const void* x, const void* w_in, const void* w_gate,
                     const void* w_out, const int32_t* st, const float* ws, float* out, int n,
                     int E, int C, int D, int F, int act, cudaStream_t stream) {
  if (D <= kThreads) {
    return C <= 8 ? by_gated<T, 8, 1>(gated, x, w_in, w_gate, w_out, st, ws, out, n, E, C, D, F,
                                      act, stream)
                  : by_gated<T, 16, 1>(gated, x, w_in, w_gate, w_out, st, ws, out, n, E, C, D, F,
                                       act, stream);
  }
  return C <= 8 ? by_gated<T, 8, 2>(gated, x, w_in, w_gate, w_out, st, ws, out, n, E, C, D, F, act,
                                    stream)
                : by_gated<T, 16, 2>(gated, x, w_in, w_gate, w_out, st, ws, out, n, E, C, D, F,
                                     act, stream);
}

}  // namespace

// out (T, D) f32, zeroed by the caller, accumulates the weighted expert
// outputs; x (T, D), w_in / w_gate (E, D, F), w_out (E, F, D) in one dtype;
// slot_token (E * C,) int32; wslot (E * C,) f32. w_gate may be null
// (ungated). act: 0 gelu (tanh), 1 silu. D <= 1024.
extern "C" int repro_fused_moe(const void* x, const void* w_in, const void* w_gate,
                               const void* w_out, const void* slot_token, const void* wslot,
                               void* out, int n_tokens, int E, int C, int D, int F, int act,
                               int dtype, void* stream) {
  if (D > 2 * kThreads || (act != kGelu && act != kSilu))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool gated = w_gate != nullptr;
  const auto* st = static_cast<const int32_t*>(slot_token);
  const auto* ws = static_cast<const float*>(wslot);
  auto* o = static_cast<float*>(out);
  auto strm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kReproF32) {
    err = by_shape<float>(gated, x, w_in, w_gate, w_out, st, ws, o, n_tokens, E, C, D, F, act,
                          strm);
  } else if (dtype == kReproBF16) {
    err = by_shape<__nv_bfloat16>(gated, x, w_in, w_gate, w_out, st, ws, o, n_tokens, E, C, D, F,
                                  act, strm);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
