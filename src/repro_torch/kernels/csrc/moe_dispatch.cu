// B2 dispatch and B3 combine: the row gathers around the expert FFN.
//
// Replace repro/kernels/moe_dispatch.py::_dispatch_impl / _dispatch_kernel
// and ::_combine_impl / _make_combine_kernel. On the TPU each grid step
// DMAs one (1, bd) row named by the scalar-prefetched routing table. Here a
// warp (dispatch) or a block (combine) owns a row and reads its index
// itself; rows move as 16-byte words where the row width allows.
//
// Both move bytes: dispatch copies S rows, combine reads K rows per token
// and writes one. Neither does enough arithmetic to matter. At decode
// dispatch copies 128 rows of 1 KB (128 KB, 0.04 us at the byte bound), so
// launch and the latency of its dependent loads set its time: it loads a
// slot's validity and token together and the row right after (one
// dependent step, as index_select's), all of a lane's row words before
// its stores, and runs 4 rows per block so that the training site's 1,024
// slots spread over every SM.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// dispatch: buf[s] = slot_valid[s] ? x[clip(slot_token[s])] : 0
// A pure byte copy, so one kernel serves every dtype; W is the word moved.
// ---------------------------------------------------------------------------

constexpr int kDispatchThreads = 128;
constexpr int kRowsPerBlock = kDispatchThreads / 32;   // one warp per slot row
constexpr int kWordsInFlight = 4;                      // a lane's loads before its stores

// Both table loads issue at once on the read-only path and the source row
// is chosen by predicate, so the row's loads wait on one dependent step;
// each lane issues up to kWordsInFlight words of the row before it stores
// any (2 at decode's 1 KB rows, 4 at the training site's 2 KB).
template <typename W>
__global__ void __launch_bounds__(kDispatchThreads)
dispatch_rows_kernel(const W* __restrict__ x, const int32_t* __restrict__ slot_token,
                     const uint8_t* __restrict__ slot_valid, W* __restrict__ out,
                     int n_tokens, int n_slots, int row_words) {
  const int s = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (s >= n_slots) return;
  const int lane = threadIdx.x % 32;
  const bool valid = __ldg(slot_valid + s) != 0;
  const int t = clamp_index(__ldg(slot_token + s), n_tokens);
  const W* src = x + static_cast<size_t>(t) * row_words;
  W* dst = out + static_cast<size_t>(s) * row_words;
  for (int i0 = lane; i0 < row_words; i0 += 32 * kWordsInFlight) {
    W v[kWordsInFlight];
#pragma unroll
    for (int j = 0; j < kWordsInFlight; ++j) {
      const int i = i0 + 32 * j;
      v[j] = valid && i < row_words ? __ldg(src + i) : W{};
    }
#pragma unroll
    for (int j = 0; j < kWordsInFlight; ++j) {
      const int i = i0 + 32 * j;
      if (i < row_words) dst[i] = v[j];
    }
  }
}

template <typename W>
void launch_dispatch(const void* x, const int32_t* slot_token, const uint8_t* slot_valid,
                     void* out, int n_tokens, int n_slots, int row_bytes, cudaStream_t stream) {
  const dim3 grid(ceil_div(n_slots, kRowsPerBlock));
  dispatch_rows_kernel<W><<<grid, kDispatchThreads, 0, stream>>>(
      static_cast<const W*>(x), slot_token, slot_valid, static_cast<W*>(out), n_tokens,
      n_slots, row_bytes / static_cast<int>(sizeof(W)));
}

// ---------------------------------------------------------------------------
// combine: y[t] = sum_k topk_w[t,k] * keep[t,k] * buf[clip(token_slot[t,k])]
// One block per token row, f32 accumulation in the order k = 0..K-1. A
// dropped (t, k) still reads its clipped row and multiplies it by 0, as the
// TPU kernel does.
// ---------------------------------------------------------------------------

constexpr int kCombineThreads = 128;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kCombineThreads)
combine_rows_kernel(const T* __restrict__ buf, const int32_t* __restrict__ token_slot,
                    const float* __restrict__ topk_w, const uint8_t* __restrict__ keep,
                    T* __restrict__ out, int n_slots, int k, int d) {
  const int t = blockIdx.x;
  const int n_vec = d / V;
  for (int c = threadIdx.x; c < n_vec; c += blockDim.x) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const int tk = t * k + kk;
      const int s = clamp_index(token_slot[tk], n_slots);
      const float w = topk_w[tk] * (keep[tk] ? 1.f : 0.f);
      const Vec<T, V> row =
          reinterpret_cast<const Vec<T, V>*>(buf + static_cast<size_t>(s) * d)[c];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += w * to_f32(row.e[j]);
    }
    Vec<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) o.e[j] = from_f32<T>(acc[j]);
    reinterpret_cast<Vec<T, V>*>(out + static_cast<size_t>(t) * d)[c] = o;
  }
}

template <typename T>
void launch_combine(const void* buf, const int32_t* token_slot, const float* topk_w,
                    const uint8_t* keep, void* out, int n_tokens, int n_slots, int k, int d,
                    cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* b = static_cast<const T*>(buf);
  T* o = static_cast<T*>(out);
  if (d % V == 0 && aligned16(buf) && aligned16(out)) {
    combine_rows_kernel<T, V><<<n_tokens, kCombineThreads, 0, stream>>>(
        b, token_slot, topk_w, keep, o, n_slots, k, d);
  } else {
    combine_rows_kernel<T, 1><<<n_tokens, kCombineThreads, 0, stream>>>(
        b, token_slot, topk_w, keep, o, n_slots, k, d);
  }
}

}  // namespace

extern "C" int repro_moe_dispatch(const void* x, const void* slot_token, const void* slot_valid,
                                  void* out, int n_tokens, int n_slots, int row_bytes,
                                  void* stream) {
  const auto* tok = static_cast<const int32_t*>(slot_token);
  const auto* valid = static_cast<const uint8_t*>(slot_valid);
  auto st = static_cast<cudaStream_t>(stream);
  const bool al = aligned16(x) && aligned16(out);
  if (row_bytes % 16 == 0 && al) {
    launch_dispatch<uint4>(x, tok, valid, out, n_tokens, n_slots, row_bytes, st);
  } else if (row_bytes % 4 == 0) {
    launch_dispatch<uint32_t>(x, tok, valid, out, n_tokens, n_slots, row_bytes, st);
  } else if (row_bytes % 2 == 0) {
    launch_dispatch<uint16_t>(x, tok, valid, out, n_tokens, n_slots, row_bytes, st);
  } else {
    launch_dispatch<uint8_t>(x, tok, valid, out, n_tokens, n_slots, row_bytes, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_moe_combine(const void* buf, const void* token_slot, const void* topk_w,
                                 const void* keep, void* out, int n_tokens, int n_slots, int k,
                                 int d, int dtype, void* stream) {
  const auto* slots = static_cast<const int32_t*>(token_slot);
  const auto* w = static_cast<const float*>(topk_w);
  const auto* kp = static_cast<const uint8_t*>(keep);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kReproF32) {
    launch_combine<float>(buf, slots, w, kp, out, n_tokens, n_slots, k, d, st);
  } else if (dtype == kReproBF16) {
    launch_combine<__nv_bfloat16>(buf, slots, w, kp, out, n_tokens, n_slots, k, d, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
