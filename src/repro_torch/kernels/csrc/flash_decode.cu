// B5 flash decode: attention of one query token per row against a
// contiguous (B, S, KV, hd) cache, positions > index[b] masked; and B6,
// the same over a paged cache: a page arena (n_pages + 1, ps, KV, hd)
// addressed through per-row block tables (B, nb).
//
// B5 replaces repro/kernels/flash_decode.py::_flash_decode_jit / _kernel.
// The TPU kernel walks grid (B, KV, S/bs) with the S axis sequential,
// carrying the online-softmax state (m, l, acc) in VMEM scratch across
// grid steps. Blocks on the H100 run in no order, so the S loop moves
// inside the block: one block per (b, kv group), its 4 warps take every
// 4th position, each warp carries its own (m, l, acc) in registers (lane i
// holds head dims i, i+32, ...), and the warps merge their states through
// shared memory at the end. The group's `rep` query heads share every K/V
// row the block reads. Positions past index[b] are skipped: the TPU kernel
// gives them probability exp(-1e30 - m) = 0, so the result is the same.
//
// B6 replaces repro/kernels/flash_decode.py::_flash_decode_paged_jit /
// _paged_kernel. The TPU kernel gathers page bt[b, j] into VMEM in its DMA
// prologue (scalar prefetch) and runs B5's body on it. Here the gather is
// the row address itself: logical position j of row b lives at arena row
// (bt[b * nb + j / ps] * ps + j % ps). Both kernels run one device body
// (attend_rows) over the same logical positions in the same order, so B6
// equals B5 bitwise on the cache its tables address. A table entry outside
// [0, n_pages] is clamped into the arena rather than read out of bounds.
//
// What bounds them on the H100: bytes -- every live K/V row is read once
// and used for 2 * rep * hd flops. At the serving shapes (S <= 96, B * KV
// <= 72 blocks) they are bound by launch latency; long caches need a split
// over S across blocks (flash-decoding), and B6 a TMA page copy, which is
// later work.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxRep = 8;           // query heads per kv head
constexpr int kMaxDimsPerLane = 4;   // head_dim <= 128
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row address of logical position j of row b, kv group g, in a contiguous
// (B, S, KV, hd) cache.
struct ContiguousRows {
  int S, KV, hd;
  __device__ __forceinline__ size_t operator()(int b, int j, int g) const {
    return ((static_cast<size_t>(b) * S + j) * KV + g) * hd;
  }
};

// The same in a page arena (n_pages + 1, ps, KV, hd) through block tables
// bt (B, nb): position j lives in page bt[b, j / ps] at offset j % ps.
struct PagedRows {
  const int32_t* __restrict__ bt;
  int nb, ps, n_arena, KV, hd;
  __device__ __forceinline__ size_t operator()(int b, int j, int g) const {
    const int page = clamp_index(bt[static_cast<size_t>(b) * nb + j / ps], n_arena);
    return ((static_cast<size_t>(page) * ps + j % ps) * KV + g) * hd;
  }
};

// One block per (kv group g = blockIdx.x, row b = blockIdx.y) over logical
// positions [0, min(index[b], n_pos - 1)]; `rows` maps a position to its
// K/V row.
template <typename TQ, typename TKV, typename Rows>
__device__ __forceinline__ void attend_rows(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                            const TKV* __restrict__ v,
                                            const int32_t* __restrict__ index,
                                            TQ* __restrict__ out, const Rows& rows, int n_pos,
                                            int KV, int rep, int hd, float scale) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int last = min(index[b], n_pos - 1);
  const int H = KV * rep;

  float qr[kMaxRep][kMaxDimsPerLane];
  float acc[kMaxRep][kMaxDimsPerLane];
  float m[kMaxRep], l[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int dim = lane + 32 * i;
      const bool live = r < rep && dim < hd;
      qr[r][i] = live ? to_f32(q[(static_cast<size_t>(b) * H + g * rep + r) * hd + dim]) * scale
                      : 0.f;
      acc[r][i] = 0.f;
    }
  }

  for (int j = warp; j <= last; j += kWarps) {
    const size_t row = rows(b, j, g);
    float kr[kMaxDimsPerLane], vr[kMaxDimsPerLane];
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int dim = lane + 32 * i;
      kr[i] = dim < hd ? to_f32(k[row + dim]) : 0.f;
      vr[i] = dim < hd ? to_f32(v[row + dim]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) s += qr[r][i] * kr[i];
      s = warp_sum(s);
      const float m_new = fmaxf(m[r], s);
      const float corr = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * corr + p;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) acc[r][i] = acc[r][i] * corr + p * vr[i];
      m[r] = m_new;
    }
  }

  __shared__ float sm_m[kWarps][kMaxRep];
  __shared__ float sm_l[kWarps][kMaxRep];
  __shared__ float sm_acc[kWarps][kMaxRep][32 * kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) sm_acc[warp][r][lane + 32 * i] = acc[r][i];
  }
  __syncthreads();

  for (int r = warp; r < rep; r += kWarps) {
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w][r]);
    float l_all = 0.f;
    float scale_w[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      scale_w[w] = expf(sm_m[w][r] - m_all);
      l_all += sm_l[w][r] * scale_w[w];
    }
    const float inv = 1.f / fmaxf(l_all, 1e-30f);
    TQ* orow = out + (static_cast<size_t>(b) * H + g * rep + r) * hd;
    for (int dim = lane; dim < hd; dim += 32) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += sm_acc[w][r][dim] * scale_w[w];
      orow[dim] = from_f32<TQ>(a * inv);
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int32_t* __restrict__ index,
                    TQ* __restrict__ out, int S, int KV, int rep, int hd, float scale) {
  attend_rows(q, k, v, index, out, ContiguousRows{S, KV, hd}, S, KV, rep, hd, scale);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_paged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v, const int32_t* __restrict__ bt,
                          const int32_t* __restrict__ index, TQ* __restrict__ out, int nb,
                          int ps, int n_arena, int KV, int rep, int hd, float scale) {
  attend_rows(q, k, v, index, out, PagedRows{bt, nb, ps, n_arena, KV, hd}, nb * ps, KV, rep,
              hd, scale);
}

// Launches the (TQ, TKV) instance that q_dtype and kv_dtype name; false if
// the pair is not one the kernels take.
template <typename Launch>
bool dispatch_dtypes(int q_dtype, int kv_dtype, Launch&& launch) {
  if (q_dtype == kReproF32 && kv_dtype == kReproF32) {
    launch(float{}, float{});
  } else if (q_dtype == kReproF32 && kv_dtype == kReproBF16) {
    launch(float{}, __nv_bfloat16{});
  } else if (q_dtype == kReproBF16 && kv_dtype == kReproBF16) {
    launch(__nv_bfloat16{}, __nv_bfloat16{});
  } else if (q_dtype == kReproBF16 && kv_dtype == kReproF32) {
    launch(__nv_bfloat16{}, float{});
  } else {
    return false;
  }
  return true;
}

bool bad_shape(int rep, int hd) {
  return rep < 1 || rep > kMaxRep || hd < 1 || hd > 32 * kMaxDimsPerLane;
}

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, const void* index,
                                  void* out, int B, int S, int KV, int rep, int hd,
                                  float scale, int q_dtype, int kv_dtype, void* stream) {
  if (bad_shape(rep, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* idx = static_cast<const int32_t*>(index);
  auto st = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch_dtypes(q_dtype, kv_dtype, [&](auto tq, auto tkv) {
    using TQ = decltype(tq);
    using TKV = decltype(tkv);
    flash_decode_kernel<TQ, TKV><<<dim3(KV, B), kWarps * 32, 0, st>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), idx,
        static_cast<TQ*>(out), S, KV, rep, hd, scale);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_flash_decode_paged(const void* q, const void* k, const void* v,
                                        const void* block_tables, const void* index, void* out,
                                        int B, int nb, int ps, int n_arena, int KV, int rep,
                                        int hd, float scale, int q_dtype, int kv_dtype,
                                        void* stream) {
  if (bad_shape(rep, hd) || nb < 1 || ps < 1 || n_arena < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* bt = static_cast<const int32_t*>(block_tables);
  const auto* idx = static_cast<const int32_t*>(index);
  auto st = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch_dtypes(q_dtype, kv_dtype, [&](auto tq, auto tkv) {
    using TQ = decltype(tq);
    using TKV = decltype(tkv);
    flash_decode_paged_kernel<TQ, TKV><<<dim3(KV, B), kWarps * 32, 0, st>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), bt,
        idx, static_cast<TQ*>(out), nb, ps, n_arena, KV, rep, hd, scale);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
