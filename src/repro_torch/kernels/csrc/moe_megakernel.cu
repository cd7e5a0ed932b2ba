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
//
// What bounds it on the H100: the bytes of the weights it must read. An
// expert none of whose slots carries weight (wslot == 0: empty, dropped or
// never kept) adds nothing, so only the live experts' w_in (and w_gate)
// and w_out are needed: 8.4 MB each in f32 at zcode-m3-base's (512, 2048),
// against 4 x C x d x f FLOPs per expert, at most 8 flops per byte at C =
// 16 where the f32 CUDA cores need 20 to be the limit. Tensor cores would
// not help, and an f32 wgmma runs in TF32, which misses the f32 gate.
// Every intermediate stays in f32. The wrapper (kernels/moe_megakernel.py::
// variant) picks one of two designs per call:
//
// * The streaming kernel (fused_moe_stream), for C <= 16 with 16-byte rows
//   of d and f and 16-byte aligned pointers (every call on the main path).
//   - Live experts only. Each block scans wslot (E x C values) at its
//     start, one warp vote per 32 experts, into bit masks in shared memory
//     and walks the live experts in expert order: nothing leaves the
//     device, the host never syncs, and an unrouted expert's weights are
//     never read.
//   - Two phases of work items in one persistent grid (the resident-block
//     count), each B1's streaming forward on a tile of 512-byte weight
//     rows (128 f32 or 256 bf16 columns), items ordered phase A first and
//     chunk-major inside each phase, so that the tiles of one expert run
//     on different SMs. Phase A, (live expert, chunk of f): gather the
//     expert's C rows of x through slot_token (clipped as the TPU kernel
//     does) and write h = act(rows @ w_in[:, chunk]) (f32) to a workspace
//     (E x C x f, 8.4 MB at C = 8). Phase B, (live expert, slice of d, half
//     of f): out[token] += wslot x (h[:, half] @ w_out[half, slice]) with
//     f32 atomicAdd. A phase-B item's producer waits (polling the expert's
//     phase-A count) until h is whole; phase-A items never wait and come
//     first in every block's order, so with every block resident nothing
//     can wait on a block that has not started.
//   - The sums meet in a fixed order: every item reduces over its whole
//     tile of rows inside one block (row groups met by two xor-shuffles,
//     as B1's forward), and an output element of a top-1 call receives
//     exactly two additions onto zero, its two halves of f, whose sum does
//     not depend on their order. So top-1 calls give the same bits on every
//     run; with k = 2 a token's contributions meet in either order. The
//     per-expert counts are zeroed by the caller with the output, in one
//     fill, so a CUDA graph's replays start from zero too.
//   - One producer warp streams the weight tiles through a ring of
//     asynchronous copies that complete on mbarriers: each stage's 32 rows
//     x 512 bytes (16 KB) as one tensor copy (a TMA box; the tensor maps
//     are encoded on the host per call), with the stage's slice of the C
//     activation rows (x or h) beside it, one bulk copy per row. The block
//     holds the ring, 64-76 KB, so three blocks stay on every SM.
//   - A first design, one item per (expert, chunk of f) running both
//     products and the expert's last item summing the chunks' partials,
//     spent its tail in those latency-bound reductions of 256 KB per expert
//     and its items in fences, and missed both of its targets (PERF.md,
//     Findings).
// * The tiled kernel (fused_moe_kernel), for every other shape (C > 16,
//   ragged rows, misaligned views), at any d: one block owns one (expert,
//   tile of up to BR = 8 or 16 slot rows, range of f), loops over its f in
//   blocks of 512 columns (h into shared memory) and scatters with f32
//   atomicAdd. A tile none of whose slots carries weight returns at once.
//   It moves 4-byte words with no asynchronous copies.
//   - Shared memory holds at most kKD = 1,024 gathered columns of the
//     tile's rows: past that (dbrx's d = 6,144 would need 426 KB at BR =
//     16, against Hopper's 227 KB per block) h's product runs over d in
//     chunks of kKD, each gathered again from x (which L2 holds) for every
//     block of f.
//   - The output columns are walked in blocks of NC x 512. Where d fits
//     one block (d <= 1,024) the output rows stay in registers over the
//     whole f range and every slot adds once, as before d was chunked; past
//     it each (block of f, block of d) is scattered as it is done, and the
//     f range is split over grid.z to fill the card (the adds of one output
//     element then meet in either order).

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"
#include "stream.cuh"

namespace {

enum Act { kGelu = 0, kSilu = 1 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kSilu) return v / (1.f + __expf(-v));
  // jax.nn.gelu's default: the tanh approximation
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(u));
}

// ---------------------------------------------------------------------------
// tiled kernel (any shape)
// ---------------------------------------------------------------------------

constexpr int kThreads = 512;
constexpr int kBF = kThreads;     // f columns per block of the f loop
constexpr int kKD = 1024;         // gathered columns of d held in shared memory

// BR slot rows per block; NC output columns of d per thread and block of d
// (NC x kThreads). grid: (C tiles, E, splits of f of f_span columns each)
template <typename T, int BR, int NC, bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
fused_moe_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
                 const T* __restrict__ w_gate, const T* __restrict__ w_out,
                 const int32_t* __restrict__ slot_token, const float* __restrict__ wslot,
                 float* __restrict__ out, int n_tokens, int C, int D, int F, int act,
                 int f_span) {
  extern __shared__ float smem[];
  const int kd = D < kKD ? D : kKD;
  float* xs = smem;              // [BR][kd]  gathered rows (one chunk of d), f32
  float* hs = smem + BR * kd;    // [BR][kBF] activations of one f block

  const int e = blockIdx.y;
  const int c0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int f_lo = blockIdx.z * f_span;
  const int f_hi = min(F, f_lo + f_span);
  const size_t wofs = static_cast<size_t>(e) * D * F;
  const T* wi = w_in + wofs;
  const T* wg = GATED ? w_gate + wofs : nullptr;
  const T* wo = w_out + wofs;

  // a tile none of whose slots carries weight adds nothing
  if (f_lo >= F ||
      !__syncthreads_or(tid < BR && c0 + tid < C && wslot[e * C + c0 + tid] != 0.f))
    return;

  // columns [k0, k0 + kn) of the tile's rows into xs
  auto gather = [&](int k0, int kn) {
    for (int r = 0; r < BR; ++r) {
      const int c = c0 + r;
      if (c < C) {
        const int t = clamp_index(slot_token[e * C + c], n_tokens);
        const T* src = x + static_cast<size_t>(t) * D + k0;
        for (int i = tid; i < kn; i += kThreads) xs[r * kd + i] = to_f32(src[i]);
      } else {
        for (int i = tid; i < kn; i += kThreads) xs[r * kd + i] = 0.f;
      }
    }
  };

  float acc[NC][BR];
  auto zero_acc = [&]() {
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[j][r] = 0.f;
  };
  // out[token] += wslot x acc, columns d0 + tid + j * kThreads
  auto scatter = [&](int d0) {
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
        const int dcol = d0 + tid + j * kThreads;
        if (dcol < D) atomicAdd(orow + dcol, wt * acc[j][r]);
      }
    }
  };

  // past kKD columns the rows are staged over d, and the output rows, which
  // then span several blocks of NC x kThreads columns, are added per block
  // of f; else they stay in registers over all of f
  const bool wide = D > kKD;
  const int n_dblk = (D + NC * kThreads - 1) / (NC * kThreads);
  if (!wide) gather(0, D);
  zero_acc();
  __syncthreads();

  for (int f0 = f_lo; f0 < f_hi; f0 += kBF) {
    // 1. h = act(rows @ w_in[:, f0 + tid]) (gated: act(rows @ w_gate) * (rows @ w_in)),
    //    over d in chunks of kKD
    const int col = f0 + tid;
    float hv[BR], gv[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) hv[r] = gv[r] = 0.f;
    for (int k0 = 0; k0 < D; k0 += kKD) {
      const int kn = min(kKD, D - k0);
      if (wide) {
        __syncthreads();           // every thread is done with the last chunk
        gather(k0, kn);
        __syncthreads();
      }
      if (col < f_hi) {
        const T* wik = wi + static_cast<size_t>(k0) * F + col;
        const T* wgk = GATED ? wg + static_cast<size_t>(k0) * F + col : nullptr;
#pragma unroll 8
        for (int k = 0; k < kn; ++k) {
          const float a = to_f32(wik[static_cast<size_t>(k) * F]);
          const float g = GATED ? to_f32(wgk[static_cast<size_t>(k) * F]) : 0.f;
#pragma unroll
          for (int r = 0; r < BR; ++r) {
            const float xv = xs[r * kd + k];
            hv[r] += xv * a;
            if (GATED) gv[r] += xv * g;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BR; ++r)
      hs[r * kBF + tid] = GATED ? activate(gv[r], act) * hv[r] : activate(hv[r], act);
    __syncthreads();

    // 2. acc += h @ w_out[f0 : f0 + nf, d block], each block of d in turn
    const int nf = min(kBF, f_hi - f0);
    for (int db = 0; db < n_dblk; ++db) {
      const int d0 = db * NC * kThreads;
#pragma unroll 8
      for (int kk = 0; kk < nf; ++kk) {
        const T* wrow = wo + static_cast<size_t>(f0 + kk) * D + d0;
        float w[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int dcol = tid + j * kThreads;
          w[j] = d0 + dcol < D ? to_f32(wrow[dcol]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          const float h = hs[r * kBF + kk];
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[j][r] += h * w[j];
        }
      }
      if (wide) {
        scatter(d0);
        zero_acc();
      }
    }
    __syncthreads();   // hs (and xs) are rewritten by the next f block
  }

  // 3. weighted scatter into the token rows
  if (!wide) scatter(0);
}

// the tiled kernel's dynamic shared memory at width D
template <int BR>
int tiled_smem(int D) {
  return BR * ((D < kKD ? D : kKD) + kBF) * static_cast<int>(sizeof(float));
}

// columns of f per split of the f range: one split up to d = kKD (every
// slot adds once), else enough splits for two blocks per SM
template <int BR>
int tiled_f_span(int E, int C, int D, int F) {
  const int fblocks = ceil_div(F, kBF);
  if (D <= kKD) return fblocks * kBF;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int tiles = ceil_div(C, BR) * E;
  int splits = ceil_div(2 * sms, tiles);
  splits = splits < 1 ? 1 : (splits > fblocks ? fblocks : splits);
  return ceil_div(fblocks, splits) * kBF;
}

template <typename T, int BR, int NC, bool GATED>
cudaError_t launch(const void* x, const void* w_in, const void* w_gate, const void* w_out,
                   const int32_t* slot_token, const float* wslot, float* out, int n_tokens,
                   int E, int C, int D, int F, int act, cudaStream_t stream) {
  auto kernel = fused_moe_kernel<T, BR, NC, GATED>;
  const size_t smem = tiled_smem<BR>(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int f_span = tiled_f_span<BR>(E, C, D, F);
  const dim3 grid(ceil_div(C, BR), E, ceil_div(F, f_span));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in), static_cast<const T*>(w_gate),
      static_cast<const T*>(w_out), slot_token, wslot, out, n_tokens, C, D, F, act, f_span);
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

// d <= 512: one column per thread; wider: two per thread, in blocks of
// 1,024 columns past that
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

// ---------------------------------------------------------------------------
// streaming kernel (C <= 16)
// ---------------------------------------------------------------------------

constexpr int kMaxStreamC = 16;
constexpr int kSNW = 4;                            // consumer warps
constexpr int kSThreads = (kSNW + 1) * 32;         // + one producer warp
constexpr int kConsumers = kSNW * 32;
constexpr int kSegBytes = 512;                     // a tile's width: bytes of a weight row
constexpr int kStageW = 16384;                     // weight bytes per ring stage
constexpr int kRows = kStageW / kSegBytes;         // 32 weight rows per stage
constexpr int kUnit = 4;                           // rows per lane unit
constexpr int kRowGroups = 4;                      // row groups of a warp's lanes
constexpr int kSmemBudget = 75776;                 // ring (+ gate) per block: three per SM
constexpr int kMaskBytes = 512;                    // the resident-block count holds live
                                                   // masks of up to 4,096 experts
constexpr int kMaxSpins = 1 << 24;                 // a phase-B wait's polls (seconds)

// Shared memory: kStages x (weight tile, activation rows), the gate's
// activations (gated only, f32, [column][row]), the full and empty
// barriers; then (sized at launch) the live-expert masks, one word per 32
// experts. The activation rows are x (T) in phase A and h (f32) in phase B.
template <typename T, int CT, bool GATED>
struct StreamSmem {
  static constexpr int kCols = kSegBytes / static_cast<int>(sizeof(T));   // 128 f32, 256 bf16
  // f32-sized rows, padded so that every stage starts on 128 bytes (a
  // tensor copy's alignment)
  static constexpr int kX = (CT * kRows * 4 + 127) / 128 * 128;
  static constexpr int kStage = kStageW + kX;
  static constexpr int kG = GATED ? kCols * CT * 4 : 0;
  static constexpr int kFit = (kSmemBudget - kG) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kGOff = kStages * kStage;
  static constexpr int kBars = kGOff + kG;
  static constexpr int kTotal = kBars + 2 * kStages * 8;
};

// one box of a tensor map (coordinates innermost first) into shared memory
// (128-byte aligned), completing on ``bar`` with the whole box's bytes;
// elements past the tensor's edges arrive as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the consumer warps' barrier (the producer warp runs ahead)
__device__ __forceinline__ void consumers_sync() {
  static_assert(kConsumers == 128, "bar.sync counts the consumer threads");
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// the j-th live expert in expert order (j < the live count), from the
// block's live masks (bit i of word w: expert 32 w + i)
__device__ __forceinline__ int nth_live(const uint32_t* masks, int n_words, int j) {
  for (int w = 0; w < n_words; ++w) {
    uint32_t m = masks[w];
    const int n = __popc(m);
    if (j < n) {
      for (int i = 0; i < j; ++i) m &= m - 1;
      return w * 32 + __ffs(m) - 1;
    }
    j -= n;
  }
  return -1;
}

// A work item: expert e, the tile's first column n0 (of f in phase A, of
// d in phase B) and its rows [k0, k1) of the reduction axis (d in phase A,
// f in phase B).
struct Item {
  int e, n0, k0, k1;
  bool b;
};

// Items 0 .. n_live * na - 1 are phase A, (chunk of f, live expert) with
// the expert fastest (chunk-major); then phase B, (half of f, slice of d,
// live expert), the expert fastest.
__device__ __forceinline__ Item decode_item(int item, int n_live, int na, int ns, int ncol,
                                            const uint32_t* masks, int n_words, int D, int F,
                                            int f_half) {
  const int j = item % n_live, r = item / n_live;
  const int e = nth_live(masks, n_words, j);
  if (r < na) return {e, r * ncol, 0, D, false};
  const int slice = (r - na) % ns, half = (r - na) / ns;
  return {e, slice * ncol, half ? f_half : 0, half ? F : f_half, true};
}

// One lane's unit of a stage: kUnit adjacent rows r0.. of the weight tile
// (each a 16-byte word of VW columns from col) against the CT activation
// rows (XT: x's type in phase A, f32 h in phase B; row c of the stage's
// activation slice at c * kRows).
template <typename T, typename XT, int CT, int VW, int NCOL>
__device__ __forceinline__ void consume_unit(const T* wst, const XT* xs, int r0, int col,
                                             float (&acc)[CT][VW]) {
  float wv[kUnit][VW];
#pragma unroll
  for (int i = 0; i < kUnit; ++i) load16(wst + (r0 + i) * NCOL + col, wv[i]);
#pragma unroll
  for (int c = 0; c < CT; ++c) {             // rows c >= C are never stored
    float xv[kUnit];
    load4(xs + c * kRows + r0, xv);
#pragma unroll
    for (int i = 0; i < kUnit; ++i)
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[c][j] += xv[i] * wv[i][j];
  }
}

// out (T, D) f32 += the weighted FFN of every live expert's slots; C <= CT
// <= 16; D and F of 16-byte rows, pointers 16-byte aligned (checked on the
// host). hbuf: (E, C, F) f32, h of the live experts; ready: E int32, the
// phase-A items done per expert, zero on entry.
//
// Both phases are B1's streaming forward on a tile of kRows rows x NCOL
// columns per stage: warp w < kSNW owns columns w * NCOL / 4 .. of the
// tile, lane l 16 bytes of them (VW columns from col) and row group g = l
// / 8, which takes units g and g + 4 of each stage's rows; at the end of
// the item the four groups' sums meet by two xor-shuffles and group 0
// holds the item's C x VW results.
//   Phase A, item (e, chunk of f): h[e][:, chunk] = act(x_e @ w_in[e][:,
//   chunk]) (gated: act(x_e @ w_gate) * (x_e @ w_in)), x_e the expert's C
//   rows of x gathered through slot_token, into hbuf; then the expert's
//   phase-A count is raised.
//   Phase B, item (e, slice of d, half of f): out[token(s)][slice] +=
//   wslot[s] * (h[e][c, half] @ w_out[e][half, slice]) for the expert's
//   slots s = e * C + c of non-zero weight. Its producer first waits until
//   the expert's phase-A count is complete. Every out element of a top-1
//   call receives exactly two additions onto zero, the two halves of f,
//   and a + b == b + a, so the result has the same bits on every run.
//
// Only phase-B producers wait, and only on phase-A items, which come first
// in every block's order and never wait: with the grid no larger than the
// resident-block count, every item it waits on is running or done.
template <typename T, int CT, bool GATED>
__global__ void __launch_bounds__(kSThreads, CT * 16 / sizeof(T) <= 64 ? 3 : 2)
fused_moe_stream(const __grid_constant__ CUtensorMap tm_in,
                 const __grid_constant__ CUtensorMap tm_gate,
                 const __grid_constant__ CUtensorMap tm_out, const T* __restrict__ x,
                 const int32_t* __restrict__ slot_token, const float* __restrict__ wslot,
                 float* __restrict__ out, float* __restrict__ hbuf, int* __restrict__ ready,
                 int n_tokens, int E, int C, int D, int F, int act) {
  using L = StreamSmem<T, CT, GATED>;
  constexpr int NCOL = L::kCols;
  constexpr int VW = 16 / sizeof(T);                       // columns per 16-byte word
  constexpr int STAGES = L::kStages;
  static_assert(kRows / kUnit == 2 * kRowGroups, "two units per row group and stage");
  static_assert(NCOL == kSNW * 8 * VW, "a tile is 8 words per consumer warp");
  extern __shared__ __align__(128) unsigned char shm[];
  float* gs = reinterpret_cast<float*>(shm + L::kGOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(shm + L::kBars);
  uint64_t* empty = full + STAGES;
  uint32_t* masks = reinterpret_cast<uint32_t*>(shm + L::kTotal);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_words = ceil_div_d(E, 32);
  const int na = ceil_div_d(F, NCOL);                      // phase-A items per expert
  const int ns = ceil_div_d(D, NCOL);                      // slices of d
  const int f_half = F > kRows ? ceil_div_d(ceil_div_d(F, 2), kRows) * kRows : F;
  const int nb = ns * (f_half < F ? 2 : 1);                // phase-B items per expert

  // the live experts: one warp vote per 32 experts, each lane reading its
  // expert's C slot weights at once
  for (int e0 = warp * 32; e0 < E; e0 += kSThreads) {
    const int e = e0 + lane;
    bool live = false;
#pragma unroll
    for (int c = 0; c < CT; ++c) live |= e < E && c < C && __ldg(wslot + e * C + c) != 0.f;
    const uint32_t m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) masks[e0 / 32] = m;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);        // the producer's arrive + the copies' bytes
      mbar_init(&empty[s], kSNW);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int n_live = 0;
  for (int w = 0; w < n_words; ++w) n_live += __popc(masks[w]);
  const int n_items = n_live * (na + nb);

  if (warp == kSNW) {
    // producer: fills stage after stage, item after item, in the order the
    // consumers read them
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Item it = decode_item(item, n_live, na, ns, NCOL, masks, n_words, D, F, f_half);
      if (it.b && lane == 0) {
        // h[e] is complete once every phase-A item of e is done (a count
        // that never completes is a fault: trap rather than hang); the
        // copies read it through the async proxy
        for (int spins = 0; load_acquire(ready + it.e) < na; ++spins) {
          if (spins == kMaxSpins) __trap();
          __nanosleep(128);
        }
        asm volatile("fence.proxy.async.global;" ::: "memory");
      }
      __syncwarp();
      // lane c < C copies activation row c: x[token(e * C + c)] or h[e][c]
      const unsigned char* src;
      int xsize;
      if (it.b) {
        src = reinterpret_cast<const unsigned char*>(
            hbuf + (static_cast<size_t>(it.e) * C + (lane < C ? lane : 0)) * F);
        xsize = 4;
      } else {
        const int tok = lane < C ? clamp_index(slot_token[it.e * C + lane], n_tokens) : 0;
        src = reinterpret_cast<const unsigned char*>(x + static_cast<size_t>(tok) * D);
        xsize = sizeof(T);
      }
      const int passes = !it.b && GATED ? 2 : 1;
      for (int pass = 0; pass < passes; ++pass) {
        const CUtensorMap* tm = it.b ? &tm_out : (GATED && pass == 0 ? &tm_gate : &tm_in);
        for (int k0 = it.k0; k0 < it.k1; k0 += kRows) {
          const int rows = min(kRows, it.k1 - k0);
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = shm + stage * L::kStage;
          if (lane == 0) {
            // the weight tile as one box of kRows rows x NCOL columns
            mbar_arrive_expect_tx(&full[stage], kStageW + C * rows * xsize);
            tma_load_3d(st, tm, it.n0, k0, it.e, &full[stage]);
          }
          __syncwarp();
          if (lane < C)
            bulk_g2s(st + kStageW + lane * kRows * xsize, src + static_cast<size_t>(k0) * xsize,
                     rows * xsize, &full[stage]);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;                    // consumer thread 0 .. kConsumers - 1
  const int col = warp * (NCOL / kSNW) + (lane % 8) * VW;
  const int g = lane / 8;
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Item it = decode_item(item, n_live, na, ns, NCOL, masks, n_words, D, F, f_half);
    const int passes = !it.b && GATED ? 2 : 1;
#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass) {
      float acc[CT][VW];
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[c][j] = 0.f;
      for (int k0 = it.k0; k0 < it.k1; k0 += kRows) {
        const int rows = min(kRows, it.k1 - k0);   // a multiple of kUnit
        mbar_wait(&full[stage], phase);
        const T* wst = reinterpret_cast<const T*>(shm + stage * L::kStage);
        const unsigned char* xs = shm + stage * L::kStage + kStageW;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r0 = (g + q * kRowGroups) * kUnit;
          if (r0 < rows) {
            if (it.b)
              consume_unit<T, float, CT, VW, NCOL>(wst, reinterpret_cast<const float*>(xs), r0,
                                                   col, acc);
            else
              consume_unit<T, T, CT, VW, NCOL>(wst, reinterpret_cast<const T*>(xs), r0, col, acc);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], 8);
          acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], 16);
        }
      if (g != 0) continue;
      if (GATED && !it.b && pass == 0) {           // act(x @ w_gate), kept for the second pass
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int j = 0; j < VW; ++j) gs[(col + j) * CT + c] = activate(acc[c][j], act);
        continue;
      }
      const int ncols = it.b ? D - it.n0 : F - it.n0;   // a multiple of VW
      if (col >= ncols) continue;
      if (!it.b) {
        // h = act(x @ w_in) (gated: act(x @ w_gate) * (x @ w_in)) into hbuf
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          if (c >= C) break;
          float* hp = hbuf + (static_cast<size_t>(it.e) * C + c) * F + it.n0 + col;
#pragma unroll
          for (int j = 0; j < VW; j += 4) {
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = GATED ? gs[(col + j + i) * CT + c] * acc[c][j + i]
                           : activate(acc[c][j + i], act);
            __stcg(reinterpret_cast<float4*>(hp + j), make_float4(v[0], v[1], v[2], v[3]));
          }
        }
      } else {
        // this half's weighted share of the output rows
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          if (c >= C) break;
          const float wt = wslot[it.e * C + c];
          if (wt == 0.f) continue;
          const int t = clamp_index(slot_token[it.e * C + c], n_tokens);
          float* o = out + static_cast<size_t>(t) * D + it.n0 + col;
#pragma unroll
          for (int j = 0; j < VW; ++j) atomicAdd(o + j, wt * acc[c][j]);
        }
      }
    }
    if (!it.b) {
      // h[e][:, chunk] is written: raise the expert's count (the barrier
      // orders the block's stores before thread 0's fence, which makes them
      // visible to the device)
      consumers_sync();
      if (tid == 0) {
        __threadfence();
        atomicAdd(ready + it.e, 1);
      }
    }
  }
}

// whether the streaming kernel takes these rows and pointers: the same
// rule as moe_megakernel.py::variant, checked again here so that a bulk
// copy is never issued on a ragged or misaligned row
template <typename T>
bool stream_ok(const void* x, const void* w_in, const void* w_gate, const void* w_out,
               const void* hbuf, int C, int D, int F) {
  return C >= 1 && C <= kMaxStreamC && (D * sizeof(T)) % 16 == 0 && (F * sizeof(T)) % 16 == 0 &&
         aligned16(x) && aligned16(w_in) && (w_gate == nullptr || aligned16(w_gate)) &&
         aligned16(w_out) && aligned16(hbuf);
}

// dynamic shared memory of a launch over E experts
template <typename T, int CT, bool GATED>
int stream_smem(int E) {
  return StreamSmem<T, CT, GATED>::kTotal + (ceil_div(E, 32) * 4 + 15) / 16 * 16;
}

// measured once per instantiation, at up to 4,096 experts
template <typename T, int CT, bool GATED>
int stream_max_blocks() {
  static const int blocks = resident_blocks(fused_moe_stream<T, CT, GATED>, kSThreads,
                                            StreamSmem<T, CT, GATED>::kTotal + kMaskBytes);
  return blocks;
}

// cuTensorMapEncodeTiled, looked up once through the runtime (no link
// against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const auto fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// the tensor map of w (E, R, N) read in boxes of kRows rows x one tile's
// columns (kSegBytes) of one expert
template <typename T>
bool weight_map(CUtensorMap* map, const void* w, int E, int R, int N) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {N * sizeof(T), static_cast<cuuint64_t>(R) * N * sizeof(T)};
  const cuuint32_t box[3] = {kSegBytes / sizeof(T), kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType dt =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, dt, 3, const_cast<void*>(w), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int CT, bool GATED>
cudaError_t launch_stream(const void* x, const void* w_in, const void* w_gate, const void* w_out,
                          const int32_t* st, const float* wslot, float* out, float* hbuf,
                          int* ready, int n, int E, int C, int D, int F, int act,
                          cudaStream_t stream) {
  auto kernel = fused_moe_stream<T, CT, GATED>;
  CUtensorMap tm_in, tm_gate, tm_out;
  if (!weight_map<T>(&tm_in, w_in, E, D, F) ||
      !weight_map<T>(&tm_gate, GATED ? w_gate : w_in, E, D, F) ||
      !weight_map<T>(&tm_out, w_out, E, F, D))
    return cudaErrorInvalidValue;
  // at most every expert live; blocks past the live items return at once.
  // Every block must be resident: phase-B items wait on other blocks.
  const int tile = StreamSmem<T, CT, GATED>::kCols;
  const int items = E * (ceil_div(F, tile) + 2 * ceil_div(D, tile));
  const int smem = stream_smem<T, CT, GATED>(E);
  const int resident = smem <= StreamSmem<T, CT, GATED>::kTotal + kMaskBytes
                           ? stream_max_blocks<T, CT, GATED>()
                           : resident_blocks(kernel, kSThreads, smem);
  const int grid = items < resident ? items : resident;
  kernel<<<grid, kSThreads, smem, stream>>>(tm_in, tm_gate, tm_out, static_cast<const T*>(x), st,
                                            wslot, out, hbuf, ready, n, E, C, D, F, act);
  return cudaGetLastError();
}

// C rounded up to the compiled row counts 1, 4, 8, 16
template <typename T, bool GATED>
cudaError_t stream_rows(const void* x, const void* w_in, const void* w_gate, const void* w_out,
                        const int32_t* st, const float* wslot, float* out, float* hbuf,
                        int* ready, int n, int E, int C, int D, int F, int act,
                        cudaStream_t s) {
  if (C == 1)
    return launch_stream<T, 1, GATED>(x, w_in, w_gate, w_out, st, wslot, out, hbuf, ready, n,
                                      E, C, D, F, act, s);
  if (C <= 4)
    return launch_stream<T, 4, GATED>(x, w_in, w_gate, w_out, st, wslot, out, hbuf, ready, n,
                                      E, C, D, F, act, s);
  if (C <= 8)
    return launch_stream<T, 8, GATED>(x, w_in, w_gate, w_out, st, wslot, out, hbuf, ready, n,
                                      E, C, D, F, act, s);
  return launch_stream<T, 16, GATED>(x, w_in, w_gate, w_out, st, wslot, out, hbuf, ready, n,
                                     E, C, D, F, act, s);
}

template <typename T>
int stream_dtype(const void* x, const void* w_in, const void* w_gate, const void* w_out,
                 const int32_t* st, const float* wslot, float* out, float* hbuf, int* ready,
                 int n, int E, int C, int D, int F, int act, cudaStream_t s) {
  if (!stream_ok<T>(x, w_in, w_gate, w_out, hbuf, C, D, F))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_gate != nullptr)
    return static_cast<int>(stream_rows<T, true>(x, w_in, w_gate, w_out, st, wslot, out, hbuf,
                                                 ready, n, E, C, D, F, act, s));
  return static_cast<int>(stream_rows<T, false>(x, w_in, w_gate, w_out, st, wslot, out, hbuf,
                                                ready, n, E, C, D, F, act, s));
}

template <typename T, int CT>
int variant_info(int kind, int* info) {
  if (kind == 0) {
    stream_max_blocks<T, CT, false>();     // raises the kernel's shared-memory limit
    return fill_info(reinterpret_cast<const void*>(fused_moe_stream<T, CT, false>),
                     stream_smem<T, CT, false>(128), kSThreads, info);
  }
  if (kind == 3) {
    stream_max_blocks<T, CT, true>();
    return fill_info(reinterpret_cast<const void*>(fused_moe_stream<T, CT, true>),
                     stream_smem<T, CT, true>(128), kSThreads, info);
  }
  constexpr int BR = CT <= 8 ? 8 : 16;
  if (kind == 1) {
    const int smem = tiled_smem<BR>(512);
    const auto kernel = fused_moe_kernel<T, BR, 1, false>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return fill_info(reinterpret_cast<const void*>(kernel), smem, kThreads, info);
  }
  if (kind == 2) {
    const int smem = tiled_smem<BR>(kKD + 1);
    const auto kernel = fused_moe_kernel<T, BR, 2, true>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return fill_info(reinterpret_cast<const void*>(kernel), smem, kThreads, info);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int variant_info_rows(int kind, int C, int* info) {
  if (C == 1) return variant_info<T, 1>(kind, info);
  if (C <= 4) return variant_info<T, 4>(kind, info);
  if (C <= 8) return variant_info<T, 8>(kind, info);
  return variant_info<T, 16>(kind, info);
}

}  // namespace

// out (T, D) f32, zeroed by the caller, accumulates the weighted expert
// outputs; x (T, D), w_in / w_gate (E, D, F), w_out (E, F, D) in one dtype;
// slot_token (E * C,) int32; wslot (E * C,) f32. w_gate may be null
// (ungated). act: 0 gelu (tanh), 1 silu. Tiled kernel, any shape.
extern "C" int repro_fused_moe(const void* x, const void* w_in, const void* w_gate,
                               const void* w_out, const void* slot_token, const void* wslot,
                               void* out, int n_tokens, int E, int C, int D, int F, int act,
                               int dtype, void* stream) {
  if (act != kGelu && act != kSilu) return static_cast<int>(cudaErrorInvalidValue);
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

// The same function on the streaming kernel (C <= 16, 16-byte rows and
// pointers; refuses other inputs with cudaErrorInvalidValue). workspace:
// E * C * F f32, 16-byte aligned, no initial value needed; counts: E
// int32, zeroed by the caller.
extern "C" int repro_fused_moe_stream(const void* x, const void* w_in, const void* w_gate,
                                      const void* w_out, const void* slot_token,
                                      const void* wslot, void* out, void* workspace,
                                      void* counts, int n_tokens, int E, int C, int D, int F,
                                      int act, int dtype, void* stream) {
  if (act != kGelu && act != kSilu) return static_cast<int>(cudaErrorInvalidValue);
  const auto* st = static_cast<const int32_t*>(slot_token);
  const auto* wsl = static_cast<const float*>(wslot);
  auto* o = static_cast<float*>(out);
  auto* wk = static_cast<float*>(workspace);
  auto* cnt = static_cast<int*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kReproF32)
    return stream_dtype<float>(x, w_in, w_gate, w_out, st, wsl, o, wk, cnt, n_tokens, E, C, D, F,
                               act, s);
  if (dtype == kReproBF16)
    return stream_dtype<__nv_bfloat16>(x, w_in, w_gate, w_out, st, wsl, o, wk, cnt, n_tokens, E,
                                       C, D, F, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What the device reports for one ungated kernel instantiation: info =
// {registers per thread, shared memory per block (static + dynamic) in
// bytes, local (spill) bytes per thread, resident blocks per SM}. kind: 0
// streaming (C rounded up to 1, 4, 8, 16), 1 tiled (its BR = 8 or 16 tile
// at D <= 512), 2 tiled and gated past D = 1,024 (two columns per thread,
// d in chunks).
extern "C" int repro_fused_moe_variant_info(int kind, int dtype, int C, int* info) {
  if (dtype == kReproF32) return variant_info_rows<float>(kind, C, info);
  if (dtype == kReproBF16) return variant_info_rows<__nv_bfloat16>(kind, C, info);
  return static_cast<int>(cudaErrorInvalidValue);
}
