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
// What bounds it on the H100 depends on C, the slots per expert. An expert
// none of whose slots carries weight (wslot == 0: empty, dropped or never
// kept) adds nothing, so only the live experts' w_in (and w_gate) and w_out
// are needed: 8.4 MB each in f32 at zcode-m3-base's (512, 2048), against 2
// x C x d x f FLOPs per matrix, 0.5 * C flops per f32 byte.
//   - C <= 16 (decode, serving, training): at most 8 flops per byte, under
//     the 20 at which the f32 CUDA cores (67 TFLOP/s) and not HBM (3.35
//     TB/s) set the limit: bound by the live weights' bytes.
//   - C >= 128 (every prefill of dbrx-132b and deepseek-v3-671b, C = 128 to
//     1,152): 64-576 flops per byte, bound by the f32 FFMA rate, counted
//     over the kept slots only.
// Tensor cores do not serve either: an f32 wgmma runs in TF32, which misses
// the f32 gate. Every intermediate stays in f32. The wrapper
// (kernels/moe_megakernel.py::variant) picks one of two designs per call:
//
// * The streaming kernel (fused_moe_stream), for C <= 16 with 16-byte rows
//   of d and f and 16-byte aligned pointers (every decode and training call).
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
// * The tiled kernel (fused_moe_tiled), for every other shape (C > 16,
//   ragged rows, misaligned views), at any d: the streaming kernel's two
//   phases on B1's register tile (tile_gemm.cuh) shaped 64 x 256, in one
//   persistent launch of the resident-block count.
//   - Units (expert, 64-row tile of its slots) that hold a weighted slot are
//     the only work, and only up to the unit's last weighted slot: each
//     block lists them from wslot at its start. Slots fill an expert's
//     capacity from the front, so at C = 128 with ~64 kept slots per expert
//     (dbrx-132b's and deepseek-v3-671b's prefills) 64-row units compute
//     ~1.5x the kept rows where 128-row ones computed ~2x.
//   - Phase A, (unit, 256 columns of f): the unit's rows of x gathered
//     through slot_token (clipped as the TPU kernel does), one 16-byte
//     cp.async per row segment (sm_90's TMA cannot gather rows), times
//     w_in, or gated 128 columns of w_gate and the same 128 of w_in in one
//     tile; the epilogue writes h = act(..) (gated: act(g) * h) in f32 to an
//     E x C x f workspace (793 MB at dbrx-132b's 2,304-token prefill, the
//     cuda pipeline's h) and raises the unit's count.
//   - Phase B, (unit, 256 columns of d): h @ w_out over all of f in
//     registers, then out[token] += wslot x acc, one f32 atomicAdd per
//     (slot, column): a top-1 output element receives exactly one add onto
//     zero, the same bits on every run, at any d. It first waits on the
//     unit's count (kMaxSpins, then a trap).
//   - Items are fetched in order from one counter (zeroed by the caller with
//     the output), phase A first, expert by expert, column tile by column
//     tile, the row tiles of one column tile side by side so that they
//     share its weights in L2. A fetched phase-B item waits only on items
//     fetched before it by resident blocks, and phase-A items never wait.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"
#include "stream.cuh"
#include "tile_gemm.cuh"

namespace {

enum Act { kGelu = 0, kSilu = 1 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kSilu) return v / (1.f + __expf(-v));
  // jax.nn.gelu's default: the tanh approximation
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(u));
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

// ---------------------------------------------------------------------------
// tiled kernel (C > 16, ragged rows, misaligned views)
// ---------------------------------------------------------------------------

constexpr int kUnitRows = 64;          // slot rows of a unit (expert, row tile): the tile's m
constexpr int kCols = tile::kTileOut / kUnitRows;   // the tile's 256 columns
constexpr int kGatedCols = kCols / 2;  // gated phase A: columns of f per item
constexpr int kMaxSmem = 232448;       // an H100 block's opt-in maximum

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// The ring: the larger of phase A's stages (x, T, by w_in, T) and phase
// B's (h, f32, by w_out, T).
template <typename T>
__host__ __device__ constexpr int tiled_ring() {
  constexpr int a = tile::kStages * tile::Stage<T, T, true, false, kUnitRows>::kBytes;
  constexpr int b = tile::kStages * tile::Stage<float, T, true, false, kUnitRows>::kBytes;
  return a > b ? a : b;
}

// The tables after the ring, for E experts of RT row tiles: each unit's
// rows up to its last weighted slot (bytes, 0 for a dead unit), the live
// experts, each one's first unit among the live units (and their count
// after the last), the row tile's tokens, and four ints (the fetched item,
// the live-expert count, the item's unit and column tile).
__host__ __device__ constexpr int tiled_tables(int E, int RT) {
  return round16(E * RT) + round16(4 * E) + round16(4 * (E + 1)) + 4 * kUnitRows + 16;
}

template <typename T>
__host__ __device__ constexpr int tiled_smem(int E, int C) {
  return tiled_ring<T>() + tiled_tables(E, (C + kUnitRows - 1) / kUnitRows);
}

// Phase A's A operand: the unit's slot rows of x, gathered through their
// (clipped) tokens.
template <typename T>
struct Gather {
  const T* x;
  const int* toks;
  int rows, D;
  __device__ __forceinline__ const T* at(int r, int col, int kt, int& n) const {
    const int k = kt * tile::kBK + col;
    n = r < rows ? D - k : 0;
    return n > 0 ? x + static_cast<size_t>(toks[r]) * D + k : x;
  }
  __device__ __forceinline__ long step() const { return tile::kBK; }
};

// Gated phase A's B operand: columns n0 .. n0 + 127 of w_gate then the same
// of w_in, one 256-column tile.
template <typename T>
struct GatedCols {
  const T* gate;
  const T* in;
  int F, n0, D;
  __device__ __forceinline__ const T* at(int r, int col, int kt, int& n) const {
    const int k = kt * tile::kBK + r;
    const bool second = col >= kGatedCols;
    const int c = n0 + col - (second ? kGatedCols : 0);
    n = k < D ? F - c : 0;
    return n > 0 ? (second ? in : gate) + static_cast<size_t>(k) * F + c : gate;
  }
  __device__ __forceinline__ long step() const { return static_cast<long>(tile::kBK) * F; }
};

// 4 adjacent f32 outputs at p (16-byte aligned where vec), the first n < 4
// of them where the row ends
__device__ __forceinline__ void store_h(float* p, const float (&v)[4], bool vec, int n) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) p[j] = v[j];
  }
}

// out (T, D) f32 += the weighted FFN of every live unit; hbuf: (E, C, F) f32,
// the units' h; counts: E x RT int32 (phase-A items done per unit), then
// the item counter; all zero on entry. VEC: x, the weights and hbuf move in
// 16-byte words (rows of D and F whole words, pointers aligned; checked on
// the host), else element by element.
//
// One persistent launch (the resident-block count), B4's streaming kernel's
// two phases on B1's register tile shaped 64 x 256 (tile_gemm.cuh):
//   Unit (e, rt): expert e's slot rows rt * 64 .. + 63, up to the last that
//   carries weight; live when one does. Each block lists the live units
//   from wslot at its start (rows past an expert's last weighted slot, and
//   experts with none, are never read), in expert order.
//   Phase A item (live unit, column tile of f): h = act(rows @ w_in) (gated:
//   act(rows @ w_gate) * (rows @ w_in), both products in one tile of 128 +
//   128 columns), the rows gathered from x through slot_token, into hbuf;
//   then the unit's count is raised.
//   Phase B item (live unit, 256 columns of d): h[rows] @ w_out over all of
//   f in registers, then out[token(s)] += wslot[s] * acc, one f32 atomicAdd
//   per (slot, column) of non-zero weight: a top-1 call adds once onto zero
//   per output element, the same bits on every run.
//   Items are numbered phase A first, each phase expert-major, then column
//   tile, then row tile (the row tiles of one weight column tile run side by
//   side and share it in L2), and fetched in that order from one counter.
//   A phase-B item waits until its unit's phase-A count is complete: every
//   item it waits on was fetched before it by a resident block, and
//   phase-A items never wait, so none waits on a block that has not
//   started.
template <typename T, bool GATED, bool VEC>
__global__ void __launch_bounds__(tile::kThreads, 1)
fused_moe_tiled(const T* __restrict__ x, const T* __restrict__ w_in,
                const T* __restrict__ w_gate, const T* __restrict__ w_out,
                const int32_t* __restrict__ slot_token, const float* __restrict__ wslot,
                float* __restrict__ out, float* __restrict__ hbuf, int* __restrict__ counts,
                int n_tokens, int E, int C, int D, int F, int act) {
  extern __shared__ __align__(128) unsigned char shm[];
  const int RT = ceil_div_d(C, kUnitRows), n_all = E * RT;
  unsigned char* rows_of = shm + tiled_ring<T>();
  int* exp_id = reinterpret_cast<int*>(rows_of + round16(n_all));
  int* exp_first = exp_id + round16(4 * E) / 4;
  int* toks = exp_first + round16(4 * (E + 1)) / 4;
  int* misc = toks + kUnitRows;
  const int tid = threadIdx.x;

  // each unit's rows up to its last weighted slot (0: a dead unit), then
  // (one thread) the live experts in order and each one's first live unit
  // in the order of the live units (expert by expert, row tile by row tile)
  for (int u = tid; u < n_all; u += tile::kThreads) {
    const float* ws = wslot + (u / RT) * C + (u % RT) * kUnitRows;
    int c = min(C - (u % RT) * kUnitRows, kUnitRows);
    while (c > 0 && ws[c - 1] == 0.f) --c;
    rows_of[u] = static_cast<unsigned char>(c);
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0, k = 0;
    for (int e = 0; e < E; ++e) {
      const int first = n;
      for (int rt = 0; rt < RT; ++rt) n += rows_of[e * RT + rt] != 0;
      if (n > first) {
        exp_id[k] = e;
        exp_first[k++] = first;
      }
    }
    exp_first[k] = n;
    misc[1] = k;
  }
  __syncthreads();
  const int n_live = misc[1], n_units = exp_first[n_live];
  const int na = ceil_div_d(F, GATED ? kGatedCols : kCols);   // phase-A items per unit
  const int nb = ceil_div_d(D, kCols);                        // phase-B items per unit
  const int n_a = n_units * na, n_items = n_a + n_units * nb;
  const tile::Pos p(kCols / 32);
  float acc[8][8];

  for (;;) {
    if (tid == 0) {
      // fetch the next item and decode it: its unit (expert e, row tile)
      // and column tile
      const int item = atomicAdd(counts + n_all, 1);
      misc[0] = item;
      if (item < n_items) {
        const bool b = item >= n_a;
        const int per = b ? nb : na, i = b ? item - n_a : item;
        int lo = 0, hi = n_live - 1;      // the live expert whose units hold unit i / per
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (exp_first[mid] <= i / per) lo = mid;
          else hi = mid - 1;
        }
        const int first = exp_first[lo], nu = exp_first[lo + 1] - first;
        const int local = i - first * per, e = exp_id[lo];
        int j = local % nu, rt = 0;       // the expert's j-th live row tile
        for (;; ++rt)
          if (rows_of[e * RT + rt] != 0 && j-- == 0) break;
        misc[2] = e * RT + rt;
        misc[3] = local / nu;
      }
    }
    __syncthreads();
    const int item = misc[0];
    if (item >= n_items) break;
    const bool phase_b = item >= n_a;
    const int ue = misc[2], ct = misc[3];
    const int e = ue / RT, c0 = (ue % RT) * kUnitRows, rows = rows_of[ue];
    const size_t wofs = static_cast<size_t>(e) * D * F;
    float* hrows = hbuf + (static_cast<size_t>(e) * C + c0) * F;

    if (!phase_b) {
      if (tid < kUnitRows)
        toks[tid] = tid < rows ? clamp_index(slot_token[e * C + c0 + tid], n_tokens) : 0;
      __syncthreads();
      const Gather<T> sa{x, toks, rows, D};
      if constexpr (GATED) {
        const int n0 = ct * kGatedCols;
        const GatedCols<T> sb{w_gate + wofs, w_in + wofs, F, n0, D};
        tile::gemm<T, T, true, false, VEC, VEC, 16, kGatedCols, kUnitRows>(shm, sa, sb, D, rows,
                                                                          p, acc);
        const int c = p.col<false, 16, kGatedCols>(0);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int m = p.row<true>(r);
          if (m >= rows) continue;
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = activate(acc[r][j], act) * acc[r][j + 4];
          store_h(hrows + static_cast<size_t>(m) * F + n0 + c, v, VEC, F - n0 - c);
        }
      } else {
        const int n0 = ct * kCols;
        const tile::MNRows<T> sb{w_in + wofs, F, n0, F, D};
        tile::gemm<T, T, true, false, VEC, VEC, 32, 16, kUnitRows>(shm, sa, sb, D, rows, p, acc);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int m = p.row<true>(r);
          if (m >= rows) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = p.col<false, 32, 16>(4 * h);
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = activate(acc[r][4 * h + j], act);
            store_h(hrows + static_cast<size_t>(m) * F + n0 + c, v, VEC, F - n0 - c);
          }
        }
      }
      // the unit's h columns are written: raise its count (the barrier
      // orders the block's stores before thread 0's fence)
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        atomicAdd(counts + ue, 1);
      }
    } else {
      if (tid == 0) {
        // a count that never completes is a fault: trap rather than hang
        for (int spins = 0; load_acquire(counts + ue) < na; ++spins) {
          if (spins == tile::kMaxSpins) __trap();
          __nanosleep(256);
        }
      }
      __syncthreads();
      const int n0 = ct * kCols;
      const tile::KRows<float> sa{hrows, F, 0, rows, F};
      const tile::MNRows<T> sb{w_out + static_cast<size_t>(e) * F * D, D, n0, D, F};
      tile::gemm<float, T, true, false, VEC, VEC, 32, 16, kUnitRows>(shm, sa, sb, F, rows, p,
                                                                     acc);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int m = p.row<true>(r);
        if (m >= rows) continue;
        const int s = e * C + c0 + m;
        const float wt = wslot[s];
        if (wt == 0.f) continue;
        float* o = out + static_cast<size_t>(clamp_index(slot_token[s], n_tokens)) * D + n0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = p.col<false, 32, 16>(j);
          if (n0 + c < D) atomicAdd(o + c, wt * acc[r][j]);
        }
      }
    }
  }
}

template <typename T, bool GATED, bool VEC>
const void* tiled_kernel() {
  static const bool raised = [] {
    cudaFuncSetAttribute(fused_moe_tiled<T, GATED, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    return true;
  }();
  (void)raised;
  return reinterpret_cast<const void*>(fused_moe_tiled<T, GATED, VEC>);
}

template <typename T, bool GATED, bool VEC>
cudaError_t launch_tiled(const void* x, const void* w_in, const void* w_gate, const void* w_out,
                         const int32_t* st, const float* wslot, float* out, float* hbuf,
                         int* counts, int n, int E, int C, int D, int F, int act,
                         cudaStream_t stream) {
  const void* kernel = tiled_kernel<T, GATED, VEC>();
  const int smem = tiled_smem<T>(E, C);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // every block resident: phase-B items wait on other blocks
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, tile::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int RT = ceil_div(C, kUnitRows);
  const long most = static_cast<long>(E) * RT *
                    (ceil_div(F, GATED ? kGatedCols : kCols) + ceil_div(D, kCols));
  const int grid = most < sms * per_sm ? static_cast<int>(most) : sms * per_sm;
  fused_moe_tiled<T, GATED, VEC><<<grid, tile::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in), static_cast<const T*>(w_gate),
      static_cast<const T*>(w_out), st, wslot, out, hbuf, counts, n, E, C, D, F, act);
  return cudaGetLastError();
}

template <typename T>
int tiled_dtype(const void* x, const void* w_in, const void* w_gate, const void* w_out,
                const int32_t* st, const float* wslot, float* out, float* hbuf, int* counts,
                int n, int E, int C, int D, int F, int act, cudaStream_t s) {
  const bool vec = (D * sizeof(T)) % 16 == 0 && (F * sizeof(T)) % 16 == 0 && aligned16(x) &&
                   aligned16(w_in) && (w_gate == nullptr || aligned16(w_gate)) &&
                   aligned16(w_out) && aligned16(hbuf);
  const bool gated = w_gate != nullptr;
  cudaError_t err;
  if (gated && vec)
    err = launch_tiled<T, true, true>(x, w_in, w_gate, w_out, st, wslot, out, hbuf, counts, n, E,
                                      C, D, F, act, s);
  else if (gated)
    err = launch_tiled<T, true, false>(x, w_in, w_gate, w_out, st, wslot, out, hbuf, counts, n,
                                       E, C, D, F, act, s);
  else if (vec)
    err = launch_tiled<T, false, true>(x, w_in, w_gate, w_out, st, wslot, out, hbuf, counts, n,
                                       E, C, D, F, act, s);
  else
    err = launch_tiled<T, false, false>(x, w_in, w_gate, w_out, st, wslot, out, hbuf, counts, n,
                                        E, C, D, F, act, s);
  return static_cast<int>(err);
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
  return static_cast<int>(cudaErrorInvalidValue);
}

// tiled: kind 1 ungated, 2 gated (16-byte words), 4 and 5 the same with
// element loads; shared memory for 128 experts of C slots
template <typename T>
int tiled_info(int kind, int C, int* info) {
  const void* kernel = kind == 1   ? tiled_kernel<T, false, true>()
                       : kind == 2 ? tiled_kernel<T, true, true>()
                       : kind == 4 ? tiled_kernel<T, false, false>()
                                   : tiled_kernel<T, true, false>();
  return fill_info(kernel, tiled_smem<T>(128, C), tile::kThreads, info);
}

template <typename T>
int variant_info_rows(int kind, int C, int* info) {
  if (kind == 1 || kind == 2 || kind == 4 || kind == 5) return tiled_info<T>(kind, C, info);
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
// workspace: E * C * F f32, no initial value needed; counts: E * ceil(C /
// 64) + 1 int32, zeroed by the caller.
extern "C" int repro_fused_moe(const void* x, const void* w_in, const void* w_gate,
                               const void* w_out, const void* slot_token, const void* wslot,
                               void* out, void* workspace, void* counts, int n_tokens, int E,
                               int C, int D, int F, int act, int dtype, void* stream) {
  if (act != kGelu && act != kSilu) return static_cast<int>(cudaErrorInvalidValue);
  const auto* st = static_cast<const int32_t*>(slot_token);
  const auto* wsl = static_cast<const float*>(wslot);
  auto* o = static_cast<float*>(out);
  auto* wk = static_cast<float*>(workspace);
  auto* cnt = static_cast<int*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kReproF32)
    return tiled_dtype<float>(x, w_in, w_gate, w_out, st, wsl, o, wk, cnt, n_tokens, E, C, D, F,
                              act, s);
  if (dtype == kReproBF16)
    return tiled_dtype<__nv_bfloat16>(x, w_in, w_gate, w_out, st, wsl, o, wk, cnt, n_tokens, E,
                                      C, D, F, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
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

// What the device reports for one kernel instantiation: info = {registers
// per thread, shared memory per block (static + dynamic) in bytes, local
// (spill) bytes per thread, resident blocks per SM}. kind: 0 streaming, 3
// streaming gated (C rounded up to 1, 4, 8, 16; shared memory for 128
// experts); 1 tiled, 2 tiled gated (16-byte words), 4 and 5 the same with
// element loads (shared memory for 128 experts of C slots).
extern "C" int repro_fused_moe_variant_info(int kind, int dtype, int C, int* info) {
  if (dtype == kReproF32) return variant_info_rows<float>(kind, C, info);
  if (dtype == kReproBF16) return variant_info_rows<__nv_bfloat16>(kind, C, info);
  return static_cast<int>(cudaErrorInvalidValue);
}
