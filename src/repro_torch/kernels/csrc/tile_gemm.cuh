// The register-tiled f32 GEMM tile shared by B1's tiled kernel
// (grouped_ffn.cu, every product with C > 16) and B4's tiled kernel
// (moe_megakernel.cu, both of its phases).
//
// What bounds it on the H100: operations. At C = 128-1,152 rows per expert
// a product does 2 * C flops per weight element, 64-576 flops per f32 byte,
// far past the 20 per byte at which the f32 CUDA cores (67 TFLOP/s) and not
// HBM (3.35 TB/s) set the limit. TF32 tensor cores miss the f32 gate (1e-4
// + 1e-4 |ref|), so the tile is a CUDA-core SGEMM and every design choice
// serves the FFMA issue rate:
//
// * A block computes a 128 x 128 output tile (B1; B4 a 64 x 256 one) with
//   256 threads, each an 8 x 8 f32 accumulator in registers (64 FFMA per 4
//   shared-memory loads of 16 bytes). 8 warps, 2 along m by 4 along n (1 by
//   8), each a 64 x 32 warp tile of 8 x 4 lanes. The k loop of a stage is
//   fully unrolled (2,048 FFMA a thread), which takes ~230-255 registers:
//   one block per SM. A cap of 128
//   registers (two blocks per SM) spills in the inner loop.
// * The k axis goes in steps of kBK = 32 through a ring of kStages = 4 stages
//   in dynamic shared memory, filled by 16-byte cp.async.cg copies that
//   zero-fill past a ragged edge (the src-size operand), so any C, d and f
//   work; one __syncthreads per step. A thread's copies for the full steps
//   are addressed once (Feed) and advanced by one add a step; a ragged last
//   step goes through the general path (load_tile).
// * A warp whose 64 rows lie past the operand's last real row (B1's last
//   row tile, M - m0 <= 64) copies its share and skips its FFMAs.
// * Each operand is copied along its contiguous axis, never transposed in
//   global memory: a k-contiguous operand (x or dy rows, w read as w^T)
//   lands as [128 (or 64) rows][32 k] rows padded by 16 bytes, so that the 8
//   distinct rows a warp reads at once fall in distinct banks; an
//   m/n-contiguous operand (w, dy, x read as x^T) lands as [32 k][128 (or
//   256)]. The inner loop reads 16 bytes per load either way: for a k-contiguous
//   operand 4 k values of one row, for the other 4 rows (or columns) of one
//   k. Thread rows interleave (tm + 8 i) in the first case and come in runs
//   of 4 in the second.
// * bf16 operands are staged as bf16 and widened to f32 as they are read.
// * A view whose rows are not whole 16-byte words, or not 16-byte aligned,
//   takes the same kernel with element loads (VEC = false): synchronous,
//   slower, any alignment.
// * Each output element is summed by one thread in a fixed order: no
//   atomics, no split-K, the same bits on every run.
#pragma once

#include "common.cuh"
#include "stream.cuh"

namespace tile {

constexpr int kBM = 128;           // output rows per block (B1; B4 takes 64 x 256)
constexpr int kBN = 128;           // output columns per block
constexpr int kTileOut = 16384;    // outputs per block: 256 threads x 8 x 8
constexpr int kBK = 32;            // k per stage
constexpr int kThreads = 256;      // 8 warps: 2 (m) x 4 (n), 64 x 32 each
constexpr int kMaxSpins = 1 << 24; // a wait's polls before it traps (seconds)

constexpr int kStages = 4;         // the ring: 136-144 KB of f32 tiles, one block per SM

// One operand tile in shared memory, R its extent along m (or n). KC: the
// operand's contiguous axis is k ([R rows][kBK + pad]); else it is m or n
// ([kBK rows][R]).
template <typename T, bool KC, int R>
struct Layout {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));   // elements per 16 bytes
  static constexpr int kRows = KC ? R : kBK;
  static constexpr int kLen = KC ? kBK : R;
  static constexpr int kStride = kLen + (KC ? kV : 0);           // elements
  static constexpr int kBytes = kRows * kStride * static_cast<int>(sizeof(T));
  static constexpr int kPerRow = kLen / kV;                      // 16-byte chunks per row
  static constexpr int kPerThread = kRows * kPerRow / kThreads;
  static_assert(kRows * kPerRow % kThreads == 0, "whole chunks per thread");
};

// A stage of a BM x (kTileOut / BM) tile: A's rows, then B's columns.
template <typename TA, typename TB, bool AKC, bool BKC, int BM>
struct Stage {
  static constexpr int kA = Layout<TA, AKC, BM>::kBytes;
  static constexpr int kBytes = (kA + Layout<TB, BKC, kTileOut / BM>::kBytes + 127) / 128 * 128;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copies k-step kt of one operand into its stage buffer. src.at(r, col,
// kt, n) gives the global address of the tile's element (r, col) in this
// step and sets n to the elements left in its row from there (n <= 0: past
// the operand's edge, zeros; the address is then any valid one).
template <typename T, bool KC, int R, bool VEC, class Src>
__device__ __forceinline__ void load_tile(T* s, const Src& src, int kt) {
  using L = Layout<T, KC, R>;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < L::kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / L::kPerRow, col = (c % L::kPerRow) * L::kV;
      int n;
      const T* g = src.at(r, col, kt, n);
      n = n < 0 ? 0 : (n > L::kV ? L::kV : n);
      cp_async16(s + r * L::kStride + col, g, n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int idx = threadIdx.x; idx < L::kRows * L::kLen; idx += kThreads) {
      const int r = idx / L::kLen, col = idx % L::kLen;
      int n;
      const T* g = src.at(r, col, kt, n);
      s[r * L::kStride + col] = n > 0 ? g[0] : from_f32<T>(0.f);
    }
  }
}

// One operand's 16-byte chunks of this thread over the full k steps (K /
// kBK of them, in order): each chunk's address and byte count are worked
// out once, at step 0, and the address advances by src.step() elements a
// step, so a step's copies cost an add and a cp.async each. A row outside
// the operand keeps 0 bytes (zeros) and its address.
template <typename T, bool KC, int R, class Src>
struct Feed {
  using L = Layout<T, KC, R>;
  const T* p[L::kPerThread];
  int bytes[L::kPerThread];
  long step;
  __device__ __forceinline__ explicit Feed(const Src& src) : step(src.step()) {
#pragma unroll
    for (int i = 0; i < L::kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      int n;
      p[i] = src.at(c / L::kPerRow, (c % L::kPerRow) * L::kV, 0, n);
      n = n < 0 ? 0 : (n > L::kV ? L::kV : n);
      bytes[i] = n * static_cast<int>(sizeof(T));
    }
  }
  __device__ __forceinline__ void next(T* s) {
#pragma unroll
    for (int i = 0; i < L::kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      cp_async16(s + (c / L::kPerRow) * L::kStride + (c % L::kPerRow) * L::kV, p[i], bytes[i]);
      if (bytes[i] > 0) p[i] += step;
    }
  }
};

// A thread's place in the tile: warp (wm, wn) of 8 / warps_n along m and
// warps_n along n (4 of a 128 x 128 tile, 8 of a 64 x 256 one), lane (tm,
// tn).
struct Pos {
  int wm, wn, tm, tn;
  __device__ __forceinline__ explicit Pos(int warps_n) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wm = warp / warps_n;
    wn = warp % warps_n;
    tm = lane / 4;
    tn = lane % 4;
  }
  // tile row of accumulator row i
  template <bool AKC>
  __device__ __forceinline__ int row(int i) const {
    return AKC ? wm * 64 + tm + 8 * i : wm * 64 + (i / 4) * 32 + tm * 4 + i % 4;
  }
  // tile column of accumulator column j. BKC: interleaved (tn + 4 j). Else
  // two runs of 4: at wn * WNC + tn * 4 and HALF further on (32 and 16 for a
  // plain tile; 16 and 64 for a gated pair, whose columns j and j + 4 are
  // the same output column of w_gate and of w_in).
  template <bool BKC, int WNC, int HALF>
  __device__ __forceinline__ int col(int j) const {
    return BKC ? wn * 32 + tn + 4 * j : wn * WNC + tn * 4 + (j % 4) + (j / 4) * HALF;
  }
};

// acc[i][j] += the stage's A rows x B columns over its kBK values of k,
// fully unrolled where FULL (2,048 FFMA a thread), else one 4-deep step per
// iteration (the element-load instances, bound by their loads: less code
// to compile); a k-contiguous operand is read 4 values of k per row at a
// time.
template <typename TA, typename TB, bool AKC, bool BKC, int WNC, int HALF, int BM, bool FULL>
__device__ __forceinline__ void mma_stage(const TA* As, const TB* Bs, const Pos& p,
                                          float (&acc)[8][8]) {
  using LA = Layout<TA, AKC, BM>;
  using LB = Layout<TB, BKC, kTileOut / BM>;
#pragma unroll (FULL ? kBK / 4 : 1)
  for (int k0 = 0; k0 < kBK; k0 += 4) {
    if constexpr (AKC) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) load4(As + p.row<true>(i) * LA::kStride + k0, a[i]);
      if constexpr (!BKC) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float b0[4], b1[4];
          const TB* bp = Bs + (k0 + q) * LB::kStride + p.wn * WNC + p.tn * 4;
          load4(bp, b0);
          load4(bp + HALF, b1);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] += a[i][q] * b0[j];
              acc[i][j + 4] += a[i][q] * b1[j];
            }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float b[4];
          load4(Bs + p.col<true, WNC, HALF>(j) * LB::kStride + k0, b);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j] += a[i][q] * b[q];
        }
      }
    } else {
      static_assert(!BKC, "no product reads both operands along m and n");
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float a0[4], a1[4], b0[4], b1[4];
        const TA* ap = As + (k0 + q) * LA::kStride + p.wm * 64 + p.tm * 4;
        load4(ap, a0);
        load4(ap + 32, a1);
        const TB* bp = Bs + (k0 + q) * LB::kStride + p.wn * WNC + p.tn * 4;
        load4(bp, b0);
        load4(bp + HALF, b1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] += a0[i] * b0[j];
            acc[i][j + 4] += a0[i] * b1[j];
            acc[i + 4][j] += a1[i] * b0[j];
            acc[i + 4][j + 4] += a1[i] * b1[j];
          }
      }
    }
  }
}

// acc = A (the tile's BM rows, the first ``rows`` of them real) x B (its
// kTileOut / BM columns) over k in [0, K): the ring's prologue, then per step one
// wait, one barrier, the copy of the step kStages - 1 ahead and the stage's
// FFMAs. Ends with every copy landed and every thread past its last read,
// so the caller may reuse the ring.
template <typename TA, typename TB, bool AKC, bool BKC, bool VA, bool VB, int WNC, int HALF,
          int BM = kBM, class SA, class SB>
__device__ __forceinline__ void gemm(unsigned char* ring, const SA& sa, const SB& sb, int K,
                                     int rows, const Pos& p, float (&acc)[8][8]) {
  using S = Stage<TA, TB, AKC, BKC, BM>;
  constexpr int BN = kTileOut / BM;
  constexpr int NS = kStages;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = (K + kBK - 1) / kBK, nfull = K / kBK;
  // a warp whose 64 rows all lie past the operand's last row (a B4 unit's
  // last weighted slot) computes nothing
  const bool busy = p.wm * 64 < rows;
  Feed<TA, AKC, BM, SA> fa(sa);
  Feed<TB, BKC, BN, SB> fb(sb);
  // steps are copied in order: the full ones through the feeds, a ragged
  // last one (and every step of an element-load operand) through load_tile
  auto load = [&](int kt) {
    unsigned char* st = ring + (kt % NS) * S::kBytes;
    if (VA && kt < nfull) fa.next(reinterpret_cast<TA*>(st));
    else load_tile<TA, AKC, BM, VA>(reinterpret_cast<TA*>(st), sa, kt);
    if (VB && kt < nfull) fb.next(reinterpret_cast<TB*>(st + S::kA));
    else load_tile<TB, BKC, BN, VB>(reinterpret_cast<TB*>(st + S::kA), sb, kt);
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (kt + NS - 1 < nk) load(kt + NS - 1);
    cp_async_commit();
    const unsigned char* st = ring + (kt % NS) * S::kBytes;
    if (busy)
      mma_stage<TA, TB, AKC, BKC, WNC, HALF, BM, VA>(reinterpret_cast<const TA*>(st),
                                             reinterpret_cast<const TB*>(st + S::kA), p, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Sources of the tile's operands (Src of load_tile).

// K-contiguous rows: tile row r is global row r0 + r (valid below rows),
// its K values at base + (r0 + r) * ld.
template <typename T>
struct KRows {
  const T* base;
  int ld, r0, rows, K;
  __device__ __forceinline__ const T* at(int r, int col, int kt, int& n) const {
    const int k = kt * kBK + col;
    n = r < rows ? K - k : 0;
    return n > 0 ? base + static_cast<size_t>(r0 + r) * ld + k : base;
  }
  __device__ __forceinline__ long step() const { return kBK; }
};

// M- or n-contiguous: tile row r is k = kt * kBK + r (valid below K), its
// columns c0 .. N - 1 at base + k * ld.
template <typename T>
struct MNRows {
  const T* base;
  int ld, c0, N, K;
  __device__ __forceinline__ const T* at(int r, int col, int kt, int& n) const {
    const int k = kt * kBK + r, c = c0 + col;
    n = k < K ? N - c : 0;
    return n > 0 ? base + static_cast<size_t>(k) * ld + c : base;
  }
  __device__ __forceinline__ long step() const { return static_cast<long>(kBK) * ld; }
};

}  // namespace tile
