// B1 grouped matmul: out[e] = A[e] @ B[e] for every expert e, f32
// accumulation, output in the input dtype. Three products share this file,
// each reading a transposed operand in place through its layout (no
// transposed copy is made):
//
//   forward  out = x  @ w     A = x  (E, C, D)            B = w  (E, D, F)
//   dx       dx  = dy @ w^T   A = dy (E, C, F)            B = w^T, read from w (E, D, F)
//   dw       dw  = x^T @ dy   A = x^T, read from x (E, C, D)   B = dy (E, C, F)
//
// Replaces repro/kernels/grouped_ffn.py::_gmm_impl / _kernel, and its
// custom VJP _gmm_bwd, which runs the same Pallas kernel on
// jnp.swapaxes'd operands. The TPU kernel walks grid (E, C/bc, F/bf,
// D/bd) with the D axis sequential and an f32 VMEM accumulator; blocks
// are exact divisors of the shape (platform.py::fit_block).
//
// What bounds it on the H100 depends on C, the rows per expert: each
// product does 2 * C flops per weight-sized element it moves, 0.5 * C per
// f32 byte, against the 20 per byte (67 TFLOP/s of f32 CUDA cores over
// 3.35 TB/s of HBM) past which operations, not bytes, set the limit.
//   - C <= 16 (decode, serving, training: C = 1-8): at most 8 flops per
//     byte, so all three are bound by the bytes of the weight-sized operand:
//     the forward and dx read every expert's w once (537 MB of f32 at (128,
//     2048, 512)), dw writes one.
//   - C >= 128 (every prefill of dbrx-132b and deepseek-v3-671b: C = 128
//     to 1,152): 64-576 flops per byte, bound by the f32 FFMA rate.
// Tensor cores do not serve either: an f32 wgmma runs in TF32 (10-bit
// mantissa), which misses the f32 gate of 1e-4 + 1e-4 |ref| against the
// plain version. So there are two designs, both on the CUDA cores in f32,
// and the wrapper (kernels/grouped_ffn.py::variant) picks one per call:
//
// * Streaming kernels, for C <= 16 with 16-byte row strides and 16-byte
//   aligned pointers (every decode and training call), one per product:
//   - forward (gmm_stream_fwd): a persistent grid walks work items
//     (expert, 128-column slab of F); each item reduces over all of D, so
//     no sum crosses blocks (no atomics, the same result on every run).
//     One producer warp streams w through a 4-stage ring in shared memory
//     with cp.async.bulk (global -> shared, completing on an mbarrier):
//     one copy per row segment (512 bytes in f32, 256 in bf16), 16 KB of w
//     per stage (32 rows in f32, 64 in bf16), plus the stage's C x R
//     slice of x[e], so x is staged in chunks over D beside the ring. No
//     tensor map is needed, so a launch costs no host-side encode. What
//     sets the rate is the bytes in flight per SM, so the block holds
//     nothing else in shared memory: four consumer warps own 32 columns
//     each, their lanes split each stage's rows in four groups, and the
//     groups' f32 sums meet at the end of an item by two xor-shuffles in
//     a fixed order. That leaves 66-74 KB per block, three blocks on every
//     SM at every C <= 16, and ~150 KB of loads in flight per SM (HBM3
//     needs ~25 KB at ~1 us unloaded). A lane's unit is one 16-byte word
//     of x's row (4 rows in f32, 8 in bf16) by 4 columns, so the shared
//     memory pipe serves one x load per row c of x and unit, not one per
//     row. The grid is the resident-block count cut down so that every
//     block gets the same number of items (512 items at decode: 256
//     blocks of 2, not a 3.9-wave tail over 132 SMs).
//   - dx (gmm_stream_dx): the forward transposed. dx reduces over w's
//     contiguous axis F, so a work item is (expert, slab of rows of D) and
//     each w row segment is an unbroken run of memory: no transposed copy
//     of w. The producer warp fills a ring with one bulk copy per 512-byte
//     row segment (a stage holds the slab's rows x one chunk of F) and
//     dy[e]'s C x chunk slice beside it, so F = 512 and F = 2048 stream
//     alike and dy never sits whole in shared memory (64 KB at F = 2048,
//     C = 8, which would cost a resident block per SM). A consumer warp
//     owns 8 rows of the slab (4 above C = 4), its lanes one 16-byte word
//     of each chunk; each lane keeps rows x C f32 sums over the whole
//     item and reads each w word and each dy word of a stage once,
//     holding its row words in registers while it walks dy's. At
//     the end of an item a warp meets its lanes' sums by halving
//     xor-shuffles (fewer than N shuffles for N sums, in a fixed order).
//     What set its rate, measured: the size of each bulk copy (256-byte
//     segments reached 65-70% of the bound at C = 8, 512-byte ones 85%)
//     and resident blocks, so the ring takes as many stages as fit four
//     blocks per SM (48-54 KB at C <= 8).
//   - dw (gmm_stream_dw): bound by writing dw, ~50x the bytes of x and dy
//     together (10.5 MB at the training site, they stay in L2). A block owns 64 rows of D x
//     (512 bytes of F) of one expert, loads its slices of x[e] (read
//     transposed in place) and dy[e] into shared memory with 16-byte
//     cp.async, keeps each thread's C x (4 f32 or 8 bf16) dy values in
//     registers, unrolls the C-long reduction, and writes each output run
//     with one 16-byte streaming store (st.global.cs), so a warp writes a
//     whole 512-byte run and the 537 MB written does not evict x and dy
//     from L2. Stores leave the thread at once, so no shared-memory tile
//     or TMA store is needed to keep them in flight: with 4 blocks of 256
//     threads per SM at C = 8 (2-8 by C), each thread issuing 8 stores,
//     enough are always queued.
// * The tiled kernel (grouped_matmul_tiled), for everything else (C > 16,
//   ragged row strides, misaligned views), the same kernel for all three
//   products: a register-tiled SGEMM (tile_gemm.cuh). A block owns a 128 x
//   128 output tile of one expert, 256 threads each with an 8 x 8 f32
//   accumulator, and walks k in steps of 32 through a 4-stage ring of
//   16-byte cp.async copies that zero-fill ragged edges; x^T and w^T are
//   copied along their contiguous axis into layouts that the inner loop
//   reads 16 bytes at a time. One block per SM. Rows
//   that are not whole 16-byte words, or misaligned views, take the same
//   kernel with element loads (its VEC = false instance). No atomics and
//   no split-K: each output element is one thread's sum in a fixed order.

#include "common.cuh"
#include "stream.cuh"
#include "tile_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// streaming kernels (C <= 16)
// ---------------------------------------------------------------------------

constexpr int kMaxStreamC = 16;
constexpr int kNW = 4;                        // consumer warps (forward and dx)
constexpr int kRowGroups = 4;                 // forward: row groups of a warp's lanes
constexpr int kFwdThreads = (kNW + 1) * 32;   // + one producer warp (forward and dx)
constexpr int kSBN = 128;                     // forward: columns per work item
constexpr int kStages = 4;                    // forward
constexpr int kStageW = 16384;                // forward: bytes of w per stage
constexpr int kDwBM = 64;                     // dw: rows of D per block
constexpr int kDxChunk = 512;                 // dx: bytes of F per row segment and stage
constexpr int kDxSmem = 57344 - 64;           // dx: ring bytes that fit four blocks per SM
constexpr int kDwThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// 16 bytes of output (4 f32 or 8 bf16) with one streaming store
__device__ __forceinline__ void store16_cs(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store16_cs(__nv_bfloat16* p, const float (&v)[8]) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7])));
}

// Shared memory of the forward kernel: kStages x (w stage, x stage), then
// the full and empty barriers.
template <typename T, int CT>
struct FwdSmem {
  static constexpr int kRows = kStageW / (kSBN * static_cast<int>(sizeof(T)));  // 32 f32, 64 bf16
  static constexpr int kX = CT * kRows * static_cast<int>(sizeof(T));           // CT x 128 bytes
  static constexpr int kStage = kStageW + kX;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kTotal = kBars + 2 * kStages * 8;
};

// One lane's unit of a stage: U = 16 / sizeof(T) adjacent rows r0.. (a
// whole 16-byte word of each row of x), 4 columns. Loads the U row pieces
// of w, then per row c of x one 16-byte load of its U values. d is a
// multiple of U (its rows are 16-byte words), so a unit is all in d or
// all past it.
template <typename T, int CT, int R>
__device__ __forceinline__ void consume_unit(const T* ws, const T* xs, int r0, int col,
                                             float (&acc)[CT][4]) {
  constexpr int U = 16 / sizeof(T);
  float wv[U][4];
#pragma unroll
  for (int i = 0; i < U; ++i) load4(ws + (r0 + i) * kSBN + col, wv[i]);
#pragma unroll
  for (int c = 0; c < CT; ++c) {           // rows c >= C are never stored
    float xv[U];
    load16(xs + c * R + r0, xv);
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] += xv[i] * wv[i][j];
  }
}

// out (E, C, F) = x (E, C, D) @ w (E, D, F), C <= CT <= 16; F and D of
// 16-byte rows, pointers 16-byte aligned (checked on the host).
//
// Warp w < kNW consumes columns 32w .. 32w + 31 of the item's slab: lane l
// owns columns 32w + 4(l % 8) .. + 3 and row group g = l / 8, which takes
// units g and g + 4 of each stage's R / U = 8 units. A quarter-warp reads
// 128 contiguous bytes of one row (f32). At the end of an item the four
// row groups' sums meet by two xor-shuffles (the same order every run) and
// group 0 stores.
template <typename T, int CT>
__global__ void __launch_bounds__(kFwdThreads, 3)
gmm_stream_fwd(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int E,
               int C, int D, int F) {
  using L = FwdSmem<T, CT>;
  constexpr int R = L::kRows;
  constexpr int U = 16 / sizeof(T);
  static_assert(R / U == 2 * kRowGroups, "two units per row group and stage");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_slab = ceil_div_d(F, kSBN);
  const int n_items = E * n_slab;
  const int n_k = ceil_div_d(D, R);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);        // the producer's arrive + the copies' bytes
      mbar_init(&empty[s], kNW);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kNW) {
    // producer: fills stage after stage, item after item, in the order
    // the consumers read them
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int e = item / n_slab, n0 = (item % n_slab) * kSBN;
      const int cols = min(kSBN, F - n0);
      const T* we = w + static_cast<size_t>(e) * D * F + n0;
      const T* xe = x + static_cast<size_t>(e) * C * D;
      for (int kt = 0; kt < n_k; ++kt) {
        const int k0 = kt * R, rows = min(R, D - k0);
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * L::kStage;
        if (lane == 0)
          mbar_arrive_expect_tx(&full[stage], (rows * cols + C * rows) * sizeof(T));
        __syncwarp();
        for (int r = lane; r < rows; r += 32)
          bulk_g2s(st + r * kSBN * sizeof(T), we + static_cast<size_t>(k0 + r) * F,
                   cols * sizeof(T), &full[stage]);
        for (int c = lane; c < C; c += 32)
          bulk_g2s(st + kStageW + c * R * sizeof(T), xe + static_cast<size_t>(c) * D + k0,
                   rows * sizeof(T), &full[stage]);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  const int col = warp * 32 + (lane % 8) * 4;
  const int g = lane / 8;
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int e = item / n_slab, n0 = (item % n_slab) * kSBN;
    const int cols = min(kSBN, F - n0);
    float acc[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int rows = min(R, D - kt * R);   // a multiple of U
      mbar_wait(&full[stage], phase);
      const T* ws = reinterpret_cast<const T*>(smem + stage * L::kStage);
      const T* xs = reinterpret_cast<const T*>(smem + stage * L::kStage + kStageW);
#pragma unroll
      for (int q = 0; q < R / U / kRowGroups; ++q) {
        const int r0 = (g + q * kRowGroups) * U;
        if (r0 < rows) consume_unit<T, CT, R>(ws, xs, r0, col, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }

#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], 8);
        acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], 16);
      }
    if (g == 0 && col < cols) {
#pragma unroll
      for (int c = 0; c < CT; ++c)
        if (c < C) store4(out + (static_cast<size_t>(e) * C + c) * F + n0 + col, acc[c]);
    }
  }
}

// dw (E, D, F) = x^T @ dy: x (E, C, D) read transposed in place, dy (E, C,
// F), C <= CT <= 16; D and F of 16-byte rows, pointers 16-byte aligned.
template <typename T, int CT>
__global__ void __launch_bounds__(kDwThreads)
gmm_stream_dw(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dw, int C,
              int D, int F) {
  constexpr int VEC = 16 / sizeof(T);          // outputs per 16-byte store
  constexpr int BN = 32 * VEC;                 // a warp's 512-byte run
  __shared__ __align__(16) T xs[CT][kDwBM];
  __shared__ __align__(16) T ds[CT][BN];

  const int e = blockIdx.z, m0 = blockIdx.y * kDwBM, n0 = blockIdx.x * BN;
  const int rows = min(kDwBM, D - m0), cols = min(BN, F - n0);
  const int xc = rows / VEC, dc = cols / VEC;  // 16-byte chunks per row slice
  for (int i = threadIdx.x; i < C * (xc + dc); i += kDwThreads) {
    if (i < C * xc) {
      const int c = i / xc, j = (i % xc) * VEC;
      cp_async16(&xs[c][j], x + (static_cast<size_t>(e) * C + c) * D + m0 + j);
    } else {
      const int c = (i - C * xc) / dc, j = ((i - C * xc) % dc) * VEC;
      cp_async16(&ds[c][j], dy + (static_cast<size_t>(e) * C + c) * F + n0 + j);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, col = (threadIdx.x % 32) * VEC;
  if (col >= cols) return;
  float dv[CT][VEC];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int j = 0; j < VEC; ++j) dv[c][j] = c < C ? to_f32(ds[c][col + j]) : 0.f;

  T* out = dw + (static_cast<size_t>(e) * D + m0) * F + n0 + col;
#pragma unroll 4
  for (int m = warp; m < rows; m += kDwThreads / 32) {
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < C) {
        const float xv = to_f32(xs[c][m]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] += xv * dv[c][j];
      }
    }
    store16_cs(out + static_cast<size_t>(m) * F, o);
  }
}

// Shared memory of the dx kernel: kStages x (w stage, dy stage), then the
// full and empty barriers. A stage holds the slab's rows of w, each one
// kDxChunk-byte segment of F, and dy[e]'s C x chunk slice beside them. A
// warp owns kRK rows: 8 (a 32-row slab, 16 KB of w per stage) up to C = 4,
// 4 (a 16-row slab) above, so that a lane's kRK x CT sums stay at 32
// registers up to C = 8. The ring takes as many stages as fit four blocks
// per SM: 3 at C = 1 and 4, 4 at C = 8, 3 at C = 16 (48-54 KB).
template <typename T, int CT>
struct DxSmem {
  static constexpr int kRK = CT <= 4 ? 8 : 4;
  static constexpr int kRows = kNW * kRK;
  static constexpr int kW = kRows * kDxChunk;
  static constexpr int kStage = kW + CT * kDxChunk;
  static constexpr int kStages = kDxSmem / kStage;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kTotal = kBars + 2 * kStages * 8;
};

// Sums N values per lane over the lanes of a warp (xor masks M, M / 2, ..,
// 1) by halving exchanges: while a lane holds more than one value
// it keeps the half that bit M of its lane selects and sends the other
// half, so N values cost fewer than N shuffles, not N log2(lanes). The
// order is fixed, so every run gives the same bits. With S the halving
// steps taken, v[j] (j < N >> S) returns the sum of the values at index
// p * (N >> S) + j, p the lane's top S bits.
template <int N, int M>
__device__ __forceinline__ void halve_reduce(float* v, int lane) {
  if constexpr (M > 0) {
    if constexpr (N > 1) {
      const bool upper = lane & M;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? v[i] : v[i + N / 2];
        const float keep = upper ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      halve_reduce<N / 2, M / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      halve_reduce<1, M / 2>(v, lane);
    }
  }
}

__host__ __device__ constexpr int log2_c(int n) { return n <= 1 ? 0 : 1 + log2_c(n / 2); }

// NL (1 or 2) adjacent outputs of one row c of dx (NL rows of D) from f32
// sums
template <int NL>
__device__ __forceinline__ void store_run(float* p, const float* v) {
  if constexpr (NL == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else p[0] = v[0];
}

template <int NL>
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float* v) {
  if constexpr (NL == 2) *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
  else p[0] = __float2bfloat16_rn(v[0]);
}

// dx (E, C, D) = dy (E, C, F) @ w^T: w (E, D, F) read in place along its
// contiguous axis F, C <= CT <= 16; D and F of 16-byte rows, pointers
// 16-byte aligned (checked on the host).
//
// The forward transposed: a persistent grid walks work items (expert e,
// slab of kRows rows of D); each item reduces over all of F, chunk by
// chunk through the ring, so no sum crosses blocks. Consumer warp q owns
// rows q * kRK .. + kRK - 1 of the slab and lane i owns 16-byte word i of
// every chunk: per stage a lane reads each of its row words and each of
// the C dy words once, holding its row words in registers while it walks
// dy's, and keeps kRK x CT f32 sums across the item. At the end
// of the item the warp meets its lanes' sums by halving exchanges
// (halve_reduce) and each lane stores NL adjacent rows of one row c of dx.
template <typename T, int CT>
__global__ void __launch_bounds__(kFwdThreads, CT <= 8 ? 4 : 3)
gmm_stream_dx(const T* __restrict__ dy, const T* __restrict__ w, T* __restrict__ dx, int E,
              int C, int D, int F) {
  using L = DxSmem<T, CT>;
  constexpr int RK = L::kRK, SR = L::kRows, STAGES = L::kStages;
  constexpr int V = 16 / sizeof(T);               // values per 16-byte word
  constexpr int FC = kDxChunk / sizeof(T);        // values of F per stage
  constexpr int N = RK * CT;                      // sums per lane: index c * RK + k
  constexpr int STEPS = log2_c(N) < 5 ? log2_c(N) : 5;
  constexpr int NL = N >> STEPS;                  // sums a lane keeps
  static_assert(kDxChunk == 32 * 16, "one 16-byte word per lane and row");
  static_assert(NL <= 2, "store_run writes one or two outputs");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_slab = ceil_div_d(D, SR);
  const int n_items = E * n_slab;
  const int n_k = ceil_div_d(F, FC);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kNW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kNW) {
    // producer: per stage, one copy per row segment of w and per row of dy
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int e = item / n_slab, d0 = (item % n_slab) * SR;
      const int rows = min(SR, D - d0);
      const T* we = w + (static_cast<size_t>(e) * D + d0) * F;
      const T* ye = dy + static_cast<size_t>(e) * C * F;
      for (int kt = 0; kt < n_k; ++kt) {
        const int f0 = kt * FC;
        const uint32_t bytes = min(FC, F - f0) * sizeof(T);
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * L::kStage;
        if (lane == 0) mbar_arrive_expect_tx(&full[stage], (rows + C) * bytes);
        __syncwarp();
        for (int r = lane; r < rows; r += 32)
          bulk_g2s(st + r * kDxChunk, we + static_cast<size_t>(r) * F + f0, bytes, &full[stage]);
        for (int c = lane; c < C; c += 32)
          bulk_g2s(st + L::kW + c * kDxChunk, ye + static_cast<size_t>(c) * F + f0, bytes,
                   &full[stage]);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  const int row0 = warp * RK;
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int e = item / n_slab, d0 = (item % n_slab) * SR;
    const int rows = min(SR, D - d0);
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int words = min(FC, F - kt * FC) / V;   // F's rows are whole words
      mbar_wait(&full[stage], phase);
      const unsigned char* ws = smem + stage * L::kStage + lane * 16;
      const unsigned char* ys = ws + L::kW;
      if (lane < words) {
        // hold the row words, walk the C dy words (rows c >= C are never stored)
        uint4 wv[RK];
#pragma unroll
        for (int k = 0; k < RK; ++k)
          wv[k] = *reinterpret_cast<const uint4*>(ws + (row0 + k) * kDxChunk);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          float yf[V];
          load16(reinterpret_cast<const T*>(ys + c * kDxChunk), yf);
#pragma unroll
          for (int k = 0; k < RK; ++k) {
            float wf[V];
            word_f32(wv[k], wf);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[c * RK + k] += yf[j] * wf[j];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }

    halve_reduce<N, 16>(acc, lane);
    // sums p * NL .. + NL - 1: row c of dx, rows k0 .. k0 + NL - 1 of the
    // warp's; lanes that differ only below the top STEPS bits hold copies
    const int p = lane >> (5 - STEPS);
    const int c = p * NL / RK, k0 = p * NL % RK;
    const bool owner = (lane & ((1 << (5 - STEPS)) - 1)) == 0;
    if (owner && c < C && row0 + k0 < rows)
      store_run<NL>(dx + (static_cast<size_t>(e) * C + c) * D + d0 + row0 + k0, acc);
  }
}

// ---------------------------------------------------------------------------
// tiled kernel (C > 16, ragged rows, misaligned views)
// ---------------------------------------------------------------------------

// out (E, M, N) = A (E, M, K) x B (E, K, N): one 128 x 128 tile of expert
// blockIdx.z per block (tile_gemm.cuh). blockIdx.x walks the row tiles, so
// that the row tiles of one weight column tile run side by side and share
// it in L2. A_T: A[m][k] = a[k * M + m] (dw's x^T), else a[m * K + k]. B_T:
// B[k][n] = b[n * K + k] (dx's w^T), else b[k * N + n]. VEC: every row of a,
// b and out is a whole number of 16-byte words and 16-byte aligned (checked
// on the host), so the tile moves 16-byte words; else element by element.
template <typename T, bool A_T, bool B_T, bool VEC>
__global__ void __launch_bounds__(tile::kThreads, 1)
grouped_matmul_tiled(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int M,
                     int K, int N) {
  constexpr bool AKC = !A_T, BKC = B_T;
  extern __shared__ __align__(128) unsigned char ring[];
  const int e = blockIdx.z, m0 = blockIdx.x * tile::kBM, n0 = blockIdx.y * tile::kBN;
  const T* ae = a + static_cast<size_t>(e) * M * K;
  const T* be = b + static_cast<size_t>(e) * K * N;
  const tile::Pos p(tile::kBN / 32);
  float acc[8][8];
  if constexpr (AKC) {
    const tile::KRows<T> sa{ae, K, m0, M - m0, K};
    if constexpr (BKC) {
      const tile::KRows<T> sb{be, K, n0, N - n0, K};
      tile::gemm<T, T, true, true, VEC, VEC, 32, 16>(ring, sa, sb, K, M - m0, p, acc);
    } else {
      const tile::MNRows<T> sb{be, N, n0, N, K};
      tile::gemm<T, T, true, false, VEC, VEC, 32, 16>(ring, sa, sb, K, M - m0, p, acc);
    }
  } else {
    const tile::MNRows<T> sa{ae, M, m0, M, K};
    const tile::MNRows<T> sb{be, N, n0, N, K};
    tile::gemm<T, T, false, false, VEC, VEC, 32, 16>(ring, sa, sb, K, M - m0, p, acc);
  }

  T* oe = out + static_cast<size_t>(e) * M * N + n0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + p.row<AKC>(i);
    if (m >= M) continue;
    T* orow = oe + static_cast<size_t>(m) * N;
    if constexpr (BKC) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = p.col<true, 32, 16>(j);
        if (n0 + c < N) orow[c] = from_f32<T>(acc[i][j]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = p.col<false, 32, 16>(4 * h);
        const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                            acc[i][4 * h + 3]};
        if (VEC && n0 + c + 3 < N) {
          store4(orow + c, v);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + c + j < N) orow[c + j] = from_f32<T>(v[j]);
        }
      }
    }
  }
}

// the tiled kernel's dynamic shared memory: its ring of stages
template <typename T, bool A_T, bool B_T>
constexpr int tiled_smem() {
  return tile::kStages * tile::Stage<T, T, !A_T, B_T, tile::kBM>::kBytes;
}

template <typename T, bool A_T, bool B_T, bool VEC>
const void* tiled_kernel() {
  static const bool raised = [] {
    cudaFuncSetAttribute(grouped_matmul_tiled<T, A_T, B_T, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, tiled_smem<T, A_T, B_T>());
    return true;
  }();
  (void)raised;
  return reinterpret_cast<const void*>(grouped_matmul_tiled<T, A_T, B_T, VEC>);
}

template <typename T, bool A_T, bool B_T, bool VEC>
void launch_tiled(const void* a, const void* b, void* out, int E, int M, int K, int N,
                  cudaStream_t st) {
  tiled_kernel<T, A_T, B_T, VEC>();
  const dim3 grid(ceil_div(M, tile::kBM), ceil_div(N, tile::kBN), E);
  grouped_matmul_tiled<T, A_T, B_T, VEC><<<grid, tile::kThreads, tiled_smem<T, A_T, B_T>(), st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), M, K, N);
}

// (E, M, K) x (E, K, N) with a, b, out of rows lda, ldb, N elements: the
// 16-byte instance where every row is whole 16-byte words and every pointer
// 16-byte aligned
template <bool A_T, bool B_T>
int dispatch_tiled(const void* a, const void* b, void* out, int E, int M, int K, int N,
                   int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int lda = A_T ? M : K, ldb = B_T ? K : N;
  auto rows16 = [&](int bytes) {
    return (lda * bytes) % 16 == 0 && (ldb * bytes) % 16 == 0 && (N * bytes) % 16 == 0 &&
           aligned16(a) && aligned16(b) && aligned16(out);
  };
  if (dtype == kReproF32) {
    if (rows16(4)) launch_tiled<float, A_T, B_T, true>(a, b, out, E, M, K, N, st);
    else launch_tiled<float, A_T, B_T, false>(a, b, out, E, M, K, N, st);
  } else if (dtype == kReproBF16) {
    if (rows16(2)) launch_tiled<__nv_bfloat16, A_T, B_T, true>(a, b, out, E, M, K, N, st);
    else launch_tiled<__nv_bfloat16, A_T, B_T, false>(a, b, out, E, M, K, N, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whether the streaming kernels take (C, K, N) rows with these pointers:
// the same rule as grouped_ffn.py::variant, checked again here so that a
// bulk copy is never issued on a ragged or misaligned row.
template <typename T>
bool stream_ok(const void* a, const void* b, const void* out, int C, int K, int N) {
  return C >= 1 && C <= kMaxStreamC && (K * sizeof(T)) % 16 == 0 && (N * sizeof(T)) % 16 == 0 &&
         aligned16(a) && aligned16(b) && aligned16(out);
}

// measured once per instantiation
template <typename T, int CT>
int fwd_max_blocks() {
  static const int blocks =
      resident_blocks(gmm_stream_fwd<T, CT>, kFwdThreads, FwdSmem<T, CT>::kTotal);
  return blocks;
}

template <typename T, int CT>
int dx_max_blocks() {
  static const int blocks =
      resident_blocks(gmm_stream_dx<T, CT>, kFwdThreads, DxSmem<T, CT>::kTotal);
  return blocks;
}

template <typename T, int CT>
void launch_stream_fwd(const void* x, const void* w, void* out, int E, int C, int D, int F,
                       cudaStream_t st) {
  const int items = E * ceil_div(F, kSBN);
  const int waves = ceil_div(items, fwd_max_blocks<T, CT>());
  gmm_stream_fwd<T, CT><<<ceil_div(items, waves), kFwdThreads, FwdSmem<T, CT>::kTotal, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), E, C, D, F);
}

// the grid is the resident-block count cut down so that every block gets
// the same number of items, as the forward's
template <typename T, int CT>
void launch_stream_dx(const void* dy, const void* w, void* dx, int E, int C, int D, int F,
                      cudaStream_t st) {
  const int items = E * ceil_div(D, DxSmem<T, CT>::kRows);
  const int waves = ceil_div(items, dx_max_blocks<T, CT>());
  gmm_stream_dx<T, CT><<<ceil_div(items, waves), kFwdThreads, DxSmem<T, CT>::kTotal, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<T*>(dx), E, C, D, F);
}

template <typename T, int CT>
void launch_stream_dw(const void* x, const void* dy, void* dw, int E, int C, int D, int F,
                      cudaStream_t st) {
  const dim3 grid(ceil_div(F, 32 * (16 / static_cast<int>(sizeof(T)))), ceil_div(D, kDwBM), E);
  gmm_stream_dw<T, CT><<<grid, kDwThreads, 0, st>>>(static_cast<const T*>(x),
                                                     static_cast<const T*>(dy), static_cast<T*>(dw),
                                                     C, D, F);
}

enum StreamKind { kStreamFwd = 0, kStreamDx = 1, kStreamDw = 2 };

// C rounded up to the compiled row counts 1, 4, 8, 16
template <typename T, int CT>
void launch_stream(int kind, const void* a, const void* b, void* o, int E, int C, int D, int F,
                   cudaStream_t st) {
  if (kind == kStreamFwd) launch_stream_fwd<T, CT>(a, b, o, E, C, D, F, st);
  else if (kind == kStreamDx) launch_stream_dx<T, CT>(a, b, o, E, C, D, F, st);
  else launch_stream_dw<T, CT>(a, b, o, E, C, D, F, st);
}

template <typename T>
void stream_rows(int kind, const void* a, const void* b, void* o, int E, int C, int D, int F,
                 cudaStream_t st) {
  if (C == 1) launch_stream<T, 1>(kind, a, b, o, E, C, D, F, st);
  else if (C <= 4) launch_stream<T, 4>(kind, a, b, o, E, C, D, F, st);
  else if (C <= 8) launch_stream<T, 8>(kind, a, b, o, E, C, D, F, st);
  else launch_stream<T, 16>(kind, a, b, o, E, C, D, F, st);
}

int dispatch_stream(int kind, const void* a, const void* b, void* out, int E, int C, int D,
                    int F, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kReproF32) {
    if (!stream_ok<float>(a, b, out, C, D, F)) return static_cast<int>(cudaErrorInvalidValue);
    stream_rows<float>(kind, a, b, out, E, C, D, F, st);
  } else if (dtype == kReproBF16) {
    if (!stream_ok<__nv_bfloat16>(a, b, out, C, D, F))
      return static_cast<int>(cudaErrorInvalidValue);
    stream_rows<__nv_bfloat16>(kind, a, b, out, E, C, D, F, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool A_T, bool B_T, bool VEC>
int tiled_info(int* info) {
  return fill_info(tiled_kernel<T, A_T, B_T, VEC>(), tiled_smem<T, A_T, B_T>(), tile::kThreads,
                   info);
}

template <typename T, int CT>
int variant_info(int kind, int* info) {
  switch (kind) {
    case 0:
      fwd_max_blocks<T, CT>();        // raises the kernel's shared-memory limit
      return fill_info(reinterpret_cast<const void*>(gmm_stream_fwd<T, CT>),
                          FwdSmem<T, CT>::kTotal, kFwdThreads, info);
    case 1:
      return fill_info(reinterpret_cast<const void*>(gmm_stream_dw<T, CT>), 0, kDwThreads,
                          info);
    case 2:
      return tiled_info<T, false, false, true>(info);
    case 3:
      return tiled_info<T, false, true, true>(info);
    case 4:
      dx_max_blocks<T, CT>();         // raises the kernel's shared-memory limit
      return fill_info(reinterpret_cast<const void*>(gmm_stream_dx<T, CT>),
                          DxSmem<T, CT>::kTotal, kFwdThreads, info);
    case 5:
      return tiled_info<T, true, false, true>(info);
    case 6:
      return tiled_info<T, false, false, false>(info);
    case 7:
      return tiled_info<T, false, true, false>(info);
    case 8:
      return tiled_info<T, true, false, false>(info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int variant_info_rows(int kind, int C, int* info) {
  if (C == 1) return variant_info<T, 1>(kind, info);
  if (C <= 4) return variant_info<T, 4>(kind, info);
  if (C <= 8) return variant_info<T, 8>(kind, info);
  return variant_info<T, 16>(kind, info);
}

}  // namespace

// out (E, C, F) = x (E, C, D) @ w (E, D, F); tiled kernel, any shape
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* out, int E, int C, int D,
                                    int F, int dtype, void* stream) {
  return dispatch_tiled<false, false>(x, w, out, E, C, D, F, dtype, stream);
}

// the same product on the streaming kernel (C <= 16, 16-byte rows and
// pointers; refuses other inputs with cudaErrorInvalidValue)
extern "C" int repro_grouped_matmul_stream(const void* x, const void* w, void* out, int E, int C,
                                           int D, int F, int dtype, void* stream) {
  return dispatch_stream(kStreamFwd, x, w, out, E, C, D, F, dtype, stream);
}

// dx (E, C, D) = dy (E, C, F) @ w^T, w (E, D, F) read transposed in place
extern "C" int repro_grouped_matmul_dx(const void* dy, const void* w, void* dx, int E, int C,
                                       int D, int F, int dtype, void* stream) {
  return dispatch_tiled<false, true>(dy, w, dx, E, C, F, D, dtype, stream);
}

// the same product on the streaming kernel (same rule as the forward's)
extern "C" int repro_grouped_matmul_dx_stream(const void* dy, const void* w, void* dx, int E,
                                              int C, int D, int F, int dtype, void* stream) {
  return dispatch_stream(kStreamDx, dy, w, dx, E, C, D, F, dtype, stream);
}

// dw (E, D, F) = x^T @ dy, x (E, C, D) read transposed in place, dy (E, C, F)
extern "C" int repro_grouped_matmul_dw(const void* x, const void* dy, void* dw, int E, int C,
                                       int D, int F, int dtype, void* stream) {
  return dispatch_tiled<true, false>(x, dy, dw, E, D, C, F, dtype, stream);
}

// the same product on the streaming kernel (same rule as the forward's)
extern "C" int repro_grouped_matmul_dw_stream(const void* x, const void* dy, void* dw, int E,
                                              int C, int D, int F, int dtype, void* stream) {
  return dispatch_stream(kStreamDw, x, dy, dw, E, C, D, F, dtype, stream);
}

// What the device reports for one kernel instantiation: info = {registers
// per thread, shared memory per block (static + dynamic) in bytes, local
// (spill) bytes per thread, resident blocks per SM}. kind: 0 streaming
// forward, 1 streaming dw, 4 streaming dx (at C rounded up to 1, 4, 8,
// 16), 2 tiled forward and 3 tiled dx (both the C <= 16 tile).
extern "C" int repro_grouped_ffn_variant_info(int kind, int dtype, int C, int* info) {
  if (dtype == kReproF32) return variant_info_rows<float>(kind, C, info);
  if (dtype == kReproBF16) return variant_info_rows<__nv_bfloat16>(kind, C, info);
  return static_cast<int>(cudaErrorInvalidValue);
}
