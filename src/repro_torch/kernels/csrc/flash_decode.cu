// B5 flash decode: attention of one query token per row against a
// contiguous (B, S, KV, hd) cache, positions > index[b] masked; and B6,
// the same over a paged cache: a page arena (n_pages + 1, ps, KV, hd)
// addressed through per-row block tables (B, nb).
//
// B5 replaces repro/kernels/flash_decode.py::_flash_decode_jit / _kernel,
// B6 replaces _flash_decode_paged_jit / _paged_kernel. The TPU kernels walk
// grid (B, KV, S/bs) with the S axis sequential, carrying the online-softmax
// state (m, l, acc) in VMEM scratch across grid steps; B6's DMA prologue
// gathers the pages bt[b, j] (scalar prefetch) and runs B5's body on them.
//
// What bounds them on the H100: bytes. Every live K/V row is read once and
// used for 2 * rep * hd flops (rep = H / KV): 2 * rep flops per byte,
// far below the ~295 at which tensor cores would matter, so at rep 1 all
// math is f32 on the CUDA cores (at rep > 1, below, the tensor cores cut
// instructions, not time at the roofline). One block per (row, kv head)
// walking the whole cache (the earlier kernel) leaves most SMs idle and
// pays one memory latency per position; so here:
//
// - The cache is split over blocks (flash-decoding): grid (KV x head
//   groups, B, n_split) (one head group but at rep > 8, below), split i
//   taking the logical positions [i * per, (i + 1) * per), per a multiple
//   of kTile. The wrapper (kernels/flash_decode.py::split_plan) picks
//   n_split from the capacity (B5: S; B6: nb * ps), B, KV, the head groups
//   and the SM count, never from index, so it reads nothing from the
//   device. A split that starts past index[b] writes an empty partial (m =
//   -1e30, l = 0).
// - Loads are staged: each of a block's four warps copies its 16 positions
//   of every tile (K and V rows) into shared memory, kStages tiles in
//   flight, so it pays one memory latency per tile, not per position. Each
//   lane copies 16-byte chunks of rows with cp.async (8, 4 or 2 bytes for
//   rows or bases not 16-byte aligned), so any page size works. B5's first
//   split issues its first tile before the index arrives (every row within
//   the capacity is readable). B6 loads the table entries of its whole
//   split into shared memory in one round trip; its first tiles, issued in
//   that same round trip, read their pages from row b's table in device
//   memory, and every later row address comes from the slice. A table
//   entry outside [0, n_pages] is clamped into the arena.
// - Latency, not arithmetic, sets the time at the serving shapes, so each
//   warp runs its own online softmax over its rows and no block-wide
//   barrier stands inside the position loop: two lanes dot one K row with q
//   (each half of the 16-byte chunks, q broadcast from shared memory), one
//   butterfly gives the warp's max per tile, the rescale runs once per tile,
//   and for P.V each lane owns a 16-byte slice of head dims over a subset of
//   the warp's rows, taking p by shuffle. The warps' states meet once, at
//   the end, in warp order.
// - Merge: with n_split > 1 each split writes (m, l, acc) to an f32
//   workspace (torch.empty in the wrapper), then counts itself in at its
//   (row, kv head)'s arrival counter (release/acquire at GPU scope); the
//   last to arrive merges all partials in split order, not arrival order,
//   in the same launch, so the result is bitwise the same on every run. The
//   counters are a __device__ array, zero when the library loads; the
//   merging block resets its counter to zero, so every launch, and every
//   CUDA-graph replay, starts from zero. (Zeroing a counter per call instead,
//   a memset before each launch that splits, cost 2 us per call at zcode's
//   full cache on the card.) Two launches that split must therefore not run
//   at once: the wrapper orders an eager one after the last, whatever its
//   stream. With n_split == 1 (a cache of at most 192 positions: every
//   serving shape) there is no workspace and no merge. (A thread-block cluster per (row, kv
//   head), merging through distributed shared memory, ran slower on the
//   card: clusters of 8 blocks did not all fit at once.)
//
// Grouped-query heads (rep = H / KV > 1: yi-6b, llama-3.2-vision,
// dbrx-132b and hymba at rep 8, 8, 6 and 5; starcoder2-3b's 12) take bodies
// of their own. The
// one above dots a K row with all rep heads in turn, q re-read from shared
// memory each time, then runs a softmax and P.V head by head: at rep 8, hd
// 128 a serial chain of ~600 FMAs and ~60 shuffles a lane per tile, 1.6x
// SDPA at 34 positions and 3.4x at yi-6b's 3,586. At rep > 1:
// - flash_decode_mma_kernel (a bf16 cache, hd a multiple of 16: every
//   grouped-query site of the main path): four warps of 16 positions a
//   tile; scores and P.V as bf16 mma.sync with f32 accumulation, K and V
//   read from the staged rows by ldmatrix, so each K/V row staged once
//   serves all rep heads, and per tile a warp issues 40-56 mma where the
//   lane chain above ran ~1,300 instructions. An f32 operand (q of an f32
//   query, p) goes in as three bf16 parts, so every product is exact and
//   the f32 gate holds (plain TF32 would not).
// - flash_decode_gqa_kernel (f32 caches, other head dims): eight warps of
//   8 positions a tile; a warp's lanes are 8 heads x 4 parts, lane (r,
//   part) holding head r's q at the chunks part, part + 4, ... in
//   registers; the scores go through shared memory to a rolled P.V loop.
// A grouped-query block takes one head group: up to kMaxRep = 8 query heads
// of its kv head, so grid x is (kv head, head group) and rep > 8 takes
// ceil(rep / 8) blocks per (row, kv head, split), each reading the kv
// head's cache (rep 12: two reads where one would do; the blocks of a kv
// head run side by side and the second read mostly hits L2). The split
// plan, the merge's partials and its arrival counters go by (row, kv head,
// head group).
// Both end in gqa_finish: the warps meet in warp order; a split's partial
// is written, and the merging block takes every split's partial in split
// order with a running max, 16 splits' loads in flight at once. That block
// reads every partial at one SM's share of the card's bandwidth (rep 8, hd
// 128: 4,160 bytes a split), which is what keeps a long cache's time above
// its byte bound.
//
// B5 and B6 run one device body over the same splits, tiles and reduction
// order; only the row address differs (logical position j of row b lives
// at arena row bt[b, j / ps] * ps + j % ps). So B6 equals B5 bitwise on
// the contiguous cache its tables address.

#include <cstring>

#include "stream.cuh"


namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // positions per staged tile (flash_decode.TILE)
constexpr int kWarpRows = kTile / kWarps;  // a warp's positions of each tile
constexpr int kStages = 3;                 // tiles in flight per warp
constexpr int kMaxRep = 8;                 // query heads of a grouped-query block (a head group)
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGroups = 1 << 16;        // (row, kv head, head group) of a launch that splits
constexpr int kMergeBatch = 8;             // splits whose partials one merge load batch holds
constexpr int kDefaultSmem = 48 * 1024;    // dynamic shared memory a launch may take unasked
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarpRows * 2 == 32, "two lanes per position of a warp's rows");

// arrivals of the splits of each (row, kv head, head group); see the header
__device__ int g_arrivals[kMaxGroups];

// Head groups per kv head: at rep > 1 a block takes the query heads [hg *
// kMaxRep, min(rep, (hg + 1) * kMaxRep)) of its kv head, hg its head group
__host__ __device__ __forceinline__ int head_groups(int rep) {
  return (rep + kMaxRep - 1) / kMaxRep;
}

// Layout of a block's shared memory and copies, from the host.
struct Geometry {
  int row_bytes;    // hd * sizeof(TKV)
  int chunks;       // 16-byte chunks per staged row (<= 32; the last zero-padded)
  int hdp;          // head dims of the padded row: chunks * 16 / sizeof(TKV)
  int pstride;      // bytes between staged rows: chunks * 16 + 16 (the 16 shift banks)
  int stage_bytes;  // one tile: kTile K rows, then kTile V rows
  int copy;         // bytes per cp.async: 16, 8, 4 or 2
  int table;        // B6: table entries of one split
  int smem;         // dynamic shared memory per block (128 of them for alignment)
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* index;  // int32, or int64 with index64
  int index64;
  const int32_t* bt;  // B6 only
  void* out;
  float* ws;          // n_split > 1 only
  int S;              // capacity in positions (B6: nb * ps)
  int KV, rep, hd;
  int nb, ps, n_arena;  // B6 only
  int n_split, per;
  float scale;
  Geometry geo;
  int* check;         // REPRO_SMEM_CHECK builds: the address check's record
};

// values of T in one 16-byte chunk of a staged row
template <typename T>
constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));

template <int W>
__device__ __forceinline__ void copy_async(unsigned char* dst, const unsigned char* src) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else if constexpr (W == 8 || W == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(W)
                 : "memory");
  } else {  // rows of an odd number of bf16 values: a plain 2-byte load
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ int arrive_acq_rel(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// ---------------------------------------------------------------------------
// The address check, off unless built with -DREPRO_SMEM_CHECK (which
// kernels/build.py adds where the environment sets REPRO_SMEM_CHECK=1).
// Every access of a body to its dynamic shared memory (a staged row's
// copy, read or zeroing, an ldmatrix row, q, B6's table slice, the warps'
// outputs) is held to [stages, smem + geo.smem): the launch's dynamic
// shared memory past its 128-byte alignment. Every K/V row copy is held to
// the cache's extent (B6: the arena's), every table entry read to the
// tables'. The first access outside writes a record to mapped host memory
// (repro_flash_decode_check_record reads it, also after the fault has
// cost the context) and the kernel traps. In a default build the checks
// compile to nothing.
// ---------------------------------------------------------------------------

#ifdef REPRO_SMEM_CHECK
constexpr bool kAddressCheck = true;
#else
constexpr bool kAddressCheck = false;
#endif

// the access a record names (flash_decode.CHECK_SITES, in this order)
enum CheckSite : int {
  kSiteCopyToShared = 1,  // a cp.async's destination
  kSiteCopyFromCache,     // a cp.async's K or V source
  kSitePadding,           // the zeroed padding of a staged row
  kSiteZeroV,             // the tensor-core body's zeroed V rows
  kSiteLdmatrixK,         // an ldmatrix row of K
  kSiteLdmatrixV,         // an ldmatrix row of V (transposed)
  kSiteStagedK,           // a CUDA-core body's read of a staged K row
  kSiteStagedV,           // a CUDA-core body's read of a staged V row
  kSiteQuery,             // q in shared memory (rep 1)
  kSiteTableSlice,        // B6's table entries in shared memory
  kSiteTableRead,         // B6's table entries in device memory
  kSiteWarpOutputs,       // the warps' outputs over the stages
};

// a record: found, site, block x, y, z, thread, offset (low, high 32
// bits), bytes, extent (low, high)
constexpr int kCheckWords = 11;

__device__ int g_check_claimed;          // the first thread to fault writes the record
__device__ volatile int g_check_written;  // ... and sets this once it is out

// Writes the record (the first faulting thread) and traps; every other
// faulting thread waits for the record first, since a trap ends the grid
// before stores still on their way to host memory land.
__device__ __noinline__ void address_fault(int* record, int site, long long offset, int bytes,
                                           long long extent) {
  if (atomicCAS(&g_check_claimed, 0, 1) != 0) {
    while (g_check_written == 0) {
    }
  } else if (record != nullptr) {
    volatile int* r = record;
    r[1] = site;
    r[2] = blockIdx.x;
    r[3] = blockIdx.y;
    r[4] = blockIdx.z;
    r[5] = threadIdx.x;
    r[6] = static_cast<int>(offset & 0xffffffffLL);
    r[7] = static_cast<int>(offset >> 32);
    r[8] = bytes;
    r[9] = static_cast<int>(extent & 0xffffffffLL);
    r[10] = static_cast<int>(extent >> 32);
    __threadfence_system();
    r[0] = 1;
    __threadfence_system();
    g_check_written = 1;
  } else {
    g_check_written = 1;
  }
  __trap();
}

// `bytes` at p lie in the launch's dynamic shared memory past its alignment
__device__ __forceinline__ void check_shared(const Args& a, const void* p, int bytes, int site) {
  if constexpr (kAddressCheck) {
    extern __shared__ __align__(16) unsigned char smem[];
    const long long base = smem_u32(smem);
    const long long lo = base + (-base & 127), hi = base + a.geo.smem;
    const long long x = __isShared(p) ? static_cast<long long>(smem_u32(p)) : -1LL;
    if (x < lo || x + bytes > hi) address_fault(a.check, site, x - lo, bytes, hi - lo);
  }
}

// `bytes` at p lie in [base, base + extent)
__device__ __forceinline__ void check_global(const Args& a, const void* base, long long extent,
                                             const void* p, int bytes, int site) {
  if constexpr (kAddressCheck) {
    const long long off = static_cast<const char*>(p) - static_cast<const char*>(base);
    if (off < 0 || off + bytes > extent) address_fault(a.check, site, off, bytes, extent);
  }
}

// a B6 table entry, in the block's slice or in the tables in device memory
__device__ __forceinline__ void check_table(const Args& a, const int* e) {
  if constexpr (kAddressCheck) {
    if (__isShared(e)) {
      check_shared(a, e, 4, kSiteTableSlice);
    } else {
      check_global(a, a.bt, 4LL * gridDim.y * a.nb, e, 4, kSiteTableRead);
    }
  }
}

// bytes of K (and of V) a launch may read: B5's cache, B6's arena
template <typename TKV, bool kPaged>
__device__ __forceinline__ long long cache_bytes(const Args& a) {
  const long long rows = kPaged ? static_cast<long long>(a.n_arena) * a.ps
                                : static_cast<long long>(gridDim.y) * a.S;
  return rows * a.KV * a.hd * static_cast<long long>(sizeof(TKV));
}

// Element offset of logical position j of row b, kv head g: in the
// contiguous cache, or in the page arena through table entries `tbl` (of
// pages first_page, first_page + 1, ...: the block's slice in shared
// memory, or row b's table in device memory), clamped into the arena.
template <bool kPaged>
__device__ __forceinline__ size_t row_offset(const Args& a, const int* tbl, int first_page,
                                             int b, int j, int g) {
  if constexpr (kPaged) {
    check_table(a, tbl + (j / a.ps - first_page));
    const int page = clamp_index(tbl[j / a.ps - first_page], a.n_arena);
    return ((static_cast<size_t>(page) * a.ps + j % a.ps) * a.KV + g) * a.hd;
  } else {
    return ((static_cast<size_t>(b) * a.S + j) * a.KV + g) * a.hd;
  }
}

// One warp's copies of the K and V rows of positions [j0, j0 + rows) into
// staged rows r0, r0 + 1, ... of stage `buf`, W bytes per copy.
template <typename TKV, bool kPaged, int W>
__device__ __forceinline__ void issue_rows(const Args& a, const int* tbl, int first_page, int b,
                                           int g, int j0, int rows, unsigned char* buf, int r0,
                                           int lane) {
  const int cpr = a.geo.row_bytes / W;
  const int ps = a.geo.pstride;
  const auto* kb = static_cast<const unsigned char*>(a.k);
  const auto* vb = static_cast<const unsigned char*>(a.v);
  // lane takes copies c0, c0 + 32, ... of rows jj0, jj0 + rpp, ...
  const int rpp = cpr <= 32 ? 32 / cpr : 1;
  const int c0 = cpr <= 32 ? lane % cpr : lane;
  const int jj0 = cpr <= 32 ? lane / cpr : 0;
  if (jj0 >= rpp) return;
  for (int jj = jj0; jj < rows; jj += rpp) {
    const size_t row = row_offset<kPaged>(a, tbl, first_page, b, j0 + jj, g) * sizeof(TKV);
    unsigned char* dst = buf + (r0 + jj) * ps;
    for (int c = c0; c < cpr; c += 32) {
      if constexpr (kAddressCheck) {
        for (int kv = 0; kv < 2; ++kv) {
          check_shared(a, dst + kv * kTile * ps + c * W, W, kSiteCopyToShared);
          check_global(a, kv ? vb : kb, cache_bytes<TKV, kPaged>(a), (kv ? vb : kb) + row + c * W,
                       W, kSiteCopyFromCache);
        }
      }
      copy_async<W>(dst + c * W, kb + row + c * W);
      copy_async<W>(dst + kTile * ps + c * W, vb + row + c * W);
    }
  }
}

// Issues a warp's copies of one tile (none for rows == 0) and closes its
// cp.async group.
template <typename TKV, bool kPaged>
__device__ __forceinline__ void issue_warp_tile(const Args& a, const int* tbl, int first_page,
                                                int b, int g, int j0, int rows,
                                                unsigned char* buf, int r0, int lane) {
  if (rows > 0) {
    switch (a.geo.copy) {
      case 16: issue_rows<TKV, kPaged, 16>(a, tbl, first_page, b, g, j0, rows, buf, r0, lane); break;
      case 8: issue_rows<TKV, kPaged, 8>(a, tbl, first_page, b, g, j0, rows, buf, r0, lane); break;
      case 4: issue_rows<TKV, kPaged, 4>(a, tbl, first_page, b, g, j0, rows, buf, r0, lane); break;
      default: issue_rows<TKV, kPaged, 2>(a, tbl, first_page, b, g, j0, rows, buf, r0, lane);
    }
  }
  commit_copies();
}

// Zeroes the padding of every staged row (rows not whole 16-byte chunks),
// so that it reads as zeros; `threads` threads of the block share it.
__device__ __forceinline__ void zero_padding(const Args& a, unsigned char* stages, int threads) {
  const Geometry& geo = a.geo;
  if (geo.row_bytes % 16 == 0) return;
  for (int i = threadIdx.x; i < kStages * 2 * kTile; i += threads) {
    unsigned char* pad = stages + i * geo.pstride + geo.row_bytes;
    for (int t = 0; t < geo.chunks * 16 - geo.row_bytes; t += 2) {
      check_shared(a, pad + t, 2, kSitePadding);
      *reinterpret_cast<uint16_t*>(pad + t) = 0;
    }
  }
}

// One block: kv head g = blockIdx.x, row b = blockIdx.y, split blockIdx.z;
// one query head per kv head, its q in shared memory (rep > 1 takes
// flash_decode_mma_kernel or flash_decode_gqa_kernel).
template <typename TQ, typename TKV, bool kPaged>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const Args a) {
  constexpr int V = kPerChunk<TKV>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_w[kWarps];
  __shared__ float l_w[kWarps];
  __shared__ int merge_s;
  const Geometry& geo = a.geo;
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hd = a.hd, C = geo.chunks;
  const int start = split * a.per;
  const int end = min(start + a.per, a.S);
  const int r0 = warp * kWarpRows;  // the warp's rows of every tile

  unsigned char* stages = smem + (-smem_u32(smem) & 127);  // 128-byte aligned
  float* q_s = reinterpret_cast<float*>(stages + kStages * geo.stage_bytes);  // [hdp]
  int* tbl = reinterpret_cast<int*>(q_s + geo.hdp);                          // B6
  const int first_page = kPaged ? start / a.ps : 0;
  // the warp's rows of tile t below position `limit`
  const auto rows_of = [&](int t, int limit) {
    return max(0, min(kWarpRows, limit - (start + t * kTile + r0)));
  };

  // the warp's copies of tile t below position `limit`
  // B6's page of position j: pages[j / ps - pages_from]
  const auto issue = [&](int t, int limit, const int* pages, int pages_from) {
    issue_warp_tile<TKV, kPaged>(a, pages, pages_from, b, g, start + t * kTile + r0,
                                 rows_of(t, limit), stages + (t % kStages) * geo.stage_bytes,
                                 r0, lane);
  };

  // the index, q and B6's table slice are requested together, and each warp
  // issues its first tiles as soon as the index is in (B5's first split
  // before it), B6 reading their pages from row b's table in device memory;
  // later tiles take their pages from the slice in shared memory
  const int last = min(a.index64 ? static_cast<int>(static_cast<const int64_t*>(a.index)[b])
                                 : static_cast<const int32_t*>(a.index)[b],
                       a.S - 1);
  const int live_end = min(end, last + 1);
  const int n_tiles = live_end > start ? (live_end - start + kTile - 1) / kTile : 0;
  const TQ* q = static_cast<const TQ*>(a.q) + (static_cast<size_t>(b) * a.KV + g) * hd;
  const float qv = tid < hd ? to_f32(q[tid]) : 0.f;  // hd <= hdp <= kThreads
  int first = 0;  // tiles issued before the barrier
  if constexpr (kPaged) {
    const int n_pages = (end - 1) / a.ps - first_page + 1;
    for (int i = tid; i < n_pages; i += kThreads) {
      const int32_t* e = a.bt + static_cast<size_t>(b) * a.nb + first_page + i;
      check_table(a, e);
      check_shared(a, tbl + i, 4, kSiteTableSlice);
      tbl[i] = clamp_index(*e, a.n_arena);
    }
  } else if (split == 0) {
    issue(0, end, tbl, 0);  // up to `end`: the index is not in yet
    first = 1;
  }
  const int* row_table = kPaged ? a.bt + static_cast<size_t>(b) * a.nb : tbl;
  for (; first < kStages - 1; ++first) issue(first, live_end, row_table, 0);
  if (tid < geo.hdp) {
    check_shared(a, q_s + tid, 4, kSiteQuery);
    q_s[tid] = qv * a.scale;
  }
  zero_padding(a, stages, kThreads);
  __syncthreads();  // q, the table slice, the padding

  // scores: lanes 2j and 2j + 1 take row j of the warp's rows, chunks
  // [c_lo, c_hi) each; P.V: lane = sub * C + pc takes chunk pc of rows sub,
  // sub + n_sub, ...
  const int sj = lane >> 1, half = lane & 1;
  const int c_lo = half ? (C + 1) / 2 : 0, c_hi = half ? C : (C + 1) / 2;
  const int n_sub = 32 / C, pc = lane % C, sub = lane / C;
  const bool pv_on = sub < n_sub;

  float m_run = kNegInf, l_run = 0.f, acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    wait_copies<kStages - 2>();
    __syncwarp();
    issue(t + kStages - 1, live_end, tbl, first_page);
    const int rows = rows_of(t, live_end);
    if (rows == 0) continue;  // the warp's rows all lie past the index
    const unsigned char* buf = stages + (t % kStages) * geo.stage_bytes;

    float s = 0.f;
    if (sj < rows) {
      const unsigned char* krow = buf + (r0 + sj) * geo.pstride;
#pragma unroll 4
      for (int c = c_lo; c < c_hi; ++c) {
        float kv[V];
        check_shared(a, krow + c * 16, 16, kSiteStagedK);
        load16(reinterpret_cast<const TKV*>(krow + c * 16), kv);
        check_shared(a, q_s + c * V, 4 * V, kSiteQuery);
        const float4* qq = reinterpret_cast<const float4*>(q_s + c * V);
#pragma unroll
        for (int e4 = 0; e4 < V / 4; ++e4) {
          const float4 q4 = qq[e4];
          s = fmaf(q4.x, kv[4 * e4], s);
          s = fmaf(q4.y, kv[4 * e4 + 1], s);
          s = fmaf(q4.z, kv[4 * e4 + 2], s);
          s = fmaf(q4.w, kv[4 * e4 + 3], s);
        }
      }
    }
    s += __shfl_xor_sync(kFull, s, 1);
    float mx = sj < rows ? s : kNegInf;
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    m_run = m_new;
    s = sj < rows ? expf(s - m_new) : 0.f;  // p of row sj
    l_run = l_run * corr + (half ? 0.f : s);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] *= corr;
#pragma unroll 4
    for (int j = 0; j < kWarpRows; j += n_sub) {
      const int jj = j + sub;
      const float p = __shfl_sync(kFull, s, (2 * jj) & 31);
      if (pv_on && jj < rows) {
        const unsigned char* vrow = buf + (kTile + r0 + jj) * geo.pstride + pc * 16;
        check_shared(a, vrow, 16, kSiteStagedV);
        float vv[V];
        load16(reinterpret_cast<const TKV*>(vrow), vv);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
      }
    }
  }
  wait_copies<0>();  // no copy may land after the block moves on

  // the warp's totals: l over its lanes, acc over its subgroups in order
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) l_run += __shfl_xor_sync(kFull, l_run, o);
  {
    float tot[V];
#pragma unroll
    for (int e = 0; e < V; ++e) tot[e] = acc[e];
    for (int sg = 1; sg < n_sub; ++sg) {
#pragma unroll
      for (int e = 0; e < V; ++e) tot[e] += __shfl_sync(kFull, acc[e], sg * C + pc);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = tot[e];
  }
  __syncthreads();  // every warp is done with the stages: the warps meet there
  float* red = reinterpret_cast<float*>(stages);  // [warp][hdp]
  if (lane < C) {
    check_shared(a, red + warp * geo.hdp + lane * V, 4 * V, kSiteWarpOutputs);
#pragma unroll
    for (int e = 0; e < V; ++e) red[warp * geo.hdp + lane * V + e] = acc[e];
  }
  if (lane == 0) {
    m_w[warp] = m_run;
    l_w[warp] = l_run;
  }
  __syncthreads();

  TQ* out = static_cast<TQ*>(a.out) + (static_cast<size_t>(b) * a.KV + g) * hd;
  const int stride = hd + 2;  // a partial: acc [hd], m, l
  float* parts = a.n_split > 1
                     ? a.ws + (static_cast<size_t>(b) * a.KV + g) * a.n_split * stride
                     : nullptr;
  for (int d = tid; d < hd; d += kThreads) {
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_w[w]);
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(m_w[w] - m_all);
      l_all += l_w[w] * wt;
      check_shared(a, red + w * geo.hdp + d, 4, kSiteWarpOutputs);
      o += red[w * geo.hdp + d] * wt;
    }
    if (!parts) {
      out[d] = from_f32<TQ>(l_all > 0.f ? o / l_all : 0.f);
    } else {
      float* part = parts + static_cast<size_t>(split) * stride;
      part[d] = o;
      if (d == 0) {
        part[hd] = l_all > 0.f ? m_all : kNegInf;
        part[hd + 1] = l_all;
      }
    }
  }
  if (!parts) return;

  __syncthreads();  // orders the block's partial before thread 0's release
  if (tid == 0) {
    int* counter = &g_arrivals[b * a.KV + g];
    const bool merges = arrive_acq_rel(counter) == a.n_split - 1;
    if (merges) atomicExch(counter, 0);  // the next launch starts from zero
    merge_s = merges;
  }
  __syncthreads();
  if (!merge_s) return;
  // the last split to arrive merges every split's partial, in split order:
  // w = exp(m - max m) over a batch of kMergeBatch splits (across batches
  // the running max rescales what came before); a split with l = 0 takes
  // no part
  for (int d = tid; d < hd; d += kThreads) {
    float m_all = kNegInf, l_all = 0.f, o = 0.f;
    for (int s0 = 0; s0 < a.n_split; s0 += kMergeBatch) {
      float mb[kMergeBatch], lb[kMergeBatch], ob[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        mb[u] = lb[u] = ob[u] = 0.f;
        if (s0 + u < a.n_split) {
          const float* p = parts + static_cast<size_t>(s0 + u) * stride;
          mb[u] = __ldcg(p + hd);
          lb[u] = __ldcg(p + hd + 1);
          ob[u] = __ldcg(p + d);
        }
      }
      float m_new = m_all;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (lb[u] > 0.f) m_new = fmaxf(m_new, mb[u]);
      }
      const float c_old = expf(m_all - m_new);
      l_all *= c_old;
      o *= c_old;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (lb[u] > 0.f) {
          const float w = expf(mb[u] - m_new);
          l_all += lb[u] * w;
          o += ob[u] * w;
        }
      }
      m_all = m_new;
    }
    out[d] = from_f32<TQ>(l_all > 0.f ? o / l_all : 0.f);
  }
}

// ---------------------------------------------------------------------------
// rep > 1: grouped-query heads (see the header)
// ---------------------------------------------------------------------------

constexpr int kMergeLoads = 16;  // splits whose partials a merging thread loads at once

// The rows of tile t that the warp whose rows of each tile start at r0 (of
// kRowsT) owns, below position `limit`.
//
// Loops over these live rows: none may be unrolled with a count known
// only at run time. NVVM gives such a loop a trip count of its own,
// computed above the tile loop from a second copy of the split's live end,
// min(end, index + 1, S), which its PTX forms as min(min(end, -max(-S,
// ~index)), S); ptxas (CUDA 12.8) fuses that neg and the two mins into one
// three-way VIMNMX3 and drops the negation, so the count runs as many
// extra rows as the index is deep. Seen on the card under the address check
// (REPRO_SMEM_CHECK; tests/test_torch_address_check_cuda.py): the V-row
// zeroing written as one flat loop over rows x chunks (unrolled by 4)
// stored past the warp's 16 rows and past the shared memory; the CUDA-core
// body's position loops under #pragma unroll 2 skipped their unrolled
// pairs and ran once, so only each warp's first row counted. So loops over
// live rows run a fixed count with each row predicated (the zeroing;
// flash_decode_kernel's P.V), or stay rolled (#pragma unroll 1:
// flash_decode_gqa_kernel).
template <int kRowsT>
__device__ __forceinline__ int warp_rows(int start, int t, int r0, int limit) {
  return max(0, min(kRowsT, limit - (start + t * kTile + r0)));
}

// The block of a grouped-query launch: grid x is (kv head, head group),
// the head group fastest (so that the blocks reading one kv head's cache
// run together and share it in L2)
struct HeadGroup {
  int g;         // kv head
  int nh;        // the block's query heads: min(kMaxRep, rep - hg * kMaxRep)
  size_t head0;  // its first query head among q's B * KV * rep
};

__device__ __forceinline__ HeadGroup head_group(const Args& a) {
  const int n_hg = head_groups(a.rep);
  const int g = blockIdx.x / n_hg, hg = blockIdx.x % n_hg;
  return {g, min(kMaxRep, a.rep - hg * kMaxRep),
          (static_cast<size_t>(blockIdx.y) * a.KV + g) * a.rep + hg * kMaxRep};
}

// The start of a grouped-query block of kv head g, as
// flash_decode_kernel's: B6's table slice and the first kStages - 1 tiles
// of each warp issued (B5's first split its first tile before the index is
// in, reading every row up to `end`), the padding of staged rows zeroed.
// Returns the end of the live positions of the split.
template <typename TKV, bool kPaged, int kRowsT, int kThreadsT>
__device__ __forceinline__ int gqa_prologue(const Args& a, int g, unsigned char* stages, int* tbl,
                                            int start, int end, int r0) {
  const Geometry& geo = a.geo;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32;
  const int first_page = kPaged ? start / a.ps : 0;
  const auto issue = [&](int t, int limit, const int* pages) {
    issue_warp_tile<TKV, kPaged>(a, pages, first_page, b, g, start + t * kTile + r0,
                                 warp_rows<kRowsT>(start, t, r0, limit),
                                 stages + (t % kStages) * geo.stage_bytes, r0, lane);
  };
  const int last = min(a.index64 ? static_cast<int>(static_cast<const int64_t*>(a.index)[b])
                                 : static_cast<const int32_t*>(a.index)[b],
                       a.S - 1);
  const int live_end = min(end, last + 1);
  int first = 0;
  if constexpr (kPaged) {
    const int n_pages = (end - 1) / a.ps - first_page + 1;
    for (int i = tid; i < n_pages; i += kThreadsT) {
      const int32_t* e = a.bt + static_cast<size_t>(b) * a.nb + first_page + i;
      check_table(a, e);
      check_shared(a, tbl + i, 4, kSiteTableSlice);
      tbl[i] = clamp_index(*e, a.n_arena);
    }
  } else if (blockIdx.z == 0) {
    issue(0, end, tbl);  // up to `end`: the index is not in yet
    first = 1;
  }
  // B6's first tiles read their pages from row b's table in device memory
  const int* row_table = kPaged ? a.bt + static_cast<size_t>(b) * a.nb + first_page : tbl;
  for (; first < kStages - 1; ++first) issue(first, live_end, row_table);
  zero_padding(a, stages, kThreadsT);
  __syncthreads();  // the table slice, the padding
  return live_end;
}

// Floats between two splits' partials of a grouped-query launch (acc
// [nh][hd], m [nh], l [nh] of the block's nh <= min(rep, kMaxRep) heads), a
// whole number of 16-byte words
__host__ __device__ __forceinline__ int gqa_stride(int rep, int hd) {
  return ((rep < kMaxRep ? rep : kMaxRep) * (hd + 2) + 3) / 4 * 4;
}

// The end of a grouped-query block (its head group hgp): its warps' states
// (red [warp][nh][hdp] unnormalised outputs, m_w and l_w per warp and head)
// meet in warp order, each head's warp weights exp(m_w - max) taken once;
// then the output, or with n_split > 1 the block's partial, its arrival
// and, in the last block of the (row, kv head, head group) to arrive, the
// merge. Thread (h, d0) takes head h's
// kOut dims from d0 * kOut; the merge runs over the splits in split order,
// kMergeLoads at a time with all their loads (m, l and the thread's
// outputs, as 16-byte words where kVec: hd a multiple of 16) in flight at
// once, the running max rescaling what came before. (One block reads every
// partial, at one SM's share of the card's bandwidth: at rep 8, hd 128 a
// partial is 4,160 bytes.)
template <typename TQ, int kThreadsT, bool kVec>
__device__ __forceinline__ void gqa_finish(const Args& a, const HeadGroup& hgp, const float* red,
                                           const float (*m_w)[kMaxRep],
                                           const float (*l_w)[kMaxRep]) {
  constexpr int kWarpsT = kThreadsT / 32;
  constexpr int kLanes = kThreadsT / kMaxRep;   // threads per head
  constexpr int kOut = kMaxHeadDim / kLanes;    // dims a thread takes
  static_assert(kOut % 4 == 0, "whole 16-byte words of a partial");
  __shared__ float wt_s[kWarpsT][kMaxRep];      // the warps' weights exp(m_w - m_all)
  __shared__ float m_s[kMaxRep];
  __shared__ float l_s[kMaxRep];
  __shared__ int merge_s;
  const int split = blockIdx.z, tid = threadIdx.x;
  const int rep = hgp.nh, hd = a.hd, hdp = a.geo.hdp, n_split = a.n_split;
  const int h = tid / kLanes, d0 = (tid % kLanes) * kOut;
  TQ* out = static_cast<TQ*>(a.out) + hgp.head0 * hd;
  const int stride = gqa_stride(a.rep, hd);
  // the partials and the arrival counter of (row, kv head, head group)
  const size_t group = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  float* parts = n_split > 1 ? a.ws + group * n_split * stride : nullptr;
  if (tid < rep) {
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarpsT; ++w) m_all = fmaxf(m_all, m_w[w][tid]);
    float l_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsT; ++w) {
      const float wt = expf(m_w[w][tid] - m_all);
      wt_s[w][tid] = wt;
      l_all += l_w[w][tid] * wt;
    }
    m_s[tid] = m_all;
    l_s[tid] = l_all;
  }
  __syncthreads();
  if (h < rep && d0 < hd) {
    // the thread's kOut dims of every warp as 16-byte words (hdp is whole
    // words; a thread reading kOut scalars a word apart from its neighbour's
    // hit one bank 8 ways)
    float o[kOut];
#pragma unroll
    for (int u = 0; u < kOut; ++u) o[u] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsT; ++w) {
      const float wt = wt_s[w][h];
      const float4* r4 = reinterpret_cast<const float4*>(red + (w * rep + h) * hdp + d0);
      check_shared(a, r4, 4 * kOut, kSiteWarpOutputs);
#pragma unroll
      for (int u = 0; u < kOut / 4; ++u) {
        const float4 x = r4[u];
        o[4 * u] += x.x * wt;
        o[4 * u + 1] += x.y * wt;
        o[4 * u + 2] += x.z * wt;
        o[4 * u + 3] += x.w * wt;
      }
    }
    float* part = parts ? parts + static_cast<size_t>(split) * stride + h * hd + d0 : nullptr;
    if (part && kVec) {  // d0 + kOut <= hd
#pragma unroll
      for (int u = 0; u < kOut / 4; ++u) {
        reinterpret_cast<float4*>(part)[u] = make_float4(o[4 * u], o[4 * u + 1], o[4 * u + 2],
                                                         o[4 * u + 3]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        if (d0 + u >= hd) break;
        if (part) {
          part[u] = o[u];
        } else {
          out[h * hd + d0 + u] = from_f32<TQ>(l_s[h] > 0.f ? o[u] / l_s[h] : 0.f);
        }
      }
    }
    if (part && d0 == 0) {
      float* ml = parts + static_cast<size_t>(split) * stride + rep * hd;
      ml[h] = l_s[h] > 0.f ? m_s[h] : kNegInf;
      ml[rep + h] = l_s[h];
    }
  }
  if (!parts) return;

  __syncthreads();  // orders the block's partial before thread 0's release
  if (tid == 0) {
    int* counter = &g_arrivals[group];
    const bool merges = arrive_acq_rel(counter) == n_split - 1;
    if (merges) atomicExch(counter, 0);  // the next launch starts from zero
    merge_s = merges;
  }
  __syncthreads();
  if (!merge_s || h >= rep) return;
  float m_run = kNegInf, l_run = 0.f, o[kOut];
#pragma unroll
  for (int u = 0; u < kOut; ++u) o[u] = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += kMergeLoads) {
    float mb[kMergeLoads], lb[kMergeLoads], ob[kMergeLoads][kOut];
#pragma unroll
    for (int k = 0; k < kMergeLoads; ++k) {
      const bool on = s0 + k < n_split;
      const float* p = parts + static_cast<size_t>(on ? s0 + k : 0) * stride;
      mb[k] = on ? __ldcg(p + rep * hd + h) : kNegInf;
      lb[k] = on ? __ldcg(p + rep * hd + rep + h) : 0.f;
      if constexpr (kVec) {  // d0 + kOut <= hd
        const float4* p4 = reinterpret_cast<const float4*>(p + h * hd + d0);
#pragma unroll
        for (int u = 0; u < kOut / 4; ++u) {
          const float4 w4 = on && d0 < hd ? __ldcg(p4 + u) : make_float4(0.f, 0.f, 0.f, 0.f);
          ob[k][4 * u] = w4.x;
          ob[k][4 * u + 1] = w4.y;
          ob[k][4 * u + 2] = w4.z;
          ob[k][4 * u + 3] = w4.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kOut; ++u) {
          ob[k][u] = on && d0 + u < hd ? __ldcg(p + h * hd + d0 + u) : 0.f;
        }
      }
    }
    float m_new = m_run;
#pragma unroll
    for (int k = 0; k < kMergeLoads; ++k) m_new = lb[k] > 0.f ? fmaxf(m_new, mb[k]) : m_new;
    const float c = expf(m_run - m_new);
    l_run *= c;
#pragma unroll
    for (int u = 0; u < kOut; ++u) o[u] *= c;
#pragma unroll
    for (int k = 0; k < kMergeLoads; ++k) {
      // a split with no live position (l = 0, its outputs 0) takes weight
      // 0; a select, not a branch, so that no load waits behind one
      const float w = lb[k] > 0.f ? expf(mb[k] - m_new) : 0.f;
      l_run += lb[k] * w;
#pragma unroll
      for (int u = 0; u < kOut; ++u) o[u] += ob[k][u] * w;
    }
    m_run = m_new;
  }
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    if (d0 + u < hd) out[h * hd + d0 + u] = from_f32<TQ>(l_run > 0.f ? o[u] / l_run : 0.f);
  }
}

// ---- on the CUDA cores: f32 caches, and head dims not a multiple of 16 ----

constexpr int kGqaThreads = 256;
constexpr int kGqaWarps = kGqaThreads / 32;
constexpr int kGqaRows = kTile / kGqaWarps;   // a warp's positions of each tile
constexpr int kParts = 32 / kMaxRep;          // lanes per query head
static_assert(kParts == 4, "a warp is 8 heads x 4 parts");

// a lane's 16-byte chunks of a row of kMaxHeadDim values
template <typename TKV>
constexpr int kLaneChunks = kMaxHeadDim * static_cast<int>(sizeof(TKV)) / 16 / kParts;

// One block: a head group of kv head g (blockIdx.x, head_group), row b =
// blockIdx.y, split blockIdx.z.
template <typename TQ, typename TKV, bool kPaged>
__global__ void __launch_bounds__(kGqaThreads, 1) flash_decode_gqa_kernel(const Args a) {
  constexpr int V = kPerChunk<TKV>;
  constexpr int NC = kLaneChunks<TKV>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_w[kGqaWarps][kMaxRep];
  __shared__ float l_w[kGqaWarps][kMaxRep];
  __shared__ float sc[kGqaWarps][kGqaRows][kMaxRep];  // a tile's scores, per warp
  const Geometry& geo = a.geo;
  const HeadGroup hgp = head_group(a);
  const int g = hgp.g, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rep = hgp.nh, hd = a.hd, C = geo.chunks;
  const int r = lane / kParts, part = lane % kParts;  // the lane's head and chunks part + 4i
  const int start = split * a.per;
  const int end = min(start + a.per, a.S);
  const int r0 = warp * kGqaRows;  // the warp's rows of every tile

  unsigned char* stages = smem + (-smem_u32(smem) & 127);  // 128-byte aligned
  int* tbl = reinterpret_cast<int*>(stages + kStages * geo.stage_bytes);  // B6
  const int first_page = kPaged ? start / a.ps : 0;
  const TQ* q = static_cast<const TQ*>(a.q) + hgp.head0 * hd;
  float qr[NC][V];  // head r's q (scaled) at the lane's chunks; zero past hd and rep
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int d = (part + i * kParts) * V + e;
      qr[i][e] = r < rep && d < hd ? to_f32(q[r * hd + d]) * a.scale : 0.f;
    }
  }
  const int live_end =
      gqa_prologue<TKV, kPaged, kGqaRows, kGqaThreads>(a, g, stages, tbl, start, end, r0);
  const int n_tiles = live_end > start ? (live_end - start + kTile - 1) / kTile : 0;

  float m_run = kNegInf, l_run = 0.f, acc[NC][V];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    wait_copies<kStages - 2>();
    __syncwarp();
    const int tn = t + kStages - 1;
    issue_warp_tile<TKV, kPaged>(a, tbl, first_page, b, g, start + tn * kTile + r0,
                                 warp_rows<kGqaRows>(start, tn, r0, live_end),
                                 stages + (tn % kStages) * geo.stage_bytes, r0, lane);
    const int rows = warp_rows<kGqaRows>(start, t, r0, live_end);
    if (rows == 0) continue;  // the warp's rows all lie past the index
    const unsigned char* buf = stages + (t % kStages) * geo.stage_bytes;

    // scores of head r at the warp's rows (a partial sum per chunk, then
    // the quad's), kept in sc, and their max. Both position loops stay
    // rolled (see warp_rows)
    float mx = kNegInf;
#pragma unroll 1
    for (int j = 0; j < rows; ++j) {
      const unsigned char* krow = buf + (r0 + j) * geo.pstride;
      float sp[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = part + i * kParts;
        sp[i] = 0.f;
        if (c < C) {
          float kv[V];
          check_shared(a, krow + c * 16, 16, kSiteStagedK);
          load16(reinterpret_cast<const TKV*>(krow + c * 16), kv);
#pragma unroll
          for (int e = 0; e < V; ++e) sp[i] = fmaf(qr[i][e], kv[e], sp[i]);
        }
      }
      float sj = sp[0];
#pragma unroll
      for (int i = 1; i < NC; ++i) sj += sp[i];
      sj += __shfl_xor_sync(kFull, sj, 1);
      sj += __shfl_xor_sync(kFull, sj, 2);
      if (part == 0) sc[warp][j][r] = sj;
      mx = fmaxf(mx, sj);
    }
    __syncwarp();
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] *= corr;
    }
    float psum = 0.f;
#pragma unroll 1
    for (int j = 0; j < rows; ++j) {
      const float p = expf(sc[warp][j][r] - m_new);
      psum += p;
      const unsigned char* vrow = buf + (kTile + r0 + j) * geo.pstride;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = part + i * kParts;
        if (c < C) {
          float vv[V];
          check_shared(a, vrow + c * 16, 16, kSiteStagedV);
          load16(reinterpret_cast<const TKV*>(vrow + c * 16), vv);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
    l_run = l_run * corr + psum;
    __syncwarp();  // sc is written again at the next tile
  }
  wait_copies<0>();  // no copy may land after the block moves on

  __syncthreads();  // every warp is done with the stages: the warps meet there
  float* red = reinterpret_cast<float*>(stages);  // [warp][rep][hdp]
  if (r < rep) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = part + i * kParts;
      if (c < C) {
        check_shared(a, red + (warp * rep + r) * geo.hdp + c * V, 4 * V, kSiteWarpOutputs);
#pragma unroll
        for (int e = 0; e < V; ++e) red[(warp * rep + r) * geo.hdp + c * V + e] = acc[i][e];
      }
    }
    if (part == 0) {
      m_w[warp][r] = m_run;
      l_w[warp][r] = l_run;
    }
  }
  __syncthreads();
  gqa_finish<TQ, kGqaThreads, false>(a, hgp, red, m_w, l_w);
}

// ---- on the tensor cores: bf16 caches, head dims a multiple of 16 ----
//
// Per warp and tile, 16 positions. Scores S = q K^T as mma m16n8k16 (rows:
// the 8 heads, padded to 16; columns: two blocks of 8 positions; k: 16 head
// dims), O^T = V^T P^T as m16n8k16 (rows: 16 head dims; columns: the 8
// heads; k: the 16 positions), both bf16 in, f32 accumulated. The cache is
// bf16 already; an f32 operand (q of an f32 query, p) goes in as three
// bf16 parts (8 bits of mantissa each: 24 together, f32's), so every
// product is exact in f32 and only the sums' order differs from the CUDA
// cores'. K and V come from shared memory by ldmatrix (V transposed),
// rows padded by 16 bytes: no bank conflict. The scores' C fragment of
// head g, positions 2t, 2t + 1 (+ 8) is P^T's B fragment as it stands.

constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaRows = kTile / kMmaWarps;    // a warp's positions of each tile: the k of P.V
constexpr int kSplitParts = 3;                 // bf16 parts of an f32 operand
constexpr int kMaxKSteps = kMaxHeadDim / 16;   // 16-dim steps of a head
static_assert(kMmaRows == 16, "P.V takes 16 positions a step");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x (two f32) as NP pairs of bf16 (the lower element in the low half): x =
// sum of the parts, to f32's precision at NP = 3
template <int NP>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&out)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    out[p] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// One block: a head group of kv head g (blockIdx.x, head_group), row b =
// blockIdx.y, split blockIdx.z; a bf16 cache. Lane (g8, t4) = (lane / 4,
// lane % 4) of the mma fragments.
template <typename TQ, bool kPaged>
__global__ void __launch_bounds__(kMmaThreads) flash_decode_mma_kernel(const Args a) {
  using TKV = __nv_bfloat16;
  constexpr int NQ = sizeof(TQ) == 2 ? 1 : kSplitParts;  // a bf16 query is one part
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_w[kMmaWarps][kMaxRep];
  __shared__ float l_w[kMmaWarps][kMaxRep];
  const Geometry& geo = a.geo;
  const HeadGroup hgp = head_group(a);
  const int g = hgp.g, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int rep = hgp.nh, hd = a.hd, n_steps = hd / 16;
  const int start = split * a.per;
  const int end = min(start + a.per, a.S);
  const int r0 = warp * kMmaRows;

  unsigned char* stages = smem + (-smem_u32(smem) & 127);  // 128-byte aligned
  int* tbl = reinterpret_cast<int*>(stages + kStages * geo.stage_bytes);  // B6
  const int first_page = kPaged ? start / a.ps : 0;
  // q of head g8 as the A fragments of S (a0: dims 16 ks + 2 t4, + 1; a2:
  // the same + 8; a1, a3, heads 8-15: zero), unscaled (the scale multiplies
  // the scores, as in the plain version), in NQ bf16 parts
  // (loaded before the prologue and split after it, so that q's round
  // trip overlaps the index's and the first tiles')
  const TQ* q = static_cast<const TQ*>(a.q) + hgp.head0 * hd;
  float qx[kMaxKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = ks * 16 + (e / 2) * 8 + 2 * t4 + e % 2;
      qx[ks][e] = g8 < rep && ks < n_steps ? to_f32(q[g8 * hd + d]) : 0.f;
    }
  }
  const int live_end =
      gqa_prologue<TKV, kPaged, kMmaRows, kMmaThreads>(a, g, stages, tbl, start, end, r0);
  uint32_t qa[kMaxKSteps][2][NQ];
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks) {
    split_pair<NQ>(qx[ks][0], qx[ks][1], qa[ks][0]);
    split_pair<NQ>(qx[ks][2], qx[ks][3], qa[ks][1]);
  }
  const int n_tiles = live_end > start ? (live_end - start + kTile - 1) / kTile : 0;
  // this lane's row address in an ldmatrix.x4: matrix lane / 8, its row lane % 8
  const int mrow = (lane >> 4) * 8 + (lane & 7), mcol = ((lane >> 3) & 1) * 16;

  float m_run = kNegInf, l_run = 0.f;  // head g8's
  float co[kMaxKSteps][4];  // O^T: dims 16 mb + g8 (+ 8), heads 2 t4, 2 t4 + 1
#pragma unroll
  for (int mb = 0; mb < kMaxKSteps; ++mb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) co[mb][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    wait_copies<kStages - 2>();
    __syncwarp();
    const int tn = t + kStages - 1;
    issue_warp_tile<TKV, kPaged>(a, tbl, first_page, b, g, start + tn * kTile + r0,
                                 warp_rows<kMmaRows>(start, tn, r0, live_end),
                                 stages + (tn % kStages) * geo.stage_bytes, r0, lane);
    const int rows = warp_rows<kMmaRows>(start, t, r0, live_end);
    if (rows == 0) continue;  // the warp's rows all lie past the index
    const unsigned char* kbase = stages + (t % kStages) * geo.stage_bytes + r0 * geo.pstride;
    unsigned char* vbase = stages + (t % kStages) * geo.stage_bytes +
                           (kTile + r0) * geo.pstride;
    if (rows < kMmaRows) {
      // V rows past the live ones hold stale or unwritten bytes, and 0 x NaN
      // is NaN in the product: zero them (their p is 0, K rows' scores are
      // masked instead), lane c its chunk c (chunks <= 16) of each: a loop
      // of a fixed count, each row predicated (see warp_rows)
      if (lane < geo.chunks) {
#pragma unroll
        for (int r = 0; r < kMmaRows; ++r) {
          if (r >= rows) {
            check_shared(a, vbase + r * geo.pstride + lane * 16, 16, kSiteZeroV);
            *reinterpret_cast<uint4*>(vbase + r * geo.pstride + lane * 16) =
                make_uint4(0, 0, 0, 0);
          }
        }
      }
      __syncwarp();
    }

    // scores of head g8 at positions 2 t4, 2 t4 + 1 (block 0) and + 8 (block
    // 1). The A rows 8-15 (no head) carry q's second part where it has one:
    // its scores land in c2, c3 beside the first part's. Two accumulators a
    // block (the steps' parity) so that no mma waits on the one before it
    float cs[2][2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cs[c][0][e] = cs[c][1][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kMaxKSteps; ++ks) {
      if (ks < n_steps) {
        uint32_t kb[4];  // B fragments: block 0's dims 16 ks + (0, 8), then block 1's
        check_shared(a, kbase + mrow * geo.pstride + ks * 32 + mcol, 16, kSiteLdmatrixK);
        ldmatrix_x4(kb, kbase + mrow * geo.pstride + ks * 32 + mcol);
        const uint32_t a1 = NQ > 1 ? qa[ks][0][1] : 0u, a3 = NQ > 1 ? qa[ks][1][1] : 0u;
        mma_bf16(cs[ks % 2][0], qa[ks][0][0], a1, qa[ks][1][0], a3, kb[0], kb[1]);
        mma_bf16(cs[ks % 2][1], qa[ks][0][0], a1, qa[ks][1][0], a3, kb[2], kb[3]);
        if (NQ > 2) {
          mma_bf16(cs[ks % 2][0], qa[ks][0][2], 0u, qa[ks][1][2], 0u, kb[0], kb[1]);
          mma_bf16(cs[ks % 2][1], qa[ks][0][2], 0u, qa[ks][1][2], 0u, kb[2], kb[3]);
        }
      }
    }
    float sv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int nb = e / 2, i = e % 2;
      sv[e] = (cs[0][nb][i] + cs[0][nb][i + 2]) + (cs[1][nb][i] + cs[1][nb][i + 2]);
    }
    const int pos[4] = {2 * t4, 2 * t4 + 1, 8 + 2 * t4, 9 + 2 * t4};
    float mx = kNegInf;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sv[e] *= a.scale;
      mx = pos[e] < rows ? fmaxf(mx, sv[e]) : mx;
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    m_run = m_new;
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sv[e] = pos[e] < rows ? expf(sv[e] - m_new) : 0.f;  // p
      psum += sv[e];
    }
    l_run = l_run * corr + psum;  // this lane's positions; the quad's summed at the end
    // P^T's B fragments (positions 2 t4, + 1 and + 8, + 9 of head g8), in
    // three bf16 parts; the rescale of heads 2 t4, 2 t4 + 1 from their quads
    uint32_t pb[2][kSplitParts];
    split_pair<kSplitParts>(sv[0], sv[1], pb[0]);
    split_pair<kSplitParts>(sv[2], sv[3], pb[1]);
    const float c_lo = __shfl_sync(kFull, corr, 8 * t4);
    const float c_hi = __shfl_sync(kFull, corr, 8 * t4 + 4);
#pragma unroll
    for (int mb = 0; mb < kMaxKSteps; ++mb) {
      if (mb < n_steps) {
        co[mb][0] *= c_lo;
        co[mb][1] *= c_hi;
        co[mb][2] *= c_lo;
        co[mb][3] *= c_hi;
        uint32_t va[4];  // A fragments of V^T: dims 16 mb + (0, 8) x positions (0, 8)
        check_shared(a, vbase + mrow * geo.pstride + mb * 32 + mcol, 16, kSiteLdmatrixV);
        ldmatrix_x4_trans(va, vbase + mrow * geo.pstride + mb * 32 + mcol);
#pragma unroll
        for (int p = 0; p < kSplitParts; ++p) {
          mma_bf16(co[mb], va[0], va[1], va[2], va[3], pb[0][p], pb[1][p]);
        }
      }
    }
  }
  wait_copies<0>();  // no copy may land after the block moves on
  l_run += __shfl_xor_sync(kFull, l_run, 1);
  l_run += __shfl_xor_sync(kFull, l_run, 2);

  __syncthreads();  // every warp is done with the stages: the warps meet there
  float* red = reinterpret_cast<float*>(stages);  // [warp][rep][hdp]
#pragma unroll
  for (int mb = 0; mb < kMaxKSteps; ++mb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = 2 * t4 + e % 2, d = 16 * mb + g8 + (e / 2) * 8;
      if (mb < n_steps && h < rep) {
        check_shared(a, red + (warp * rep + h) * geo.hdp + d, 4, kSiteWarpOutputs);
        red[(warp * rep + h) * geo.hdp + d] = co[mb][e];
      }
    }
  }
  if (t4 == 0 && g8 < rep) {
    m_w[warp][g8] = m_run;
    l_w[warp][g8] = l_run;
  }
  __syncthreads();
  gqa_finish<TQ, kMmaThreads, true>(a, hgp, red, m_w, l_w);
}

// The device body of a launch: one query head per kv head; grouped-query
// heads on the tensor cores (a bf16 cache, head dims a multiple of 16); or
// grouped-query heads on the CUDA cores
enum class Body { kRep1, kTensorCores, kCudaCores };

template <typename TKV>
Body body_for(int rep, int hd) {
  if (rep == 1) return Body::kRep1;
  return sizeof(TKV) == 2 && hd % 16 == 0 ? Body::kTensorCores : Body::kCudaCores;
}

// The layout of a launch: copies as wide as the rows and bases allow;
// paged, room for the table entries of one split of `per` positions. Rows
// padded by 16 bytes (no bank conflict: flash_decode_kernel's lane pairs,
// the tensor cores' ldmatrix) but on the CUDA cores at rep > 1 (its parts
// read adjacent chunks); q in shared memory at rep 1 only.
template <typename TKV>
Geometry geometry(int hd, int rep, int per, int ps, bool paged, const void* k, const void* v) {
  Geometry geo;
  geo.row_bytes = hd * static_cast<int>(sizeof(TKV));
  geo.chunks = ceil_div(geo.row_bytes, 16);
  geo.hdp = geo.chunks * kPerChunk<TKV>;
  geo.copy = 2;
  for (int w = 16; w >= 4; w /= 2) {
    const auto mis = [w](const void* p) { return reinterpret_cast<uintptr_t>(p) % w != 0; };
    if (geo.row_bytes % w == 0 && !mis(k) && !mis(v)) {
      geo.copy = w;
      break;
    }
  }
  const Body body = body_for<TKV>(rep, hd);
  geo.pstride = geo.chunks * 16 + (body == Body::kCudaCores ? 0 : 16);
  geo.stage_bytes = 2 * kTile * geo.pstride;
  geo.table = paged ? per / ps + 2 : 0;
  geo.smem = kStages * geo.stage_bytes +
             ((body == Body::kRep1 ? geo.hdp : 0) + geo.table) * 4 + 128;
  return geo;
}

using KernelFn = void (*)(const Args);

// the kernel of rep query heads per kv head at head dim hd, and its threads
template <typename TQ, typename TKV, bool kPaged>
KernelFn kernel_for(int rep, int hd) {
  switch (body_for<TKV>(rep, hd)) {
    case Body::kRep1: return flash_decode_kernel<TQ, TKV, kPaged>;
    case Body::kTensorCores: return flash_decode_mma_kernel<TQ, kPaged>;
    default: return flash_decode_gqa_kernel<TQ, TKV, kPaged>;
  }
}

template <typename TKV>
int threads_for(int rep, int hd) {
  switch (body_for<TKV>(rep, hd)) {
    case Body::kRep1: return kThreads;
    case Body::kTensorCores: return kMmaThreads;
    default: return kGqaThreads;
  }
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

bool bad_args(int B, int KV, int rep, int hd, int S, int n_split, int per, const float* ws) {
  if (rep < 1 || hd < 1 || hd > kMaxHeadDim || S < 1) return true;
  if (n_split < 1 || per < kTile || per % kTile) return true;
  if (static_cast<long long>(n_split) * per < S || static_cast<long long>(n_split - 1) * per >= S) {
    return true;
  }
  // every (row, kv head, head group) of a launch that splits has a counter
  const long long groups = static_cast<long long>(B) * KV * head_groups(rep);
  return n_split > 1 && (ws == nullptr || groups > kMaxGroups);
}

// The address check's record in mapped host memory (kCheckWords ints),
// allocated at the first launch of a REPRO_SMEM_CHECK build; its device
// address, or nullptr in a default build.
int* g_check_host = nullptr;
int* g_check_device = nullptr;

int* check_record() {
  if constexpr (kAddressCheck) {
    if (g_check_host == nullptr) {
      void* host = nullptr;
      if (cudaHostAlloc(&host, kCheckWords * sizeof(int), cudaHostAllocMapped) != cudaSuccess) {
        return nullptr;
      }
      memset(host, 0, kCheckWords * sizeof(int));
      void* dev = nullptr;
      cudaHostGetDevicePointer(&dev, host, 0);
      g_check_host = static_cast<int*>(host);
      g_check_device = static_cast<int*>(dev);
    }
  }
  return g_check_device;
}

template <bool kPaged>
int launch(Args a, int B, int q_dtype, int kv_dtype, cudaStream_t st) {
  const bool ok = dispatch_dtypes(q_dtype, kv_dtype, [&](auto tq, auto tkv) {
    using TQ = decltype(tq);
    using TKV = decltype(tkv);
    a.geo = geometry<TKV>(a.hd, a.rep, a.per, a.ps, kPaged, a.k, a.v);
    const auto kernel = kernel_for<TQ, TKV, kPaged>(a.rep, a.hd);
    if (a.geo.smem > kDefaultSmem) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.geo.smem);
    }
    a.check = check_record();
    const dim3 grid(a.KV * head_groups(a.rep), B, a.n_split);
    kernel<<<grid, threads_for<TKV>(a.rep, a.hd), a.geo.smem, st>>>(a);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, const void* index,
                                  int index64, void* out, void* ws, int B, int S, int KV, int rep,
                                  int hd, int n_split, int per, float scale, int q_dtype,
                                  int kv_dtype, void* stream) {
  auto* w = static_cast<float*>(ws);
  if (bad_args(B, KV, rep, hd, S, n_split, per, w)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, index, index64, nullptr, out, w, S, KV, rep, hd,
         0, 1, 0, n_split, per, scale, {}, nullptr};
  return launch<false>(a, B, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_flash_decode_paged(const void* q, const void* k, const void* v,
                                        const void* block_tables, const void* index,
                                        int index64, void* out, void* ws, int B, int nb, int ps,
                                        int n_arena, int KV, int rep, int hd, int n_split,
                                        int per, float scale, int q_dtype, int kv_dtype,
                                        void* stream) {
  auto* w = static_cast<float*>(ws);
  if (nb < 1 || ps < 1 || n_arena < 1 || bad_args(B, KV, rep, hd, nb * ps, n_split, per, w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, index, index64, static_cast<const int32_t*>(block_tables),
         out, w, nb * ps, KV, rep, hd, nb, ps, n_arena, n_split, per, scale, {}, nullptr};
  return launch<true>(a, B, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream));
}

// What the card reports for one instance (info as fill_info's) at head dim
// hd, rep query heads per kv head, `per` positions per split and, for B6,
// page size ps, the cache 16-byte aligned.
extern "C" int repro_flash_decode_variant_info(int paged, int q_dtype, int kv_dtype, int hd,
                                               int rep, int per, int ps, int* info) {
  if (rep < 1 || hd < 1 || hd > kMaxHeadDim || per < kTile || ps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int code = static_cast<int>(cudaErrorInvalidValue);
  dispatch_dtypes(q_dtype, kv_dtype, [&](auto tq, auto tkv) {
    using TQ = decltype(tq);
    using TKV = decltype(tkv);
    const Geometry geo = geometry<TKV>(hd, rep, per, ps, paged != 0, nullptr, nullptr);
    const void* fn = reinterpret_cast<const void*>(
        paged ? kernel_for<TQ, TKV, true>(rep, hd) : kernel_for<TQ, TKV, false>(rep, hd));
    if (geo.smem > kDefaultSmem) {  // as a launch does: the limit never drops below the default
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    }
    code = fill_info(fn, geo.smem, threads_for<TKV>(rep, hd), info);
  });
  return code;
}

// The address check's record (kCheckWords ints, all zero while no access
// has failed the check) into `out`; cudaErrorNotSupported from a build
// without REPRO_SMEM_CHECK. Host memory: readable after a fault.
extern "C" int repro_flash_decode_check_record(int* out) {
  if (!kAddressCheck) return static_cast<int>(cudaErrorNotSupported);
  for (int i = 0; i < kCheckWords; ++i) out[i] = g_check_host ? g_check_host[i] : 0;
  return 0;
}
