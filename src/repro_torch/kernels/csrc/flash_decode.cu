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
// used for 2 * rep * hd flops (rep = H / KV <= 8): 2 * rep flops per byte,
// far below the ~295 at which tensor cores would matter, so all math is f32
// on the CUDA cores. One block per (row, kv head) walking the whole cache
// (the earlier kernel) leaves most SMs idle and pays one memory latency per
// position; so here:
//
// - The cache is split over blocks (flash-decoding): grid (KV, B, n_split),
//   split i taking the logical positions [i * per, (i + 1) * per), per a
//   multiple of kTile. The wrapper (kernels/flash_decode.py::split_plan)
//   picks n_split from the capacity (B5: S; B6: nb * ps), B, KV and the SM
//   count, never from index, so it reads nothing from the device. A split
//   that starts past index[b] writes an empty partial (m = -1e30, l = 0).
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
//   stream. With n_split == 1 (the serving shapes, at most 96 positions)
//   there is no workspace and no merge. (A thread-block cluster per (row, kv
//   head), merging through distributed shared memory, ran slower on the
//   card: clusters of 8 blocks did not all fit at once.)
//
// B5 and B6 run one device body over the same splits, tiles and reduction
// order; only the row address differs (logical position j of row b lives
// at arena row bt[b, j / ps] * ps + j % ps). So B6 equals B5 bitwise on
// the contiguous cache its tables address.

#include "stream.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // positions per staged tile (flash_decode.TILE)
constexpr int kWarpRows = kTile / kWarps;  // a warp's positions of each tile
constexpr int kStages = 3;                 // tiles in flight per warp
constexpr int kMaxRep = 8;                 // query heads per kv head
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGroups = 1 << 16;        // (row, kv head) pairs of a launch that splits
constexpr int kMergeBatch = 8;             // splits whose partials one merge load batch holds
constexpr int kDefaultSmem = 48 * 1024;    // dynamic shared memory a launch may take unasked
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarpRows * 2 == 32, "two lanes per position of a warp's rows");

// arrivals of the splits of each (row, kv head); see the header
__device__ int g_arrivals[kMaxGroups];

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

// Element offset of logical position j of row b, kv head g: in the
// contiguous cache, or in the page arena through table entries `tbl` (of
// pages first_page, first_page + 1, ...: the block's slice in shared
// memory, or row b's table in device memory), clamped into the arena.
template <bool kPaged>
__device__ __forceinline__ size_t row_offset(const Args& a, const int* tbl, int first_page,
                                             int b, int j, int g) {
  if constexpr (kPaged) {
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

// One block: kv head g = blockIdx.x, row b = blockIdx.y, split blockIdx.z;
// kR >= rep query heads per kv head held in registers.
template <typename TQ, typename TKV, int kR, bool kPaged>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const Args a) {
  constexpr int V = kPerChunk<TKV>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_w[kWarps][kR];
  __shared__ float l_w[kWarps][kR];
  __shared__ int merge_s;
  const Geometry& geo = a.geo;
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rep = a.rep, hd = a.hd, C = geo.chunks;
  const int start = split * a.per;
  const int end = min(start + a.per, a.S);
  const int r0 = warp * kWarpRows;  // the warp's rows of every tile

  unsigned char* stages = smem + (-smem_u32(smem) & 127);  // 128-byte aligned
  float* q_s = reinterpret_cast<float*>(stages + kStages * geo.stage_bytes);  // [rep][hdp]
  int* tbl = reinterpret_cast<int*>(q_s + rep * geo.hdp);                    // B6
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
  const TQ* q = static_cast<const TQ*>(a.q) + (static_cast<size_t>(b) * a.KV + g) * rep * hd;
  float qv[kR];  // rep * hdp <= kR * kThreads values
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int i = tid + k * kThreads, d = i % geo.hdp;
    qv[k] = i < rep * geo.hdp && d < hd ? to_f32(q[i / geo.hdp * hd + d]) : 0.f;
  }
  int first = 0;  // tiles issued before the barrier
  if constexpr (kPaged) {
    const int n_pages = (end - 1) / a.ps - first_page + 1;
    for (int i = tid; i < n_pages; i += kThreads) {
      tbl[i] = clamp_index(a.bt[static_cast<size_t>(b) * a.nb + first_page + i], a.n_arena);
    }
  } else if (split == 0) {
    issue(0, end, tbl, 0);  // up to `end`: the index is not in yet
    first = 1;
  }
  const int* row_table = kPaged ? a.bt + static_cast<size_t>(b) * a.nb : tbl;
  for (; first < kStages - 1; ++first) issue(first, live_end, row_table, 0);
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    if (tid + k * kThreads < rep * geo.hdp) q_s[tid + k * kThreads] = qv[k] * a.scale;
  }
  if (geo.row_bytes % 16) {  // staged rows' padding reads as zeros
    for (int i = tid; i < kStages * 2 * kTile; i += kThreads) {
      unsigned char* pad = stages + i * geo.pstride + geo.row_bytes;
      for (int t = 0; t < C * 16 - geo.row_bytes; t += 2) {
        *reinterpret_cast<uint16_t*>(pad + t) = 0;
      }
    }
  }
  __syncthreads();  // q, the table slice, the padding

  // scores: lanes 2j and 2j + 1 take row j of the warp's rows, chunks
  // [c_lo, c_hi) each; P.V: lane = sub * C + pc takes chunk pc of rows sub,
  // sub + n_sub, ...
  const int sj = lane >> 1, half = lane & 1;
  const int c_lo = half ? (C + 1) / 2 : 0, c_hi = half ? C : (C + 1) / 2;
  const int n_sub = 32 / C, pc = lane % C, sub = lane / C;
  const bool pv_on = sub < n_sub;

  float m_run[kR], l_run[kR], acc[kR][V];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    wait_copies<kStages - 2>();
    __syncwarp();
    issue(t + kStages - 1, live_end, tbl, first_page);
    const int rows = rows_of(t, live_end);
    if (rows == 0) continue;  // the warp's rows all lie past the index
    const unsigned char* buf = stages + (t % kStages) * geo.stage_bytes;

    float s[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) s[r] = 0.f;
    if (sj < rows) {
      const unsigned char* krow = buf + (r0 + sj) * geo.pstride;
#pragma unroll 4
      for (int c = c_lo; c < c_hi; ++c) {
        float kv[V];
        load16(reinterpret_cast<const TKV*>(krow + c * 16), kv);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r >= rep) break;
          const float4* qq = reinterpret_cast<const float4*>(q_s + r * geo.hdp + c * V);
#pragma unroll
          for (int e4 = 0; e4 < V / 4; ++e4) {
            const float4 q4 = qq[e4];
            s[r] = fmaf(q4.x, kv[4 * e4], s[r]);
            s[r] = fmaf(q4.y, kv[4 * e4 + 1], s[r]);
            s[r] = fmaf(q4.z, kv[4 * e4 + 2], s[r]);
            s[r] = fmaf(q4.w, kv[4 * e4 + 3], s[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r >= rep) break;
      s[r] += __shfl_xor_sync(kFull, s[r], 1);
      float mx = sj < rows ? s[r] : kNegInf;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m_run[r], mx);
      const float corr = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      s[r] = sj < rows ? expf(s[r] - m_new) : 0.f;  // p of row sj
      l_run[r] = l_run[r] * corr + (half ? 0.f : s[r]);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kWarpRows; j += n_sub) {
      const int jj = j + sub;
      float p[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r >= rep) break;
        p[r] = __shfl_sync(kFull, s[r], (2 * jj) & 31);
      }
      if (pv_on && jj < rows) {
        float vv[V];
        load16(reinterpret_cast<const TKV*>(buf + (kTile + r0 + jj) * geo.pstride + pc * 16), vv);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r >= rep) break;
#pragma unroll
          for (int e = 0; e < V; ++e) acc[r][e] = fmaf(p[r], vv[e], acc[r][e]);
        }
      }
    }
  }
  wait_copies<0>();  // no copy may land after the block moves on

  // the warp's totals: l over its lanes, acc over its subgroups in order
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) l_run[r] += __shfl_xor_sync(kFull, l_run[r], o);
    float tot[V];
#pragma unroll
    for (int e = 0; e < V; ++e) tot[e] = acc[r][e];
    for (int sg = 1; sg < n_sub; ++sg) {
#pragma unroll
      for (int e = 0; e < V; ++e) tot[e] += __shfl_sync(kFull, acc[r][e], sg * C + pc);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = tot[e];
  }
  __syncthreads();  // every warp is done with the stages: the warps meet there
  float* red = reinterpret_cast<float*>(stages);  // [warp][rep][hdp]
  if (lane < C) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r >= rep) break;
#pragma unroll
      for (int e = 0; e < V; ++e) red[(warp * rep + r) * geo.hdp + lane * V + e] = acc[r][e];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r >= rep) break;
      m_w[warp][r] = m_run[r];
      l_w[warp][r] = l_run[r];
    }
  }
  __syncthreads();

  const int H = a.KV * rep;
  TQ* out = static_cast<TQ*>(a.out) + (static_cast<size_t>(b) * H + g * rep) * hd;
  const int stride = rep * (hd + 2);  // a partial: acc [rep][hd], m [rep], l [rep]
  float* parts = a.n_split > 1
                     ? a.ws + (static_cast<size_t>(b) * a.KV + g) * a.n_split * stride
                     : nullptr;
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_w[w][r]);
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(m_w[w][r] - m_all);
      l_all += l_w[w][r] * wt;
      o += red[(w * rep + r) * geo.hdp + d] * wt;
    }
    if (!parts) {
      out[i] = from_f32<TQ>(l_all > 0.f ? o / l_all : 0.f);
    } else {
      float* part = parts + static_cast<size_t>(split) * stride;
      part[i] = o;
      if (d == 0) {
        part[rep * hd + r] = l_all > 0.f ? m_all : kNegInf;
        part[rep * hd + rep + r] = l_all;
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
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd;
    float m_all = kNegInf, l_all = 0.f, o = 0.f;
    for (int s0 = 0; s0 < a.n_split; s0 += kMergeBatch) {
      float mb[kMergeBatch], lb[kMergeBatch], ob[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        mb[u] = lb[u] = ob[u] = 0.f;
        if (s0 + u < a.n_split) {
          const float* p = parts + static_cast<size_t>(s0 + u) * stride;
          mb[u] = __ldcg(p + rep * hd + r);
          lb[u] = __ldcg(p + rep * hd + rep + r);
          ob[u] = __ldcg(p + i);
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
    out[i] = from_f32<TQ>(l_all > 0.f ? o / l_all : 0.f);
  }
}

// The layout of a launch: copies as wide as the rows and bases allow;
// paged, room for the table entries of one split of `per` positions.
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
  geo.pstride = geo.chunks * 16 + 16;
  geo.stage_bytes = 2 * kTile * geo.pstride;
  geo.table = paged ? per / ps + 2 : 0;
  geo.smem = kStages * geo.stage_bytes + (rep * geo.hdp + geo.table) * 4 + 128;
  return geo;
}

template <typename TQ, typename TKV, bool kPaged>
auto kernel_for(int rep) {
  return rep == 1 ? flash_decode_kernel<TQ, TKV, 1, kPaged>
                  : flash_decode_kernel<TQ, TKV, kMaxRep, kPaged>;
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
  if (rep < 1 || rep > kMaxRep || hd < 1 || hd > kMaxHeadDim || S < 1) return true;
  if (n_split < 1 || per < kTile || per % kTile) return true;
  if (static_cast<long long>(n_split) * per < S || static_cast<long long>(n_split - 1) * per >= S) {
    return true;
  }
  return n_split > 1 && (ws == nullptr || static_cast<long long>(B) * KV > kMaxGroups);
}

template <bool kPaged>
int launch(Args a, int B, int q_dtype, int kv_dtype, cudaStream_t st) {
  const bool ok = dispatch_dtypes(q_dtype, kv_dtype, [&](auto tq, auto tkv) {
    using TQ = decltype(tq);
    using TKV = decltype(tkv);
    a.geo = geometry<TKV>(a.hd, a.rep, a.per, a.ps, kPaged, a.k, a.v);
    const auto kernel = kernel_for<TQ, TKV, kPaged>(a.rep);
    if (a.geo.smem > kDefaultSmem) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.geo.smem);
    }
    kernel<<<dim3(a.KV, B, a.n_split), kThreads, a.geo.smem, st>>>(a);
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
         0, 1, 0, n_split, per, scale, {}};
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
         out, w, nb * ps, KV, rep, hd, nb, ps, n_arena, n_split, per, scale, {}};
  return launch<true>(a, B, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream));
}

// What the card reports for one instance (info as fill_info's) at head dim
// hd, rep query heads per kv head, `per` positions per split and, for B6,
// page size ps, the cache 16-byte aligned.
extern "C" int repro_flash_decode_variant_info(int paged, int q_dtype, int kv_dtype, int hd,
                                               int rep, int per, int ps, int* info) {
  if (rep < 1 || rep > kMaxRep || hd < 1 || hd > kMaxHeadDim || per < kTile || ps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int code = static_cast<int>(cudaErrorInvalidValue);
  dispatch_dtypes(q_dtype, kv_dtype, [&](auto tq, auto tkv) {
    using TQ = decltype(tq);
    using TKV = decltype(tkv);
    const Geometry geo = geometry<TKV>(hd, rep, per, ps, paged != 0, nullptr, nullptr);
    const void* fn = paged ? reinterpret_cast<const void*>(kernel_for<TQ, TKV, true>(rep))
                           : reinterpret_cast<const void*>(kernel_for<TQ, TKV, false>(rep));
    if (geo.smem > kDefaultSmem) {  // as a launch does: the limit never drops below the default
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    }
    code = fill_info(fn, geo.smem, kThreads, info);
  });
  return code;
}
