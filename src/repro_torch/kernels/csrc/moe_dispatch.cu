// B2 dispatch and B3 combine: the row gathers around the expert FFN.
//
// Replace repro/kernels/moe_dispatch.py::_dispatch_impl / _dispatch_kernel
// and ::_combine_impl / _make_combine_kernel. On the TPU each grid step
// DMAs one (1, bd) row named by the scalar-prefetched routing table. Here a
// thread owns one or a few words of a slot row (dispatch), or a warp a
// token row or a thread a word of one (combine), and reads the row's
// indices itself; rows move as 16-byte words where the row width allows.
//
// Both move bytes: dispatch copies S rows, combine reads K rows per token
// and writes one. Neither does enough arithmetic to matter, and on this
// card neither is bound by its bytes at decode: there dispatch copies 128
// rows of 1 KB (0.04 us at the byte bound) and combine reads 8 rows and
// writes 8 (~16 KB, 5 ns), so the launch and the latency of their
// dependent loads set their time. A long prefill's dispatch (18,432 rows
// of 12 KB) is bound by the bytes it writes.
//
// dispatch is a flat grid over S x the row's words: thread i takes N words
// of one slot row. It loads the slot's validity and token together, then
// its N words, then stores them: every load is one table round trip and
// one row round trip from the thread's start, and an SM holds 16 bytes in
// flight per resident thread (32 KB at 2,048), which covers the card's
// latency at its bandwidth. (A warp per slot row, 4 rows a block, walked
// dbrx-132b's 12 KB rows in 6 dependent passes on 16 blocks and lost 1.8x
// to index_select at decode.) dispatch_plan in kernels/moe_dispatch.py
// picks from the shapes N = 2 for rows past 4 KB (half the threads and
// blocks: 3-5% faster at dbrx-132b's and deepseek-v3-671b's decode, equal
// at their prefills), else 1, and evict-first stores for outputs of 16 MB
// or more (the long prefills' 226-470 MB: 6-7% faster; an output the next
// kernel reads from L2 keeps plain stores). An invalid slot stores zeros
// and reads no row.
//
// combine has two grids, which the wrapper picks from the shapes
// (kernels/moe_dispatch.py::combine_plan):
// - rows: one warp per token, 4 tokens per block, where a row takes one
//   pass, or tokens enough to fill the card at k <= 4. Every lane loads the
//   table entries of up to 4 rows at once (the lanes share the address:
//   one request per warp), then all its words of those rows, then the
//   FMAs, so a row waits on one table load. Top-1 takes an instance with
//   no loop over k: in a kernel this short the fetch of its own
//   instructions sits on the chain too, and a shuffle of the table
//   entries from lanes 0..K-1 or a loop over k ran slower at decode than
//   the block-per-token kernel this replaced.
// - cols: one thread per 16-byte word of the output, a flat grid over T x
//   d, for wide rows at few tokens or k > 4 (decode at d 6,144-7,168, k
//   4-8: one warp a token put 8 warps on 132 SMs, each walking its row in
//   6-7 passes of two dependent steps). A thread loads the table entries
//   of up to 8 rows at once, then its word of every one of them, then the
//   FMAs: one table round trip and one row round trip per output word,
//   over T x d / 8 (bf16) threads.
// Both sum in f32 in the order k = 0..K-1, w * keep times the row, and
// cast once. Both launch as a programmatic dependent launch (PDL): their
// launch and the placement of their blocks overlap the end of the kernel
// before it on the stream, eagerly and as a CUDA-graph edge. The PDL rule:
// the kernel makes no global load or store before griddepcontrol.wait,
// since the kernel before it may still be writing the tables, the rows,
// or the memory the allocator handed out as its output.

#include "stream.cuh"

namespace {

// ---------------------------------------------------------------------------
// dispatch: buf[s] = slot_valid[s] ? x[clip(slot_token[s])] : 0
// A pure byte copy, so one kernel serves every dtype; W is the word moved.
// ---------------------------------------------------------------------------

constexpr int kDispatchThreads = 128;

// Thread i of the grid takes words c, c + tpr, ..., c + (N - 1) tpr of slot
// row s = i / tpr, c = i % tpr: the tpr = ceil(row_words / N) threads of a
// row read and write its words side by side, a warp's loads one segment of
// the row. The two table loads issue at once on the read-only path, the
// row's N loads once they are in, the N stores after all of them;
// kStream stores them evict-first (st.global.cs), for outputs the next
// kernel will not find in L2 anyway.
template <typename W, int N, bool kStream>
__global__ void __launch_bounds__(kDispatchThreads)
dispatch_words_kernel(const W* __restrict__ x, const int32_t* __restrict__ slot_token,
                      const uint8_t* __restrict__ slot_valid, W* __restrict__ out,
                      int n_tokens, unsigned n_threads, int row_words, unsigned tpr) {
  const unsigned i = blockIdx.x * kDispatchThreads + threadIdx.x;
  if (i >= n_threads) return;
  const int s = static_cast<int>(i / tpr), c = static_cast<int>(i % tpr);
  const bool valid = __ldg(slot_valid + s) != 0;
  const int t = clamp_index(__ldg(slot_token + s), n_tokens);
  const W* src = x + static_cast<size_t>(t) * row_words;
  W* dst = out + static_cast<size_t>(s) * row_words;
  W v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int w = c + j * static_cast<int>(tpr);
    v[j] = valid && w < row_words ? __ldg(src + w) : W{};
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int w = c + j * static_cast<int>(tpr);
    if (w < row_words) {
      if constexpr (kStream) {
        __stcs(dst + w, v[j]);
      } else {
        dst[w] = v[j];
      }
    }
  }
}

template <typename W>
using DispatchKernel = void (*)(const W*, const int32_t*, const uint8_t*, W*, int, unsigned, int,
                                unsigned);

// B2's instance of N words a thread (1 or 2), streaming its stores or not,
// else nullptr
template <typename W>
DispatchKernel<W> dispatch_kernel(int per_thread, bool stream) {
  if (per_thread == 1) {
    return stream ? dispatch_words_kernel<W, 1, true> : dispatch_words_kernel<W, 1, false>;
  }
  if (per_thread == 2) {
    return stream ? dispatch_words_kernel<W, 2, true> : dispatch_words_kernel<W, 2, false>;
  }
  return nullptr;
}

template <typename W>
int launch_dispatch(const void* x, const int32_t* slot_token, const uint8_t* slot_valid,
                    void* out, int n_tokens, int n_slots, int row_bytes, int per_thread,
                    bool stream, cudaStream_t st) {
  const auto kernel = dispatch_kernel<W>(per_thread, stream);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int row_words = row_bytes / static_cast<int>(sizeof(W));
  const long long tpr = ceil_div(row_words, per_thread);
  const long long n_threads = tpr * n_slots;
  if (n_threads >= 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((n_threads + kDispatchThreads - 1) / kDispatchThreads);
  kernel<<<blocks, kDispatchThreads, 0, st>>>(
      static_cast<const W*>(x), slot_token, slot_valid, static_cast<W*>(out), n_tokens,
      static_cast<unsigned>(n_threads), row_words, static_cast<unsigned>(tpr));
  return static_cast<int>(cudaGetLastError());
}

// the word dispatch moves rows in: the widest of 16, 4, 2 and 1 bytes that
// divides a row and both bases (a view off a word boundary takes a
// narrower one)
int dispatch_word(const void* x, const void* out, int row_bytes) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                        static_cast<uintptr_t>(row_bytes);
  return any % 16 == 0 ? 16 : (any % 4 == 0 ? 4 : (any % 2 == 0 ? 2 : 1));
}

// ---------------------------------------------------------------------------
// combine: y[t] = sum_k topk_w[t,k] * keep[t,k] * buf[clip(token_slot[t,k])]
// One warp per token row, f32 accumulation in the order k = 0..K-1 (so a
// top-1 output is one product onto zero, the plain version's bits). A
// dropped (t, k) still reads its clipped row and multiplies it by 0, as the
// TPU kernel does, so a NaN row propagates as in the reference.
// ---------------------------------------------------------------------------

constexpr int kCombineThreads = 128;
constexpr int kTokensPerBlock = kCombineThreads / 32;   // one warp per token row
constexpr int kCombineWords = 4;    // a lane's words of one row per pass (2 KB rows in one)
constexpr int kCombineRows = 4;     // rows whose words a lane loads before its first FMA (k > 1)
constexpr int kColRows = 8;         // the cols grid's rows loaded before the first FMA (k > 1)

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

// PDL: returns once the kernel before this one on the stream has finished
// and its writes are visible; at once when launched without the attribute
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// R rows per step: R = 1 is the top-1 instance (k == 1, one step, no loop
// over k: a short body, since a one-shot kernel waits on its instruction
// fetches too), else k rows in steps of kCombineRows
template <typename T, int V, int R>
__global__ void __launch_bounds__(kCombineThreads)
combine_rows_kernel(const T* __restrict__ buf, const int32_t* __restrict__ token_slot,
                    const float* __restrict__ topk_w, const uint8_t* __restrict__ keep,
                    T* __restrict__ out, int n_tokens, int n_slots, int k, int d) {
  wait_for_previous_grid();           // before any global access
  const int t = blockIdx.x * kTokensPerBlock + threadIdx.x / 32;
  if (t >= n_tokens) return;
  const int lane = threadIdx.x % 32;
  using Row = Vec<T, V>;
  const int n_vec = d / V;
  const int n_rows = R == 1 ? 1 : k;
  const Row* rows = reinterpret_cast<const Row*>(buf);
  Row* dst = reinterpret_cast<Row*>(out + static_cast<size_t>(t) * d);
  for (int base = 0; base < n_vec; base += 32 * kCombineWords) {
    const int c0 = base + lane;
    float acc[kCombineWords][V];
#pragma unroll
    for (int r = 0; r < kCombineWords; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
    for (int j0 = 0; j0 < n_rows; j0 += R) {
      // the step's table entries, loaded at once by every lane (one
      // request per warp: the lanes share the address)
      const Row* src[R];
      float w[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int tk = t * k + min(j0 + j, n_rows - 1);
        src[j] = rows + static_cast<size_t>(clamp_index(__ldg(token_slot + tk), n_slots)) * n_vec;
        w[j] = __ldg(topk_w + tk) * (__ldg(keep + tk) ? 1.f : 0.f);
      }
      // then every word of the step's rows, then the FMAs in the order of k
      Row v[R][kCombineWords];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int r = 0; r < kCombineWords; ++r) {
          const int i = c0 + 32 * r;
          v[j][r] = j0 + j < n_rows && i < n_vec ? src[j][i] : Row{};
        }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j0 + j < n_rows) {
#pragma unroll
          for (int r = 0; r < kCombineWords; ++r)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[r][e] += w[j] * to_f32(v[j][r].e[e]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kCombineWords; ++r) {
      const int i = c0 + 32 * r;
      if (i < n_vec) {
        Row o;
#pragma unroll
        for (int e = 0; e < V; ++e) o.e[e] = from_f32<T>(acc[r][e]);
        dst[i] = o;
      }
    }
  }
}

// The cols grid: thread g takes word i = g % n_vec of token t = g / n_vec.
// R rows per step as in combine_rows_kernel: R = 1 the top-1 instance,
// else k rows in steps of kColRows (one step up to k = 8)
template <typename T, int V, int R>
__global__ void __launch_bounds__(kCombineThreads)
combine_cols_kernel(const T* __restrict__ buf, const int32_t* __restrict__ token_slot,
                    const float* __restrict__ topk_w, const uint8_t* __restrict__ keep,
                    T* __restrict__ out, int n_tokens, int n_slots, int k, int d) {
  wait_for_previous_grid();           // before any global access
  using Row = Vec<T, V>;
  const int n_vec = d / V;
  const long long g = static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (g >= static_cast<long long>(n_tokens) * n_vec) return;
  const int t = static_cast<int>(g / n_vec), i = static_cast<int>(g % n_vec);
  const int n_rows = R == 1 ? 1 : k;
  const Row* rows = reinterpret_cast<const Row*>(buf);
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < n_rows; j0 += R) {
    const Row* src[R];
    float w[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int tk = t * k + min(j0 + j, n_rows - 1);
      src[j] = rows + static_cast<size_t>(clamp_index(__ldg(token_slot + tk), n_slots)) * n_vec;
      w[j] = __ldg(topk_w + tk) * (__ldg(keep + tk) ? 1.f : 0.f);
    }
    Row v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = j0 + j < n_rows ? src[j][i] : Row{};
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j0 + j < n_rows) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += w[j] * to_f32(v[j].e[e]);
      }
    }
  }
  Row o;
#pragma unroll
  for (int e = 0; e < V; ++e) o.e[e] = from_f32<T>(acc[e]);
  reinterpret_cast<Row*>(out)[g] = o;
}

// an empty kernel that obeys the PDL rule (repro_launch_floor); its one
// argument keeps cudaLaunchKernelEx's argument array from being empty
__global__ void launch_floor_kernel(int) { wait_for_previous_grid(); }

// a copy of 16-byte words that lets its dependent launch before it stores
// anything (repro_copy_early_trigger): a kernel launched after it with PDL
// runs while it writes. With only the implicit trigger at a grid's end,
// as every other kernel here has, a dependent starts once the writes are
// visible, so a load issued before griddepcontrol.wait shows up only
// after a kernel such as this one.
__global__ void copy_early_trigger_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                                          long long n_words) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n_words;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    dst[i] = src[i];
}

// launches ``kernel`` on ``stream``, as a programmatic dependent of the
// kernel before it where ``pdl`` is set; returns the launch's error
template <typename... Params, typename... Args>
cudaError_t launch_ex(void (*kernel)(Params...), int blocks, int threads, bool pdl,
                      cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
using CombineKernel = void (*)(const T*, const int32_t*, const float*, const uint8_t*, T*, int,
                               int, int, int);

// B3's instance: the cols or rows grid, top-1 or k rows, on the 16-byte
// vector path (vec) or one element a word
template <typename T>
CombineKernel<T> combine_kernel(bool cols, bool top1, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (cols) {
    return vec ? (top1 ? combine_cols_kernel<T, V, 1> : combine_cols_kernel<T, V, kColRows>)
               : (top1 ? combine_cols_kernel<T, 1, 1> : combine_cols_kernel<T, 1, kColRows>);
  }
  return vec ? (top1 ? combine_rows_kernel<T, V, 1> : combine_rows_kernel<T, V, kCombineRows>)
             : (top1 ? combine_rows_kernel<T, 1, 1> : combine_rows_kernel<T, 1, kCombineRows>);
}

// the 16-byte vector path where d is whole words and both rows are
// aligned, else one element a word (ragged d, a view off a 16-byte boundary)
template <typename T>
cudaError_t launch_combine(const void* buf, const int32_t* token_slot, const float* topk_w,
                           const uint8_t* keep, void* out, int n_tokens, int n_slots, int k,
                           int d, bool cols, bool pdl, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && aligned16(buf) && aligned16(out);
  const long long threads = static_cast<long long>(n_tokens) * (d / (vec ? V : 1));
  const long long blocks = cols ? (threads + kCombineThreads - 1) / kCombineThreads
                                : ceil_div(n_tokens, kTokensPerBlock);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_ex(combine_kernel<T>(cols, k == 1, vec), static_cast<int>(blocks),
                   kCombineThreads, pdl, stream, static_cast<const T*>(buf), token_slot, topk_w,
                   keep, static_cast<T*>(out), n_tokens, n_slots, k, d);
}

// the launch's own error, else any error pending from before
int launch_status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// per_thread: the words a thread moves (1 or 2), stream: evict-first
// stores, as dispatch_plan picks them
extern "C" int repro_moe_dispatch(const void* x, const void* slot_token, const void* slot_valid,
                                  void* out, int n_tokens, int n_slots, int row_bytes,
                                  int per_thread, int stream, void* cuda_stream) {
  const auto* tok = static_cast<const int32_t*>(slot_token);
  const auto* valid = static_cast<const uint8_t*>(slot_valid);
  auto st = static_cast<cudaStream_t>(cuda_stream);
  const bool cs = stream != 0;
  switch (dispatch_word(x, out, row_bytes)) {
    case 16:
      return launch_dispatch<uint4>(x, tok, valid, out, n_tokens, n_slots, row_bytes, per_thread,
                                    cs, st);
    case 4:
      return launch_dispatch<uint32_t>(x, tok, valid, out, n_tokens, n_slots, row_bytes,
                                       per_thread, cs, st);
    case 2:
      return launch_dispatch<uint16_t>(x, tok, valid, out, n_tokens, n_slots, row_bytes,
                                       per_thread, cs, st);
    default:
      return launch_dispatch<uint8_t>(x, tok, valid, out, n_tokens, n_slots, row_bytes,
                                      per_thread, cs, st);
  }
}

// cols: the cols grid (else rows), as combine_plan picks
extern "C" int repro_moe_combine(const void* buf, const void* token_slot, const void* topk_w,
                                 const void* keep, void* out, int n_tokens, int n_slots, int k,
                                 int d, int dtype, int cols, int pdl, void* stream) {
  const auto* slots = static_cast<const int32_t*>(token_slot);
  const auto* w = static_cast<const float*>(topk_w);
  const auto* kp = static_cast<const uint8_t*>(keep);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kReproF32) {
    return launch_status(launch_combine<float>(buf, slots, w, kp, out, n_tokens, n_slots, k,
                                               d, cols != 0, pdl != 0, st));
  }
  if (dtype == kReproBF16) {
    return launch_status(launch_combine<__nv_bfloat16>(buf, slots, w, kp, out, n_tokens,
                                                       n_slots, k, d, cols != 0, pdl != 0, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What the card reports for one instance (info as fill_info's): kind 0 is
// B2's kernel moving rows in `word`-byte words (16, 4, 2 or 1),
// `per_thread` of them a thread (1 or 2), with evict-first stores where
// `stream` is set, kind 1 is
// B3's in `dtype`, on the cols grid where `cols` is set (else rows), its
// top-1 instance at k == 1 else the k-row one, on the 16-byte vector path
// where `vec` is set
extern "C" int repro_moe_dispatch_variant_info(int kind, int dtype, int word, int per_thread,
                                               int stream, int k, int vec, int cols, int* info) {
  const void* fn = nullptr;
  if (kind == 0) {
    const bool cs = stream != 0;
    if (word == 16) fn = reinterpret_cast<const void*>(dispatch_kernel<uint4>(per_thread, cs));
    if (word == 4) fn = reinterpret_cast<const void*>(dispatch_kernel<uint32_t>(per_thread, cs));
    if (word == 2) fn = reinterpret_cast<const void*>(dispatch_kernel<uint16_t>(per_thread, cs));
    if (word == 1) fn = reinterpret_cast<const void*>(dispatch_kernel<uint8_t>(per_thread, cs));
    return fn == nullptr ? static_cast<int>(cudaErrorInvalidValue)
                         : fill_info(fn, 0, kDispatchThreads, info);
  }
  if (kind != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kReproF32) {
    fn = reinterpret_cast<const void*>(combine_kernel<float>(cols != 0, k == 1, vec != 0));
  } else if (dtype == kReproBF16) {
    fn = reinterpret_cast<const void*>(
        combine_kernel<__nv_bfloat16>(cols != 0, k == 1, vec != 0));
  }
  return fn == nullptr ? static_cast<int>(cudaErrorInvalidValue)
                       : fill_info(fn, 0, kCombineThreads, info);
}

// one empty launch of ``blocks`` x 128 threads, as a programmatic dependent
// of the kernel before it where ``pdl`` is set: B3's launch path with no
// work, timed by chip_smoke.py as the floor of a launch-bound kernel
extern "C" int repro_launch_floor(int blocks, int pdl, void* stream) {
  return launch_status(launch_ex(launch_floor_kernel, blocks, kCombineThreads, pdl != 0,
                                 static_cast<cudaStream_t>(stream), 0));
}

// dst <- src, nbytes a multiple of 16 and both 16-byte aligned, by a grid
// that is resident at once and triggers its dependents as it starts: the
// cuda tests launch B3 after it to show that B3 reads nothing before its
// wait
extern "C" int repro_copy_early_trigger(const void* src, void* dst, long long nbytes,
                                        void* stream) {
  if (nbytes % 16 != 0 || !aligned16(src) || !aligned16(dst))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  copy_early_trigger_kernel<<<2 * sms, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), nbytes / 16);
  return static_cast<int>(cudaGetLastError());
}
