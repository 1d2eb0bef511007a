// Window functions on the card: K15 window_rank and K16 window_frame.
//
// They replace the sorted-space window programs of the JAX package's
// relational.py, which XLA lowers to sorts, cumulative scans, scatters and
// gathers; none of it is a Pallas kernel:
//   - K15 window_rank: _window_rank_family's program (:1542-1641):
//     row_number, rank, dense_rank, ntile(n), percent_rank and cume_dist;
//   - K16 window_frame: _window_frame_agg's program (:1762-2057): each
//     sorted row's frame [lo, hi] (the default running frame, ROWS with
//     literal offsets, GROUPS, RANGE with numeric offsets on one key) and
//     count, sum, avg, min, max, lag/lead, first_value, last_value and
//     nth_value over it.
// Contracts: window_rank_reference and window_frame_reference in
// reference.py.
//
// Sorted space. The caller sorts the rows once by words whose top field is
// the partition's segment id and whose lower fields are the ORDER BY keys
// (K11, one stable torch.sort a word), and passes the order and the sorted
// words. A position starts a partition where word 0's bits above
// part_shift change, and a peer group where any word changes: the words
// hold every key with its nulls neutralised, as the JAX program compares
// adjacent sorted codes (:1580-1590). The JAX program scatters each output
// to row order (:1633-1641); K15 and K16 store through order_scatter.cuh's
// slabs.
//
// K15: single-pass scans (decoupled look-back; see
// K16's section), each result computed in sorted order and handed to step
// 1 of the slab store. rank_forward gives each position its partition
// start ps, its peer group's start gs and its dense rank (the peer heads
// since ps); row_number, rank and dense_rank are final there. ntile,
// percent_rank and cume_dist need the partition's end or the peer group's
// end: rank_forward writes ps (and gs), and frame_reverse's fused pass
// computes them beside pe and ge.
//
// K16: one single-pass launch a scan (decoupled look-back; see
// its section). The forward scan reads the argument through the order
// once, beside ps, gs and cnt: its sum P (int64 for integer arguments,
// float64 for the rest), the count C of its valid values and, for a
// min/max whose frame starts at the partition start, its running extremum
// M, reset at each partition start, and the sorted argument sv/sm that
// positional functions, loops and the table read. Each result is computed
// in sorted order and stored through the order by slab: no random store.
//
// Frames and their routes (the caller picks agg_route):
//   - sums and counts: over [ps, hi] the prefix P[hi] itself; over a ROWS
//     frame of literal offsets at most LOOP_MAX (reference.py) rows wide a
//     loop in row order;
//     else P[hi] - P[lo - 1], per partition;
//   - min/max: a frame that starts at the partition start reads the
//     running extremum M[hi]; a ROWS frame of literal offsets at most
//     LOOP_MAX rows wide loops over its width; the rest (GROUPS, RANGE and
//     frames to UNBOUNDED FOLLOWING) read a sparse table whose levels stop
//     at the longest frame that occurs (the caller reads that length back
//     between stage 1 and stage 2), never ceil(log2 n) + 1 copies of the
//     argument as the JAX program builds (:2024-2046).
//
// What bounds them on an H100: K15 moves 24 B a row at the bound (order,
// word, result); in this design it also writes and reads back 12 B a row of
// bucket entries, and the reverse functions 4-8 B a row of ps (and gs).
// K16's running sum moves about 29 B a row at the bound (order, word,
// argument, result and mask); its floor in this design is the one random
// 8 B read of the argument through the order. It reads the words twice
// (once a scan), writes and reads back P and C (16 B), and moves 12 B a
// row of bucket entries each way.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "launch.cuh"
#include "order_scatter.cuh"

// Every field is 8 bytes, in the order of window.py's ctypes Structure. It
// lies outside the anonymous namespace: the C entry points take it.
constexpr int kMaxWords = 4;  // sort words (window.py's MAX_WORDS)

struct WindowArgs {
  long long n;            // sorted positions (the frame's padded rows)
  long long nwords;
  long long part_shift;   // word 0's bits below the partition field
  long long unreal;       // 1: rows that are not real sorted last, word 0 at or above real_below
  long long real_below;
  const void* words[kMaxWords];
  long long wide[kMaxWords];  // 1: int64 words, 0: int32 words
  const long long* order;     // int64 [n]: the row at each sorted position
  long long func;
  long long param;        // ntile's buckets, lag/lead's offset, nth_value's n
  long long unit;
  long long lo_kind, hi_kind;
  double lo_n, hi_n;
  long long agg_route;
  long long stage;        // 0: all; 1: up to the frames' bounds; 2: the table, then the output
  long long level;        // the table level a table_level launch builds
  const void* values;     // int64 or float64 [rows]: the argument
  const uint8_t* vmask;   // bool [rows] or null
  long long is_float;
  long long has_default;
  long long default_i;
  double default_f;
  const double* key;      // float64 [rows]: RANGE's order key
  const uint8_t* kmask;
  long long key_desc;
  int* ps;
  int* pe;
  int* gs;
  int* ge;
  int* cnt;
  int* gstart;            // int32 [n]: each peer group's first position (GROUPS offsets)
  int* gend;
  double* skv;            // the RANGE key in sorted order, negated if descending
  uint8_t* snull;
  void* P;
  long long* C;
  void* M;
  void* sv;               // the argument in sorted order, 0 where not valid
  uint8_t* sm;
  int* lo;                // the frames' bounds (the table route)
  int* hi;
  int* maxlen;            // the longest frame (the table route)
  void* levels;           // [nlevels][n]
  long long nlevels;
  void* out;              // int64 or float64 [rows]
  uint8_t* outm;          // bool [rows] or null
  // the single-pass scans and the store through the order
  int* state;             // int32: 2 tile counters, the forward and reverse tiles' flags,
                          // each slab's bucket count; zeroed by the call
  void* fwd_part;         // 2 x forward tiles: each tile's aggregate, then its inclusive prefix
  void* rev_part;         // 2 x reverse tiles, likewise
  long long fuse;         // 1: the reverse scan computes the results (running and ROWS frames
                          // but the table route); 0: frame_final does
  unsigned* slab_offs;    // [rows]: bucket entries' offsets
  void* slab_vals;        // [rows]: their 8-byte results
};

namespace {

using namespace fugue;
using Args = WindowArgs;

constexpr int kThreads = 256;
constexpr int kBig = 0x7FFFFFFF;

// functions, as the wrappers pass them
constexpr int kRowNumber = 0, kRank = 1, kDenseRank = 2, kNtile = 3, kPercentRank = 4,
              kCumeDist = 5;
constexpr int kCount = 10, kCountStar = 11, kSum = 12, kAvg = 13, kMin = 14, kMax = 15,
              kLag = 16, kLead = 17, kFirst = 18, kLast = 19, kNth = 20;
// frame units and bound kinds
constexpr int kRunning = 0, kRows = 1, kGroups = 2, kRange = 3;
constexpr int kUp = 0, kPre = 1, kCur = 2, kFol = 3, kUf = 4;
// aggregate routes
constexpr int kPrefix = 0, kLoop = 1, kTable = 2;



__device__ __forceinline__ unsigned long long word_at(const Args& a, int w, long long j) {
  if (a.wide[w]) return (unsigned long long)__ldg(static_cast<const long long*>(a.words[w]) + j);
  return (unsigned long long)(unsigned)__ldg(static_cast<const int*>(a.words[w]) + j);
}

__device__ __forceinline__ bool same_part(const Args& a, long long i, long long j) {
  return (word_at(a, 0, i) >> a.part_shift) == (word_at(a, 0, j) >> a.part_shift);
}

// Whether sorted position j holds a real row (the rows that are not real
// carry K11's top bit in word 0 and sort last).
__device__ __forceinline__ bool is_real(const Args& a, long long j) {
  if (!a.unreal) return true;
  const unsigned long long w = word_at(a, 0, j);
  const long long v = a.wide[0] ? (long long)w : (long long)(int)(unsigned)w;
  return v < a.real_below;
}

__device__ __forceinline__ bool same_words(const Args& a, long long i, long long j) {
  for (int w = 0; w < a.nwords; ++w) {
    if (word_at(a, w, i) != word_at(a, w, j)) return false;
  }
  return true;
}

// ---- values: int64 or float64, NaN not valid, -0.0 below +0.0 ----------

template <class V>
__device__ __forceinline__ bool is_nan(V) {
  return false;
}
template <>
__device__ __forceinline__ bool is_nan<double>(double v) {
  return isnan(v);
}

template <class V>
__device__ __forceinline__ bool less(V x, V y) {
  return x < y;
}
template <>
__device__ __forceinline__ bool less<double>(double x, double y) {
  return x < y || (x == y && signbit(x) && !signbit(y));
}

template <class V>
__device__ __forceinline__ V pick(bool is_min, V x, V y) {
  return is_min ? (less(y, x) ? y : x) : (less(x, y) ? y : x);
}

template <class V>
__device__ __forceinline__ V extreme_fill(bool is_min);
template <>
__device__ __forceinline__ long long extreme_fill<long long>(bool is_min) {
  return is_min ? 0x7FFFFFFFFFFFFFFFLL : (-0x7FFFFFFFFFFFFFFFLL - 1);
}
template <>
__device__ __forceinline__ double extreme_fill<double>(bool is_min) {
  return is_min ? INFINITY : -INFINITY;
}

struct EndT {
  int pe, ge;
};

// ---- K16 ----------------------------------------------------------------
//
// Two single-pass scans (decoupled look-back), then the store through the
// order by slab (order_scatter.cuh):
//   A. frame_forward, over tiles of kFwdTile positions: each position's
//      partition start ps, peer group start gs and peer heads cnt, and the
//      argument read through the order once (its only read), with its sum
//      P, valid count C and extremum M reset at each partition start; it
//      writes only the arrays a later pass reads (the running sum: P, C).
//   B. frame_reverse, over tiles of kRevTile positions from the end: the
//      partition end pe and the peer group end ge. Where every input of a
//      position's result is at hand (running and ROWS frames, but the
//      table route's min/max), it computes the result in sorted order and
//      hands (order[j], value, valid) to step 1 of the slab store (fuse);
//      else it writes pe and ge, and frame_final (after the table's levels
//      for the table route) computes the results and hands them over.
//   build_image (order_scatter.cuh): each slab of the output and its mask
//      written once.
// A tile takes its id from a counter in launch order, so it waits only on
// tiles already running; it publishes its aggregate (flag 1), then, from
// the tiles before it (warp 0 looks back 32 tiles at a time), its
// inclusive prefix (flag 2).

constexpr int kFwdThreads = 256, kFwdItems = 8;
constexpr long long kFwdTile = (long long)kFwdThreads * kFwdItems;
constexpr int kRevThreads = 512, kRevItems = 16;
constexpr long long kRevTile = (long long)kRevThreads * kRevItems;
constexpr int kAggregate = 1, kInclusive = 2;  // a tile's published flags

// The forward scan's element; without kPos (no position array is read
// back) it drops the partition and peer group fields.
template <class V, bool kPos>
struct FwdT;
template <class V>
struct FwdT<V, true> {
  int ps, gs, cnt;
  int start;       // a partition starts in the range
  V sum;           // the valid values' sum since the last start
  long long count;
  V ext;           // their extremum
};
template <class V>
struct FwdT<V, false> {
  int start, pad;
  V sum;
  long long count;
  V ext;
};

template <class V, bool kPos>
struct FwdOp {
  typedef FwdT<V, kPos> T;
  bool is_min;
  __device__ T identity() const {
    T r;
    if constexpr (kPos) {
      r.ps = r.gs = -1;
      r.cnt = 0;
    } else {
      r.pad = 0;
    }
    r.start = 0;
    r.sum = (V)0;
    r.count = 0;
    r.ext = extreme_fill<V>(is_min);
    return r;
  }
  __device__ T operator()(const T& x, const T& y) const {
    T r;
    if constexpr (kPos) {
      r.ps = x.ps > y.ps ? x.ps : y.ps;
      r.gs = x.gs > y.gs ? x.gs : y.gs;
      r.cnt = x.cnt + y.cnt;
    } else {
      r.pad = 0;
    }
    if (y.start) {
      r.start = 1;
      r.sum = y.sum;
      r.count = y.count;
      r.ext = y.ext;
    } else {
      r.start = x.start;
      r.sum = x.sum + y.sum;
      r.count = x.count + y.count;
      r.ext = pick(is_min, x.ext, y.ext);
    }
    return r;
  }
};

struct RevOp {
  typedef EndT T;
  __device__ T identity() const { return {kBig, kBig}; }
  __device__ T operator()(const T& x, const T& y) const {
    return {x.pe < y.pe ? x.pe : y.pe, x.ge < y.ge ? x.ge : y.ge};
  }
};

template <class T>
__device__ __forceinline__ T shfl_down_t(const T& v, int d) {
  static_assert(sizeof(T) % 4 == 0, "a scan element is whole 32-bit words");
  unsigned w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) w[i] = __shfl_down_sync(0xffffffffu, w[i], d);
  T out;
  memcpy(&out, w, sizeof(T));
  return out;
}

template <class T>
__device__ __forceinline__ T shfl_t(const T& v, int lane) {
  unsigned w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) w[i] = __shfl_sync(0xffffffffu, w[i], lane);
  T out;
  memcpy(&out, w, sizeof(T));
  return out;
}

// A published element, read from L2 (another SM wrote it).
template <class T>
__device__ __forceinline__ T load_published(const T* p) {
  unsigned w[sizeof(T) / 4];
  const unsigned* src = reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) w[i] = __ldcg(src + i);
  T out;
  memcpy(&out, w, sizeof(T));
  return out;
}

// part holds each tile's aggregate, then (from ntiles on) its inclusive
// prefix; flags[t] says which of them tile t has published.
template <class T>
__device__ __forceinline__ void publish(T* part, int* flags, long long ntiles, long long t,
                                        const T& v, int flag) {
  part[(flag == kInclusive ? ntiles : 0) + t] = v;
  __threadfence();
  atomicExch(flags + t, flag);
}

// Warp 0 of tile t's block: the combination of every tile before t, from
// the published aggregates back to the nearest inclusive prefix.
template <class Op>
__device__ typename Op::T look_back(const Op& op, const typename Op::T* part, int* flags,
                                    long long ntiles, long long t) {
  typedef typename Op::T T;
  const int lane = threadIdx.x & 31;
  T excl = op.identity();
  for (long long end = t;; end -= 32) {
    const long long u = end - 1 - lane;  // lane 0 the latest tile of the window
    int f = kInclusive;
    T v = op.identity();
    if (u >= 0) {
      const volatile int* fp = flags + u;
      while ((f = *fp) == 0) {
      }
      __threadfence();
      v = load_published(part + (f == kInclusive ? ntiles : 0) + u);
    }
    const unsigned inclusive = __ballot_sync(0xffffffffu, f == kInclusive);
    const int stop = inclusive != 0 ? __ffs(inclusive) - 1 : 31;
    if (lane > stop) v = op.identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // earlier tiles (higher lanes) first
      const T o = shfl_down_t(v, d);
      if (lane + d < 32) v = op(o, v);
    }
    excl = op(shfl_t(v, 0), excl);
    if (inclusive != 0) return excl;
  }
}

template <class T>
__device__ __forceinline__ T shfl_up_t(const T& v, int d) {
  unsigned w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) w[i] = __shfl_up_sync(0xffffffffu, w[i], d);
  T out;
  memcpy(&out, w, sizeof(T));
  return out;
}

// The exclusive scan of each thread's value in thread order (the
// identity for thread 0), by warp shuffles and one warp over the warps'
// totals; *agg gets the block's total. warp_sh: Threads / 32 elements.
template <int Threads, class Op>
__device__ typename Op::T block_scan(const Op& op, const typename Op::T& v,
                                     typename Op::T* warp_sh, typename Op::T* agg) {
  typedef typename Op::T T;
  constexpr int kWarps = Threads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up_t(x, d);
    if (lane >= d) x = op(y, x);
  }
  if (lane == 31) warp_sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_sh[lane] : op.identity();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const T y = shfl_up_t(w, d);
      if (lane >= d) w = op(y, w);
    }
    if (lane < kWarps) warp_sh[lane] = w;
  }
  __syncthreads();
  T before = shfl_up_t(x, 1);
  if (lane == 0) before = op.identity();
  if (warp > 0) before = op(warp_sh[warp - 1], before);
  *agg = warp_sh[kWarps - 1];
  return before;
}

// A tile's exclusive prefix from its aggregate: tile 0 publishes its
// inclusive prefix at once, the others their aggregate, then look back and
// publish the inclusive prefix. Every thread calls it.
template <class Op>
__device__ typename Op::T tile_prefix(const Op& op, const typename Op::T& agg,
                                      typename Op::T* part, int* flags, long long ntiles,
                                      long long tile, typename Op::T* excl_sh) {
  typedef typename Op::T T;
  if (threadIdx.x < 32) {
    T excl = op.identity();
    if (tile == 0) {
      if (threadIdx.x == 0) publish(part, flags, ntiles, 0, agg, kInclusive);
    } else {
      if (threadIdx.x == 0) publish(part, flags, ntiles, tile, agg, kAggregate);
      excl = look_back(op, part, flags, ntiles, tile);
      if (threadIdx.x == 0) publish(part, flags, ntiles, tile, op(excl, agg), kInclusive);
    }
    if (threadIdx.x == 0) *excl_sh = excl;
  }
  __syncthreads();
  return *excl_sh;
}

// The scratch counts of a call: the forward and reverse tiles and slabs.
// K15's forward scan (rank_forward) takes tiles of kRevTile positions.
struct FrameLayout {
  long long fwd_tiles, rev_tiles;
  int shift, nslabs;
};

__host__ __device__ inline FrameLayout frame_layout(const Args& a) {
  const int shift = slab_shift(8);
  const long long fwd_tile = a.func <= kCumeDist ? kRevTile : kFwdTile;
  return {(a.n + fwd_tile - 1) / fwd_tile, (a.n + kRevTile - 1) / kRevTile, shift,
          (int)slab_count(a.n, shift)};
}

__device__ __forceinline__ SlabOut slab_out(const Args& a, const FrameLayout& l) {
  return {a.n, l.shift, l.nslabs, a.slab_offs, a.slab_vals,
          a.state + 2 + l.fwd_tiles + l.rev_tiles};
}

// The inclusive scan of e across the warp's lanes.
template <class Op>
__device__ __forceinline__ typename Op::T warp_scan(const Op& op, typename Op::T e) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const typename Op::T y = shfl_up_t(e, d);
    if (lane >= d) e = op(y, e);
  }
  return e;
}

// The prefix of every position before warp w's chunk of a warp-striped
// tile (kWarps chunks of 32 * items positions, item k of lane l at
// 32 k + l of its warp's chunk), from each warp's total: the warps'
// totals scanned by warp 0, and the tile's look-back. Every thread calls
// it.
template <int kWarps, class Op>
__device__ typename Op::T chunk_prefix(const Op& op, const typename Op::T& total,
                                       typename Op::T* warp_sh, typename Op::T* excl_sh,
                                       typename Op::T* part, int* flags, long long ntiles,
                                       long long tile) {
  typedef typename Op::T T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sh[warp] = total;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_sh[lane] : op.identity();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const T y = shfl_up_t(w, d);
      if (lane >= d) w = op(y, w);
    }
    if (lane < kWarps) warp_sh[lane] = w;
  }
  __syncthreads();
  T before = tile_prefix(op, warp_sh[kWarps - 1], part, flags, ntiles, tile, excl_sh);
  if (warp > 0) before = op(before, warp_sh[warp - 1]);
  return before;
}

__device__ __forceinline__ unsigned long long bits_of(long long v) {
  return (unsigned long long)v;
}
__device__ __forceinline__ unsigned long long bits_of(double v) {
  return (unsigned long long)__double_as_longlong(v);
}
template <class V>
__device__ __forceinline__ V from_bits(unsigned long long b);
template <>
__device__ __forceinline__ long long from_bits<long long>(unsigned long long b) {
  return (long long)b;
}
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double((long long)b);
}

// The forward scan over tiles of kFwdTile positions, kFwdItems consecutive
// positions a thread (a blocked scan: one combine an item). Its per-position
// outputs go out coalesced, one array a round through a shared-memory
// transpose (a thread's row padded by one entry, off the banks' stride).
template <class V, bool kPos>
__global__ void __launch_bounds__(kFwdThreads) frame_forward(const Args a) {
  typedef FwdT<V, kPos> T;
  constexpr int kRow = kFwdItems + 1;
  __shared__ T warp_sh[kFwdThreads / 32];
  __shared__ T excl_sh;
  __shared__ long long tile_sh;
  __shared__ unsigned long long stage[kFwdThreads * kRow];
  const FwdOp<V, kPos> op{a.func == kMin};
  const FrameLayout l = frame_layout(a);
  if (threadIdx.x == 0) tile_sh = atomicAdd(a.state, 1);
  __syncthreads();
  const long long tile = tile_sh;
  const long long t0 = tile * kFwdTile;
  const long long base = t0 + (long long)threadIdx.x * kFwdItems;
  // each position's heads and value, read once; the argument through the order
  V val[kFwdItems];
  unsigned flag[kFwdItems];  // 1: partition head, 2: peer head, 4: a valid value
  T acc = op.identity();
#pragma unroll
  for (int k = 0; k < kFwdItems; ++k) {
    const long long j = base + k;
    flag[k] = 0;
    val[k] = (V)0;
    if (j >= a.n) continue;
    const bool ph = j == 0 || !same_part(a, j - 1, j);
    const bool gh = kPos && (ph || !same_words(a, j - 1, j));
    bool ok = false;
    if (a.values != nullptr) {
      const long long row = __ldg(a.order + j);
      const V v = __ldg(static_cast<const V*>(a.values) + row);
      ok = (a.vmask == nullptr || __ldg(a.vmask + row) != 0) && !is_nan(v);
      val[k] = ok ? v : (V)0;
    }
    flag[k] = (ph ? 1u : 0u) | (gh ? 2u : 0u) | (ok ? 4u : 0u);
  }
  auto element = [&](long long j, int k) -> T {
    const bool ph = flag[k] & 1u, ok = flag[k] & 4u;
    T e;
    if constexpr (kPos) {
      const bool gh = flag[k] & 2u;
      e.ps = ph ? (int)j : -1;
      e.gs = gh ? (int)j : -1;
      e.cnt = gh ? 1 : 0;
    } else {
      e.pad = 0;
    }
    e.start = ph ? 1 : 0;
    e.sum = val[k];
    e.count = ok ? 1 : 0;
    e.ext = ok ? val[k] : extreme_fill<V>(op.is_min);
    return e;
  };
#pragma unroll
  for (int k = 0; k < kFwdItems; ++k) {
    if (base + k < a.n) acc = op(acc, element(base + k, k));
  }
  T agg;
  const T before = block_scan<kFwdThreads>(op, acc, warp_sh, &agg);
  const T start = op(tile_prefix(op, agg, static_cast<T*>(a.fwd_part), a.state + 2,
                                 l.fwd_tiles, tile, &excl_sh),
                     before);
  // one output array: field(e, v) of each position (its element and its
  // inclusive prefix) staged by thread, then put(j, bits) coalesced
  auto emit = [&](auto field, auto put) {
    T run = start;
#pragma unroll
    for (int k = 0; k < kFwdItems; ++k) {
      if (base + k >= a.n) break;
      const T e = element(base + k, k);
      run = op(run, e);
      stage[threadIdx.x * kRow + k] = field(e, run);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFwdItems; ++k) {
      const int idx = k * kFwdThreads + threadIdx.x;
      if (t0 + idx < a.n) put(t0 + idx, stage[(idx / kFwdItems) * kRow + idx % kFwdItems]);
    }
    __syncthreads();
  };
  if constexpr (kPos) {
    if (a.ps != nullptr)
      emit([](const T&, const T& v) { return (unsigned long long)v.ps; },
           [&](long long j, unsigned long long b) { a.ps[j] = (int)b; });
    if (a.gs != nullptr)
      emit([](const T&, const T& v) { return (unsigned long long)v.gs; },
           [&](long long j, unsigned long long b) { a.gs[j] = (int)b; });
    if (a.cnt != nullptr)
      emit([](const T& e, const T& v) { return (unsigned long long)v.cnt | (e.gs >= 0 ? 1ULL << 32 : 0); },
           [&](long long j, unsigned long long b) {
             a.cnt[j] = (int)(b & 0xFFFFFFFFu);
             if (a.gstart != nullptr && (b >> 32)) a.gstart[(int)(b & 0xFFFFFFFFu) - 1] = (int)j;
           });
    if (a.skv != nullptr) {  // RANGE's key, read through the order
#pragma unroll
      for (int k = 0; k < kFwdItems; ++k) {
        const long long j = t0 + k * kFwdThreads + threadIdx.x;
        if (j >= a.n) break;
        const long long row = __ldg(a.order + j);
        const double kv = __ldg(a.key + row);
        const bool null = (a.kmask != nullptr && __ldg(a.kmask + row) == 0) || isnan(kv);
        a.skv[j] = null ? 0.0 : (a.key_desc ? -kv : kv);
        a.snull[j] = null;
      }
    }
  }
  if (a.P != nullptr)
    emit([](const T&, const T& v) { return bits_of(v.sum); },
         [&](long long j, unsigned long long b) { static_cast<V*>(a.P)[j] = from_bits<V>(b); });
  if (a.C != nullptr)
    emit([](const T&, const T& v) { return (unsigned long long)v.count; },
         [&](long long j, unsigned long long b) { a.C[j] = (long long)b; });
  if (a.M != nullptr)
    emit([](const T&, const T& v) { return bits_of(v.ext); },
         [&](long long j, unsigned long long b) { static_cast<V*>(a.M)[j] = from_bits<V>(b); });
  if (a.sv != nullptr)
    emit([](const T& e, const T&) { return bits_of(e.sum) ; },
         [&](long long j, unsigned long long b) {
           static_cast<V*>(a.sv)[j] = from_bits<V>(b);
         });
  if (a.sm != nullptr)
    emit([](const T& e, const T&) { return (unsigned long long)(e.count != 0); },
         [&](long long j, unsigned long long b) { a.sm[j] = (uint8_t)b; });
}

// The first position k in [lo, hi) with skv[k] >= t (upper: > t).
__device__ long long search(const double* skv, long long lo, long long hi, double t, bool upper) {
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    const double m = skv[mid];
    if (upper ? m <= t : m < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A position's partition and peer group bounds, from registers or arrays
// (gs and ge only where a GROUPS or RANGE bound reads them).
struct Pos {
  long long ps, pe, gs, ge;
};

// One bound of position j's frame (is_start: its first position, else its
// last), before the clamp to the partition. kOwn: a running or ROWS frame,
// whose bounds are the position's own (the fused reverse pass).
template <bool kOwn>
__device__ __forceinline__ long long frame_bound(const Args& a, long long j, const Pos& q,
                                                 bool is_start) {
  const int kind = (int)(is_start ? a.lo_kind : a.hi_kind);
  const double nv = is_start ? a.lo_n : a.hi_n;
  if (kind == kUp) return q.ps;
  if (kind == kUf) return q.pe;
  if (a.unit == kRows) {
    if (kind == kCur) return j;
    return kind == kFol ? j + (long long)nv : j - (long long)nv;
  }
  if constexpr (kOwn) return j;  // not reached: the fused frames are running or ROWS
  if (kind == kCur) return is_start ? q.gs : q.ge;
  if (a.unit == kGroups) {
    const long long g = (long long)a.cnt[j] - 1;
    const long long tg = kind == kFol ? g + (long long)nv : g - (long long)nv;
    const long long first = (long long)a.cnt[q.ps] - 1, last = (long long)a.cnt[q.pe] - 1;
    if (is_start) {
      if (tg < first) return q.ps;
      if (tg > last) return q.pe + 1;
      return a.gstart[tg];
    }
    if (tg > last) return q.pe;
    if (tg < first) return q.ps - 1;
    return a.gend[tg];
  }
  // RANGE by the one key's value: a null key's bound is its peer group's
  if (a.snull[j]) return is_start ? q.gs : q.ge;
  const double t = a.skv[j] + (kind == kFol ? nv : -nv);
  // the partition's non-null span: nulls are one peer group at one end
  const long long s0 = a.snull[q.ps] ? (long long)a.ge[q.ps] + 1 : q.ps;
  const long long s1 = a.snull[q.pe] ? (long long)a.gs[q.pe] - 1 : q.pe;
  if (is_start) return search(a.skv, s0, s1 + 1, t, false);
  return search(a.skv, s0, s1 + 1, t, true) - 1;
}

template <bool kOwn>
__device__ __forceinline__ void frame_of(const Args& a, long long j, const Pos& q, long long* lo,
                                         long long* hi) {
  if (!is_real(a, j)) {  // a row that is not real: an empty frame, so that
    *lo = j + 1;         // no table level is sized by it
    *hi = j;
    return;
  }
  if (a.unit == kRunning) {  // peers share their group's last row
    *lo = q.ps;
    *hi = q.ge;
    return;
  }
  const long long s = frame_bound<kOwn>(a, j, q, true), e = frame_bound<kOwn>(a, j, q, false);
  *lo = s > q.ps ? s : q.ps;
  *hi = e < q.pe ? e : q.pe;
}

__device__ __forceinline__ Pos pos_of(const Args& a, long long j) {
  return {a.ps[j], a.pe[j], a.gs[j], a.ge[j]};
}

// The table route's first stage: every position's frame, and the longest.
__global__ void __launch_bounds__(kThreads) frame_bounds(const Args a) {
  const long long stride = (long long)gridDim.x * kThreads;
  int longest = 0;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < a.n; j += stride) {
    long long lo, hi;
    frame_of<false>(a, j, pos_of(a, j), &lo, &hi);
    a.lo[j] = (int)lo;
    a.hi[j] = (int)hi;
    const long long len = hi - lo + 1;
    if (len > longest) longest = (int)len;
  }
  if (longest > 0) atomicMax(a.maxlen, longest);
}

// Level k of the sparse table: the extremum over [j, j + 2^k - 1].
template <class V>
__global__ void __launch_bounds__(kThreads) table_level(const Args a) {
  const bool is_min = a.func == kMin;
  V* levels = static_cast<V*>(a.levels);
  const long long n = a.n, k = a.level;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < n; j += stride) {
    if (k == 0) {
      levels[j] = a.sm[j] ? static_cast<const V*>(a.sv)[j] : extreme_fill<V>(is_min);
      continue;
    }
    const V* prev = levels + (k - 1) * n;
    const long long h = 1LL << (k - 1);
    levels[k * n + j] = j + h < n ? pick(is_min, prev[j], prev[j + h]) : prev[j];
  }
}

// Sorted position j's result, as the 8 bytes of its output (0 where not
// valid), and whether it is valid (the output's mask). kFused: in the
// reverse pass, where the frame is running or ROWS and no table is read.
// kDivide: the function is avg, whose float64 division (a call to its slow
// path) is compiled only into the kernels that take avg, so that the
// others keep their registers.
template <class V, bool kFused, bool kDivide>
__device__ __forceinline__ bool frame_result(const Args& a, long long j, const Pos& q,
                                             unsigned long long* bits) {
  const int fn = (int)a.func;
  const V* sv = static_cast<const V*>(a.sv);
  if (fn == kLag || fn == kLead) {
    const long long src = fn == kLag ? j - a.param : j + a.param;
    V v;
    bool valid;
    if (src >= q.ps && src <= q.pe) {
      v = sv[src];
      valid = a.sm[src] != 0;
    } else {
      v = a.is_float ? (V)a.default_f : (V)a.default_i;
      valid = a.has_default != 0;
    }
    *bits = bits_of(valid ? v : (V)0);
    return valid;
  }
  long long lo, hi;
  if (!kFused && a.stage == 2) {
    lo = a.lo[j];
    hi = a.hi[j];
  } else {
    frame_of<kFused>(a, j, q, &lo, &hi);
  }
  const bool empty = lo > hi;
  if (fn == kFirst || fn == kLast || fn == kNth) {
    const long long at = fn == kFirst ? lo : (fn == kLast ? hi : lo + a.param - 1);
    const bool valid = !(empty || at > hi) && a.sm[at] != 0;
    *bits = bits_of(valid ? sv[at] : (V)0);
    return valid;
  }
  if (fn == kCountStar) {
    *bits = (unsigned long long)(empty ? 0 : hi - lo + 1);
    return true;
  }
  // count, sum, avg, min, max over the valid values of [lo, hi]
  const bool is_min = fn == kMin;
  long long count = 0;
  V sum = 0, ext = extreme_fill<V>(is_min);
  if (!empty) {
    if (a.agg_route == kLoop) {
      for (long long k = lo; k <= hi; ++k) {
        if (!a.sm[k]) continue;
        ++count;
        sum += sv[k];
        ext = pick(is_min, ext, sv[k]);
      }
    } else {
      count = a.C[hi] - (lo > q.ps ? a.C[lo - 1] : 0);
      if (fn == kSum || fn == kAvg) {
        const V* P = static_cast<const V*>(a.P);
        sum = lo > q.ps ? P[hi] - P[lo - 1] : P[hi];
      } else if (fn == kMin || fn == kMax) {
        if (kFused || a.agg_route == kPrefix) {
          ext = static_cast<const V*>(a.M)[hi];
        } else {
          const long long len = hi - lo + 1;
          int k = 0;
          while ((2LL << k) <= len) ++k;
          const V* lvl = static_cast<const V*>(a.levels) + (long long)k * a.n;
          ext = pick(is_min, lvl[lo], lvl[hi - (1LL << k) + 1]);
        }
      }
    }
  }
  if (fn == kCount) {
    *bits = (unsigned long long)count;
    return true;
  }
  if constexpr (kDivide) {
    *bits = bits_of(count > 0 ? (double)sum / (double)count : 0.0);
    return count > 0;
  }
  *bits = bits_of(count > 0 ? (fn == kSum ? sum : ext) : (V)0);
  return count > 0;
}

// K16's result in the fused reverse pass.
template <class V, bool kDivide>
struct FrameResult {
  __device__ static bool of(const Args& a, long long j, const Pos& q, unsigned long long* bits) {
    return frame_result<V, true, kDivide>(a, j, q, bits);
  }
};

// The results of a tile, computed in a rolled loop (one copy of
// frame_result's code) into step 1's staging area, which is free until its
// decisions are taken; step 1 then reads them from there.
struct Results {
  unsigned long long* bits;  // [kRevTile]
  unsigned* rows;            // [kRevTile]: row | valid << 31, kNoRow where none
};
constexpr unsigned kNoRow = ~kValidBit;

__device__ __forceinline__ Results results_in(uint4* smem) {
  unsigned long long* bits = reinterpret_cast<unsigned long long*>(smem);
  return {bits, reinterpret_cast<unsigned*>(bits + kRevTile)};
}

// Step 1 over a tile's results (any arrangement: item k of thread t reads
// slot k * kRevThreads + t).
__device__ __forceinline__ void scatter_results(const SlabOut& so, const Results& res,
                                                uint4* smem) {
  scatter_tile<kRevThreads, kRevItems, unsigned long long>(
      so,
      [&](int k, unsigned long long& v, bool& ok) -> int {
        const int idx = k * kRevThreads + threadIdx.x;
        const unsigned r = res.rows[idx];
        if (r == kNoRow) return -1;
        v = res.bits[idx];
        ok = (r & kValidBit) != 0;
        return (int)(r & ~kValidBit);
      },
      reinterpret_cast<unsigned char*>(smem));
}

// The reverse scan, warp-striped (see chunk_prefix; r = n - 1 - j). Where
// fused, each position's result (R::of: K16's FrameResult, K15's
// RankResult) is computed as the second row-by-row scan gives its ends,
// and the tile's results go to step 1.
template <bool kFuse, class R>
__global__ void __launch_bounds__(kRevThreads, 2) frame_reverse(const Args a) {
  typedef EndT T;
  __shared__ T warp_sh[kRevThreads / 32];
  __shared__ T excl_sh;
  __shared__ long long tile_sh;
  extern __shared__ uint4 reverse_smem[];  // step 1's, where fused
  const RevOp op;
  const FrameLayout l = frame_layout(a);
  if (threadIdx.x == 0) tile_sh = atomicAdd(a.state + 1, 1);
  __syncthreads();
  const long long tile = tile_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = warp * 32 * kRevItems + lane;  // the lane's first slot in the tile
  const long long chunk = tile * kRevTile + first;
  // two bits an item: 1 a partition end, 2 a peer group end
  unsigned ends = 0;
#pragma unroll
  for (int k = 0; k < kRevItems; ++k) {
    const long long r = chunk + 32 * k;
    if (r >= a.n) continue;
    const long long j = a.n - 1 - r;
    const bool pend = j == a.n - 1 || !same_part(a, j, j + 1);
    const bool gend = pend || !same_words(a, j, j + 1);
    ends |= ((pend ? 1u : 0u) | (gend ? 2u : 0u)) << (2 * k);
  }
  auto element = [&](long long r, int k) -> T {
    if (r >= a.n) return op.identity();
    const int j = (int)(a.n - 1 - r);
    const unsigned h = ends >> (2 * k);
    return {h & 1u ? j : kBig, h & 2u ? j : kBig};
  };
  T total = op.identity();
#pragma unroll
  for (int k = 0; k < kRevItems; ++k)
    total = op(total, shfl_t(warp_scan(op, element(chunk + 32 * k, k)), 31));
  T run = chunk_prefix<kRevThreads / 32>(op, total, warp_sh, &excl_sh,
                                         static_cast<T*>(a.rev_part), a.state + 2 + l.fwd_tiles,
                                         l.rev_tiles, tile);
  const Results res = results_in(reverse_smem);
#pragma unroll 1
  for (int k = 0; k < kRevItems; ++k) {
    const long long r = chunk + 32 * k;
    const T x = warp_scan(op, element(r, k));
    const T v = op(run, x);
    run = op(run, shfl_t(x, 31));
    if constexpr (kFuse) {
      const int slot = first + 32 * k;
      res.rows[slot] = kNoRow;
      if (r >= a.n) continue;
      const long long j = a.n - 1 - r;
      const Pos q = {a.ps != nullptr ? a.ps[j] : -1, v.pe, a.gs != nullptr ? a.gs[j] : -1, v.ge};
      unsigned long long bits;
      const bool ok = R::of(a, j, q, &bits);
      res.bits[slot] = bits;
      res.rows[slot] = (unsigned)__ldg(a.order + j) | (ok ? kValidBit : 0u);
    } else {
      if (r >= a.n) continue;
      const long long j = a.n - 1 - r;
      a.pe[j] = v.pe;
      a.ge[j] = v.ge;
      if (a.gend != nullptr && v.ge == (int)j) a.gend[a.cnt[j] - 1] = (int)j;
    }
  }
  if constexpr (kFuse) {
    __syncthreads();
    scatter_results(slab_out(a, l), res, reverse_smem);
  }
}

// The results of the frames that read other positions' bounds (GROUPS,
// RANGE) or the table's levels, in sorted order, handed to step 1.
template <class V, bool kDivide>
__global__ void __launch_bounds__(kRevThreads, 2) frame_final(const Args a) {
  extern __shared__ uint4 final_smem[];
  const FrameLayout l = frame_layout(a);
  const long long t0 = (long long)blockIdx.x * kRevTile;
  const Results res = results_in(final_smem);
#pragma unroll 1
  for (int k = 0; k < kRevItems; ++k) {
    const int slot = k * kRevThreads + threadIdx.x;
    const long long j = t0 + slot;
    res.rows[slot] = kNoRow;
    if (j >= a.n) continue;
    unsigned long long bits;
    const bool ok = frame_result<V, false, kDivide>(a, j, pos_of(a, j), &bits);
    res.bits[slot] = bits;
    res.rows[slot] = (unsigned)__ldg(a.order + j) | (ok ? kValidBit : 0u);
  }
  __syncthreads();
  scatter_results(slab_out(a, l), res, final_smem);
}

// ---- K15 ----------------------------------------------------------------
//
// rank_forward: the forward scan over warp-striped tiles of kRevTile
// positions (frame_reverse's layout, forward), with decoupled look-back.
// Its element: the last partition and peer group starts, and the peer
// heads since the last partition start (dense_rank), reset there. Where
// kFinal (row_number, rank, dense_rank), each result goes to step 1; else
// it writes ps (and gs for percent_rank) for frame_reverse<true,
// RankResult>.

struct RankT {
  int ps, gs, dr, start;
};

struct RankOp {
  typedef RankT T;
  __device__ T identity() const { return {-1, -1, 0, 0}; }
  __device__ T operator()(const T& x, const T& y) const {
    return {x.ps > y.ps ? x.ps : y.ps, x.gs > y.gs ? x.gs : y.gs, y.start ? y.dr : x.dr + y.dr,
            x.start | y.start};
  }
};

// Sorted position j's rank as the 8 bytes of the output, from its
// partition's start ps and end pe, its peer group's start gs and end ge
// and its dense rank dr (each where the function reads it).
__device__ __forceinline__ unsigned long long rank_bits(const Args& a, long long j, long long ps,
                                                        long long pe, long long gs, long long ge,
                                                        long long dr) {
  const long long local = j - ps, psize = pe - ps + 1;
  switch ((int)a.func) {
    case kRowNumber:
      return (unsigned long long)(local + 1);
    case kRank:
      return (unsigned long long)(gs - ps + 1);
    case kDenseRank:
      return (unsigned long long)dr;
    case kNtile: {
      // the first psize % n buckets take one row more (:1570-1577)
      const long long q = psize / a.param, rem = psize % a.param;
      const long long cutoff = rem * (q + 1);
      return (unsigned long long)(local < cutoff ? local / (q + 1) + 1
                                                 : rem + (local - cutoff) / (q > 1 ? q : 1) + 1);
    }
    case kPercentRank:
      return bits_of(psize > 1 ? (double)(gs - ps) / (double)(psize - 1) : 0.0);
    default:  // kCumeDist: peers share their group's last position
      return bits_of((double)(ge - ps + 1) / (double)psize);
  }
}

struct RankResult {
  __device__ static bool of(const Args& a, long long j, const Pos& q, unsigned long long* bits) {
    *bits = rank_bits(a, j, q.ps, q.pe, q.gs, q.ge, 0);
    return true;
  }
};

template <bool kFinal>
__global__ void __launch_bounds__(kRevThreads, 2) rank_forward(const Args a) {
  typedef RankT T;
  __shared__ T warp_sh[kRevThreads / 32];
  __shared__ T excl_sh;
  __shared__ long long tile_sh;
  extern __shared__ uint4 rank_smem[];  // step 1's, where final
  const RankOp op;
  const FrameLayout l = frame_layout(a);
  if (threadIdx.x == 0) tile_sh = atomicAdd(a.state, 1);
  __syncthreads();
  const long long tile = tile_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = warp * 32 * kRevItems + lane;  // the lane's first slot in the tile
  const long long chunk = tile * kRevTile + first;
  // two bits an item: 1 a partition head, 2 a peer group head
  unsigned heads = 0;
#pragma unroll
  for (int k = 0; k < kRevItems; ++k) {
    const long long j = chunk + 32 * k;
    if (j >= a.n) continue;
    const bool ph = j == 0 || !same_part(a, j - 1, j);
    const bool gh = ph || !same_words(a, j - 1, j);
    heads |= ((ph ? 1u : 0u) | (gh ? 2u : 0u)) << (2 * k);
  }
  auto element = [&](long long j, int k) -> T {
    if (j >= a.n) return op.identity();
    const unsigned h = heads >> (2 * k);
    return {h & 1u ? (int)j : -1, h & 2u ? (int)j : -1, h & 2u ? 1 : 0, (int)(h & 1u)};
  };
  T total = op.identity();
#pragma unroll
  for (int k = 0; k < kRevItems; ++k)
    total = op(total, shfl_t(warp_scan(op, element(chunk + 32 * k, k)), 31));
  T run = chunk_prefix<kRevThreads / 32>(op, total, warp_sh, &excl_sh,
                                         static_cast<T*>(a.fwd_part), a.state + 2, l.fwd_tiles,
                                         tile);
  const Results res = results_in(rank_smem);
#pragma unroll 1
  for (int k = 0; k < kRevItems; ++k) {
    const long long j = chunk + 32 * k;
    const T x = warp_scan(op, element(j, k));
    const T v = op(run, x);
    run = op(run, shfl_t(x, 31));
    if constexpr (kFinal) {
      const int slot = first + 32 * k;
      res.rows[slot] = kNoRow;
      if (j >= a.n) continue;
      res.bits[slot] = rank_bits(a, j, v.ps, -1, v.gs, -1, v.dr);
      res.rows[slot] = (unsigned)__ldg(a.order + j) | kValidBit;
    } else {
      if (j >= a.n) continue;
      a.ps[j] = v.ps;
      if (a.gs != nullptr) a.gs[j] = v.gs;
    }
  }
  if constexpr (kFinal) {
    __syncthreads();
    scatter_results(slab_out(a, l), res, rank_smem);
  }
}

cudaError_t launch_rows(void (*kernel)(Args), const Args& a, int device, cudaStream_t st) {
  return launch_wave(kernel, a.n, kThreads, device, st, a);
}

// A launch of kernel over `grid` blocks of kRevThreads with step 1's
// shared memory.
template <auto Kernel>
cudaError_t launch_step1(const Args& a, long long grid, int nslabs, int device,
                         cudaStream_t st) {
  const int smem = scatter_smem<kRevThreads, kRevItems, unsigned long long>(nslabs);
  const cudaError_t err = allow_smem<Kernel>(device, smem);
  if (err != cudaSuccess) return err;
  return launch_cluster(Kernel, grid, kRevThreads, 1, smem, st, a);
}

// The call's one memset: the scans' tile counters and flags, the buckets'
// counts.
cudaError_t clear_state(const Args& a, const FrameLayout& l, cudaStream_t st) {
  return cudaMemsetAsync(a.state, 0,
                         sizeof(int) * (2 + l.fwd_tiles + l.rev_tiles + (long long)l.nslabs), st);
}

// Step 2, after step 1 has filled the buckets: each slab of the output
// (and its mask) written once.
cudaError_t build_out(const Args& a, const FrameLayout& l, int device, cudaStream_t st) {
  const ImageParams ip = {a.n, l.shift, l.nslabs, a.slab_offs, a.slab_vals,
                          a.state + 2 + l.fwd_tiles + l.rev_tiles, a.out, a.outm};
  return a.outm != nullptr ? build_image<unsigned long long, true>(ip, device, st)
                           : build_image<unsigned long long, false>(ip, device, st);
}

cudaError_t run_rank(const Args& a, int device, cudaStream_t st) {
  const FrameLayout l = frame_layout(a);
  const bool forward_only = a.func <= kDenseRank;
  cudaError_t err = clear_state(a, l, st);
  if (err == cudaSuccess)
    err = forward_only ? launch_step1<rank_forward<true>>(a, l.fwd_tiles, l.nslabs, device, st)
                       : launch_params(rank_forward<false>, l.fwd_tiles, kRevThreads, st, a);
  if (err == cudaSuccess && !forward_only)
    err = launch_step1<frame_reverse<true, RankResult>>(a, l.rev_tiles, l.nslabs, device, st);
  if (err != cudaSuccess) return err;
  return build_out(a, l, device, st);
}

template <class V>
cudaError_t run_frame(const Args& a, int device, cudaStream_t st) {
  const FrameLayout l = frame_layout(a);
  cudaError_t err;
  if (a.stage != 2) {
    err = clear_state(a, l, st);
    const bool pos = a.ps != nullptr || a.gs != nullptr || a.cnt != nullptr;
    if (err == cudaSuccess)
      err = pos ? launch_params(frame_forward<V, true>, l.fwd_tiles, kFwdThreads, st, a)
                : launch_params(frame_forward<V, false>, l.fwd_tiles, kFwdThreads, st, a);
    if (err != cudaSuccess) return err;
    if (a.fuse) {
      err = a.func == kAvg
                ? launch_step1<frame_reverse<true, FrameResult<V, true>>>(a, l.rev_tiles,
                                                                          l.nslabs, device, st)
                : launch_step1<frame_reverse<true, FrameResult<V, false>>>(a, l.rev_tiles,
                                                                           l.nslabs, device, st);
    } else {
      err = launch_params(frame_reverse<false, FrameResult<long long, false>>, l.rev_tiles,
                          kRevThreads, st, a);
      if (err == cudaSuccess && a.stage == 1) return launch_rows(frame_bounds, a, device, st);
    }
    if (err != cudaSuccess) return err;
  } else {
    for (long long k = 0; k < a.nlevels; ++k) {
      Args b = a;
      b.level = k;
      err = launch_rows(table_level<V>, b, device, st);
      if (err != cudaSuccess) return err;
    }
  }
  if (!a.fuse) {
    err = a.func == kAvg ? launch_step1<frame_final<V, true>>(a, l.rev_tiles, l.nslabs, device, st)
                         : launch_step1<frame_final<V, false>>(a, l.rev_tiles, l.nslabs, device, st);
    if (err != cudaSuccess) return err;
  }
  return build_out(a, l, device, st);
}

bool bad_words(const Args* a) {
  if (a == nullptr || a->n < 1 || a->n >= kBig || a->nwords < 1 || a->nwords > kMaxWords)
    return true;
  for (int w = 0; w < a->nwords; ++w) {
    if (a->words[w] == nullptr) return true;
  }
  return a->order == nullptr || a->out == nullptr;
}

// The scans' and the slab store's scratch.
bool bad_scratch(const Args* a) {
  return bad_words(a) || a->state == nullptr || a->fwd_part == nullptr ||
         a->rev_part == nullptr || a->slab_offs == nullptr || a->slab_vals == nullptr ||
         reinterpret_cast<uintptr_t>(a->out) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(a->outm) % 16 != 0;
}

bool bad_rank_args(const Args* a) {
  if (bad_scratch(a) || a->func < kRowNumber || a->func > kCumeDist ||
      (a->func == kNtile && a->param < 1) || a->outm != nullptr)
    return true;
  // the reverse pass reads ps (percent_rank also gs) from the forward scan
  return (a->func > kDenseRank && a->ps == nullptr) || (a->func == kPercentRank && a->gs == nullptr);
}

bool bad_frame_args(const Args* a) {
  if (bad_scratch(a)) return true;
  // the final pass reads every position's bounds
  return !a->fuse && (a->ps == nullptr || a->pe == nullptr || a->gs == nullptr ||
                      a->ge == nullptr || a->cnt == nullptr);
}

}  // namespace

// K15. Returns a cudaError_t; *launched is 1 where the kernels were
// launched.
extern "C" int fugue_window_rank(const WindowArgs* a, int device, void* stream, int* launched) {
  *launched = 0;
  if (bad_rank_args(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&] { return run_rank(*a, device, st); });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// K16, in stage 0 (all), 1 (up to the table route's bounds and longest
// frame) or 2 (the table route's levels and output). Returns a
// cudaError_t; *launched is 1 where the kernels were launched.
extern "C" int fugue_window_frame(const WindowArgs* a, int device, void* stream, int* launched) {
  *launched = 0;
  if (bad_frame_args(a) || a->func < kCount || a->func > kNth || a->stage < 0 || a->stage > 2 ||
      (a->func != kCountStar && a->values == nullptr) || (a->fuse && a->stage != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&] {
    return a->is_float ? run_frame<double>(*a, device, st) : run_frame<long long>(*a, device, st);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The scratch shapes: out[0] and out[1] K16's forward and the reverse
// tiles' positions, out[2] and out[3] their scan elements' bytes, out[4]
// the log2 of a slab's rows, out[5] and out[6] K15's forward tiles'
// positions and scan element's bytes.
extern "C" void fugue_window_frame_layout(long long* out) {
  out[0] = kFwdTile;
  out[1] = kRevTile;
  out[2] = (long long)(sizeof(FwdT<double, true>) > sizeof(FwdT<long long, true>)
                           ? sizeof(FwdT<double, true>)
                           : sizeof(FwdT<long long, true>));
  out[3] = (long long)sizeof(EndT);
  out[4] = slab_shift(8);
  out[5] = kRevTile;
  out[6] = (long long)sizeof(RankT);
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* fugue_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
