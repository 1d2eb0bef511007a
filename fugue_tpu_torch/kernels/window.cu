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
// adjacent sorted codes (:1580-1590). Each output is written straight into
// row order, out[order[j]], where the JAX program scatters (:1633-1641).
//
// The positions of a partition and of a peer group are segmented scans
// (the JAX program's cummax and reversed cummin). Each scan is three
// launches: every block reduces its tile of kTile positions, one block
// scans the tiles' aggregates into each tile's carry, and every block
// scans its tile again from its carry and stores. A forward scan gives
// each position its partition start ps, its peer group's start gs and the
// peer heads up to it (cnt, dense_rank's and GROUPS' group ids); a reverse
// scan the partition end pe and the peer group's end ge. K16 adds a
// forward scan of the argument, reset at each partition start: its sum P
// (int64 for integer arguments, float64 for the rest), the count C of its
// valid values and, for a min/max whose frame starts at the partition
// start, its running extremum M; it also stores the sorted argument sv/sm
// that positional functions and loops read.
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
// What bounds them on an H100: each position reads its order entry and
// its words twice (their neighbours are in cache), the scans write 4 B an
// array a position, and the final launch reads them and scatters its
// output through the order, a random 8-16 B store a row. The argument is
// read through the order, a random 8 B read a row. This first version is
// simple and right; it keeps every per-position array in device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

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
  void* agg;              // scan scratch: a tile's aggregate, then its carry
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
};

namespace {

using namespace fugue;
using Args = WindowArgs;

constexpr int kThreads = 256;
constexpr int kItems = 8;  // positions a thread in a scan
constexpr long long kTile = (long long)kThreads * kItems;
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

// ---- the scans ----------------------------------------------------------

struct PosT {
  int ps, gs, cnt;
};

// ps: the last partition start at or before j; gs: the last peer group
// start; cnt: the peer group starts up to j.
struct FwdPos {
  typedef PosT T;
  __device__ static T identity(const Args&) { return {-1, -1, 0}; }
  __device__ static T combine(const Args&, const T& x, const T& y) {
    return {x.ps > y.ps ? x.ps : y.ps, x.gs > y.gs ? x.gs : y.gs, x.cnt + y.cnt};
  }
  __device__ static T load(const Args& a, long long j) {
    const bool ph = j == 0 || !same_part(a, j - 1, j);
    const bool gh = ph || !same_words(a, j - 1, j);
    return {ph ? (int)j : -1, gh ? (int)j : -1, gh ? 1 : 0};
  }
  __device__ static void store(const Args& a, long long j, const T& e, const T& v) {
    a.ps[j] = v.ps;
    a.gs[j] = v.gs;
    a.cnt[j] = v.cnt;
    if (a.gstart != nullptr && e.gs >= 0) a.gstart[v.cnt - 1] = (int)j;
    if (a.skv != nullptr) {
      const long long row = __ldg(a.order + j);
      const double k = __ldg(a.key + row);
      const bool null = (a.kmask != nullptr && __ldg(a.kmask + row) == 0) || isnan(k);
      a.skv[j] = null ? 0.0 : (a.key_desc ? -k : k);
      a.snull[j] = null;
    }
  }
};

struct EndT {
  int pe, ge;
};

// Scanned from the last position down (index r is position n - 1 - r):
// pe, the first partition end at or after j; ge, the first peer group end.
struct RevPos {
  typedef EndT T;
  __device__ static T identity(const Args&) { return {kBig, kBig}; }
  __device__ static T combine(const Args&, const T& x, const T& y) {
    return {x.pe < y.pe ? x.pe : y.pe, x.ge < y.ge ? x.ge : y.ge};
  }
  __device__ static T load(const Args& a, long long r) {
    const long long j = a.n - 1 - r;
    const bool pend = j == a.n - 1 || !same_part(a, j, j + 1);
    const bool gend = pend || !same_words(a, j, j + 1);
    return {pend ? (int)j : kBig, gend ? (int)j : kBig};
  }
  __device__ static void store(const Args& a, long long r, const T& e, const T& v) {
    const long long j = a.n - 1 - r;
    a.pe[j] = v.pe;
    a.ge[j] = v.ge;
    if (a.gend != nullptr && e.ge < kBig) a.gend[a.cnt[j] - 1] = (int)j;
  }
};

template <class V>
struct ValT {
  int start;   // a partition starts in the range
  V sum;       // the valid values' sum since the last start
  long long count;
  V ext;       // their extremum
};

// The argument in sorted order, its sum, count and extremum reset at each
// partition start. Loaded, an element holds the value (0 where not valid)
// and 1 or 0 as its count.
template <class V>
struct FwdVal {
  typedef ValT<V> T;
  __device__ static bool is_min(const Args& a) { return a.func == kMin; }
  __device__ static T identity(const Args& a) { return {0, (V)0, 0, extreme_fill<V>(is_min(a))}; }
  __device__ static T combine(const Args& a, const T& x, const T& y) {
    if (y.start) return y;
    return {x.start, x.sum + y.sum, x.count + y.count, pick(is_min(a), x.ext, y.ext)};
  }
  __device__ static T load(const Args& a, long long j) {
    const bool ph = j == 0 || !same_part(a, j - 1, j);
    const long long row = __ldg(a.order + j);
    const V v = __ldg(static_cast<const V*>(a.values) + row);
    const bool ok = (a.vmask == nullptr || __ldg(a.vmask + row) != 0) && !is_nan(v);
    return {ph ? 1 : 0, ok ? v : (V)0, ok ? 1 : 0, ok ? v : extreme_fill<V>(is_min(a))};
  }
  __device__ static void store(const Args& a, long long j, const T& e, const T& v) {
    if (a.P != nullptr) static_cast<V*>(a.P)[j] = v.sum;
    if (a.C != nullptr) a.C[j] = v.count;
    if (a.M != nullptr) static_cast<V*>(a.M)[j] = v.ext;
    if (a.sv != nullptr) {
      static_cast<V*>(a.sv)[j] = e.sum;
      a.sm[j] = e.count != 0;
    }
  }
};

// The inclusive scan of each thread's value in thread order; sh holds
// every thread's on return.
template <class Op>
__device__ typename Op::T block_inclusive(const Args& a, typename Op::T v, typename Op::T* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    const typename Op::T prev = sh[t >= d ? t - d : 0];
    __syncthreads();
    if (t >= d) {
      v = Op::combine(a, prev, v);
      sh[t] = v;
    }
    __syncthreads();
  }
  return v;
}

template <class Op>
__global__ void __launch_bounds__(kThreads) scan_reduce(const Args a) {
  typedef typename Op::T T;
  __shared__ T sh[kThreads];
  const long long base = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  T acc = Op::identity(a);
  for (int k = 0; k < kItems; ++k) {
    if (base + k < a.n) acc = Op::combine(a, acc, Op::load(a, base + k));
  }
  acc = block_inclusive<Op>(a, acc, sh);
  if (threadIdx.x == kThreads - 1) static_cast<T*>(a.agg)[blockIdx.x] = acc;
}

// One block: each tile's aggregate becomes the tiles' exclusive scan
// before it, its carry.
template <class Op>
__global__ void __launch_bounds__(kThreads) scan_carry(const Args a) {
  typedef typename Op::T T;
  __shared__ T sh[kThreads];
  T* agg = static_cast<T*>(a.agg);
  const long long ntiles = (a.n + kTile - 1) / kTile;
  const long long chunk = (ntiles + kThreads - 1) / kThreads;
  const long long b0 = (long long)threadIdx.x * chunk;
  const long long b1 = b0 + chunk < ntiles ? b0 + chunk : ntiles;
  T acc = Op::identity(a);
  for (long long b = b0; b < b1; ++b) acc = Op::combine(a, acc, agg[b]);
  block_inclusive<Op>(a, acc, sh);
  T run = threadIdx.x > 0 ? sh[threadIdx.x - 1] : Op::identity(a);
  for (long long b = b0; b < b1; ++b) {
    const T x = agg[b];
    agg[b] = run;
    run = Op::combine(a, run, x);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads) scan_apply(const Args a) {
  typedef typename Op::T T;
  __shared__ T sh[kThreads];
  const long long base = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  T items[kItems];
  T acc = Op::identity(a);
  for (int k = 0; k < kItems; ++k) {
    items[k] = base + k < a.n ? Op::load(a, base + k) : Op::identity(a);
    acc = Op::combine(a, acc, items[k]);
  }
  block_inclusive<Op>(a, acc, sh);
  T run = static_cast<const T*>(a.agg)[blockIdx.x];
  if (threadIdx.x > 0) run = Op::combine(a, run, sh[threadIdx.x - 1]);
  for (int k = 0; k < kItems; ++k) {
    if (base + k >= a.n) break;
    run = Op::combine(a, run, items[k]);
    Op::store(a, base + k, items[k], run);
  }
}

template <class Op>
cudaError_t run_scan(const Args& a, cudaStream_t st) {
  const long long ntiles = (a.n + kTile - 1) / kTile;
  cudaError_t err = launch_params(scan_reduce<Op>, ntiles, kThreads, st, a);
  if (err != cudaSuccess) return err;
  err = launch_params(scan_carry<Op>, 1, kThreads, st, a);
  if (err != cudaSuccess) return err;
  return launch_params(scan_apply<Op>, ntiles, kThreads, st, a);
}

// ---- K15 ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) rank_final(const Args a) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < a.n; j += stride) {
    const long long ps = a.ps[j], pe = a.pe[j], gs = a.gs[j], ge = a.ge[j];
    const long long local = j - ps, psize = pe - ps + 1;
    const long long row = __ldg(a.order + j);
    long long r = 0;
    double f = 0.0;
    switch ((int)a.func) {
      case kRowNumber:
        r = local + 1;
        break;
      case kRank:
        r = gs - ps + 1;
        break;
      case kDenseRank:
        r = (long long)a.cnt[j] - a.cnt[ps] + 1;
        break;
      case kNtile: {
        // the first psize % n buckets take one row more (:1570-1577)
        const long long q = psize / a.param, rem = psize % a.param;
        const long long cutoff = rem * (q + 1);
        r = local < cutoff ? local / (q + 1) + 1
                           : rem + (local - cutoff) / (q > 1 ? q : 1) + 1;
        break;
      }
      case kPercentRank:
        f = psize > 1 ? (double)(gs - ps) / (double)(psize - 1) : 0.0;
        break;
      default:  // kCumeDist: peers share their group's last position
        f = (double)(ge - ps + 1) / (double)psize;
        break;
    }
    if (a.func == kPercentRank || a.func == kCumeDist) {
      static_cast<double*>(a.out)[row] = f;
    } else {
      static_cast<long long*>(a.out)[row] = r;
    }
  }
}

// ---- K16 ----------------------------------------------------------------

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

// One bound of position j's frame (is_start: its first position, else its
// last), before the clamp to the partition.
__device__ long long frame_bound(const Args& a, long long j, bool is_start) {
  const int kind = (int)(is_start ? a.lo_kind : a.hi_kind);
  const double nv = is_start ? a.lo_n : a.hi_n;
  const long long ps = a.ps[j], pe = a.pe[j];
  if (kind == kUp) return ps;
  if (kind == kUf) return pe;
  if (a.unit == kRows) {
    if (kind == kCur) return j;
    return kind == kFol ? j + (long long)nv : j - (long long)nv;
  }
  if (kind == kCur) return is_start ? a.gs[j] : a.ge[j];
  if (a.unit == kGroups) {
    const long long g = (long long)a.cnt[j] - 1;
    const long long tg = kind == kFol ? g + (long long)nv : g - (long long)nv;
    const long long first = (long long)a.cnt[ps] - 1, last = (long long)a.cnt[pe] - 1;
    if (is_start) {
      if (tg < first) return ps;
      if (tg > last) return pe + 1;
      return a.gstart[tg];
    }
    if (tg > last) return pe;
    if (tg < first) return ps - 1;
    return a.gend[tg];
  }
  // RANGE by the one key's value: a null key's bound is its peer group's
  if (a.snull[j]) return is_start ? a.gs[j] : a.ge[j];
  const double t = a.skv[j] + (kind == kFol ? nv : -nv);
  // the partition's non-null span: nulls are one peer group at one end
  const long long s0 = a.snull[ps] ? (long long)a.ge[ps] + 1 : ps;
  const long long s1 = a.snull[pe] ? (long long)a.gs[pe] - 1 : pe;
  if (is_start) return search(a.skv, s0, s1 + 1, t, false);
  return search(a.skv, s0, s1 + 1, t, true) - 1;
}

__device__ __forceinline__ void frame_of(const Args& a, long long j, long long* lo,
                                         long long* hi) {
  if (!is_real(a, j)) {  // a row that is not real: an empty frame, so that
    *lo = j + 1;         // no table level is sized by it
    *hi = j;
    return;
  }
  const long long ps = a.ps[j], pe = a.pe[j];
  if (a.unit == kRunning) {  // peers share their group's last row
    *lo = ps;
    *hi = a.ge[j];
    return;
  }
  const long long s = frame_bound(a, j, true), e = frame_bound(a, j, false);
  *lo = s > ps ? s : ps;
  *hi = e < pe ? e : pe;
}

// The table route's first stage: every position's frame, and the longest.
__global__ void __launch_bounds__(kThreads) frame_bounds(const Args a) {
  const long long stride = (long long)gridDim.x * kThreads;
  int longest = 0;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < a.n; j += stride) {
    long long lo, hi;
    frame_of(a, j, &lo, &hi);
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

template <class V>
__device__ __forceinline__ void put(const Args& a, long long row, V v, bool valid) {
  static_cast<V*>(a.out)[row] = valid ? v : (V)0;
  if (a.outm != nullptr) a.outm[row] = valid;
}

template <class V>
__global__ void __launch_bounds__(kThreads) frame_final(const Args a) {
  const long long stride = (long long)gridDim.x * kThreads;
  const int fn = (int)a.func;
  const V* sv = static_cast<const V*>(a.sv);
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < a.n; j += stride) {
    const long long row = __ldg(a.order + j);
    const long long ps = a.ps[j], pe = a.pe[j];
    if (fn == kLag || fn == kLead) {
      const long long src = fn == kLag ? j - a.param : j + a.param;
      const bool in = src >= ps && src <= pe;
      if (in) {
        put<V>(a, row, sv[src], a.sm[src] != 0);
      } else {
        const V d = a.is_float ? (V)a.default_f : (V)a.default_i;
        put<V>(a, row, d, a.has_default != 0);
      }
      continue;
    }
    long long lo, hi;
    if (a.stage == 2) {
      lo = a.lo[j];
      hi = a.hi[j];
    } else {
      frame_of(a, j, &lo, &hi);
    }
    const bool empty = lo > hi;
    if (fn == kFirst || fn == kLast || fn == kNth) {
      const long long at = fn == kFirst ? lo : (fn == kLast ? hi : lo + a.param - 1);
      const bool bad = empty || at > hi;
      put<V>(a, row, bad ? (V)0 : sv[at], !bad && a.sm[at] != 0);
      continue;
    }
    if (fn == kCountStar) {
      static_cast<long long*>(a.out)[row] = empty ? 0 : hi - lo + 1;
      continue;
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
        count = a.C[hi] - (lo > ps ? a.C[lo - 1] : 0);
        if (fn == kSum || fn == kAvg) {
          const V* P = static_cast<const V*>(a.P);
          sum = lo > ps ? P[hi] - P[lo - 1] : P[hi];
        } else if (fn == kMin || fn == kMax) {
          if (a.agg_route == kPrefix) {
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
      static_cast<long long*>(a.out)[row] = count;
    } else if (fn == kAvg) {
      static_cast<double*>(a.out)[row] = count > 0 ? (double)sum / (double)count : 0.0;
      a.outm[row] = count > 0;
    } else {
      put<V>(a, row, fn == kSum ? sum : ext, count > 0);
    }
  }
}

cudaError_t launch_rows(void (*kernel)(Args), const Args& a, int device, cudaStream_t st) {
  return launch_wave(kernel, a.n, kThreads, device, st, a);
}

cudaError_t position_scans(const Args& a, cudaStream_t st) {
  cudaError_t err = run_scan<FwdPos>(a, st);
  if (err != cudaSuccess) return err;
  return run_scan<RevPos>(a, st);
}

template <class V>
cudaError_t run_frame(const Args& a, int device, cudaStream_t st) {
  cudaError_t err;
  if (a.stage != 2) {
    err = position_scans(a, st);
    if (err != cudaSuccess) return err;
    if (a.values != nullptr) {  // COUNT(*) reads no argument
      err = run_scan<FwdVal<V>>(a, st);
      if (err != cudaSuccess) return err;
    }
    if (a.stage == 1) return launch_rows(frame_bounds, a, device, st);
  } else {
    for (long long k = 0; k < a.nlevels; ++k) {
      Args b = a;
      b.level = k;
      err = launch_rows(table_level<V>, b, device, st);
      if (err != cudaSuccess) return err;
    }
  }
  return launch_rows(frame_final<V>, a, device, st);
}

bool bad_args(const Args* a) {
  if (a == nullptr || a->n < 1 || a->n >= kBig || a->nwords < 1 || a->nwords > kMaxWords)
    return true;
  for (int w = 0; w < a->nwords; ++w) {
    if (a->words[w] == nullptr) return true;
  }
  return a->order == nullptr || a->agg == nullptr || a->out == nullptr || a->ps == nullptr ||
         a->pe == nullptr || a->gs == nullptr || a->ge == nullptr || a->cnt == nullptr;
}

}  // namespace

// K15. Returns a cudaError_t; *launched is 1 where the kernels were
// launched.
extern "C" int fugue_window_rank(const WindowArgs* a, int device, void* stream, int* launched) {
  *launched = 0;
  if (bad_args(a) || a->func < kRowNumber || a->func > kCumeDist ||
      (a->func == kNtile && a->param < 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&] {
    cudaError_t e = position_scans(*a, st);
    if (e != cudaSuccess) return e;
    return launch_rows(rank_final, *a, device, st);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// K16, in stage 0 (all), 1 (up to the table route's bounds and longest
// frame) or 2 (the table route's levels and output). Returns a
// cudaError_t; *launched is 1 where the kernels were launched.
extern "C" int fugue_window_frame(const WindowArgs* a, int device, void* stream, int* launched) {
  *launched = 0;
  if (bad_args(a) || a->func < kCount || a->func > kNth || a->stage < 0 || a->stage > 2 ||
      (a->func != kCountStar && a->values == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&] {
    return a->is_float ? run_frame<double>(*a, device, st) : run_frame<long long>(*a, device, st);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The bytes of scan scratch a tile needs: the largest scan element.
extern "C" long long fugue_window_tile_bytes() {
  long long b = sizeof(PosT);
  if ((long long)sizeof(EndT) > b) b = sizeof(EndT);
  if ((long long)sizeof(ValT<double>) > b) b = sizeof(ValT<double>);
  if ((long long)sizeof(ValT<long long>) > b) b = sizeof(ValT<long long>);
  return b;
}

extern "C" long long fugue_window_tile_rows() { return kTile; }

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* fugue_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
