// Per-segment reductions that the fused sums kernel (segment_sums.cu)
// cannot do: K4 segment_extrema and K5 segment_sq_dev.
//
// Both replace parts of the JAX package's _segment_agg_impl
// (fugue_tpu/jax_backend/groupby.py:602-726), which XLA lowers to
// scatter programs; none of it is a Pallas kernel:
//   - K4 segment_extrema: the scatter-min/max of min and max (:647-656,
//     filled with _type_max/_type_min, :729-743) and of the row index of
//     first and last (:711-718);
//   - K5 segment_sq_dev: the second pass of the two-pass variance
//     (:676-678): the sum of (x - mean[seg])^2 in float64 per segment.
// Contracts: segment_extrema_reference and segment_sq_dev_reference in
// reference.py.
//
// Rows: rows [0, n) are read; a row counts where seg[row] lies in
// [0, num) and, with row_valid, its byte is non-zero. A payload with a
// mask (bool, True = valid) takes only the rows where its mask holds.
//
// K4 keeps one table per requested reduction: the min or the max of a
// payload as an order-preserving unsigned code (4 bytes for payloads of
// up to 32 bits, 8 for int64/float64), or the first or last counted row.
// Codes: bool/uint8 as they are; int8-32 sign-extended to 32 bits and
// int64 with the top bit flipped; a float's bits with the sign flipped
// and, for a negative float, the rest flipped too (so -0.0 < +0.0). NaN
// wins both (the JAX package's segment_min/segment_max propagate it):
// code 0 in a min table, all ones in a max table. No other value takes
// those codes, so the caller can tell NaN from an empty segment. The
// first row is its index, the last its index + 1, so that 0 means "no
// row" in a max table. The caller fills each table with its identity
// (all ones for min, 0 for max) and decodes.
//
// What bounds them on an H100: bytes (seg and the payload once: 8 bytes
// a row for one float32 payload, 0.239 ms at 100M rows) and, where rows
// of one segment do not follow one another, one shared-memory atomic a
// table a run of equal rows. What stood in the way before was latency
// and contention: one row a thread per step kept little in flight, and
// every row made one atomic per table, so that the rows of one segment
// (the keyless aggregate) or of a hot key all landed on one shared word
// (a float64 add there is a compare-and-swap loop on sm_90:
// ATOMS.CAST.SPIN). The design:
//   - a persistent grid of one wave walks tiles of kTile rows; each thread
//     takes a run of kRun consecutive rows of a tile and reads seg, the
//     row validity, each payload and its mask with one 8-64 byte load a
//     column (16-byte pieces; scalar loads where a column is not aligned
//     to its run, as a view at an offset can be, and at the ragged end);
//   - payloads outside, rows inside: a payload's dtype is switched on once
//     a run, and its min and max tables (or first and last row) fold
//     together as one group; K4 runs on 4-byte codes (fewer registers)
//     unless a table or payload is 8 bytes wide; K5 reads the means of a
//     run's rows together, before it folds them;
//   - each thread folds its rows into a pending (segment, value) a group
//     in registers, carried from run to run in a per-thread slot of shared
//     memory, and flushes it with one atomic a table only where the
//     segment changes: one segment costs no atomic until the end, sorted
//     runs one a run of equal rows;
//   - at the end each warp combines its pendings before any atomic: where
//     every lane holds the same segment (one segment, a hot key) a
//     butterfly of shuffles (__reduce_min/max_sync for 32-bit codes),
//     else the groups of __match_any_sync, reduced in log2(group) rounds
//     of full-warp shuffles; one lane a group makes the atomic;
//   - each block keeps its tables in shared memory while they fit the
//     device's opt-in limit, as 1-8 replicas (as many as fit in
//     kReplicaBudget) that lanes pick by lane index, each shifted by
//     128/replicas bytes so that one hot segment's replicas sit in other
//     banks; at the end it merges the replicas and adds each touched
//     entry to the global tables with one atomic; above the limit the
//     flushes go to the global tables directly;
//   - K4's tables are filled before its launches and decoded into the
//     payloads' dtypes after them by one launch each (extrema_fill,
//     extrema_decode).
// Integer min/max codes use the native 32- and 64-bit atomicMin and
// atomicMax. K5's float64 sums depend on the order in which flushes and
// atomics land; K4 is exact.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "bin_keys.cuh"
#include "launch.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kRun = 8;                 // consecutive rows a thread takes from a tile
constexpr int kTile = kThreads * kRun;  // rows a block takes a step
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPayloads = 8;
constexpr int kMaxTables = 2 * kMaxPayloads + 2;
constexpr int kMaxReplicas = 8;
constexpr long long kReplicaBudget = 32 * 1024;  // bytes of shared tables a block, at most

struct Table {
  void* out;   // uint32 or uint64 [num], filled with the identity
  int wide;    // 8-byte codes
  int is_max;  // max table (identity 0), else min (identity all ones)
  int src;     // payload index; -1: the row index
};

// The tables of one source folded together: a min (or first row) and a
// max (or last row) at most; -1 where absent.
struct Group {
  int src;
  int tmin, tmax;
};

struct Rows {
  long long n;
  const uint8_t* row_valid;  // null: every row of [0, n) is real
  const int* seg;
  int num;
  int vec;  // bit 0: seg, bit 1: row_valid can be read a run at a time
};

struct ExtremaParams {
  Rows rows;
  int np;
  Column pay[kMaxPayloads];
  int vec[kMaxPayloads];  // bit 0: data, bit 1: mask can be read a run at a time
  int ntab;
  Table tab[kMaxTables];
  long long off[kMaxTables];  // byte offset of each table's first replica in shared memory
  long long stride[kMaxTables];  // bytes from one replica of a table to the next
  int ngroups;
  Group grp[kMaxTables];
  int nrep;             // replicas of the shared tables
  long long pend_off;   // byte offset of the pending folds in shared memory
};

struct SqDevParams {
  Rows rows;
  int np;
  Column pay[kMaxPayloads];  // float32/float64
  int vec[kMaxPayloads];
  const double* mean;  // [np][num]
  double* out;         // [np][num], zeroed by the caller
  int nrep;
  long long stride;    // doubles from one replica of the sums to the next
  long long pend_off;  // byte offset of the pending folds in shared memory
};

// kRun consecutive values from row r0, cnt of them real (the rest T()):
// 8-64 bytes in 8- or 16-byte loads where vec (the column is aligned to
// its run) and the run is whole, else one load a row.
template <typename T>
__device__ __forceinline__ void load_run(const T* p, long long r0, int cnt, bool vec,
                                         T (&v)[kRun]) {
  constexpr int kBytes = kRun * (int)sizeof(T);
  if (vec && cnt == kRun) {
    if constexpr (kBytes == 8) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(p + r0));
      memcpy(v, &w, 8);
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(p + r0) + i);
        memcpy(reinterpret_cast<char*>(v) + 16 * i, &w, 16);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = i < cnt ? __ldg(p + r0 + i) : T();
  }
}

// The segment of each row of the run at r0, -1 where the row does not
// count.
__device__ __forceinline__ void run_segments(const Rows& rows, long long r0, int (&s)[kRun]) {
  const long long left = rows.n - r0;
  const int cnt = left >= kRun ? kRun : (left > 0 ? (int)left : 0);
  load_run(rows.seg, r0, cnt, rows.vec & 1, s);
  uint8_t rv[kRun];
  if (rows.row_valid != nullptr) load_run(rows.row_valid, r0, cnt, rows.vec & 2, rv);
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const bool real = i < cnt && (rows.row_valid == nullptr || rv[i] != 0);
    s[i] = real && (unsigned)s[i] < (unsigned)rows.num ? s[i] : -1;
  }
}

// Bit i set where payload row r0 + i is valid (every bit without a mask).
__device__ __forceinline__ unsigned run_mask(const Column& c, bool vec, long long r0,
                                             long long n) {
  if (c.mask == nullptr) return 0xFFu;
  const long long left = n - r0;
  const int cnt = left >= kRun ? kRun : (left > 0 ? (int)left : 0);
  uint8_t m[kRun];
  load_run(c.mask, r0, cnt, vec, m);
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) bits |= (m[i] != 0 ? 1u : 0u) << i;
  return bits;
}

// The order-preserving code of one value, as a min table takes it (lo:
// NaN 0) and as a max table does (hi: NaN all ones of the dtype's width).
// C is the codes' type: unsigned where every table holds 4-byte codes.
template <typename C, typename T>
__device__ __forceinline__ void code_of(T x, C& lo, C& hi) {
  using u64 = unsigned long long;
  if constexpr (std::is_same_v<T, float>) {
    const unsigned u = __float_as_uint(x);
    const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    const bool nan = (u & 0x7FFFFFFFu) > 0x7F800000u;
    lo = nan ? 0u : k;
    hi = nan ? 0xFFFFFFFFu : k;
  } else if constexpr (std::is_same_v<T, double>) {
    const u64 u = (u64)__double_as_longlong(x);
    const u64 k = (u >> 63) ? ~u : (u | 0x8000000000000000ull);
    const bool nan = (u & 0x7FFFFFFFFFFFFFFFull) > 0x7FF0000000000000ull;
    lo = nan ? 0ull : k;
    hi = nan ? ~0ull : k;
  } else if constexpr (std::is_same_v<T, long long>) {
    lo = hi = (u64)x ^ 0x8000000000000000ull;
  } else if constexpr (std::is_same_v<T, uint8_t>) {
    lo = hi = x;
  } else {  // int8, int16, int32: sign-extended to 32 bits
    lo = hi = (unsigned)(int)x ^ 0x80000000u;
  }
}

// Where a group's flushes go: its min and max tables (the lane's replica
// in shared memory, or the global table) where it has them, and whether
// each holds 8-byte codes. An absent table's pointer is a present one's,
// never dereferenced, so that every pointer stays in shared memory.
template <typename C>
struct Dst {
  void* min;
  void* max;
  bool has_min, has_max;
  bool wide_min, wide_max;
};

template <bool kShared, typename C>
__device__ __forceinline__ Dst<C> group_dst(const ExtremaParams& p, char* sbase,
                                            const Group& g, int rep) {
  auto base = [&](int t) -> void* {
    if constexpr (kShared) return sbase + p.off[t] + rep * p.stride[t];
    else return p.tab[t].out;
  };
  const int tmin = g.tmin >= 0 ? g.tmin : g.tmax, tmax = g.tmax >= 0 ? g.tmax : g.tmin;
  return {base(tmin), base(tmax), g.tmin >= 0, g.tmax >= 0, p.tab[tmin].wide != 0,
          p.tab[tmax].wide != 0};
}

template <typename C>
__device__ __forceinline__ void flush(const Dst<C>& d, int s, C lo, C hi) {
  using u64 = unsigned long long;
  if constexpr (sizeof(C) == 8) {
    if (d.has_min) {
      if (d.wide_min) atomicMin(static_cast<u64*>(d.min) + s, lo);
      else atomicMin(static_cast<unsigned*>(d.min) + s, (unsigned)lo);
    }
    if (d.has_max) {
      if (d.wide_max) atomicMax(static_cast<u64*>(d.max) + s, hi);
      else atomicMax(static_cast<unsigned*>(d.max) + s, (unsigned)hi);
    }
  } else {
    if (d.has_min) atomicMin(static_cast<unsigned*>(d.min) + s, lo);
    if (d.has_max) atomicMax(static_cast<unsigned*>(d.max) + s, hi);
  }
}

// One run of a payload of dtype T into the pending fold (ps, plo, phi);
// kHalf: T is a float16's bits, folded by its value as a float.
template <typename C, typename T, bool kHalf = false>
__device__ __forceinline__ void fold_payload(const Column& c, int vec, long long r0,
                                             long long n, const int (&s)[kRun],
                                             const Dst<C>& d, int& ps, C& plo, C& phi) {
  const long long left = n - r0;
  const int cnt = left >= kRun ? kRun : (left > 0 ? (int)left : 0);
  T x[kRun];
  load_run(static_cast<const T*>(c.data), r0, cnt, vec & 1, x);
  const unsigned mbits = run_mask(c, vec & 2, r0, n);
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (s[i] < 0 || !((mbits >> i) & 1u)) continue;
    C lo, hi;
    if constexpr (kHalf) code_of<C>(half_value(x[i]), lo, hi);
    else code_of<C>(x[i], lo, hi);
    if (s[i] != ps) {
      if (ps >= 0) flush(d, ps, plo, phi);
      ps = s[i];
      plo = lo;
      phi = hi;
    } else {
      plo = lo < plo ? lo : plo;
      phi = hi > phi ? hi : phi;
    }
  }
}

// One run of the row tables: a thread meets its rows in increasing order,
// so a pending fold's first row is the one that opened it and its last
// row (+ 1) the latest.
template <typename C>
__device__ __forceinline__ void fold_rows(long long r0, const int (&s)[kRun], const Dst<C>& d,
                                          int& ps, C& plo, C& phi) {
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (s[i] < 0) continue;
    if (s[i] != ps) {
      if (ps >= 0) flush(d, ps, plo, phi);
      ps = s[i];
      plo = (C)(r0 + i);
    }
    phi = (C)(r0 + i + 1);
  }
}

// The min of lo and the max of hi over each group of lanes that agree on
// s (the lanes of a group must be `peers`, from __match_any_sync),
// landing on the group's lowest lane, in log2(group size) rounds of
// shuffles that every lane of the warp takes part in.
template <typename Combine, typename V>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane, V& a, V& b, Combine comb) {
  int rel = __popc(peers & ((1u << lane) - 1));  // the lane's place among its peers
  unsigned above = peers & ~((2u << lane) - 1);  // its peers above it
  while (__any_sync(kFull, above != 0)) {
    const int next = __ffs(above);  // the next peer still folding, 1-based; 0: none
    const V ta = __shfl_sync(kFull, a, next > 0 ? next - 1 : lane);
    const V tb = __shfl_sync(kFull, b, next > 0 ? next - 1 : lane);
    if (next > 0) comb(a, b, ta, tb);
    above &= ~__ballot_sync(kFull, rel & 1);  // odd places have handed on their values
    rel >>= 1;
  }
}

__device__ __forceinline__ void table_update(const Table& t, void* base, int s,
                                             unsigned long long code) {
  if (t.wide) {
    unsigned long long* a = static_cast<unsigned long long*>(base) + s;
    if (t.is_max) atomicMax(a, code);
    else atomicMin(a, code);
  } else {
    unsigned* a = static_cast<unsigned*>(base) + s;
    if (t.is_max) atomicMax(a, (unsigned)code);
    else atomicMin(a, (unsigned)code);
  }
}

// K4. C: the codes' type (unsigned where every table holds 4-byte codes
// and no payload is 8 bytes wide: fewer registers).
template <bool kShared, typename C>
__global__ void __launch_bounds__(kThreads)
    segment_extrema(const __grid_constant__ ExtremaParams p) {
  using u64 = unsigned long long;
  extern __shared__ u64 smem[];
  char* sbase = reinterpret_cast<char*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rep = lane & (p.nrep - 1);
  // the pending folds: [group][thread] min codes, max codes, segments
  C* plo = reinterpret_cast<C*>(sbase + p.pend_off);
  C* phi = plo + p.ngroups * kThreads;
  int* pseg = reinterpret_cast<int*>(phi + p.ngroups * kThreads);
  for (int g = 0; g < p.ngroups; ++g) pseg[g * kThreads + tid] = -1;
  if constexpr (kShared) {
    for (int t = 0; t < p.ntab; ++t) {
      const Table& tb = p.tab[t];
      for (int r = 0; r < p.nrep; ++r) {
        char* base = sbase + p.off[t] + r * p.stride[t];
        if (tb.wide) {
          u64* a = reinterpret_cast<u64*>(base);
          const u64 id = tb.is_max ? 0ull : ~0ull;
          for (int s = tid; s < p.rows.num; s += kThreads) a[s] = id;
        } else {
          unsigned* a = reinterpret_cast<unsigned*>(base);
          const unsigned id = tb.is_max ? 0u : ~0u;
          for (int s = tid; s < p.rows.num; s += kThreads) a[s] = id;
        }
      }
    }
    __syncthreads();
  }
  for (long long tile = blockIdx.x; tile * kTile < p.rows.n; tile += gridDim.x) {
    const long long r0 = tile * kTile + (long long)tid * kRun;
    int s[kRun];
    run_segments(p.rows, r0, s);
    for (int g = 0; g < p.ngroups; ++g) {
      const Group grp = p.grp[g];
      const Dst<C> d = group_dst<kShared, C>(p, sbase, grp, rep);
      const int slot = g * kThreads + tid;
      int ps = pseg[slot];
      C lo = plo[slot], hi = phi[slot];
      if (grp.src < 0) {
        fold_rows(r0, s, d, ps, lo, hi);
      } else {
        const Column& c = p.pay[grp.src];
        const int vec = p.vec[grp.src];
        switch (c.code) {
          case kBool:
          case kU8: fold_payload<C, uint8_t>(c, vec, r0, p.rows.n, s, d, ps, lo, hi); break;
          case kI8: fold_payload<C, int8_t>(c, vec, r0, p.rows.n, s, d, ps, lo, hi); break;
          case kI16: fold_payload<C, int16_t>(c, vec, r0, p.rows.n, s, d, ps, lo, hi); break;
          case kI32: fold_payload<C, int32_t>(c, vec, r0, p.rows.n, s, d, ps, lo, hi); break;
          case kF32: fold_payload<C, float>(c, vec, r0, p.rows.n, s, d, ps, lo, hi); break;
          case kF16:
            fold_payload<C, unsigned short, true>(c, vec, r0, p.rows.n, s, d, ps, lo, hi);
            break;
          default:
            if constexpr (sizeof(C) == 8) {
              if (c.code == kI64)
                fold_payload<C, long long>(c, vec, r0, p.rows.n, s, d, ps, lo, hi);
              else
                fold_payload<C, double>(c, vec, r0, p.rows.n, s, d, ps, lo, hi);
            }
            break;
        }
      }
      pseg[slot] = ps;
      plo[slot] = lo;
      phi[slot] = hi;
    }
  }
  // every lane of every warp gets here: the warps combine their pendings
  for (int g = 0; g < p.ngroups; ++g) {
    const Group grp = p.grp[g];
    const int slot = g * kThreads + tid;
    const int ps = pseg[slot];
    C lo = plo[slot], hi = phi[slot];
    const int s0 = __shfl_sync(kFull, ps, 0);
    bool leader;
    if (__all_sync(kFull, ps == s0)) {
      if constexpr (sizeof(C) == 4) {
        lo = __reduce_min_sync(kFull, lo);
        hi = __reduce_max_sync(kFull, hi);
      } else {
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          const C ol = __shfl_xor_sync(kFull, lo, d), oh = __shfl_xor_sync(kFull, hi, d);
          lo = ol < lo ? ol : lo;
          hi = oh > hi ? oh : hi;
        }
      }
      leader = lane == 0;
    } else {
      const unsigned peers = __match_any_sync(kFull, ps);
      leader = (peers & ((1u << lane) - 1)) == 0;
      reduce_peers(peers, lane, lo, hi, [](C& a, C& b, C ta, C tb) {
        a = ta < a ? ta : a;
        b = tb > b ? tb : b;
      });
    }
    if (leader && ps >= 0) flush(group_dst<kShared, C>(p, sbase, grp, rep), ps, lo, hi);
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int t = 0; t < p.ntab; ++t) {
      const Table& tb = p.tab[t];
      for (int s = tid; s < p.rows.num; s += kThreads) {
        if (tb.wide) {
          u64 v = tb.is_max ? 0ull : ~0ull;
          for (int r = 0; r < p.nrep; ++r) {
            const u64 x = reinterpret_cast<const u64*>(sbase + p.off[t] + r * p.stride[t])[s];
            v = tb.is_max ? (x > v ? x : v) : (x < v ? x : v);
          }
          if (v != (tb.is_max ? 0ull : ~0ull)) table_update(tb, tb.out, s, v);
        } else {
          unsigned v = tb.is_max ? 0u : ~0u;
          for (int r = 0; r < p.nrep; ++r) {
            const unsigned x =
                reinterpret_cast<const unsigned*>(sbase + p.off[t] + r * p.stride[t])[s];
            v = tb.is_max ? (x > v ? x : v) : (x < v ? x : v);
          }
          if (v != (tb.is_max ? 0u : ~0u)) table_update(tb, tb.out, s, v);
        }
      }
    }
  }
}

// kRun float32/float64 values of a payload as float64.
__device__ __forceinline__ void run_doubles(const Column& c, bool vec, long long r0, long long n,
                                            double (&x)[kRun]) {
  const long long left = n - r0;
  const int cnt = left >= kRun ? kRun : (left > 0 ? (int)left : 0);
  if (c.code == kF32) {
    float f[kRun];
    load_run(static_cast<const float*>(c.data), r0, cnt, vec, f);
#pragma unroll
    for (int i = 0; i < kRun; ++i) x[i] = (double)f[i];
  } else {
    load_run(static_cast<const double*>(c.data), r0, cnt, vec, x);
  }
}

// K5, at most 64 registers (4 blocks an SM): faster at every timed shape
// than the 76 it takes unbounded (PERF.md).
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 4)
    segment_sq_dev(const __grid_constant__ SqDevParams p) {
  // shared: [np * num means][nrep replicas of np * num sums, stride apart][pending]
  extern __shared__ double dsmem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rep = lane & (p.nrep - 1);
  const long long tab = (long long)p.np * p.rows.num;
  const double* mean = p.mean;
  double* acc = p.out;
  double* pacc = reinterpret_cast<double*>(reinterpret_cast<char*>(dsmem) + p.pend_off);
  int* pseg = reinterpret_cast<int*>(pacc + p.np * kThreads);
  for (int q = 0; q < p.np; ++q) pseg[q * kThreads + tid] = -1;
  if constexpr (kShared) {
    for (long long i = tid; i < tab; i += kThreads) dsmem[i] = __ldg(p.mean + i);
    for (int r = 0; r < p.nrep; ++r)
      for (long long i = tid; i < tab; i += kThreads) dsmem[tab + r * p.stride + i] = 0.0;
    __syncthreads();
    mean = dsmem;
    acc = dsmem + tab + rep * p.stride;
  }
  for (long long tile = blockIdx.x; tile * kTile < p.rows.n; tile += gridDim.x) {
    const long long r0 = tile * kTile + (long long)tid * kRun;
    int s[kRun];
    run_segments(p.rows, r0, s);
    for (int q = 0; q < p.np; ++q) {
      const Column& c = p.pay[q];
      double x[kRun];
      run_doubles(c, p.vec[q] & 1, r0, p.rows.n, x);
      const unsigned mbits = run_mask(c, p.vec[q] & 2, r0, p.rows.n);
      const long long row = (long long)q * p.rows.num;
      // each counted row's square first: its mean read with the run's
      // others, none waiting on the fold
      unsigned counted = 0;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (s[i] < 0 || !((mbits >> i) & 1u)) continue;
        counted |= 1u << i;
        double m;
        if constexpr (kShared) m = mean[row + s[i]];
        else m = __ldg(mean + row + s[i]);
        const double d = x[i] - m;
        x[i] = d * d;
      }
      const int slot = q * kThreads + tid;
      int ps = pseg[slot];
      double sum = pacc[slot];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (!((counted >> i) & 1u)) continue;
        if (s[i] != ps) {
          if (ps >= 0) atomicAdd(acc + row + ps, sum);
          ps = s[i];
          sum = 0.0;
        }
        sum += x[i];
      }
      pseg[slot] = ps;
      pacc[slot] = sum;
    }
  }
  for (int q = 0; q < p.np; ++q) {
    const int slot = q * kThreads + tid;
    const int ps = pseg[slot];
    double sum = pacc[slot];
    const int s0 = __shfl_sync(kFull, ps, 0);
    bool leader;
    if (__all_sync(kFull, ps == s0)) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
      leader = lane == 0;
    } else {
      const unsigned peers = __match_any_sync(kFull, ps);
      leader = (peers & ((1u << lane) - 1)) == 0;
      double unused = 0.0;
      reduce_peers(peers, lane, sum, unused, [](double& a, double&, double ta, double) {
        a += ta;
      });
    }
    if (leader && ps >= 0) atomicAdd(acc + (long long)q * p.rows.num + ps, sum);
  }
  if constexpr (kShared) {
    __syncthreads();
    for (long long i = tid; i < tab; i += kThreads) {
      double v = 0.0;
      for (int r = 0; r < p.nrep; ++r) v += dsmem[tab + r * p.stride + i];
      if (v != 0.0) atomicAdd(p.out + i, v);
    }
  }
}

// K4's tables around its launches, all in one launch each: their fill
// with the identity before, and their decoding into the payloads' dtypes
// after (in place of a dozen small PyTorch operations a table, whose
// enqueue took longer than K4 itself: PERF.md). Block row y is
// table y.
struct TableSet {
  int ntab;
  int num;
  void* code[kMaxTables];  // uint32 or uint64 [num]
  void* dst[kMaxTables];   // decode: [num] of dtype dcode
  int wide[kMaxTables];
  int is_max[kMaxTables];
  int dcode[kMaxTables];   // a dtype code of bin_keys.cuh; -1: the last row (an int32 index)
};

constexpr int kTableThreads = 256;

__global__ void __launch_bounds__(kTableThreads) extrema_fill(const __grid_constant__ TableSet p) {
  const int t = blockIdx.y;
  for (long long s = (long long)blockIdx.x * kTableThreads + threadIdx.x; s < p.num;
       s += (long long)gridDim.x * kTableThreads) {
    if (p.wide[t]) static_cast<unsigned long long*>(p.code[t])[s] = p.is_max[t] ? 0ull : ~0ull;
    else static_cast<unsigned*>(p.code[t])[s] = p.is_max[t] ? 0u : ~0u;
  }
}

template <typename T>
__device__ __forceinline__ void put(void* dst, long long s, T v) {
  static_cast<T*>(dst)[s] = v;
}

// A code as its value: the identity (all ones in a min table, 0 in a max
// table) is an empty segment and takes the JAX package's fill (+inf or
// the type's max for a min, -inf or its min for a max; bool: True, False);
// a float's NaN code (0 in a min table, all ones in a max table) is NaN.
__global__ void __launch_bounds__(kTableThreads)
    extrema_decode(const __grid_constant__ TableSet p) {
  using u64 = unsigned long long;
  const int t = blockIdx.y;
  const bool wide = p.wide[t], is_max = p.is_max[t];
  const u64 ones = wide ? ~0ull : 0xFFFFFFFFull;
  void* dst = p.dst[t];
  for (long long s = (long long)blockIdx.x * kTableThreads + threadIdx.x; s < p.num;
       s += (long long)gridDim.x * kTableThreads) {
    const u64 c = wide ? static_cast<const u64*>(p.code[t])[s]
                       : static_cast<const unsigned*>(p.code[t])[s];
    const bool empty = c == (is_max ? 0ull : ones);
    const bool nan = c == (is_max ? ones : 0ull);
    const unsigned lo = (unsigned)c ^ 0x80000000u;  // a narrow integer's value
    switch (p.dcode[t]) {
      case -1: put<int>(dst, s, (int)(unsigned)c - 1); break;
      case kBool: put<uint8_t>(dst, s, empty ? !is_max : c != 0); break;
      case kU8: put<uint8_t>(dst, s, empty ? (is_max ? 0 : 255) : (uint8_t)c); break;
      case kI8: put<int8_t>(dst, s, empty ? (is_max ? -128 : 127) : (int8_t)(int)lo); break;
      case kI16:
        put<int16_t>(dst, s, empty ? (is_max ? -32768 : 32767) : (int16_t)(int)lo);
        break;
      case kI32: put<int>(dst, s, empty ? (is_max ? INT32_MIN : INT32_MAX) : (int)lo); break;
      case kI64:
        put<long long>(dst, s, empty ? (is_max ? INT64_MIN : INT64_MAX)
                                     : (long long)(c ^ 0x8000000000000000ull));
        break;
      case kF32:
      case kF16: {  // a float16's table holds its value's float code
        const unsigned k = (unsigned)c;
        const unsigned bits = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
        float v = empty ? __uint_as_float(is_max ? 0xFF800000u : 0x7F800000u)  // -inf, +inf
                        : __uint_as_float(bits);
        if (!empty && nan) v = __uint_as_float(0x7FC00000u);  // the NaN float("nan") gives
        if (p.dcode[t] == kF16)  // exact: the value came from a float16
          put<unsigned short>(dst, s, __half_as_ushort(__float2half_rn(v)));
        else
          put<float>(dst, s, v);
        break;
      }
      default: {
        const u64 bits = (c >> 63) ? (c ^ 0x8000000000000000ull) : ~c;
        double v = empty ? __longlong_as_double(is_max ? (long long)0xFFF0000000000000ull
                                                        : 0x7FF0000000000000LL)
                         : __longlong_as_double((long long)bits);
        if (!empty && nan) v = __longlong_as_double(0x7FF8000000000000LL);
        put<double>(dst, s, v);
        break;
      }
    }
  }
}

// The replicas of `one` bytes of shared tables that fit kReplicaBudget
// (1, 2, 4 or 8; 1 where even two do not).
int replicas_for(long long one) {
  int rep = 1;
  while (rep < kMaxReplicas && 2 * rep * one <= kReplicaBudget) rep *= 2;
  return rep;
}

// Bytes from one replica of a table of `bytes` to the next: whole
// 128-byte lines, then a shift of 128 / nrep bytes (a 1/nrep turn of the
// 32 banks), so that one segment's replicas lie in other banks.
long long replica_stride(long long bytes, int nrep) {
  return (bytes + 127) / 128 * 128 + (nrep > 1 ? 128 / nrep : 0);
}

// Whether the 8-row runs of a column at ptr with elements of `size` bytes
// can be read whole: the column aligned to min(16, 8 * size) bytes.
int aligned_runs(const void* ptr, int size) {
  const long long need = 8LL * size < 16 ? 8LL * size : 16;
  return ptr != nullptr && reinterpret_cast<uintptr_t>(ptr) % need == 0;
}

Rows make_rows(long long n, const void* row_valid, const void* seg, int num) {
  Rows r = {};
  r.n = n;
  r.row_valid = static_cast<const uint8_t*>(row_valid);
  r.seg = static_cast<const int*>(seg);
  r.num = num;
  r.vec = aligned_runs(seg, 4) | (aligned_runs(row_valid, 1) << 1);
  return r;
}

// Launches fn over n rows with `shared_bytes` of dynamic shared memory
// where that fits the device's opt-in limit (the shared path), else with
// `global_bytes` (the global path), as one persistent wave of tiles.
// *path: 1 shared, 2 global. `params` is the kernel's parameter struct;
// `use(shared)` is called before the launch to finish it for the path.
template <typename P, typename Use>
cudaError_t launch_rows(void (*shared_fn)(P), void (*global_fn)(P), long long n,
                        size_t shared_bytes, size_t global_bytes, P& params, Use use, int device,
                        cudaStream_t stream, int* path) {
  int sms = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const bool shared = shared_bytes <= (size_t)optin;
  void (*fn)(P) = shared ? shared_fn : global_fn;
  const size_t bytes = shared ? shared_bytes : global_bytes;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  use(shared);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(fn), kThreads, bytes);
  if (err != cudaSuccess) return err;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (n + kTile - 1) / kTile;
  void* args[] = {&params};
  const dim3 grid((unsigned)(need < wave ? need : wave));
  err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid, dim3(kThreads), args, bytes,
                         stream);
  if (err != cudaSuccess) return err;
  *path = shared ? 1 : 2;
  return cudaGetLastError();
}

}  // namespace

// K4. Payload q is (data[q], mask[q] or null, code[q]) with the dtype
// codes of bin_keys.cuh; table t writes outs[t] (uint32 [num], or uint64
// where wide[t]), a max table where is_max[t], over payload src[t] or,
// where src[t] is -1, the row index. The caller fills each table with its
// identity. device is the CUDA ordinal of the tensors, stream a
// cudaStream_t of it. Returns a cudaError_t; *path is 1 (shared-memory
// tables), 2 (global tables) or 0 (nothing launched: no row or no table).
extern "C" int fugue_segment_extrema(long long n, const void* row_valid, const void* seg,
                                     int num, int np, const void* const* data,
                                     const void* const* mask, const int* code, int ntab,
                                     void* const* outs, const int* wide, const int* is_max,
                                     const int* src, int device, void* stream, int* path) {
  *path = 0;
  if (np < 0 || np > kMaxPayloads || ntab < 0 || ntab > kMaxTables || num < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || ntab == 0) return (int)cudaSuccess;
  ExtremaParams p = {};
  p.rows = make_rows(n, row_valid, seg, num);
  p.np = np;
  for (int q = 0; q < np; ++q) {
    if (code[q] < kBool || code[q] > kF16) return (int)cudaErrorInvalidValue;
    p.pay[q] = {data[q], static_cast<const uint8_t*>(mask[q]), code[q]};
    p.vec[q] = aligned_runs(data[q], elem_size(code[q])) | (aligned_runs(mask[q], 1) << 1);
  }
  p.ntab = ntab;
  long long one = 0;  // bytes of one replica of every table
  bool wide_codes = false;  // 8-byte codes somewhere: the 64-bit kernel
  for (int t = 0; t < ntab; ++t) {
    if (src[t] < -1 || src[t] >= np) return (int)cudaErrorInvalidValue;
    p.tab[t] = {outs[t], wide[t], is_max[t], src[t]};
    one += replica_stride((long long)num * (wide[t] ? 8 : 4), 1);
    wide_codes |= wide[t] != 0 || (src[t] >= 0 && elem_size(code[src[t]]) == 8);
    // a table joins the first group of its source that lacks its kind
    int g = 0;
    while (g < p.ngroups &&
           !(p.grp[g].src == src[t] && (is_max[t] ? p.grp[g].tmax : p.grp[g].tmin) < 0))
      ++g;
    if (g == p.ngroups) p.grp[p.ngroups++] = {src[t], -1, -1};
    (is_max[t] ? p.grp[g].tmax : p.grp[g].tmin) = t;
  }
  p.nrep = replicas_for(one);
  long long tables = 0;
  for (int t = 0; t < ntab; ++t) {
    p.stride[t] = replica_stride((long long)num * (wide[t] ? 8 : 4), p.nrep);
    p.off[t] = tables;
    tables += p.nrep * p.stride[t];
  }
  const long long pend = (long long)p.ngroups * kThreads * (2 * (wide_codes ? 8 : 4) + 4);
  auto use = [&](bool shared) {
    p.pend_off = shared ? tables : 0;
    if (!shared) p.nrep = 1;
  };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)on_device(device, [&] {
    using u64 = unsigned long long;
    return wide_codes
               ? launch_rows(segment_extrema<true, u64>, segment_extrema<false, u64>, n,
                             (size_t)(tables + pend), (size_t)pend, p, use, device, st, path)
               : launch_rows(segment_extrema<true, unsigned>, segment_extrema<false, unsigned>,
                             n, (size_t)(tables + pend), (size_t)pend, p, use, device, st,
                             path);
  });
}

// K5. Payload q is (data[q], mask[q] or null, code[q]), float32 or
// float64; mean and out are float64 [np][num], out zeroed by the caller.
// Returns a cudaError_t; *path as for fugue_segment_extrema.
extern "C" int fugue_segment_sq_dev(long long n, const void* row_valid, const void* seg,
                                    int num, int np, const void* const* data,
                                    const void* const* mask, const int* code,
                                    const void* mean, void* out, int device, void* stream,
                                    int* path) {
  *path = 0;
  if (np < 0 || np > kMaxPayloads || num < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0 || np == 0) return (int)cudaSuccess;
  SqDevParams p = {};
  p.rows = make_rows(n, row_valid, seg, num);
  p.np = np;
  for (int q = 0; q < np; ++q) {
    if (code[q] != kF32 && code[q] != kF64) return (int)cudaErrorInvalidValue;
    p.pay[q] = {data[q], static_cast<const uint8_t*>(mask[q]), code[q]};
    p.vec[q] = aligned_runs(data[q], elem_size(code[q])) | (aligned_runs(mask[q], 1) << 1);
  }
  p.mean = static_cast<const double*>(mean);
  p.out = static_cast<double*>(out);
  const long long tab = (long long)np * num * sizeof(double);
  p.nrep = replicas_for(tab);
  const long long stride = replica_stride(tab, p.nrep);
  p.stride = stride / (long long)sizeof(double);
  const long long tables = tab + p.nrep * stride;  // the means, then the sums' replicas
  const long long pend = (long long)np * kThreads * (8 + 4);
  return (int)on_device(device, [&] {
    return launch_rows(segment_sq_dev<true>, segment_sq_dev<false>, n,
                       (size_t)(tables + pend), (size_t)pend, p,
                       [&](bool shared) {
                         p.pend_off = shared ? tables : 0;
                         if (!shared) p.nrep = 1;
                       },
                       device, static_cast<cudaStream_t>(stream), path);
  });
}

// K4's tables: fill each table t (codes[t], uint32 [num] or uint64 where
// wide[t]) with its identity (0 where is_max[t], else all ones), or
// decode each into dst[t] (num values of dtype code dcode[t]; -1: a last
// row's table, into int32 indexes, -1 where empty), as extrema_decode
// says. At most kMaxTables tables a call, one launch. Returns a
// cudaError_t.
static int table_launch(bool decode, int ntab, void* const* codes, const int* wide,
                        const int* is_max, const int* dcode, void* const* dst, int num,
                        int device, void* stream) {
  if (ntab < 0 || ntab > kMaxTables || num < 1) return (int)cudaErrorInvalidValue;
  if (ntab == 0) return (int)cudaSuccess;
  TableSet p = {};
  p.ntab = ntab;
  p.num = num;
  for (int t = 0; t < ntab; ++t) {
    p.code[t] = codes[t];
    p.wide[t] = wide[t];
    p.is_max[t] = is_max[t];
    if (decode) {
      if (dcode[t] < -1 || dcode[t] > kF16) return (int)cudaErrorInvalidValue;
      p.dst[t] = dst[t];
      p.dcode[t] = dcode[t];
    }
  }
  const long long blocks = (num + kTableThreads - 1) / kTableThreads;
  const dim3 grid((unsigned)(blocks < 4096 ? blocks : 4096), (unsigned)ntab);
  return (int)on_device(device, [&] {
    void* args[] = {&p};
    cudaError_t err = cudaLaunchKernel(
        reinterpret_cast<const void*>(decode ? extrema_decode : extrema_fill), grid,
        dim3(kTableThreads), args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  });
}

extern "C" int fugue_segment_extrema_fill(int ntab, void* const* codes, const int* wide,
                                          const int* is_max, int num, int device,
                                          void* stream) {
  return table_launch(false, ntab, codes, wide, is_max, nullptr, nullptr, num, device, stream);
}

extern "C" int fugue_segment_extrema_decode(int ntab, void* const* codes, const int* wide,
                                            const int* is_max, const int* dcode,
                                            void* const* dst, int num, int device,
                                            void* stream) {
  return table_launch(true, ntab, codes, wide, is_max, dcode, dst, num, device, stream);
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* fugue_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
