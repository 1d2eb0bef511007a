// Row selection on the card: K12 rank_keep, K13 first_row_mask and K14
// null_count_keep. Each writes a frame's new row validity (one keep flag
// a row) and the kept count into one int32 device counter, so the frame's
// row count stays lazy.
//
// They replace one-device programs of the JAX package, which XLA lowers
// to sorts, scatters, gathers and reductions; none of them is a Pallas
// kernel:
//   - K12 rank_keep: each row's rank under a sort's permutation, within
//     its segment, against a limit: device_take's rank-within-partition
//     `local < n` (relational.py:1348-1361), INTERSECT ALL's and EXCEPT
//     ALL's ordinal `< c2[seg]` and `>= c2[seg]` (:1072-1084), and
//     device_sample's k smallest priorities (:2196-2206), k read from a
//     device scalar;
//   - K13 first_row_mask: each segment's first row, where its predicate
//     holds: every occupied segment for distinct's _distinct_prog
//     (execution_engine.py:1854-1867) and for the DISTINCT aggregates'
//     first-occurrence mask (_apply_distinct_mask, :3749-3776), `c2[g] >
//     0` or `c2[g] == 0` for INTERSECT and EXCEPT DISTINCT
//     (relational.py:1061-1071);
//   - K14 null_count_keep: each row's count of valid columns against
//     dropna's how/thresh, _dropna_prog (execution_engine.py:1906-1925).
// Contracts: rank_keep_reference, first_row_mask_reference and
// null_count_keep_reference in reference.py.
//
// K12 and K13 write their mask the same way, with no random byte store
// and no memset of the mask: a memset of 4 B a slab, then two launches.
//   1. partition (partition_kept, blocks of kPartThreads): each block
//      decides a tile of candidates, groups its kept rows by slab of 2^18
//      rows in shared memory (a histogram and its scan), reserves one run
//      a slab in the slab's bucket of scratch with one atomic, and copies
//      each kept row's offset in its slab there with coalesced stores
//      (4 B a kept row; runs of ~40 offsets at 100M rows).
//   2. build (build_slabs): one block a slab sets its kept rows' bits in
//      32 KB of shared memory (shared atomics), then writes the slab's
//      keep bytes once with 16-byte stores, counting the set bits
//      (__popc, a warp reduction, one atomic a block) into the count,
//      which step 1's kernel zeroed.
// A first design set the bits of one 12.5 MB bitmask with global atomics
// in L2 and expanded it in one pass. It was right but bound by L2's
// random atomics, about 35 G a second on an H100 80GB HBM3 at 700 W
// (K13 0.333 ms over 10.24M first rows of 100M, an EXCEPT ALL keeping
// 99M rows 2.63 ms), so the random work moved to shared memory: 0.14 and
// 1.6 ms there. Step 1 is then bound by its shared-memory grouping and
// the decision's reads, step 2 by the mask's 1 B a row.
//
// What bounds them on an H100, and what the design does about it:
//   - K12 takes its decision in sorted order, where every read is
//     coalesced: the segment of each sorted position (seg, an int32 id or
//     the first K11 presort word, its field above `shift` bits; a segment
//     outside [0, num) is the sentinel or a row that is not real, both
//     sorted last), the segment's first position starts[s] and limit
//     limits[s], read in nondecreasing s; it reads order[i] only at a
//     kept position. With one limit and rank < limit (sample, the takes)
//     only the first `limit` positions of each segment can be kept:
//     where num * limit <= n, a candidate is one (segment, rank) pair,
//     position starts[s] + rank, kept where that position's segment is
//     still s (the tail test), so the work is num * limit positions, not
//     the frame, and the mask's 1 B a row bounds it. In the walk over
//     every position (EXCEPT ALL, INTERSECT ALL) it reads 4-8 B of
//     segment a position and the start and limit of each segment, and
//     moves 12 B a kept row (order, and the offset written and read).
//   - K13 takes one candidate a segment: it reads the segment's first
//     row, occupancy and count (coalesced); its work is the segments and
//     the 1 B a row of the mask.
//   - K14 reads one byte a row of each of the M masks and of the row
//     validity and writes one keep byte, all coalesced: at four masks
//     0.149 ms at 100M rows. A row a thread, a byte load a mask, moved 32
//     B a warp's load with at most four loads in flight a thread, too few
//     bytes in flight to fill HBM (0.468 ms, 3.1x the bound), and the
//     wrapper uploaded the masks' pointer array from pageable memory on
//     every call. So each thread takes groups of 16 consecutive rows,
//     kGroupsPer of them at a time: one 16-byte streaming load a mask a
//     group (and of row_valid in a masked frame), the masks added in byte
//     lanes (__vadd4; past kByteLanes masks widened into ints), the keep
//     test one per-byte compare (__vcmpgeu4) against `need`, worked out
//     once on the host from the mode, thresh and the columns without masks
//     (need <= 0 keeps every real row and need > M none, without reading a
//     mask), and one 16-byte streaming store of the flags; a prefix frame
//     compares with nrows only in the group that straddles it and reads no
//     mask past it. The count is __popc of the flag words, summed by warp,
//     one atomic a block. Up to kParamMasks mask pointers go by value in
//     the kernel's parameters, more through a device array the wrapper
//     copies from pinned memory. The rows past the last whole group, and
//     every row where a mask, row_valid or keep is not 16-byte aligned,
//     take a row a thread. Rows: rows [0, n) are read; a row is real where
//     it is below nrows (a prefix frame) or, with nrows = -1, where its
//     row_valid byte is non-zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "launch.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
// K14: mask pointers passed by value (more go through a device array); a
// thread's groups of consecutive rows, one 16-byte load a mask each, and
// how many it has in flight; the masks whose ones a byte lane can count
constexpr int kParamMasks = 64;
constexpr int kGroupRows = 16;
constexpr int kGroupsPer = 2;
constexpr int kByteLanes = 255;
// K12 and K13: a slab of 2^18 rows (its bits, 32 KB, in the shared memory
// of one block of kBuildThreads); at most 8192 slabs (n < 2^31); step 1's
// blocks of kPartThreads take at most kItems candidates a thread a tile
constexpr int kSlabShift = 18;
constexpr int kSlabRows = 1 << kSlabShift;
constexpr int kItems = 16;
constexpr int kPartThreads = 1024;
constexpr int kBuildThreads = 512;

// K13's predicates and K14's tests, as the wrappers pass them
constexpr int kAll = 0, kHit = 1, kMiss = 2;
constexpr int kAny = 0, kAllNull = 1, kThresh = 2;

__device__ __forceinline__ bool is_real(long long nrows, const uint8_t* row_valid,
                                        long long r) {
  return nrows >= 0 ? r < nrows : __ldg(row_valid + r) != 0;
}

// Adds the block's sum of v (one int a thread, Threads a block) to *count
// with one atomic; every thread of the block calls it.
template <int Threads = kThreads>
__device__ __forceinline__ void block_count(int v, int* count) {
  __shared__ int warp_sums[Threads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) warp_sums[warp] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int k = 0; k < Threads / 32; ++k) total += warp_sums[k];
    if (total != 0) atomicAdd(count, total);
  }
}

struct SlabParams {
  long long n;
  int nslabs;       // ceil(n / kSlabRows)
  unsigned* slots;  // nslabs buckets of kSlabRows offsets in the slab
  int* fill;        // int32 [nslabs]: each bucket's entries, zeroed
  uint8_t* keep;    // bool [n]
  int* count;       // int32 0-d: zeroed by step 1's kernel, summed by step 2's
};

// The exclusive prefix sum of v over the block's threads (kPartThreads), and
// the block's total in *total; every thread of the block calls it.
// scratch holds kPartThreads / 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kPartThreads / 32; ++w) {
    const int t = scratch[w];
    before += w < warp ? t : 0;
    all += t;
  }
  *total = all;
  __syncthreads();
  return before + x - v;
}

// Step 1: the kept rows of a block's tile, partitioned by slab. A tile is
// kPartThreads * items candidates, items (at most kItems) chosen so that a
// small candidate count still spreads over the wave; each thread decides
// items of them (decide(idx, row), coalesced across the block) and counts
// its kept rows in the block's histogram of slabs; a scan of the
// histogram stages the tile's kept rows in shared memory grouped by slab;
// the block reserves one run a slab in the slab's bucket with one atomic
// (fill); and consecutive threads copy the staged rows into the runs, so
// the stores are coalesced. Every thread of the block calls it, over
// candidates [0, work). The kept rows are distinct (K12's order is a
// permutation; K13's kept segments have distinct first rows), so a slab's
// bucket of kSlabRows entries holds them; an entry past it is dropped
// rather than written out of bounds. Shared memory: step1_smem(nslabs).
template <typename Decide>
__device__ __forceinline__ void partition_kept(long long work, const Decide& decide,
                                               const SlabParams sp) {
  extern __shared__ int smem[];
  int* hist = smem;                  // nslabs: counts, then each run's start in its bucket
  int* scan = hist + sp.nslabs;      // nslabs: each slab's first staged entry
  int* staged = scan + sp.nslabs;    // kPartThreads * kItems kept rows, by slab
  int* warp_tot = staged + kPartThreads * kItems;
  const long long lanes = (long long)gridDim.x * kPartThreads;
  const long long want = (work + lanes - 1) / lanes;
  const int items = want < 1 ? 1 : (want > kItems ? kItems : (int)want);
  const long long tile = (long long)kPartThreads * items;
  const int per = (sp.nslabs + kPartThreads - 1) / kPartThreads;  // slabs a thread scans
  const int lo = threadIdx.x * per, hi = min(lo + per, sp.nslabs);
  for (long long t0 = (long long)blockIdx.x * tile; t0 < work; t0 += (long long)gridDim.x * tile) {
    for (int j = threadIdx.x; j < sp.nslabs; j += kPartThreads) hist[j] = 0;
    __syncthreads();
    // the decisions first, with no atomic between them, so that their
    // loads are in flight together; then the histogram
    int rows[kItems], local[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      rows[k] = -1;
      const long long idx = t0 + (long long)k * kPartThreads + threadIdx.x;
      long long row = -1;
      if (k < items && idx < work && decide(idx, row) &&
          (unsigned long long)row < (unsigned long long)sp.n)
        rows[k] = (int)row;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      local[k] = rows[k] >= 0 ? atomicAdd(hist + (rows[k] >> kSlabShift), 1) : 0;
    }
    __syncthreads();
    int sum = 0;
    for (int j = lo; j < hi; ++j) sum += hist[j];
    int total = 0;
    int at = block_exclusive_scan(sum, warp_tot, &total);
    for (int j = lo; j < hi; ++j) {
      const int c = hist[j];
      scan[j] = at;
      at += c;
      if (c != 0) hist[j] = atomicAdd(sp.fill + j, c);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (rows[k] >= 0) staged[scan[rows[k] >> kSlabShift] + local[k]] = rows[k];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < total; j += kPartThreads) {
      const int row = staged[j];
      const int slab = row >> kSlabShift;
      const int pos = hist[slab] + (j - scan[slab]);
      if (pos < kSlabRows) sp.slots[((long long)slab << kSlabShift) + pos] =
          (unsigned)row & (kSlabRows - 1);
    }
    __syncthreads();
  }
}

// Step 1's dynamic shared memory, in bytes.
__host__ __device__ constexpr int step1_smem(int nslabs) {
  return (int)sizeof(int) * (2 * nslabs + kPartThreads * kItems + kPartThreads / 32);
}

// Four bits, each as one byte 0 or 1 (bit k to byte k).
__device__ __forceinline__ unsigned spread4(unsigned b) {
  return ((b & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Step 2: one block a slab of kSlabRows rows. It sets the bits of the
// slab's kept rows in shared memory, then writes the slab's keep bytes,
// 16 rows a thread with one 16-byte store (the mask's allocation is
// 16-byte aligned), and adds their count to *count.
__global__ void __launch_bounds__(kBuildThreads) build_slabs(const SlabParams p) {
  extern __shared__ unsigned bits[];  // kSlabRows / 32 words
  const long long r0 = (long long)blockIdx.x << kSlabShift;
  const int rows = (int)(p.n - r0 < kSlabRows ? p.n - r0 : kSlabRows);
  for (int w = threadIdx.x; w < (rows + 31) / 32; w += kBuildThreads) bits[w] = 0;
  __syncthreads();
  const unsigned* bucket = p.slots + r0;
  const int kept = min(p.fill[blockIdx.x], kSlabRows);
  // four loads in flight a thread
  int j = threadIdx.x;
  for (; j + 3 * kBuildThreads < kept; j += 4 * kBuildThreads) {
    unsigned off[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) off[u] = __ldg(bucket + j + u * kBuildThreads);
#pragma unroll
    for (int u = 0; u < 4; ++u) atomicOr(bits + (off[u] >> 5), 1u << (off[u] & 31));
  }
  for (; j < kept; j += kBuildThreads) {
    const unsigned off = __ldg(bucket + j);
    atomicOr(bits + (off >> 5), 1u << (off & 31));
  }
  __syncthreads();
  int acc = 0;
  uint8_t* keep = p.keep + r0;
  for (int c = threadIdx.x; c < (rows + 15) / 16; c += kBuildThreads) {
    const unsigned h = (bits[c >> 1] >> ((c & 1) * 16)) & 0xFFFFu;
    acc += __popc(h);
    const int r = c * 16;
    if (r + 16 <= rows) {
      *reinterpret_cast<uint4*>(keep + r) =
          make_uint4(spread4(h), spread4(h >> 4), spread4(h >> 8), spread4(h >> 12));
    } else {
      for (int k = 0; r + k < rows; ++k) keep[r + k] = (h >> k) & 1u;
    }
  }
  block_count<kBuildThreads>(acc, p.count);
}

struct RankParams {
  const long long* order;    // int64 [n]: the rows in sorted order
  const void* seg;           // int32 or int64 [n] in sorted order; null: one segment
  unsigned long long flip;   // xor'ed into a seg value (a K11 word's container top bit)
  int shift;                 // the bits below the segment's field
  const long long* starts;   // int64 [num]: each segment's first sorted position
  long long num;
  const long long* limit;    // int64 0-d, or null
  const int* limits;         // int32 [num], or null
  int ge;                    // keep rank >= limit, else rank < limit
};

// The segment of sorted position i, or -1 outside [0, num).
template <typename T>
__device__ __forceinline__ long long segment_at(const RankParams& p, long long i) {
  using U = typename std::conditional<sizeof(T) == 8, unsigned long long, unsigned>::type;
  const U u = (U)__ldg(static_cast<const T*>(p.seg) + i) ^ (U)p.flip;
  const unsigned long long s = (unsigned long long)u >> p.shift;
  return s < (unsigned long long)p.num ? (long long)s : -1;
}

// One limit, rank < limit: candidate t is the pair (segment t / limit,
// rank t % limit), position starts[s] + rank, kept where that position's
// segment is still s (the tail test).
template <typename T>
struct PairWalk {
  RankParams p;
  long long n, lim;
  __device__ bool operator()(long long t, long long& row) const {
    const long long s = t / lim;
    const bool segmented = p.seg != nullptr;
    const long long i = (segmented ? __ldg(p.starts + s) : 0) + (t - s * lim);
    if (i < 0 || i >= n || (segmented && segment_at<T>(p, i) != s)) return false;
    row = __ldg(p.order + i);
    return true;
  }
};

// Every position i in sorted order: its segment, rank and limit.
template <typename T>
struct PositionWalk {
  RankParams p;
  long long n, lim;
  __device__ bool operator()(long long i, long long& row) const {
    long long rank = i, l = lim;
    if (p.seg != nullptr) {
      const long long s = segment_at<T>(p, i);
      if (s < 0) return false;
      rank = i - __ldg(p.starts + s);
      if (p.limits != nullptr) l = __ldg(p.limits + s);
    }
    if (rank < 0 || (p.ge ? rank < l : rank >= l)) return false;
    row = __ldg(p.order + i);
    return true;
  }
};

template <typename T>
__global__ void __launch_bounds__(kPartThreads)
    rank_keep(const RankParams p, const SlabParams sp) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *sp.count = 0;
  const long long nseg = p.seg != nullptr ? p.num : 1;
  const long long lim = p.limit != nullptr ? __ldg(p.limit) : 0;
  if (p.limits == nullptr && !p.ge && (nseg == 0 || lim <= 0 || lim <= sp.n / nseg)) {
    const long long work = nseg > 0 && lim > 0 ? nseg * lim : 0;
    partition_kept(work, PairWalk<T>{p, sp.n, lim}, sp);
  } else {
    partition_kept(sp.n, PositionWalk<T>{p, sp.n, lim}, sp);
  }
}

struct FirstParams {
  long long num;
  const int* first_idx;     // int32 [num]
  const uint8_t* occupied;  // bool [num], or null: every segment
  const int* counts;        // int32 [num] (kHit, kMiss)
  int mode;
};

// Segment g's first row, where its predicate holds.
struct FirstRow {
  FirstParams p;
  long long n;
  __device__ bool operator()(long long g, long long& row) const {
    const int f = __ldg(p.first_idx + g);
    if (f < 0 || f >= n || (p.occupied != nullptr && __ldg(p.occupied + g) == 0)) return false;
    if (p.mode != kAll) {
      const int c = __ldg(p.counts + g);
      if (p.mode == kHit ? c <= 0 : c != 0) return false;
    }
    row = f;
    return true;
  }
};

__global__ void __launch_bounds__(kPartThreads)
    first_row_mask(const FirstParams p, const SlabParams sp) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *sp.count = 0;
  partition_kept(p.num, FirstRow{p, sp.n}, sp);
}

struct NullParams {
  long long n;
  long long nrows;                   // rows [0, nrows) real; -1: by row_valid
  const uint8_t* row_valid;
  const uint8_t* const* masks;       // device array of the nmasks pointers above kParamMasks
  const uint8_t* mask[kParamMasks];  // the pointers themselves, up to kParamMasks
  int nmasks;
  int need;                          // keep a real row where at least need masks are set
  bool vec;                          // masks, row_valid and keep 16-byte aligned
  uint8_t* keep;                     // bool [n]
  int* count;                        // int32 0-d, zeroed by the caller
};

__device__ __forceinline__ const uint8_t* mask_at(const NullParams& p, int j) {
  if (p.masks == nullptr) return p.mask[j];
  return reinterpret_cast<const uint8_t*>(
      __ldg(reinterpret_cast<const unsigned long long*>(p.masks) + j));
}

__device__ __forceinline__ void add4(uint4& s, const uint4& x) {
  s.x = __vadd4(s.x, x.x), s.y = __vadd4(s.y, x.y);
  s.z = __vadd4(s.z, x.z), s.w = __vadd4(s.w, x.w);
}

// Masks [j0, j1) (at most kByteLanes of them) added into byte lanes over
// each live group's 16 rows: one 16-byte streaming load a mask a group,
// the loads of kGroupsPer groups and four masks issued together.
__device__ __forceinline__ void add_masks(const NullParams& p, int j0, int j1,
                                          const long long* g, const bool* live, uint4* sum) {
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const uint4* m = reinterpret_cast<const uint4*>(mask_at(p, j));
    uint4 x[kGroupsPer];
#pragma unroll
    for (int k = 0; k < kGroupsPer; ++k) x[k] = live[k] ? __ldcs(m + g[k]) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < kGroupsPer; ++k) add4(sum[k], x[k]);
  }
}

// Byte b of a group's four words.
__device__ __forceinline__ unsigned byte_of(const uint4& v, int b) {
  const unsigned w = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return (w >> (8 * (b & 3))) & 0xFFu;
}

// The keep flags of kGroupsPer groups of kGroupRows rows, groups g0, g0 +
// stride, ...: 0/1 bytes, real rows only; a group at or past `groups` is
// left alone.
__device__ __forceinline__ void keep_groups(const NullParams& p, long long g0, long long stride,
                                            long long groups, bool read, uint4* keep) {
  long long g[kGroupsPer];
  bool live[kGroupsPer];
  uint4 real[kGroupsPer];
#pragma unroll
  for (int k = 0; k < kGroupsPer; ++k) {
    g[k] = g0 + k * stride;
    const long long r0 = g[k] * kGroupRows;
    const bool exists = g[k] < groups;
    real[k] = make_uint4(0, 0, 0, 0);
    if (p.nrows >= 0) {  // a prefix frame: only the group that straddles nrows compares
      live[k] = exists && r0 < p.nrows;
      if (live[k]) {
        const long long left = p.nrows - r0;
        unsigned w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long in = left - 4 * q;  // real rows of this word
          w[q] = in >= 4 ? 0x01010101u : in <= 0 ? 0u : 0x01010101u >> (8 * (4 - in));
        }
        real[k] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {
      live[k] = exists;
      if (exists) {
        const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p.row_valid + r0));
        real[k] = make_uint4(__vcmpne4(v.x, 0u) & 0x01010101u, __vcmpne4(v.y, 0u) & 0x01010101u,
                             __vcmpne4(v.z, 0u) & 0x01010101u, __vcmpne4(v.w, 0u) & 0x01010101u);
      }
    }
  }
  if (!read) {  // no mask decides: every real row (need <= 0) or none
#pragma unroll
    for (int k = 0; k < kGroupsPer; ++k) keep[k] = p.need <= 0 ? real[k] : make_uint4(0, 0, 0, 0);
    return;
  }
  uint4 sum[kGroupsPer];
#pragma unroll
  for (int k = 0; k < kGroupsPer; ++k) sum[k] = make_uint4(0, 0, 0, 0);
  if (p.nmasks <= kByteLanes) {  // at most 255 ones a byte lane: one compare a word
    add_masks(p, 0, p.nmasks, g, live, sum);
    const unsigned need4 = (unsigned)p.need * 0x01010101u;
#pragma unroll
    for (int k = 0; k < kGroupsPer; ++k)
      keep[k] = make_uint4(__vcmpgeu4(sum[k].x, need4) & real[k].x,
                           __vcmpgeu4(sum[k].y, need4) & real[k].y,
                           __vcmpgeu4(sum[k].z, need4) & real[k].z,
                           __vcmpgeu4(sum[k].w, need4) & real[k].w);
    return;
  }
  // more masks: the byte lanes of each kByteLanes masks widened into ints
  int cnt[kGroupsPer][kGroupRows] = {};
  for (int j0 = 0; j0 < p.nmasks; j0 += kByteLanes) {
#pragma unroll
    for (int k = 0; k < kGroupsPer; ++k) sum[k] = make_uint4(0, 0, 0, 0);
    add_masks(p, j0, min(j0 + kByteLanes, p.nmasks), g, live, sum);
#pragma unroll
    for (int k = 0; k < kGroupsPer; ++k)
#pragma unroll
      for (int b = 0; b < kGroupRows; ++b) cnt[k][b] += (int)byte_of(sum[k], b);
  }
#pragma unroll
  for (int k = 0; k < kGroupsPer; ++k) {
    unsigned w[4] = {};
#pragma unroll
    for (int b = 0; b < kGroupRows; ++b)
      w[b >> 2] |= (unsigned)(cnt[k][b] >= p.need) << (8 * (b & 3));
    keep[k] = make_uint4(w[0] & real[k].x, w[1] & real[k].y, w[2] & real[k].z, w[3] & real[k].w);
  }
}

// K14: a persistent wave. On the vector route each thread takes kGroupsPer
// groups of kGroupRows consecutive rows at a time (keep_groups) and stores
// each group's flags with one 16-byte streaming store; the rows past the
// last whole group, and every row on the scalar route, take a row a thread.
// The kept rows are counted by __popc of the flag words, summed by warp,
// one atomic a block.
__global__ void __launch_bounds__(kThreads)
    null_count_keep(const __grid_constant__ NullParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool read = p.need >= 1 && p.need <= p.nmasks;  // else no mask decides
  int acc = 0;
  long long tail = 0;  // the first row of the scalar form
  if (p.vec) {
    const long long groups = p.n / kGroupRows;
    tail = groups * kGroupRows;
    for (long long g0 = tid; g0 < groups; g0 += kGroupsPer * stride) {
      uint4 keep[kGroupsPer];
      keep_groups(p, g0, stride, groups, read, keep);
#pragma unroll
      for (int k = 0; k < kGroupsPer; ++k) {
        const long long g = g0 + k * stride;
        if (g >= groups) continue;
        __stcs(reinterpret_cast<uint4*>(p.keep) + g, keep[k]);
        acc += __popc(keep[k].x) + __popc(keep[k].y) + __popc(keep[k].z) + __popc(keep[k].w);
      }
    }
  }
  for (long long r = tail + tid; r < p.n; r += stride) {
    bool keep = false;
    if (is_real(p.nrows, p.row_valid, r)) {
      if (read) {
        int valid = 0;
        for (int j = 0; j < p.nmasks; ++j) valid += __ldcs(mask_at(p, j) + r);
        keep = valid >= p.need;
      } else {
        keep = p.need <= 0;
      }
    }
    p.keep[r] = keep;
    acc += keep;
  }
  block_count(acc, p.count);
}

}  // namespace

// The plain C entry points, bound with ctypes. Each returns a cudaError_t
// (0 when every call was accepted), launches on stream (a cudaStream_t of
// device), allocates nothing and sets *launched to 1 where it launched
// its kernel. Row counts are below 2^31.

constexpr int kMaxDevices = 64;

// One wave of Kernel (the blocks of `threads` that the device's SMs hold
// at once with `smem` bytes of dynamic shared memory, whose cap it raises
// to that), cached by device for the last smem asked.
template <auto Kernel>
cudaError_t wave_of(int threads, int smem, int device, long long* wave) {
  static std::mutex lock;
  static int cached_smem[kMaxDevices];
  static long long cached_wave[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  if (cached_wave[device] == 0 || cached_smem[device] != smem) {
    cudaError_t err =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(Kernel), threads, smem);
    if (err != cudaSuccess) return err;
    cached_wave[device] = (long long)sms * (per_sm > 0 ? per_sm : 1);
    cached_smem[device] = smem;
  }
  *wave = cached_wave[device];
  return cudaSuccess;
}

// Launches a step-1 kernel (Kernel(p, sp)) over `work` candidates: one
// wave, or fewer blocks where the candidates need fewer.
template <auto Kernel, typename P>
cudaError_t launch_step1(long long work, int device, cudaStream_t st, const P& p,
                         const SlabParams& sp) {
  const int smem = step1_smem(sp.nslabs);
  long long wave = 0;
  cudaError_t err = wave_of<Kernel>(kPartThreads, smem, device, &wave);
  if (err != cudaSuccess) return err;
  const long long need = work > 0 ? (work + kPartThreads - 1) / kPartThreads : 1;
  void* args[] = {const_cast<P*>(&p), const_cast<SlabParams*>(&sp)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(Kernel),
                         dim3((unsigned)(need < wave ? need : wave)), dim3(kPartThreads), args,
                         smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Step 1's kernel (launched by step1(sp), which it is given) between
// the clearing of the buckets' fill counts and step 2's launch, one block
// a slab. slots is scratch of ceil(n / 2^18) * 2^18 uint32 and fill of
// ceil(n / 2^18) int32.
template <typename F>
cudaError_t select_rows(long long n, void* slots, void* fill, void* keep, void* count,
                        int device, cudaStream_t st, F step1) {
  SlabParams sp = {n, (int)((n + kSlabRows - 1) >> kSlabShift), static_cast<unsigned*>(slots),
                   static_cast<int*>(fill), static_cast<uint8_t*>(keep),
                   static_cast<int*>(count)};
  cudaError_t e = cudaMemsetAsync(fill, 0, (size_t)sp.nslabs * sizeof(int), st);
  if (e == cudaSuccess) e = step1(sp);
  if (e != cudaSuccess) return e;
  const int smem = kSlabRows / 8;
  long long wave = 0;
  e = wave_of<build_slabs>(kBuildThreads, smem, device, &wave);
  if (e != cudaSuccess) return e;
  void* args[] = {&sp};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(build_slabs), dim3(sp.nslabs),
                       dim3(kBuildThreads), args, smem, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// K12. order int64 [n]; seg_bytes 0 (no segment: one segment of every
// position), 4 (seg int32 [n]) or 8 (int64 [n]), in sorted order, the
// segment (seg ^ flip) >> shift taken unsigned, with word 1 flipping the
// container's top bit (a K11 word) and 0 none (an id); starts int64 [num]
// (num >= 0 with seg); exactly one of limit (int64 0-d) and limits (int32
// [num], with seg), or neither where num is 0 (nothing is kept); ge 0
// (rank < limit) or 1 (rank >= limit). slots and fill are scratch (see
// select_rows). Writes keep bool [n] (16-byte aligned) and count int32 0-d.
extern "C" int fugue_rank_keep(long long n, const void* order, const void* seg, int seg_bytes,
                               int word, int shift, const void* starts, long long num,
                               const void* limit, const void* limits, int ge, void* slots,
                               void* fill, void* keep, void* count, int device, void* stream,
                               int* launched) {
  *launched = 0;
  const bool segmented = seg_bytes != 0;
  if (n < 1 || n >= (1LL << 31) || (seg_bytes != 0 && seg_bytes != 4 && seg_bytes != 8) ||
      (segmented && (seg == nullptr || num < 0 || num >= (1LL << 31) ||
                     (num > 0 && starts == nullptr) || shift < 0 || shift >= 8 * seg_bytes)) ||
      (limit != nullptr && limits != nullptr) || (limits != nullptr && !segmented) ||
      (limit == nullptr && limits == nullptr && !(segmented && num == 0)) ||
      reinterpret_cast<uintptr_t>(keep) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  RankParams p = {};
  p.order = static_cast<const long long*>(order);
  p.seg = segmented ? seg : nullptr;
  p.flip = word ? 1ULL << (8 * seg_bytes - 1) : 0;
  p.shift = shift;
  p.starts = static_cast<const long long*>(starts);
  p.num = segmented ? num : 1;
  p.limit = static_cast<const long long*>(limit);
  p.limits = static_cast<const int*>(limits);
  p.ge = ge;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&] {
    return select_rows(n, slots, fill, keep, count, device, st, [&](const SlabParams& sp) {
      // the wave is sized for every position; the pair walk uses as much of it as it needs
      return seg_bytes == 8 ? launch_step1<rank_keep<long long>>(n, device, st, p, sp)
                            : launch_step1<rank_keep<int>>(n, device, st, p, sp);
    });
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// K13. first_idx int32 [num]; occupied bool [num] or null; counts int32
// [num] for mode 1 (counts > 0) and 2 (counts == 0), else null (mode 0:
// every segment); slots and fill scratch (see select_rows). Sets keep
// bool [n] (16-byte aligned) at each kept segment's first row, clears it
// elsewhere, and writes the kept rows' count.
extern "C" int fugue_first_row_mask(long long num, const void* first_idx, const void* occupied,
                                    const void* counts, int mode, long long n, void* slots,
                                    void* fill, void* keep, void* count, int device,
                                    void* stream, int* launched) {
  *launched = 0;
  if (n < 1 || n >= (1LL << 31) || num < 0 || num >= (1LL << 31) || mode < kAll ||
      mode > kMiss || ((mode != kAll) != (counts != nullptr)) ||
      reinterpret_cast<uintptr_t>(keep) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  FirstParams p = {num, static_cast<const int*>(first_idx),
                   static_cast<const uint8_t*>(occupied), static_cast<const int*>(counts),
                   mode};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&] {
    return select_rows(n, slots, fill, keep, count, device, st, [&](const SlabParams& sp) {
      return launch_step1<first_row_mask>(num, device, st, p, sp);
    });
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// K14. masks: a host array of nmasks pointers to bool [n] (null when
// nmasks is 0), read here; dev_masks: the same pointers in device memory,
// read by the kernel above 64 masks (else null); ncols >= nmasks the
// columns tested; mode 0 (any: every column valid), 1 (all: any column
// valid) or 2 (at least thresh valid); rows as for K12. Writes keep bool
// [n]; adds the kept rows to count, which the caller zeroed. *launched is
// 1 on the vector route (every mask, row_valid and keep 16-byte aligned),
// 2 on the scalar one.
extern "C" int fugue_null_count_keep(long long n, long long nrows, const void* row_valid,
                                     const void* const* masks, const void* dev_masks,
                                     int nmasks, int ncols, int mode, int thresh, void* keep,
                                     void* count, int device, void* stream, int* launched) {
  *launched = 0;
  if (n < 1 || n >= (1LL << 31) || (nrows < 0 && row_valid == nullptr) || nmasks < 0 ||
      ncols < nmasks || (nmasks > 0 && masks == nullptr) ||
      (nmasks > kParamMasks && dev_masks == nullptr) || mode < kAny || mode > kThresh)
    return (int)cudaErrorInvalidValue;
  auto at16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  NullParams p = {};
  p.n = n;
  p.nrows = nrows;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  p.nmasks = nmasks;
  p.vec = at16(keep) && (nrows >= 0 || at16(row_valid));
  for (int j = 0; j < nmasks; ++j) {
    if (masks[j] == nullptr) return (int)cudaErrorInvalidValue;
    p.vec = p.vec && at16(masks[j]);
    if (nmasks <= kParamMasks) p.mask[j] = static_cast<const uint8_t*>(masks[j]);
  }
  if (nmasks > kParamMasks) p.masks = static_cast<const uint8_t* const*>(dev_masks);
  // a row's valid columns are (ncols - nmasks) + its set masks
  const long long others = (long long)ncols - nmasks;
  const long long need = mode == kThresh ? (long long)thresh - others
                         : mode == kAny  ? (long long)nmasks
                                         : 1 - others;
  p.need = (int)(need < 0 ? 0 : need > nmasks ? (long long)nmasks + 1 : need);
  p.keep = static_cast<uint8_t*>(keep);
  p.count = static_cast<int*>(count);
  const long long work = p.vec ? (n + kGroupRows * kGroupsPer - 1) / (kGroupRows * kGroupsPer) : n;
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(null_count_keep, work, kThreads, device,
                       static_cast<cudaStream_t>(stream), p);
  });
  if (err == cudaSuccess) *launched = p.vec ? 1 : 2;
  return (int)err;
}

// The message of a cudaError_t, for the wrappers' exceptions.
extern "C" const char* fugue_row_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
