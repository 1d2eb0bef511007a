// Joins on the card: K7 join_build, K8 join_probe and K9 join_expand.
//
// They replace the one-device join programs of the JAX package's
// relational.py, which XLA lowers to scatters, gathers and scans; none
// of it is a Pallas kernel:
//   - K7 join_build: the build side's per-segment table. Counts mode is
//     the segment_count of semi_anti_join's _prog (:298-300) and of
//     expand_join's _count_prog (:466, and the left side's counts of a
//     full outer join, :484-489); slot mode is _unique_right_join's
//     scatter-max of each right row's position into its segment (:674-678).
//     For NOT IN (not_in_join's _prog, :356-367) it also counts, into two
//     device ints, the side's real rows and its real rows with a null key.
//   - K8 join_probe: each probe row reads its segment's entry once and
//     writes by mode: semi/anti keep flags (:301-306; the full outer
//     join's right-unmatched mask is anti mode over the right side against
//     the left side's counts, :490-493), the unique route's right row and
//     keep flag (:679-682, :688), or the expansion's matches m and output
//     rows reps (:470-474), or SQL's three-valued NOT IN (:368-369): keep =
//     real & (empty2 | (notnull1 & !any_null2 & !hit)), empty2 and
//     any_null2 read from K7's two side counts on the card; in every mode
//     it folds a total into one device counter, int32 for a lazy row
//     count, int64 for the output size M.
//   - K9 join_expand: each output row's probe row and build row, what
//     _gather_prog computes by scatter marks, a cumsum, a clamp and two
//     gathers (:568-577).
// Contracts: join_build_reference, join_probe_reference and
// join_expand_reference in reference.py.
//
// Rows of a side: rows [0, n) are read; a row is real where it is below
// nrows (a prefix frame) or, with nrows = -1, where its row_valid byte is
// non-zero; it is matchable where it is also free of null keys (nulls
// byte zero, or no nulls array) and its segment lies in [0, num).
//
// What bounds them on an H100, and what the design does about it:
//   - K7 reads 4 B of segment id and 1-2 B of flags a row and writes 4*num
//     B. One row a thread a step over a persistent wave; up to 12288
//     segments (48 KB) each block keeps its own table in shared memory and
//     merges the entries its rows touched with one global atomic each,
//     above that rows update the global table. A segment that every row
//     shares (a cross join, a skewed key) then contends in shared memory,
//     not in L2.
//   - K8 reads the same per row plus one random 4 B read of the table, and
//     writes its outputs. One row a thread a step; each thread sums its
//     rows' total in a register, the block in shared memory, and one
//     atomic a block adds it to the counter.
//   - K9 writes 8 B an output row and reads 16 B a probe row (start, m,
//     seg), and reads one cstart a probe row and each output's build row
//     in order, at random places (one run of order a probe row). Each
//     block takes kTile consecutive output rows, whatever the runs that
//     hold them: a first launch finds the probe row of every tile's first
//     output (one binary search over start a thread, all tiles at once);
//     the second reads the tile's probe rows once, coalesced, and each
//     row that owns outputs there writes its number, m, seg and cstart
//     into shared memory at the slot its run starts; a block-wide max
//     scan then gives every output its row, with no search an output.
//     A tile whose outputs span more than kWalk probe rows (a selective
//     inner join: most rows unmatched) would read them all; its block
//     binary-searches start over the range for each output instead, so a
//     block's work stays bounded by its kTile outputs. Each thread writes
//     8 consecutive outputs of li and ri with 16-byte stores, and a run
//     of any length (a cross join's p2, a skewed key's 10^6) is split
//     over as many blocks as it fills. The random cstart
//     and order reads bound it: at 200M outputs of 100M probe rows on an
//     NVIDIA H100 80GB HBM3 at 700 W, 7.33 ms, of which 1.2 remain without
//     them (a search an output took 9.12); what raised the rate of those
//     reads was more blocks an SM, from 24 KB of shared memory a block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kSharedMax = 12288;  // segments of a block's own K7 table
constexpr int kPerThread = 8;      // K9 output rows a thread (one 16-byte load of slots)
constexpr int kRowsPer = 4;        // K9 probe rows a thread a step of its marks
constexpr long long kTile = (long long)kThreads * kPerThread;
// K9: a tile's probe rows read, at most (2 MB of start). At 100M probe rows
// with one match in 50 (about 50 tiles of rows a tile) reading them took
// 0.54 ms on an NVIDIA H100 80GB HBM3 at 700 W, a search an output 0.74
// (PERF.md §6)
constexpr long long kWalk = 64 * kTile;

// K8 modes, as the wrapper passes them
constexpr int kSemi = 0, kAnti = 1, kUnique = 2, kExpand = 3, kNotIn = 4;

struct Side {
  long long n;
  long long nrows;           // rows [0, nrows) real; -1: by row_valid
  const uint8_t* row_valid;  // bool/uint8 [n] where nrows is -1
  const uint8_t* nulls;      // bool [n], true where a key is null; null: none
  const int* seg;            // int32 [n]
  int num;
};

// Whether row r is real; *s is its segment where it is also matchable,
// else -1.
__device__ __forceinline__ bool side_row(const Side& d, long long r, int* s) {
  *s = -1;
  const bool real = d.nrows >= 0 ? r < d.nrows : __ldg(d.row_valid + r) != 0;
  if (!real) return false;
  if (d.nulls != nullptr && __ldg(d.nulls + r) != 0) return true;
  const int v = __ldg(d.seg + r);
  if ((unsigned)v < (unsigned)d.num) *s = v;
  return true;
}

struct BuildParams {
  Side side;
  int slots;   // slot mode: the highest row of each segment, else counts
  int* table;  // int32 [num], filled by the caller with 0 (counts) or -1
  int* stats;  // int32 [2], zeroed by the caller: real rows, real rows with a null key; or null
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads) join_build(const BuildParams p) {
  __shared__ int local[kShared ? kSharedMax : 1];
  const int num = p.side.num;
  const int fill = p.slots ? -1 : 0;
  int* table = kShared ? local : p.table;
  if (kShared) {
    for (int i = threadIdx.x; i < num; i += kThreads) local[i] = fill;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * kThreads;
  int real_rows = 0, null_rows = 0;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < p.side.n;
       r += stride) {
    int s;
    if (side_row(p.side, r, &s)) {
      ++real_rows;
      null_rows += p.side.nulls != nullptr && __ldg(p.side.nulls + r) != 0;
    }
    if (s < 0) continue;
    if (p.slots) {
      atomicMax(table + s, (int)r);
    } else {
      atomicAdd(table + s, 1);
    }
  }
  if (p.stats != nullptr) {  // a warp's sums, one atomic each a warp
    real_rows = (int)__reduce_add_sync(0xffffffffu, (unsigned)real_rows);
    null_rows = (int)__reduce_add_sync(0xffffffffu, (unsigned)null_rows);
    if ((threadIdx.x & 31) == 0) {
      if (real_rows != 0) atomicAdd(p.stats, real_rows);
      if (null_rows != 0) atomicAdd(p.stats + 1, null_rows);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < num; i += kThreads) {
      const int v = local[i];
      if (v == fill) continue;
      if (p.slots) {
        atomicMax(p.table + i, v);
      } else {
        atomicAdd(p.table + i, v);
      }
    }
  }
}

struct ProbeParams {
  Side side;
  const int* table;  // int32 [num]: K7's counts, or its slots (unique)
  const int* stats;  // int32 [2]: K7's side counts of the build side (not_in)
  int mode;
  int outer;
  uint8_t* keep;     // bool [n]: semi, anti, unique
  int* ridx;         // int32 [n]: unique
  int* m;            // int32 [n]: expand
  int* reps;         // int32 [n]: expand
  int* count;        // int32 0-d, zeroed by the caller: semi, anti, unique
  unsigned long long* total;  // int64 0-d, zeroed by the caller: expand
};

__global__ void __launch_bounds__(kThreads) join_probe(const ProbeParams p) {
  __shared__ long long part[kThreads];
  long long acc = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < p.side.n;
       r += stride) {
    int s;
    const bool real = side_row(p.side, r, &s);
    const int entry = s >= 0 ? __ldg(p.table + s) : (p.mode == kUnique ? -1 : 0);
    if (p.mode == kExpand) {
      const int reps = real ? (p.outer && entry < 1 ? 1 : entry) : 0;
      p.m[r] = entry;
      p.reps[r] = reps;
      acc += reps;
      continue;
    }
    bool keep;
    if (p.mode == kUnique) {
      p.ridx[r] = entry;
      keep = p.outer ? real : entry >= 0;
    } else if (p.mode == kNotIn) {
      // an empty build side keeps every row; a null on it keeps none
      const bool null = p.side.nulls != nullptr && __ldg(p.side.nulls + r) != 0;
      const bool empty2 = __ldg(p.stats) == 0, any_null2 = __ldg(p.stats + 1) > 0;
      keep = real && (empty2 || (!null && !any_null2 && entry <= 0));
    } else {
      const bool hit = entry > 0;
      keep = p.mode == kSemi ? hit : real && !hit;
    }
    p.keep[r] = keep;
    acc += keep;
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0 && part[0] != 0) {
    if (p.mode == kExpand) {
      atomicAdd(p.total, (unsigned long long)part[0]);
    } else {
      atomicAdd(p.count, (int)part[0]);
    }
  }
}

struct ExpandParams {
  long long p1;
  long long total;           // M, the output rows
  const long long* start;    // int64 [p1]: exclusive prefix sum of reps
  const int* m;              // int32 [p1]
  const int* seg;            // int32 [p1]
  int num;
  const long long* cstart;   // int64 [num]: each segment's first position in order
  const long long* order;    // int64 [p2]: build rows grouped by segment
  long long p2;
  long long* tiles;          // int64 [tiles + 1]: the probe row of each tile's first output
  long long ntiles;
  int* li;                   // int32 [total]
  int* ri;                   // int32 [total]
  bool vec;                  // li and ri are 16-byte aligned: 16-byte stores
};

// The last row i in [lo, hi] with start[i] <= t, given start[lo] <= t.
__device__ __forceinline__ long long last_at_or_below(const long long* start, long long lo,
                                                      long long hi, long long t) {
  while (lo < hi) {
    const long long mid = lo + (hi - lo + 1) / 2;
    if (start[mid] <= t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// K9's first launch: the probe row that holds the first output row of
// each tile (and, at index ntiles, of the last output row), one binary
// search a thread, all tiles at once.
__global__ void __launch_bounds__(kThreads) expand_tiles(const ExpandParams p) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b > p.ntiles) return;
  const long long t = b < p.ntiles ? b * kTile : p.total - 1;
  p.tiles[b] = last_at_or_below(p.start, 0, p.p1 - 1, t);
}

// K9's second launch: each block writes one tile of kTile output rows
// (slots), whose probe rows lie in [tiles[b], tiles[b + 1]], with no
// search an output. Row tiles[b] owns slot 0; each later row of the range
// that owns outputs (its run is not empty: its start is below the next
// row's) owns the slot where its run starts, and reads its m, seg and
// cstart[seg] once into shared memory under that slot. A block-wide max
// scan of the owned slots then gives every slot its row. Rows whose runs
// are empty (an inner join's unmatched rows) are read and skipped, so a
// tile's range may hold up to kWalk probe rows; past that, each slot's
// row comes from a binary search over start in the range. A run longer
// than a tile is row tiles[b] of every tile it covers.
__global__ void __launch_bounds__(kThreads) join_expand(const ExpandParams p) {
  constexpr int kWarps = kThreads / 32;
  // 24 KB a block: slots (< kTile) as 16-bit words, so more blocks fit an
  // SM and more of the random reads are in flight (32 KB of 32-bit words
  // took 9.59 ms at join_timing's 200M outputs, 24 KB 7.33; PERF.md §6)
  __shared__ __align__(16) short owner[kTile];  // slot -> the slot its row's run starts at
  __shared__ int srow[kTile];    // by first slot: the probe row
  __shared__ short slim[kTile];  // by first slot: slots below it have a build row
  __shared__ int soff[kTile];    // by first slot: order position of slot 0, clamped
  __shared__ int warp_sh[kWarps];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int width = (int)(p.total - t0 < kTile ? p.total - t0 : kTile);
  const long long i0 = p.tiles[blockIdx.x], i1 = p.tiles[blockIdx.x + 1];
  const int q0 = threadIdx.x * kPerThread;
  int li[kPerThread], ri[kPerThread];
  if (i1 - i0 > kWalk) {
    // a sparse tile: each slot's row by a search over the range (the
    // branch is the block's: i0 and i1 are its own)
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      li[j] = 0;
      ri[j] = -1;
      if (q0 + j >= width) continue;
      const long long t = t0 + q0 + j;
      const long long i = last_at_or_below(p.start, i0, i1, t);
      const long long k = t - __ldg(p.start + i);
      li[j] = (int)i;
      if (k < __ldg(p.m + i)) {
        int sg = __ldg(p.seg + i);
        sg = sg < 0 ? 0 : (sg >= p.num ? p.num - 1 : sg);
        long long pos = __ldg(p.cstart + sg) + k;
        pos = pos < 0 ? 0 : (pos >= p.p2 ? p.p2 - 1 : pos);
        ri[j] = (int)__ldg(p.order + pos);
      }
    }
  } else {
    for (int q = threadIdx.x; q < kTile; q += kThreads) owner[q] = -1;
    __syncthreads();
    // kRowsPer rows a thread a step, each read's loads issued together
    for (long long step = i0; step <= i1; step += (long long)kThreads * kRowsPer) {
      long long s[kRowsPer], cs[kRowsPer];
      int mm[kRowsPer], q[kRowsPer];
      bool owns[kRowsPer];
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) {
        const long long i = step + (long long)k * kThreads + threadIdx.x;
        owns[k] = i <= i1;
        s[k] = owns[k] ? __ldg(p.start + i) : 0;
        const long long next = owns[k] && i + 1 < p.p1 ? __ldg(p.start + i + 1) : p.total;
        q[k] = (int)(s[k] - t0);
        // row tiles[b] owns slot 0; a later row, the slot its run starts at,
        // unless its run is empty or starts in the next tile (tiles[b + 1]
        // is the row of the next tile's first output)
        if (i == i0)
          q[k] = 0;
        else if (s[k] >= next || s[k] - t0 >= width)
          owns[k] = false;
      }
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) {
        const long long i = step + (long long)k * kThreads + threadIdx.x;
        int sg = owns[k] ? __ldg(p.seg + i) : 0;
        mm[k] = owns[k] ? __ldg(p.m + i) : 0;
        sg = sg < 0 ? 0 : (sg >= p.num ? p.num - 1 : sg);
        cs[k] = owns[k] ? __ldg(p.cstart + sg) : 0;
      }
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) {
        if (!owns[k]) continue;
        const long long lim = s[k] + mm[k] - t0;
        long long off = cs[k] - s[k] + t0;
        off = off < -kTile ? -kTile : (off > p.p2 ? p.p2 : off);
        srow[q[k]] = (int)(step + (long long)k * kThreads + threadIdx.x);
        slim[q[k]] = (int)(lim < 0 ? 0 : (lim > kTile ? kTile : lim));
        soff[q[k]] = (int)off;
        owner[q[k]] = q[k];
      }
    }
    __syncthreads();

    // the max scan of the owned slots, kPerThread consecutive slots a thread
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int own[kPerThread];
    {
      const int4 v = *reinterpret_cast<const int4*>(owner + q0);  // kPerThread 16-bit slots
      const short* h = reinterpret_cast<const short*>(&v);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) own[j] = h[j];
    }
#pragma unroll
    for (int j = 1; j < kPerThread; ++j) own[j] = own[j] > own[j - 1] ? own[j] : own[j - 1];
    int incl = own[kPerThread - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d && o > incl) incl = o;
    }
    if (lane == 31) warp_sh[warp] = incl;
    int before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = -1;
    __syncthreads();
    for (int w = 0; w < warp; ++w) before = warp_sh[w] > before ? warp_sh[w] : before;

#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int r = q0 + j;
      const int o = own[j] > before ? own[j] : before;  // slot 0 is owned: o >= 0
      li[j] = srow[o];
      ri[j] = -1;
      if (r < width && r < slim[o]) {
        long long pos = (long long)soff[o] + r;
        pos = pos < 0 ? 0 : (pos >= p.p2 ? p.p2 - 1 : pos);
        ri[j] = (int)__ldg(p.order + pos);
      }
    }
  }
  const long long t = t0 + q0;
  if (q0 + kPerThread <= width && p.vec) {
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      reinterpret_cast<int4*>(p.li + t)[k] =
          make_int4(li[4 * k], li[4 * k + 1], li[4 * k + 2], li[4 * k + 3]);
      reinterpret_cast<int4*>(p.ri + t)[k] =
          make_int4(ri[4 * k], ri[4 * k + 1], ri[4 * k + 2], ri[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (q0 + j < width) {
        p.li[t + j] = li[j];
        p.ri[t + j] = ri[j];
      }
  }
}

}  // namespace

// K7. The side is (n, nrows or -1 with row_valid, nulls or null, seg,
// num); table is int32 [num], filled by the caller with 0 (counts) or -1
// (slots); stats int32 [2] zeroed by the caller, or null (NOT IN's side
// counts). device is the CUDA ordinal of the tensors, stream a
// cudaStream_t of it. Returns a cudaError_t; *path is 1 (per-block tables
// in shared memory), 2 (the global table) or 0 (no row: nothing launched).
extern "C" int fugue_join_build(long long n, long long nrows, const void* row_valid,
                                const void* nulls, const void* seg, int num, int slots,
                                void* table, void* stats, int device, void* stream,
                                int* path) {
  *path = 0;
  if (num < 1 || (nrows < 0 && row_valid == nullptr)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  BuildParams p = {};
  p.side = {n, nrows, static_cast<const uint8_t*>(row_valid),
            static_cast<const uint8_t*>(nulls), static_cast<const int*>(seg), num};
  p.slots = slots;
  p.table = static_cast<int*>(table);
  p.stats = static_cast<int*>(stats);
  const bool shared = num <= kSharedMax;
  void (*kernel)(BuildParams) = shared ? join_build<true> : join_build<false>;
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(kernel, n, kThreads, device, static_cast<cudaStream_t>(stream), p);
  });
  if (err == cudaSuccess) *path = shared ? 1 : 2;
  return (int)err;
}

// K8. The side as for K7; table int32 [num]; stats K7's int32 [2] side
// counts (not_in), or null; mode 0 semi, 1 anti, 2 unique, 3 expand, 4
// not_in; the outputs the mode writes (see ProbeParams), the counter
// zeroed by the caller. Returns a cudaError_t; *launched is 1
// where the kernel was launched.
extern "C" int fugue_join_probe(long long n, long long nrows, const void* row_valid,
                                const void* nulls, const void* seg, int num, const void* table,
                                const void* stats, int mode, int outer, void* keep, void* ridx,
                                void* m,
                                void* reps, void* count, void* total, int device,
                                void* stream, int* launched) {
  *launched = 0;
  if (num < 1 || mode < kSemi || mode > kNotIn || (nrows < 0 && row_valid == nullptr) ||
      (mode == kNotIn && stats == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((mode == kExpand && (m == nullptr || reps == nullptr || total == nullptr)) ||
      (mode != kExpand && (keep == nullptr || count == nullptr)) ||
      (mode == kUnique && ridx == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  ProbeParams p = {};
  p.side = {n, nrows, static_cast<const uint8_t*>(row_valid),
            static_cast<const uint8_t*>(nulls), static_cast<const int*>(seg), num};
  p.table = static_cast<const int*>(table);
  p.stats = static_cast<const int*>(stats);
  p.mode = mode;
  p.outer = outer;
  p.keep = static_cast<uint8_t*>(keep);
  p.ridx = static_cast<int*>(ridx);
  p.m = static_cast<int*>(m);
  p.reps = static_cast<int*>(reps);
  p.count = static_cast<int*>(count);
  p.total = static_cast<unsigned long long*>(total);
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(join_probe, n, kThreads, device, static_cast<cudaStream_t>(stream), p);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// K9. start int64 [p1], m and seg int32 [p1], cstart int64 [num], order
// int64 [p2]; tiles int64 [ceil(total / kTile) + 1], scratch; li and ri
// int32 [total]. Returns a cudaError_t; *launched is 1 where the kernel
// was launched (total > 0).
extern "C" int fugue_join_expand(long long p1, long long total, const void* start,
                                 const void* m, const void* seg, int num, const void* cstart,
                                 const void* order, long long p2, void* tiles, void* li,
                                 void* ri, int device, void* stream, int* launched) {
  *launched = 0;
  if (p1 < 1 || p2 < 1 || num < 1 || total < 0) return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  ExpandParams p = {};
  p.p1 = p1;
  p.total = total;
  p.start = static_cast<const long long*>(start);
  p.m = static_cast<const int*>(m);
  p.seg = static_cast<const int*>(seg);
  p.num = num;
  p.cstart = static_cast<const long long*>(cstart);
  p.order = static_cast<const long long*>(order);
  p.p2 = p2;
  p.tiles = static_cast<long long*>(tiles);
  p.ntiles = (total + kTile - 1) / kTile;
  p.li = static_cast<int*>(li);
  p.ri = static_cast<int*>(ri);
  p.vec = reinterpret_cast<uintptr_t>(li) % 16 == 0 && reinterpret_cast<uintptr_t>(ri) % 16 == 0;
  const cudaError_t err = on_device(device, [&] {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = launch_params(expand_tiles, p.ntiles / kThreads + 1, kThreads, st, p);
    if (e != cudaSuccess) return e;
    return launch_params(join_expand, p.ntiles, kThreads, st, p);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* fugue_join_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
