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
//     B. Up to 12288 segments (48 KB) each block of a persistent wave
//     keeps its own table in shared memory and merges the entries its rows
//     touched with one global atomic each (the shared route); a segment
//     that every row shares (a cross join, a skewed key) then contends in
//     shared memory, not in L2. Above that the table is larger than L2 at
//     the sizes that matter (25M segments: 100 MB), where an atomic a row
//     on it ran at 2.78 ms for 50M rows and 36.7 with one segment holding
//     them all (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6). While the
//     table stays in L2 (join.py's GLOBAL_MAX) the global route keeps an
//     atomic a run of equal segments among a warp's lanes; above it the
//     slab route counts by slab of 2^kSegShift segments:
//       1. a count pass (each slab's entries, NOT IN's side counts), a
//          one-block plan (each bucket's start, and its pieces of at most
//          kPieceEntries entries) and a partition (slab_partition.cuh) of
//          each matchable row's segment into its slab's bucket: 4 B (the
//          offset in the slab and a run length), or 8 B with the row in
//          slot mode. A warp's lanes hold consecutive rows, and a run of
//          equal segments among them makes one entry;
//       2. a block a piece holds the slab's table in shared memory (128
//          KB), applies the entries with shared atomics (a warp whose
//          entries are all one segment, one atomic), and writes the table
//          once with 16-byte stores, fill values included; a slab of
//          several pieces is filled first (in step 1) and its pieces
//          merged with global atomics. A cluster's slab of 2^18 segments
//          in distributed shared memory, whose atomics cross SMs, took
//          0.80 ms for this step at 50M rows over 25M segments (PERF.md).
//   - K8 reads the same per row plus one random read of the table, and
//     writes its outputs. The random reads bound it: at 25M segments K7's
//     int32 table is 100 MB, twice the L2, and a read a row cost a 32 B
//     sector of HBM (2.88 ms for 100M probe rows; 4 MB of table in L2 still
//     0.67 ms for 80M). So the table is narrowed first: a launch reads it
//     once, coalesced, and writes one bit a segment (count > 0: semi, anti,
//     NOT IN) or one byte (expand: the count, 255 an escape to the int32
//     entry); unique mode keeps the int32 slots it returns. The probe then
//     reads its table from where join.py's probe_place puts it: byte
//     entries and slots that fit kProbeSharedBytes from a copy in each
//     block's shared memory; larger byte entries, and bits at every size
//     (they read faster through L2 and L1 than from a shared copy), from
//     the narrow copy in device memory under an L2 evict-last policy,
//     with the streams read and written evict-first; larger slots from
//     K7's table itself (the wide place). A last launch returns the narrow
//     copy's lines to the normal eviction priority, so that they do not
//     outlast the call ahead of the next kernels' data. Each thread takes
//     groups of 4 consecutive rows (16-byte loads and stores where the
//     side is aligned, 4 keep flags a store); each thread sums its rows'
//     total in a register, the block by warp, and one atomic a block adds
//     it to the counter.
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

#include <atomic>

#include "launch.cuh"
#include "slab_partition.cuh"

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

// NOT IN's side counts of a block: a warp's sums, one atomic each a warp.
__device__ __forceinline__ void add_side_counts(int* stats, int real_rows, int null_rows) {
  if (stats == nullptr) return;
  real_rows = (int)__reduce_add_sync(0xffffffffu, (unsigned)real_rows);
  null_rows = (int)__reduce_add_sync(0xffffffffu, (unsigned)null_rows);
  if ((threadIdx.x & 31) == 0) {
    if (real_rows != 0) atomicAdd(stats, real_rows);
    if (null_rows != 0) atomicAdd(stats + 1, null_rows);
  }
}

// The shared route (num <= kSharedMax).
__global__ void __launch_bounds__(kThreads) join_build(const BuildParams p) {
  __shared__ int local[kSharedMax];
  const int num = p.side.num;
  const int fill = p.slots ? -1 : 0;
  for (int i = threadIdx.x; i < num; i += kThreads) local[i] = fill;
  __syncthreads();
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
      atomicMax(local + s, (int)r);
    } else {
      atomicAdd(local + s, 1);
    }
  }
  add_side_counts(p.stats, real_rows, null_rows);
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

// ---- K7's global and slab routes ----------------------------------------------

constexpr int kSegShift = 15;  // segments a slab: a block's table, 128 KB of shared memory
constexpr unsigned kSegMask = (1u << kSegShift) - 1u;
constexpr int kPieceEntries = 1 << 18;  // a block's entries, at most (1-2 MB)
constexpr int kBuildUnroll = 4;  // a lane's entries with their loads in flight together
constexpr int kK7Threads = 512;
constexpr int kK7Items = 8;
constexpr long long kK7Tile = (long long)kK7Threads * kK7Items;
constexpr int kPlanThreads = 1024;
constexpr unsigned kNoSeg = 0xFFFFFFFFu;

struct SlabBuildParams {
  Side side;
  int slots;
  int* table;  // int32 [num]: written whole
  int* stats;  // as BuildParams
  int nslabs;
  int* counts;      // [nslabs], zeroed: each bucket's entries
  int* starts;      // [nslabs + 1]
  int* cursor;      // [nslabs]: ends at starts[s + 1]
  int* npieces;     // [1]
  int* multi;       // [nslabs]: the bucket has several pieces
  int* piece_slab;  // [max pieces]
  int* piece_lo;    // [max pieces]: its first entry
  unsigned* ent;             // counts: offset | (run - 1) << kSegShift
  unsigned long long* ent8;  // slots: highest row << 32 | offset
};

// Row r's segment where it is matchable (-1 else), and whether it is
// real, and real with a null key: side_row's answer with every load made
// up front, so that the loads of a thread's rows are in flight together.
__device__ __forceinline__ void read_row(const Side& d, long long r, int* s, bool* real,
                                         bool* null_key) {
  *s = -1;
  *real = *null_key = false;
  if (r >= d.n) return;
  const int v = __ldg(d.seg + r);
  const bool re = d.nrows >= 0 ? r < d.nrows : __ldg(d.row_valid + r) != 0;
  const bool nk = d.nulls != nullptr && __ldg(d.nulls + r) != 0;
  *real = re;
  *null_key = re && nk;
  if (re && !nk && (unsigned)v < (unsigned)d.num) *s = v;
}

// A lane's row's segment s (-1: none) in a warp whose lanes hold
// consecutive rows: s where the row heads a run of equal segments among
// the lanes (the run ending at a lane with another segment or none), -1
// where it heads none; *len the run's lanes. Every lane of the warp calls
// it.
__device__ __forceinline__ int run_head(int s, int* len) {
  const unsigned key = s >= 0 ? (unsigned)s : kNoSeg;
  const unsigned prev = __shfl_up_sync(0xffffffffu, key, 1);
  const int lane = threadIdx.x & 31;
  const bool head = s >= 0 && (lane == 0 || prev != key);
  const unsigned stop = __ballot_sync(0xffffffffu, head || s < 0);
  const unsigned above = stop & ~((2u << lane) - 1u);
  *len = (above != 0 ? __ffs((int)above) - 1 : 32) - lane;
  return head ? s : -1;
}

constexpr int kGlobalRows = 4;  // the global route's rows a thread a step

// The global route (kSharedMax < num, the table small enough to stay in
// L2: join.py's GLOBAL_MAX): each run of equal segments among a warp's
// lanes updates the table, filled by the caller, with one atomic.
__global__ void __launch_bounds__(kThreads) join_build_global(const BuildParams p) {
  constexpr long long kStep = (long long)kThreads * kGlobalRows;
  int real_rows = 0, null_rows = 0;
  // every lane of a warp takes the same steps (run_head)
  for (long long t0 = (long long)blockIdx.x * kStep; t0 < p.side.n;
       t0 += (long long)gridDim.x * kStep) {
    int s[kGlobalRows];
    bool real[kGlobalRows], null_key[kGlobalRows];
#pragma unroll
    for (int k = 0; k < kGlobalRows; ++k)
      read_row(p.side, t0 + (long long)k * kThreads + threadIdx.x, &s[k], &real[k],
               &null_key[k]);
#pragma unroll
    for (int k = 0; k < kGlobalRows; ++k) {
      real_rows += real[k];
      null_rows += null_key[k];
      int len;
      const int h = run_head(s[k], &len);
      if (h < 0) continue;
      if (p.slots) {
        atomicMax(p.table + h, (int)(t0 + (long long)k * kThreads + threadIdx.x + len - 1));
      } else {
        atomicAdd(p.table + h, len);
      }
    }
  }
  add_side_counts(p.stats, real_rows, null_rows);
}

// Step 1a: each slab's entries, and the side counts.
__global__ void __launch_bounds__(kK7Threads) join_slab_count(const SlabBuildParams p) {
  extern __shared__ int slab_counts[];
  for (int s = threadIdx.x; s < p.nslabs; s += kK7Threads) slab_counts[s] = 0;
  __syncthreads();
  int real_rows = 0, null_rows = 0;
  for (long long t0 = (long long)blockIdx.x * kK7Tile; t0 < p.side.n;
       t0 += (long long)gridDim.x * kK7Tile) {
    int s[kK7Items];
    bool real[kK7Items], null_key[kK7Items];
#pragma unroll
    for (int k = 0; k < kK7Items; ++k)
      read_row(p.side, t0 + (long long)k * kK7Threads + threadIdx.x, &s[k], &real[k],
               &null_key[k]);
#pragma unroll
    for (int k = 0; k < kK7Items; ++k) {
      real_rows += real[k];
      null_rows += null_key[k];
      int len;
      const int h = run_head(s[k], &len);
      warp_rank_add(slab_counts, h >= 0 ? h >> kSegShift : -1);
    }
  }
  add_side_counts(p.stats, real_rows, null_rows);
  __syncthreads();
  for (int s = threadIdx.x; s < p.nslabs; s += kK7Threads) {
    const int c = slab_counts[s];
    if (c != 0) atomicAdd(p.counts + s, c);
  }
}

__device__ __forceinline__ int pieces_of(int entries) {
  return entries <= kPieceEntries ? 1 : (entries + kPieceEntries - 1) / kPieceEntries;
}

// Step 1b, one block: each bucket's start, and its pieces.
__global__ void __launch_bounds__(kPlanThreads) join_slab_plan(const SlabBuildParams p) {
  __shared__ int warp_tot[kPlanThreads / 32];
  block_scan_counts<kPlanThreads>(p.counts, p.starts, p.cursor, p.nslabs, warp_tot);
  const int per = (p.nslabs + kPlanThreads - 1) / kPlanThreads;
  const int lo = min((int)threadIdx.x * per, p.nslabs), hi = min(lo + per, p.nslabs);
  int mine = 0;
  for (int j = lo; j < hi; ++j) mine += pieces_of(p.counts[j]);
  int total = 0;
  int at = block_exclusive_sum<kPlanThreads>(mine, warp_tot, &total);
  for (int j = lo; j < hi; ++j) {
    const int k = pieces_of(p.counts[j]);
    p.multi[j] = k > 1;
    for (int q = 0; q < k; ++q, ++at) {
      p.piece_slab[at] = j;
      p.piece_lo[at] = p.starts[j] + q * kPieceEntries;
    }
  }
  if (threadIdx.x == 0) *p.npieces = total;
}

// Step 1c: the slabs of several pieces filled, then the entries partitioned
// by slab, a persistent wave over tiles.
__global__ void __launch_bounds__(kK7Threads) join_slab_partition(const SlabBuildParams p) {
  extern __shared__ uint4 k7_smem[];
  auto* stage = reinterpret_cast<unsigned long long*>(k7_smem);  // run << 32 | segment
  int* hist = reinterpret_cast<int*>(stage + kK7Tile);
  int* warp_tot = hist + p.nslabs + 1;
  const int fill = p.slots ? -1 : 0;
  for (int s = blockIdx.x; s < p.nslabs; s += gridDim.x) {
    if (!p.multi[s]) continue;
    const long long a = (long long)s << kSegShift;
    const long long b = a + (1LL << kSegShift) < p.side.num ? a + (1LL << kSegShift) : p.side.num;
    for (long long i = a + threadIdx.x; i < b; i += kK7Threads) p.table[i] = fill;
  }
  for (long long t0 = (long long)blockIdx.x * kK7Tile; t0 < p.side.n;
       t0 += (long long)gridDim.x * kK7Tile) {
    int b[kK7Items], pos[kK7Items];
    unsigned long long v[kK7Items];
#pragma unroll
    for (int k = 0; k < kK7Items; ++k) {
      bool real, null_key;
      read_row(p.side, t0 + (long long)k * kK7Threads + threadIdx.x, &b[k], &real, &null_key);
    }
#pragma unroll
    for (int k = 0; k < kK7Items; ++k) {
      const long long r = t0 + (long long)k * kK7Threads + threadIdx.x;
      int len;
      const int s = run_head(b[k], &len);
      b[k] = s >= 0 ? s >> kSegShift : -1;
      // counts: the run's length; slots: its highest row (its last lane's)
      const unsigned long long hi = p.slots ? (unsigned long long)(r + len - 1) : len;
      v[k] = hi << 32 | (unsigned)s;
    }
    const int total = tile_slots<kK7Threads, kK7Items>(
        p.nslabs, b, pos, hist, warp_tot, [&](int j, int c) { return atomicAdd(p.cursor + j, c); });
#pragma unroll
    for (int k = 0; k < kK7Items; ++k)
      if (pos[k] >= 0) stage[pos[k]] = v[k];
    __syncthreads();
    for (int j = threadIdx.x; j < total; j += kK7Threads) {
      const unsigned long long e = stage[j];
      const unsigned s = (unsigned)e;
      const int slab = (int)(s >> kSegShift);
      const int at = hist[slab] + j;
      if (at >= p.starts[slab + 1]) continue;
      const unsigned hi = (unsigned)(e >> 32);
      if (p.slots) {
        p.ent8[at] = (unsigned long long)hi << 32 | (s & kSegMask);
      } else {
        p.ent[at] = (s & kSegMask) | (hi - 1u) << kSegShift;
      }
    }
    __syncthreads();
  }
}

// Step 2: a block a piece, the slab's table in its shared memory.
__global__ void __launch_bounds__(kImageThreads) join_slab_build(const SlabBuildParams p) {
  extern __shared__ int seg_img[];
  const int piece = blockIdx.x;
  if (piece >= *p.npieces) return;
  const int fill = p.slots ? -1 : 0;
  for (int i = threadIdx.x; i < (1 << kSegShift); i += kImageThreads) seg_img[i] = fill;
  __syncthreads();
  const int slab = p.piece_slab[piece];
  const long long lo = p.piece_lo[piece];
  const long long end = p.starts[slab + 1];
  const long long hi = lo + kPieceEntries < end ? lo + kPieceEntries : end;
  const int lane = threadIdx.x & 31;
  auto apply = [&](unsigned off, int v) {
    if (p.slots) {
      atomicMax(seg_img + off, v);
    } else {
      atomicAdd(seg_img + off, v);
    }
  };
  // every lane of a warp takes the same steps: the warp's entries are
  // base + u * kImageThreads + lane, kBuildUnroll of them loaded at once
  for (long long base = lo + (threadIdx.x & ~31); base < hi;
       base += (long long)kBuildUnroll * kImageThreads) {
    unsigned off[kBuildUnroll];
    int v[kBuildUnroll];
#pragma unroll
    for (int u = 0; u < kBuildUnroll; ++u) {
      const long long e = base + u * kImageThreads + lane;
      off[u] = kNoSeg;
      v[u] = 0;
      if (e >= hi) continue;
      if (p.slots) {
        const unsigned long long x = __ldcs(p.ent8 + e);
        off[u] = (unsigned)x & kSegMask;
        v[u] = (int)(x >> 32);
      } else {
        const unsigned x = __ldcs(p.ent + e);
        off[u] = x & kSegMask;
        v[u] = (int)(x >> kSegShift) + 1;
      }
    }
#pragma unroll
    for (int u = 0; u < kBuildUnroll; ++u) {
      const unsigned first = __shfl_sync(0xffffffffu, off[u], 0);
      const bool uniform = __all_sync(0xffffffffu, off[u] == first);
      const unsigned folded = p.slots ? __reduce_max_sync(0xffffffffu, (unsigned)v[u])
                                      : __reduce_add_sync(0xffffffffu, (unsigned)v[u]);
      if (uniform && first != kNoSeg) {
        if (lane == 0) apply(first, (int)folded);
      } else if (off[u] != kNoSeg) {
        apply(off[u], v[u]);
      }
    }
  }
  __syncthreads();
  // the slab's part of the table, 16 bytes a store (4 segments)
  const long long s0 = (long long)slab << kSegShift;
  const bool merge = p.multi[slab] != 0;
  for (int q = threadIdx.x; q < (1 << kSegShift) / 4; q += kImageThreads) {
    const long long g = s0 + 4LL * q;
    if (g >= p.side.num) break;
    const int* src = seg_img + 4 * q;
    if (!merge && g + 4 <= p.side.num) {
      *reinterpret_cast<int4*>(p.table + g) = *reinterpret_cast<const int4*>(src);
      continue;
    }
    for (int k = 0; k < 4 && g + k < p.side.num; ++k) {
      const int x = src[k];
      if (!merge) {
        p.table[g + k] = x;
      } else if (x != fill) {
        if (p.slots) {
          atomicMax(p.table + g + k, x);
        } else {
          atomicAdd(p.table + g + k, x);
        }
      }
    }
  }
}

// ---- K8 join_probe ------------------------------------------------------------

// Where a probe reads its table (join.py's probe_place): a copy in each
// block's shared memory (byte entries, slots), the narrow copy in device
// memory read with an L2 evict-last policy (bits, byte entries), or K7's
// int32 table itself (slots).
constexpr int kPlaceShared = 0, kPlaceL2 = 1, kPlaceWide = 2;
// a block's copy of the table, at most (join.py's PROBE_SHARED_BYTES)
constexpr int kProbeSharedBytes = 200 * 1024;
constexpr int kProbeThreads = 1024;
constexpr int kProbeGroups = 4;  // groups of 4 consecutive rows a thread a step
constexpr long long kProbeWarpRows = 32LL * kProbeGroups * 4;
constexpr long long kProbeTile = (long long)kProbeThreads * kProbeGroups * 4;
constexpr int kNarrowThreads = 256;
constexpr unsigned kEscape = 255;  // a byte entry: the count is 255 or more, read the int32

struct ProbeParams {
  Side side;
  const int* table;     // int32 [num]: K7's counts, or its slots (unique)
  const void* narrow;   // bits (semi, anti, not_in: uint32 [ceil(num / 32)], bit s of word
                        // s / 32 set where the count is above 0) or bytes (expand: uint8
                        // [num], min(count, 255)); null in unique mode
  long long narrow_bytes;  // its bytes, rounded up to 128 (the lines the last launch releases)
  long long narrow_words;  // 4-byte words a block copies to shared memory (shared place)
  const int* stats;  // int32 [2]: K7's side counts of the build side (not_in)
  int mode;
  int outer;
  bool vec;          // seg 16-byte aligned, row_valid and nulls 4-byte aligned
  uint8_t* keep;     // bool [n]: semi, anti, unique, not_in
  int* ridx;         // int32 [n]: unique
  int* m;            // int32 [n]: expand
  int* reps;         // int32 [n]: expand
  int* count;        // int32 0-d, zeroed by the caller: every mode but expand
  unsigned long long* total;  // int64 0-d, zeroed by the caller: expand
};

// The narrowing launch: each warp reads 32 consecutive entries of K7's
// table, coalesced, and writes their bits as one word.
__global__ void __launch_bounds__(kNarrowThreads) join_probe_narrow_bits(const ProbeParams p) {
  const int lane = threadIdx.x & 31;
  const long long words = ((long long)p.side.num + 31) / 32;
  const long long warps = (long long)gridDim.x * (kNarrowThreads / 32);
  unsigned* bits = static_cast<unsigned*>(const_cast<void*>(p.narrow));
  // w is the warp's own: every lane takes the same steps
  for (long long w = ((long long)blockIdx.x * kNarrowThreads + threadIdx.x) >> 5; w < words;
       w += warps) {
    const long long i = w * 32 + lane;
    const bool hit = i < p.side.num && __ldcs(p.table + i) > 0;
    const unsigned word = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) bits[w] = word;
  }
}

// The narrowing launch of expand mode: each thread reads 4 consecutive
// entries (one 16-byte load where aligned) and writes their bytes.
__global__ void __launch_bounds__(kNarrowThreads) join_probe_narrow_bytes(const ProbeParams p) {
  uint8_t* bytes = static_cast<uint8_t*>(const_cast<void*>(p.narrow));
  const long long num = p.side.num;
  const bool aligned = reinterpret_cast<uintptr_t>(p.table) % 16 == 0;
  auto narrow = [](int c) { return (unsigned)(c < (int)kEscape ? (c < 0 ? 0 : c) : kEscape); };
  for (long long q = (long long)blockIdx.x * kNarrowThreads + threadIdx.x; q * 4 < num;
       q += (long long)gridDim.x * kNarrowThreads) {
    const long long i = q * 4;
    if (aligned && i + 4 <= num) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(p.table + i));
      reinterpret_cast<unsigned*>(bytes)[q] =
          narrow(v.x) | narrow(v.y) << 8 | narrow(v.z) << 16 | narrow(v.w) << 24;
    } else {
      for (long long k = i; k < num && k < i + 4; ++k)
        bytes[k] = (uint8_t)narrow(__ldcs(p.table + k));
    }
  }
}

// An L2 evict-last policy for the narrow table's reads: the streams read
// and written beside them are evict-first (__ldcs, __stcs), so the table
// stays in L2 while they pass through.
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ unsigned load_last_u32(const unsigned* at, unsigned long long policy) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(at), "l"(policy));
  return v;
}

__device__ __forceinline__ unsigned load_last_u8(const uint8_t* at, unsigned long long policy) {
  unsigned short v;
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;" : "=h"(v) : "l"(at), "l"(policy));
  return v;
}

// The last launch of the L2 place: each thread returns one 128-byte line
// of the narrow table to the normal eviction priority.
__global__ void __launch_bounds__(kNarrowThreads) join_probe_release(const ProbeParams p) {
  const char* lines = static_cast<const char*>(p.narrow);
  const long long step = (long long)gridDim.x * kNarrowThreads;
  for (long long i = (long long)blockIdx.x * kNarrowThreads + threadIdx.x; i * 128 < p.narrow_bytes;
       i += step)
    asm volatile("applypriority.global.L2::evict_normal [%0], 128;" ::"l"(lines + i * 128)
                 : "memory");
}

// Segment s's entry (s in [0, num)): hit 0/1 (semi, anti, not_in), the
// count (expand) or the slot (unique), from where Place keeps it: slots in
// shared memory or K7's table, byte entries in shared memory or the narrow
// copy, bits in the narrow copy.
template <int Mode, int Place>
__device__ __forceinline__ int probe_entry(const ProbeParams& p, const void* sh, int s,
                                           unsigned long long policy) {
  if (Mode == kUnique)
    return Place == kPlaceShared ? static_cast<const int*>(sh)[s] : __ldg(p.table + s);
  if (Mode == kExpand) {
    const unsigned b = Place == kPlaceShared
                           ? static_cast<const uint8_t*>(sh)[s]
                           : load_last_u8(static_cast<const uint8_t*>(p.narrow) + s, policy);
    return b == kEscape ? __ldg(p.table + s) : (int)b;
  }
  const unsigned word = load_last_u32(static_cast<const unsigned*>(p.narrow) + (s >> 5), policy);
  return (int)((word >> (s & 31)) & 1u);
}

// A group of 4 consecutive rows from `base`: each row's segment where it
// is matchable (-1 else), whether it is real and whether its key is null.
__device__ __forceinline__ void probe_group(const ProbeParams& p, long long base, int s[4],
                                            unsigned* real, unsigned* null) {
  const Side& d = p.side;
  *real = *null = 0;
  if (p.vec && base + 4 <= d.n) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(d.seg + base));
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
    const unsigned rv =
        d.nrows >= 0 ? 0u : __ldcs(reinterpret_cast<const unsigned*>(d.row_valid + base));
    const unsigned nl =
        d.nulls == nullptr ? 0u : __ldcs(reinterpret_cast<const unsigned*>(d.nulls + base));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool re = d.nrows >= 0 ? base + k < d.nrows : ((rv >> (8 * k)) & 0xffu) != 0u;
      const bool nk = ((nl >> (8 * k)) & 0xffu) != 0u;
      *real |= (unsigned)re << k;
      *null |= (unsigned)nk << k;
      if (!re || nk || (unsigned)s[k] >= (unsigned)d.num) s[k] = -1;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long r = base + k;
    s[k] = -1;
    if (r >= d.n) continue;
    const int v = __ldcs(d.seg + r);
    const bool re = d.nrows >= 0 ? r < d.nrows : __ldcs(d.row_valid + r) != 0;
    const bool nk = d.nulls != nullptr && __ldcs(d.nulls + r) != 0;
    *real |= (unsigned)re << k;
    *null |= (unsigned)nk << k;
    if (re && !nk && (unsigned)v < (unsigned)d.num) s[k] = v;
  }
}

// K8: each thread takes kProbeGroups groups of 4 consecutive rows a step
// (a warp's groups side by side, so each load and store of the warp is one
// coalesced run), loads all their streams, then reads all their entries,
// then writes by mode: 4 keep flags in one 4-byte store, m, reps and ridx
// in 16-byte stores. The block's total is one atomic.
template <int Mode, int Place>
__global__ void __launch_bounds__(kProbeThreads, 1) join_probe(const ProbeParams p) {
  extern __shared__ uint4 probe_table[];
  __shared__ long long warp_total[kProbeThreads / 32];
  const void* sh = probe_table;
  if (Place == kPlaceShared) {
    // the block's copy of the narrow table (the slots themselves in unique mode)
    const unsigned* src = Mode == kUnique ? reinterpret_cast<const unsigned*>(p.table)
                                          : static_cast<const unsigned*>(p.narrow);
    unsigned* dst = reinterpret_cast<unsigned*>(probe_table);
    const long long vecs = reinterpret_cast<uintptr_t>(src) % 16 == 0 ? p.narrow_words / 4 : 0;
    for (long long i = threadIdx.x; i < vecs; i += kProbeThreads)
      probe_table[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    for (long long i = vecs * 4 + threadIdx.x; i < p.narrow_words; i += kProbeThreads)
      dst[i] = __ldg(src + i);
    __syncthreads();
  }
  const unsigned long long policy = Place == kPlaceL2 ? evict_last_policy() : 0ull;
  const bool empty2 = Mode == kNotIn && __ldg(p.stats) == 0;
  const bool any_null2 = Mode == kNotIn && __ldg(p.stats + 1) > 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long acc = 0;
  for (long long t0 = (long long)blockIdx.x * kProbeTile; t0 < p.side.n;
       t0 += (long long)gridDim.x * kProbeTile) {
    const long long w0 = t0 + warp * kProbeWarpRows + lane * 4;
    int s[kProbeGroups][4];
    unsigned real[kProbeGroups], null[kProbeGroups];
#pragma unroll
    for (int g = 0; g < kProbeGroups; ++g) probe_group(p, w0 + g * 128, s[g], &real[g], &null[g]);
    int e[kProbeGroups][4];
#pragma unroll
    for (int g = 0; g < kProbeGroups; ++g)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        e[g][k] = s[g][k] >= 0 ? probe_entry<Mode, Place>(p, sh, s[g][k], policy)
                               : (Mode == kUnique ? -1 : 0);
#pragma unroll
    for (int g = 0; g < kProbeGroups; ++g) {
      const long long base = w0 + g * 128;
      if (base >= p.side.n) break;
      const bool full = base + 4 <= p.side.n;
      if (Mode == kExpand) {
        int reps[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool re = (real[g] >> k) & 1u;
          reps[k] = re ? (p.outer && e[g][k] < 1 ? 1 : e[g][k]) : 0;
          acc += reps[k];
        }
        if (full) {
          __stcs(reinterpret_cast<int4*>(p.m + base),
                 make_int4(e[g][0], e[g][1], e[g][2], e[g][3]));
          __stcs(reinterpret_cast<int4*>(p.reps + base),
                 make_int4(reps[0], reps[1], reps[2], reps[3]));
        } else {
          for (int k = 0; k < 4 && base + k < p.side.n; ++k) {
            p.m[base + k] = e[g][k];
            p.reps[base + k] = reps[k];
          }
        }
        continue;
      }
      unsigned flags = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool re = (real[g] >> k) & 1u;
        bool keep;
        if (Mode == kUnique) {
          keep = p.outer ? re : e[g][k] >= 0;
        } else if (Mode == kNotIn) {
          // an empty build side keeps every row; a null on it keeps none
          const bool nk = (null[g] >> k) & 1u;
          keep = re && (empty2 || (!nk && !any_null2 && e[g][k] == 0));
        } else if (Mode == kSemi) {
          keep = e[g][k] != 0;
        } else {
          keep = re && e[g][k] == 0;
        }
        flags |= (unsigned)keep << (8 * k);
        acc += keep;
      }
      if (full) {
        __stcs(reinterpret_cast<unsigned*>(p.keep + base), flags);
        if (Mode == kUnique)
          __stcs(reinterpret_cast<int4*>(p.ridx + base),
                 make_int4(e[g][0], e[g][1], e[g][2], e[g][3]));
      } else {
        for (int k = 0; k < 4 && base + k < p.side.n; ++k) {
          p.keep[base + k] = (uint8_t)((flags >> (8 * k)) & 1u);
          if (Mode == kUnique) p.ridx[base + k] = e[g][k];
        }
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, d);
  if (lane == 0) warp_total[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
    for (int w = 0; w < kProbeThreads / 32; ++w) sum += warp_total[w];
    if (sum != 0) {
      if (Mode == kExpand) {
        atomicAdd(p.total, (unsigned long long)sum);
      } else {
        atomicAdd(p.count, (int)sum);
      }
    }
  }
}

using ProbeKernel = void (*)(ProbeParams);

// The probe of a mode at a place, or null where join.py's probe_place never
// puts that mode's table.
ProbeKernel probe_kernel(int mode, int place) {
  const bool shared = place == kPlaceShared;
  switch (mode) {
    case kSemi: return place == kPlaceL2 ? join_probe<kSemi, kPlaceL2> : nullptr;
    case kAnti: return place == kPlaceL2 ? join_probe<kAnti, kPlaceL2> : nullptr;
    case kNotIn: return place == kPlaceL2 ? join_probe<kNotIn, kPlaceL2> : nullptr;
    case kExpand:
      return shared ? join_probe<kExpand, kPlaceShared>
             : place == kPlaceL2 ? join_probe<kExpand, kPlaceL2> : nullptr;
    case kUnique:
      return shared ? join_probe<kUnique, kPlaceShared>
             : place == kPlaceWide ? join_probe<kUnique, kPlaceWide> : nullptr;
    default: return nullptr;
  }
}

// Lets the shared place's probes take kProbeSharedBytes of dynamic shared
// memory, once a device (bit d of `allowed`: device d).
cudaError_t allow_shared_table(int device) {
  static std::atomic<unsigned long long> allowed{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (allowed.load() & bit) return cudaSuccess;
  const ProbeKernel shared[] = {join_probe<kExpand, kPlaceShared>,
                                join_probe<kUnique, kPlaceShared>};
  for (ProbeKernel k : shared) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kProbeSharedBytes);
    if (e != cudaSuccess) return e;
  }
  allowed.fetch_or(bit);
  return cudaSuccess;
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

// K7, shared route (num at most kSharedMax, join.py's SHARED_MAX) or
// global route (above). The side is (n, nrows or -1 with row_valid, nulls
// or null, seg, num); table is int32 [num], filled by the caller with 0
// (counts) or -1 (slots); stats int32 [2] zeroed by the caller, or null
// (NOT IN's side counts). device is the CUDA ordinal of the tensors,
// stream a cudaStream_t of it. Returns a cudaError_t; *path is 1
// (per-block tables in shared memory), 2 (the global table) or 0 (no row:
// nothing launched).
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
  void (*kernel)(BuildParams) = shared ? join_build : join_build_global;
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(kernel, n, kThreads, device, static_cast<cudaStream_t>(stream), p);
  });
  if (err == cudaSuccess) *path = shared ? 1 : 2;
  return (int)err;
}

// The ints of K7's slab route's scratch (`meta`) for n rows over num
// segments, and the bytes of its entries.
extern "C" void fugue_join_slab_shape(long long n, int num, int slots, long long* meta_ints,
                                      long long* entry_bytes) {
  const long long nslabs = slab_count(num, kSegShift);
  const long long pieces = nslabs + (n + kPieceEntries - 1) / kPieceEntries;
  *meta_ints = 4 * nslabs + 2 + 2 * pieces;
  *entry_bytes = n * (slots ? 8 : 4);
}

// K7, slab route (any num): the side, slots, stats, device and stream as
// for fugue_join_build; table int32 [num], written whole (no fill);
// meta and entries scratch as fugue_join_slab_shape sizes them. Returns a
// cudaError_t; *launched is 1 where the kernels were launched (n > 0).
extern "C" int fugue_join_build_slab(long long n, long long nrows, const void* row_valid,
                                     const void* nulls, const void* seg, int num, int slots,
                                     void* table, void* stats, void* meta, void* entries,
                                     int device, void* stream, int* launched) {
  *launched = 0;
  if (num < 1 || n >= (1LL << 31) || (nrows < 0 && row_valid == nullptr) ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  SlabBuildParams p = {};
  p.side = {n, nrows, static_cast<const uint8_t*>(row_valid),
            static_cast<const uint8_t*>(nulls), static_cast<const int*>(seg), num};
  p.slots = slots;
  p.table = static_cast<int*>(table);
  p.stats = static_cast<int*>(stats);
  p.nslabs = (int)slab_count(num, kSegShift);
  const long long pieces = p.nslabs + (n + kPieceEntries - 1) / kPieceEntries;
  p.counts = static_cast<int*>(meta);
  p.starts = p.counts + p.nslabs;
  p.cursor = p.starts + p.nslabs + 1;
  p.npieces = p.cursor + p.nslabs;
  p.multi = p.npieces + 1;
  p.piece_slab = p.multi + p.nslabs;
  p.piece_lo = p.piece_slab + pieces;
  p.ent = static_cast<unsigned*>(entries);
  p.ent8 = static_cast<unsigned long long*>(entries);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&]() -> cudaError_t {
    cudaError_t e = cudaMemsetAsync(p.counts, 0, sizeof(int) * (size_t)p.nslabs, st);
    if (e != cudaSuccess) return e;
    const long long tiles = (n + kK7Tile - 1) / kK7Tile;
    int grid = 0;
    const int count_smem = 4 * p.nslabs;
    e = allow_smem<join_slab_count>(device, count_smem);
    if (e == cudaSuccess)
      e = wave_blocks(join_slab_count, kK7Threads, count_smem, tiles, device, &grid);
    if (e != cudaSuccess) return e;
    join_slab_count<<<grid, kK7Threads, count_smem, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    join_slab_plan<<<1, kPlanThreads, 0, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int smem = (int)(kK7Tile * 8) + 4 * (p.nslabs + 1 + kK7Threads / 32);
    e = allow_smem<join_slab_partition>(device, smem);
    if (e == cudaSuccess)
      e = wave_blocks(join_slab_partition, kK7Threads, smem, tiles, device, &grid);
    if (e != cudaSuccess) return e;
    join_slab_partition<<<grid, kK7Threads, smem, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int img = 4 << kSegShift;
    e = allow_smem<join_slab_build>(device, img);
    if (e != cudaSuccess) return e;
    join_slab_build<<<pieces, kImageThreads, img, st>>>(p);
    return cudaGetLastError();
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// K8. The side as for K7; table int32 [num]; stats K7's int32 [2] side
// counts (not_in), or null; mode 0 semi, 1 anti, 2 unique, 3 expand, 4
// not_in; place 0 shared, 1 L2, 2 wide (join.py's probe_place: semi, anti
// and not_in take L2, expand shared or L2, unique shared or wide; the
// shared place's table at most kProbeSharedBytes); narrow the narrow
// table's scratch (bits or bytes, 128-byte aligned: join.py's
// probe_table_bytes rounded up to 128), null in unique mode; the outputs
// the mode writes (see ProbeParams), the counter zeroed by the caller.
// Returns a cudaError_t; *launched is 1 where the kernels were launched
// (the narrowing launch outside unique mode, the probe, and the release
// of the L2 place).
extern "C" int fugue_join_probe(long long n, long long nrows, const void* row_valid,
                                const void* nulls, const void* seg, int num, const void* table,
                                const void* stats, int mode, int outer, int place, void* narrow,
                                void* keep, void* ridx, void* m, void* reps, void* count,
                                void* total, int device, void* stream, int* launched) {
  *launched = 0;
  const ProbeKernel kernel = probe_kernel(mode, place);
  if (num < 1 || kernel == nullptr || (nrows < 0 && row_valid == nullptr) ||
      (mode == kNotIn && stats == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((mode == kExpand && (m == nullptr || reps == nullptr || total == nullptr)) ||
      (mode != kExpand && (keep == nullptr || count == nullptr)) ||
      (mode == kUnique && ridx == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool narrowed = mode != kUnique;
  if (narrowed && (narrow == nullptr || reinterpret_cast<uintptr_t>(narrow) % 128 != 0))
    return (int)cudaErrorInvalidValue;
  const bool bits = narrowed && mode != kExpand;
  const long long entries = mode == kUnique ? 4LL * num : bits ? (num + 31LL) / 32 * 4 : num;
  if (place == kPlaceShared && entries > kProbeSharedBytes) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  ProbeParams p = {};
  p.side = {n, nrows, static_cast<const uint8_t*>(row_valid),
            static_cast<const uint8_t*>(nulls), static_cast<const int*>(seg), num};
  p.table = static_cast<const int*>(table);
  p.narrow = narrowed ? narrow : nullptr;
  p.narrow_bytes = narrowed ? (entries + 127) / 128 * 128 : 0;
  p.stats = static_cast<const int*>(stats);
  p.mode = mode;
  p.outer = outer;
  p.keep = static_cast<uint8_t*>(keep);
  p.ridx = static_cast<int*>(ridx);
  p.m = static_cast<int*>(m);
  p.reps = static_cast<int*>(reps);
  p.count = static_cast<int*>(count);
  p.total = static_cast<unsigned long long*>(total);
  auto at = [](const void* q, unsigned a) { return reinterpret_cast<uintptr_t>(q) % a == 0; };
  p.vec = at(seg, 16) && at(row_valid, 4) && at(nulls, 4) && at(keep, 4) && at(ridx, 16) &&
          at(m, 16) && at(reps, 16);
  int smem = 0;
  if (place == kPlaceShared) {
    p.narrow_words = (entries + 3) / 4;
    smem = (int)((p.narrow_words * 4 + 15) / 16 * 16);
  }
  const cudaError_t err = on_device(device, [&]() -> cudaError_t {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaSuccess;
    if (narrowed) {
      // a warp a word of bits, a thread 4 byte entries
      const long long threads = bits ? (num + 31LL) / 32 * 32 : (num + 3LL) / 4;
      e = launch_wave(bits ? join_probe_narrow_bits : join_probe_narrow_bytes, threads,
                      kNarrowThreads, device, st, p);
      if (e != cudaSuccess) return e;
    }
    if (place == kPlaceShared) {
      e = allow_shared_table(device);
      if (e != cudaSuccess) return e;
    }
    int grid = 0;
    e = wave_blocks(kernel, kProbeThreads, smem, (n + kProbeTile - 1) / kProbeTile, device, &grid);
    if (e != cudaSuccess) return e;
    e = launch_cluster(kernel, grid, kProbeThreads, 1, smem, st, p);
    if (e != cudaSuccess || place != kPlaceL2) return e;
    return launch_wave(join_probe_release, p.narrow_bytes / 128, kNarrowThreads, device, st, p);
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
