// Key factorization on the card: the binned path (K1), the sort path over
// one packed sort word (KW, K2w, K3w) and the sort path of keys too wide
// for one word (K2, K3), which follow torch's stable sorts.
//
// Replaces, in the JAX package (fugue_tpu/jax_backend/groupby.py; none of
// them is a Pallas kernel, each is a jitted XLA program):
//   K1  bin_factorize        _bin_core (:481): segment ids, first valid row
//                            per bin, occupied bins, group count;
//   KW  sort_word            the sort codes of _sort_factorize (:507-546),
//                            packed into one order-preserving int32/int64
//                            word a row, "not real" as its top field;
//   K11 KW's presort mode    relational.py's _sort_code_columns (:1234)
//                            and _stable_sort_order (:1265): per key
//                            descending, nulls first, NaN as null and a
//                            field narrowed to its known range, so that
//                            one stable ascending sort of the word (LSD
//                            over several where the fields exceed 64
//                            bits) gives that loop's order;
//   K2w sort_word_boundaries the tail of _sort_factorize_core (:554) over
//                            the sorted words: group boundaries, their
//                            scan, the distinct words, the first row of
//                            each group, the group count;
//   K3w sort_word_lookup     _sort_factorize_finish (:582) in row order:
//                            each row's id by a binary search of its own
//                            word among the distinct words;
//   K2  sort_boundaries      the tail of _sort_factorize_core (:554) over
//                            the codes of a wide key, gathered at the order;
//   K3  sort_finish          _sort_factorize_finish (:582): the sentinel on
//                            invalid rows, the scatter of the ids back to
//                            row order, the first row of each group.
// Their twins are bin_factorize_reference, sort_word_reference,
// presort_word_reference, sort_word_boundaries_reference,
// sort_word_lookup_reference, sort_boundaries_reference and
// sort_finish_reference in reference.py.
//
// What bounds them on an H100: bytes. K1 reads the keys once and writes
// one id a row (8 bytes a row for one int32 key); the bins' first rows
// are a shared-memory atomicMin (global when the bins do not fit in 48
// KB), tried only when a plain read shows the row is earlier than the
// bin's current first, so after the first rows of a bin almost no row
// pays an atomic. KW (and K11) reads each key once and writes the word,
// one row a thread, coalesced. K2w reads the sorted words in sorted order with
// 16-byte loads (twice: reduce-then-scan in three launches), writes one
// id a position, and touches the order only where a group opens. K3w
// reads each row's word in row order with 16-byte loads and writes its id
// with 16-byte stores; the search runs in a copy of the distinct words in
// shared memory, padded so its probes spread over the banks (global memory
// through L2 when they do not fit), so no access is random in device
// memory. K2 and K3, the route of keys wider
// than 64 bits and of group counts above the lookup's reach, read the
// sort's int64 order (8 bytes a row). K2 is one launch: each position
// gathers each key code of its row once (random 4-byte reads: the sort
// left the codes in row order; the most significant code comes in sorted
// order from the sort's own values where the frame needed no validity
// sort, and is read in order), takes its predecessor's codes from the
// lane or warp before, and scans the "opens a group" flags in one pass
// with decoupled look-back, writing the ids with 16-byte stores. It is
// bound by the random reads, which the card serves at about 27M a ms
// (NVIDIA H100 80GB HBM3, 700 W: 10.85 ms for 150M positions and two
// gathered codes, 3.86 ms for 100M and one). K3 stores
// one id a row through the order, which was a random 4-byte store a row
// (7.45 ms at 100M rows on an H100 80GB HBM3 at 700 W against a 0.478 ms
// bound); it now goes through order_scatter.cuh: the positions, read
// coalesced, are grouped by slab of rows into scratch buckets (8 B a row
// written and read back), and each slab's ids are placed in shared memory
// and written once with 16-byte stores, about 32 B a row in all.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bin_keys.cuh"
#include "launch.cuh"
#include "order_scatter.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
// the bins' first rows live in shared memory up to the default per-block
// limit, which needs no opt-in
constexpr long long kSharedBins = 48 * 1024 / 4;
constexpr int kMaxCodes = 16;  // sort codes per K2 launch

// the SM count of each device, asked once
std::atomic<int> sm_counts[64];

cudaError_t sm_count(int dev, int* out) {
  if (dev >= 0 && dev < 64) {
    const int known = sm_counts[dev].load(std::memory_order_relaxed);
    if (known > 0) {
      *out = known;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev >= 0 && dev < 64)
    sm_counts[dev].store(*out, std::memory_order_relaxed);
  return err;
}

int grid_for(long long items, int per_block, int sms, int per_sm) {
  const long long need = (items + per_block - 1) / per_block;
  const long long wave = (long long)sms * per_sm;
  return (int)(need < 1 ? 1 : need < wave ? need : wave);
}

// ---- K1: bin factorization ----------------------------------------------

struct BinParams {
  long long n;      // padded rows: every one gets a segment id
  long long nrows;  // a prefix frame's real rows; ignored with row_valid
  const uint8_t* row_valid;  // a masked frame's rows (non-zero = real)
  KeyBins keys;
  int total;
  int* seg;            // int32[n]: the bin, total where the row has none
  int* first;          // int32[total]: first row per bin, n - 1 if empty
  uint8_t* occupied;   // bool[total]
  int* count;          // int32[1]: occupied bins
};

__global__ void bin_init(const __grid_constant__ BinParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long b = (long long)blockIdx.x * kThreads + threadIdx.x; b < p.total; b += stride)
    p.first[b] = (int)p.n;
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.count = 0;
}

// One row a thread per step, grid-stride. A row's first-row candidate is
// its own index: the bin's entry only ever falls, so a read that is stale
// is never below the true value, and a row that reads an entry at or
// below its index cannot lower it and skips the atomic.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    bin_rows_kernel(const __grid_constant__ BinParams p) {
  extern __shared__ int sfirst[];
  int* first = p.first;
  if constexpr (kShared) {
    for (int b = threadIdx.x; b < p.total; b += kThreads) sfirst[b] = (int)p.n;
    __syncthreads();
    first = sfirst;
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < p.n; r += stride) {
    bool ok[1] = {p.row_valid != nullptr ? __ldg(p.row_valid + r) != 0 : r < p.nrows};
    unsigned int bin[1] = {0u};
    if (ok[0]) bin_rows<1>(p.keys, r, ok, bin);
    p.seg[r] = ok[0] ? (int)bin[0] : p.total;
    if (ok[0]) {
      const volatile int* cur = first + bin[0];
      if ((int)r < *cur) atomicMin(first + bin[0], (int)r);
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < p.total; b += kThreads)
      if (sfirst[b] < p.n) atomicMin(p.first + b, sfirst[b]);
  }
}

// occupied = first < n, the empty bins' first clipped to n - 1, and the
// count of occupied bins (one atomic per block and step).
__global__ void bin_finish(const __grid_constant__ BinParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long b0 = (long long)blockIdx.x * kThreads; b0 < p.total; b0 += stride) {
    const long long b = b0 + threadIdx.x;
    bool occ = false;
    if (b < p.total) {
      const int f = p.first[b];
      occ = f < p.n;
      p.occupied[b] = occ;
      if (!occ) p.first[b] = (int)(p.n - 1);
    }
    const int c = __syncthreads_count(occ);
    if (threadIdx.x == 0 && c > 0) atomicAdd(p.count, c);
  }
}

// ---- K2: sort boundaries -------------------------------------------------

struct Code {
  const void* data;
  long long stride;  // in elements
  int width;         // 4 or 8 bytes
};

// One launch over tiles of kBoundTile sorted positions, kBoundItems
// consecutive positions a thread. A tile takes its id from a counter in
// launch order (so it waits only on tiles already running), publishes its
// count of groups opened, looks back over the tiles before it for its
// offset and publishes its inclusive count: one 64-bit word a tile, the
// flag in its top bits and the count below (kBoundAggregate,
// kBoundInclusive), so a reader sees both at once.
constexpr int kBoundThreads = 256;
constexpr int kBoundItems = 8;
constexpr int kBoundTile = kBoundThreads * kBoundItems;
constexpr unsigned long long kBoundAggregate = 1ULL << 62, kBoundInclusive = 2ULL << 62;
constexpr unsigned long long kBoundValue = (1ULL << 62) - 1;

struct SortParams {
  long long n;
  long long nrows;  // a prefix frame: position i is real iff order[i] < nrows
  const uint8_t* row_valid;  // a masked frame: real iff row_valid[order[i]]
  const long long* order;
  bool order_vec;   // order is 16-byte aligned: read in 16-byte loads
  int ncodes;
  Code code[kMaxCodes];
  bool first_sorted;  // code 0 is in sorted order (read at the position)
  unsigned long long* state;  // [tiles]: each tile's published count
  unsigned int* next_tile;    // the tile counter (state's last word)
  long long tiles;
  int* seg_sorted;  // int32[n]: group id in sorted order, -1 where not real
  int* count;       // int32[1]: groups
};

__device__ __forceinline__ unsigned long long code_at(const Code& c, long long row) {
  if (c.width == 4)
    return __ldg(static_cast<const unsigned int*>(c.data) + row * c.stride);
  return __ldg(static_cast<const unsigned long long*>(c.data) + row * c.stride);
}

// Block-wide inclusive scan of one int a thread (Hillis-Steele in shared
// memory); returns the thread's inclusive sum, *total the block's. K2w's.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int s[kThreads];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int t = threadIdx.x >= off ? s[threadIdx.x - off] : 0;
    __syncthreads();
    s[threadIdx.x] += t;
    __syncthreads();
  }
  const int incl = s[threadIdx.x];
  *total = s[kThreads - 1];
  __syncthreads();
  return incl;
}

// One block: the tiles' counts become exclusive offsets, and their sum is
// the group count. K2w's second launch.
__global__ void __launch_bounds__(kThreads)
    sort_offsets(int* block_sums, int tiles, int* count) {
  const int per = (tiles + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < tiles ? lo + per : tiles;
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += block_sums[t];
  int total = 0;
  int run = block_scan(sum, &total) - sum;
  for (int t = lo; t < hi; ++t) {
    const int c = block_sums[t];
    block_sums[t] = run;
    run += c;
  }
  if (threadIdx.x == 0) *count = total;
}

// Warp 0 of tile t's block: the groups opened in every tile before t, from
// the published counts back to the nearest inclusive one (32 tiles a
// step, lane 0 the latest).
__device__ long long bound_look_back(unsigned long long* state, long long t) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (long long end = t;; end -= 32) {
    const long long u = end - 1 - lane;
    unsigned long long w = kBoundInclusive;  // before tile 0: nothing, inclusive
    if (u >= 0) {
      const volatile unsigned long long* sp = state + u;
      while ((w = *sp) == 0) {
      }
    }
    const unsigned inclusive = __ballot_sync(0xffffffffu, (w & kBoundInclusive) != 0);
    const int stop = inclusive != 0 ? __ffs(inclusive) - 1 : 31;
    long long v = lane <= stop ? (long long)(w & kBoundValue) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    excl += __shfl_sync(0xffffffffu, v, 0);
    if (inclusive != 0) return excl;
  }
}

// K2. Each position gathers each code of its row once (or reads it at
// the position, where the caller has it in sorted order: the sort's own
// values of the most significant code); the code of the position before
// it comes from the lane before (a shuffle), from the warp before (shared
// memory), or, at a tile's first position, from its own read of
// order[i - 1]. Real positions come first in sorted order
// (validity is the sort's primary key), so a position's predecessor is
// real where it is, unreal positions gather nothing, and with row_valid a
// thread reads the flag of its last row, then of its first, and of the
// others only where the two differ (one thread in the launch).
__global__ void __launch_bounds__(kBoundThreads)
    sort_boundaries_kernel(const __grid_constant__ SortParams p) {
  constexpr int kWarps = kBoundThreads / 32;
  __shared__ unsigned long long last_sh[kWarps];
  __shared__ int warp_sh[kWarps];
  __shared__ long long tile_sh, excl_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_sh = atomicAdd(p.next_tile, 1u);
  __syncthreads();
  const long long tile = tile_sh;
  const long long first = tile * kBoundTile;
  const long long base = first + (long long)threadIdx.x * kBoundItems;
  const int have = base >= p.n ? 0 : (p.n - base < kBoundItems ? (int)(p.n - base) : kBoundItems);

  long long row[kBoundItems];
  if (have == kBoundItems && p.order_vec) {
    const longlong2* src = reinterpret_cast<const longlong2*>(p.order + base);
#pragma unroll
    for (int j = 0; j < kBoundItems / 2; ++j) {
      const longlong2 v = __ldg(src + j);
      row[2 * j] = v.x;
      row[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBoundItems; ++j) row[j] = j < have ? __ldg(p.order + base + j) : 0;
  }
  unsigned real = 0;  // bit j: position base + j is real
  if (have > 0) {
    const unsigned all = (1u << have) - 1;
    if (p.row_valid == nullptr) {
#pragma unroll
      for (int j = 0; j < kBoundItems; ++j)
        if (j < have && row[j] < p.nrows) real |= 1u << j;
    } else if (__ldg(p.row_valid + row[have - 1]) != 0) {
      real = all;
    } else if (__ldg(p.row_valid + row[0]) != 0) {
#pragma unroll
      for (int j = 0; j < kBoundItems; ++j)
        if (j < have && __ldg(p.row_valid + row[j]) != 0) real |= 1u << j;
    }
  }

  unsigned differ = 0;  // bit j: a code differs from position base + j - 1
  for (int c = 0; c < p.ncodes; ++c) {
    const Code code = p.code[c];
    const bool at_position = c == 0 && p.first_sorted;
    unsigned long long v[kBoundItems];
#pragma unroll
    for (int j = 0; j < kBoundItems; ++j)
      v[j] = (real >> j) & 1u ? code_at(code, at_position ? base + j : row[j]) : 0;
    unsigned long long prev = __shfl_up_sync(0xffffffffu, v[kBoundItems - 1], 1);
    if (lane == 31) last_sh[warp] = v[kBoundItems - 1];
    __syncthreads();
    if (lane == 0) {
      if (warp > 0)
        prev = last_sh[warp - 1];
      else if (first > 0 && (real & 1u))
        prev = code_at(code, at_position ? first - 1 : __ldg(p.order + first - 1));
    }
    differ |= (unsigned)(v[0] != prev);
#pragma unroll
    for (int j = 1; j < kBoundItems; ++j) differ |= (unsigned)(v[j] != v[j - 1]) << j;
    __syncthreads();  // last_sh is rewritten by the next code
  }
  if (base == 0) differ |= 1u;  // the first position opens a group
  const unsigned opens = real & differ;

  // the block's exclusive scan of its threads' counts, by warp shuffles
  const int mine = __popc(opens);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sh[warp] = incl;
  __syncthreads();
  int before = incl - mine, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sh[w];
    if (w < warp) before += s;
    agg += s;
  }
  if (warp == 0) {
    long long excl = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(p.state, kBoundInclusive | (unsigned long long)agg);
    } else {
      if (lane == 0) atomicExch(p.state + tile, kBoundAggregate | (unsigned long long)agg);
      excl = bound_look_back(p.state, tile);
      if (lane == 0)
        atomicExch(p.state + tile, kBoundInclusive | (unsigned long long)(excl + agg));
    }
    if (lane == 0) {
      excl_sh = excl;
      if (tile == p.tiles - 1) *p.count = (int)(excl + agg);
    }
  }
  __syncthreads();

  int id = (int)excl_sh + before - 1;
  int out[kBoundItems];
#pragma unroll
  for (int j = 0; j < kBoundItems; ++j) {
    id += (opens >> j) & 1u;
    out[j] = (real >> j) & 1u ? id : -1;
  }
  if (have == kBoundItems) {
    int4* dst = reinterpret_cast<int4*>(p.seg_sorted + base);
#pragma unroll
    for (int j = 0; j < kBoundItems / 4; ++j)
      dst[j] = make_int4(out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kBoundItems; ++j)
      if (j < have) p.seg_sorted[base + j] = out[j];
  }
}

// ---- K3: sort finish -----------------------------------------------------

// One block of kFinishThreads takes kFinishItems positions a thread a tile.
constexpr int kFinishThreads = 512;
constexpr int kFinishItems = 16;
constexpr long long kFinishTile = (long long)kFinishThreads * kFinishItems;

struct FinishParams {
  long long n;
  const int* seg_sorted;
  const long long* order;
  int num;
  int* first_idx;  // int32[num]
};

// Step 1 of the store through the order (order_scatter.cuh), a persistent
// wave over tiles: position i, read coalesced, gives row order[i] the id
// seg_sorted[i] (num where it is not real). In sorted order a group's
// first position is the one that opens it, so first_idx[seg_sorted[i]] =
// order[i] where position i opens a group: the same value as the JAX
// package's segment_min over positions, with no reduction; those stores
// run in nondecreasing id.
__global__ void __launch_bounds__(kFinishThreads, 2)
    sort_finish_partition(const FinishParams p, const SlabOut so) {
  extern __shared__ uint4 finish_smem[];
  for (long long t0 = (long long)blockIdx.x * kFinishTile; t0 < p.n;
       t0 += (long long)gridDim.x * kFinishTile) {
    scatter_tile<kFinishThreads, kFinishItems, unsigned>(
        so,
        [&](int k, unsigned& value, bool& valid) -> int {
          const long long i = t0 + (long long)k * kFinishThreads + threadIdx.x;
          if (i >= p.n) return -1;
          const int s = __ldg(p.seg_sorted + i);
          const long long row = __ldg(p.order + i);
          if (s >= 0 && (i == 0 || __ldg(p.seg_sorted + i - 1) != s)) p.first_idx[s] = (int)row;
          value = (unsigned)(s < 0 ? p.num : s);
          valid = true;
          return (int)row;
        },
        reinterpret_cast<unsigned char*>(finish_smem));
  }
}

// ---- KW: the sort word ---------------------------------------------------

constexpr int kMaxWordKeys = 16;  // key columns per KW launch

// A key's options (presort mode, K11); the factorize mode sets kFlag
// where the key has a mask and nothing else.
constexpr int kFlag = 1;        // the word holds the key's null flag
constexpr int kNoValue = 2;     // the word does not hold the key's field
constexpr int kDesc = 4;        // the field inverted: descending
constexpr int kNullsFirst = 8;  // the null flag inverted: nulls first
constexpr int kNanNull = 16;    // a float NaN is null (flag set, field 0)
constexpr int kNarrow = 32;     // an integer field is value - kmin in width bits

struct WordKey {
  const void* data;
  const uint8_t* mask;  // null: every row valid (True = valid)
  int code;             // a dtype code of bin_keys.cuh
  int opts;             // kFlag | kNoValue | kDesc | kNullsFirst | kNanNull | kNarrow
  int width;            // the field's bits
  long long kmin;       // kNarrow's offset
};

struct WordParams {
  long long n;
  long long nrows;           // a prefix frame's real rows; ignored with row_valid
  const uint8_t* row_valid;  // a masked frame's rows (non-zero = real)
  int unreal;                // 1: the top field is the "not real" bit
  int nkeys;
  WordKey key[kMaxWordKeys];
  int wide;                  // 0: int32 words, 1: int64 words
  void* word;
};

__host__ __device__ inline int field_bits(int code) {
  switch (code) {
    case kBool: return 1;
    case kU8: case kI8: return 8;
    case kI16: return 16;
    case kI32: case kF32: return 32;
    default: return 64;
  }
}

// A key's field: unsigned, in the order of the JAX package's sort codes.
// Signed integers are offset by their minimum; an int64 is its two int32
// words swapped, each offset, so the low word orders first as there
// (bitcast_convert_type); a float is -0.0 as +0.0, its bits flipped so
// that the unsigned order is the float order, and NaN the all-ones field
// above +inf (the JAX package's isnan flag before the value).
__device__ __forceinline__ unsigned long long key_field(int code, const void* data,
                                                        long long r) {
  switch (code) {
    case kBool: return __ldg(static_cast<const unsigned char*>(data) + r) != 0;
    case kU8: return __ldg(static_cast<const unsigned char*>(data) + r);
    case kI8: return (unsigned long long)((int)__ldg(static_cast<const signed char*>(data) + r) + 128);
    case kI16: return (unsigned long long)((int)__ldg(static_cast<const short*>(data) + r) + 32768);
    case kI32: return (unsigned int)__ldg(static_cast<const int*>(data) + r) ^ 0x80000000u;
    case kI64: {
      const unsigned long long x = (unsigned long long)__ldg(static_cast<const long long*>(data) + r);
      return ((x << 32) | (x >> 32)) ^ 0x8000000080000000ull;
    }
    case kF32: {
      const float f = __ldg(static_cast<const float*>(data) + r);
      if (isnan(f)) return 0xFFFFFFFFull;
      const unsigned int b = f == 0.0f ? 0u : __float_as_uint(f);
      return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    }
    default: {
      const double f = __ldg(static_cast<const double*>(data) + r);
      if (isnan(f)) return ~0ull;
      const unsigned long long b = f == 0.0 ? 0ull : (unsigned long long)__double_as_longlong(f);
      return (b >> 63) ? ~b : (b | (1ull << 63));
    }
  }
}

// An integer key's value as a signed 64-bit integer (bool and uint8 as
// their unsigned value).
__device__ __forceinline__ long long key_int(int code, const void* data, long long r) {
  switch (code) {
    case kBool: case kU8: return __ldg(static_cast<const unsigned char*>(data) + r);
    case kI8: return __ldg(static_cast<const signed char*>(data) + r);
    case kI16: return __ldg(static_cast<const short*>(data) + r);
    case kI32: return __ldg(static_cast<const int*>(data) + r);
    default: return __ldg(static_cast<const long long*>(data) + r);
  }
}

__device__ __forceinline__ bool key_isnan(int code, const void* data, long long r) {
  if (code == kF32) return isnan(__ldg(static_cast<const float*>(data) + r));
  if (code == kF64) return isnan(__ldg(static_cast<const double*>(data) + r));
  return false;
}

__host__ __device__ inline unsigned long long low_mask(int width) {
  return width >= 64 ? ~0ull : (1ull << width) - 1ull;
}

// One row a thread, grid-stride: the fields most significant first ("not
// real", then per key its null flag and its field, zero where null, each
// as its options say), then the word's top bit flipped so a signed sort
// orders it as unsigned.
__global__ void __launch_bounds__(kThreads) sort_word_kernel(const __grid_constant__ WordParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < p.n; r += stride) {
    unsigned long long u = 0;
    if (p.unreal)
      u = p.row_valid != nullptr ? __ldg(p.row_valid + r) == 0 : r >= p.nrows;
    for (int k = 0; k < p.nkeys; ++k) {
      const WordKey& key = p.key[k];
      const int opts = key.opts;
      bool null = key.mask != nullptr && __ldg(key.mask + r) == 0;
      unsigned long long f = 0;
      if (!null) {
        if (opts & kNarrow) {
          f = ((unsigned long long)key_int(key.code, key.data, r) -
               (unsigned long long)key.kmin) & low_mask(key.width);
        } else if ((opts & kNanNull) && key_isnan(key.code, key.data, r)) {
          null = true;
        } else {
          f = key_field(key.code, key.data, r);
        }
      }
      if (opts & kDesc) f = ~f & low_mask(key.width);
      if (null) f = 0;
      if (opts & kFlag) u = (u << 1) | (null != ((opts & kNullsFirst) != 0) ? 1ull : 0ull);
      if (!(opts & kNoValue)) u = key.width == 64 ? f : (u << key.width) | f;
    }
    if (p.wide)
      static_cast<long long*>(p.word)[r] = (long long)(u ^ (1ull << 63));
    else
      static_cast<int*>(p.word)[r] = (int)((unsigned int)u ^ 0x80000000u);
  }
}

// ---- K2w: boundaries over the sorted words -------------------------------

// words per 16-byte vector, and vectors per thread and tile
template <typename W>
constexpr int kVec = 16 / (int)sizeof(W);
constexpr int kRounds = 4;
template <typename W>
constexpr int kWordTile = kThreads * kVec<W> * kRounds;

template <typename W>
struct WordBoundsParams {
  long long n;
  const W* sorted;          // the words in sorted order, 16-byte aligned
  const long long* order;   // the sort's permutation
  int has_limit;            // positions whose word is >= limit are not real
  W limit;
  int tiles;
  int* block_sums;          // int32[tiles]: groups opened per tile, then offsets
  W* uniq;                  // W[n]: the first count entries are the groups' words
  int* first_idx;           // int32[n]: the first count entries, each group's first row
  int* seg_sorted;          // int32[n]: group id in sorted order, -1 where not real
  int* count;               // int32[1]
};

// V consecutive words from position i (a multiple of V): one 16-byte load,
// or scalar loads at the ragged end. Returns how many lie below n.
template <typename W>
__device__ __forceinline__ int load_words(const W* p, long long i, long long n,
                                          W (&w)[kVec<W>]) {
  constexpr int V = kVec<W>;
  if (i + V <= n) {
    if constexpr (V == 4) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(p + i));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
      const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(p + i));
      w[0] = x.x; w[1] = x.y;
    }
    return V;
  }
  const int m = i < n ? (int)(n - i) : 0;
#pragma unroll
  for (int j = 0; j < V; ++j) w[j] = j < m ? __ldg(p + i + j) : W(0);
  return m;
}

// The group openings among the m words w from position i: a real position
// opens a group where its word differs from the one before. Real positions
// come first (the "not real" bit is the word's top field), so the one
// before a real position is real too. Bit j of the result is position i+j.
template <typename W>
__device__ __forceinline__ unsigned int word_opens(const WordBoundsParams<W>& p, long long i,
                                                   const W (&w)[kVec<W>], int m,
                                                   unsigned int* real) {
  unsigned int opens = 0, reals = 0;
  W prev = i > 0 && m > 0 ? __ldg(p.sorted + i - 1) : W(0);
#pragma unroll
  for (int j = 0; j < kVec<W>; ++j) {
    if (j >= m) break;
    const bool is_real = !p.has_limit || w[j] < p.limit;
    if (is_real) reals |= 1u << j;
    if (is_real && (i + j == 0 || w[j] != prev)) opens |= 1u << j;
    prev = w[j];
  }
  *real = reals;
  return opens;
}

// Block-wide exclusive scan of one int a thread with warp shuffles; every
// thread of the block must call it. *total is the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    const int s = warp_sums[k];
    before += k < warp ? s : 0;
    sum += s;
  }
  __syncthreads();  // warp_sums is written again by the next call
  *total = sum;
  return before + x - v;
}

// Pass 1: the groups each tile opens.
template <typename W>
__global__ void __launch_bounds__(kThreads)
    word_count(const __grid_constant__ WordBoundsParams<W> p) {
  constexpr int V = kVec<W>;
  const long long base = (long long)blockIdx.x * kWordTile<W>;
  int opened = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + ((long long)r * kThreads + threadIdx.x) * V;
    W w[V];
    const int m = load_words(p.sorted, i, p.n, w);
    unsigned int real = 0;
    opened += __popc(word_opens(p, i, w, m, &real));
  }
  int total = 0;
  block_exclusive_scan(opened, &total);
  if (threadIdx.x == 0) p.block_sums[blockIdx.x] = total;
}

// Pass 3: the ids of the tile's positions from its offset, one vector a
// thread and round; an opening position writes its group's word and
// first row (the row at the group's first stable-sorted position, which is
// the group's smallest row: the JAX package's segment_min over positions).
template <typename W>
__global__ void __launch_bounds__(kThreads)
    word_scan(const __grid_constant__ WordBoundsParams<W> p) {
  constexpr int V = kVec<W>;
  const long long base = (long long)blockIdx.x * kWordTile<W>;
  int run = p.block_sums[blockIdx.x];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + ((long long)r * kThreads + threadIdx.x) * V;
    W w[V];
    const int m = load_words(p.sorted, i, p.n, w);
    unsigned int real = 0;
    const unsigned int opens = word_opens(p, i, w, m, &real);
    int total = 0;
    int g = run + block_exclusive_scan(__popc(opens), &total);
    int seg[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if ((opens >> j) & 1u) {
        p.uniq[g] = w[j];
        p.first_idx[g] = (int)__ldg(p.order + i + j);
        ++g;
      }
      seg[j] = (real >> j) & 1u ? g - 1 : -1;
    }
    if (m == V) {
      if constexpr (V == 4)
        *reinterpret_cast<int4*>(p.seg_sorted + i) = make_int4(seg[0], seg[1], seg[2], seg[3]);
      else
        *reinterpret_cast<int2*>(p.seg_sorted + i) = make_int2(seg[0], seg[1]);
    } else {
      for (int j = 0; j < m; ++j) p.seg_sorted[i + j] = seg[j];
    }
    run += total;
  }
}

// ---- K3w: row-order ids by lookup ----------------------------------------

// the largest table a block takes in shared memory (227 KB), and what one
// SM holds for its blocks (228 KB, 1 KB of it reserved per block)
constexpr long long kMaxTableBytes = 227 * 1024;
constexpr long long kSmBytes = 228 * 1024;

template <typename W>
struct LookupParams {
  long long n;
  const W* words;  // each row's word, row order, 16-byte aligned
  const W* uniq;   // the num distinct words of the real rows, ascending
  int num;
  int has_limit;   // rows whose word is >= limit are not real
  W limit;
  int* seg;        // int32[n]: the row's group, num where it is not real
};

// words per row of the 32 4-byte banks; the shared copy of the table
// skips one word after each row, so that the search's probes at strides
// of a power of two (every level above the last five) fall in different
// banks instead of all in one
template <typename W>
constexpr int kBankRow = 128 / (int)sizeof(W);
template <typename W, bool kPadded>
__device__ __forceinline__ int slot(int i) {
  return kPadded ? i + i / kBankRow<W> : i;
}
// the words a padded table of num entries takes
template <typename W>
constexpr long long padded_words(long long num) {
  return num + num / kBankRow<W>;
}

// V binary searches side by side (independent loads in flight): base[j]
// becomes the last index whose word is <= w[j], which for a real row is
// its own word's index. Every thread of a warp runs the same steps.
template <typename W, int V, bool kPadded>
__device__ __forceinline__ void search(const W* table, int num, const W (&w)[V], int (&base)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) base[j] = 0;
  int len = num;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < V; ++j)
      base[j] = table[slot<W, kPadded>(base[j] + half)] <= w[j] ? base[j] + half : base[j];
    len -= half;
  }
}

// Persistent grid: each block copies the table into shared memory once
// (kShared, padded), then strides over the rows a 16-byte vector a thread.
template <typename W, bool kShared>
__global__ void __launch_bounds__(kThreads)
    word_lookup(const __grid_constant__ LookupParams<W> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = kVec<W>;
  const W* table = p.uniq;
  if constexpr (kShared) {
    W* t = reinterpret_cast<W*>(smem);
    for (int g = threadIdx.x; g < p.num; g += kThreads) t[slot<W, true>(g)] = __ldg(p.uniq + g);
    __syncthreads();
    table = t;
  }
  const long long vecs = p.n / V;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < vecs; v += stride) {
    W w[V];
    load_words(p.words, v * V, p.n, w);
    int s[V];
    search<W, V, kShared>(table, p.num, w, s);
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (p.has_limit && w[j] >= p.limit) s[j] = p.num;
    if constexpr (V == 4)
      *reinterpret_cast<int4*>(p.seg + v * V) = make_int4(s[0], s[1], s[2], s[3]);
    else
      *reinterpret_cast<int2*>(p.seg + v * V) = make_int2(s[0], s[1]);
  }
  // the ragged end, by the first threads of block 0
  const long long r = vecs * V + threadIdx.x;
  if (blockIdx.x == 0 && r < p.n) {
    const W w[1] = {__ldg(p.words + r)};
    int s[1];
    search<W, 1, kShared>(table, p.num, w, s);
    p.seg[r] = p.has_limit && w[0] >= p.limit ? p.num : s[0];
  }
}

// The launches of K2w and K3w for one word type; the C entry points below
// check their arguments.
template <typename W>
cudaError_t launch_word_boundaries(long long n, const void* sorted, const void* order,
                                   int has_limit, long long limit, void* block_sums,
                                   void* uniq, void* first_idx, void* seg_sorted,
                                   void* count, cudaStream_t st) {
  WordBoundsParams<W> p = {};
  p.n = n;
  p.sorted = static_cast<const W*>(sorted);
  p.order = static_cast<const long long*>(order);
  p.has_limit = has_limit;
  p.limit = (W)limit;
  p.tiles = (int)((n + kWordTile<W> - 1) / kWordTile<W>);
  p.block_sums = static_cast<int*>(block_sums);
  p.uniq = static_cast<W*>(uniq);
  p.first_idx = static_cast<int*>(first_idx);
  p.seg_sorted = static_cast<int*>(seg_sorted);
  p.count = static_cast<int*>(count);
  word_count<W><<<p.tiles, kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sort_offsets<<<1, kThreads, 0, st>>>(p.block_sums, p.tiles, p.count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  word_scan<W><<<p.tiles, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_word_lookup(long long n, const void* words, const void* uniq, int num,
                               int has_limit, long long limit, void* seg, int sms,
                               cudaStream_t st, int* path) {
  const LookupParams<W> p = {n, static_cast<const W*>(words), static_cast<const W*>(uniq),
                             num, has_limit, (W)limit, static_cast<int*>(seg)};
  const long long threads = n / kVec<W> + 1;
  const long long bytes = padded_words<W>(num) * (long long)sizeof(W);
  if (bytes <= kMaxTableBytes) {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          word_lookup<W, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
    }
    long long per_sm = kSmBytes / (bytes + 1024);
    per_sm = per_sm < 1 ? 1 : per_sm > kMaxBlocksPerSm ? kMaxBlocksPerSm : per_sm;
    word_lookup<W, true><<<grid_for(threads, kThreads, sms, (int)per_sm), kThreads,
                           (size_t)bytes, st>>>(p);
    *path = 1;
  } else {
    word_lookup<W, false><<<grid_for(threads, kThreads, sms, kMaxBlocksPerSm), kThreads, 0,
                            st>>>(p);
    *path = 2;
  }
  return cudaGetLastError();
}

}  // namespace

// The plain C entry points, bound with ctypes. Each returns a cudaError_t
// (0 when every launch was accepted), launches on stream (a cudaStream_t
// of device) and allocates nothing; the launches make device current and
// then restore the caller's current device. Every row count is below
// 2^31, since row indices are int32.

// K1. Keys as in bin_keys.cuh; rows: a prefix frame passes nrows and a
// null row_valid, a masked frame row_valid. Writes seg int32[n],
// first_idx int32[total], occupied bool[total] and count int32[1]; *path
// is 1 when the first rows were taken in shared memory, 2 in global.
extern "C" int fugue_bin_factorize(
    long long n, long long nrows, const void* row_valid, int nkeys,
    const void* const* key_data, const void* const* key_mask,
    const int* key_code, const long long* kmin, const long long* span,
    void* seg, void* first_idx, void* occupied, void* count, int device,
    void* stream, int* path) {
  *path = 0;
  BinParams p = {};
  long long total = 0;
  if (n < 1 || n >= (1LL << 31) ||
      !make_key_bins(nkeys, key_data, key_mask, key_code, kmin, span, &p.keys, &total))
    return (int)cudaErrorInvalidValue;
  p.n = n;
  p.nrows = nrows;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  p.total = (int)total;
  p.seg = static_cast<int*>(seg);
  p.first = static_cast<int*>(first_idx);
  p.occupied = static_cast<uint8_t*>(occupied);
  p.count = static_cast<int*>(count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    int sms = 0;
    cudaError_t err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    const int bins_grid = grid_for(total, kThreads, sms, kMaxBlocksPerSm);
    bin_init<<<bins_grid, kThreads, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const bool shared = total <= kSharedBins;
    const size_t smem = shared ? (size_t)total * 4 : 0;
    // 8 blocks of 256 threads fill an SM; at more than 24 KB of bins
    // each, 4 fit in its shared memory
    const int per_sm = smem <= 24 * 1024 ? kMaxBlocksPerSm : 4;
    const int rows_grid = grid_for(n, kThreads, sms, per_sm);
    if (shared)
      bin_rows_kernel<true><<<rows_grid, kThreads, smem, st>>>(p);
    else
      bin_rows_kernel<false><<<rows_grid, kThreads, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bin_finish<<<bins_grid, kThreads, 0, st>>>(p);
    err = cudaGetLastError();
    if (err == cudaSuccess) *path = shared ? 1 : 2;
    return err;
  });
}

// K2. order int64[n] is the sorted permutation of the rows, real rows
// first; code c is code_data[c] read every code_stride[c] elements of
// code_width[c] (4 or 8) bytes, compared bit for bit (floats come
// canonical: no NaN, no -0.0), in row order; first_sorted, where not
// null, is code 0 in sorted order (code 0 at order[i] is its element i,
// dense), read in its place. Rows as for K1. Scratch: state uint64[tiles
// + 1], tiles = fugue_sort_boundaries_tiles(n), zeroed here (the tiles'
// look-back state and the tile counter). Writes seg_sorted int32[n]
// (16-byte aligned) and count int32[1]. One memset and one launch.
extern "C" long long fugue_sort_boundaries_tiles(long long n) {
  return (n + kBoundTile - 1) / kBoundTile;
}

extern "C" int fugue_sort_boundaries(
    long long n, long long nrows, const void* row_valid, const void* order,
    int ncodes, const void* const* code_data, const long long* code_stride,
    const int* code_width, const void* first_sorted, void* state, void* seg_sorted,
    void* count, int device, void* stream) {
  if (n < 1 || n >= (1LL << 31) || ncodes < 1 || ncodes > kMaxCodes ||
      reinterpret_cast<uintptr_t>(seg_sorted) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  SortParams p = {};
  p.n = n;
  p.nrows = nrows;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  p.order = static_cast<const long long*>(order);
  p.order_vec = reinterpret_cast<uintptr_t>(order) % 16 == 0;
  p.ncodes = ncodes;
  for (int c = 0; c < ncodes; ++c) {
    if (code_width[c] != 4 && code_width[c] != 8) return (int)cudaErrorInvalidValue;
    p.code[c] = {code_data[c], code_stride[c], code_width[c]};
  }
  p.first_sorted = first_sorted != nullptr;
  if (p.first_sorted) p.code[0] = {first_sorted, 1, code_width[0]};
  p.tiles = fugue_sort_boundaries_tiles(n);
  p.state = static_cast<unsigned long long*>(state);
  p.next_tile = reinterpret_cast<unsigned int*>(p.state + p.tiles);
  p.seg_sorted = static_cast<int*>(seg_sorted);
  p.count = static_cast<int*>(count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    cudaError_t err = cudaMemsetAsync(state, 0, (size_t)(p.tiles + 1) * 8, st);
    if (err != cudaSuccess) return err;
    sort_boundaries_kernel<<<(unsigned)p.tiles, kBoundThreads, 0, st>>>(p);
    return cudaGetLastError();
  });
}

// K3. seg_sorted as K2 writes it, order as K2 reads it (a permutation of
// [0, n)), num the group count. Writes seg int32[n] (16-byte aligned) and
// first_idx int32[num] through the slabs of order_scatter.cuh; offs
// uint32[n], vals uint32[n] and fill int32[ceil(n / 2^shift)] are scratch,
// shift = fugue_sort_finish_shift(). fill keeps each bucket's count.
extern "C" int fugue_sort_finish(long long n, const void* seg_sorted, const void* order, int num,
                                 void* seg, void* first_idx, void* offs, void* vals, void* fill,
                                 int device, void* stream) {
  if (n < 1 || n >= (1LL << 31) || num < 0 || reinterpret_cast<uintptr_t>(seg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int shift = slab_shift(4);
  const long long nslabs = slab_count(n, shift);
  const FinishParams p = {n, static_cast<const int*>(seg_sorted),
                          static_cast<const long long*>(order), num, static_cast<int*>(first_idx)};
  const SlabOut so = {n, shift, (int)nslabs, static_cast<unsigned*>(offs), vals,
                      static_cast<int*>(fill)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    cudaError_t err = cudaMemsetAsync(fill, 0, (size_t)nslabs * sizeof(int), st);
    if (err != cudaSuccess) return err;
    const int smem = scatter_smem<kFinishThreads, kFinishItems, unsigned>((int)nslabs);
    err = allow_smem<sort_finish_partition>(device, smem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = sm_count(device, &sms);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(sort_finish_partition), kFinishThreads, smem);
    if (err != cudaSuccess) return err;
    const int grid = grid_for(n, (int)kFinishTile, sms, per_sm > 0 ? per_sm : 1);
    sort_finish_partition<<<grid, kFinishThreads, smem, st>>>(p, so);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const ImageParams ip = {n, shift, (int)nslabs, so.offs, vals, so.fill, seg, nullptr};
    return build_image<unsigned, false>(ip, device, st);
  });
}

// log2 of K3's slab rows.
extern "C" int fugue_sort_finish_shift() { return slab_shift(4); }

// KW, in its factorize mode and its presort mode (K11). Keys: nkeys
// columns of n rows, key_data[k] of dtype code key_code[k] (bin_keys.cuh)
// with an optional bool mask key_mask[k], its options key_opts[k]
// (kFlag, kNoValue, kDesc, kNullsFirst, kNanNull, kNarrow), the width of
// its field key_width[k] and kNarrow's offset key_kmin[k]; kNarrow takes
// integer and bool keys only, and an unnarrowed field is the dtype's
// (1 for bool, 8, 16, 32 or 64). The factorize mode is kFlag where a key
// has a mask and nothing else. Rows as for K1, and with unreal = 1 the
// word's top field marks the rows that are not real; no key at all
// (nkeys = 0) takes unreal = 1: the word is then the "not real" bit
// alone. The fields must fit the word: int32 (wide = 0) or int64 (wide =
// 1). Writes word[n].
extern "C" int fugue_sort_word(long long n, long long nrows, const void* row_valid,
                               int unreal, int nkeys, const void* const* key_data,
                               const void* const* key_mask, const int* key_code,
                               const int* key_opts, const int* key_width,
                               const long long* key_kmin, int wide, void* word, int device,
                               void* stream) {
  if (n < 1 || n >= (1LL << 31) || nkeys < 0 || nkeys > kMaxWordKeys || (nkeys == 0 && !unreal))
    return (int)cudaErrorInvalidValue;
  WordParams p = {};
  int bits = unreal ? 1 : 0;
  for (int k = 0; k < nkeys; ++k) {
    const int code = key_code[k], opts = key_opts[k], width = key_width[k];
    if (code < kBool || code > kF64 || ((opts & kNarrow) && code > kI64) ||
        (!(opts & kNarrow) && width != field_bits(code)) || width < 0 || width > 64)
      return (int)cudaErrorInvalidValue;
    p.key[k] = {key_data[k], static_cast<const uint8_t*>(key_mask[k]), code, opts, width,
                key_kmin[k]};
    bits += ((opts & kFlag) ? 1 : 0) + ((opts & kNoValue) ? 0 : width);
  }
  if (bits > (wide ? 64 : 32)) return (int)cudaErrorInvalidValue;
  p.n = n;
  p.nrows = nrows;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  p.unreal = unreal;
  p.nkeys = nkeys;
  p.wide = wide;
  p.word = word;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    int sms = 0;
    cudaError_t err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    sort_word_kernel<<<grid_for(n, kThreads, sms, kMaxBlocksPerSm), kThreads, 0, st>>>(p);
    return cudaGetLastError();
  });
}

// K2w. sorted: the n words (width 4 or 8 bytes) in sorted order, 16-byte
// aligned; order int64[n] the sort's permutation. With has_limit, the
// positions whose word is >= limit are not real (they sort last). Scratch:
// block_sums int32[ceil(n / 2048)]. Writes uniq[n] and first_idx int32[n]
// (their first count entries: each group's word and first row),
// seg_sorted int32[n] and count int32[1].
extern "C" int fugue_sort_word_boundaries(long long n, int width, const void* sorted,
                                          const void* order, int has_limit, long long limit,
                                          void* block_sums, void* uniq, void* first_idx,
                                          void* seg_sorted, void* count, int device,
                                          void* stream) {
  if (n < 1 || n >= (1LL << 31) || (width != 4 && width != 8) ||
      reinterpret_cast<uintptr_t>(sorted) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(seg_sorted) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    if (width == 4)
      return launch_word_boundaries<int>(n, sorted, order, has_limit, limit, block_sums,
                                         uniq, first_idx, seg_sorted, count, st);
    return launch_word_boundaries<long long>(n, sorted, order, has_limit, limit, block_sums,
                                             uniq, first_idx, seg_sorted, count, st);
  });
}

// K3w. words: each row's word (width 4 or 8 bytes), row order, 16-byte
// aligned; uniq: the num distinct words of the real rows, ascending, as
// K2w writes them; has_limit and limit as for K2w. Writes seg int32[n]
// (16-byte aligned). *path is 1 when the table was searched in shared
// memory, 2 in global memory.
extern "C" int fugue_sort_word_lookup(long long n, int width, const void* words,
                                      const void* uniq, int num, int has_limit,
                                      long long limit, void* seg, int device,
                                      void* stream, int* path) {
  *path = 0;
  if (n < 1 || n >= (1LL << 31) || (width != 4 && width != 8) || num < 0 || num > n ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(seg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int taken = 0;
  const int err = on_device(device, [&]() -> cudaError_t {
    int sms = 0;
    cudaError_t e = sm_count(device, &sms);
    if (e != cudaSuccess) return e;
    if (width == 4)
      return launch_word_lookup<int>(n, words, uniq, num, has_limit, limit, seg, sms, st, &taken);
    return launch_word_lookup<long long>(n, words, uniq, num, has_limit, limit, seg, sms, st,
                                         &taken);
  });
  if (err == 0) *path = taken;
  return err;
}

// The message of a cudaError_t, for the wrappers' exceptions.
extern "C" const char* fugue_factorize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
