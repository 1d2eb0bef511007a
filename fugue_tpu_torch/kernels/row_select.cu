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
//     (execution_engine.py:1854-1867), `c2[g] > 0` or `c2[g] == 0` for
//     INTERSECT and EXCEPT DISTINCT (relational.py:1061-1071);
//   - K14 null_count_keep: each row's count of valid columns against
//     dropna's how/thresh, _dropna_prog (execution_engine.py:1906-1925).
// Contracts: rank_keep_reference, first_row_mask_reference and
// null_count_keep_reference in reference.py.
//
// Rows: rows [0, n) are read; a row is real where it is below nrows (a
// prefix frame) or, with nrows = -1, where its row_valid byte is
// non-zero.
//
// What bounds them on an H100, and what the design does about it:
//   - K12 reads the permutation in sorted order (8 B a position,
//     coalesced) and, at each position's row, its validity byte, its
//     segment (4 B) and its segment's start and limit, and writes the
//     row's keep byte there: row order seen through a permutation, so
//     those accesses are random, one sector each. One position a thread
//     a step over a persistent wave; the count is a warp reduction, a
//     block sum in shared memory and one atomic a block. With one limit,
//     no segment and rank < limit (a global take, sample) only the
//     first positions can be kept: the mask is cleared with one memset
//     and the threads read and store only below the limit, which they
//     read on the card, so the work is the kept rows, not the frame.
//   - K13 runs one thread a segment: it reads the segment's first row,
//     occupancy and count and sets one byte at that row. Its work is the
//     segments, not the rows; the mask it writes into is cleared first
//     with one memset (n bytes).
//   - K14 reads one byte a row of each of the M masks and of the row
//     validity and writes one keep byte, all coalesced. The masks come as
//     a device array of pointers (M has no cap), staged in shared memory
//     up to kStagedMasks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kStagedMasks = 64;  // K14 mask pointers a block keeps in shared memory

// K13's predicates and K14's tests, as the wrappers pass them
constexpr int kAll = 0, kHit = 1, kMiss = 2;
constexpr int kAny = 0, kAllNull = 1, kThresh = 2;

__device__ __forceinline__ bool is_real(long long nrows, const uint8_t* row_valid,
                                        long long r) {
  return nrows >= 0 ? r < nrows : __ldg(row_valid + r) != 0;
}

// Adds the block's sum of v (one int a thread) to *count with one atomic;
// every thread of the block calls it.
__device__ __forceinline__ void block_count(int v, int* count) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) warp_sums[warp] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) total += warp_sums[k];
    if (total != 0) atomicAdd(count, total);
  }
}

struct RankParams {
  long long n;
  const long long* order;    // int64 [n]: the rows in sorted order
  long long nrows;           // rows [0, nrows) real; -1: by row_valid
  const uint8_t* row_valid;  // bool [n] where nrows is -1
  const int* seg;            // int32 [n] in row order; null: one segment
  const long long* starts;   // int64 [num]: each segment's first sorted position
  int num;
  const long long* limit;    // int64 0-d, or null
  const int* limits;         // int32 [num], or null
  int ge;                    // keep rank >= limit, else rank < limit
  uint8_t* keep;             // bool [n], row order
  int* count;                // int32 0-d, zeroed by the caller
};

__global__ void __launch_bounds__(kThreads) rank_keep(const RankParams p) {
  const long long lim0 = p.limit != nullptr ? __ldg(p.limit) : 0;
  int acc = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  if (p.seg == nullptr && !p.ge) {
    // the prefix: positions [0, min(limit, n)) keep their real rows; the
    // mask was cleared
    const long long end = lim0 < p.n ? lim0 : p.n;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < end; i += stride) {
      const long long row = __ldg(p.order + i);
      if (is_real(p.nrows, p.row_valid, row)) {
        p.keep[row] = 1;
        ++acc;
      }
    }
    block_count(acc, p.count);
    return;
  }
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < p.n; i += stride) {
    const long long row = __ldg(p.order + i);
    bool keep = is_real(p.nrows, p.row_valid, row);
    long long rank = i, lim = lim0;
    if (keep && p.seg != nullptr) {
      const int s = __ldg(p.seg + row);
      if ((unsigned)s < (unsigned)p.num) {
        rank = i - __ldg(p.starts + s);
        if (p.limits != nullptr) lim = __ldg(p.limits + s);
      } else {
        keep = false;
      }
    }
    keep = keep && (p.ge ? rank >= lim : rank < lim);
    p.keep[row] = keep;
    acc += keep;
  }
  block_count(acc, p.count);
}

struct FirstParams {
  long long num;
  const int* first_idx;     // int32 [num]
  const uint8_t* occupied;  // bool [num], or null: every segment
  const int* counts;        // int32 [num] (kHit, kMiss)
  int mode;
  long long n;
  uint8_t* keep;            // bool [n], cleared by a memset first
  int* count;               // int32 0-d, cleared by a memset first
};

__global__ void __launch_bounds__(kThreads) first_row_mask(const FirstParams p) {
  int acc = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < p.num; g += stride) {
    const int f = __ldg(p.first_idx + g);
    bool ok = f >= 0 && f < p.n;
    if (ok && p.occupied != nullptr) ok = __ldg(p.occupied + g) != 0;
    if (ok && p.mode != kAll) {
      const int c = __ldg(p.counts + g);
      ok = p.mode == kHit ? c > 0 : c == 0;
    }
    if (ok) {
      p.keep[f] = 1;
      ++acc;
    }
  }
  block_count(acc, p.count);
}

struct NullParams {
  long long n;
  long long nrows;              // rows [0, nrows) real; -1: by row_valid
  const uint8_t* row_valid;
  const uint8_t* const* masks;  // device array of nmasks bool [n] pointers
  int nmasks;
  int ncols;                    // the columns tested; the others have no nulls
  int mode;                     // kAny, kAllNull or kThresh
  int thresh;
  uint8_t* keep;                // bool [n]
  int* count;                   // int32 0-d, zeroed by the caller
};

__global__ void __launch_bounds__(kThreads) null_count_keep(const NullParams p) {
  __shared__ const uint8_t* staged[kStagedMasks];
  const int nstaged = p.nmasks < kStagedMasks ? p.nmasks : kStagedMasks;
  for (int j = threadIdx.x; j < nstaged; j += kThreads) staged[j] = p.masks[j];
  __syncthreads();
  int acc = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < p.n; r += stride) {
    int valid = p.ncols - p.nmasks;
    for (int j = 0; j < p.nmasks; ++j) {
      const uint8_t* m = j < kStagedMasks ? staged[j] : p.masks[j];
      valid += __ldg(m + r) != 0;
    }
    bool keep = p.mode == kThresh ? valid >= p.thresh
                                  : (p.mode == kAny ? valid == p.ncols : valid > 0);
    keep = keep && is_real(p.nrows, p.row_valid, r);
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

// K12. order int64 [n]; rows as (nrows, or -1 and row_valid); seg int32
// [n] and starts int64 [num] together or both null; exactly one of limit
// (int64 0-d) and limits (int32 [num], with seg); ge 0 (rank < limit) or
// 1 (rank >= limit). Writes keep bool [n] (with one limit, no segment
// and ge 0, by a memset and the stores below the limit); adds the kept
// rows to count, which the caller zeroed.
extern "C" int fugue_rank_keep(long long n, const void* order, long long nrows,
                               const void* row_valid, const void* seg, const void* starts,
                               int num, const void* limit, const void* limits, int ge,
                               void* keep, void* count, int device, void* stream,
                               int* launched) {
  *launched = 0;
  if (n < 1 || n >= (1LL << 31) || (nrows < 0 && row_valid == nullptr) ||
      (seg == nullptr) != (starts == nullptr) || (seg != nullptr && num < 1) ||
      (limit == nullptr) == (limits == nullptr) || (limits != nullptr && seg == nullptr))
    return (int)cudaErrorInvalidValue;
  RankParams p = {};
  p.n = n;
  p.order = static_cast<const long long*>(order);
  p.nrows = nrows;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  p.seg = static_cast<const int*>(seg);
  p.starts = static_cast<const long long*>(starts);
  p.num = num;
  p.limit = static_cast<const long long*>(limit);
  p.limits = static_cast<const int*>(limits);
  p.ge = ge;
  p.keep = static_cast<uint8_t*>(keep);
  p.count = static_cast<int*>(count);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&] {
    if (seg == nullptr && !ge) {
      const cudaError_t e = cudaMemsetAsync(keep, 0, (size_t)n, st);
      if (e != cudaSuccess) return e;
    }
    return launch_wave(rank_keep, n, kThreads, device, st, p);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// K13. first_idx int32 [num]; occupied bool [num] or null; counts int32
// [num] for mode 1 (counts > 0) and 2 (counts == 0), else null (mode 0:
// every segment). Clears keep bool [n] and count int32 0-d, then sets
// keep at each kept segment's first row and counts them. With no segment
// it only clears.
extern "C" int fugue_first_row_mask(long long num, const void* first_idx, const void* occupied,
                                    const void* counts, int mode, long long n, void* keep,
                                    void* count, int device, void* stream, int* launched) {
  *launched = 0;
  if (n < 1 || n >= (1LL << 31) || num < 0 || num >= (1LL << 31) || mode < kAll ||
      mode > kMiss || ((mode != kAll) != (counts != nullptr)))
    return (int)cudaErrorInvalidValue;
  FirstParams p = {num, static_cast<const int*>(first_idx),
                   static_cast<const uint8_t*>(occupied), static_cast<const int*>(counts),
                   mode, n, static_cast<uint8_t*>(keep), static_cast<int*>(count)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&] {
    cudaError_t e = cudaMemsetAsync(keep, 0, (size_t)n, st);
    if (e == cudaSuccess) e = cudaMemsetAsync(count, 0, sizeof(int), st);
    if (e != cudaSuccess || num == 0) return e;
    return launch_wave(first_row_mask, num, kThreads, device, st, p);
  });
  if (err == cudaSuccess && num > 0) *launched = 1;
  return (int)err;
}

// K14. masks: a device array of nmasks pointers to bool [n] (null when
// nmasks is 0); ncols >= nmasks the columns tested; mode 0 (any: every
// column valid), 1 (all: any column valid) or 2 (at least thresh valid);
// rows as for K12. Writes keep bool [n]; adds the kept rows to count,
// which the caller zeroed.
extern "C" int fugue_null_count_keep(long long n, long long nrows, const void* row_valid,
                                     const void* masks, int nmasks, int ncols, int mode,
                                     int thresh, void* keep, void* count, int device,
                                     void* stream, int* launched) {
  *launched = 0;
  if (n < 1 || n >= (1LL << 31) || (nrows < 0 && row_valid == nullptr) || nmasks < 0 ||
      ncols < nmasks || (nmasks > 0 && masks == nullptr) || mode < kAny || mode > kThresh)
    return (int)cudaErrorInvalidValue;
  NullParams p = {n, nrows, static_cast<const uint8_t*>(row_valid),
                  static_cast<const uint8_t* const*>(masks), nmasks, ncols, mode, thresh,
                  static_cast<uint8_t*>(keep), static_cast<int*>(count)};
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(null_count_keep, n, kThreads, device, static_cast<cudaStream_t>(stream),
                       p);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The message of a cudaError_t, for the wrappers' exceptions.
extern "C" const char* fugue_row_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
