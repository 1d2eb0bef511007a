// Key factorization on the card: the binned path (K1) and the two passes
// of the sort path that follow torch's stable sorts (K2, K3).
//
// Replaces, in the JAX package (fugue_tpu/jax_backend/groupby.py; none of
// them is a Pallas kernel, each is a jitted XLA program):
//   K1 bin_factorize   _bin_core (:481): segment ids, first valid row per
//                      bin, occupied bins, group count;
//   K2 sort_boundaries the tail of _sort_factorize_core (:554): group
//                      boundaries over the sorted key codes, the inclusive
//                      scan to sorted segment ids, the group count;
//   K3 sort_finish     _sort_factorize_finish (:582): the sentinel on
//                      invalid rows, the scatter of the ids back to row
//                      order, the first row of each group.
// Their twins are bin_factorize_reference, sort_boundaries_reference and
// sort_finish_reference in reference.py.
//
// What bounds them on an H100: bytes. K1 reads the keys once and writes
// one id a row (8 bytes a row for one int32 key); the bins' first rows
// are a shared-memory atomicMin (global when the bins do not fit in 48
// KB), tried only when a plain read shows the row is earlier than the
// bin's current first, so after the first rows of a bin almost no row
// pays an atomic. K2 and K3 read the sort's int64 order (8 bytes a row)
// as torch.sort returns it, with no conversion pass; K2 gathers each
// key code at order[i] and order[i - 1] (random reads: the sort left the
// codes in row order), writes one flag byte a row, then scans the flags
// in a second pass, reduce-then-scan in three launches; K3 scatters one
// id a row to row order (random writes). None of the three is tuned yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bin_keys.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
// the bins' first rows live in shared memory up to the default per-block
// limit, which needs no opt-in
constexpr long long kSharedBins = 48 * 1024 / 4;
constexpr int kMaxCodes = 16;  // sort codes per K2 launch
constexpr int kItems = 16;     // K2 positions per thread and tile
constexpr int kTile = kThreads * kItems;

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

// Runs launch(stream) with device current, then makes the caller's
// current device current again.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  err = launch();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
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

struct SortParams {
  long long n;
  long long nrows;  // a prefix frame: position i is real iff order[i] < nrows
  const uint8_t* row_valid;  // a masked frame: real iff row_valid[order[i]]
  const long long* order;
  int ncodes;
  Code code[kMaxCodes];
  uint8_t* flags;   // uint8[n]: 0 same group, 1 opens a group, 2 not real
  int* block_sums;  // int32[tiles]: groups opened per tile, then offsets
  int tiles;
  int* seg_sorted;  // int32[n]: group id in sorted order, -1 where not real
  int* count;       // int32[1]: groups
};

__device__ __forceinline__ unsigned long long code_at(const Code& c, long long row) {
  if (c.width == 4)
    return __ldg(static_cast<const unsigned int*>(c.data) + row * c.stride);
  return __ldg(static_cast<const unsigned long long*>(c.data) + row * c.stride);
}

// Block-wide inclusive scan of one int a thread (Hillis-Steele in shared
// memory); returns the thread's inclusive sum, *total the block's.
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

// Pass 1: each position's flag and each tile's count of groups opened.
// Real positions come first in sorted order (validity is the sort's
// primary key), so position i - 1 of a real position i is real too.
__global__ void __launch_bounds__(kThreads)
    sort_flags(const __grid_constant__ SortParams p) {
  const long long base = (long long)blockIdx.x * kTile;
  int opened = 0;
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + (long long)j * kThreads + threadIdx.x;
    if (i >= p.n) break;
    const long long row = __ldg(p.order + i);
    const bool real = p.row_valid != nullptr ? __ldg(p.row_valid + row) != 0 : row < p.nrows;
    uint8_t f = 2;
    if (real) {
      f = 1;
      if (i > 0) {
        const long long prev = __ldg(p.order + i - 1);
        bool differ = false;
        for (int c = 0; c < p.ncodes; ++c)
          differ = differ || code_at(p.code[c], row) != code_at(p.code[c], prev);
        f = differ ? 1 : 0;
      }
    }
    p.flags[i] = f;
    opened += f == 1;
  }
  int total = 0;
  block_scan(opened, &total);
  if (threadIdx.x == 0) p.block_sums[blockIdx.x] = total;
}

// Pass 2, one block: the tiles' counts become exclusive offsets, and their
// sum is the group count.
__global__ void __launch_bounds__(kThreads)
    sort_offsets(const __grid_constant__ SortParams p) {
  const int per = (p.tiles + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < p.tiles ? lo + per : p.tiles;
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += p.block_sums[t];
  int total = 0;
  int run = block_scan(sum, &total) - sum;
  for (int t = lo; t < hi; ++t) {
    const int c = p.block_sums[t];
    p.block_sums[t] = run;
    run += c;
  }
  if (threadIdx.x == 0) *p.count = total;
}

// Pass 3: the inclusive scan of the flags within each tile, from the
// tile's offset; kItems consecutive positions a thread.
__global__ void __launch_bounds__(kThreads)
    sort_scan(const __grid_constant__ SortParams p) {
  const long long start = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  uint8_t f[kItems];
  int opened = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    f[j] = start + j < p.n ? p.flags[start + j] : 2;
    opened += f[j] == 1;
  }
  int total = 0;
  int run = p.block_sums[blockIdx.x] + block_scan(opened, &total) - opened;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (start + j >= p.n) break;
    run += f[j] == 1;
    p.seg_sorted[start + j] = f[j] == 2 ? -1 : run - 1;
  }
}

// ---- K3: sort finish -----------------------------------------------------

struct FinishParams {
  long long n;
  const int* seg_sorted;
  const long long* order;
  int num;
  int* seg;        // int32[n] in row order, num where the row is not real
  int* first_idx;  // int32[num]
};

// In sorted order a group's first position is the one that opens it, so
// first_idx[seg_sorted[i]] = order[i] where position i opens a group:
// the same value as the JAX package's segment_min over positions, with no
// reduction.
__global__ void __launch_bounds__(kThreads)
    sort_finish(const __grid_constant__ FinishParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < p.n; i += stride) {
    const int s = __ldg(p.seg_sorted + i);
    const long long row = __ldg(p.order + i);
    p.seg[row] = s < 0 ? p.num : s;
    if (s >= 0 && (i == 0 || __ldg(p.seg_sorted + i - 1) != s)) p.first_idx[s] = (int)row;
  }
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
// canonical: no NaN, no -0.0). Rows as for K1. Scratch: flags uint8[n]
// and block_sums int32[ceil(n / 4096)]. Writes seg_sorted int32[n] and
// count int32[1].
extern "C" int fugue_sort_boundaries(
    long long n, long long nrows, const void* row_valid, const void* order,
    int ncodes, const void* const* code_data, const long long* code_stride,
    const int* code_width, void* flags, void* block_sums, void* seg_sorted,
    void* count, int device, void* stream) {
  if (n < 1 || n >= (1LL << 31) || ncodes < 1 || ncodes > kMaxCodes)
    return (int)cudaErrorInvalidValue;
  SortParams p = {};
  p.n = n;
  p.nrows = nrows;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  p.order = static_cast<const long long*>(order);
  p.ncodes = ncodes;
  for (int c = 0; c < ncodes; ++c) {
    if (code_width[c] != 4 && code_width[c] != 8) return (int)cudaErrorInvalidValue;
    p.code[c] = {code_data[c], code_stride[c], code_width[c]};
  }
  p.flags = static_cast<uint8_t*>(flags);
  p.block_sums = static_cast<int*>(block_sums);
  p.tiles = (int)((n + kTile - 1) / kTile);
  p.seg_sorted = static_cast<int*>(seg_sorted);
  p.count = static_cast<int*>(count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    sort_flags<<<p.tiles, kThreads, 0, st>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sort_offsets<<<1, kThreads, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sort_scan<<<p.tiles, kThreads, 0, st>>>(p);
    return cudaGetLastError();
  });
}

// K3. seg_sorted as K2 writes it, order as K2 reads it, num the group
// count. Writes seg int32[n] and first_idx int32[num].
extern "C" int fugue_sort_finish(long long n, const void* seg_sorted,
                                 const void* order, int num, void* seg,
                                 void* first_idx, int device, void* stream) {
  if (n < 1 || n >= (1LL << 31) || num < 0) return (int)cudaErrorInvalidValue;
  FinishParams p = {n, static_cast<const int*>(seg_sorted),
                    static_cast<const long long*>(order), num,
                    static_cast<int*>(seg), static_cast<int*>(first_idx)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    int sms = 0;
    cudaError_t err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    sort_finish<<<grid_for(n, kThreads, sms, kMaxBlocksPerSm), kThreads, 0, st>>>(p);
    return cudaGetLastError();
  });
}

// The message of a cudaError_t, for the wrappers' exceptions.
extern "C" const char* fugue_factorize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
