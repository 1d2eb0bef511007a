// One store through a sort's order, by slab: out[order[j]] = value_j for
// every sorted position j, where order is a permutation of [0, n), with no
// random store to device memory. Used by K3 sort_finish (factorize.cu) and
// K16 window_frame (window.cu); it generalizes row_select.cu's two steps
// (partition_kept, build_slabs) from a kept flag to a value.
//
//   1. partition (scatter_tile, called by the kernel's own pass): each
//      thread decides its items, decide(k, value, valid) -> row (or -1),
//      in the order it reads them (coalesced); the block groups the
//      tile's entries by destination slab (row >> shift) in shared memory
//      (a histogram and its scan), reserves one run a slab in that slab's
//      bucket with one atomic, and copies the entries out with coalesced
//      stores: the row's offset in its slab (bit 31: valid) and the value.
//   2. build (build_image): a thread-block cluster of kCluster blocks
//      holds the image of a slab in shared memory, each block a part; the
//      bucket's entries are placed through distributed shared memory into
//      the block that owns each row, and each block writes its part once
//      with 16-byte stores (the values, and the validity bytes where the
//      output has a mask).
// There are no holes to clear: order is a permutation, so bucket s holds
// exactly the rows of slab s (bucket_rows), the image is whole and needs no
// memset, and the scratch is one entry a row. An entry past its bucket (an
// order that is not a permutation) is dropped, never written out of
// bounds; with FUGUE_DEBUG_SLABS defined the build traps on a bucket whose
// count is not its slab's rows, and the wrappers keep the counts
// (last_fill) for chip_smoke.py to check.
//
// Why a cluster's slab (NVIDIA H100 80GB HBM3, 700 W, 100M rows; PERF.md,
// PR 14). A block's image holds 2^15 4-byte values (128 KB) or 2^14
// 8-byte values and their validity (144 KB): 3,000-6,000 slabs, so an
// 8K-entry tile puts 1-3 entries into a run and step 1's bucket stores
// scatter (K3 3.4 ms on any order but ascending runs, against 1.9 with
// the cluster's 2^18-row slabs, runs of 10-20 entries). Sixteen blocks
// were no faster than eight; plain stores into 2^21-row buckets that L2
// merges took 2.0-2.2 ms for K3's step 2 alone. The cluster's step 2 is
// bound by the rate of distributed shared memory's stores, so an entry
// sends its validity byte only where it is not valid (the image starts
// valid): 1.61 -> 0.99 ms for K16.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "launch.cuh"

namespace fugue {

constexpr int kCluster = 8;  // blocks a slab
constexpr int kImageThreads = 1024;
constexpr unsigned kValidBit = 0x80000000u;

// Rows of one block's part of the image: 128 KB of 4-byte values, or
// 8-byte values and their validity bytes (144 KB).
__host__ __device__ constexpr int image_shift(int value_bytes) { return value_bytes == 4 ? 15 : 14; }

// log2 of a slab's rows: at most 2^31 / 2^17 = 16384 slabs, whose
// histogram (64 KB) step 1 keeps in shared memory.
__host__ __device__ constexpr int slab_shift(int value_bytes) {
  return image_shift(value_bytes) + 3;
}
static_assert(1 << 3 == kCluster, "a slab is the cluster's parts");

__host__ __device__ inline long long slab_count(long long n, int shift) {
  return (n + (1LL << shift) - 1) >> shift;
}

struct SlabOut {
  long long n;     // rows of the output (the permutation's length)
  int shift;       // a slab is 2^shift rows
  int nslabs;
  unsigned* offs;  // [n]: bucket s from s << shift, a row's offset in its slab | valid << 31
  void* vals;      // [n]: the values, beside their offsets
  int* fill;       // [nslabs]: each bucket's entries, zeroed before step 1
};

// The entries bucket s holds: its slab's rows.
__host__ __device__ __forceinline__ long long bucket_rows(long long n, int shift, long long s) {
  const long long left = n - (s << shift);
  return left < (1LL << shift) ? left : (1LL << shift);
}

// The exclusive prefix sum of v over the block's Threads threads, and the
// block's total in *total; every thread calls it. scratch: Threads / 32 ints.
template <int Threads>
__device__ __forceinline__ int block_exclusive_sum(int v, int* scratch, int* total) {
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
  for (int w = 0; w < Threads / 32; ++w) {
    const int t = scratch[w];
    before += w < warp ? t : 0;
    all += t;
  }
  *total = all;
  __syncthreads();
  return before + x - v;
}

// Step 1's shared memory (bytes) for a tile of Threads * Items entries of
// value type V over nslabs slabs.
template <int Threads, int Items, typename V>
__host__ __device__ constexpr int scatter_smem(int nslabs) {
  return (int)((long long)Threads * Items * (sizeof(V) + sizeof(unsigned)) +
               sizeof(int) * ((long long)nslabs + 1 + Threads / 32));
}

// Step 1 for one tile: Items entries a thread, decide(k, value, valid)
// giving item k's destination row (-1: none). Every thread of the block
// calls it; smem is scatter_smem bytes, 16-byte aligned, reusable once it
// returns.
template <int Threads, int Items, typename V, typename Decide>
__device__ __forceinline__ void scatter_tile(const SlabOut& so, const Decide& decide,
                                             unsigned char* smem) {
  V* svals = reinterpret_cast<V*>(smem);
  unsigned* srows = reinterpret_cast<unsigned*>(svals + Threads * Items);
  int* hist = reinterpret_cast<int*>(srows + Threads * Items);  // nslabs + 1
  int* warp_tot = hist + so.nslabs + 1;
  for (int s = threadIdx.x; s <= so.nslabs; s += Threads) hist[s] = 0;
  __syncthreads();
  // the decisions first, so that their loads are in flight together; an
  // entry is its row | valid << 31, kNone where the item has none
  constexpr unsigned kNone = ~kValidBit;  // no row: rows are below 2^31 - 1
  unsigned entry[Items];
  V val[Items];
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    bool ok = false;
    const int r = decide(k, val[k], ok);
    entry[k] = r >= 0 && (long long)r < so.n ? (unsigned)r | (ok ? kValidBit : 0u) : kNone;
  }
  int local[Items];
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    const unsigned r = entry[k] & ~kValidBit;
    local[k] = r != kNone ? atomicAdd(hist + (r >> so.shift), 1) : 0;
  }
  __syncthreads();
  const int per = (so.nslabs + Threads - 1) / Threads;  // slabs a thread scans
  const int lo = min((int)threadIdx.x * per, so.nslabs), hi = min(lo + per, so.nslabs);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += hist[j];
  int total = 0;
  int at = block_exclusive_sum<Threads>(sum, warp_tot, &total);
  for (int j = lo; j < hi; ++j) {
    const int c = hist[j];
    hist[j] = at;
    at += c;
  }
  if (threadIdx.x == 0) hist[so.nslabs] = total;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    const unsigned r = entry[k] & ~kValidBit;
    if (r == kNone) continue;
    const int idx = hist[r >> so.shift] + local[k];
    srows[idx] = entry[k];
    svals[idx] = val[k];
  }
  // each slab's run, reserved with one atomic: hist[j] becomes the run's
  // start in the bucket less the slab's first staged entry; the last slab
  // of a thread's range needs the next range's start, read before any is
  // overwritten
  const int next = hist[hi];
  __syncthreads();
  for (int j = lo; j < hi; ++j) {
    const int start = hist[j];
    const int c = (j + 1 < hi ? hist[j + 1] : next) - start;
    const int base = c != 0 ? atomicAdd(so.fill + j, c) : 0;
    hist[j] = base - start;
  }
  __syncthreads();
  const unsigned slab_mask = (1u << so.shift) - 1u;
  for (int idx = threadIdx.x; idx < total; idx += Threads) {
    const unsigned o = srows[idx];
    const int r = (int)(o & ~kValidBit);
    const int s = r >> so.shift;
    const long long pos = (long long)hist[s] + idx;
    if (pos < bucket_rows(so.n, so.shift, s)) {
      const long long e = ((long long)s << so.shift) + pos;
      so.offs[e] = ((unsigned)r & slab_mask) | (o & kValidBit);
      static_cast<V*>(so.vals)[e] = svals[idx];
    }
  }
  __syncthreads();
}

// ---- step 2 ----------------------------------------------------------------

struct ImageParams {
  long long n;
  int shift;
  int nslabs;
  const unsigned* offs;
  const void* vals;
  const int* fill;
  void* out;      // V [n], 16-byte aligned
  uint8_t* outm;  // bool [n], 16-byte aligned (kMask)
};

template <typename V, bool kMask>
__host__ __device__ constexpr int image_bytes() {
  return (1 << image_shift(sizeof(V))) * (int)(sizeof(V) + (kMask ? 1 : 0));
}

// One slab by the kCluster blocks of a cluster: the bucket's entries,
// interleaved over the cluster's blocks in warp-wide runs, placed into the
// block that owns each row's part of the image, then each block writes its
// part with 16-byte stores.
template <typename V, bool kMask>
__global__ void __launch_bounds__(kImageThreads) build_slab(const ImageParams p) {
  constexpr int kShift = image_shift(sizeof(V));
  constexpr int kRows = 1 << kShift;
  extern __shared__ uint4 image_raw[];
  V* img = reinterpret_cast<V*>(image_raw);
  uint8_t* vimg = reinterpret_cast<uint8_t*>(img + kRows);
  // the mask image starts valid; an entry sends its byte only where it is
  // not (one store an entry instead of two, where most rows are valid)
  if constexpr (kMask) {
    for (int i = threadIdx.x; i < kRows / 16; i += kImageThreads)
      reinterpret_cast<uint4*>(vimg)[i] = make_uint4(0x01010101u, 0x01010101u, 0x01010101u,
                                                     0x01010101u);
  }
  auto cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();  // every part's block has started, its mask image set
  const long long slab = blockIdx.x / kCluster;
  const long long r0 = slab << p.shift;
  const long long rows = bucket_rows(p.n, p.shift, slab);
  long long cnt = p.fill[slab];
#ifdef FUGUE_DEBUG_SLABS
  if (cnt != rows) __trap();
#endif
  cnt = cnt < rows ? cnt : rows;
  const unsigned* offs = p.offs + r0;
  const V* vals = static_cast<const V*>(p.vals) + r0;
  auto place = [&](unsigned o, V v) {
    const unsigned off = o & ~kValidBit;
    const unsigned owner = off >> kShift, at = off & (kRows - 1);
    cluster.map_shared_rank(img, owner)[at] = v;
    if (kMask && !(o & kValidBit)) cluster.map_shared_rank(vimg, owner)[at] = 0;
  };
  // kUnroll entries' loads in flight a thread before their stores (the
  // stores may alias the loads, so they would otherwise wait in turn)
  constexpr int kUnroll = 4;
  const long long stride = (long long)kCluster * kImageThreads;
  long long e = (long long)rank * kImageThreads + threadIdx.x;
  for (; e + (kUnroll - 1) * stride < cnt; e += kUnroll * stride) {
    unsigned o[kUnroll];
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      o[u] = __ldcs(offs + e + u * stride);
      v[u] = __ldcs(vals + e + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) place(o[u], v[u]);
  }
  for (; e < cnt; e += stride) place(__ldcs(offs + e), __ldcs(vals + e));
  cluster.sync();
  const long long b0 = (long long)rank * kRows;
  const long long nb = rows - b0 < kRows ? rows - b0 : kRows;
  if (nb <= 0) return;
  V* out = static_cast<V*>(p.out) + r0 + b0;
  constexpr int kVec = 16 / (int)sizeof(V);
  for (long long c = threadIdx.x; c * kVec < nb; c += kImageThreads) {
    const long long r = c * kVec;
    if (r + kVec <= nb) {
      *reinterpret_cast<uint4*>(out + r) = *reinterpret_cast<const uint4*>(img + r);
    } else {
      for (long long k = r; k < nb; ++k) out[k] = img[k];
    }
  }
  if constexpr (kMask) {
    uint8_t* om = p.outm + r0 + b0;
    for (long long c = threadIdx.x; c * 16 < nb; c += kImageThreads) {
      const long long r = c * 16;
      if (r + 16 <= nb) {
        *reinterpret_cast<uint4*>(om + r) = *reinterpret_cast<const uint4*>(vimg + r);
      } else {
        for (long long k = r; k < nb; ++k) om[k] = vimg[k];
      }
    }
  }
}

// The dynamic shared memory cap of kernel raised to smem bytes, once a
// device for the largest smem asked.
template <auto Kernel>
cudaError_t allow_smem(int device, int smem) {
  static std::atomic<int> allowed[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (allowed[device].load(std::memory_order_relaxed) >= smem) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed[device].store(smem, std::memory_order_relaxed);
  return err;
}

// Step 2, after step 1 has filled the buckets on stream st.
template <typename V, bool kMask>
cudaError_t build_image(const ImageParams& p, int device, cudaStream_t st) {
  constexpr auto kernel = build_slab<V, kMask>;
  const int smem = image_bytes<V, kMask>();
  const cudaError_t err = allow_smem<kernel>(device, smem);
  if (err != cudaSuccess) return err;
  return launch_cluster(kernel, (long long)p.nslabs * kCluster, kImageThreads, kCluster, smem,
                        st, p);
}

}  // namespace fugue
