// A partition by bucket whose sizes are known only once the data is read:
// shared by the slab routes of K7 join_build (join.cu) and K10 gather_rows
// (gather.cu). order_scatter.cuh's step 1 places entries whose buckets
// each hold a known count (a permutation's slab); here a count pass and a
// one-block scan give each bucket its start first, and then a block's
// tile of entries is grouped by bucket in shared memory (a histogram and
// its scan), one atomic a bucket reserves the tile's run, and the run is
// copied out with coalesced stores (tile_slots).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "order_scatter.cuh"

namespace fugue {

// The blocks of one persistent wave of `kernel` (threads a block, smem
// bytes of dynamic shared memory) over `tiles` tiles: at most as many as
// the device holds at once, at least one.
template <typename P>
cudaError_t wave_blocks(void (*kernel)(P), int threads, int smem, long long tiles, int device,
                        int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kernel), threads, smem);
  if (err != cudaSuccess) return err;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(tiles < 1 ? 1 : tiles < wave ? tiles : wave);
  return cudaSuccess;
}

// atomicAdd(hist + b, 1) for each lane of the warp whose b >= 0, with one
// atomic for the warp where those lanes share one b (a skewed or narrow
// key, a sorted index: else they would queue on one shared word); returns
// what the lane's own atomic would have returned. Every lane calls it.
__device__ __forceinline__ int warp_rank_add(int* hist, int b) {
  const unsigned live = __ballot_sync(0xffffffffu, b >= 0);
  if (live == 0) return 0;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs((int)live) - 1;
  const int first = __shfl_sync(0xffffffffu, b, leader);
  if (__all_sync(0xffffffffu, b < 0 || b == first)) {
    int base = 0;
    if (lane == leader) base = atomicAdd(hist + first, __popc(live));
    base = __shfl_sync(0xffffffffu, base, leader);
    return base + __popc(live & ((1u << lane) - 1u));
  }
  return b >= 0 ? atomicAdd(hist + b, 1) : 0;
}

// One tile's slots by bucket. Item k of the calling thread goes to
// bucket b[k] (-1: it has none) among nb buckets; on return pos[k] is its
// slot in the tile's order by bucket (-1: none), and hist[j] is the
// position in device memory of bucket j's first slot less that slot's
// index, where reserve(j, c) returned the position of the run of c
// entries that the tile takes in bucket j (positions below 2^31). Returns
// the tile's entries.
// Every thread of the block calls it; hist holds nb + 1 ints and
// warp_tot Threads / 32, both in shared memory.
template <int Threads, int Items, typename Reserve>
__device__ __forceinline__ int tile_slots(int nb, const int (&b)[Items], int (&pos)[Items],
                                          int* hist, int* warp_tot,
                                          const Reserve& reserve) {
  for (int s = threadIdx.x; s <= nb; s += Threads) hist[s] = 0;
  __syncthreads();
  int local[Items];
#pragma unroll
  for (int k = 0; k < Items; ++k)
    local[k] = warp_rank_add(hist, b[k]);
  __syncthreads();
  const int per = (nb + Threads - 1) / Threads;  // buckets a thread scans
  const int lo = min((int)threadIdx.x * per, nb), hi = min(lo + per, nb);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += hist[j];
  int total = 0;
  int at = block_exclusive_sum<Threads>(sum, warp_tot, &total);
  for (int j = lo; j < hi; ++j) {
    const int c = hist[j];
    hist[j] = at;
    at += c;
  }
  if (threadIdx.x == 0) hist[nb] = total;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < Items; ++k) pos[k] = b[k] >= 0 ? hist[b[k]] + local[k] : -1;
  // each bucket's run, reserved with one atomic; the last bucket of a
  // thread's range needs the next range's start, read before any is
  // overwritten. A thread's atomics go out kReserve at a time, their
  // latencies overlapping.
  constexpr int kReserve = 4;
  const int next = hist[hi];
  __syncthreads();
  for (int j0 = lo; j0 < hi; j0 += kReserve) {
    int start[kReserve], base[kReserve];
#pragma unroll
    for (int u = 0; u < kReserve; ++u) {
      const int j = j0 + u;
      start[u] = base[u] = 0;
      if (j >= hi) continue;
      start[u] = hist[j];
      const int c = (j + 1 < hi ? hist[j + 1] : next) - start[u];
      if (c != 0) base[u] = reserve(j, c);
    }
#pragma unroll
    for (int u = 0; u < kReserve; ++u)
      if (j0 + u < hi) hist[j0 + u] = base[u] - start[u];
  }
  __syncthreads();
  return total;
}

// The exclusive prefix sum of counts[0, nb) into starts[0, nb] (starts[nb]
// the total) by one block of Threads threads, a contiguous range of
// buckets a thread; copy[j] = starts[j] as well where copy is not null.
template <int Threads>
__device__ __forceinline__ void block_scan_counts(const int* counts, int* starts, int* copy,
                                                  int nb, int* warp_tot) {
  const int per = (nb + Threads - 1) / Threads;
  const int lo = min((int)threadIdx.x * per, nb), hi = min(lo + per, nb);
  int sum = 0;  // the totals stay below 2^31: the entries of one call
  for (int j = lo; j < hi; ++j) sum += counts[j];
  int total = 0;
  int at = block_exclusive_sum<Threads>(sum, warp_tot, &total);
  for (int j = lo; j < hi; ++j) {
    starts[j] = at;
    if (copy != nullptr) copy[j] = at;
    at += counts[j];
  }
  if (threadIdx.x == 0) starts[nb] = total;
}

}  // namespace fugue
