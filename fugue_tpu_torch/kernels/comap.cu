// Co-map membership on the card: K17 comap_presence and K18 comap_rows.
//
// They replace the membership part of the JAX package's compiled co-map
// program (compiled_comap's _wrapped, comap_compiled.py:314-365, which
// XLA lowers to segment sums, compares and gathers; no Pallas kernel):
//   - K17 comap_presence: per member, per segment, whether the member has
//     a real row there (`segment_sum(valid) > 0`, :335-341), as one bit a
//     member in ceil(N / 32) uint32 words a segment;
//   - K18 comap_rows: the zip's rule over those words (_alive_rule,
//     :197-213: inner all members, left_outer the first, right_outer the
//     last, full_outer any; a cross zip's one segment is always alive);
//     per row `valid & alive[seg]` and its segment id re-pointed at the
//     sentinel S where not alive (:344-362); per member its alive rows,
//     and the count of alive segments.
// Contracts: comap_presence_reference, comap_rows_reference in
// reference.py.
//
// Rows: the N members' rows stacked, member m holding rows
// [offsets[m], offsets[m + 1]). A row is real where it lies below its
// member's nrows[m] (a prefix frame) and, where `valid` is given, its
// byte is non-zero (masked frames).
//
// What bounds them on an H100, and what the design does about it:
//   - K17 reads 4 B (seg) and 1 B (validity) a row, coalesced, and sets
//     bits in S * W words (4 B each) that the wrapper zeroed. Rows of one
//     segment are adjacent in a co-partitioned frame (config 4: 50 rows
//     a key), so a warp first groups its lanes by (segment, member)
//     (__match_any_sync) and only each group's leader reads the word and,
//     where its bit is not yet set, ORs it in: about one atomic a segment
//     and member instead of one a row.
//   - K18 reads seg, validity and the row's segment's words (adjacent rows
//     share them, so mostly from L1) and writes 1 B (row_alive) and 4 B
//     (seg_out) a row, coalesced; the segments' part reads the words and
//     writes 1 B a segment. Both parts run in one launch over n + S
//     indices. The per-member counts are a warp vote (lanes grouped by
//     member), a block's counts in shared memory and one atomic a block
//     and member.
// Each row's member comes from a binary search of `offsets` (read through
// the read-only cache; N + 1 entries).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kSharedMembers = 64;  // per-member counts a block keeps in shared memory
constexpr int kInner = 0, kLeftOuter = 1, kRightOuter = 2, kFullOuter = 3, kCross = 4;

struct Layout {
  long long n;               // stacked rows
  const int* seg;            // int32 [n]
  const uint8_t* valid;      // bool [n], or null: every row below nrows is real
  const long long* offsets;  // int64 [members + 1]
  const long long* nrows;    // int64 [members]
  int members;
  int words;                 // ceil(members / 32)
  long long num;             // segments S
};

__device__ __forceinline__ int member_of(const Layout& l, long long r) {
  int lo = 0, hi = l.members - 1;  // the last m with offsets[m] <= r
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(l.offsets + mid) <= r) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool is_real(const Layout& l, int m, long long r) {
  return r - __ldg(l.offsets + m) < __ldg(l.nrows + m) &&
         (l.valid == nullptr || __ldg(l.valid + r) != 0);
}

struct PresenceParams {
  Layout l;
  unsigned* presence;  // uint32 [num * words], zeroed by the caller
};

__global__ void __launch_bounds__(kThreads)
    comap_presence(const __grid_constant__ PresenceParams p) {
  const Layout& l = p.l;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * kThreads;
  // every lane of a warp runs every iteration, so the warp votes together
  for (long long base = warp * 32; base < l.n; base += step) {
    const long long r = base + lane;
    long long bit = -1;  // (word index) * 32 + bit, or -1: nothing to set
    if (r < l.n) {
      const int m = member_of(l, r);
      const int s = __ldg(l.seg + r);
      if (s >= 0 && s < l.num && is_real(l, m, r))
        bit = ((long long)s * l.words + (m >> 5)) * 32 + (m & 31);
    }
    const unsigned same = __match_any_sync(0xffffffffu, bit);
    if (bit >= 0 && lane == __ffs(same) - 1) {
      unsigned* word = p.presence + (bit >> 5);
      const unsigned mask = 1u << (bit & 31);
      if ((*word & mask) == 0u) atomicOr(word, mask);
    }
  }
}

struct RowsParams {
  Layout l;
  const unsigned* presence;  // uint32 [num * words]; null for a cross zip
  int rule;
  uint8_t* row_alive;        // bool [n]
  int* seg_out;              // int32 [n]
  uint8_t* alive;            // bool [num]
  int* counts;               // int32 [members], zeroed by the caller
  int* alive_count;          // int32 0-d, zeroed by the caller
};

__device__ __forceinline__ bool segment_alive(const RowsParams& p, long long s) {
  if (p.rule == kCross) return true;
  const Layout& l = p.l;
  const unsigned* w = p.presence + s * l.words;
  if (p.rule == kLeftOuter) return (__ldg(w) & 1u) != 0u;
  if (p.rule == kRightOuter) {
    const int last = l.members - 1;
    return ((__ldg(w + (last >> 5)) >> (last & 31)) & 1u) != 0u;
  }
  if (p.rule == kFullOuter) {
    for (int j = 0; j < l.words; ++j)
      if (__ldg(w + j) != 0u) return true;
    return false;
  }
  for (int j = 0; j < l.words; ++j) {  // inner: every member's bit
    const int bits = (j == l.words - 1 && (l.members & 31)) ? (l.members & 31) : 32;
    const unsigned full = bits == 32 ? 0xffffffffu : (1u << bits) - 1u;
    if (__ldg(w + j) != full) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads) comap_rows(const __grid_constant__ RowsParams p) {
  __shared__ int block_counts[kSharedMembers];
  __shared__ int block_alive;
  const Layout& l = p.l;
  const int shared_members = l.members < kSharedMembers ? l.members : kSharedMembers;
  for (int j = threadIdx.x; j < shared_members; j += kThreads) block_counts[j] = 0;
  if (threadIdx.x == 0) block_alive = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * kThreads;
  const long long total = l.n + l.num;  // the rows, then the segments
  for (long long base = warp * 32; base < total; base += step) {
    const long long i = base + lane;
    int counted = -1;  // the member whose alive row this lane counts
    bool seg_alive = false;
    if (i < l.n) {
      const int m = member_of(l, i);
      const int s = __ldg(l.seg + i);
      const bool ra = s >= 0 && s < l.num && is_real(l, m, i) && segment_alive(p, s);
      p.row_alive[i] = ra;
      p.seg_out[i] = ra ? s : (int)l.num;
      if (ra) counted = m;
    } else if (i < total) {
      const long long s = i - l.n;
      seg_alive = segment_alive(p, s);
      p.alive[s] = seg_alive;
    }
    const unsigned same = __match_any_sync(0xffffffffu, counted);
    if (counted >= 0 && lane == __ffs(same) - 1) {
      if (counted < kSharedMembers) atomicAdd(&block_counts[counted], __popc(same));
      else atomicAdd(p.counts + counted, __popc(same));
    }
    const unsigned alive_lanes = __ballot_sync(0xffffffffu, seg_alive);
    if (lane == 0 && alive_lanes != 0u) atomicAdd(&block_alive, __popc(alive_lanes));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < shared_members; j += kThreads)
    if (block_counts[j] != 0) atomicAdd(p.counts + j, block_counts[j]);
  if (threadIdx.x == 0 && block_alive != 0) atomicAdd(p.alive_count, block_alive);
}

bool bad_layout(long long n, const void* seg, const void* offsets, const void* nrows,
                int members, long long num) {
  return n < 1 || n >= (1LL << 31) || seg == nullptr || offsets == nullptr ||
         nrows == nullptr || members < 1 || num < 1 || num >= (1LL << 31);
}

Layout layout(long long n, const void* seg, const void* valid, const void* offsets,
              const void* nrows, int members, long long num) {
  return Layout{n, static_cast<const int*>(seg), static_cast<const uint8_t*>(valid),
                static_cast<const long long*>(offsets), static_cast<const long long*>(nrows),
                members, (members + 31) / 32, num};
}

}  // namespace

// The plain C entry points, bound with ctypes. Each returns a cudaError_t
// (0 when every call was accepted), launches on stream (a cudaStream_t of
// device), allocates nothing and sets *launched to 1 where it launched
// its kernel. Rows: n stacked rows (1 to 2^31 - 1) of `members` members,
// offsets int64 [members + 1] and nrows int64 [members] on the device,
// valid bool [n] or null; num segments (1 to 2^31 - 1).

// K17: sets the presence bits (uint32 [num * ceil(members / 32)], zeroed
// by the caller) of every real row whose seg (int32 [n]) lies in
// [0, num).
extern "C" int fugue_comap_presence(long long n, const void* seg, const void* valid,
                                    const void* offsets, const void* nrows, int members,
                                    long long num, void* presence, int device, void* stream,
                                    int* launched) {
  *launched = 0;
  if (bad_layout(n, seg, offsets, nrows, members, num) || presence == nullptr)
    return (int)cudaErrorInvalidValue;
  PresenceParams p = {layout(n, seg, valid, offsets, nrows, members, num),
                      static_cast<unsigned*>(presence)};
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(comap_presence, n, kThreads, device, static_cast<cudaStream_t>(stream),
                       p);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// K18: rule 0 inner, 1 left_outer, 2 right_outer, 3 full_outer, 4 cross
// (presence null). Writes row_alive bool [n], seg_out int32 [n], alive
// bool [num]; adds each member's alive rows to counts int32 [members] and
// the alive segments to alive_count int32 0-d, both zeroed by the caller.
extern "C" int fugue_comap_rows(long long n, const void* seg, const void* valid,
                                const void* offsets, const void* nrows, int members,
                                long long num, const void* presence, int rule, void* row_alive,
                                void* seg_out, void* alive, void* counts, void* alive_count,
                                int device, void* stream, int* launched) {
  *launched = 0;
  if (bad_layout(n, seg, offsets, nrows, members, num) || rule < kInner || rule > kCross ||
      (rule != kCross && presence == nullptr) || row_alive == nullptr ||
      seg_out == nullptr || alive == nullptr || counts == nullptr || alive_count == nullptr)
    return (int)cudaErrorInvalidValue;
  RowsParams p = {layout(n, seg, valid, offsets, nrows, members, num),
                  static_cast<const unsigned*>(presence), rule,
                  static_cast<uint8_t*>(row_alive), static_cast<int*>(seg_out),
                  static_cast<uint8_t*>(alive), static_cast<int*>(counts),
                  static_cast<int*>(alive_count)};
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(comap_rows, n + num, kThreads, device, static_cast<cudaStream_t>(stream),
                       p);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The message of a cudaError_t, for the wrappers' exceptions.
extern "C" const char* fugue_comap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
