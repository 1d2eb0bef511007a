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
//     bits in S * W words (4 B each) that the wrapper zeroed: 0.124 ms at
//     config 4's 102M rows. A row a thread, with a binary search of
//     `offsets`, two more loads of the layout and a warp's
//     __match_any_sync a row, made it issue-bound (0.51 ms). So it walks
//     the layout as K18 does, from the block's copy in shared memory, but
//     with kPresenceRows consecutive rows a thread in a persistent wave of
//     row tiles with no barrier between them (each thread finds its own
//     first row's member): fewer threads' fixed work for the same rows,
//     which measured faster at config 4 than K18's 4 rows a thread and
//     its tile barrier (0.246-0.249 ms against 0.26-0.32). A run of equal
//     (segment, member) among a thread's real rows gives one candidate
//     bit, and a run that continues the lane before's last is dropped
//     (__shfl_up_sync), so a co-partitioned frame (config 4: 50 rows a key)
//     leaves about one candidate a segment and member; a candidate reads
//     its word through L2 and ORs its bit in where it is clear. Rows of
//     random segments (a masked frame) are each their own run: a word read
//     in L2 a row. Where nearly every row is a new bit in a table of words
//     larger than L2 (100M sorted rows of 33 members over 2^24 segments),
//     each warp instruction's reads and atomics go to 32 rows 16 apart,
//     and it is slower than a row a thread (PERF.md PR 21).
//   - K18 reads seg, validity and the row's segment's words (adjacent rows
//     share them, so mostly from L1) and writes 1 B (row_alive) and 4 B
//     (seg_out) a row, coalesced; the segments' part reads the words and
//     writes 1 B a segment. Its bytes are few (0.277 ms at config 4's
//     102M rows), and a row a thread with a search of offsets, a vote and
//     a byte store a row made it issue-bound (0.733 ms). So one launch
//     takes tiles: a block keeps the layout (each member's first row and
//     real-row end) in shared memory; a row tile of kRowTile rows finds its
//     first and last rows' members once, each thread takes kRowsPer
//     consecutive rows (16-byte loads and stores), walks to its rows'
//     members with compares only, reads the rule's words once for each run
//     of equal segments among its rows (all of its reads issued together)
//     and counts its alive rows in a register; a tile of one member adds
//     them by warp (__reduce_add_sync), one of several a thread's run of a
//     member at a time; a block's counts stay in shared memory for the
//     first kSharedMembers members, one atomic a block and member. Segment
//     tiles of kSegTile segments, kSegsPer a thread, follow the row tiles
//     in the same persistent wave. In a zip of more than kSharedMembers
//     members a thread finds its first row's member by a binary search of
//     `offsets` (read through the read-only cache), then walks, in both
//     kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kSharedMembers = 64;  // per-member counts a block keeps in shared memory
constexpr int kInner = 0, kLeftOuter = 1, kRightOuter = 2, kFullOuter = 3, kCross = 4;
// K18: consecutive rows a thread. 4 (one 16-byte load of seg) took 0.38 ms
// at config 4's 102M rows, 8 0.41, 16 0.59; at 100M rows of 33 members
// 1.40, 1.60 and 1.71 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6)
constexpr int kRowsPer = 4;
constexpr int kRowTile = kThreads * kRowsPer;
// K17: consecutive rows a thread. At config 4 16 took 0.246-0.249 ms, 12
// 0.245, 8 0.255, 4 0.261, 24 0.308 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md PR 21)
constexpr int kPresenceRows = 16;
constexpr int kPresenceTile = kThreads * kPresenceRows;
constexpr int kSegsPer = 16;  // K18: consecutive segments a thread
constexpr int kSegTile = kThreads * kSegsPer;
constexpr int kNoRow = 0x7fffffff;  // the start past the last member (rows are below 2^31)

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

// The block's copy of the layout (a zip of at most kSharedMembers members):
// each member's first row and the end of its real rows, as ints.
struct SharedLayout {
  int lo[kSharedMembers + 1];  // offsets
  int end[kSharedMembers];     // offsets + nrows, at most kNoRow
  int tile[4];                 // by tile parity: the first and the last member of the tile
};

__device__ __forceinline__ int real_end_of(const Layout& l, int m) {
  const long long e = __ldg(l.offsets + m) + __ldg(l.nrows + m);
  return e < kNoRow ? (int)e : kNoRow;
}

// The last member m with lo[m] <= r, in the block's copy.
__device__ __forceinline__ int shared_member_of(const SharedLayout& sl, int members, int r) {
  int lo = 0, hi = members - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (sl.lo[mid] <= r) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// A thread's kPresenceRows consecutive rows from r0 (rows past n read
// nothing): their segment ids (-1 past n) and, bit j, whether row r0 + j
// is below n with a non-zero valid byte. With vec (seg 16-byte and valid
// 4-byte aligned) four rows a load: seg in 16-byte, valid in 4-byte loads.
__device__ __forceinline__ unsigned load_rows(const Layout& l, bool vec, long long r0,
                                              int (&s)[kPresenceRows]) {
  unsigned ok = 0u;
  if (vec && r0 + kPresenceRows <= l.n) {
#pragma unroll
    for (int q = 0; q < kPresenceRows / 4; ++q) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(l.seg + r0) + q);
      s[4 * q] = x.x, s[4 * q + 1] = x.y, s[4 * q + 2] = x.z, s[4 * q + 3] = x.w;
      const unsigned y = l.valid == nullptr
                             ? 0x01010101u
                             : __ldcs(reinterpret_cast<const unsigned*>(l.valid + r0) + q);
#pragma unroll
      for (int k = 0; k < 4; ++k) ok |= (unsigned)(((y >> (8 * k)) & 0xFFu) != 0u) << (4 * q + k);
    }
    return ok;
  }
#pragma unroll
  for (int j = 0; j < kPresenceRows; ++j) {
    const long long r = r0 + j;
    s[j] = r < l.n ? __ldcs(l.seg + r) : -1;
    if (r < l.n && (l.valid == nullptr || __ldcs(l.valid + r) != 0)) ok |= 1u << j;
  }
  return ok;
}

struct PresenceParams {
  Layout l;
  unsigned* presence;  // uint32 [num * words], zeroed by the caller
  bool vec;            // seg 16-byte aligned, valid 4-byte aligned
  int row_tiles;       // tiles of kPresenceTile rows
};

// The bits of a thread's rows (load_rows) from r0. The first row's member
// comes from a search of the block's copy of the layout (of offsets, in a
// zip of more than kSharedMembers members), each next row's from compares
// with the next member's start; a row is real below its member's real-row
// end, valid and with a segment in [0, num). A run of equal (segment,
// member) among a thread's real rows gives one candidate; where every row
// is valid and of one member only the segments are compared. A thread hands
// its last run to the next lane, which drops its first run where it
// continues it (that lane, or one before it, sets the bit). Each remaining
// candidate reads its word through L2 (__ldcg: a stale word costs one
// redundant atomic) and ORs its bit in where it is clear. Every lane of the
// warp calls it.
__device__ __forceinline__ void set_bits(const PresenceParams& p, const SharedLayout& sl,
                                         long long r0, const int (&s)[kPresenceRows],
                                         unsigned ok) {
  const Layout& l = p.l;
  const bool cached = l.members <= kSharedMembers;
  int mj[kPresenceRows];
  unsigned head = 0u;  // the first row of each run
  int run_s = -1, run_m = -1, first_s = -1, first_m = -1;
  if (ok != 0u) {
    const int r = (int)r0;  // a row below n
    int m = cached ? shared_member_of(sl, l.members, r) : member_of(l, r);
    auto next_of = [&](int k) {
      return k + 1 > l.members ? kNoRow : cached ? sl.lo[k + 1] : (int)__ldg(l.offsets + k + 1);
    };
    int next = next_of(m);
    int real_end = cached ? sl.end[m] : real_end_of(l, m);
    if (ok == (1u << kPresenceRows) - 1u && r + kPresenceRows <= min(next, real_end)) {
      // every row valid and of member m: runs of equal segments
#pragma unroll
      for (int j = 0; j < kPresenceRows; ++j) {
        mj[j] = m;
        if ((unsigned)s[j] < (unsigned)l.num && s[j] != run_s) {
          if (head == 0u) first_s = s[j];
          head |= 1u << j;
          run_s = s[j];
        }
      }
      if (head != 0u) first_m = run_m = m;
    } else {
#pragma unroll
      for (int j = 0; j < kPresenceRows; ++j) {
        mj[j] = 0;
        if (((ok >> j) & 1u) == 0u) continue;
        const int rj = r + j;  // below n
        while (rj >= next) {  // into the next member (past empty ones)
          ++m;
          next = next_of(m);
          real_end = cached ? sl.end[m] : real_end_of(l, m);
        }
        mj[j] = m;
        if (rj < real_end && (unsigned)s[j] < (unsigned)l.num && (s[j] != run_s || m != run_m)) {
          if (head == 0u) first_s = s[j], first_m = m;
          head |= 1u << j;
          run_s = s[j], run_m = m;
        }
      }
    }
  }
  // every lane, those without rows too, passes its last run on
  const int before_s = __shfl_up_sync(0xffffffffu, run_s, 1);
  const int before_m = __shfl_up_sync(0xffffffffu, run_m, 1);
  if ((threadIdx.x & 31) != 0 && before_s >= 0 && first_s == before_s && first_m == before_m)
    head &= head - 1u;
  if (head == 0u) return;
  unsigned w[kPresenceRows];
#pragma unroll
  for (int j = 0; j < kPresenceRows; ++j)
    w[j] = ((head >> j) & 1u) ? __ldcg(p.presence + (long long)s[j] * l.words + (mj[j] >> 5)) : 0u;
#pragma unroll
  for (int j = 0; j < kPresenceRows; ++j) {
    const unsigned mask = 1u << (mj[j] & 31);
    if (((head >> j) & 1u) && (w[j] & mask) == 0u)
      atomicOr(p.presence + (long long)s[j] * l.words + (mj[j] >> 5), mask);
  }
}

// K17: a persistent wave over the row tiles of kPresenceTile rows, a
// thread's kPresenceRows consecutive rows of each (load_rows, set_bits).
// No barrier between tiles: a thread finds its own rows' members.
__global__ void __launch_bounds__(kThreads)
    comap_presence(const __grid_constant__ PresenceParams p) {
  __shared__ SharedLayout sl;
  const Layout& l = p.l;
  if (l.members <= kSharedMembers) {
    for (int j = threadIdx.x; j < l.members; j += kThreads) sl.end[j] = real_end_of(l, j);
    for (int j = threadIdx.x; j <= l.members; j += kThreads) sl.lo[j] = (int)__ldg(l.offsets + j);
  }
  __syncthreads();
  // the unit is the block's: every thread takes the same branches
  for (long long u = blockIdx.x; u < p.row_tiles; u += gridDim.x) {
    const long long r0 = u * kPresenceTile + (long long)threadIdx.x * kPresenceRows;
    int s[kPresenceRows];
    const unsigned ok = load_rows(l, p.vec, r0, s);
    set_bits(p, sl, r0, s, ok);
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
  bool vec;                  // seg, valid, row_alive, seg_out, alive, presence 16-byte aligned
  int row_tiles;             // tiles of kRowTile rows, then tiles of kSegTile segments
  int seg_tiles;
};

// The rule over one segment's presence word (a zip of at most 32 members).
__device__ __forceinline__ bool word_alive(const RowsParams& p, unsigned w) {
  if (p.rule == kLeftOuter) return (w & 1u) != 0u;
  if (p.rule == kRightOuter) return ((w >> (p.l.members - 1)) & 1u) != 0u;
  if (p.rule == kFullOuter) return w != 0u;
  const unsigned full = p.l.members == 32 ? 0xffffffffu : (1u << p.l.members) - 1u;
  return w == full;  // inner: every member's bit
}

// The rule over segment s's words, given its first and its last (the
// others, of a zip of more than 64 members, read here).
__device__ __forceinline__ bool rule_alive(const RowsParams& p, long long s, unsigned first,
                                           unsigned last) {
  const Layout& l = p.l;
  if (p.rule == kCross) return true;
  if (l.words == 1) return word_alive(p, first);
  if (p.rule == kLeftOuter) return (first & 1u) != 0u;
  if (p.rule == kRightOuter) return ((last >> ((l.members - 1) & 31)) & 1u) != 0u;
  const unsigned* w = p.presence + s * l.words;
  if (p.rule == kFullOuter) {
    if (first != 0u || last != 0u) return true;
    for (int j = 1; j < l.words - 1; ++j)
      if (__ldg(w + j) != 0u) return true;
    return false;
  }
  // inner: every member's bit
  const unsigned tail = (l.members & 31) ? (1u << (l.members & 31)) - 1u : 0xffffffffu;
  if (first != 0xffffffffu || last != tail) return false;
  for (int j = 1; j < l.words - 1; ++j)
    if (__ldg(w + j) != 0xffffffffu) return false;
  return true;
}

__device__ __forceinline__ bool segment_alive(const RowsParams& p, long long s) {
  if (p.rule == kCross) return true;
  const unsigned* w = p.presence + s * p.l.words;
  return rule_alive(p, s, __ldg(w), __ldg(w + p.l.words - 1));
}

// The alive rows of member m, counted by a thread or a warp: in the block's
// shared counts for the first kSharedMembers members, else in the global
// ones.
__device__ __forceinline__ void add_count(const RowsParams& p, int* block_counts, int m, int c) {
  if (c == 0) return;
  if (m < kSharedMembers) {
    atomicAdd(block_counts + m, c);
  } else {
    atomicAdd(p.counts + m, c);
  }
}

// A tile of kRowTile consecutive rows, kRowsPer consecutive rows a thread.
// Its first and last rows' members are found once (thread 0, in the
// block's copy of the layout); a thread then walks forward from the first
// member to its own rows' (a zip of more than kSharedMembers members: a
// search a thread over offsets), and each row only compares with the next
// member's start and the member's real-row bound. The rule's words are
// read once for each run of equal segments among a thread's rows, all of a
// thread's reads issued together.
__device__ __forceinline__ void rows_tile(const RowsParams& p, int t0, int parity,
                                          SharedLayout& sl, int* block_counts) {
  const Layout& l = p.l;
  const int n = (int)l.n;
  // a tile's end and a thread's last row + 1 may reach 2^31 (the top tile
  // of 2^31 - 1 rows): compared in 64 bits
  const int t1 = (int)((long long)t0 + kRowTile < l.n ? (long long)t0 + kRowTile : l.n);
  const bool cached = l.members <= kSharedMembers;
  if (threadIdx.x == 0) {
    sl.tile[2 * parity] = cached ? shared_member_of(sl, l.members, t0) : member_of(l, t0);
    sl.tile[2 * parity + 1] =
        cached ? shared_member_of(sl, l.members, t1 - 1) : member_of(l, t1 - 1);
  }
  // one barrier a tile: the next tile writes the other parity, and the one
  // after it this one only once every thread has passed the next barrier
  __syncthreads();
  const int first = sl.tile[2 * parity], last = sl.tile[2 * parity + 1];
  const int r0 = t0 + (int)threadIdx.x * kRowsPer;
  int mine = 0;  // alive rows of member m not yet added
  int m = first;
  if (r0 < t1) {
    if (cached) {
      while (m < last && sl.lo[m + 1] <= r0) ++m;
    } else {
      m = member_of(l, r0);
    }
    auto next_of = [&](int k) {
      return k + 1 > l.members ? kNoRow : cached ? sl.lo[k + 1] : (int)__ldg(l.offsets + k + 1);
    };
    int next = next_of(m);
    int real_end = cached ? sl.end[m] : real_end_of(l, m);
    int s[kRowsPer];
    uint8_t v[kRowsPer];
    const bool full = p.vec && (long long)r0 + kRowsPer <= l.n;
    if (full) {  // 4 consecutive rows a load
#pragma unroll
      for (int q = 0; q < kRowsPer / 4; ++q) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(l.seg + r0 + 4 * q));
        s[4 * q] = x.x, s[4 * q + 1] = x.y, s[4 * q + 2] = x.z, s[4 * q + 3] = x.w;
        const unsigned y =
            l.valid == nullptr ? 0x01010101u
                               : __ldcs(reinterpret_cast<const unsigned*>(l.valid + r0 + 4 * q));
#pragma unroll
        for (int k = 0; k < 4; ++k) v[4 * q + k] = (uint8_t)(y >> (8 * k));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
        const int r = r0 + j;
        s[j] = r < n ? __ldcs(l.seg + r) : -1;
        v[j] = r < n && (l.valid == nullptr || __ldcs(l.valid + r) != 0);
      }
    }
    // each row's member, whether it can be alive, and the heads of runs of
    // equal segments among those that can
    int mj[kRowsPer];
    unsigned can = 0u, head = 0u;
    int run_seg = -1;
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j) {
      const int r = r0 + j;
      if (r < n) {
        while (r >= next) {  // into the next member (past empty ones)
          ++m;
          next = next_of(m);
          real_end = cached ? sl.end[m] : real_end_of(l, m);
        }
      }
      mj[j] = m;
      if (r < n && v[j] != 0 && r < real_end && (unsigned)s[j] < (unsigned)l.num) {
        can |= 1u << j;
        if (s[j] != run_seg) head |= 1u << j;
        run_seg = s[j];
      }
    }
    unsigned wf[kRowsPer], wl[kRowsPer];
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j) {
      wf[j] = wl[j] = 0u;
      if (p.rule != kCross && ((head >> j) & 1u)) {
        const unsigned* w = p.presence + (long long)s[j] * l.words;
        if (l.words == 2 && p.vec) {  // both words in one 8-byte load
          const uint2 x = __ldg(reinterpret_cast<const uint2*>(w));
          wf[j] = x.x, wl[j] = x.y;
        } else {
          wf[j] = __ldg(w);
          wl[j] = __ldg(w + l.words - 1);
        }
      }
    }
    bool run_alive = false;
    unsigned flags[kRowsPer / 4] = {};  // row_alive, 4 rows a word
    m = mj[0];
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j) {
      if ((head >> j) & 1u) run_alive = rule_alive(p, s[j], wf[j], wl[j]);
      const bool a = ((can >> j) & 1u) && run_alive;
      flags[j >> 2] |= (unsigned)a << (8 * (j & 3));
      if (mj[j] != m) {
        add_count(p, block_counts, m, mine);
        mine = 0;
        m = mj[j];
      }
      mine += a;
      if (!a) s[j] = (int)l.num;
    }
    if (full) {
#pragma unroll
      for (int q = 0; q < kRowsPer / 4; ++q) {
        __stcs(reinterpret_cast<unsigned*>(p.row_alive + r0 + 4 * q), flags[q]);
        __stcs(reinterpret_cast<int4*>(p.seg_out + r0 + 4 * q),
               make_int4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
        const int r = r0 + j;
        if (r >= n) continue;
        p.row_alive[r] = (uint8_t)((flags[j >> 2] >> (8 * (j & 3))) & 1u);
        p.seg_out[r] = s[j];
      }
    }
  }
  if (first == last) {
    // a tile of one member: a warp's sum, one atomic a warp (every lane,
    // those past the rows too, takes this branch: first and last are the
    // block's)
    mine = (int)__reduce_add_sync(0xffffffffu, (unsigned)mine);
    if ((threadIdx.x & 31) == 0) add_count(p, block_counts, first, mine);
  } else {
    add_count(p, block_counts, m, mine);
  }
}

// A tile of kSegTile consecutive segments, kSegsPer a thread: each one's
// liveness, written 16 at a time, and the alive ones counted by warp. The
// words of a zip of at most 64 members are read 16 bytes at a time.
__device__ __forceinline__ void segments_tile(const RowsParams& p, long long u0,
                                              int* block_alive) {
  const Layout& l = p.l;
  const long long s0 = u0 + (long long)threadIdx.x * kSegsPer;
  int alive = 0;
  if (s0 < l.num) {
    uint8_t a[kSegsPer];
    const bool full = p.vec && s0 + kSegsPer <= l.num;
    if (full && p.rule != kCross && l.words == 1) {
#pragma unroll
      for (int q = 0; q < kSegsPer / 4; ++q) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p.presence + s0) + q);
        a[4 * q] = word_alive(p, x.x), a[4 * q + 1] = word_alive(p, x.y);
        a[4 * q + 2] = word_alive(p, x.z), a[4 * q + 3] = word_alive(p, x.w);
      }
    } else if (full && p.rule != kCross && l.words == 2) {
#pragma unroll
      for (int q = 0; q < kSegsPer / 2; ++q) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p.presence + 2 * s0) + q);
        a[2 * q] = rule_alive(p, s0 + 2 * q, x.x, x.y);
        a[2 * q + 1] = rule_alive(p, s0 + 2 * q + 1, x.z, x.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSegsPer; ++j) a[j] = s0 + j < l.num && segment_alive(p, s0 + j);
    }
    unsigned w[kSegsPer / 4] = {};
#pragma unroll
    for (int j = 0; j < kSegsPer; ++j) {
      alive += a[j];
      w[j >> 2] |= (unsigned)a[j] << (8 * (j & 3));
    }
    if (full) {
      __stcs(reinterpret_cast<uint4*>(p.alive + s0), make_uint4(w[0], w[1], w[2], w[3]));
    } else {
      for (int j = 0; j < kSegsPer && s0 + j < l.num; ++j) p.alive[s0 + j] = a[j];
    }
  }
  alive = (int)__reduce_add_sync(0xffffffffu, (unsigned)alive);
  if ((threadIdx.x & 31) == 0 && alive != 0) atomicAdd(block_alive, alive);
}

// K18: a persistent wave over the row tiles, then the segment tiles.
__global__ void __launch_bounds__(kThreads) comap_rows(const __grid_constant__ RowsParams p) {
  __shared__ int block_counts[kSharedMembers];
  __shared__ int block_alive;
  __shared__ SharedLayout sl;
  const Layout& l = p.l;
  const int shared_members = l.members < kSharedMembers ? l.members : kSharedMembers;
  for (int j = threadIdx.x; j < shared_members; j += kThreads) {
    block_counts[j] = 0;
    if (l.members <= kSharedMembers) sl.end[j] = real_end_of(l, j);
  }
  if (l.members <= kSharedMembers)
    for (int j = threadIdx.x; j <= l.members; j += kThreads) sl.lo[j] = (int)__ldg(l.offsets + j);
  if (threadIdx.x == 0) block_alive = 0;
  __syncthreads();
  // the unit is the block's: every thread takes the same branches
  int parity = 0;
  for (int u = blockIdx.x; u < p.row_tiles + p.seg_tiles; u += gridDim.x) {
    if (u < p.row_tiles) {
      rows_tile(p, u * kRowTile, parity, sl, block_counts);
      parity ^= 1;
    } else {
      segments_tile(p, (long long)(u - p.row_tiles) * kSegTile, &block_alive);
    }
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
// [0, num). *launched is 1 on the vector route (seg 16-byte and valid
// 4-byte aligned), 2 on the scalar one.
extern "C" int fugue_comap_presence(long long n, const void* seg, const void* valid,
                                    const void* offsets, const void* nrows, int members,
                                    long long num, void* presence, int device, void* stream,
                                    int* launched) {
  *launched = 0;
  if (bad_layout(n, seg, offsets, nrows, members, num) || presence == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(seg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  PresenceParams p = {layout(n, seg, valid, offsets, nrows, members, num),
                      static_cast<unsigned*>(presence), vec,
                      (int)((n + kPresenceTile - 1) / kPresenceTile)};
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(comap_presence, (long long)p.row_tiles * kThreads, kThreads, device,
                       static_cast<cudaStream_t>(stream), p);
  });
  if (err == cudaSuccess) *launched = vec ? 1 : 2;
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
  auto at16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  RowsParams p = {layout(n, seg, valid, offsets, nrows, members, num),
                  static_cast<const unsigned*>(presence), rule,
                  static_cast<uint8_t*>(row_alive), static_cast<int*>(seg_out),
                  static_cast<uint8_t*>(alive), static_cast<int*>(counts),
                  static_cast<int*>(alive_count),
                  at16(seg) && at16(valid) && at16(row_alive) && at16(seg_out) && at16(alive) &&
                      at16(presence),
                  (int)((n + kRowTile - 1) / kRowTile), (int)((num + kSegTile - 1) / kSegTile)};
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(comap_rows, ((long long)p.row_tiles + p.seg_tiles) * kThreads, kThreads,
                       device, static_cast<cudaStream_t>(stream), p);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The message of a cudaError_t, for the wrappers' exceptions.
extern "C" const char* fugue_comap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
