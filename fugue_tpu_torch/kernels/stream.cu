// Streaming aggregation on the card: K19 stream_fold.
//
// It replaces the JAX package's streaming update program
// (StreamingAggregator._get_update's _update, streaming.py:295-350, which
// XLA lowers to one segment sum, min or max a plan over the chunk, added
// into donated accumulators; no Pallas kernel): one chunk's rows binned
// into the aggregator's slot space (the mixed radix of _Space.seg,
// streaming.py:125) and folded into the persistent accumulators of every
// plan:
//   - kRows, kCount: u64 adds (every row; the valid values);
//   - kSumI: int64 sums as u64 adds, exact by two's complement;
//   - kSumF, kSumIF: float64 adds of a float64 value, or of an int64 value
//     converted (an average of integers);
//   - kMinI, kMaxI: signed min/max;
//   - kMinF, kMaxF: the same on the float's order key (its bits, the
//     magnitude flipped where negative: a signed order equal to the
//     float's).
// A masked value is skipped; NaN never arrives (the caller masks it as
// null, as streaming.py:428-440 does); a row whose slot is outside the
// store is dropped. Contract: stream_fold_reference in reference.py.
//
// What bounds it on an H100: it reads 8 B a key and 8 B (+1 B where
// masked) a payload a row, and each touched slot's accumulators once (8 B
// read and 8 B written each). The store is slot-major ([slots][width]).
// Its first version made one global atomic a row and accumulator (200M a
// 10M-row chunk at 20 accumulators) into a store that L2 does not hold
// (1M slots x 160 B); it ran at 22x its bound. This design folds in
// shared memory instead, by slab of slots (a slab: 2^shift slots whose
// accumulators fit one block's shared memory, the wrapper's fold_plan):
//   1. fold_count: each row's slot, and the rows of every slab;
//   2. fold_plan (one block): each slab's bucket in the entries, and its
//      pieces of at most kPiece entries;
//   3. fold_partition: each block groups a tile of rows by slab in shared
//      memory, reserves one run a slab in its bucket with one atomic and
//      copies the entries out coalesced: the slot in the slab with the
//      payloads' validity bits, and the row (8 B an entry; copying the
//      values into the entries instead was slower, PERF.md);
//   4. fold_slabs: one block a piece. Each distinct accumulator (the
//      columns that repeat one, as an average's sum beside a sum, share
//      it) is folded into an image of the slab's slots in shared memory
//      from the neutral values, the values read through the entries'
//      rows; then each touched column of the store is read, combined and
//      written once where the slab is one piece, or merged with one
//      global atomic a touched accumulator where its bucket is several
//      (a hot slot, a skewed key).
// Shared-memory atomics of 64 bits are compare-and-swap loops on sm_90, so
// counts and int64 sums add 32-bit words (merge_shared). A warp whose 32
// entries share one slot reduces each accumulator across the warp and
// keeps it in a private row until the warp meets another such slot: a hot
// slot is no contended address. A slot space that one slab holds whole
// skips steps 1-3: fold_direct folds the rows straight from the chunk, a
// block a range of rows, and merges as the pieces do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "order_scatter.cuh"

namespace {

using namespace fugue;

constexpr int kMaxKeys = 8;
constexpr int kMaxPayloads = 16;
constexpr int kMaxOps = 48;
constexpr int kRows = 0, kCount = 1, kSumI = 2, kSumF = 3, kSumIF = 4, kMinI = 5, kMaxI = 6,
              kMinF = 7, kMaxF = 8;
constexpr long long kMagnitude = 0x7fffffffffffffffLL;
constexpr long long kMinLL = -0x7fffffffffffffffLL - 1;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kCountThreads = 512;
constexpr int kPartThreads = 1024;
constexpr int kPartItems = 16;                // rows a thread of a partition tile, at most
constexpr int kPartBytes = 200 * 1024;        // a partition tile's shared memory, at most
constexpr int kFoldThreads = 1024;
constexpr int kMaxImageBytes = 200 * 1024;    // a slab's accumulators, at most
constexpr int kMaxSlabs = 1 << 14;            // a partition tile's histogram: 64 KB
constexpr long long kPiece = 1LL << 15;       // entries a fold block takes, at most
constexpr long long kDirectRows = 1LL << 16;  // rows a fold_direct block takes, at least

struct FoldKey {
  const long long* data;  // int64 [n]
  long long lo;
  long long span;
};

struct FoldPayload {
  const long long* values;  // int64 or float64 [n], read as their bits
  const uint8_t* mask;      // bool [n], or null: every value valid
  int read;                 // 1: an accumulator reads its values; 0: it is only counted
};

// An accumulator the fold computes once a slot, however many columns of
// the store take it (an average's sum beside a sum, a payload's count
// beside each of its functions).
struct FoldAcc {
  int kind;
  int payload;  // index into payloads; -1 for kRows
};

struct FoldParams {
  long long n;
  unsigned long long* store;  // int64 [slots][width]
  long long slots;
  int width;
  int shift;   // a slab is 2^shift slots
  int nslabs;
  int items;   // rows a thread of a partition tile
  int nkeys, npayloads;
  int nacc;                  // distinct accumulators
  int* counts;               // [nslabs]: each slab's rows (fold_count)
  int* fill;                 // [nslabs]: each bucket's entries (fold_partition)
  int* start;                // [nslabs + 1]: each bucket's first entry
  int* pfirst;               // [nslabs + 1]: each slab's first piece
  unsigned* offs;            // [n]: an entry's slot in its slab | validity bits << 16
  unsigned* rows;            // [n]: an entry's row
  FoldKey keys[kMaxKeys];
  FoldPayload payloads[kMaxPayloads];
  FoldAcc accs[kMaxOps];
  int col_acc[kMaxOps];      // each column's accumulator, -1: none
};

__device__ __forceinline__ long long order_key(long long bits) {
  return bits < 0 ? bits ^ kMagnitude : bits;
}

// Row r's slot, or -1 outside the store.
__device__ __forceinline__ long long slot_of(const FoldParams& p, long long r) {
  long long slot = 0;
  for (int j = 0; j < p.nkeys; ++j)
    slot = slot * p.keys[j].span + (__ldg(p.keys[j].data + r) - p.keys[j].lo);
  return slot >= 0 && slot < p.slots ? slot : -1;
}

__device__ __forceinline__ unsigned validity(const FoldParams& p, long long r) {
  unsigned bits = 0;
  for (int j = 0; j < p.npayloads; ++j) {
    const uint8_t* m = p.payloads[j].mask;
    bits |= (m == nullptr || __ldg(m + r) != 0 ? 1u : 0u) << j;
  }
  return bits;
}

// ---- one accumulator, in the store's representation -------------------------

__host__ __device__ __forceinline__ long long neutral(int kind) {
  if (kind == kMinI || kind == kMinF) return kMagnitude;
  if (kind == kMaxI || kind == kMaxF) return kMinLL;
  return 0;  // counts and sums (+0.0's bits)
}

// A valid value's contribution (its bits; the rows' 1).
__device__ __forceinline__ long long contribution(int kind, long long bits) {
  switch (kind) {
    case kRows:
    case kCount:
      return 1;
    case kSumIF:
      return __double_as_longlong((double)bits);
    case kMinF:
    case kMaxF:
      return order_key(bits);
    default:
      return bits;
  }
}

__device__ __forceinline__ long long combine(int kind, long long x, long long y) {
  switch (kind) {
    case kSumF:
    case kSumIF:
      return __double_as_longlong(__longlong_as_double(x) + __longlong_as_double(y));
    case kMinI:
    case kMinF:
      return x < y ? x : y;
    case kMaxI:
    case kMaxF:
      return x > y ? x : y;
    default:
      return (long long)((unsigned long long)x + (unsigned long long)y);
  }
}

// v folded into the accumulator at a in global memory (a piece's merge).
__device__ __forceinline__ void merge(unsigned long long* a, int kind, long long v) {
  switch (kind) {
    case kSumF:
    case kSumIF:
      atomicAdd(reinterpret_cast<double*>(a), __longlong_as_double(v));
      break;
    case kMinI:
    case kMinF:
      atomicMin(reinterpret_cast<long long*>(a), v);
      break;
    case kMaxI:
    case kMaxF:
      atomicMax(reinterpret_cast<long long*>(a), v);
      break;
    default:
      atomicAdd(a, (unsigned long long)v);
      break;
  }
}

// v folded into the accumulator at a in shared memory, where a 64-bit
// atomic is a compare-and-swap loop (ATOMS.CAST.SPIN.64 on sm_90) and a
// 32-bit add is native: a count (v at most 32) and an int64 sum add their
// low words, and their high words only with a carry or a high part; a
// min/max reads first and swaps only a value that improves the
// accumulator (it only moves one way, so a stale read costs a swap, never
// a result). Float sums remain swap loops.
__device__ __forceinline__ void merge_shared(unsigned long long* a, int kind, long long v) {
  unsigned* const lo = reinterpret_cast<unsigned*>(a);  // little-endian: the low word first
  switch (kind) {
    case kRows:
    case kCount:
    case kSumI: {
      const unsigned low = (unsigned)v;
      const unsigned old = atomicAdd(lo, low);
      const unsigned high = (unsigned)((unsigned long long)v >> 32) + (old + low < old ? 1u : 0u);
      if (high != 0) atomicAdd(lo + 1, high);
      break;
    }
    case kMinI:
    case kMinF:
      if (v < *reinterpret_cast<volatile long long*>(a)) atomicMin(reinterpret_cast<long long*>(a), v);
      break;
    case kMaxI:
    case kMaxF:
      if (v > *reinterpret_cast<volatile long long*>(a)) atomicMax(reinterpret_cast<long long*>(a), v);
      break;
    default:
      atomicAdd(reinterpret_cast<double*>(a), __longlong_as_double(v));
      break;
  }
}

// ---- a slab's image in shared memory ----------------------------------------

// A piece's image: each distinct accumulator of each slot of the slab,
// from the neutral values; each warp's private row (see WarpFold); each
// accumulator's kind and each column's accumulator, copied from the
// parameters, where a warp's lanes read different ones (the constant
// cache serves one address a cycle).
struct Image {
  unsigned long long* acc;  // [rows][nacc]
  long long* ident;         // [nacc]: each accumulator's neutral value
  long long* priv;          // [kFoldWarps][nacc]
  int* kind;                // [nacc]
  int* col;                 // [width]: p.col_acc
  long long rows;
};

constexpr int kFoldWarps = kFoldThreads / 32;

__host__ __device__ inline int image_smem(int nacc, int shift, int width) {
  return (int)((((long long)nacc << shift) + (long long)nacc * (1 + kFoldWarps)) * 8 +
               4LL * (nacc + width) + 15) / 16 * 16;
}

// The image in dynamic shared memory, every accumulator neutral. Every
// thread calls it, and it syncs.
__device__ __forceinline__ Image image_of(const FoldParams& p, uint4* smem, long long rows) {
  Image im;
  im.acc = reinterpret_cast<unsigned long long*>(smem);
  im.ident = reinterpret_cast<long long*>(im.acc + ((long long)p.nacc << p.shift));
  im.priv = im.ident + p.nacc;
  im.kind = reinterpret_cast<int*>(im.priv + kFoldWarps * p.nacc);
  im.col = im.kind + p.nacc;
  im.rows = rows;
  if (threadIdx.x < p.nacc) im.kind[threadIdx.x] = p.accs[threadIdx.x].kind;
  if (threadIdx.x < p.width) im.col[threadIdx.x] = p.col_acc[threadIdx.x];
  __syncthreads();
  for (int a = threadIdx.x; a < p.nacc * (1 + kFoldWarps); a += blockDim.x)
    im.ident[a] = neutral(im.kind[a % p.nacc]);
  __syncthreads();
  const int words = (int)rows * p.nacc;  // below 2^16 x 48
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    im.acc[i] = (unsigned long long)im.ident[i % p.nacc];
  __syncthreads();
  return im;
}

// The folded image into the store's slots dst: where the block owns the
// slots, each column read, combined with its accumulator and written
// (coalesced); else each accumulator the piece moved merged into each of
// its columns with one global atomic.
__device__ __forceinline__ void image_finish(const FoldParams& p, const Image& im,
                                             unsigned long long* dst, bool own) {
  const int words = (int)im.rows * p.width;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int slot = i / p.width, a = im.col[i - slot * p.width];
    if (a < 0) continue;
    const long long d = (long long)im.acc[slot * p.nacc + a];
    if (d == im.ident[a]) continue;
    if (own) {
      dst[i] = (unsigned long long)combine(im.kind[a], (long long)dst[i], d);
    } else {
      merge(dst + i, im.kind[a], d);
    }
  }
}

// One warp's fold into the image, one entry a lane a call (every lane of
// the warp calls it). Where the warp's 32 entries share a slot, each
// accumulator is reduced across the warp, and lane 0 adds it into the
// warp's private row for that slot with plain stores; the row goes into
// the image (with atomics) when the warp meets another such slot and at
// the end. A hot slot is then no contended address.
struct WarpFold {
  const FoldParams& p;
  const Image& im;
  long long* row;  // the warp's private row
  int slot = -1;   // the slot it holds

  __device__ WarpFold(const FoldParams& params, const Image& image)
      : p(params), im(image), row(image.priv + (threadIdx.x >> 5) * params.nacc) {}

  __device__ __forceinline__ void flush() {
    __syncwarp();
    if (slot >= 0) {
      for (int a = threadIdx.x & 31; a < p.nacc; a += 32) {
        const long long v = row[a];
        if (v != im.ident[a]) merge_shared(im.acc + (long long)slot * p.nacc + a, im.kind[a], v);
        row[a] = im.ident[a];
      }
    }
    __syncwarp();
  }

  // has: whether the lane holds an entry; off: its slot in the image;
  // vbits: its payloads' validity; value(j): payload j's bits.
  template <class Value>
  __device__ __forceinline__ void fold(bool has, int off, unsigned vbits, const Value& value) {
    const int off0 = __shfl_sync(kFull, off, 0);  // every lane, before any test of has
    const bool uniform = __all_sync(kFull, has && off == off0);
    if (uniform && off0 != slot) {
      flush();
      slot = off0;
    }
    unsigned long long* const dst = im.acc + (long long)off * p.nacc;
    int cur = -1;
    long long bits = 0;
    for (int a = 0; a < p.nacc; ++a) {
      const FoldAcc ac = p.accs[a];
      bool ok = true;
      if (ac.kind != kRows) {
        ok = (vbits >> ac.payload) & 1u;
        if (ac.payload != cur) {  // a payload's adjacent accumulators share one load
          cur = ac.payload;
          bits = has && p.payloads[cur].read ? value(cur) : 0;
        }
      }
      long long v = contribution(ac.kind, bits);
      if (uniform) {
        v = ok ? v : neutral(ac.kind);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v = combine(ac.kind, v, __shfl_xor_sync(kFull, v, d));
        if ((threadIdx.x & 31) == 0) row[a] = combine(ac.kind, row[a], v);
      } else if (has && ok) {
        merge_shared(dst + a, ac.kind, v);
      }
    }
  }
};

// ---- step 1: the slabs' rows -------------------------------------------------

__global__ void __launch_bounds__(kCountThreads) fold_count(const __grid_constant__ FoldParams p) {
  extern __shared__ int count_hist[];
  for (int s = threadIdx.x; s < p.nslabs; s += kCountThreads) count_hist[s] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kCountThreads;
  for (long long base = (long long)blockIdx.x * kCountThreads + (threadIdx.x & ~31); base < p.n;
       base += step) {
    const long long r = base + lane;
    const long long slot = r < p.n ? slot_of(p, r) : -1;
    const int slab = slot >= 0 ? (int)(slot >> p.shift) : -1;
    const unsigned peers = __match_any_sync(kFull, slab);
    if (slab >= 0 && lane == __ffs(peers) - 1) atomicAdd(count_hist + slab, __popc(peers));
  }
  __syncthreads();
  for (int s = threadIdx.x; s < p.nslabs; s += kCountThreads) {
    const int c = count_hist[s];
    if (c != 0) atomicAdd(p.counts + s, c);
  }
}

// ---- step 2: buckets and pieces ------------------------------------------------

constexpr int kPlanThreads = 1024;

__device__ __forceinline__ int pieces_of(int count) { return (int)((count + kPiece - 1) / kPiece); }

__global__ void __launch_bounds__(kPlanThreads) fold_plan(const __grid_constant__ FoldParams p) {
  __shared__ int warp_tot[kPlanThreads / 32];
  const int per = (p.nslabs + kPlanThreads - 1) / kPlanThreads;
  const int lo = min((int)threadIdx.x * per, p.nslabs), hi = min(lo + per, p.nslabs);
  int rows = 0, pieces = 0;
  for (int s = lo; s < hi; ++s) {
    rows += p.counts[s];
    pieces += pieces_of(p.counts[s]);
  }
  int total_rows = 0, total_pieces = 0;
  int at = block_exclusive_sum<kPlanThreads>(rows, warp_tot, &total_rows);
  int pat = block_exclusive_sum<kPlanThreads>(pieces, warp_tot, &total_pieces);
  for (int s = lo; s < hi; ++s) {
    p.start[s] = at;
    p.pfirst[s] = pat;
    at += p.counts[s];
    pat += pieces_of(p.counts[s]);
  }
  if (threadIdx.x == 0) {
    p.start[p.nslabs] = total_rows;
    p.pfirst[p.nslabs] = total_pieces;
  }
}

// ---- step 3: the entries, grouped by slab ---------------------------------------

__host__ __device__ inline int partition_smem(int items, int nslabs) {
  return kPartThreads * items * 12 + 4 * (nslabs + 1 + kPartThreads / 32);
}

__global__ void __launch_bounds__(kPartThreads) fold_partition(const __grid_constant__ FoldParams p) {
  extern __shared__ uint4 part_smem[];
  const int tile = kPartThreads * p.items;
  unsigned* sentry = reinterpret_cast<unsigned*>(part_smem);
  unsigned* srow = sentry + tile;
  unsigned* sslab = srow + tile;
  int* hist = reinterpret_cast<int*>(sslab + tile);  // nslabs + 1
  int* warp_tot = hist + p.nslabs + 1;
  for (int s = threadIdx.x; s <= p.nslabs; s += kPartThreads) hist[s] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * tile;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // each item's slot and its place among the tile's entries of its slab
  int slot[kPartItems], local[kPartItems];
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {  // the keys' loads in flight together
    const long long r = t0 + (long long)k * kPartThreads + threadIdx.x;
    slot[k] = k < p.items && r < p.n ? (int)slot_of(p, r) : -1;
  }
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    local[k] = 0;
    if (k >= p.items) continue;
    const int slab = slot[k] >= 0 ? slot[k] >> p.shift : -1;
    const unsigned peers = __match_any_sync(kFull, slab);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (slab >= 0 && lane == leader) base = atomicAdd(hist + slab, __popc(peers));
    local[k] = __shfl_sync(kFull, base, leader) + __popc(peers & below);
  }
  __syncthreads();
  const int per = (p.nslabs + kPartThreads - 1) / kPartThreads;  // slabs a thread scans
  const int lo = min((int)threadIdx.x * per, p.nslabs), hi = min(lo + per, p.nslabs);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += hist[j];
  int total = 0;
  int at = block_exclusive_sum<kPartThreads>(sum, warp_tot, &total);
  for (int j = lo; j < hi; ++j) {
    const int c = hist[j];
    hist[j] = at;
    at += c;
  }
  if (threadIdx.x == 0) hist[p.nslabs] = total;
  __syncthreads();
  const unsigned in_slab = (1u << p.shift) - 1u;
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    if (slot[k] < 0) continue;
    const long long r = t0 + (long long)k * kPartThreads + threadIdx.x;
    const int slab = slot[k] >> p.shift;
    const int idx = hist[slab] + local[k];
    sentry[idx] = ((unsigned)slot[k] & in_slab) | validity(p, r) << 16;
    srow[idx] = (unsigned)r;
    sslab[idx] = (unsigned)slab;
  }
  // each slab's run, reserved with one atomic: hist[j] becomes the run's
  // first entry less the slab's first staged entry; the last slab of a
  // thread's range needs the next range's start, read before any is
  // overwritten. A run past its bucket (keys that changed between the
  // passes) is dropped, never written out of bounds.
  const int next = hist[hi];
  __syncthreads();
  constexpr int kDrop = -0x7fffffff - 1;
  for (int j = lo; j < hi; ++j) {
    const int first = hist[j];
    const int c = (j + 1 < hi ? hist[j + 1] : next) - first;
    const int base = c != 0 ? atomicAdd(p.fill + j, c) : 0;
    hist[j] = base + c <= p.counts[j] ? p.start[j] + base - first : kDrop;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < total; idx += kPartThreads) {
    const int s = (int)sslab[idx];
    if (hist[s] == kDrop) continue;
    const long long e = (long long)hist[s] + idx;
    p.offs[e] = sentry[idx];
    p.rows[e] = srow[idx];
  }
}

// ---- step 4: each piece folded in shared memory ---------------------------------

__global__ void __launch_bounds__(kFoldThreads) fold_slabs(const __grid_constant__ FoldParams p) {
  extern __shared__ uint4 fold_smem[];
  __shared__ int slab_sh;
  const int b = (int)blockIdx.x;
  if (b >= p.pfirst[p.nslabs]) return;
  if (threadIdx.x == 0) {  // the slab whose pieces hold b: the last with pfirst <= b
    int lo = 0, hi = p.nslabs - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (p.pfirst[mid] <= b) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    slab_sh = lo;
  }
  __syncthreads();
  const int s = slab_sh;
  const long long slot0 = (long long)s << p.shift;
  const long long left = p.slots - slot0;
  const Image im = image_of(p, fold_smem, left < (1LL << p.shift) ? left : (1LL << p.shift));
  const long long e0 = p.start[s] + (long long)(b - p.pfirst[s]) * kPiece;
  const long long e1 = e0 + kPiece < p.start[s + 1] ? e0 + kPiece : p.start[s + 1];
  const int lane = threadIdx.x & 31;
  WarpFold wf(p, im);
  for (long long base = e0 + (threadIdx.x & ~31); base < e1; base += kFoldThreads) {
    const long long e = base + lane;
    const bool has = e < e1;
    const unsigned o = has ? __ldcs(p.offs + e) : 0u;
    const unsigned r = has ? __ldcs(p.rows + e) : 0u;
    wf.fold(has, (int)(o & 0xffffu), o >> 16,
            [&](int j) { return __ldg(p.payloads[j].values + r); });
  }
  wf.flush();
  __syncthreads();
  image_finish(p, im, p.store + slot0 * p.width, p.pfirst[s + 1] - p.pfirst[s] == 1);
}

// A slot space that one slab holds: each block folds a range of the rows
// straight from the chunk.
__global__ void __launch_bounds__(kFoldThreads) fold_direct(const __grid_constant__ FoldParams p) {
  extern __shared__ uint4 direct_smem[];
  const Image im = image_of(p, direct_smem, p.slots);
  const long long per = (p.n + gridDim.x - 1) / gridDim.x;
  const long long r0 = (long long)blockIdx.x * per, r1 = r0 + per < p.n ? r0 + per : p.n;
  const int lane = threadIdx.x & 31;
  WarpFold wf(p, im);
  for (long long base = r0 + (threadIdx.x & ~31); base < r1; base += kFoldThreads) {
    const long long r = base + lane;
    const long long slot = r < r1 ? slot_of(p, r) : -1;
    const bool has = slot >= 0;
    wf.fold(has, has ? (int)slot : 0, has ? validity(p, r) : 0u,
            [&](int j) { return __ldg(p.payloads[j].values + r); });
  }
  wf.flush();
  __syncthreads();
  image_finish(p, im, p.store, gridDim.x == 1);
}

// Blocks of kernel that the device runs at once with smem bytes each.
template <class K>
cudaError_t wave(K kernel, int threads, int smem, int device, long long* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

cudaError_t run_fold(const FoldParams& p, int device, cudaStream_t st) {
  cudaError_t err;
  const int ismem = image_smem(p.nacc, p.shift, p.width);
  if (p.nslabs == 1) {
    err = allow_smem<fold_direct>(device, ismem);
    long long blocks = 0;
    if (err == cudaSuccess) err = wave(fold_direct, kFoldThreads, ismem, device, &blocks);
    if (err != cudaSuccess) return err;
    const long long need = (p.n + kDirectRows - 1) / kDirectRows;
    return launch_cluster(fold_direct, need < blocks ? need : blocks, kFoldThreads, 1, ismem, st,
                          p);
  }
  err = cudaMemsetAsync(p.counts, 0, sizeof(int) * 2 * (size_t)p.nslabs, st);  // counts, fill
  const int csmem = 4 * p.nslabs;
  if (err == cudaSuccess) err = allow_smem<fold_count>(device, csmem);
  long long blocks = 0;
  if (err == cudaSuccess) err = wave(fold_count, kCountThreads, csmem, device, &blocks);
  if (err != cudaSuccess) return err;
  const long long need = (p.n + kCountThreads - 1) / kCountThreads;
  err = launch_cluster(fold_count, need < blocks ? need : blocks, kCountThreads, 1, csmem, st, p);
  if (err == cudaSuccess) err = launch_params(fold_plan, 1, kPlanThreads, st, p);
  const int psmem = partition_smem(p.items, p.nslabs);
  if (err == cudaSuccess) err = allow_smem<fold_partition>(device, psmem);
  if (err != cudaSuccess) return err;
  const long long tile = (long long)kPartThreads * p.items;
  err = launch_cluster(fold_partition, (p.n + tile - 1) / tile, kPartThreads, 1, psmem, st, p);
  if (err == cudaSuccess) err = allow_smem<fold_slabs>(device, ismem);
  if (err != cudaSuccess) return err;
  // at most one piece a slab and one a kPiece entries; the blocks past the
  // plan's pieces return at once
  return launch_cluster(fold_slabs, p.nslabs + (p.n + kPiece - 1) / kPiece, kFoldThreads, 1,
                        ismem, st, p);
}

}  // namespace

// The plain C entry point, bound with ctypes. Returns a cudaError_t (0
// when every call was accepted), launches on stream (a cudaStream_t of
// device), allocates nothing and sets *launched to 1 where it launched.
// n rows (1 to 2^31 - 1) into store, int64 [slots][width] on the device,
// 16-byte aligned, slots below 2^31, width 1 to 48; the descriptors are
// host arrays: keys (nkeys x 3: data pointer, lo, span), payloads
// (npayloads x 3: values pointer, mask pointer or 0, 1 where an op reads
// the values, 0 where they are only counted) and ops (nops x 3: kind,
// payload index, column of the store, one op a column), at most 8, 16 and
// 48. The ops of equal kind and payload share one accumulator of the
// image; a slab is 2^shift slots (the distinct accumulators at most
// kMaxImageBytes), at most kMaxSlabs of them. Where the store is more than
// one slab: state int32 [4 nslabs + 2] (counts, fill, start, pfirst),
// offs and rows uint32 [n].
extern "C" int fugue_stream_fold(long long n, void* store, long long slots, long long width,
                                 int nkeys, const long long* keys, int npayloads,
                                 const long long* payloads, int nops, const long long* ops,
                                 int shift, int* state, void* offs, void* rows, int device,
                                 void* stream, int* launched) {
  *launched = 0;
  if (n < 1 || n >= (1LL << 31) || store == nullptr ||
      reinterpret_cast<uintptr_t>(store) % 16 != 0 || slots < 1 || slots >= (1LL << 31) ||
      width < 1 || width > kMaxOps || nkeys < 1 || nkeys > kMaxKeys || npayloads < 0 ||
      npayloads > kMaxPayloads || nops < 1 || nops > kMaxOps || shift < 1 || shift > 16)
    return (int)cudaErrorInvalidValue;
  FoldParams p = {};
  p.n = n;
  p.store = static_cast<unsigned long long*>(store);
  p.slots = slots;
  p.width = (int)width;
  p.shift = shift;
  const long long nslabs = (slots + (1LL << shift) - 1) >> shift;
  if (nslabs > kMaxSlabs) return (int)cudaErrorInvalidValue;
  p.nslabs = (int)nslabs;
  p.nkeys = nkeys;
  p.npayloads = npayloads;
  for (int j = 0; j < nkeys; ++j) {
    p.keys[j].data = reinterpret_cast<const long long*>(keys[3 * j]);
    p.keys[j].lo = keys[3 * j + 1];
    p.keys[j].span = keys[3 * j + 2];
    if (p.keys[j].data == nullptr || p.keys[j].span < 1) return (int)cudaErrorInvalidValue;
  }
  for (int j = 0; j < npayloads; ++j) {
    p.payloads[j].values = reinterpret_cast<const long long*>(payloads[3 * j]);
    p.payloads[j].mask = reinterpret_cast<const uint8_t*>(payloads[3 * j + 1]);
    p.payloads[j].read = payloads[3 * j + 2] != 0;
  }
  for (int c = 0; c < width; ++c) p.col_acc[c] = -1;
  for (int o = 0; o < nops; ++o) {
    const int kind = (int)ops[3 * o], payload = kind == kRows ? -1 : (int)ops[3 * o + 1];
    const int column = (int)ops[3 * o + 2];
    if (kind < kRows || kind > kMaxF || column < 0 || column >= width ||
        p.col_acc[column] >= 0 || (kind != kRows && (payload < 0 || payload >= npayloads)) ||
        (kind != kRows && kind != kCount && !p.payloads[payload].read))
      return (int)cudaErrorInvalidValue;
    int a = 0;
    while (a < p.nacc && (p.accs[a].kind != kind || p.accs[a].payload != payload)) ++a;
    if (a == p.nacc) p.accs[p.nacc++] = {kind, payload};
    p.col_acc[column] = a;
  }
  if (((long long)p.nacc << shift) * 8 > kMaxImageBytes) return (int)cudaErrorInvalidValue;
  if (nslabs > 1) {
    if (state == nullptr || offs == nullptr || rows == nullptr) return (int)cudaErrorInvalidValue;
    p.counts = state;
    p.fill = state + nslabs;
    p.start = state + 2 * nslabs;
    p.pfirst = state + 3 * nslabs + 1;
    p.offs = static_cast<unsigned*>(offs);
    p.rows = static_cast<unsigned*>(rows);
    // the partition tile's rows a thread: as many as its shared memory holds
    int items = kPartItems;
    while (items > 1 && partition_smem(items, p.nslabs) > kPartBytes) --items;
    p.items = items;
  }
  const cudaError_t err =
      on_device(device, [&] { return run_fold(p, device, static_cast<cudaStream_t>(stream)); });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The message of a cudaError_t, for the wrapper's exceptions.
extern "C" const char* fugue_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
