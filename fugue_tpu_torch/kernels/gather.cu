// K10 gather_rows: every column of one join side gathered by one index
// vector.
//
// It replaces the column gathers of the JAX package's join programs in
// relational.py, which XLA lowers to one gather a column and a mask op;
// none of it is a Pallas kernel:
//   - expand_join's _gather_prog (:578-585): the left side by the output
//     rows' left rows, the right side by their right rows, a right row's
//     mask false where it has no match;
//   - _unique_right_join's _prog (:683-687): the right side by each left
//     row's right row;
//   - _gather_right_unmatched's _prog (:767-776): the full outer join's
//     tail, the right rows with no left match.
// Contract: gather_rows_reference in reference.py.
//
// For each column: out[t] = data[idx[t]], 0 where idx[t] is -1; where the
// column has an output mask, out_mask[t] = (mask[idx[t]] or true where the
// column has no mask) and idx[t] >= 0. A column is its data's bytes: an
// element of 1, 2, 4 or 8 bytes is copied as it is, whatever its dtype.
//
// What bounds it on an H100: bytes, the gathered elements read once and
// written once plus 4 B of index a row; and where the index is scattered
// over sources larger than L2, the rate of random 32 B sectors (about
// 27-29M a ms, a third of the stream rate: PERF.md §6). Two routes,
// which the caller picks (gather.py):
//   - direct (an index in order, or sources that fit in L2): one output
//     row a thread a step over a persistent wave; the index is read once
//     for every column, each column's stores coalesce across the warp,
//     and its loads are as random as the index;
//   - slab (a scattered index): three steps, each of whose device memory
//     accesses is coalesced or falls inside an L2-sized slab.
//       1. The output positions t are grouped by the source slab of
//          idx[t] (2^kSrcShift rows; -1 to a last bucket of holes): a
//          count pass, a one-block scan and a partition
//          (slab_partition.cuh) into 8-byte entries (idx[t], t), once a
//          call.
//       2. For each group of columns whose elements pack into 8 B a row
//          (group_end), the entries are read in order, so the blocks in
//          flight read a few source slabs at once and their random loads
//          hit L2; each entry becomes a record, a 4-byte header (t's
//          offset in its destination slab of 2^kDstShift rows, a mask bit
//          a column) and its packed elements, 8 or 16 bytes, and the tile's
//          records are grouped by destination slab and copied out with one
//          store each.
//       3. A thread-block cluster a destination slab reads its bucket,
//          places each packed row through distributed shared memory into
//          the image of the slab (as order_scatter.cuh's build does: one
//          store an entry, a mask byte only where it is false), and each
//          block writes its part of every column and mask out. The output
//          positions are a permutation of [0, n) whatever idx holds
//          (duplicates, -1s), so every image is whole and needs no memset.
//     The scratch is at most 24 B a row (8 B entries, 8-16 B records) and a
//     few ints a slab.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "slab_partition.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kMaxColumns = 8;

struct GatherColumn {
  const void* data;
  void* out;
  const uint8_t* mask;  // bool, true = valid; null: every row valid
  uint8_t* out_mask;    // bool; null: no output mask
  int width;            // bytes an element: 1, 2, 4 or 8
};

struct GatherParams {
  long long n;     // output rows
  const int* idx;  // int32 [n], -1 or a row of the columns
  int ncols;
  GatherColumn col[kMaxColumns];
};

template <typename T>
__device__ __forceinline__ void copy_element(const GatherColumn& c, long long t, int i) {
  T v = 0;
  if (i >= 0) v = __ldg(static_cast<const T*>(c.data) + i);
  static_cast<T*>(c.out)[t] = v;
}

__global__ void __launch_bounds__(kThreads) gather_rows(const GatherParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < p.n; t += stride) {
    const int i = __ldg(p.idx + t);
    for (int c = 0; c < p.ncols; ++c) {
      const GatherColumn& col = p.col[c];
      switch (col.width) {
        case 1: copy_element<uint8_t>(col, t, i); break;
        case 2: copy_element<uint16_t>(col, t, i); break;
        case 4: copy_element<uint32_t>(col, t, i); break;
        default: copy_element<unsigned long long>(col, t, i); break;
      }
      if (col.out_mask != nullptr) {
        col.out_mask[t] = i >= 0 && (col.mask == nullptr || __ldg(col.mask + i) != 0);
      }
    }
  }
}

// ---- the slab route ------------------------------------------------------

constexpr int kSrcShift = 18;   // a source slab: 2 MB of an 8-byte column, in L2 while read
constexpr int kPartShift = 14;  // a block's part of a destination slab's image
constexpr int kDstShift = kPartShift + 3;  // a destination slab: the cluster's parts
static_assert(1 << 3 == kCluster, "a destination slab is the cluster's parts");
constexpr int kPartRows = 1 << kPartShift;
constexpr unsigned kDstMask = (1u << kDstShift) - 1u;
constexpr int kGroupBytes = 8;  // a group's elements a row, packed into one record
constexpr int kImageRowBytes = 14;  // a row's bytes in the image (2^14 rows: 224 KB)
constexpr int kSlabThreads = 512;
constexpr int kSlabItems = 16;
constexpr int kSlabTile = kSlabThreads * kSlabItems;
constexpr int kScanThreads = 1024;
static_assert(kDstShift + kMaxColumns <= 32, "a header holds the offset and the mask bits");

struct SourceArgs {
  long long n;
  const int* idx;
  long long src_rows;  // the rows of the longest column
  int nb;              // buckets: the source slabs, then the holes
  int* counts;         // [nb], zeroed before the count pass
  int* starts;         // [nb + 1]
  int* cursor;         // [nb]
  unsigned long long* entries;  // [n]: idx[t] << 32 | t, by source slab
};

// A source row's bucket: its slab, or the last bucket for -1 (and for an
// index past the columns, which the contract excludes).
__device__ __forceinline__ int source_bucket(int i, long long src_rows, int nb) {
  return (long long)(unsigned)i < src_rows ? i >> kSrcShift : nb - 1;
}

__global__ void __launch_bounds__(kSlabThreads) gather_count_sources(const SourceArgs p) {
  extern __shared__ int count_smem[];
  for (int s = threadIdx.x; s < p.nb; s += kSlabThreads) count_smem[s] = 0;
  __syncthreads();
  // every lane takes the same steps (warp_rank_add), a thread's loads in
  // flight together
  constexpr int kRows = 4;
  const long long step = (long long)kSlabThreads * kRows;
  for (long long t0 = (long long)blockIdx.x * step; t0 < p.n; t0 += gridDim.x * step) {
    int b[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long t = t0 + u * kSlabThreads + threadIdx.x;
      b[u] = t < p.n ? source_bucket(__ldg(p.idx + t), p.src_rows, p.nb) : -1;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) warp_rank_add(count_smem, b[u]);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < p.nb; s += kSlabThreads) {
    const int c = count_smem[s];
    if (c != 0) atomicAdd(p.counts + s, c);
  }
}

__global__ void __launch_bounds__(kScanThreads) gather_scan_sources(const SourceArgs p) {
  __shared__ int warp_tot[kScanThreads / 32];
  block_scan_counts<kScanThreads>(p.counts, p.starts, p.cursor, p.nb, warp_tot);
}

__global__ void __launch_bounds__(kSlabThreads) gather_partition_sources(const SourceArgs p) {
  extern __shared__ uint4 source_smem[];
  auto* stage = reinterpret_cast<unsigned long long*>(source_smem);
  int* hist = reinterpret_cast<int*>(stage + kSlabTile);
  int* warp_tot = hist + p.nb + 1;
  for (long long t0 = (long long)blockIdx.x * kSlabTile; t0 < p.n;
       t0 += (long long)gridDim.x * kSlabTile) {
    int iv[kSlabItems], b[kSlabItems], pos[kSlabItems];
#pragma unroll
    for (int k = 0; k < kSlabItems; ++k) {
      const long long t = t0 + (long long)k * kSlabThreads + threadIdx.x;
      iv[k] = t < p.n ? __ldg(p.idx + t) : 0;
      b[k] = t < p.n ? source_bucket(iv[k], p.src_rows, p.nb) : -1;
    }
    const int total = tile_slots<kSlabThreads, kSlabItems>(
        p.nb, b, pos, hist, warp_tot, [&](int j, int c) { return atomicAdd(p.cursor + j, c); });
#pragma unroll
    for (int k = 0; k < kSlabItems; ++k)
      if (pos[k] >= 0)
        stage[pos[k]] = (unsigned long long)(unsigned)iv[k] << 32 |
                        (unsigned)(t0 + (long long)k * kSlabThreads + threadIdx.x);
    __syncthreads();
    for (int j = threadIdx.x; j < total; j += kSlabThreads) {
      const unsigned long long e = stage[j];
      const int s = source_bucket((int)(unsigned)(e >> 32), p.src_rows, p.nb);
      const int at = hist[s] + j;
      if (at < p.starts[s + 1]) p.entries[at] = e;
    }
    __syncthreads();
  }
}

struct RouteColumn {
  const void* data;
  const uint8_t* mask;  // null: every row valid
  long long rows;       // the column's rows
  int width;
  int masked;           // the caller wants an output mask
  int shift;            // bits into the group's packed row
};

struct RouteArgs {
  long long n;
  const unsigned long long* entries;
  int ncols;
  RouteColumn col[kMaxColumns];
  int ndst;    // destination slabs
  void* rec;   // [n] records of rec_bytes, by destination slab
  int rec_bytes;  // 8 (a row of at most 4 B) or 16
  int* fill;   // [ndst], zeroed: each bucket's entries
};

// Step 2's shared memory (bytes): the tile's packed rows, positions t and
// mask bits, the histogram over destination slabs.
__host__ __device__ constexpr int route_smem(int ndst) {
  return kSlabTile * (8 + 4 + 1) + 4 * (ndst + 1 + kSlabThreads / 32);
}

// A column's elements of a thread's items, read from their source rows
// (in L2: the items of a tile come from few source slabs) into the packed
// rows, and their mask bits.
template <typename T>
__device__ __forceinline__ void load_column(const RouteColumn& c, int bit,
                                            const unsigned long long (&e)[kSlabItems],
                                            const int (&pos)[kSlabItems],
                                            unsigned long long (&row)[kSlabItems],
                                            unsigned (&bits)[kSlabItems]) {
  T v[kSlabItems];
  bool ok[kSlabItems];
#pragma unroll
  for (int k = 0; k < kSlabItems; ++k) {
    const unsigned i = (unsigned)(e[k] >> 32);
    const bool hit = pos[k] >= 0 && (long long)i < c.rows;
    v[k] = hit ? __ldg(static_cast<const T*>(c.data) + i) : T(0);
    ok[k] = hit && (c.mask == nullptr || __ldg(c.mask + i) != 0);
  }
#pragma unroll
  for (int k = 0; k < kSlabItems; ++k) {
    row[k] |= (unsigned long long)v[k] << c.shift;
    if (c.masked && ok[k]) bits[k] |= 1u << bit;
  }
}

// Step 2 for one group of columns (elements of at most 8 B a row), a
// persistent wave over tiles of the entries: each entry's record, its
// header (t's offset in its slab | mask bit c << (kDstShift + c)) and its
// packed row, grouped by destination slab and copied out, one store each.
__global__ void __launch_bounds__(kSlabThreads) gather_route_columns(const RouteArgs p) {
  extern __shared__ uint4 route_raw[];
  auto* srow = reinterpret_cast<unsigned long long*>(route_raw);
  unsigned* st = reinterpret_cast<unsigned*>(srow + kSlabTile);
  uint8_t* sbits = reinterpret_cast<uint8_t*>(st + kSlabTile);
  int* hist = reinterpret_cast<int*>(sbits + kSlabTile);
  int* warp_tot = hist + p.ndst + 1;
  for (long long t0 = (long long)blockIdx.x * kSlabTile; t0 < p.n;
       t0 += (long long)gridDim.x * kSlabTile) {
    unsigned long long e[kSlabItems], row[kSlabItems];
    int b[kSlabItems], pos[kSlabItems];
    unsigned bits[kSlabItems];
#pragma unroll
    for (int k = 0; k < kSlabItems; ++k) {
      const long long j = t0 + (long long)k * kSlabThreads + threadIdx.x;
      e[k] = j < p.n ? __ldcs(p.entries + j) : 0ull;
      b[k] = j < p.n ? (int)((unsigned)e[k] >> kDstShift) : -1;
      row[k] = 0;
      bits[k] = 0;
    }
    const int total = tile_slots<kSlabThreads, kSlabItems>(
        p.ndst, b, pos, hist, warp_tot,
        [&](int s, int c) { return (s << kDstShift) + atomicAdd(p.fill + s, c); });
    for (int c = 0; c < p.ncols; ++c) {
      const RouteColumn& col = p.col[c];
      switch (col.width) {
        case 1: load_column<uint8_t>(col, c, e, pos, row, bits); break;
        case 2: load_column<uint16_t>(col, c, e, pos, row, bits); break;
        case 4: load_column<uint32_t>(col, c, e, pos, row, bits); break;
        default: load_column<unsigned long long>(col, c, e, pos, row, bits); break;
      }
    }
#pragma unroll
    for (int k = 0; k < kSlabItems; ++k) {
      if (pos[k] < 0) continue;
      srow[pos[k]] = row[k];
      st[pos[k]] = (unsigned)e[k];
      sbits[pos[k]] = (uint8_t)bits[k];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < total; j += kSlabThreads) {
      const unsigned t = st[j];
      const long long at = hist[t >> kDstShift] + j;
      const unsigned h = (t & kDstMask) | (unsigned)sbits[j] << kDstShift;
      if (p.rec_bytes == 8) {
        static_cast<unsigned long long*>(p.rec)[at] = srow[j] << 32 | h;
      } else {
        static_cast<ulonglong2*>(p.rec)[at] = make_ulonglong2(h, srow[j]);
      }
    }
    __syncthreads();
  }
}

struct BuildColumn {
  void* out;
  uint8_t* out_mask;  // null: no output mask
  int width;
  int shift;          // bits into the packed row
  int mask_off;       // bytes into the image of its mask bytes (out_mask)
};

struct BuildArgs {
  long long n;
  int ndst;
  const void* rec;
  int rec_bytes;
  const int* fill;
  int ncols;
  unsigned masked;  // the header's mask bits of the columns with an output mask
  BuildColumn col[kMaxColumns];
};

constexpr int kBuildUnroll = 4;  // a thread's records with their loads in flight together

// The image's rows of S bytes: a record's packed row is placed whole.
template <typename S>
__device__ __forceinline__ void build_rows(const BuildArgs& p, unsigned char* img, long long r0,
                                           long long cnt, int rank) {
  auto cluster = cooperative_groups::this_cluster();
  const long long stride = (long long)kCluster * kImageThreads;
  for (long long e = (long long)rank * kImageThreads + threadIdx.x; e < cnt;
       e += kBuildUnroll * stride) {
    unsigned h[kBuildUnroll];
    unsigned long long v[kBuildUnroll];
#pragma unroll
    for (int u = 0; u < kBuildUnroll; ++u) {
      const long long at = r0 + e + u * stride;
      if (e + u * stride >= cnt) continue;
      if (sizeof(S) == 4) {
        const unsigned long long r = __ldcs(static_cast<const unsigned long long*>(p.rec) + at);
        h[u] = (unsigned)r;
        v[u] = r >> 32;
      } else {
        const ulonglong2 r = __ldcs(static_cast<const ulonglong2*>(p.rec) + at);
        h[u] = (unsigned)r.x;
        v[u] = r.y;
      }
    }
#pragma unroll
    for (int u = 0; u < kBuildUnroll; ++u) {
      if (e + u * stride >= cnt) continue;
      const unsigned off = h[u] & kDstMask;
      unsigned char* dst = cluster.map_shared_rank(img, off >> kPartShift);
      const unsigned at = off & (kPartRows - 1);
      reinterpret_cast<S*>(dst)[at] = (S)v[u];
      if (((h[u] >> kDstShift) & p.masked) == p.masked) continue;  // the mask images start valid
      for (int c = 0; c < p.ncols; ++c)
        if (p.col[c].out_mask != nullptr && !((h[u] >> (kDstShift + c)) & 1u))
          dst[p.col[c].mask_off + at] = 0;
    }
  }
}

// The image's part of block `rank` written over the output: `bytes` from
// img to out, 16 bytes a store where they fill one.
__device__ __forceinline__ void write_part(unsigned char* out, const unsigned char* img,
                                           long long bytes) {
  const long long vecs = bytes / 16;
  for (long long v = threadIdx.x; v < vecs; v += kImageThreads)
    reinterpret_cast<uint4*>(out)[v] = reinterpret_cast<const uint4*>(img)[v];
  for (long long k = vecs * 16 + threadIdx.x; k < bytes; k += kImageThreads) out[k] = img[k];
}

// A column's nb rows of the image's rows of S bytes, written out.
template <typename S, typename T>
__device__ __forceinline__ void write_column(const BuildColumn& c, const S* img, long long o,
                                             long long nb) {
  T* out = static_cast<T*>(c.out) + o;
  for (long long r = threadIdx.x; r < nb; r += kImageThreads)
    out[r] = (T)((unsigned long long)img[r] >> c.shift);
}

template <typename S>
__device__ __forceinline__ void write_columns(const BuildArgs& p, const unsigned char* img,
                                              long long o, long long nb) {
  if (p.ncols == 1 && p.col[0].width == (int)sizeof(S)) {  // the image is the column
    write_part(static_cast<unsigned char*>(p.col[0].out) + o * sizeof(S), img, nb * sizeof(S));
    return;
  }
  const S* rows = reinterpret_cast<const S*>(img);
  for (int c = 0; c < p.ncols; ++c) {
    const BuildColumn& col = p.col[c];
    switch (col.width) {
      case 1: write_column<S, uint8_t>(col, rows, o, nb); break;
      case 2: write_column<S, uint16_t>(col, rows, o, nb); break;
      case 4: write_column<S, uint32_t>(col, rows, o, nb); break;
      default: write_column<S, unsigned long long>(col, rows, o, nb); break;
    }
  }
}

// Step 3, a cluster a destination slab: its bucket's records placed into
// the image (a packed row of 4 or 8 bytes a row, then a mask byte a row of
// each masked column), then each block's part written out, a column at a
// time.
__global__ void __launch_bounds__(kImageThreads) gather_build_slab(const BuildArgs p) {
  extern __shared__ uint4 build_raw[];
  unsigned char* img = reinterpret_cast<unsigned char*>(build_raw);
  for (int c = 0; c < p.ncols; ++c) {  // the mask images start valid
    if (p.col[c].out_mask == nullptr) continue;
    uint4* m = reinterpret_cast<uint4*>(img + p.col[c].mask_off);
    for (int i = threadIdx.x; i < kPartRows / 16; i += kImageThreads)
      m[i] = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
  }
  auto cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  const long long slab = blockIdx.x / kCluster;
  const long long r0 = slab << kDstShift;
  const long long rows = bucket_rows(p.n, kDstShift, slab);
  long long cnt = p.fill[slab];
#ifdef FUGUE_DEBUG_SLABS
  if (cnt != rows) __trap();
#endif
  cnt = cnt < rows ? cnt : rows;
  if (p.rec_bytes == 8) {
    build_rows<unsigned>(p, img, r0, cnt, rank);
  } else {
    build_rows<unsigned long long>(p, img, r0, cnt, rank);
  }
  cluster.sync();
  const long long b0 = (long long)rank * kPartRows;
  const long long nb = rows - b0 < kPartRows ? rows - b0 : kPartRows;
  if (nb <= 0) return;
  if (p.rec_bytes == 8) {
    write_columns<unsigned>(p, img, r0 + b0, nb);
  } else {
    write_columns<unsigned long long>(p, img, r0 + b0, nb);
  }
  for (int c = 0; c < p.ncols; ++c)
    if (p.col[c].out_mask != nullptr)
      write_part(p.col[c].out_mask + r0 + b0, img + p.col[c].mask_off, nb);
}

// The end of the column group that starts at column g0: elements of at
// most kGroupBytes a row, and an image row (the packed elements, 4 or 8
// bytes, and a mask byte a masked column) of at most kImageRowBytes.
int group_end(int g0, int ncols, const int* width, const int* masked, int* bytes) {
  int g1 = g0, w = 0, m = 0;
  while (g1 < ncols) {
    const int w1 = w + width[g1], m1 = m + (masked[g1] != 0);
    if (w1 > kGroupBytes || (w1 > 4 ? 8 : 4) + m1 > kImageRowBytes) break;
    w = w1;
    m = m1;
    ++g1;
  }
  *bytes = w;
  return g1;
}

int source_buckets(long long src_rows) {
  return (int)slab_count(src_rows, kSrcShift) + 1;
}

}  // namespace

// K10, direct route. Column c is (data[c], out[c], mask[c] or null,
// out_mask[c] or null, width[c]); idx int32 [n]. device is the CUDA
// ordinal of the tensors, stream a cudaStream_t of it. Returns a
// cudaError_t; *launched is 1 where the kernel was launched (n > 0 and a
// column).
extern "C" int fugue_gather_rows(long long n, const void* idx, int ncols,
                                 const void* const* data, void* const* out,
                                 const void* const* mask, void* const* out_mask,
                                 const int* width, int device, void* stream, int* launched) {
  *launched = 0;
  if (ncols < 0 || ncols > kMaxColumns || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || ncols == 0) return (int)cudaSuccess;
  GatherParams p = {};
  p.n = n;
  p.idx = static_cast<const int*>(idx);
  p.ncols = ncols;
  for (int c = 0; c < ncols; ++c) {
    if (width[c] != 1 && width[c] != 2 && width[c] != 4 && width[c] != 8)
      return (int)cudaErrorInvalidValue;
    p.col[c] = {data[c], out[c], static_cast<const uint8_t*>(mask[c]),
                static_cast<uint8_t*>(out_mask[c]), width[c]};
  }
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(gather_rows, n, kThreads, device, static_cast<cudaStream_t>(stream), p);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The slab route's shapes: log2 of a source slab's and of a destination
// slab's rows, and the ints of its per-call scratch (`meta`) for n output
// rows over columns of at most src_rows rows: counts, starts and cursor
// of the source buckets, then the destination buckets' fill.
extern "C" void fugue_gather_slab_shape(long long n, long long src_rows, int* src_shift,
                                        int* dst_shift, long long* meta_ints) {
  *src_shift = kSrcShift;
  *dst_shift = kDstShift;
  const long long nb = source_buckets(src_rows);
  *meta_ints = 3 * nb + 1 + slab_count(n, kDstShift);
}

// Step 1 of the slab route: idx int32 [n] partitioned by source slab into
// entries (int64 [n], idx[t] << 32 | t); meta int32 as
// fugue_gather_slab_shape sizes it. n in [1, 2^31), src_rows in [1, 2^31).
extern "C" int fugue_gather_slab_sources(long long n, const void* idx, long long src_rows,
                                         void* meta, void* entries, int device, void* stream) {
  if (n < 1 || n >= (1LL << 31) || src_rows < 1 || src_rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  SourceArgs p = {};
  p.n = n;
  p.idx = static_cast<const int*>(idx);
  p.src_rows = src_rows;
  p.nb = source_buckets(src_rows);
  p.counts = static_cast<int*>(meta);
  p.starts = p.counts + p.nb;
  p.cursor = p.starts + p.nb + 1;
  p.entries = static_cast<unsigned long long*>(entries);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)on_device(device, [&]() -> cudaError_t {
    cudaError_t err = cudaMemsetAsync(p.counts, 0, sizeof(int) * (size_t)p.nb, st);
    if (err != cudaSuccess) return err;
    const long long tiles = (n + kSlabTile - 1) / kSlabTile;
    int grid = 0;
    const int count_smem = 4 * p.nb;
    err = allow_smem<gather_count_sources>(device, count_smem);
    if (err == cudaSuccess)
      err = wave_blocks(gather_count_sources, kSlabThreads, count_smem, tiles * kSlabItems / 4,
                        device, &grid);
    if (err != cudaSuccess) return err;
    gather_count_sources<<<grid, kSlabThreads, count_smem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gather_scan_sources<<<1, kScanThreads, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int smem = kSlabTile * 8 + 4 * (p.nb + 1 + kSlabThreads / 32);
    err = allow_smem<gather_partition_sources>(device, smem);
    if (err == cudaSuccess)
      err = wave_blocks(gather_partition_sources, kSlabThreads, smem, tiles, device, &grid);
    if (err != cudaSuccess) return err;
    gather_partition_sources<<<grid, kSlabThreads, smem, st>>>(p);
    return cudaGetLastError();
  });
}

// The bytes of a record of steps 2 and 3 for ncols (at most 8) columns of
// these widths, masked[c] non-zero where column c has an output mask: 16
// where a group's elements take more than 4 B, else 8.
extern "C" int fugue_gather_slab_record_bytes(int ncols, const int* width, const int* masked) {
  int most = 0;
  for (int g0 = 0; g0 < ncols;) {
    int bytes = 0;
    g0 = group_end(g0, ncols, width, masked, &bytes);
    most = bytes > most ? bytes : most;
  }
  return most > 4 ? 16 : 8;
}

// Steps 2 and 3 of the slab route for ncols (at most 8) columns, given as
// for fugue_gather_rows with rows[c] each column's rows: the columns in
// groups (at most kGroupBytes of elements a row, and an image row of the
// packed elements and each mask byte within kImageRowBytes: group_end),
// each routed and built. entries are step 1's; rec [n] records of
// fugue_gather_slab_record_bytes bytes and fill int32 [ceil(n /
// 2^dst_shift)] scratch (fill keeps the last group's bucket counts). out
// and out_mask 16-byte aligned.
extern "C" int fugue_gather_slab_columns(long long n, const void* entries, int ncols,
                                         const void* const* data, void* const* out,
                                         const void* const* mask, void* const* out_mask,
                                         const int* width, const long long* rows, void* rec,
                                         void* fill, int device, void* stream, int* launched) {
  *launched = 0;
  if (ncols < 0 || ncols > kMaxColumns || n < 1 || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < ncols; ++c) {
    if (width[c] != 1 && width[c] != 2 && width[c] != 4 && width[c] != 8)
      return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(out[c]) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out_mask[c]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  }
  if (ncols == 0) return (int)cudaSuccess;
  const int ndst = (int)slab_count(n, kDstShift);
  int masked[kMaxColumns];
  for (int c = 0; c < ncols; ++c) masked[c] = out_mask[c] != nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = on_device(device, [&]() -> cudaError_t {
    cudaError_t e = cudaSuccess;
    for (int g0 = 0; g0 < ncols;) {
      RouteArgs r = {};
      r.n = n;
      r.entries = static_cast<const unsigned long long*>(entries);
      r.ndst = ndst;
      r.rec = rec;
      r.fill = static_cast<int*>(fill);
      BuildArgs b = {};
      b.n = n;
      b.ndst = ndst;
      b.rec = rec;
      b.fill = r.fill;
      int bytes = 0;
      const int g1 = group_end(g0, ncols, width, masked, &bytes);
      for (int c = g0, at = 0; c < g1; at += width[c], ++c) {
        r.col[c - g0] = {data[c], static_cast<const uint8_t*>(mask[c]), rows[c], width[c],
                         masked[c], 8 * at};
        b.col[c - g0] = {out[c], static_cast<uint8_t*>(out_mask[c]), width[c], 8 * at, 0};
      }
      r.ncols = b.ncols = g1 - g0;
      r.rec_bytes = b.rec_bytes = bytes > 4 ? 16 : 8;
      int img = kPartRows * (bytes > 4 ? 8 : 4);
      for (int c = 0; c < b.ncols; ++c) {
        if (b.col[c].out_mask == nullptr) continue;
        b.col[c].mask_off = img;
        b.masked |= 1u << c;
        img += kPartRows;
      }
      e = cudaMemsetAsync(fill, 0, sizeof(int) * (size_t)ndst, st);
      if (e != cudaSuccess) return e;
      const int smem = route_smem(ndst);
      int grid = 0;
      e = allow_smem<gather_route_columns>(device, smem);
      if (e == cudaSuccess)
        e = wave_blocks(gather_route_columns, kSlabThreads, smem,
                        (n + kSlabTile - 1) / kSlabTile, device, &grid);
      if (e != cudaSuccess) return e;
      gather_route_columns<<<grid, kSlabThreads, smem, st>>>(r);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      e = allow_smem<gather_build_slab>(device, img);
      if (e != cudaSuccess) return e;
      e = launch_cluster(gather_build_slab, (long long)ndst * kCluster, kImageThreads, kCluster,
                         img, st, b);
      if (e != cudaSuccess) return e;
      g0 = g1;
    }
    return cudaSuccess;
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* fugue_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
