// Per-segment reductions that the fused sums kernel (segment_sums.cu)
// cannot do: K4 segment_extrema and K5 segment_sq_dev.
//
// Both replace parts of the JAX package's _segment_agg_impl
// (fugue_tpu/jax_backend/groupby.py:602-726), which XLA lowers to
// scatter programs; none of it is a Pallas kernel:
//   - K4 segment_extrema: the scatter-min/max of min and max (:647-656,
//     filled with _type_max/_type_min, :729-743) and of the row index of
//     first and last (:711-718);
//   - K5 segment_sq_dev: the second pass of the two-pass variance
//     (:676-678): the sum of (x - mean[seg])^2 in float64 per segment.
// Contracts: segment_extrema_reference and segment_sq_dev_reference in
// reference.py.
//
// Rows: rows [0, n) are read; a row counts where seg[row] lies in
// [0, num) and, with row_valid, its byte is non-zero. A payload with a
// mask (bool, True = valid) takes only the rows where its mask holds.
//
// K4 keeps one table per requested reduction: the min or the max of a
// payload as an order-preserving unsigned code (4 bytes for payloads of
// up to 32 bits, 8 for int64/float64), or the first or last counted row.
// Codes: bool/uint8 as they are; int8-32 sign-extended to 32 bits and
// int64 with the top bit flipped; a float's bits with the sign flipped
// and, for a negative float, the rest flipped too (so -0.0 < +0.0). NaN
// wins both (the JAX package's segment_min/segment_max propagate it):
// code 0 in a min table, all ones in a max table. No other value takes
// those codes, so the caller can tell NaN from an empty segment. The
// first row is its index, the last its index + 1, so that 0 means "no
// row" in a max table. The caller fills each table with its identity
// (all ones for min, 0 for max) and decodes.
//
// What bounds them on an H100: bytes (seg and the payload once: 8 bytes
// a row for one float32 payload, 0.239 ms at 100M rows) and shared-memory
// atomics (K4: one a table a row; K5: one float64 add a payload a row).
// The design: a persistent grid of one wave walks the rows, one row a
// thread per step, so each warp's loads are consecutive; each block keeps
// its own copy of the tables in shared memory (K5: the means too) while
// they fit, and merges the entries its rows touched into the global
// tables with one atomic each; above that, rows update the global tables
// directly. Integer min/max codes use the native 32- and 64-bit atomicMin
// and atomicMax, never a compare-and-swap loop; a shared float64 add has
// no instruction of its own on sm_90 and compiles to one (ATOMS.CAST.SPIN),
// like the fused kernel's float adds. K5's float64 sums depend on the order
// in which atomics land; K4 is exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bin_keys.cuh"
#include "launch.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kMaxPayloads = 8;
constexpr int kMaxTables = 2 * kMaxPayloads + 2;

struct Table {
  void* out;   // uint32 or uint64 [num], filled with the identity
  int wide;    // 8-byte codes
  int is_max;  // max table (identity 0), else min (identity all ones)
  int src;     // payload index; -1: the row index
};

struct ExtremaParams {
  long long n;
  const uint8_t* row_valid;  // null: every row of [0, n) is real
  const int* seg;
  int num;
  int np;
  Column pay[kMaxPayloads];
  int ntab;
  Table tab[kMaxTables];
  long long off[kMaxTables];  // byte offset of each table in shared memory
};

struct SqDevParams {
  long long n;
  const uint8_t* row_valid;
  const int* seg;
  int num;
  int np;
  Column pay[kMaxPayloads];  // float32/float64
  const double* mean;        // [np][num]
  double* out;               // [np][num], zeroed by the caller
};

// Whether row r counts: a segment in [0, num), and real.
__device__ __forceinline__ int row_segment(const int* seg, const uint8_t* row_valid,
                                           int num, long long r) {
  const int s = __ldg(seg + r);
  if ((unsigned)s >= (unsigned)num) return -1;
  if (row_valid != nullptr && __ldg(row_valid + r) == 0) return -1;
  return s;
}

// The order-preserving code of a payload's value at row r; *nan is set
// for a float NaN.
__device__ __forceinline__ unsigned long long ordered_code(const Column& c, long long r,
                                                           bool* nan) {
  const char* b = static_cast<const char*>(c.data);
  *nan = false;
  switch (c.code) {
    case kBool:
    case kU8:
      return __ldg(reinterpret_cast<const unsigned char*>(b) + r);
    case kI8:
      return (unsigned)(int)__ldg(reinterpret_cast<const signed char*>(b) + r) ^ 0x80000000u;
    case kI16:
      return (unsigned)(int)__ldg(reinterpret_cast<const short*>(b) + r) ^ 0x80000000u;
    case kI32:
      return (unsigned)__ldg(reinterpret_cast<const int*>(b) + r) ^ 0x80000000u;
    case kI64:
      return (unsigned long long)__ldg(reinterpret_cast<const long long*>(b) + r) ^
             0x8000000000000000ull;
    case kF32: {
      const unsigned u = __float_as_uint(__ldg(reinterpret_cast<const float*>(b) + r));
      *nan = (u & 0x7FFFFFFFu) > 0x7F800000u;
      return (u & 0x80000000u) ? (unsigned)~u : (u | 0x80000000u);
    }
    default: {
      const unsigned long long u = (unsigned long long)__double_as_longlong(
          __ldg(reinterpret_cast<const double*>(b) + r));
      *nan = (u & 0x7FFFFFFFFFFFFFFFull) > 0x7FF0000000000000ull;
      return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
    }
  }
}

__device__ __forceinline__ void table_update(const Table& t, void* base, int s,
                                             unsigned long long code) {
  if (t.wide) {
    unsigned long long* a = static_cast<unsigned long long*>(base) + s;
    if (t.is_max) atomicMax(a, code);
    else atomicMin(a, code);
  } else {
    unsigned* a = static_cast<unsigned*>(base) + s;
    if (t.is_max) atomicMax(a, (unsigned)code);
    else atomicMin(a, (unsigned)code);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    segment_extrema(const __grid_constant__ ExtremaParams p) {
  extern __shared__ unsigned long long smem[];
  char* sbase = reinterpret_cast<char*>(smem);
  if constexpr (kShared) {
    for (int t = 0; t < p.ntab; ++t) {
      const Table& tb = p.tab[t];
      if (tb.wide) {
        unsigned long long* a = reinterpret_cast<unsigned long long*>(sbase + p.off[t]);
        const unsigned long long id = tb.is_max ? 0ull : ~0ull;
        for (int s = threadIdx.x; s < p.num; s += kThreads) a[s] = id;
      } else {
        unsigned* a = reinterpret_cast<unsigned*>(sbase + p.off[t]);
        const unsigned id = tb.is_max ? 0u : ~0u;
        for (int s = threadIdx.x; s < p.num; s += kThreads) a[s] = id;
      }
    }
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < p.n; r += stride) {
    const int s = row_segment(p.seg, p.row_valid, p.num, r);
    if (s < 0) continue;
    for (int t = 0; t < p.ntab; ++t) {
      const Table& tb = p.tab[t];
      unsigned long long code;
      if (tb.src < 0) {
        code = tb.is_max ? (unsigned long long)(r + 1) : (unsigned long long)r;
      } else {
        const Column& c = p.pay[tb.src];
        if (c.mask != nullptr && __ldg(c.mask + r) == 0) continue;
        bool nan;
        code = ordered_code(c, r, &nan);
        if (nan) code = tb.is_max ? (tb.wide ? ~0ull : 0xFFFFFFFFull) : 0ull;
      }
      table_update(tb, kShared ? static_cast<void*>(sbase + p.off[t]) : tb.out, s, code);
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int t = 0; t < p.ntab; ++t) {
      const Table& tb = p.tab[t];
      if (tb.wide) {
        const unsigned long long* a =
            reinterpret_cast<const unsigned long long*>(sbase + p.off[t]);
        const unsigned long long id = tb.is_max ? 0ull : ~0ull;
        for (int s = threadIdx.x; s < p.num; s += kThreads)
          if (a[s] != id) table_update(tb, tb.out, s, a[s]);
      } else {
        const unsigned* a = reinterpret_cast<const unsigned*>(sbase + p.off[t]);
        const unsigned id = tb.is_max ? 0u : ~0u;
        for (int s = threadIdx.x; s < p.num; s += kThreads)
          if (a[s] != id) table_update(tb, tb.out, s, a[s]);
      }
    }
  }
}

__device__ __forceinline__ double load_double(const Column& c, long long r) {
  return c.code == kF32 ? (double)__ldg(static_cast<const float*>(c.data) + r)
                        : __ldg(static_cast<const double*>(c.data) + r);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    segment_sq_dev(const __grid_constant__ SqDevParams p) {
  // shared: [np * num means][np * num sums]
  extern __shared__ double dsmem[];
  const long long tab = (long long)p.np * p.num;
  const double* mean = p.mean;
  double* acc = p.out;
  if constexpr (kShared) {
    for (long long i = threadIdx.x; i < tab; i += kThreads) {
      dsmem[i] = __ldg(p.mean + i);
      dsmem[tab + i] = 0.0;
    }
    __syncthreads();
    mean = dsmem;
    acc = dsmem + tab;
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < p.n; r += stride) {
    const int s = row_segment(p.seg, p.row_valid, p.num, r);
    if (s < 0) continue;
    for (int q = 0; q < p.np; ++q) {
      const Column& c = p.pay[q];
      if (c.mask != nullptr && __ldg(c.mask + r) == 0) continue;
      const long long i = (long long)q * p.num + s;
      double m;
      if constexpr (kShared) m = mean[i];
      else m = __ldg(mean + i);
      const double d = load_double(c, r) - m;
      atomicAdd(acc + i, d * d);
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (long long i = threadIdx.x; i < tab; i += kThreads) {
      const double v = acc[i];
      if (v != 0.0) atomicAdd(p.out + i, v);
    }
  }
}

// Launches fn over n rows with smem bytes of dynamic shared memory (the
// shared path, when it fits the device's opt-in limit) or none (the
// global path), as one persistent wave. *path: 1 shared, 2 global.
cudaError_t launch_rows(const void* shared_fn, const void* global_fn, long long n,
                        size_t smem, void* params, int device, cudaStream_t stream,
                        int* path) {
  int sms = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const bool shared = smem <= (size_t)optin;
  const void* fn = shared ? shared_fn : global_fn;
  const size_t bytes = shared ? smem : 0;
  if (bytes > 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, bytes);
  if (err != cudaSuccess) return err;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (n + kThreads - 1) / kThreads;
  const int grid = (int)(need < wave ? need : wave);
  void* args[] = {params};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  *path = shared ? 1 : 2;
  return cudaGetLastError();
}

}  // namespace

// K4. Payload q is (data[q], mask[q] or null, code[q]) with the dtype
// codes of bin_keys.cuh; table t writes outs[t] (uint32 [num], or uint64
// where wide[t]), a max table where is_max[t], over payload src[t] or,
// where src[t] is -1, the row index. The caller fills each table with its
// identity. device is the CUDA ordinal of the tensors, stream a
// cudaStream_t of it. Returns a cudaError_t; *path is 1 (shared-memory
// tables), 2 (global tables) or 0 (nothing launched: no row or no table).
extern "C" int fugue_segment_extrema(long long n, const void* row_valid, const void* seg,
                                     int num, int np, const void* const* data,
                                     const void* const* mask, const int* code, int ntab,
                                     void* const* outs, const int* wide, const int* is_max,
                                     const int* src, int device, void* stream, int* path) {
  *path = 0;
  if (np < 0 || np > kMaxPayloads || ntab < 0 || ntab > kMaxTables || num < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || ntab == 0) return (int)cudaSuccess;
  ExtremaParams p = {};
  p.n = n;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  p.seg = static_cast<const int*>(seg);
  p.num = num;
  p.np = np;
  for (int q = 0; q < np; ++q)
    p.pay[q] = {data[q], static_cast<const uint8_t*>(mask[q]), code[q]};
  p.ntab = ntab;
  long long bytes = 0;
  for (int t = 0; t < ntab; ++t) {
    if (src[t] < -1 || src[t] >= np) return (int)cudaErrorInvalidValue;
    p.tab[t] = {outs[t], wide[t], is_max[t], src[t]};
    p.off[t] = bytes;
    bytes += ((long long)num * (wide[t] ? 8 : 4) + 7) / 8 * 8;
  }
  return (int)on_device(device, [&] {
    return launch_rows(reinterpret_cast<const void*>(segment_extrema<true>),
                       reinterpret_cast<const void*>(segment_extrema<false>), n,
                       (size_t)bytes, &p, device, static_cast<cudaStream_t>(stream), path);
  });
}

// K5. Payload q is (data[q], mask[q] or null, code[q]), float32 or
// float64; mean and out are float64 [np][num], out zeroed by the caller.
// Returns a cudaError_t; *path as for fugue_segment_extrema.
extern "C" int fugue_segment_sq_dev(long long n, const void* row_valid, const void* seg,
                                    int num, int np, const void* const* data,
                                    const void* const* mask, const int* code,
                                    const void* mean, void* out, int device, void* stream,
                                    int* path) {
  *path = 0;
  if (np < 0 || np > kMaxPayloads || num < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0 || np == 0) return (int)cudaSuccess;
  SqDevParams p = {};
  p.n = n;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  p.seg = static_cast<const int*>(seg);
  p.num = num;
  p.np = np;
  for (int q = 0; q < np; ++q) {
    if (code[q] != kF32 && code[q] != kF64) return (int)cudaErrorInvalidValue;
    p.pay[q] = {data[q], static_cast<const uint8_t*>(mask[q]), code[q]};
  }
  p.mean = static_cast<const double*>(mean);
  p.out = static_cast<double*>(out);
  const size_t bytes = (size_t)2 * np * num * sizeof(double);
  return (int)on_device(device, [&] {
    return launch_rows(reinterpret_cast<const void*>(segment_sq_dev<true>),
                       reinterpret_cast<const void*>(segment_sq_dev<false>), n, bytes, &p,
                       device, static_cast<cudaStream_t>(stream), path);
  });
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* fugue_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
