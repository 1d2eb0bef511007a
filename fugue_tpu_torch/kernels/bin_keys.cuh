// Key binning, shared by segment_sums.cu and factorize.cu: the device
// form of inline_seg (fugue_tpu/jax_backend/groupby.py:120), the twin of
// bin_segments in reference.py.
//
// Up to kMaxKeys key columns, each bool/uint8/int8/int16/int32/int64,
// read in its own type and widened to int64 before kmin is taken off, so
// a narrow key whose span does not fit its type bins right (the JAX
// package's inline_seg wraps there: ROADMAP.md queue 3). A key's code is
// key - kmin, or span - 1 where its null mask (bool, True = valid) is
// false; the bin is the mixed radix of the codes, the first key most
// significant. A row with any code outside [0, span) has no bin.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fugue {

constexpr int kMaxKeys = 4;

// dtype codes, as the Python wrappers pass them
constexpr int kBool = 0, kU8 = 1, kI8 = 2, kI16 = 3, kI32 = 4, kI64 = 5,
              kF32 = 6, kF64 = 7;

struct Column {
  const void* data;
  const uint8_t* mask;  // null: every row valid
  int code;
};

struct KeyBins {
  int nkeys;
  Column key[kMaxKeys];
  long long kmin[kMaxKeys];
  long long span[kMaxKeys];
};

__host__ __device__ inline int elem_size(int code) {
  switch (code) {
    case kBool: case kU8: case kI8: return 1;
    case kI16: return 2;
    case kI32: case kF32: return 4;
    default: return 8;
  }
}

// R consecutive flags from row r0. At R = 4, r0 % 4 == 0 and the column
// is 4-byte aligned.
template <int R>
__device__ __forceinline__ void load_flags(const uint8_t* p, long long r0,
                                           bool (&m)[R]) {
  if constexpr (R == 1) {
    m[0] = __ldg(p + r0) != 0;
  } else {
    const uchar4 x = __ldg(reinterpret_cast<const uchar4*>(p + r0));
    m[0] = x.x != 0; m[1] = x.y != 0; m[2] = x.z != 0; m[3] = x.w != 0;
  }
}

// R consecutive values of an integer column from row r0, widened to
// int64. At R = 4, r0 % 4 == 0 and the column is aligned to 4 elements
// (16 bytes at most).
template <int R>
__device__ __forceinline__ void load_int(const Column& col, long long r0,
                                         long long (&v)[R]) {
  const char* b = static_cast<const char*>(col.data);
  if constexpr (R == 1) {
    switch (col.code) {
      case kBool: case kU8: v[0] = __ldg(reinterpret_cast<const unsigned char*>(b) + r0); break;
      case kI8: v[0] = __ldg(reinterpret_cast<const signed char*>(b) + r0); break;
      case kI16: v[0] = __ldg(reinterpret_cast<const short*>(b) + r0); break;
      case kI32: v[0] = __ldg(reinterpret_cast<const int*>(b) + r0); break;
      default: v[0] = __ldg(reinterpret_cast<const long long*>(b) + r0); break;
    }
  } else {
    switch (col.code) {
      case kBool: case kU8: {
        const uchar4 x = __ldg(reinterpret_cast<const uchar4*>(b + r0));
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        break;
      }
      case kI8: {
        const char4 x = __ldg(reinterpret_cast<const char4*>(b + r0));
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        break;
      }
      case kI16: {
        const short4 x = __ldg(reinterpret_cast<const short4*>(b + 2 * r0));
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        break;
      }
      case kI32: {
        const int4 x = __ldg(reinterpret_cast<const int4*>(b + 4 * r0));
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        break;
      }
      default: {
        const longlong2* q = reinterpret_cast<const longlong2*>(b + 8 * r0);
        const longlong2 x = __ldg(q), y = __ldg(q + 1);
        v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
        break;
      }
    }
  }
}

// The bins of R consecutive rows from r0: bin[r] is the row's mixed-radix
// bin, and ok[r] is cleared where a code falls outside [0, span). The
// codes are checked in int64 and combined in 32 bits, which is exact for
// every row that keeps ok since the bin total is below 2^31.
template <int R>
__device__ __forceinline__ void bin_rows(const KeyBins& kb, long long r0,
                                         bool (&ok)[R],
                                         unsigned int (&bin)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) bin[r] = 0u;
#pragma unroll
  for (int k = 0; k < kMaxKeys; ++k) {
    if (k >= kb.nkeys) break;
    long long v[R];
    load_int<R>(kb.key[k], r0, v);
    bool m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = true;
    if (kb.key[k].mask != nullptr) load_flags<R>(kb.key[k].mask, r0, m);
    const long long kmin = kb.kmin[k], span = kb.span[k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long code = m[r] ? v[r] - kmin : span - 1;
      ok[r] = ok[r] && (unsigned long long)code < (unsigned long long)span;
      bin[r] = bin[r] * (unsigned int)span + (unsigned int)code;
    }
  }
}

// Fills kb from the C entry points' key arrays; false when nkeys or a
// span is out of range or the bin total reaches 2^31.
inline bool make_key_bins(int nkeys, const void* const* key_data,
                          const void* const* key_mask, const int* key_code,
                          const long long* kmin, const long long* span,
                          KeyBins* kb, long long* total) {
  if (nkeys < 1 || nkeys > kMaxKeys) return false;
  kb->nkeys = nkeys;
  long long t = 1;
  for (int k = 0; k < nkeys; ++k) {
    if (span[k] < 1) return false;
    kb->key[k] = {key_data[k], static_cast<const uint8_t*>(key_mask[k]), key_code[k]};
    kb->kmin[k] = kmin[k];
    kb->span[k] = span[k];
    t *= span[k];
    if (t >= (1LL << 31)) return false;
  }
  *total = t;
  return true;
}

}  // namespace fugue
