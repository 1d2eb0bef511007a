// K10 gather_rows: every column of one join side gathered by one index
// vector, in one launch.
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
// written once plus 4 B of index a row. One output row a thread a step
// over a persistent wave: the index is read once for every column, each
// column's stores coalesce across the warp, and its loads are as random
// as the index.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

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

}  // namespace

// K10. Column c is (data[c], out[c], mask[c] or null, out_mask[c] or
// null, width[c]); idx int32 [n]. device is the CUDA ordinal of the
// tensors, stream a cudaStream_t of it. Returns a cudaError_t; *launched
// is 1 where the kernel was launched (n > 0 and a column).
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

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* fugue_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
