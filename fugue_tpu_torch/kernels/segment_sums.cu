// Packed per-segment sums: the group-by's per-row reduction.
//
// Replaces the JAX package's segment reduction groupby.segment_sums /
// _packed_scatter_sums (fugue_tpu/jax_backend/groupby.py:219, :291), which
// runs inside _binned_packed_aggregate (jax_backend/execution_engine.py:3463).
// That one is an XLA-lowered jnp program, not a Pallas kernel.
//
// Contract (the same as segment_sums_reference in reference.py):
//   seg    int32[n]      segment id per row; a row with seg < 0 or
//                        seg >= total contributes nothing
//   fpack  F[nf][n]      float payloads, summed in F (float or double)
//   cpack  uint8[nc][n]  count payloads (bool, or uint8 read as a flag):
//                        the rows whose byte is non-zero are counted
//                        exactly in int32
//   ipack  int64[ni][n]  integer payloads, summed exactly in int64
//   fout F[nf][total], cout int32[nc][total], iout int64[ni][total]: zeroed
//   by the caller; the kernel adds into them.
//
// What bounds it on an H100: bytes. Each row is read once (4 bytes of seg
// plus each payload) and does one add per payload, far below the card's
// operation rate. Design: a grid-stride loop over rows; each block keeps
// a private accumulator for every (payload, segment) in shared memory,
// adds with shared-memory atomics, and flushes its non-zero partials to
// global memory with one atomicAdd each. When the accumulator does not
// fit in a block's shared memory, rows add straight into global memory.
// Float sums depend on the order in which atomics land, so they are not
// bitwise reproducible from run to run; integer sums are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename F>
__device__ __forceinline__ void add_row(
    long long r, int s, long long n, int total,
    const F* __restrict__ fpack, int nf,
    const uint8_t* __restrict__ cpack, int nc,
    const long long* __restrict__ ipack, int ni,
    F* facc, int* cacc, unsigned long long* iacc) {
  for (int p = 0; p < nf; ++p) {
    atomicAdd(&facc[(size_t)p * total + s], fpack[(size_t)p * n + r]);
  }
  for (int p = 0; p < nc; ++p) {
    // a constant increment, not the byte's value: it measured faster on
    // an H100 (PERF.md, Findings)
    if (cpack[(size_t)p * n + r]) atomicAdd(&cacc[(size_t)p * total + s], 1);
  }
  for (int p = 0; p < ni; ++p) {
    const long long v = ipack[(size_t)p * n + r];
    // two's-complement wrap-around makes the unsigned add an exact
    // signed int64 sum
    if (v != 0) {
      atomicAdd(&iacc[(size_t)p * total + s], (unsigned long long)v);
    }
  }
}

template <typename F>
__global__ void __launch_bounds__(kThreads) segment_sums_shared(
    const int* __restrict__ seg, long long n, int total,
    const F* __restrict__ fpack, int nf,
    const uint8_t* __restrict__ cpack, int nc,
    const long long* __restrict__ ipack, int ni,
    F* __restrict__ fout, int* __restrict__ cout,
    unsigned long long* __restrict__ iout) {
  // [ni*total int64][nf*total F][nc*total int32]: 8-byte members first
  extern __shared__ unsigned long long smem_raw[];
  unsigned long long* s_i = smem_raw;
  F* s_f = reinterpret_cast<F*>(s_i + (size_t)ni * total);
  int* s_c = reinterpret_cast<int*>(s_f + (size_t)nf * total);
  const int nfi = nf * total, nci = nc * total, nii = ni * total;
  for (int i = threadIdx.x; i < nii; i += blockDim.x) s_i[i] = 0ull;
  for (int i = threadIdx.x; i < nfi; i += blockDim.x) s_f[i] = F(0);
  for (int i = threadIdx.x; i < nci; i += blockDim.x) s_c[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int s = seg[r];
    if (s < 0 || s >= total) continue;
    add_row<F>(r, s, n, total, fpack, nf, cpack, nc, ipack, ni, s_f, s_c, s_i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nfi; i += blockDim.x) {
    const F v = s_f[i];
    if (v != F(0)) atomicAdd(&fout[i], v);
  }
  for (int i = threadIdx.x; i < nci; i += blockDim.x) {
    const int v = s_c[i];
    if (v != 0) atomicAdd(&cout[i], v);
  }
  for (int i = threadIdx.x; i < nii; i += blockDim.x) {
    const unsigned long long v = s_i[i];
    if (v != 0ull) atomicAdd(&iout[i], v);
  }
}

template <typename F>
__global__ void __launch_bounds__(kThreads) segment_sums_global(
    const int* __restrict__ seg, long long n, int total,
    const F* __restrict__ fpack, int nf,
    const uint8_t* __restrict__ cpack, int nc,
    const long long* __restrict__ ipack, int ni,
    F* __restrict__ fout, int* __restrict__ cout,
    unsigned long long* __restrict__ iout) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int s = seg[r];
    if (s < 0 || s >= total) continue;
    add_row<F>(r, s, n, total, fpack, nf, cpack, nc, ipack, ni, fout, cout, iout);
  }
}

template <typename F>
cudaError_t launch(const int* seg, long long n, int total, const F* fpack,
                   int nf, const uint8_t* cpack, int nc, const long long* ipack,
                   int ni, F* fout, int* cout, unsigned long long* iout,
                   int dev, cudaStream_t stream, int* path) {
  *path = 0;
  if (n <= 0 || total <= 0 || nf + nc + ni == 0) return cudaSuccess;
  int sms = 0, smem_optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)total * ((size_t)ni * sizeof(long long) +
                                       (size_t)nf * sizeof(F) +
                                       (size_t)nc * sizeof(int));
  const long long row_blocks = (n + kThreads - 1) / kThreads;
  if (smem <= (size_t)smem_optin) {
    // above 48 KB a block must opt in to its dynamic shared memory
    err = cudaFuncSetAttribute(segment_sums_shared<F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_sums_shared<F>, kThreads, smem);
    if (err != cudaSuccess) return err;
    const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const int grid = (int)(row_blocks < cap ? row_blocks : cap);
    segment_sums_shared<F><<<grid, kThreads, smem, stream>>>(
        seg, n, total, fpack, nf, cpack, nc, ipack, ni, fout, cout, iout);
    *path = 1;
  } else {
    const long long cap = (long long)sms * 16;
    const int grid = (int)(row_blocks < cap ? row_blocks : cap);
    segment_sums_global<F><<<grid, kThreads, 0, stream>>>(
        seg, n, total, fpack, nf, cpack, nc, ipack, ni, fout, cout, iout);
    *path = 2;
  }
  return cudaGetLastError();
}

}  // namespace

// The plain C entry point bound with ctypes. Returns a cudaError_t: 0 when
// the launch was accepted. f64 selects double float payloads (else float);
// device is the CUDA ordinal the tensors live on, stream a cudaStream_t of
// that device. The launch makes device current and then restores the
// caller's current device, so the caller's CUDA state is left as it was.
// *path is set to 0 (nothing to sum, no launch), 1 (shared-memory
// accumulators) or 2 (global atomics).
extern "C" int fugue_segment_sums(const void* seg, long long n, int total,
                                  const void* fpack, int nf, int f64,
                                  const void* cpack, int nc, const void* ipack,
                                  int ni, void* fout, void* cout, void* iout,
                                  int device, void* stream, int* path) {
  const int* s = static_cast<const int*>(seg);
  const uint8_t* c = static_cast<const uint8_t*>(cpack);
  const long long* ip = static_cast<const long long*>(ipack);
  int* co = static_cast<int*>(cout);
  unsigned long long* io = static_cast<unsigned long long*>(iout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *path = 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  if (f64) {
    err = launch<double>(s, n, total, static_cast<const double*>(fpack), nf, c,
                         nc, ip, ni, static_cast<double*>(fout), co, io, device,
                         st, path);
  } else {
    err = launch<float>(s, n, total, static_cast<const float*>(fpack), nf, c,
                        nc, ip, ni, static_cast<float*>(fout), co, io, device,
                        st, path);
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* fugue_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
