// Launch helpers shared by the port's kernel sources: the caller's device
// kept around a launch (all of them), and a typed launch of a kernel that
// takes its parameters as one struct (join.cu, gather.cu), alone or in
// thread-block clusters (order_scatter.cuh).

#pragma once

#include <cuda_runtime.h>

namespace fugue {

// Runs launch() with `device` current, then restores the caller's device.
template <typename F>
cudaError_t on_device(int device, F launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  err = launch();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

// Launches kernel(p) over `grid` blocks of `threads` on `stream`, and
// reports a refused launch.
template <typename P>
cudaError_t launch_params(void (*kernel)(P), long long grid, int threads, cudaStream_t stream,
                          const P& p) {
  if (grid < 1 || grid > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  void* args[] = {const_cast<P*>(&p)};
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                                           dim3((unsigned)grid), dim3(threads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches kernel(p) over `grid` blocks of `threads` with `smem` bytes of
// dynamic shared memory, in thread-block clusters of `cluster` blocks
// (1: no cluster), on `stream`, and reports a refused launch.
template <typename P>
cudaError_t launch_cluster(void (*kernel)(P), long long grid, int threads, int cluster, int smem,
                           cudaStream_t stream, const P& p) {
  if (grid < 1 || grid > 0x7FFFFFFFLL || cluster < 1 || grid % cluster != 0)
    return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One persistent wave of `kernel` (blocks of `threads`, static shared
// memory only) over `n` rows: as many blocks as the rows need, at most as
// many as the device holds at once.
template <typename P>
cudaError_t launch_wave(void (*kernel)(P), long long n, int threads, int device,
                        cudaStream_t stream, const P& p) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kernel), threads, 0);
  if (err != cudaSuccess) return err;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (n + threads - 1) / threads;
  return launch_params(kernel, need < wave ? need : wave, threads, stream, p);
}

}  // namespace fugue
