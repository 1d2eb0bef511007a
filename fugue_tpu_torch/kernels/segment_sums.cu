// Fused binned aggregate: segment ids, row validity and per-segment sums
// in one pass over the key and value columns.
//
// Replaces the per-row part of the JAX package's binned group-by program,
// _prog in _binned_packed_aggregate (fugue_tpu/jax_backend/
// execution_engine.py:3500-3574): materialize_validity and inline_seg
// (jax_backend/groupby.py:40, :120), the payload masking, and
// segment_sums / _packed_scatter_sums (groupby.py:219, :291). XLA fuses
// that program into one pass; this kernel is that pass. None of it is a
// Pallas kernel.
//
// Contract (the same as binned_sums_reference in reference.py):
//   keys      1-4 columns, each bool/uint8/int8/int16/int32/int64, read in
//             its own type, with an optional null mask (bool, True =
//             valid), kmin and span (the null bucket included where
//             masked). A key's code is key - kmin in int64, span - 1 where
//             the key is null; the segment id is the mixed radix of the
//             codes, the first key most significant. A row with any code
//             outside [0, span) is dropped.
//   rows      rows [0, n) are read. With row_valid, only the rows whose
//             byte is non-zero count (a masked frame); without it every
//             row counts (a prefix frame passes n = nrows, so its padding
//             is never read).
//   payloads  nf float columns (float32/float64, optional mask) summed in
//             F; nc count flags (bool/uint8: the rows whose byte is
//             non-zero are counted); ni integer columns (any key type,
//             optional mask) summed exactly in int64. A masked payload
//             adds only the rows where its mask holds. With occupancy,
//             count row 0 counts every accepted row and the flags fill
//             rows 1..nc.
//   outputs   fout F[nf][total], cout int32[occupancy + nc][total], iout
//             int64[ni][total], zeroed by the caller; the kernel adds into
//             them, allocates nothing and runs on the caller's stream.
//
// What bounds it on an H100: bytes (each row's keys and payloads are read
// once: 8 bytes a row for the headline's int32 key and float32 value) and
// shared-memory atomics (two a row there, into ~1024 bins). The design:
//   - a persistent grid of one wave (SMs x resident blocks);
//   - each thread takes tiles of R consecutive rows, one 4-32 byte load
//     per column and tile (16 bytes for a 4-byte column at R = 4), U tiles
//     in flight per loop iteration, and a scalar tail for the ragged end;
//     a column that is not aligned to its tile selects R = 1;
//   - segment ids and validity live in registers only; the key binning
//     is bin_keys.cuh's, shared with factorize.cu;
//   - each block sums into replicas of its [payload][segment] accumulators
//     in shared memory, one per warp or per group of warps, so that fewer
//     lanes contend for one address; the block merges its replicas and
//     adds each non-zero partial to global memory with one atomic;
//   - when one replica does not fit in shared memory, rows add straight
//     into global memory.
// Counts add the constant 1, which compiles to the warp-aggregating
// ATOMS.POPC.INC; a shared float or int64 add has no instruction of its
// own on sm_90 and compiles to a compare-and-swap loop (ATOMS.CAST.SPIN).
// Float sums depend on the order in which atomics land, so they are not
// bitwise reproducible; counts and integer sums are exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>
#include <vector>

#include "bin_keys.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPayloads = 8;  // of each kind, per launch
// Defaults from the variant sweep at the headline shape (PERF.md, PR 2):
// as many replicas as fit in 16 KB of shared memory per block (two at one
// float payload and 1024 segments; more cost resident blocks and time,
// but a shape whose rows crowd few segments wants many, and gets them
// since its replicas are small); one 4-row tile per thread per iteration
// (more cost registers and resident blocks). A 1-tile kernel has its
// registers capped so that all of an SM's 2048 threads are resident.
constexpr long long kReplicaBudget = 16 * 1024;
constexpr int kDefaultUnroll = 1;
constexpr int kTightBlocks = 2048 / kThreads;

struct Params {
  long long n;
  const uint8_t* row_valid;  // null: every row in [0, n) is real
  KeyBins keys;
  int total;
  int nf, nc, ni, occupancy;
  Column f[kMaxPayloads];
  const uint8_t* c[kMaxPayloads];
  Column i[kMaxPayloads];
  void* fout;
  int* cout;
  unsigned long long* iout;
  int nrep;             // shared-memory replicas per block
  long long rep_words;  // one replica, in 8-byte words
};

// R consecutive values of a float column from row r0, in F.
template <int R, typename F>
__device__ __forceinline__ void load_float(const Column& col, long long r0,
                                           F (&v)[R]) {
  const char* b = static_cast<const char*>(col.data);
  if constexpr (R == 1) {
    v[0] = col.code == kF32 ? F(__ldg(reinterpret_cast<const float*>(b) + r0))
                            : F(__ldg(reinterpret_cast<const double*>(b) + r0));
  } else if (col.code == kF32) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(b + 4 * r0));
    v[0] = F(x.x); v[1] = F(x.y); v[2] = F(x.z); v[3] = F(x.w);
  } else {
    const double2* q = reinterpret_cast<const double2*>(b + 8 * r0);
    const double2 x = __ldg(q), y = __ldg(q + 1);
    v[0] = F(x.x); v[1] = F(x.y); v[2] = F(y.x); v[3] = F(y.y);
  }
}

// Each row's segment id, or -1 for a row that is dropped: outside the
// scanned tiles, not valid, or with a key code outside [0, span).
template <int R>
__device__ __forceinline__ void tile_segments(const Params& p, bool in,
                                              long long r0, int (&seg)[R]) {
  bool ok[R];
  unsigned int bin[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ok[r] = in;
    bin[r] = 0u;
  }
  if (in) {
    if (p.row_valid != nullptr) {
      bool m[R];
      load_flags<R>(p.row_valid, r0, m);
#pragma unroll
      for (int r = 0; r < R; ++r) ok[r] = ok[r] && m[r];
    }
    bin_rows<R>(p.keys, r0, ok, bin);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) seg[r] = ok[r] ? (int)bin[r] : -1;
}

// Adds the rows of tiles tile, tile + stride, ... (< ntiles) into the
// accumulators; tile t holds rows first + t*R .. first + t*R + R - 1.
// The U tiles of one iteration are kThreads apart, so each of a warp's
// loads covers consecutive memory.
template <typename F, int R, int U>
__device__ __forceinline__ void scan(const Params& p, long long first,
                                     long long ntiles, long long tile,
                                     long long stride, F* facc, int* cacc,
                                     unsigned long long* iacc) {
  const int total = p.total;
  for (long long t0 = tile; t0 < ntiles; t0 += stride) {
    int seg[U][R];
    F v0[U][R];
    bool m0[U][R];
    // the first float payload's loads are issued with the keys', so both
    // are in flight together
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = t0 + (long long)u * kThreads;
      const bool in = t < ntiles;
      const long long r0 = first + t * R;
#pragma unroll
      for (int r = 0; r < R; ++r) m0[u][r] = true;
      if (in && p.nf > 0) {
        load_float<R, F>(p.f[0], r0, v0[u]);
        if (p.f[0].mask != nullptr) load_flags<R>(p.f[0].mask, r0, m0[u]);
      }
      tile_segments<R>(p, in, r0, seg[u]);
    }
    if (p.occupancy) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (seg[u][r] >= 0) atomicAdd(&cacc[seg[u][r]], 1);
    }
    if (p.nf > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (seg[u][r] >= 0 && m0[u][r]) atomicAdd(&facc[seg[u][r]], v0[u][r]);
    }
    for (int q = 1; q < p.nf; ++q) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long t = t0 + (long long)u * kThreads;
        if (t >= ntiles) break;
        const long long r0 = first + t * R;
        F v[R];
        bool m[R];
        load_float<R, F>(p.f[q], r0, v);
#pragma unroll
        for (int r = 0; r < R; ++r) m[r] = true;
        if (p.f[q].mask != nullptr) load_flags<R>(p.f[q].mask, r0, m);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (seg[u][r] >= 0 && m[r])
            atomicAdd(&facc[(size_t)q * total + seg[u][r]], v[r]);
      }
    }
    for (int q = 0; q < p.nc; ++q) {
      int* acc = cacc + (size_t)(p.occupancy + q) * total;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long t = t0 + (long long)u * kThreads;
        if (t >= ntiles) break;
        bool m[R];
        load_flags<R>(p.c[q], first + t * R, m);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (seg[u][r] >= 0 && m[r]) atomicAdd(&acc[seg[u][r]], 1);
      }
    }
    for (int q = 0; q < p.ni; ++q) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long t = t0 + (long long)u * kThreads;
        if (t >= ntiles) break;
        const long long r0 = first + t * R;
        long long v[R];
        bool m[R];
        load_int<R>(p.i[q], r0, v);
#pragma unroll
        for (int r = 0; r < R; ++r) m[r] = true;
        if (p.i[q].mask != nullptr) load_flags<R>(p.i[q].mask, r0, m);
        // two's-complement wrap-around makes the unsigned add an exact
        // signed int64 sum
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (seg[u][r] >= 0 && m[r] && v[r] != 0)
            atomicAdd(&iacc[(size_t)q * total + seg[u][r]],
                      (unsigned long long)v[r]);
      }
    }
  }
}

// A 1-tile kernel caps its registers so that kTightBlocks blocks fit on
// an SM; with more tiles in flight the cap would spill.
template <typename F, int R, int U, bool kShared>
__global__ void __launch_bounds__(kThreads, U == 1 ? kTightBlocks : 1)
    binned_sums(const __grid_constant__ Params p) {
  // per replica: [ni*total int64][nf*total F][(occupancy+nc)*total int32]
  extern __shared__ unsigned long long smem[];
  const long long nis = (long long)p.ni * p.total;
  const long long nfs = (long long)p.nf * p.total;
  const long long ncs = (long long)(p.occupancy + p.nc) * p.total;
  F* facc;
  int* cacc;
  unsigned long long* iacc;
  if constexpr (kShared) {
    for (long long w = threadIdx.x; w < p.nrep * p.rep_words; w += kThreads)
      smem[w] = 0ull;
    __syncthreads();
    unsigned long long* rep = smem + (threadIdx.x / 32 % p.nrep) * p.rep_words;
    iacc = rep;
    facc = reinterpret_cast<F*>(rep + nis);
    cacc = reinterpret_cast<int*>(facc + nfs);
  } else {
    facc = static_cast<F*>(p.fout);
    cacc = p.cout;
    iacc = p.iout;
  }
  const long long ntiles = p.n / R;
  scan<F, R, U>(p, 0, ntiles,
                (long long)blockIdx.x * kThreads * U + threadIdx.x,
                (long long)gridDim.x * kThreads * U, facc, cacc, iacc);
  if (R > 1) {  // the ragged end, row by row
    const long long done = ntiles * R;
    scan<F, 1, 1>(p, done, p.n - done,
                  (long long)blockIdx.x * kThreads + threadIdx.x,
                  (long long)gridDim.x * kThreads, facc, cacc, iacc);
  }
  if constexpr (kShared) {
    __syncthreads();
    for (long long s = threadIdx.x; s < nis; s += kThreads) {
      unsigned long long v = 0ull;
      for (int r = 0; r < p.nrep; ++r) v += smem[r * p.rep_words + s];
      if (v != 0ull) atomicAdd(&p.iout[s], v);
    }
    for (long long s = threadIdx.x; s < nfs; s += kThreads) {
      F v = F(0);
      for (int r = 0; r < p.nrep; ++r)
        v += reinterpret_cast<const F*>(smem + r * p.rep_words + nis)[s];
      if (v != F(0)) atomicAdd(&static_cast<F*>(p.fout)[s], v);
    }
    for (long long s = threadIdx.x; s < ncs; s += kThreads) {
      int v = 0;
      for (int r = 0; r < p.nrep; ++r)
        v += reinterpret_cast<const int*>(
            reinterpret_cast<const F*>(smem + r * p.rep_words + nis) + nfs)[s];
      if (v != 0) atomicAdd(&p.cout[s], v);
    }
  }
}

template <typename F, bool kShared, int R>
const void* kernel_for_tile(int U) {
  if (U == 1) return reinterpret_cast<const void*>(binned_sums<F, R, 1, kShared>);
  if (U == 2) return reinterpret_cast<const void*>(binned_sums<F, R, 2, kShared>);
  return reinterpret_cast<const void*>(binned_sums<F, R, 4, kShared>);
}

template <typename F, bool kShared>
const void* kernel_for(int R, int U) {
  return R == 4 ? kernel_for_tile<F, kShared, 4>(U) : kernel_for_tile<F, kShared, 1>(U);
}

bool aligned(const void* ptr, int code) {
  const int es = elem_size(code);
  const uintptr_t a = (uintptr_t)(4 * es < 16 ? 4 * es : 16);
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % a == 0;
}

// Whether every column allows 4-row tiles.
bool all_aligned(const Params& p) {
  bool ok = aligned(p.row_valid, kU8);
  for (int k = 0; k < p.keys.nkeys; ++k)
    ok = ok && aligned(p.keys.key[k].data, p.keys.key[k].code) &&
         aligned(p.keys.key[k].mask, kU8);
  for (int q = 0; q < p.nf; ++q)
    ok = ok && aligned(p.f[q].data, p.f[q].code) && aligned(p.f[q].mask, kU8);
  for (int q = 0; q < p.nc; ++q) ok = ok && aligned(p.c[q], kU8);
  for (int q = 0; q < p.ni; ++q)
    ok = ok && aligned(p.i[q].data, p.i[q].code) && aligned(p.i[q].mask, kU8);
  return ok;
}

// What a launch asks the runtime is fixed per device, and per kernel
// instance and shared-memory size, so it is asked once and kept.
struct DeviceInfo {
  int sms = 0, smem_optin = 0;
};

// the largest dynamic shared memory a kernel instance was opted in to
struct OptIn {
  int dev;
  const void* fn;
  size_t smem;
};

// how many blocks of a kernel instance fit on an SM at smem bytes each
struct Occupancy {
  int dev;
  const void* fn;
  size_t smem;
  int per_sm;
};

std::mutex cache_lock;
std::unordered_map<int, DeviceInfo> devices;
std::vector<OptIn> optins;
std::vector<Occupancy> occupancies;

cudaError_t device_info(int dev, DeviceInfo* out) {
  std::lock_guard<std::mutex> g(cache_lock);
  auto it = devices.find(dev);
  if (it == devices.end()) {
    DeviceInfo d;
    cudaError_t err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    it = devices.emplace(dev, d).first;
  }
  *out = it->second;
  return cudaSuccess;
}

// Opts fn in to smem bytes of dynamic shared memory (a block must, above
// 48 KB) and gives how many of its blocks fit on one SM.
cudaError_t instance_info(int dev, const void* fn, size_t smem, int* per_sm) {
  std::lock_guard<std::mutex> g(cache_lock);
  OptIn* optin = nullptr;
  for (OptIn& e : optins)
    if (e.dev == dev && e.fn == fn) optin = &e;
  if (smem > 0 && (optin == nullptr || optin->smem < smem)) {
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (optin == nullptr) optins.push_back({dev, fn, smem});
    else optin->smem = smem;
  }
  for (const Occupancy& e : occupancies) {
    if (e.dev == dev && e.fn == fn && e.smem == smem) {
      *per_sm = e.per_sm;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  occupancies.push_back({dev, fn, smem, *per_sm});
  return cudaSuccess;
}

// info: [path (0 none, 1 shared, 2 global), rows per tile, tiles per
// iteration, replicas, grid]
template <typename F>
cudaError_t launch(Params& p, int vec, int unroll, int replicas, int dev,
                   cudaStream_t stream, int* info) {
  if (p.n <= 0 || p.nf + p.nc + p.ni + p.occupancy == 0) return cudaSuccess;
  DeviceInfo d;
  cudaError_t err = device_info(dev, &d);
  if (err != cudaSuccess) return err;
  const long long smem_optin = d.smem_optin;
  const int R = (vec == 1 || !all_aligned(p)) ? 1 : 4;
  const int U = unroll == 1 || unroll == 2 || unroll == 4 ? unroll : kDefaultUnroll;
  const long long rep_bytes =
      (long long)p.total * (8LL * p.ni + (long long)sizeof(F) * p.nf +
                            4LL * (p.occupancy + p.nc));
  p.rep_words = (rep_bytes + 7) / 8;
  const bool shared = p.rep_words * 8 <= smem_optin;
  size_t smem = 0;
  const void* fn;
  if (shared) {
    const int fit = (int)(smem_optin / (p.rep_words * 8));
    int nrep = replicas > 0 ? replicas
                            : (int)(kReplicaBudget / (p.rep_words * 8));
    nrep = nrep < 1 ? 1 : nrep;
    nrep = nrep < kWarps ? nrep : kWarps;
    p.nrep = nrep < fit ? nrep : fit;
    smem = (size_t)p.nrep * p.rep_words * 8;
    fn = kernel_for<F, true>(R, U);
  } else {
    p.nrep = 0;
    fn = kernel_for<F, false>(R, U);
  }
  int per_sm = 0;
  err = instance_info(dev, fn, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const long long wave = (long long)d.sms * (per_sm > 0 ? per_sm : 1);
  const long long rows_per_block = (long long)kThreads * U * R;
  const long long need = (p.n + rows_per_block - 1) / rows_per_block;
  const int grid = (int)(need < wave ? need : wave);
  void* args[] = {&p};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  info[0] = shared ? 1 : 2;
  info[1] = R;
  info[2] = U;
  info[3] = p.nrep;
  info[4] = grid;
  return cudaGetLastError();
}

}  // namespace

// The plain C entry point bound with ctypes. Returns a cudaError_t: 0 when
// the launch was accepted (or there was nothing to launch). Column i of a
// kind is (data[i], mask[i] or null, code[i]) with the dtype codes above;
// f64 selects double accumulation of the float payloads (else float).
// vec (1 or 4), unroll (1, 2 or 4) and replicas (1-8) pick a variant; 0
// takes the default: 4-row tiles where every column is aligned, 1 tile
// per iteration, as many replicas as fit in 16 KB. device is the CUDA
// ordinal the tensors live on, stream a cudaStream_t of that device; the
// launch makes device current and then restores the caller's current
// device. info receives [path (0 nothing launched, 1 shared-memory
// replicas, 2 global atomics), rows per tile, tiles per iteration,
// replicas, grid].
extern "C" int fugue_binned_sums(
    long long n, const void* row_valid, int nkeys,
    const void* const* key_data, const void* const* key_mask,
    const int* key_code, const long long* kmin, const long long* span,
    int nf, const void* const* f_data, const void* const* f_mask,
    const int* f_code, int f64, int nc, const void* const* c_flags, int ni,
    const void* const* i_data, const void* const* i_mask, const int* i_code,
    int occupancy, void* fout, void* cout, void* iout, int vec, int unroll,
    int replicas, int device, void* stream, int* info) {
  for (int j = 0; j < 5; ++j) info[j] = 0;
  if (nf < 0 || nf > kMaxPayloads || nc < 0 || nc > kMaxPayloads || ni < 0 ||
      ni > kMaxPayloads) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = {};
  p.n = n;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  long long total = 0;
  if (!make_key_bins(nkeys, key_data, key_mask, key_code, kmin, span, &p.keys, &total))
    return (int)cudaErrorInvalidValue;
  p.total = (int)total;
  p.nf = nf;
  p.nc = nc;
  p.ni = ni;
  p.occupancy = occupancy != 0;
  for (int q = 0; q < nf; ++q)
    p.f[q] = {f_data[q], static_cast<const uint8_t*>(f_mask[q]), f_code[q]};
  for (int q = 0; q < nc; ++q) p.c[q] = static_cast<const uint8_t*>(c_flags[q]);
  for (int q = 0; q < ni; ++q)
    p.i[q] = {i_data[q], static_cast<const uint8_t*>(i_mask[q]), i_code[q]};
  p.fout = fout;
  p.cout = static_cast<int*>(cout);
  p.iout = static_cast<unsigned long long*>(iout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  err = f64 ? launch<double>(p, vec, unroll, replicas, device, st, info)
            : launch<float>(p, vec, unroll, replicas, device, st, info);
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
