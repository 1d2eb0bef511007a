// Streaming aggregation on the card: K19 stream_fold.
//
// It replaces the JAX package's streaming update program
// (StreamingAggregator._get_update's _update, streaming.py:295-350, which
// XLA lowers to one segment sum, min or max a plan over the chunk, added
// into donated accumulators; no Pallas kernel): one chunk's rows binned
// into the aggregator's slot space (the mixed radix of _Space.seg,
// streaming.py:125) and folded into the persistent accumulators of every
// plan in one pass, with global atomics:
//   - kRows, kCount: atomicAdd on u64 (every row; the valid values);
//   - kSumI: int64 sums as u64 adds, exact by two's complement;
//   - kSumF, kSumIF: atomicAdd(double) of a float64 value, or of an int64
//     value converted (an average of integers);
//   - kMinI, kMaxI: atomicMin/atomicMax on long long;
//   - kMinF, kMaxF: the same on the float's order key (its bits, the
//     magnitude flipped where negative: a signed order equal to the
//     float's), so no compare-and-swap loop.
// A masked value is skipped; NaN never arrives (the caller masks it as
// null, as streaming.py:428-440 does). Contract: stream_fold_reference in
// reference.py.
//
// What bounds it on an H100, and what the design does about it: it reads
// 8 B a key and 8 B (+1 B where masked) a payload a row, coalesced, and
// each slot it touches is read and written once an accumulator, through
// L2 by the atomics. The store is slot-major ([slots][width]): a row's
// atomics all land in its slot's few adjacent sectors; with one row of
// memory an accumulator they would each hit a far sector of a store that
// L2 does not hold (2.4x slower at 20 accumulators, PERF.md). The keys, payloads and the ops live in the kernel's
// parameters (uniform across a warp), so a row costs its loads, one
// mixed-radix slot and one atomic an op. A chunk of uniformly spread keys
// over ~1M slots has few collisions, so no warp aggregation is tried.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kMaxKeys = 8;
constexpr int kMaxPayloads = 16;
constexpr int kMaxOps = 48;
constexpr int kRows = 0, kCount = 1, kSumI = 2, kSumF = 3, kSumIF = 4, kMinI = 5, kMaxI = 6,
              kMinF = 7, kMaxF = 8;
constexpr long long kMagnitude = 0x7fffffffffffffffLL;

struct FoldKey {
  const long long* data;  // int64 [n]
  long long lo;
  long long span;
};

struct FoldPayload {
  const long long* values;  // int64 or float64 [n], read as their bits
  const uint8_t* mask;      // bool [n], or null: every value valid
};

struct FoldOp {
  int kind;
  int payload;  // index into payloads; -1 for kRows
  int column;   // the op's accumulator in a slot's row of the store
};

struct FoldParams {
  long long n;
  long long* store;  // int64 [slots][width]
  long long slots;
  long long width;
  int nkeys, npayloads, nops;
  FoldKey keys[kMaxKeys];
  FoldPayload payloads[kMaxPayloads];
  FoldOp ops[kMaxOps];
};

__device__ __forceinline__ long long order_key(long long bits) {
  return bits < 0 ? bits ^ kMagnitude : bits;
}

__global__ void __launch_bounds__(kThreads) stream_fold(const __grid_constant__ FoldParams p) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < p.n; r += step) {
    long long slot = 0;
    for (int j = 0; j < p.nkeys; ++j)
      slot = slot * p.keys[j].span + (__ldg(p.keys[j].data + r) - p.keys[j].lo);
    if (slot < 0 || slot >= p.slots) continue;  // outside the space: the caller's bounds
    long long* const accs = p.store + slot * p.width;
    int cur = -1;
    long long bits = 0;
    bool ok = false;
    for (int o = 0; o < p.nops; ++o) {
      const FoldOp op = p.ops[o];
      long long* const a = accs + op.column;
      if (op.kind == kRows) {
        atomicAdd(reinterpret_cast<unsigned long long*>(a), 1ull);
        continue;
      }
      if (op.payload != cur) {  // ops of one payload are adjacent: one load each
        cur = op.payload;
        const FoldPayload pl = p.payloads[cur];
        ok = pl.mask == nullptr || __ldg(pl.mask + r) != 0;
        bits = ok ? __ldg(pl.values + r) : 0;
      }
      if (!ok) continue;
      switch (op.kind) {
        case kCount:
          atomicAdd(reinterpret_cast<unsigned long long*>(a), 1ull);
          break;
        case kSumI:
          atomicAdd(reinterpret_cast<unsigned long long*>(a), (unsigned long long)bits);
          break;
        case kSumF:
          atomicAdd(reinterpret_cast<double*>(a), __longlong_as_double(bits));
          break;
        case kSumIF:
          atomicAdd(reinterpret_cast<double*>(a), (double)bits);
          break;
        case kMinI:
          atomicMin(a, bits);
          break;
        case kMaxI:
          atomicMax(a, bits);
          break;
        case kMinF:
          atomicMin(a, order_key(bits));
          break;
        default:  // kMaxF
          atomicMax(a, order_key(bits));
          break;
      }
    }
  }
}

}  // namespace

// The plain C entry point, bound with ctypes. Returns a cudaError_t (0
// when every call was accepted), launches on stream (a cudaStream_t of
// device), allocates nothing and sets *launched to 1 where it launched.
// n rows (1 to 2^31 - 1) into store, int64 [slots][width] on the device;
// the descriptors are host arrays: keys (nkeys x 3: data pointer, lo,
// span), payloads (npayloads x 2: values pointer, mask pointer or 0) and
// ops (nops x 3: kind, payload index, column of the store), at most 8, 16
// and 48.
extern "C" int fugue_stream_fold(long long n, void* store, long long slots, long long width,
                                 int nkeys, const long long* keys, int npayloads,
                                 const long long* payloads, int nops, const long long* ops,
                                 int device, void* stream, int* launched) {
  *launched = 0;
  if (n < 1 || n >= (1LL << 31) || store == nullptr || slots < 1 || width < 1 || nkeys < 1 ||
      nkeys > kMaxKeys || npayloads < 0 || npayloads > kMaxPayloads || nops < 1 ||
      nops > kMaxOps)
    return (int)cudaErrorInvalidValue;
  FoldParams p = {};
  p.n = n;
  p.store = static_cast<long long*>(store);
  p.slots = slots;
  p.width = width;
  p.nkeys = nkeys;
  p.npayloads = npayloads;
  p.nops = nops;
  for (int j = 0; j < nkeys; ++j) {
    p.keys[j].data = reinterpret_cast<const long long*>(keys[3 * j]);
    p.keys[j].lo = keys[3 * j + 1];
    p.keys[j].span = keys[3 * j + 2];
    if (p.keys[j].data == nullptr || p.keys[j].span < 1) return (int)cudaErrorInvalidValue;
  }
  for (int j = 0; j < npayloads; ++j) {
    p.payloads[j].values = reinterpret_cast<const long long*>(payloads[2 * j]);
    p.payloads[j].mask = reinterpret_cast<const uint8_t*>(payloads[2 * j + 1]);
  }
  for (int o = 0; o < nops; ++o) {
    p.ops[o].kind = (int)ops[3 * o];
    p.ops[o].payload = (int)ops[3 * o + 1];
    p.ops[o].column = (int)ops[3 * o + 2];
    if (p.ops[o].kind < kRows || p.ops[o].kind > kMaxF || p.ops[o].column < 0 ||
        p.ops[o].column >= width ||
        (p.ops[o].kind != kRows && (p.ops[o].payload < 0 || p.ops[o].payload >= npayloads)))
      return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = on_device(device, [&] {
    return launch_wave(stream_fold, n, kThreads, device, static_cast<cudaStream_t>(stream), p);
  });
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The message of a cudaError_t, for the wrapper's exceptions.
extern "C" const char* fugue_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
