// Maps what K6's generated device code uses of CUDA onto host C++, so
// that tests/test_torch_expr_codegen.py can build a generated kernel's
// device part (its Params, Row, Out, loads, row and stores) with g++ and run it
// row by row on the CPU. Build with -ffp-contract=off: the _rn
// intrinsics below are plain operations, each rounded to nearest, and
// must not be contracted into an FMA.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __global__
#define __grid_constant__
#define __launch_bounds__(x)

struct uint4 {
  unsigned x, y, z, w;
};

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

inline float __fadd_rn(float x, float y) { return x + y; }
inline float __fsub_rn(float x, float y) { return x - y; }
inline float __fmul_rn(float x, float y) { return x * y; }
inline float __fdiv_rn(float x, float y) { return x / y; }
inline double __dadd_rn(double x, double y) { return x + y; }
inline double __dsub_rn(double x, double y) { return x - y; }
inline double __dmul_rn(double x, double y) { return x * y; }
inline double __ddiv_rn(double x, double y) { return x / y; }

inline float __int_as_float(int b) {
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
}
inline double __longlong_as_double(long long b) {
  double d;
  memcpy(&d, &b, sizeof d);
  return d;
}
inline float __double2float_rn(double x) { return (float)x; }
inline double __ll2double_rn(long long x) { return (double)x; }
inline float __ll2float_rn(long long x) { return (float)x; }

// the vector types of the vector path, and their bit casts
struct uchar4 {
  unsigned char x, y, z, w;
};
struct ushort4 {
  unsigned short x, y, z, w;
};
struct ulonglong2 {
  unsigned long long x, y;
};
inline uchar4 make_uchar4(unsigned char x, unsigned char y, unsigned char z, unsigned char w) {
  return {x, y, z, w};
}
inline ushort4 make_ushort4(unsigned short x, unsigned short y, unsigned short z,
                            unsigned short w) {
  return {x, y, z, w};
}
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline ulonglong2 make_ulonglong2(unsigned long long x, unsigned long long y) { return {x, y}; }
inline float __uint_as_float(unsigned b) {
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
}
inline unsigned __float_as_uint(float x) {
  unsigned b;
  memcpy(&b, &x, sizeof b);
  return b;
}
inline long long __double_as_longlong(double x) {
  long long b;
  memcpy(&b, &x, sizeof b);
  return b;
}
struct uchar2 {
  unsigned char x, y;
};
struct ushort2 {
  unsigned short x, y;
};
struct uint2 {
  unsigned x, y;
};
inline uchar2 make_uchar2(unsigned char x, unsigned char y) { return {x, y}; }
inline ushort2 make_ushort2(unsigned short x, unsigned short y) { return {x, y}; }
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
