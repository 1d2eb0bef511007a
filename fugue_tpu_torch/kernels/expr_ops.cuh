// K6 expr_program's numeric rules, one function per operation family,
// typed on the values' own C types. Every kernel that expr_codegen.py
// generates for a compiled program calls these and re-derives none of
// them; the twin (reference.expr_program_reference) follows the same
// rules with torch ops, and expr_program.py states them.
//
// The types: bool, unsigned char (uint8), signed char (int8), short,
// int, long long (int64), float, double. A bool is stored as one byte.
//
// - Integer + - * and negation wrap in their type: they compute in an
//   unsigned type at least as wide, then truncate.
// - Float + - * / round each operation to nearest: the _rn intrinsics,
//   which nvcc never contracts into an FMA nor folds (x + 0 keeps -0.0).
// - x mod 0 is NULL; an integer x mod -1 is 0; float mod is fmod.
// - A float becomes an integer by truncation, NaN as 0, values beyond the
//   type saturating at its bounds; anything becomes a bool as x != 0.
// - AND and OR are Kleene's: NULL AND FALSE is FALSE, NULL OR TRUE is TRUE.
// - A LUT index is clamped into its table.

#pragma once

#include <math.h>
#include <stdint.h>

namespace fugue {
namespace k6 {

// the unsigned type an integer type's + - * wrap in
template <class T> struct Wide;
template <> struct Wide<unsigned char> { using type = unsigned; };
template <> struct Wide<signed char> { using type = unsigned; };
template <> struct Wide<short> { using type = unsigned; };
template <> struct Wide<int> { using type = unsigned; };
template <> struct Wide<long long> { using type = unsigned long long; };

// an integer type's bounds, and the first float above it
template <class T> struct Limits;
template <> struct Limits<unsigned char> {
  static constexpr long long lo = 0, hi = 255;
  static constexpr double above = 256.0;
};
template <> struct Limits<signed char> {
  static constexpr long long lo = -128, hi = 127;
  static constexpr double above = 128.0;
};
template <> struct Limits<short> {
  static constexpr long long lo = -32768, hi = 32767;
  static constexpr double above = 32768.0;
};
template <> struct Limits<int> {
  static constexpr long long lo = -2147483648LL, hi = 2147483647LL;
  static constexpr double above = 2147483648.0;
};
template <> struct Limits<long long> {
  static constexpr long long lo = -9223372036854775807LL - 1, hi = 9223372036854775807LL;
  static constexpr double above = 9223372036854775808.0;
};

template <class T> struct IsFloat { static constexpr bool value = false; };
template <> struct IsFloat<float> { static constexpr bool value = true; };
template <> struct IsFloat<double> { static constexpr bool value = true; };
template <class T> struct IsBool { static constexpr bool value = false; };
template <> struct IsBool<bool> { static constexpr bool value = true; };

// --- loads and immediates -----------------------------------------------

template <class T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldg(p);
}
__device__ __forceinline__ bool ld_flag(const unsigned char* p) { return __ldg(p) != 0; }

// an immediate from its 64-bit word (expr_program.Instr.imm_bits): floats
// by their bits (float32's in the low half), integers sign-extended
template <class T>
__device__ __forceinline__ T from_bits(long long b) {
  if constexpr (IsFloat<T>::value) {
    if constexpr (sizeof(T) == 4) return __int_as_float((int)b);
    else return __longlong_as_double(b);
  } else {
    return (T)b;  // a bool: b != 0
  }
}

// a value from the low bytes of a vector's word, and back
template <class T>
__device__ __forceinline__ T from_word(unsigned long long w) {
  if constexpr (IsFloat<T>::value) {
    if constexpr (sizeof(T) == 4) return __uint_as_float((unsigned)w);
    else return __longlong_as_double((long long)w);
  } else {
    return (T)w;  // the low bytes, as the type's bits
  }
}
template <class T>
__device__ __forceinline__ unsigned long long to_word(T x) {
  if constexpr (IsFloat<T>::value) {
    if constexpr (sizeof(T) == 4) return __float_as_uint(x);
    else return (unsigned long long)__double_as_longlong(x);
  } else if constexpr (sizeof(T) == 1) {
    return (unsigned char)x;
  } else if constexpr (sizeof(T) == 2) {
    return (unsigned short)x;
  } else if constexpr (sizeof(T) == 4) {
    return (unsigned)x;
  } else {
    return (unsigned long long)x;
  }
}

// W (2 or 4) consecutive values from p, aligned to W * sizeof(T) bytes
// (at most 16), in one vector load, and W stored the same way
template <int W, class T>
__device__ __forceinline__ void ldv(const T* p, T (&v)[W]) {
  static_assert(W * sizeof(T) <= 16, "one vector of at most 16 bytes");
  if constexpr (W == 2) {
    if constexpr (sizeof(T) == 1) {
      const uchar2 w = __ldg(reinterpret_cast<const uchar2*>(p));
      v[0] = from_word<T>(w.x), v[1] = from_word<T>(w.y);
    } else if constexpr (sizeof(T) == 2) {
      const ushort2 w = __ldg(reinterpret_cast<const ushort2*>(p));
      v[0] = from_word<T>(w.x), v[1] = from_word<T>(w.y);
    } else if constexpr (sizeof(T) == 4) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = from_word<T>(w.x), v[1] = from_word<T>(w.y);
    } else {
      const ulonglong2 w = __ldg(reinterpret_cast<const ulonglong2*>(p));
      v[0] = from_word<T>(w.x), v[1] = from_word<T>(w.y);
    }
  } else {
    if constexpr (sizeof(T) == 1) {
      const uchar4 w = __ldg(reinterpret_cast<const uchar4*>(p));
      v[0] = from_word<T>(w.x), v[1] = from_word<T>(w.y), v[2] = from_word<T>(w.z),
      v[3] = from_word<T>(w.w);
    } else if constexpr (sizeof(T) == 2) {
      const ushort4 w = __ldg(reinterpret_cast<const ushort4*>(p));
      v[0] = from_word<T>(w.x), v[1] = from_word<T>(w.y), v[2] = from_word<T>(w.z),
      v[3] = from_word<T>(w.w);
    } else {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = from_word<T>(w.x), v[1] = from_word<T>(w.y), v[2] = from_word<T>(w.z),
      v[3] = from_word<T>(w.w);
    }
  }
}
template <int W>
__device__ __forceinline__ void ldv_flag(const unsigned char* p, bool (&v)[W]) {
  unsigned char w[W];
  ldv<W>(p, w);
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = w[j] != 0;
}

template <int W, class T>
__device__ __forceinline__ void stv(T* p, const T (&v)[W]) {
  static_assert(W * sizeof(T) <= 16, "one vector of at most 16 bytes");
  if constexpr (W == 2) {
    if constexpr (sizeof(T) == 1) {
      *reinterpret_cast<uchar2*>(p) = make_uchar2(to_word(v[0]), to_word(v[1]));
    } else if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<ushort2*>(p) = make_ushort2(to_word(v[0]), to_word(v[1]));
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(to_word(v[0]), to_word(v[1]));
    } else {
      *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(to_word(v[0]), to_word(v[1]));
    }
  } else {
    if constexpr (sizeof(T) == 1) {
      *reinterpret_cast<uchar4*>(p) =
          make_uchar4(to_word(v[0]), to_word(v[1]), to_word(v[2]), to_word(v[3]));
    } else if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<ushort4*>(p) =
          make_ushort4(to_word(v[0]), to_word(v[1]), to_word(v[2]), to_word(v[3]));
    } else {
      *reinterpret_cast<uint4*>(p) =
          make_uint4(to_word(v[0]), to_word(v[1]), to_word(v[2]), to_word(v[3]));
    }
  }
}

// --- arithmetic -----------------------------------------------------------

template <class T>
__device__ __forceinline__ T add(T x, T y) {
  using U = typename Wide<T>::type;
  return (T)((U)x + (U)y);
}
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ bool add(bool x, bool y) { return x | y; }  // as jnp adds bools

template <class T>
__device__ __forceinline__ T sub(T x, T y) {
  using U = typename Wide<T>::type;
  return (T)((U)x - (U)y);
}
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }

template <class T>
__device__ __forceinline__ T mul(T x, T y) {
  using U = typename Wide<T>::type;
  return (T)((U)x * (U)y);
}
__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ bool mul(bool x, bool y) { return x & y; }

__device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
__device__ __forceinline__ double pow_(double x, double y) { return pow(x, y); }

template <class T>
__device__ __forceinline__ T neg(T x) {
  using U = typename Wide<T>::type;
  return (T)((U)0 - (U)x);
}
__device__ __forceinline__ float neg(float x) { return -x; }
__device__ __forceinline__ double neg(double x) { return -x; }

template <class T>
__device__ __forceinline__ T abs_(T x) {
  return x < (T)0 ? neg(x) : x;
}
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ bool abs_(bool x) { return x; }

// integers: -1, 0 or 1; floats keep NaN and a zero's sign
template <class T>
__device__ __forceinline__ T sign(T x) {
  return x > (T)0 ? (T)1 : (x < (T)0 ? (T)-1 : (T)0);
}
__device__ __forceinline__ float sign(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }
__device__ __forceinline__ double sign(double x) { return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x); }

// x mod y truncates (the dividend's sign); its validity also needs mod_ok
template <class T>
__device__ __forceinline__ T mod(T x, T y) {
  return ((long long)y == 0 || (long long)y == -1) ? (T)0 : (T)(x % y);
}
__device__ __forceinline__ float mod(float x, float y) { return fmodf(x, y == 0.f ? 1.f : y); }
__device__ __forceinline__ double mod(double x, double y) { return fmod(x, y == 0.0 ? 1.0 : y); }
template <class T>
__device__ __forceinline__ bool mod_ok(T y) {
  return y != (T)0;
}

__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float ceil_(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_(double x) { return ceil(x); }

// NaN as a NULL 0: the value, and whether it stays valid
template <class T>
__device__ __forceinline__ T nannull(T x) {
  return isnan(x) ? (T)0 : x;
}
template <class T>
__device__ __forceinline__ bool not_nan(T x) {
  return !isnan(x);
}

// the float functions, float64 only (CUDA's libraries, within 2 ulp)
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ double ln_(double x) { return log(x); }
__device__ __forceinline__ double log2_(double x) { return log2(x); }
__device__ __forceinline__ double log10_(double x) { return log10(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ double tan_(double x) { return tan(x); }

// round(x, d): numpy's formula, each step rounded; s = 10^|d|, and
// divide where d < 0
__device__ __forceinline__ double round_(double x, double s, bool divide) {
  return divide ? __dmul_rn(rint(__ddiv_rn(x, s)), s) : __ddiv_rn(rint(__dmul_rn(x, s)), s);
}

// --- comparisons and logic --------------------------------------------------

template <class T> __device__ __forceinline__ bool eq(T x, T y) { return x == y; }
template <class T> __device__ __forceinline__ bool ne(T x, T y) { return x != y; }
template <class T> __device__ __forceinline__ bool lt(T x, T y) { return x < y; }
template <class T> __device__ __forceinline__ bool le(T x, T y) { return x <= y; }
template <class T> __device__ __forceinline__ bool gt(T x, T y) { return x > y; }
template <class T> __device__ __forceinline__ bool ge(T x, T y) { return x >= y; }

// Kleene logic over (value, validity) pairs; a NULL's value reads as false
__device__ __forceinline__ bool and_value(bool x, bool vx, bool y, bool vy) {
  return x && vx && y && vy;
}
__device__ __forceinline__ bool and_valid(bool x, bool vx, bool y, bool vy) {
  return (vx && vy) || (vx && !x) || (vy && !y);
}
__device__ __forceinline__ bool or_value(bool x, bool vx, bool y, bool vy) {
  return (x && vx) || (y && vy);
}
__device__ __forceinline__ bool or_valid(bool x, bool vx, bool y, bool vy) {
  return (vx && vy) || (vx && x) || (vy && y);
}
__device__ __forceinline__ bool not_(bool x) { return !x; }

// SEL takes its value where the condition holds and is valid
__device__ __forceinline__ bool sel_cond(bool c, bool vc) { return c && vc; }
// NULLIF: a's value, NULL where b (a == b, with its validity) holds
__device__ __forceinline__ bool nullif_valid(bool va, bool b, bool vb) { return va && !(b && vb); }

// --- casts ---------------------------------------------------------------

// a float to integer type D: truncation, NaN as 0, saturation
template <class D>
__device__ __forceinline__ D float_to_int(double x) {
  if (isnan(x)) return (D)0;
  if (x >= Limits<D>::above) return (D)Limits<D>::hi;
  if (x < (double)Limits<D>::lo) return (D)Limits<D>::lo;
  return (D)(long long)x;
}

template <class D, class S>
__device__ __forceinline__ D cast(S x) {
  if constexpr (IsBool<D>::value) {
    return x != (S)0;
  } else if constexpr (IsFloat<S>::value) {
    if constexpr (IsFloat<D>::value) {
      if constexpr (sizeof(D) == 8) return (double)x;
      else if constexpr (sizeof(S) == 4) return x;
      else return __double2float_rn(x);
    } else {
      return float_to_int<D>((double)x);
    }
  } else {
    if constexpr (IsFloat<D>::value) {
      if constexpr (sizeof(D) == 8) return __ll2double_rn((long long)x);
      else return __ll2float_rn((long long)x);
    } else {
      return (D)x;  // wraps to D's width
    }
  }
}

// --- tables ----------------------------------------------------------------

__device__ __forceinline__ long long lut_index(long long i, long long len) {
  return i < 0 ? 0 : (i >= len ? len - 1 : i);
}

// table[clamp(i)], through the read-only path (a dictionary's table stays
// in L1 and L2; staging it in shared memory measured no better)
template <class T>
__device__ __forceinline__ T lut(const T* table, long long len, long long i) {
  return __ldg(table + lut_index(i, len));
}

}  // namespace k6
}  // namespace fugue
