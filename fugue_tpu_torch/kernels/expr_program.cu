// K6 expr_program: one pass of a compiled column-expression program over
// a frame's rows.
//
// Replaces the JAX package's jitted elementwise programs over
// expr_eval._eval (fugue_tpu/jax_backend/expr_eval.py:109; _binary :512,
// _cast :552): filter's _filter_prog (execution_engine.py:1387), assign's
// _assign_prog (:1446) and _device_project's _project_prog (:2242), and
// the table gathers by dictionary code of expr_eval's string part: LIKE's
// jnp.take of a match table (_like_literal :64, the pair table :197-216),
// _str_compare's rank gathers (:477), LENGTH and the dictionary
// transforms (:303, :417), canonicalize_string_column's take (:572) and
// relational.harmonize_string_keys' remap (:69). XLA fuses each into one
// elementwise pass; none is a Pallas kernel.
// Contract: expr_program_reference in reference.py, which interprets the
// same program with torch ops; the compiler and the numeric rules are in
// expr_program.py.
//
// The program: registers 0 .. nin - 1 start as the row's input values
// (each column and its mask read once), then the instructions run in
// order, each dst = op(a, b, c) with an opcode per operation family and
// operand dtype (family * 8 + the dtype code of bin_keys.cuh). A register
// is 64 bits: integers sign-extended, uint8 and bool zero-extended,
// float32 by its bits in the low half, float64 by its bits; its validity
// is one bit of a 32-bit word. The program rides in the kernel's
// parameters (__grid_constant__, at most kMaxInstrs instructions), and
// every thread of the grid runs the same instruction at the same step,
// so the dispatch never diverges.
//
// Tables: a program carries up to kMaxTables small device tables (bool,
// int32 or int64), each a pointer and a length. LUT dst = table[t][clamp(a,
// 0, len - 1)] with a's validity: a string register holds int32 codes and
// the host compiler, not the kernel, knows which dictionary they index.
// The tables are read through __ldg and left in global memory: they are
// small (a dictionary's entries) and stay hot in L1 and L2.
//
// Epilogues: columns mode writes each output's values (and its mask
// where it has one); filter mode writes keep = value AND valid AND the
// row is real, and adds the kept count of each block to one counter (a
// sum per warp, then per block in shared memory, one atomicAdd a block).
//
// Numbers: integer + - * and negation wrap (computed in 64-bit unsigned,
// then truncated to the type's width); x mod 0 is NULL and x mod -1 is 0;
// float + - * / round to nearest with no contraction (__fadd_rn and the
// rest); a float becomes an integer by truncation with NaN as 0 and
// values beyond the type saturating; the float functions are CUDA's
// double-precision ones (within 2 ulp of the twin's, not bit-equal).
//
// What bounds it on an H100: bytes (each input and mask read once, each
// output written once: 5 to 37 bytes a row on the paths that run it),
// but as an interpreter it issues about one warp instruction a row for
// each program instruction, plus the loads and stores around them, and
// that sets its pace. The design: registers are indexed at run time, so
// they live in shared memory (a thread's file for its rows: 8 bytes a
// register a row, only the program's registers allocated); each thread
// takes R rows a step (4, or 2 or 1 for programs of more than 8 or 16
// registers, keeping a block within 64 KB) and decodes each instruction
// once for them, its switch outside the row loop. Specialising the kernel
// per program is left for later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bin_keys.cuh"
#include "launch.cuh"

namespace {

using namespace fugue;

constexpr int kThreads = 256;
constexpr int kMaxInstrs = 64;
constexpr int kMaxRegs = 32;  // the validity word's bits
constexpr int kMaxInputs = 16;
constexpr int kMaxOutputs = 16;
constexpr int kMaxTables = 8;

// operation families, in expr_program.py's OPS order
enum Family {
  CONST, NULLV, ADD, SUB, MUL, DIV, MOD, POW, NEG, ABS,
  EQ, NE, LT, LE, GT, GE, AND, OR, NOT, ISNULL, NOTNULL,
  CAST, SEL, COAL, NULLIF, FLOOR, CEIL, SIGN, NANNULL,
  SQRT, EXP, LN, LOG2, LOG10, SIN, COS, TAN, ROUND, LUT, kFamilies
};

struct Instr {
  int op;  // family * 8 + dtype code
  unsigned char dst, a, b, c;
  long long imm;  // CONST's register bits; ROUND's factor as float64 bits
};

struct Output {
  void* data;
  uint8_t* mask;  // null: no mask written
  int code;
  int reg;
};

struct Program {
  long long n;
  long long nrows;            // filter mode: prefix rows, or -1 with row_valid
  const uint8_t* row_valid;
  uint8_t* keep;              // filter mode: bool [n]
  int* count;                 // filter mode: kept rows are added here
  int nin, ninstr, nout, ntab;
  Column in[kMaxInputs];
  Instr ins[kMaxInstrs];
  Output out[kMaxOutputs];
  Column tab[kMaxTables];     // LUT tables: data and dtype code
  long long tab_len[kMaxTables];
};

__device__ __forceinline__ float as_f32(long long x) { return __uint_as_float((unsigned)x); }
__device__ __forceinline__ long long from_f32(float f) {
  return (long long)__float_as_uint(f);
}
__device__ __forceinline__ double as_f64(long long x) { return __longlong_as_double(x); }
__device__ __forceinline__ long long from_f64(double d) { return __double_as_longlong(d); }

__device__ __forceinline__ long long load(const Column& c, long long row) {
  switch (c.code) {
    case kBool:
    case kU8: return (long long)__ldg(static_cast<const uint8_t*>(c.data) + row);
    case kI8: return (long long)__ldg(static_cast<const signed char*>(c.data) + row);
    case kI16: return (long long)__ldg(static_cast<const short*>(c.data) + row);
    case kI32: return (long long)__ldg(static_cast<const int*>(c.data) + row);
    case kI64: return __ldg(static_cast<const long long*>(c.data) + row);
    case kF32: return from_f32(__ldg(static_cast<const float*>(c.data) + row));
    default: return from_f64(__ldg(static_cast<const double*>(c.data) + row));
  }
}

__device__ __forceinline__ void store(const Output& o, long long row, long long x) {
  switch (o.code) {
    case kBool:
    case kU8:
    case kI8: static_cast<uint8_t*>(o.data)[row] = (uint8_t)x; break;
    case kI16: static_cast<short*>(o.data)[row] = (short)x; break;
    case kI32:
    case kF32: static_cast<unsigned*>(o.data)[row] = (unsigned)x; break;
    default: static_cast<long long*>(o.data)[row] = x; break;
  }
}

// an integer wrapped to the width of dtype `code`, sign- or zero-extended
__device__ __forceinline__ long long wrap(int code, unsigned long long x) {
  switch (code) {
    case kBool: return x != 0;
    case kU8: return (long long)(uint8_t)x;
    case kI8: return (long long)(signed char)x;
    case kI16: return (long long)(short)x;
    case kI32: return (long long)(int)x;
    default: return (long long)x;
  }
}

// a float to integer dtype `code`: truncation, NaN as 0, saturation
__device__ __forceinline__ long long float_to_int(double x, int code) {
  double hi;  // 2^(bits - 1), or 2^8 for uint8: the first value above the type
  long long lo_v, hi_v;
  switch (code) {
    case kU8: hi = 256.0; lo_v = 0; hi_v = 255; break;
    case kI8: hi = 128.0; lo_v = -128; hi_v = 127; break;
    case kI16: hi = 32768.0; lo_v = -32768; hi_v = 32767; break;
    case kI32: hi = 2147483648.0; lo_v = -2147483648LL; hi_v = 2147483647LL; break;
    default: hi = 9223372036854775808.0; lo_v = (-9223372036854775807LL - 1);
             hi_v = 9223372036854775807LL; break;
  }
  if (isnan(x)) return 0;
  if (x >= hi) return hi_v;
  if (x < (double)lo_v) return lo_v;
  return (long long)x;
}

template <int D>
constexpr bool kFloat = D == kF32 || D == kF64;

// a register of float dtype D as a double (exact for float32) and back
template <int D>
__device__ __forceinline__ double fget(long long x) {
  if constexpr (D == kF32) return (double)as_f32(x);
  else return as_f64(x);
}

template <int S>
__device__ __forceinline__ long long cast(long long a, int dst) {
  if (dst == kBool) {
    if constexpr (kFloat<S>) return fget<S>(a) != 0.0;
    else return a != 0;
  }
  if constexpr (kFloat<S>) {
    if (dst == kF64) return from_f64(fget<S>(a));
    if (dst == kF32) return S == kF32 ? a : from_f32(__double2float_rn(as_f64(a)));
    return float_to_int(fget<S>(a), dst);
  } else {
    if (dst == kF64) return from_f64(__ll2double_rn(a));
    if (dst == kF32) return from_f32(__ll2float_rn(a));
    return wrap(dst, (unsigned long long)a);
  }
}

template <typename T>
__device__ __forceinline__ T fsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);  // NaN and a zero's sign kept
}

// Row by row, unrolled: the body of one instruction over a thread's R rows.
template <int R, typename F>
__device__ __forceinline__ void rows(F body) {
#pragma unroll
  for (int j = 0; j < R; ++j) body(j);
}

// A thread's registers for its R rows of a step: register i of row j at
// word (i * R + j) * kThreads + t of the block's shared memory (so a warp's
// accesses to one register are consecutive words), and the validity of
// row j's registers as the bits of v[j].
template <int R>
struct File {
  long long* base;
  unsigned v[R];
  __device__ __forceinline__ long long& at(int i, int j) const {
    return base[(i * R + j) * kThreads];
  }
  __device__ __forceinline__ bool ok(int i, int j) const { return (v[j] >> i) & 1u; }
  __device__ __forceinline__ void set(int i, int j, long long x, bool valid) {
    at(i, j) = x;
    v[j] = valid ? (v[j] | (1u << i)) : (v[j] & ~(1u << i));
  }
};

// a float register of dtype D (float32 or float64) in its own type, and back
template <int D>
__device__ __forceinline__ auto fval(long long x) {
  if constexpr (D == kF32) return as_f32(x);
  else return as_f64(x);
}

template <int D, typename T>
__device__ __forceinline__ long long fbits(T x) {
  if constexpr (D == kF32) return from_f32((float)x);
  else return from_f64((double)x);
}

__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }

// The families whose meaning depends on the operands' dtype D. Each case
// decodes once and runs over the R rows.
template <int D, int R>
__device__ __forceinline__ void typed(int fam, const Instr& in, File<R>& f) {
  const int a = in.a, b = in.b, d = in.dst;
  // comparisons: integers and bools compare sign- or zero-extended
#define K6_CMP(FAM, OP)                                                              \
  case FAM:                                                                          \
    rows<R>([&](int j) {                                                             \
      bool res;                                                                      \
      if constexpr (kFloat<D>) res = fval<D>(f.at(a, j)) OP fval<D>(f.at(b, j));     \
      else res = f.at(a, j) OP f.at(b, j);                                           \
      f.set(d, j, res, f.ok(a, j) && f.ok(b, j));                                    \
    });                                                                              \
    return;
  switch (fam) {
    K6_CMP(EQ, ==)
    K6_CMP(NE, !=)
    K6_CMP(LT, <)
    K6_CMP(LE, <=)
    K6_CMP(GT, >)
    K6_CMP(GE, >=)
    case CAST:
      rows<R>([&](int j) { f.set(d, j, cast<D>(f.at(a, j), in.b), f.ok(a, j)); });
      return;
    default: break;
  }
#undef K6_CMP
  if constexpr (D == kBool) {
    switch (fam) {
      case ADD:  // OR, as jnp adds bools
        rows<R>([&](int j) {
          f.set(d, j, (f.at(a, j) | f.at(b, j)) != 0, f.ok(a, j) && f.ok(b, j));
        });
        return;
      case MUL:  // AND
        rows<R>([&](int j) {
          f.set(d, j, (f.at(a, j) & f.at(b, j)) != 0, f.ok(a, j) && f.ok(b, j));
        });
        return;
      default:  // ABS
        rows<R>([&](int j) { f.set(d, j, f.at(a, j), f.ok(a, j)); });
        return;
    }
  } else if constexpr (kFloat<D>) {
    using T = decltype(fval<D>(0));
#define K6_BIN(FAM, EXPR)                                                            \
  case FAM:                                                                          \
    rows<R>([&](int j) {                                                             \
      const T x = fval<D>(f.at(a, j)), y = fval<D>(f.at(b, j));                      \
      f.set(d, j, fbits<D>(EXPR), f.ok(a, j) && f.ok(b, j));                         \
    });                                                                              \
    return;
#define K6_UN(FAM, EXPR)                                                             \
  case FAM:                                                                          \
    rows<R>([&](int j) {                                                             \
      const T x = fval<D>(f.at(a, j));                                               \
      f.set(d, j, fbits<D>(EXPR), f.ok(a, j));                                       \
    });                                                                              \
    return;
    switch (fam) {
      K6_BIN(ADD, add_rn(x, y))
      K6_BIN(SUB, sub_rn(x, y))
      K6_BIN(MUL, mul_rn(x, y))
      K6_BIN(DIV, div_rn(x, y))
      K6_BIN(POW, pow(x, y))
      case MOD:  // fmod is exact; x mod 0 is NULL
        rows<R>([&](int j) {
          const T x = fval<D>(f.at(a, j)), y = fval<D>(f.at(b, j));
          f.set(d, j, fbits<D>(fmod(x, y == T(0) ? T(1) : y)),
                f.ok(a, j) && f.ok(b, j) && y != T(0));
        });
        return;
      case NANNULL:
        rows<R>([&](int j) {
          const T x = fval<D>(f.at(a, j));
          f.set(d, j, fbits<D>(isnan(x) ? T(0) : x), f.ok(a, j) && !isnan(x));
        });
        return;
      case ROUND: {  // float64 only: numpy's formula, each step rounded
        const double s = as_f64(in.imm);
        if (in.b) {
          rows<R>([&](int j) {
            const double x = (double)fval<D>(f.at(a, j));
            f.set(d, j, from_f64(__dmul_rn(rint(__ddiv_rn(x, s)), s)), f.ok(a, j));
          });
        } else {
          rows<R>([&](int j) {
            const double x = (double)fval<D>(f.at(a, j));
            f.set(d, j, from_f64(__ddiv_rn(rint(__dmul_rn(x, s)), s)), f.ok(a, j));
          });
        }
        return;
      }
      K6_UN(NEG, -x)
      K6_UN(ABS, fabs(x))
      K6_UN(FLOOR, floor(x))
      K6_UN(CEIL, ceil(x))
      K6_UN(SIGN, fsign(x))
      K6_UN(SQRT, sqrt(x))
      K6_UN(EXP, exp(x))
      K6_UN(LN, log(x))
      K6_UN(LOG2, log2(x))
      K6_UN(LOG10, log10(x))
      K6_UN(SIN, sin(x))
      K6_UN(COS, cos(x))
      default: K6_UN(TAN, tan(x))
    }
#undef K6_BIN
#undef K6_UN
  } else {  // integers: + - * and negation in 64-bit unsigned, then wrapped
#define K6_INT(FAM, EXPR, VALID)                                                     \
  case FAM:                                                                          \
    rows<R>([&](int j) {                                                             \
      const long long x = f.at(a, j), y = f.at(b, j);                                \
      (void)y;                                                                       \
      f.set(d, j, EXPR, VALID);                                                      \
    });                                                                              \
    return;
    switch (fam) {
      K6_INT(ADD, wrap(D, (unsigned long long)x + (unsigned long long)y),
             f.ok(a, j) && f.ok(b, j))
      K6_INT(SUB, wrap(D, (unsigned long long)x - (unsigned long long)y),
             f.ok(a, j) && f.ok(b, j))
      K6_INT(MUL, wrap(D, (unsigned long long)x * (unsigned long long)y),
             f.ok(a, j) && f.ok(b, j))
      K6_INT(MOD, (y == 0 || y == -1) ? 0 : wrap(D, (unsigned long long)(x % y)),
             f.ok(a, j) && f.ok(b, j) && y != 0)
      K6_INT(NEG, wrap(D, 0ull - (unsigned long long)x), f.ok(a, j))
      K6_INT(ABS, x < 0 ? wrap(D, 0ull - (unsigned long long)x) : x, f.ok(a, j))
      default: K6_INT(SIGN, x > 0 ? 1 : (x < 0 ? -1 : 0), f.ok(a, j))
    }
#undef K6_INT
  }
}

// One instruction over the thread's R rows.
template <int R>
__device__ __forceinline__ void step(const Program& p, const Instr& in, File<R>& f) {
  const int fam = in.op >> 3;
  const int a = in.a, b = in.b, c = in.c, d = in.dst;
  switch (fam) {
    case LUT: {  // b: the table; an index outside it is clamped into it
      const Column& t = p.tab[b];
      const long long hi = p.tab_len[b] - 1;
      rows<R>([&](int j) {
        const long long i = f.at(a, j);
        f.set(d, j, load(t, i < 0 ? 0 : (i > hi ? hi : i)), f.ok(a, j));
      });
      return;
    }
    case CONST: rows<R>([&](int j) { f.set(d, j, in.imm, true); }); return;
    case NULLV: rows<R>([&](int j) { f.set(d, j, 0, false); }); return;
    case ISNULL: rows<R>([&](int j) { f.set(d, j, !f.ok(a, j), true); }); return;
    case NOTNULL: rows<R>([&](int j) { f.set(d, j, f.ok(a, j), true); }); return;
    case NOT: rows<R>([&](int j) { f.set(d, j, f.at(a, j) == 0, f.ok(a, j)); }); return;
    case AND:  // Kleene logic: NULL AND FALSE is FALSE
      rows<R>([&](int j) {
        const bool x = f.at(a, j) != 0, y = f.at(b, j) != 0, vx = f.ok(a, j), vy = f.ok(b, j);
        f.set(d, j, x && vx && y && vy, (vx && vy) || (vx && !x) || (vy && !y));
      });
      return;
    case OR:  // NULL OR TRUE is TRUE
      rows<R>([&](int j) {
        const bool x = f.at(a, j) != 0, y = f.at(b, j) != 0, vx = f.ok(a, j), vy = f.ok(b, j);
        f.set(d, j, (x && vx) || (y && vy), (vx && vy) || (vx && x) || (vy && y));
      });
      return;
    case SEL:  // a: the condition, b: its value, c: the value otherwise
      rows<R>([&](int j) {
        const bool m = f.at(a, j) != 0 && f.ok(a, j);
        f.set(d, j, m ? f.at(b, j) : f.at(c, j), m ? f.ok(b, j) : f.ok(c, j));
      });
      return;
    case COAL:
      rows<R>([&](int j) {
        const bool m = f.ok(a, j);
        f.set(d, j, m ? f.at(a, j) : f.at(b, j), m || f.ok(b, j));
      });
      return;
    case NULLIF:  // a's value, NULL where b (a == b, with its validity) holds
      rows<R>([&](int j) {
        f.set(d, j, f.at(a, j), f.ok(a, j) && !(f.at(b, j) != 0 && f.ok(b, j)));
      });
      return;
    default:
      switch (in.op & 7) {
        case kBool: typed<kBool, R>(fam, in, f); return;
        case kU8: typed<kU8, R>(fam, in, f); return;
        case kI8: typed<kI8, R>(fam, in, f); return;
        case kI16: typed<kI16, R>(fam, in, f); return;
        case kI32: typed<kI32, R>(fam, in, f); return;
        case kI64: typed<kI64, R>(fam, in, f); return;
        case kF32: typed<kF32, R>(fam, in, f); return;
        default: typed<kF64, R>(fam, in, f); return;
      }
  }
}

// Each thread takes R rows a step, kThreads apart (so each of a warp's
// loads and stores is consecutive), decodes each instruction once for
// them, and keeps its registers in the block's shared memory.
template <bool kFilter, int R>
__global__ void __launch_bounds__(kThreads) expr_program(const __grid_constant__ Program p) {
  extern __shared__ long long regs[];  // [program registers][R][kThreads]
  File<R> f;
  f.base = regs + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads * R;
  int kept = 0;
  for (long long base = (long long)blockIdx.x * kThreads * R + threadIdx.x; base < p.n;
       base += stride) {
    rows<R>([&](int j) {
      const long long row = base + (long long)j * kThreads;
      f.v[j] = 0;
      if (row < p.n) {
        for (int i = 0; i < p.nin; ++i) {
          // an input read only by IS [NOT] NULL comes without its values
          f.at(i, j) = p.in[i].data != nullptr ? load(p.in[i], row) : 0;
          if (p.in[i].mask == nullptr || __ldg(p.in[i].mask + row) != 0) f.v[j] |= 1u << i;
        }
      }
    });
    // rows past n compute on whatever their registers hold: no operation
    // traps, and nothing of them is stored
    for (int k = 0; k < p.ninstr; ++k) step<R>(p, p.ins[k], f);
    rows<R>([&](int j) {
      const long long row = base + (long long)j * kThreads;
      if (row >= p.n) return;
      if constexpr (kFilter) {
        const int reg = p.out[0].reg;
        const bool real = p.row_valid != nullptr ? __ldg(p.row_valid + row) != 0 : row < p.nrows;
        const bool keep = f.at(reg, j) != 0 && f.ok(reg, j) && real;
        p.keep[row] = keep;
        kept += keep;
      } else {
        for (int o = 0; o < p.nout; ++o) {
          const Output& out = p.out[o];
          store(out, row, f.at(out.reg, j));
          if (out.mask != nullptr) out.mask[row] = f.ok(out.reg, j);
        }
      }
    });
  }
  if constexpr (kFilter) {  // the block's kept rows, then one atomic a block
    __shared__ int block_kept;
    if (threadIdx.x == 0) block_kept = 0;
    __syncthreads();
    kept = __reduce_add_sync(0xffffffffu, kept);
    if ((threadIdx.x & 31) == 0 && kept != 0) atomicAdd(&block_kept, kept);
    __syncthreads();
    if (threadIdx.x == 0 && block_kept != 0) atomicAdd(p.count, block_kept);
  }
}

template <bool kFilter>
const void* kernel_for(int rows_per_thread) {
  switch (rows_per_thread) {
    case 4: return reinterpret_cast<const void*>(expr_program<kFilter, 4>);
    case 2: return reinterpret_cast<const void*>(expr_program<kFilter, 2>);
    default: return reinterpret_cast<const void*>(expr_program<kFilter, 1>);
  }
}

}  // namespace

// K6. Inputs q: (in_data[q] or null where only its mask is read, in_mask[q]
// or null, in_code[q]); instruction
// k: ops[k] (family * 8 + dtype code), regs[4k .. 4k + 3] (dst, a, b, c)
// and imms[k]; outputs o: out_data[o] and out_mask[o] or null, of dtype
// out_code[o], from register out_reg[o]; the program has nregs registers.
// Table t: tab_data[t], tab_len[t] entries (at least 1) of dtype
// tab_code[t] (bool, int32 or int64). With keep non-null the launch is
// a filter: output 0 is the condition, keep (bool [n]) gets the kept rows
// and count (int32, zeroed by the caller) their number; rows are real
// below nrows, or where row_valid is non-zero when nrows is -1. device is
// the CUDA ordinal of the tensors, stream a cudaStream_t of it. Returns a
// cudaError_t.
extern "C" int fugue_expr_program(long long n, long long nrows, const void* row_valid, int nin,
                                  const void* const* in_data, const void* const* in_mask,
                                  const int* in_code, int ninstr, const int* ops,
                                  const int* regs, const long long* imms, int nout,
                                  void* const* out_data, void* const* out_mask,
                                  const int* out_code, const int* out_reg, int nregs,
                                  int ntab, const void* const* tab_data,
                                  const long long* tab_len, const int* tab_code,
                                  void* keep, void* count, int device, void* stream) {
  if (n < 1 || nin < 0 || nin > kMaxInputs || ninstr < 0 || ninstr > kMaxInstrs ||
      nregs < 1 || nregs > kMaxRegs || nin > nregs ||
      nout < 1 || nout > kMaxOutputs || ntab < 0 || ntab > kMaxTables ||
      (keep != nullptr && (nout != 1 || count == nullptr)) ||
      (keep != nullptr && nrows < 0 && row_valid == nullptr))
    return (int)cudaErrorInvalidValue;
  Program p = {};
  p.n = n;
  p.nrows = nrows;
  p.row_valid = static_cast<const uint8_t*>(row_valid);
  p.keep = static_cast<uint8_t*>(keep);
  p.count = static_cast<int*>(count);
  p.nin = nin;
  p.ninstr = ninstr;
  p.nout = nout;
  p.ntab = ntab;
  for (int t = 0; t < ntab; ++t) {
    if (tab_data[t] == nullptr || tab_len[t] < 1 ||
        (tab_code[t] != kBool && tab_code[t] != kI32 && tab_code[t] != kI64))
      return (int)cudaErrorInvalidValue;
    p.tab[t] = {tab_data[t], nullptr, tab_code[t]};
    p.tab_len[t] = tab_len[t];
  }
  for (int q = 0; q < nin; ++q) {
    if (in_code[q] < kBool || in_code[q] > kF64) return (int)cudaErrorInvalidValue;
    p.in[q] = {in_data[q], static_cast<const uint8_t*>(in_mask[q]), in_code[q]};
  }
  for (int k = 0; k < ninstr; ++k) {
    const int fam = ops[k] >> 3;
    if (ops[k] < 0 || fam >= kFamilies) return (int)cudaErrorInvalidValue;
    // every field read as a register names one of the program's; CAST's b
    // is a dtype code, ROUND's a flag and LUT's a table of the op's dtype
    for (int j = 0; j < 4; ++j) {
      const int reg = regs[4 * k + j];
      const bool code = j == 2 && (fam == CAST || fam == ROUND);
      const int limit = j == 2 && fam == LUT ? ntab : code ? 8 : nregs;
      if (reg < 0 || reg >= limit) return (int)cudaErrorInvalidValue;
    }
    if (fam == LUT && tab_code[regs[4 * k + 2]] != (ops[k] & 7))
      return (int)cudaErrorInvalidValue;
    p.ins[k] = {ops[k], (unsigned char)regs[4 * k], (unsigned char)regs[4 * k + 1],
                (unsigned char)regs[4 * k + 2], (unsigned char)regs[4 * k + 3], imms[k]};
  }
  for (int o = 0; o < nout; ++o) {
    if (out_code[o] < kBool || out_code[o] > kF64 || out_reg[o] < 0 || out_reg[o] >= nregs)
      return (int)cudaErrorInvalidValue;
    p.out[o] = {out_data[o], static_cast<uint8_t*>(out_mask[o]), out_code[o], out_reg[o]};
  }
  // rows a thread takes a step: as many as keep the registers of a block
  // within 64 KB of shared memory, up to 4
  const int rows_per_thread = nregs <= 8 ? 4 : nregs <= 16 ? 2 : 1;
  const size_t smem = (size_t)nregs * rows_per_thread * kThreads * sizeof(long long);
  return (int)on_device(device, [&]() -> cudaError_t {
    const void* fn = keep != nullptr ? kernel_for<true>(rows_per_thread)
                                     : kernel_for<false>(rows_per_thread);
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    // up to 64 KB, above the 48 KB a launch gets by default
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    if (err != cudaSuccess) return err;
    const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long need = (n + (long long)kThreads * rows_per_thread - 1) /
                           ((long long)kThreads * rows_per_thread);
    const int grid = (int)(need < wave ? need : wave);
    void* args[] = {&p};
    err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem,
                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  });
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* fugue_expr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
