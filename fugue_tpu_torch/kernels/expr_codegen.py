"""K6 ``expr_program`` as generated code: one CUDA kernel for each compiled
``Program`` structure, built with ``nvcc`` at first use.

The JAX package has XLA compile each expression program
(``_filter_prog``, ``_assign_prog``, ``_project_prog`` over
``expr_eval._eval``, ``fugue_tpu/jax_backend/expr_eval.py:109``) into
one fused elementwise pass. Here ``generate`` turns a program's
structure into the source of one kernel that does the same:

- **Values** are locals in their own C types (``float``, ``double``,
  ``signed char``, ..., ``bool``), one a value (static single
  assignment over the program's allocated registers), so they live in
  hardware registers and no instruction is decoded at run time.
- **Validity** is one ``bool`` a value; where a value cannot be null it
  is the constant ``true`` and costs nothing.
- **Loads**: each input and its mask are read once a row, a mask-only
  input's values never, a mask no output keeps never. Where every
  column's address allows it, a thread takes 4 consecutive rows (2 where
  a column is 8 bytes wide) and reads each column's in one vector
  access of at most 16 bytes (the vector path); otherwise, as on a
  slice's view, it takes ``kRows`` rows ``blockDim.x`` apart with scalar
  accesses, all loaded before any is computed (the scalar path). Each
  path is its own entry point. One block takes one tile of rows and the
  grid covers them all at once (measured faster than one resident wave
  looping over the rows); a grid-stride loop takes any rest.
- **Stores**: each output and its mask once, vectors as the loads.
  Filter mode writes keep = value AND valid AND the row is real (below
  ``nrows``, or where ``row_valid`` holds) and adds the block's kept
  rows to one counter (a warp sum, then one atomic a block). An output
  whose validity is an input's mask, unchanged, takes that mask tensor
  as its own (``mask_aliases``; the twin's does the same) and stores
  none.
- **Tables**: a LUT reads its table through ``__ldg``: a dictionary's
  table stays in L1 and L2. Staging the tables in shared memory was
  measured (PERF.md) at most 4 % faster on tables up to 48 KB and
  40 % slower on a 200 KB one, and each block of a full grid would copy
  them again.
- **Semantics** come from ``expr_ops.cuh``: the generated code calls its
  functions (wrap, casts, ``_rn`` float arithmetic, MOD, ROUND, Kleene
  AND/OR, the LUT clamp) and re-derives none of them. Float ``+ - * /``
  go through ``__fadd_rn`` and the rest, so ``nvcc`` neither contracts
  ``a * b + c`` into an FMA nor folds ``x + 0``, whatever the flags.

**Parameters, not source**: the row count, the pointers, the tables'
pointers and lengths and every immediate (CONST values, ROUND's factor)
travel in one ``__grid_constant__`` struct of 8-byte fields. So the key
(``structure``) covers the structure only (dtypes, masks, opcodes,
register wiring, outputs, table dtypes, mode): ``v < 0.9`` and
``v < 0.5`` share one binary, and a literal divisor stays a true
division. A struct over ``PARAM_LIMIT`` bytes (the most a launch takes)
goes to device memory instead, and the kernel reads it there.

The source of one kernel has two parts: ``device_part``, a namespace
with the ``Params``, ``Row`` and ``Out`` structs and the ``__device__``
functions ``load``/``loadv``, ``row`` (one row's program) and
``store``/``storev``; then the row loops, the filter's count and the
``extern "C" __global__`` entries named ``expr_program_<digest>`` (the
vector path) and ``expr_program_<digest>_scalar`` (the profiler
attributes their time to K6). A host build of ``device_part``
under a header that maps the CUDA intrinsics to C++ runs the same
program on the CPU (``tests/test_torch_expr_codegen.py``).
"""

import hashlib
import re
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from fugue_tpu_torch.kernels import expr_program as ep

MODES = ("columns", "prefix", "row_valid")
PARAM_LIMIT = 32764  # the most bytes of parameters one launch takes
THREADS = 256
SCALAR = "_scalar"  # the name of a kernel's scalar entry point: its name + this
# nvcc's flags for a generated kernel: device code only, to a cubin
CUBIN_FLAGS = ("-arch=sm_90a", "-cubin", "-O3", "-std=c++17")
HEADER = Path(__file__).resolve().parent / "expr_ops.cuh"

# each dtype code's C type, and how it lies in memory (a bool as a byte)
_C = {ep.B: "bool", ep.U8: "unsigned char", ep.I8: "signed char", ep.I16: "short",
      ep.I32: "int", ep.I64: "long long", ep.F32: "float", ep.F64: "double"}
_MEM = {**_C, ep.B: "unsigned char"}
_SIZE = {ep.B: 1, ep.U8: 1, ep.I8: 1, ep.I16: 2, ep.I32: 4, ep.I64: 8, ep.F32: 4, ep.F64: 8}

_BINARY = {"ADD": "add", "SUB": "sub", "MUL": "mul", "DIV": "div", "POW": "pow_"}
_COMPARE = {"EQ": "eq", "NE": "ne", "LT": "lt", "LE": "le", "GT": "gt", "GE": "ge"}
_UNARY = {"NEG": "neg", "ABS": "abs_", "SIGN": "sign", "FLOOR": "floor_", "CEIL": "ceil_",
          "SQRT": "sqrt_", "EXP": "exp_", "LN": "ln_", "LOG2": "log2_", "LOG10": "log10_",
          "SIN": "sin_", "COS": "cos_", "TAN": "tan_"}

Structure = Tuple


def structure(program: "ep.Program", masked: Sequence[bool], mode: str) -> Structure:
    """The key of ``program``'s kernel: everything the generated source
    depends on and nothing else. ``masked`` flags the inputs that come
    with a null mask; ``mode`` is one of ``MODES``. Immediates and the
    tables' contents and lengths are parameters, so they are not in it."""
    return (
        mode,
        tuple(code for _, code in program.inputs),
        tuple(bool(m) for m in masked),
        tuple(program.mask_only),
        tuple((i.op, i.dtype, i.dst, i.a, i.b, i.c) for i in program.instrs),
        tuple((o.reg, o.dtype, o.masked) for o in program.outputs),
        tuple(ep.CODES[t.dtype] for t in program.tables),
    )


class Kernel(NamedTuple):
    """One generated kernel. ``fields`` lists the ``Params`` struct's
    8-byte fields in order, each ``(kind, index)``: ``n``, ``nrows``,
    ``row_valid``, ``keep``, ``count``, ``in``/``inm`` (input ``index``'s
    values and mask), ``out``/``outm``, ``tab``/``tablen`` (table
    ``index``'s pointer and entries) and ``imm`` (instruction ``index``'s
    immediate). ``indirect``: the struct is passed by a device pointer.
    A thread takes ``rows_per_thread`` rows on the scalar path,
    ``vec_width`` consecutive rows on the vector path. ``mask_aliases``:
    for each output, the input whose mask it has unchanged (that tensor
    is the output's mask and the kernel writes none), else None.
    ``bytes_per_row``: what a row loads and stores, each once."""

    name: str
    namespace: str
    source: str
    device_part: str
    fields: Tuple[Tuple[str, Optional[int]], ...]
    indirect: bool
    rows_per_thread: int
    vec_width: int
    mode: str
    mask_aliases: Tuple[Optional[int], ...]
    bytes_per_row: int


_HEADER_TEXT: List[str] = []


def header_text() -> str:
    if not _HEADER_TEXT:
        _HEADER_TEXT.append(HEADER.read_text())
    return _HEADER_TEXT[0]


def _conj(*parts: str) -> str:
    """``a && b && ...`` of validity expressions, folding the constants."""
    if "false" in parts:
        return "false"
    rest = [p for p in parts if p != "true"]
    if not rest:
        return "true"
    return rest[0] if len(rest) == 1 else "(" + " && ".join(rest) + ")"


_DEF = re.compile(r"^  const .+? (\w+) = (.*);$")
_LOCAL = re.compile(r"\b(?:t|mt|c|a|ma)\d+\b")


def _prune(lines: List[str]) -> List[str]:
    """The row's body without the definitions nothing reads (a constant
    whose COALESCE was decided, a validity no output keeps): straight-line
    code the compiler would drop too, but only after inlining it."""
    defs: Dict[str, int] = {}
    reads: List[List[str]] = []
    refs: Counter = Counter()
    for i, line in enumerate(lines):
        m = _DEF.match(line)
        names = _LOCAL.findall(m.group(2) if m else line)
        if m:
            defs[m.group(1)] = i
        reads.append(names)
        refs.update(names)
    dead = set()
    work = [name for name in defs if refs[name] == 0]
    while work:
        i = defs[work.pop()]
        if i in dead:
            continue
        dead.add(i)
        for name in reads[i]:
            refs[name] -= 1
            if refs[name] == 0 and name in defs:
                work.append(name)
    return [line for i, line in enumerate(lines) if i not in dead]


class _Gen:
    def __init__(self, key: Structure):
        (self.mode, self.in_codes, self.in_masked, self.mask_only, self.instrs,
         self.outputs, self.tab_codes) = key
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}: one of {MODES}")
        self.fields: List[Tuple[str, Optional[int]]] = []
        self.members: List[str] = []
        self.body: List[str] = []
        # physical register -> (C expression, dtype code, validity expression)
        self.regs: Dict[int, Tuple[str, int, str]] = {}

    def field(self, kind: str, index: Optional[int], ctype: str) -> str:
        name = kind if index is None else f"{kind}{index}"
        self.fields.append((kind, index))
        self.members.append(f"  {ctype} {name};")
        return f"p.{name}"

    def read(self, reg: int, *dtypes: int) -> Tuple[str, int, str]:
        if reg not in self.regs:
            raise ValueError(f"register r{reg} is read before it is written")
        v = self.regs[reg]
        if dtypes and v[1] not in dtypes:
            raise ValueError(f"register r{reg} is {ep._NAMES[v[1]]}, expected "
                             f"{'/'.join(ep._NAMES[d] for d in dtypes)}")
        return v

    def define(self, k: int, reg: int, dtype: int, value: str, valid: str) -> None:
        if _LOCAL.fullmatch(value) and valid in ("true", "false") + tuple(
                v for _, _, v in self.regs.values()):
            self.regs[reg] = (value, dtype, valid)  # a copy: the same local
            return
        self.body.append(f"  const {_C[dtype]} t{k} = {value};")
        if valid not in ("true", "false") and not _LOCAL.fullmatch(valid):
            self.body.append(f"  const bool mt{k} = {valid};")
            valid = f"mt{k}"
        self.regs[reg] = (f"t{k}", dtype, valid)

    def instr(self, k: int, ins: Tuple[int, int, int, int, int, int]) -> None:
        op_i, d, dst, ra, rb, rc = ins
        op = ep.OPS[op_i]
        T = _C[d]
        f = "fugue::k6::"
        if op == "CONST":
            imm = self.field("imm", k, "long long")
            return self.define(k, dst, d, f"{f}from_bits<{T}>({imm})", "true")
        if op == "NULL":
            return self.define(k, dst, d, f"({T})0", "false")
        if op == "LUT":
            a, _, va = self.read(ra, ep.U8, ep.I8, ep.I16, ep.I32, ep.I64)
            if self.tab_codes[rb] != d:
                raise ValueError(f"LUT of {ep._NAMES[d]} over a table of "
                                 f"{ep._NAMES[self.tab_codes[rb]]}")
            read = f"{f}lut<{_MEM[d]}>(p.tab{rb}, p.tablen{rb}, (long long){a})"
            return self.define(k, dst, d, read + (" != 0" if d == ep.B else ""), va)
        if op in ("ISNULL", "NOTNULL"):
            _, _, va = self.read(ra)
            value = va if op == "NOTNULL" else (
                {"true": "false", "false": "true"}.get(va, f"!{va}"))
            return self.define(k, dst, ep.B, value, "true")
        if op in ("AND", "OR"):
            (a, _, va), (b, _, vb) = self.read(ra, ep.B), self.read(rb, ep.B)
            fam = op.lower()
            return self.define(k, dst, ep.B, f"{f}{fam}_value({a}, {va}, {b}, {vb})",
                               f"{f}{fam}_valid({a}, {va}, {b}, {vb})")
        if op == "NOT":
            a, _, va = self.read(ra, ep.B)
            return self.define(k, dst, ep.B, f"{f}not_({a})", va)
        if op == "SEL":
            c, _, vc = self.read(ra, ep.B)
            (b, _, vb), (e, _, ve) = self.read(rb, d), self.read(rc, d)
            self.body.append(f"  const bool c{k} = {f}sel_cond({c}, {vc});")
            valid = vb if vb == ve else f"(c{k} ? {vb} : {ve})"
            return self.define(k, dst, d, f"c{k} ? {b} : {e}", valid)
        if op == "COAL":
            (a, _, va), (b, _, vb) = self.read(ra, d), self.read(rb, d)
            if va == "true":
                return self.define(k, dst, d, a, "true")
            if va == "false":
                return self.define(k, dst, d, b, vb)
            valid = "true" if vb == "true" else f"({va} || {vb})"
            return self.define(k, dst, d, f"{va} ? {a} : {b}", valid)
        if op == "NULLIF":
            (a, _, va), (b, _, vb) = self.read(ra, d), self.read(rb, ep.B)
            return self.define(k, dst, d, a, f"{f}nullif_valid({va}, {b}, {vb})")
        if op == "CAST":
            a, _, va = self.read(ra, d)
            return self.define(k, dst, rb, f"{f}cast<{_C[rb]}>({a})", va)
        if op == "ROUND":
            a, _, va = self.read(ra, d)
            imm = self.field("imm", k, "long long")
            return self.define(k, dst, d, f"{f}round_({a}, {f}from_bits<double>({imm}), "
                                          f"{'true' if rb else 'false'})", va)
        if op in _COMPARE:
            (a, _, va), (b, _, vb) = self.read(ra, d), self.read(rb, d)
            return self.define(k, dst, ep.B, f"{f}{_COMPARE[op]}({a}, {b})", _conj(va, vb))
        if op in _BINARY:
            (a, _, va), (b, _, vb) = self.read(ra, d), self.read(rb, d)
            return self.define(k, dst, d, f"{f}{_BINARY[op]}({a}, {b})", _conj(va, vb))
        if op == "MOD":
            (a, _, va), (b, _, vb) = self.read(ra, d), self.read(rb, d)
            return self.define(k, dst, d, f"{f}mod({a}, {b})", _conj(va, vb, f"{f}mod_ok({b})"))
        if op == "NANNULL":
            a, _, va = self.read(ra, d)
            return self.define(k, dst, d, f"{f}nannull({a})", _conj(va, f"{f}not_nan({a})"))
        if op in _UNARY:
            a, _, va = self.read(ra, d)
            return self.define(k, dst, d, f"{f}{_UNARY[op]}({a})", va)
        raise ValueError(f"no code for {op}")  # pragma: no cover - OPS are all above

    def generate(self, param_limit: int) -> Kernel:
        filt = self.mode != "columns"
        f = "fugue::k6::"
        self.field("n", None, "long long")
        if self.mode == "prefix":
            self.field("nrows", None, "long long")
        elif self.mode == "row_valid":
            self.field("row_valid", None, "const unsigned char*")
        if filt:
            self.field("keep", None, "unsigned char*")
            self.field("count", None, "int*")
        # the vector path's width: 4 consecutive rows a thread, or 2 where a
        # column is 8 bytes wide (16 bytes, one vector)
        wide = [c for c, m in zip(self.in_codes, self.mask_only) if not m]
        if not filt:
            wide += [d for _, d, _ in self.outputs]
        W = 2 if any(_SIZE[c] == 8 for c in wide) else 4

        # each input load: (member, its bytes, declaration, scalar load, vector load)
        row_loads: List[Tuple[str, int, str, str, str]] = []

        def load(member: str, ptr: str, ctype: str, flag: bool, size: int) -> None:
            scalar = f"{f}ld_flag({ptr} + r)" if flag else f"{f}ld({ptr} + r)"
            vector = (f"  {{\n    {'bool' if flag else ctype} w[{W}];\n    "
                      f"{f}ldv{'_flag' if flag else ''}<{W}>({ptr} + r, w);\n    "
                      + " ".join(f"x[{j}].{member} = w[{j}];" for j in range(W)) + "\n  }")
            row_loads.append((member, size, f"  {ctype} {member};", f"  x.{member} = {scalar};",
                              vector))

        for q, (code, masked, mask_only) in enumerate(zip(self.in_codes, self.in_masked,
                                                          self.mask_only)):
            value = f"({_C[code]})0"
            if not mask_only:
                load(f"v{q}", self.field("in", q, f"const {_MEM[code]}*"), _C[code],
                     code == ep.B, _SIZE[code])
                value = f"x.v{q}"
            valid = "true"
            if masked:
                load(f"m{q}", self.field("inm", q, "const unsigned char*"), "bool", True, 1)
                valid = f"x.m{q}"
            self.body.append(f"  const {_C[code]} a{q} = {value};")
            if valid != "true":
                self.body.append(f"  const bool ma{q} = {valid};")
                valid = f"ma{q}"
            self.regs[q] = (f"a{q}", code, valid)
        if self.mode == "row_valid":
            load("real", "p.row_valid", "bool", True, 1)
        out_members: List[str] = []
        stores: List[str] = []
        storesv: List[str] = []
        store_bytes = []

        def store(member: str, ptr: str, code: int) -> None:
            mem, ctype = _MEM[code], _C[code]
            store_bytes.append(_SIZE[code])
            out_members.append(f"  {ctype} {member};")
            stores.append(f"  {ptr}[r] = ({mem})y.{member};")
            storesv.append(f"  {{\n    const {mem} w[{W}] = {{"
                           + ", ".join(f"({mem})y[{j}].{member}" for j in range(W))
                           + f"}};\n    {f}stv<{W}>({ptr} + r, w);\n  }}")

        for t, code in enumerate(self.tab_codes):
            self.field("tab", t, f"const {_MEM[code]}*")
            self.field("tablen", t, "long long")
        for k, ins in enumerate(self.instrs):
            self.instr(k, ins)
        aliases: List[Optional[int]] = []
        if filt:
            if len(self.outputs) != 1 or self.outputs[0][1] != ep.B:
                raise ValueError("a filter program has one bool output")
            v, _, valid = self.read(self.outputs[0][0], ep.B)
            real = "(r < p.nrows)" if self.mode == "prefix" else "x.real"
            store("keep", "p.keep", ep.B)
            self.body.append(f"  y.keep = {_conj(v, valid, real)};")
            self.body.append("  return y.keep;")
        else:
            inputs_masks = {f"ma{q}": q for q, m in enumerate(self.in_masked) if m}
            for o, (reg, dtype, masked) in enumerate(self.outputs):
                v, _, valid = self.read(reg, dtype)
                store(f"v{o}", self.field("out", o, f"{_MEM[dtype]}*"), dtype)
                self.body.append(f"  y.v{o} = {v};")
                # an input's mask, unchanged, is the output's: not copied
                aliases.append(inputs_masks.get(valid) if masked else None)
                if masked and aliases[-1] is None:
                    store(f"m{o}", self.field("outm", o, "unsigned char*"), ep.B)
                    self.body.append(f"  y.m{o} = {valid};")
            self.body.append("  return false;")
        self.body = _prune(self.body)
        # loads no row reads go (a mask only an aliased output keeps)
        used = set(re.findall(r"\bx\.(\w+)", "\n".join(self.body)))
        row_loads = [ld for ld in row_loads if ld[0] in used]
        row_members = [ld[2] for ld in row_loads]
        loads = [ld[3] for ld in row_loads]
        loadsv = [ld[4] for ld in row_loads]
        row_bytes = sum(ld[1] for ld in row_loads)
        # scalar rows a thread a step: more loads in flight for narrow rows;
        # one copy of a long program's row code (it is inlined once a row)
        big = len(self.body) > 512
        rows = 1 if big or row_bytes > 96 else 2 if row_bytes > 32 else 4
        indirect = 8 * len(self.fields) > param_limit
        parts = dict(row=row_members, load=loads, loadv=loadsv, out=out_members, store=stores,
                     storev=storesv)
        return self._assemble(rows, W, indirect, parts, tuple(aliases),
                              row_bytes + sum(store_bytes))

    def _assemble(self, rows: int, W: int, indirect: bool,
                  parts: Dict[str, List[str]], aliases: Tuple[Optional[int], ...],
                  bytes_per_row: int) -> Kernel:
        filt = self.mode != "columns"
        nl = "\n"
        # a long program's row is called, not inlined into every row slot
        inline = "__noinline__" if rows == 1 and len(self.body) > 512 else "__forceinline__"
        device_part = f"""struct Params {{
{nl.join(self.members)}
}};

// one row's inputs, as loaded
struct Row {{
{nl.join(parts["row"]) or "  char unused;"}
}};

// one row's outputs, to be stored
struct Out {{
{nl.join(parts["out"])}
}};

__device__ __forceinline__ void load(const Params& p, long long r, Row& x) {{
  (void)p; (void)r; (void)x;
{nl.join(parts["load"])}
}}

// rows r .. r + {W - 1}, r a multiple of {W}, every pointer aligned for vectors
__device__ __forceinline__ void loadv(const Params& p, long long r, Row (&x)[{W}]) {{
  (void)p; (void)r; (void)x;
{nl.join(parts["loadv"])}
}}

__device__ __forceinline__ void store(const Params& p, long long r, const Out& y) {{
{nl.join(parts["store"])}
}}

__device__ __forceinline__ void storev(const Params& p, long long r, const Out (&y)[{W}]) {{
{nl.join(parts["storev"])}
}}

// the program over one row; returns whether a filter keeps it
__device__ {inline} bool row(const Params& p, long long r, const Row& x, Out& y) {{
  (void)p; (void)r; (void)x;
{nl.join(self.body)}
}}
"""
        if filt:
            epilogue = """  __shared__ int block_kept;
  if (threadIdx.x == 0) block_kept = 0;
  __syncthreads();
  kept = __reduce_add_sync(0xffffffffu, kept);
  if ((threadIdx.x & 31) == 0 && kept != 0) atomicAdd(&block_kept, kept);
  __syncthreads();
  if (threadIdx.x == 0 && block_kept != 0) atomicAdd(p.count, block_kept);"""
        else:
            epilogue = "  (void)kept;"
        body_part = f"""// scalar rows: kRows a thread a step, blockDim.x apart
__device__ __forceinline__ int rows(const Params& p) {{
  constexpr int kRows = {rows};
  const long long n = p.n;
  const long long step = (long long)gridDim.x * blockDim.x * kRows;
  int kept = 0;
  for (long long base = (long long)blockIdx.x * blockDim.x * kRows + threadIdx.x; base < n;
       base += step) {{
    Row x[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {{
      const long long r = base + (long long)j * blockDim.x;
      if (r < n) load(p, r, x[j]);
    }}
#pragma unroll
    for (int j = 0; j < kRows; ++j) {{
      const long long r = base + (long long)j * blockDim.x;
      if (r < n) {{
        Out y;
        kept += row(p, r, x[j], y);
        store(p, r, y);
      }}
    }}
  }}
  return kept;
}}

// vector rows: kW consecutive rows a thread a step, then the last n % kW
// rows one a thread of block 0
__device__ __forceinline__ int rowsv(const Params& p) {{
  constexpr int kW = {W};
  const long long n = p.n, nv = n / kW * kW;
  const long long step = (long long)gridDim.x * blockDim.x * kW;
  int kept = 0;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kW; r < nv;
       r += step) {{
    Row x[kW];
    Out y[kW];
    loadv(p, r, x);
#pragma unroll
    for (int j = 0; j < kW; ++j) kept += row(p, r + j, x[j], y[j]);
    storev(p, r, y);
  }}
  if (blockIdx.x == 0 && threadIdx.x < n - nv) {{
    const long long r = nv + threadIdx.x;
    Row x;
    Out y;
    load(p, r, x);
    kept += row(p, r, x, y);
    store(p, r, y);
  }}
  return kept;
}}

// the vector path where every row pointer is aligned for it, else the
// scalar path: two entry points, each with its own registers
template <bool kVector>
__device__ __forceinline__ void run(const Params& p) {{
  int kept;
  if constexpr (kVector) kept = rowsv(p);
  else kept = rows(p);
{epilogue}
}}
"""
        arg = "const Params* __restrict__ pp" if indirect else "const __grid_constant__ Params p"
        params = "*pp" if indirect else "p"
        digest = hashlib.sha256("\n".join(
            (device_part, body_part, arg, header_text(), " ".join(CUBIN_FLAGS))).encode())
        name = f"expr_program_{digest.hexdigest()[:20]}"
        ns = f"k6_{name[len('expr_program_'):]}"
        device_ns = f"namespace {ns} {{\n\n{device_part}\n}}  // namespace {ns}\n"
        entries = "".join(
            f"\nextern \"C\" __global__ void __launch_bounds__({THREADS}) {name}{suffix}(\n"
            f"    {arg.replace('Params', f'{ns}::Params')}) {{\n"
            f"  {ns}::run<{vector}>({params});\n}}\n"
            for suffix, vector in (("", "true"), (SCALAR, "false")))
        global_part = f"namespace {ns} {{\n\n{body_part}\n}}  // namespace {ns}\n{entries}"
        source = (f"// K6 expr_program, generated by fugue_tpu_torch/kernels/expr_codegen.py\n"
                  f"// for one program structure (mode {self.mode}).\n\n"
                  f"#include <stdint.h>\n\n#include \"expr_ops.cuh\"\n\n"
                  f"{device_ns}\n{global_part}")
        return Kernel(name, ns, source, device_ns, tuple(self.fields), indirect, rows, W,
                      self.mode, aliases, bytes_per_row)


def generate(key: Structure, param_limit: int = PARAM_LIMIT) -> Kernel:
    """The kernel of structure ``key`` (``structure``). Raises
    ``ValueError`` where the program reads a register before writing it
    or an operand's dtype is not its instruction's."""
    return _Gen(key).generate(param_limit)
