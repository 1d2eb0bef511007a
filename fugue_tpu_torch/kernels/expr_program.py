"""K6 ``expr_program``: column expressions compiled into one typed register
program, and the wrapper that runs it over a frame's rows on the card
(``expr_program.cu``).

The JAX package evaluates an expression tree (``expr_eval._eval``,
``fugue_tpu/jax_backend/expr_eval.py:109``) inside a jitted program
(``filter``'s ``_filter_prog``, ``assign``'s ``_assign_prog``,
``_device_project``'s ``_project_prog``), which XLA fuses into one
elementwise pass. Here the host compiles the trees once into a program
of instructions ``dst = op(a, b[, c])``, each with an opcode per
operation and dtype (``ADD_F32``, ``LT_I64``, ``CAST_F64`` to a target,
``AND_B`` in Kleene logic, ``SEL``, ...), and one launch of K6 runs it
over every row: it reads each input column and its mask once, keeps
values and validity in registers, and writes either every output column
with its mask (columns mode: ``assign``, a projection, an aggregate's
arguments) or a filter's keep flags and kept count (filter mode).

Types: each node computes in its DECLARED type (``_promote`` and
``infer_type`` of ``column/expressions.py``): both operands of ``a op b``
are cast to the promoted type first, a literal is an immediate of that
type (never a column), ``/`` and the float functions compute in float64,
and a cast anywhere in the tree is honoured. The JAX package computes in
jnp's types instead, which differ in four places (weak literals, int /
int in float32, inner casts dropped, float32 arguments of the float
functions); ROADMAP.md queue 3 lists them and the tests hold those cases
against numpy.

Numeric rules shared by the kernel and its twin
(``reference.expr_program_reference``, which interprets the same
program with torch ops): integer ``+ - * -x abs`` wrap in their type;
``mod`` truncates (the sign of the dividend), ``x mod 0`` is NULL and
``x mod -1`` is 0; a float becomes an integer by truncation, NaN as 0
and values beyond the type saturating at its bounds (what XLA does), and
a bool as ``x != 0``; ``round(x, d)`` is ``rint(x * 10^d) / 10^d`` for
``d >= 0`` and ``rint(x / 10^-d) * 10^-d`` below (numpy's formula);
``sign`` keeps NaN and a zero's sign; ``floor``, ``ceil`` and ``sign``
of a float are int64 with NaN as NULL.

A program over the caps (``MAX_INSTRS`` instructions, ``MAX_REGS``
registers, ``MAX_INPUTS`` inputs, ``MAX_OUTPUTS`` outputs) raises
``NotImplementedError`` naming ROADMAP.md queue 2 item 17, on the card
and on the CPU alike.
"""

import ctypes
import math
import struct
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from fugue_tpu_torch.column.expressions import (
    ColumnExpr,
    _BinaryOpExpr,
    _FuncExpr,
    _LitColumnExpr,
    _NamedColumnExpr,
    _promote,
    _UnaryOpExpr,
)
from fugue_tpu_torch.kernels import build

MAX_INSTRS = 64
MAX_REGS = 32
MAX_INPUTS = 16
MAX_OUTPUTS = 16

STRINGS = "ROADMAP.md queue 1 item 1 (string columns)"
HOST_ENGINE = "ROADMAP.md queue 1 item 2(b) (the host engine)"
OVER_CAPS = "ROADMAP.md queue 2 item 17 (K6 programs over the caps)"

# dtype codes of bin_keys.cuh
B, U8, I8, I16, I32, I64, F32, F64 = range(8)
CODES = {
    torch.bool: B, torch.uint8: U8, torch.int8: I8, torch.int16: I16,
    torch.int32: I32, torch.int64: I64, torch.float32: F32, torch.float64: F64,
}
DTYPES = {c: t for t, c in CODES.items()}
_NAMES = ("B", "U8", "I8", "I16", "I32", "I64", "F32", "F64")
_PA = {
    B: pa.bool_(), U8: pa.uint8(), I8: pa.int8(), I16: pa.int16(),
    I32: pa.int32(), I64: pa.int64(), F32: pa.float32(), F64: pa.float64(),
}
_FROM_PA = {t: c for c, t in _PA.items()}
_INTS = (U8, I8, I16, I32, I64)
_FLOATS = (F32, F64)

# operation families; the opcode is family * 8 + the dtype code of the
# operands (expr_program.cu reads the same numbers)
OPS = (
    "CONST", "NULL", "ADD", "SUB", "MUL", "DIV", "MOD", "POW", "NEG", "ABS",
    "EQ", "NE", "LT", "LE", "GT", "GE", "AND", "OR", "NOT", "ISNULL", "NOTNULL",
    "CAST", "SEL", "COAL", "NULLIF", "FLOOR", "CEIL", "SIGN", "NANNULL",
    "SQRT", "EXP", "LN", "LOG2", "LOG10", "SIN", "COS", "TAN", "ROUND",
)
OP = {name: i for i, name in enumerate(OPS)}
_CMP = {"==": "EQ", "!=": "NE", "<": "LT", "<=": "LE", ">": "GT", ">=": "GE"}
_ARITH = {"+": "ADD", "-": "SUB", "*": "MUL", "/": "DIV"}
_FLOAT_FUNCS = {
    "sqrt": "SQRT", "exp": "EXP", "ln": "LN", "log": "LN", "log2": "LOG2",
    "log10": "LOG10", "sin": "SIN", "cos": "COS", "tan": "TAN",
}
_STRING_FUNCS = (
    "like", "length", "len", "upper", "ucase", "lower", "lcase", "trim", "ltrim",
    "rtrim", "reverse", "substring", "substr", "replace", "concat",
)
# the (family, dtype) pairs the kernel implements
_ANY = tuple(range(8))
_NUM = _INTS + _FLOATS
_VALID = {
    "CONST": _ANY, "NULL": _ANY, "ADD": _ANY, "SUB": _NUM, "MUL": _ANY, "DIV": (F64,),
    "MOD": _NUM, "POW": (F64,), "NEG": _NUM, "ABS": _ANY,
    **{c: _ANY for c in ("EQ", "NE", "LT", "LE", "GT", "GE")},
    "AND": (B,), "OR": (B,), "NOT": (B,), "ISNULL": _ANY, "NOTNULL": _ANY,
    "CAST": _ANY, "SEL": _ANY, "COAL": _ANY, "NULLIF": _ANY,
    "FLOOR": _FLOATS, "CEIL": _FLOATS, "SIGN": _NUM, "NANNULL": _FLOATS,
    **{c: (F64,) for c in _FLOAT_FUNCS.values()}, "ROUND": (F64,),
}


class Refused(NotImplementedError):
    """An expression K6 does not evaluate: ``what`` it is and the
    ROADMAP.md ``item`` that ports it."""

    def __init__(self, what: str, item: str):
        super().__init__(f"{what} on the card is not ported yet; see {item}")
        self.what = what
        self.item = item


class Instr(NamedTuple):
    """``dst = op(a, b, c)`` over registers of the operands' ``dtype``.
    ``imm`` is a CONST's value (a Python scalar already in ``dtype``) or
    ROUND's factor; CAST's target dtype is ``b``; ROUND divides first
    where ``b`` is 1."""

    op: int
    dtype: int
    dst: int
    a: int = 0
    b: int = 0
    c: int = 0
    imm: Any = 0

    @property
    def opcode(self) -> int:
        return self.op * 8 + self.dtype

    def imm_bits(self) -> int:
        """``imm`` as the kernel's 64-bit register: floats by their bits
        (float32's in the low half), integers sign-extended, uint8 and
        bool zero-extended."""
        if self.op == OP["ROUND"] or (self.op == OP["CONST"] and self.dtype == F64):
            return struct.unpack("<q", struct.pack("<d", float(self.imm)))[0]
        if self.op == OP["CONST"] and self.dtype == F32:
            return struct.unpack("<I", struct.pack("<f", float(self.imm)))[0]
        return int(self.imm)

    def __str__(self) -> str:
        name = f"{OPS[self.op]}_{_NAMES[self.dtype]}"
        if self.op == OP["CONST"]:
            return f"r{self.dst} = {name} {self.imm!r}"
        if self.op == OP["CAST"]:
            return f"r{self.dst} = {name}->{_NAMES[self.b]} r{self.a}"
        if self.op == OP["ROUND"]:
            return f"r{self.dst} = {name} r{self.a} {'/' if self.b else '*'}{self.imm!r}"
        return f"r{self.dst} = {name} " + " ".join(f"r{r}" for r in reads(self))


class Output(NamedTuple):
    reg: int
    dtype: int
    masked: bool  # the result has a null mask (else every row is valid)


class Program(NamedTuple):
    """A compiled program: registers ``0 .. len(inputs) - 1`` start as the
    input columns (``inputs``: their names and dtype codes), then
    ``instrs`` run in order; ``outputs`` are read at the end. A filter
    program has one bool output, the condition. ``mask_only`` flags the
    inputs read only by IS [NOT] NULL, whose values are never loaded."""

    inputs: Tuple[Tuple[str, int], ...]
    instrs: Tuple[Instr, ...]
    outputs: Tuple[Output, ...]
    nregs: int
    mask_only: Tuple[bool, ...]

    def __str__(self) -> str:
        ins = ", ".join(f"r{i}={n}:{_NAMES[c]}" for i, (n, c) in enumerate(self.inputs))
        outs = ", ".join(f"r{o.reg}:{_NAMES[o.dtype]}{'?' if o.masked else ''}"
                         for o in self.outputs)
        body = "\n".join(f"  {i}" for i in self.instrs)
        return f"inputs {ins}\n{body}\noutputs {outs}"


_NP = {U8: np.uint8, I8: np.int8, I16: np.int16, I32: np.int32, I64: np.int64}


def int_bounds(code: int) -> Tuple[int, int]:
    info = np.iinfo(_NP[code])
    return int(info.min), int(info.max)


def cast_scalar(v: Any, src: int, dst: int) -> Any:
    """A Python scalar of dtype ``src`` converted to ``dst`` by the
    program's cast rule (the compiler folds casts of literals with it)."""
    if dst == B:
        return bool(v != 0)
    if dst in _FLOATS:
        if src in _FLOATS:
            x = float(v)
        else:
            x = float(np.asarray(int(v), dtype=np.int64).astype(
                np.float32 if dst == F32 else np.float64))
        return float(np.float32(x)) if dst == F32 else x
    lo, hi = int_bounds(dst)
    if src in _FLOATS:
        x = float(v)
        if math.isnan(x):
            return 0
        if x >= hi + 1:
            return hi
        if x < lo:
            return lo
        return int(x)  # truncates toward zero, in range
    return int(np.asarray(int(v), dtype=np.int64).astype(_NP[dst]))


class _Val(NamedTuple):
    """A compiled node: its virtual register and dtype code, whether it
    has a mask, whether it is the NULL literal, and a constant's value."""

    reg: int
    dtype: int
    masked: bool
    null: bool = False
    const: Any = None


# registers each family reads, in the order a, b, c
_NARGS = {
    **dict.fromkeys(("CONST", "NULL"), 0),
    **dict.fromkeys(("ADD", "SUB", "MUL", "DIV", "MOD", "POW", "EQ", "NE", "LT", "LE", "GT",
                     "GE", "AND", "OR", "COAL", "NULLIF"), 2),
    **dict.fromkeys(("NEG", "ABS", "NOT", "ISNULL", "NOTNULL", "CAST", "FLOOR", "CEIL", "SIGN",
                     "NANNULL", "SQRT", "EXP", "LN", "LOG2", "LOG10", "SIN", "COS", "TAN",
                     "ROUND"), 1),
    "SEL": 3,
}


_BOOL_RESULTS = ("EQ", "NE", "LT", "LE", "GT", "GE", "ISNULL", "NOTNULL")


def reads(ins: Instr) -> Tuple[int, ...]:
    """The registers an instruction reads."""
    return (ins.a, ins.b, ins.c)[: _NARGS[OPS[ins.op]]]


class _Compiler:
    """Expression trees -> instructions over virtual registers (one per
    value, common subexpressions and constants shared), then a linear-scan
    allocation onto ``MAX_REGS`` registers."""

    def __init__(self, columns: Dict[str, Tuple[int, bool]]):
        self.columns = columns  # name -> (dtype code, has a mask)
        self.inputs: Dict[str, _Val] = {}
        self.code: List[Instr] = []
        self.nvirt = 0
        self.memo: Dict[Any, _Val] = {}

    def _emit(self, op: str, dtype: int, *args: int, imm: Any = 0, b: Optional[int] = None,
              masked: bool = False) -> _Val:
        """``op`` over operands of ``dtype``; the value is of ``dtype`` too,
        but bool for a comparison or a null test and ``b`` for a CAST."""
        regs = list(args) + [0] * (3 - len(args))
        if b is not None:
            regs[1] = b
        ins = Instr(OP[op], dtype, self.nvirt, regs[0], regs[1], regs[2], imm)
        key = (ins.opcode, tuple(regs), ins.imm_bits())
        if key not in self.memo:
            out = B if op in _BOOL_RESULTS else regs[1] if op == "CAST" else dtype
            self.nvirt += 1
            self.code.append(ins)
            self.memo[key] = _Val(ins.dst, out, masked, const=imm if op == "CONST" else None)
        return self.memo[key]

    def const(self, value: Any, dtype: int) -> _Val:
        return self._emit("CONST", dtype, imm=value)

    def null(self, dtype: int) -> _Val:
        return self._emit("NULL", dtype, masked=True)._replace(null=True)

    def cast(self, v: _Val, dtype: int) -> _Val:
        if v.dtype == dtype:
            return v
        if v.null:
            return self.null(dtype)
        if v.const is not None:
            return self.const(cast_scalar(v.const, v.dtype, dtype), dtype)
        return self._emit("CAST", v.dtype, v.reg, b=dtype, masked=v.masked)

    def promote(self, a: _Val, b: _Val, op: str, what: Any) -> int:
        """The type ``a op b`` computes in: ``_promote``'s, or the other
        side's beside a NULL literal."""
        if a.null and b.null:
            return F64
        if a.null or b.null:
            return b.dtype if a.null else a.dtype
        tp = _promote(_PA[a.dtype], _PA[b.dtype], op)
        if tp not in _FROM_PA:
            raise Refused(f"{what} ({_PA[a.dtype]} {op} {_PA[b.dtype]} has no declared type)",
                          HOST_ENGINE)
        return _FROM_PA[tp]

    def node(self, e: ColumnExpr) -> _Val:
        v = self._node(e)
        if e.as_type is not None:
            if e.as_type not in _FROM_PA:
                raise Refused(f"cast to {e.as_type}", STRINGS)
            v = self.cast(v, _FROM_PA[e.as_type])
        return v

    def _node(self, e: ColumnExpr) -> _Val:
        if isinstance(e, _NamedColumnExpr):
            if e.name not in self.columns:
                raise ValueError(f"{e.name} not available on device")
            if e.name not in self.inputs:
                code, masked = self.columns[e.name]
                self.inputs[e.name] = _Val(self.nvirt, code, masked)
                self.nvirt += 1
            return self.inputs[e.name]
        if isinstance(e, _LitColumnExpr):
            return self._literal(e.value)
        if isinstance(e, _UnaryOpExpr):
            return self._unary(e)
        if isinstance(e, _BinaryOpExpr):
            return self._binary(e)
        if isinstance(e, _FuncExpr) and not e.is_aggregation:
            return self._func(e)
        raise Refused(f"expression {e}", HOST_ENGINE)

    def _literal(self, v: Any) -> _Val:
        if v is None:
            return self.null(F64)
        if isinstance(v, str):
            raise Refused(f"string literal {v!r}", STRINGS)
        if isinstance(v, bool):
            return self.const(v, B)
        if isinstance(v, int):
            if not -(2**63) <= v < 2**63:
                raise Refused(f"integer literal {v} beyond int64", HOST_ENGINE)
            return self.const(v, I64)
        return self.const(float(v), F64)

    def _unary(self, e: _UnaryOpExpr) -> _Val:
        x = self.node(e.col)
        if e.op in ("IS_NULL", "NOT_NULL"):
            return self._emit("ISNULL" if e.op == "IS_NULL" else "NOTNULL", x.dtype, x.reg)
        if e.op == "-":
            if x.dtype == B:
                raise Refused(f"{e} (the negation of a bool, which the JAX package refuses too)",
                              HOST_ENGINE)
            return self._emit("NEG", x.dtype, x.reg, masked=x.masked)
        if e.op == "~":
            return self._emit("NOT", B, self.cast(x, B).reg, masked=x.masked)
        raise Refused(f"unary {e.op}", HOST_ENGINE)

    def _binary(self, e: _BinaryOpExpr) -> _Val:
        a, b = self.node(e.left), self.node(e.right)
        if e.op in ("&", "|"):
            return self._emit("AND" if e.op == "&" else "OR", B, self.cast(a, B).reg,
                              self.cast(b, B).reg, masked=True)
        if e.op not in _CMP and e.op not in _ARITH:
            raise Refused(f"binary {e.op}", HOST_ENGINE)
        t = self.promote(a, b, "+" if e.op in _CMP else e.op, e)
        if e.op == "-" and t == B:
            raise Refused(f"{e} (bool minus bool, which the JAX package refuses too)",
                          HOST_ENGINE)
        op = _CMP[e.op] if e.op in _CMP else _ARITH[e.op]
        return self._emit(op, t, self.cast(a, t).reg, self.cast(b, t).reg,
                          masked=a.masked or b.masked)

    def _func(self, e: _FuncExpr) -> _Val:
        f = e.func.lower()
        if f in _STRING_FUNCS:
            raise Refused(f.upper(), STRINGS)
        args = e.args
        if f == "coalesce":
            vals = [self.node(a) for a in args]
            t = next((v.dtype for v in vals if not v.null), F64)
            acc = self.cast(vals[0], t)
            for v in vals[1:]:
                acc = self._emit("COAL", t, acc.reg, self.cast(v, t).reg, masked=True)
            return acc._replace(masked=True, null=False, const=None)
        if f == "case_when":
            if len(args) < 3 or len(args) % 2 == 0:
                raise ValueError("case_when takes cond/value pairs plus a default")
            vals = [self.node(a) for a in args]
            branches = [vals[i] for i in range(1, len(vals) - 1, 2)] + [vals[-1]]
            t = self._common_type([v for v in branches if not v.null], e)
            acc = self.cast(vals[-1], t)
            # first match wins: the branches apply last to first
            for i in range(len(vals) - 2, 0, -2):
                cond, val = self.cast(vals[i - 1], B), self.cast(vals[i], t)
                acc = self._emit("SEL", t, cond.reg, val.reg, acc.reg, masked=True)
            return acc._replace(masked=True, null=False, const=None)
        if f in ("if", "iif"):
            if len(args) != 3:
                raise ValueError(f"{f} takes a condition and two values")
            cond, yes, no = (self.node(a) for a in args)
            t = no.dtype if yes.null else yes.dtype
            return self._emit("SEL", t, self.cast(cond, B).reg, self.cast(yes, t).reg,
                              self.cast(no, t).reg, masked=True)
        if f == "nullif":
            a, b = self.node(args[0]), self.node(args[1])
            t = self.promote(a, b, "+", e)
            eq = self._emit("EQ", t, self.cast(a, t).reg, self.cast(b, t).reg)
            return self._emit("NULLIF", a.dtype, a.reg, eq.reg, masked=True)
        if f == "mod":
            a, b = self.node(args[0]), self.node(args[1])
            t = self.promote(a, b, "+", e)
            if t == B:
                raise Refused(f"{e} (mod of bools)", HOST_ENGINE)
            out = self._emit("MOD", t, self.cast(a, t).reg, self.cast(b, t).reg, masked=True)
            return self.cast(out, t if a.null else a.dtype)
        if f in ("power", "pow"):
            a, b = self.node(args[0]), self.node(args[1])
            return self._emit("POW", F64, self.cast(a, F64).reg, self.cast(b, F64).reg,
                              masked=a.masked or b.masked)
        if f == "round":
            x = self.cast(self.node(args[0]), F64)
            d = 0
            if len(args) > 1:
                digits = args[1]
                if not (isinstance(digits, _LitColumnExpr)
                        and isinstance(digits.value, (int, float))
                        and not isinstance(digits.value, bool)):
                    raise Refused(f"{e} (its digits must be a numeric literal)", HOST_ENGINE)
                d = int(digits.value)
            if abs(d) > 308:
                raise Refused(f"{e} (digits beyond float64's range)", HOST_ENGINE)
            return self._emit("ROUND", F64, x.reg, imm=10.0 ** abs(d), b=int(d < 0),
                              masked=x.masked)
        if f == "abs":
            x = self.node(args[0])
            return self._emit("ABS", x.dtype, x.reg, masked=x.masked)
        if f in ("floor", "ceil", "ceiling", "sign"):
            x = self.node(args[0])
            if f == "sign" and x.dtype == B:
                raise Refused(f"{e} (the sign of a bool, which the JAX package refuses too)",
                              HOST_ENGINE)
            y = x
            if x.dtype in _FLOATS:
                op = {"floor": "FLOOR", "ceil": "CEIL", "ceiling": "CEIL", "sign": "SIGN"}[f]
                y = self._emit(op, x.dtype, x.reg, masked=x.masked)
                y = self._emit("NANNULL", x.dtype, y.reg, masked=True)
            elif f == "sign":
                y = self._emit("SIGN", x.dtype, x.reg, masked=x.masked)
            return self.cast(y, I64)._replace(masked=True)
        if f in _FLOAT_FUNCS:
            x = self.cast(self.node(args[0]), F64)
            return self._emit(_FLOAT_FUNCS[f], F64, x.reg, masked=x.masked)
        raise Refused(f"function {e.func}", HOST_ENGINE)

    def _common_type(self, vals: List[_Val], what: Any) -> int:
        t = vals[0].dtype if vals else F64
        for v in vals[1:]:
            t = self.promote(_Val(0, t, False), v, "+", what)
        return t

    def finish(self, outs: List[_Val]) -> Program:
        """Allocates registers: the inputs take ``0 .. nin - 1``; a register
        is free again after the last instruction that reads its value,
        unless that value is an output."""
        inputs = list(self.inputs.items())
        keep = {v.reg for v in outs}
        # dead code (constants whose casts were folded) goes first
        needed = set(keep)
        code: List[Instr] = []
        for ins in reversed(self.code):
            if ins.dst in needed:
                code.append(ins)
                needed.update(reads(ins))
        self.code = code[::-1]
        last: Dict[int, int] = {}
        for k, ins in enumerate(self.code):
            for r in reads(ins):
                last[r] = k
        phys = {v.reg: i for i, (_, v) in enumerate(inputs)}
        free = [phys[r] for r in phys if r not in last and r not in keep]
        nregs = len(inputs)
        instrs: List[Instr] = []
        for k, ins in enumerate(self.code):
            src = [phys[r] for r in reads(ins)]
            free += sorted({phys[r] for r in reads(ins) if last[r] == k and r not in keep},
                           reverse=True)
            if free:
                dst = free.pop()
            else:
                dst, nregs = nregs, nregs + 1
            phys[ins.dst] = dst
            if ins.dst not in last and ins.dst not in keep:
                free.append(dst)
            fields = dict(zip("abc", src))
            instrs.append(ins._replace(dst=dst, **fields))
        value_reads = {r for ins in self.code if OPS[ins.op] not in ("ISNULL", "NOTNULL")
                       for r in reads(ins)} | keep
        return Program(
            tuple((name, v.dtype) for name, v in inputs), tuple(instrs),
            tuple(Output(phys[v.reg], v.dtype, v.masked) for v in outs), max(nregs, 1),
            tuple(v.reg not in value_reads for _, v in inputs),
        )


def compile_program(
    exprs: Sequence[ColumnExpr],
    out_dtypes: Sequence[Optional[torch.dtype]],
    columns: Dict[str, Tuple[torch.dtype, bool]],
) -> Program:
    """``exprs`` over a frame whose ``columns`` are ``name -> (dtype, has
    a mask)``, each output converted to its ``out_dtypes`` entry (None:
    the type it computes in). Raises ``Refused`` for what K6 does not
    evaluate and for a program over the caps."""
    if not 1 <= len(exprs) <= MAX_OUTPUTS:
        raise Refused(f"{len(exprs)} expressions in one program (at most {MAX_OUTPUTS})",
                      OVER_CAPS)
    comp = _Compiler({n: (CODES[t], m) for n, (t, m) in columns.items() if t in CODES})
    outs = []
    for e, dt in zip(exprs, out_dtypes):
        v = comp.node(e)
        if dt is not None:
            if dt not in CODES:
                raise Refused(f"{e} as {dt}", STRINGS)
            v = comp.cast(v, CODES[dt])
        outs.append(v)
    prog = comp.finish(outs)
    if len(prog.inputs) > MAX_INPUTS or len(prog.instrs) > MAX_INSTRS or prog.nregs > MAX_REGS:
        raise Refused(
            f"a program of {len(prog.instrs)} instructions, {prog.nregs} registers and "
            f"{len(prog.inputs)} inputs (caps {MAX_INSTRS}, {MAX_REGS}, {MAX_INPUTS})",
            OVER_CAPS)
    for ins in prog.instrs:
        assert ins.dtype in _VALID[OPS[ins.op]], f"no kernel for {ins}"
    return prog


class ProgramCache:
    """Compiled programs by the expressions' ``__uuid__``, the wanted
    output dtypes and the frame's column dtypes and masks."""

    def __init__(self) -> None:
        self._programs: Dict[Any, Program] = {}

    def get(self, exprs: Sequence[ColumnExpr], out_dtypes: Sequence[Optional[torch.dtype]],
            columns: Dict[str, Tuple[torch.dtype, bool]]) -> Program:
        key = (tuple(e.__uuid__() for e in exprs), tuple(out_dtypes),
               tuple(sorted((n, str(t), m) for n, (t, m) in columns.items())))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = compile_program(exprs, out_dtypes, columns)
        return prog

    def __len__(self) -> int:
        return len(self._programs)


Masked = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _bind() -> ctypes.CDLL:
    lib = build.load("expr_program")
    if lib.fugue_expr_program.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pp, ip, llp = ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(ll)
        lib.fugue_expr_program.argtypes = [
            ll, ll, p,  # n, nrows, row_valid
            i, pp, pp, ip,  # inputs: count, data, masks, codes
            i, ip, ip, llp,  # instructions: count, opcodes, registers, immediates
            i, pp, pp, ip, ip, i,  # outputs: count, data, masks, codes, registers; nregs
            p, p,  # keep, count
            i, p,  # device, stream
        ]
        lib.fugue_expr_program.restype = i
        lib.fugue_expr_error_string.argtypes = [i]
        lib.fugue_expr_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(program: Program, inputs: Sequence[Masked], n: int,
                  device: torch.device) -> None:
    if len(inputs) != len(program.inputs):
        raise ValueError(f"{len(inputs)} inputs for a program of {len(program.inputs)}")
    for (name, code), (v, m) in zip(program.inputs, inputs):
        for t, what, dtype in ((v, name, DTYPES[code]), (m, f"{name} mask", torch.bool)):
            if t is None:
                continue
            if t.device != device or t.dtype != dtype:
                raise ValueError(f"{what} is {t.dtype} on {t.device}, expected {dtype} on {device}")
            if tuple(t.shape) != (n,) or (n > 1 and t.stride(0) != 1):
                raise ValueError(f"{what} must be a dense 1-D tensor of {n} rows")


def launch(lib: ctypes.CDLL, program: Program, inputs: Sequence[Masked],
           outs: Sequence[Masked], n: int, nrows: int, row_valid: Optional[torch.Tensor],
           keep: Optional[torch.Tensor], count: Optional[torch.Tensor], device: int,
           stream: int) -> None:
    """One call of ``fugue_expr_program`` over checked, allocated tensors
    (``nrows`` -1 with ``row_valid``); raises on a refused launch."""

    def ptrs(ts: Sequence[Optional[torch.Tensor]]) -> "ctypes.Array":
        return (ctypes.c_void_p * max(len(ts), 1))(
            *[None if t is None else t.data_ptr() for t in ts])

    def ints(xs: Sequence[int]) -> "ctypes.Array":
        return (ctypes.c_int * max(len(xs), 1))(*xs)

    instrs = program.instrs
    err = lib.fugue_expr_program(
        n, nrows, None if row_valid is None else row_valid.data_ptr(),
        len(inputs), ptrs([None if skip else v for (v, _), skip in zip(inputs, program.mask_only)]),
        ptrs([m for _, m in inputs]), ints([c for _, c in program.inputs]),
        len(instrs), ints([i.opcode for i in instrs]),
        ints([r for i in instrs for r in (i.dst, i.a, i.b, i.c)]),
        (ctypes.c_longlong * max(len(instrs), 1))(*[i.imm_bits() for i in instrs]),
        len(outs), ptrs([v for v, _ in outs]), ptrs([m for _, m in outs]),
        ints([o.dtype for o in program.outputs]), ints([o.reg for o in program.outputs]),
        program.nregs, None if keep is None else keep.data_ptr(), None if count is None else count.data_ptr(),
        device, stream,
    )
    if err != 0:
        msg = lib.fugue_expr_error_string(err).decode()
        raise RuntimeError(f"expr_program kernel launch failed: {msg} ({err})")


def expr_program_cuda(
    program: Program,
    inputs: Sequence[Masked],
    n: int,
    *,
    device: torch.device,
    filter: bool = False,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Any:
    """K6, with the contract of ``reference.expr_program_reference``: one
    launch over ``n`` rows on ``device`` (a CUDA device), on PyTorch's
    current stream. Raises on anything else, on a failed build and on a
    refused launch; the filter's count stays on the card. ``launches``
    grows by one where it launches, ``filter_launches`` too in filter
    mode."""
    if device.type != "cuda":
        raise ValueError("expr_program_cuda takes CUDA tensors only")
    if not 1 <= n < 2**62:
        raise ValueError(f"{n} rows: the kernel takes at least one")
    _check_inputs(program, inputs, n, device)
    keep = count = None
    nrows_arg = -1
    if filter:
        if len(program.outputs) != 1 or program.outputs[0].dtype != B:
            raise ValueError("a filter program has one bool output")
        if (nrows is None) == (row_valid is None):
            raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
        if row_valid is not None:
            if row_valid.device != device or row_valid.dtype not in (torch.bool, torch.uint8) \
                    or tuple(row_valid.shape) != (n,) or (n > 1 and row_valid.stride(0) != 1):
                raise ValueError(f"row_valid must be a dense bool tensor of {n} rows on {device}")
        else:
            nrows_arg = int(nrows)  # type: ignore[arg-type]
        keep = torch.empty((n,), dtype=torch.bool, device=device)
        count = torch.zeros((), dtype=torch.int32, device=device)
        outs: List[Masked] = [(keep, None)]
    else:
        outs = [(torch.empty((n,), dtype=DTYPES[o.dtype], device=device),
                 torch.empty((n,), dtype=torch.bool, device=device) if o.masked else None)
                for o in program.outputs]
    index = device.index if device.index is not None else torch.cuda.current_device()
    launch(_bind(), program, inputs, outs, n, nrows_arg, row_valid, keep, count, index,
           torch.cuda.current_stream(device).cuda_stream)
    expr_program_cuda.launches += 1
    expr_program_cuda.filter_launches += int(filter)
    return (keep, count) if filter else outs


expr_program_cuda.launches = 0  # type: ignore[attr-defined]
expr_program_cuda.filter_launches = 0  # type: ignore[attr-defined]
