"""K6 ``expr_program``: column expressions compiled into one typed register
program, and the wrapper that runs it over a frame's rows on the card in
one CUDA kernel generated for the program's structure
(``expr_codegen.py``, semantics in ``expr_ops.cuh``).

The JAX package evaluates an expression tree (``expr_eval._eval``,
``fugue_tpu/jax_backend/expr_eval.py:109``) inside a jitted program
(``filter``'s ``_filter_prog``, ``assign``'s ``_assign_prog``,
``_device_project``'s ``_project_prog``), which XLA fuses into one
elementwise pass. Here the host compiles the trees once into a program
of instructions ``dst = op(a, b[, c])``, each with an opcode per
operation and dtype (``ADD_F32``, ``LT_I64``, ``CAST_F64`` to a target,
``AND_B`` in Kleene logic, ``SEL``, ...); ``expr_codegen`` turns the
program's structure into one CUDA kernel, built with ``nvcc`` at first
use and cached by that structure (literals and tables are its
parameters), and one launch of it runs over every row: it reads each
input column and its mask once, keeps values and validity in hardware
registers, and writes either every output column with its mask (columns
mode: ``assign``, a projection, an aggregate's arguments) or a filter's
keep flags and kept count (filter mode).

Strings: a string register is an I32 register holding dictionary codes;
the compiler, not the kernel, tracks which dictionary it codes
(``torch_backend/strings.py`` builds the tables). The ``LUT`` family,
``dst = table[t][clamp(a, 0, len - 1)]`` with ``a``'s validity, gathers
from one of the program's small device tables (any dtype K6 holds): a
LIKE's match flags, a compare against a literal folded into flags, the
ranks of a compare of two columns in their union vocabulary, LENGTH, the
re-coding of a transformed dictionary onto its distinct entries and a
join key's re-coding into the other side's dictionary. A dictionary
transform (UPPER, TRIM, SUBSTRING, ...) costs no instruction: the codes
pass and the dictionary changes; a CONCAT of several columns composes
their codes with I32 arithmetic.

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

Unsigned and half columns (``blocks.torch_dtype``): a uint16 or uint32
is its value in its int32 or int64 register; a uint64 is its word with
the sign bit flipped, so a compare of two of them, or of one and a
literal flipped the same way, is a signed compare, and ``plain`` reads
its value out (a cast, a bool test, a float64 rounded once). A float16
is loaded from its bits into an F32 register (input code ``F16``) and
stored back the same way; each float16 operation computes in float32 and
rounds to float16 (``HALF``), so ``h * 2`` overflows to inf as the JAX
package's does. A float64 stored as float16 rounds once, straight to
float16 (``HALF`` of an F64: float32 rounded to odd, then to nearest),
as arrow's cast does; an integer reaches float16 exactly or overflows.
Arithmetic that ``_promote`` declares unsigned wraps in the type and is
reduced back into the column's word
(``unsigned_result``); one it cannot type raises ``ValueError``, as type
inference does.

A program has no cap on its instructions, registers, inputs, outputs or
tables: its kernel is generated to its size. A table over the string
caps of ``strings.py`` (a LIKE by a pattern column over more than
``MAX_PAIR_LUT`` pairs, a CONCAT over more than ``MAX_COMPOSED_DICT``
combinations), and what else the JAX package answers on its host engine,
raises it naming queue 1 item 2(b).
"""

import math
import os
import struct
import time
from pathlib import Path
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
from fugue_tpu_torch.kernels import U64_FLIP, build
from fugue_tpu_torch.torch_backend import strings

HOST_ENGINE = "ROADMAP.md queue 1 item 2(b) (the host engine)"

# dtype codes of bin_keys.cuh
B, U8, I8, I16, I32, I64, F32, F64 = range(8)
# float16 in memory: an input loaded into an F32 register, an output
# stored from one (a storage code, never an instruction's dtype)
F16 = 8
CODES = {
    torch.bool: B, torch.uint8: U8, torch.int8: I8, torch.int16: I16,
    torch.int32: I32, torch.int64: I64, torch.float32: F32, torch.float64: F64,
}
DTYPES = {c: t for t, c in CODES.items()}
DTYPES[F16] = torch.float16
_NAMES = ("B", "U8", "I8", "I16", "I32", "I64", "F32", "F64", "F16")
_PA = {
    B: pa.bool_(), U8: pa.uint8(), I8: pa.int8(), I16: pa.int16(),
    I32: pa.int32(), I64: pa.int64(), F32: pa.float32(), F64: pa.float64(),
}
_FROM_PA = {t: c for c, t in _PA.items()}
_U16, _U32, _U64 = pa.uint16(), pa.uint32(), pa.uint64()
_INTS = (U8, I8, I16, I32, I64)
_FLOATS = (F32, F64)

# operation families; the opcode is family * 8 + the dtype code of the
# operands
OPS = (
    "CONST", "NULL", "ADD", "SUB", "MUL", "DIV", "MOD", "POW", "NEG", "ABS",
    "EQ", "NE", "LT", "LE", "GT", "GE", "AND", "OR", "NOT", "ISNULL", "NOTNULL",
    "CAST", "SEL", "COAL", "NULLIF", "FLOOR", "CEIL", "SIGN", "NANNULL",
    "SQRT", "EXP", "LN", "LOG2", "LOG10", "SIN", "COS", "TAN", "ROUND", "LUT", "HALF",
)
OP = {name: i for i, name in enumerate(OPS)}
_CMP = {"==": "EQ", "!=": "NE", "<": "LT", "<=": "LE", ">": "GT", ">=": "GE"}
_ARITH = {"+": "ADD", "-": "SUB", "*": "MUL", "/": "DIV"}
_FLOAT_FUNCS = {
    "sqrt": "SQRT", "exp": "EXP", "ln": "LN", "log": "LN", "log2": "LOG2",
    "log10": "LOG10", "sin": "SIN", "cos": "COS", "tan": "TAN",
}
_TABLE_CODES = {np.dtype(bool): B, np.dtype(np.uint8): U8, np.dtype(np.int8): I8,
                np.dtype(np.int16): I16, np.dtype(np.int32): I32, np.dtype(np.int64): I64,
                np.dtype(np.float32): F32, np.dtype(np.float64): F64}
# the (family, dtype) pairs the kernels implement
_ANY = tuple(range(8))
_NUM = _INTS + _FLOATS
_VALID = {
    "CONST": _ANY, "NULL": _ANY, "ADD": _ANY, "SUB": _NUM, "MUL": _ANY, "DIV": (F64,),
    "MOD": _NUM, "POW": (F64,), "NEG": _NUM, "ABS": _ANY,
    **{c: _ANY for c in ("EQ", "NE", "LT", "LE", "GT", "GE")},
    "AND": (B,), "OR": (B,), "NOT": (B,), "ISNULL": _ANY, "NOTNULL": _ANY,
    "CAST": _ANY, "SEL": _ANY, "COAL": _ANY, "NULLIF": _ANY,
    "FLOOR": _FLOATS, "CEIL": _FLOATS, "SIGN": _NUM, "NANNULL": _FLOATS,
    **{c: (F64,) for c in _FLOAT_FUNCS.values()}, "ROUND": (F64,), "LUT": _ANY,
    "HALF": _FLOATS,
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
    where ``b`` is 1; LUT gathers from table ``b``, of ``dtype``, at
    register ``a``."""

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
        if self.op == OP["LUT"]:
            return f"r{self.dst} = {name} t{self.b}[r{self.a}]"
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
    inputs read only by IS [NOT] NULL, whose values are never loaded.
    ``tables`` are the LUT instructions' tables (1-D tensors of bool,
    int32 or int64, on the device the program runs on); ``dicts`` the
    dictionary each output's codes index, None for an output that is not
    a string."""

    inputs: Tuple[Tuple[str, int], ...]
    instrs: Tuple[Instr, ...]
    outputs: Tuple[Output, ...]
    nregs: int
    mask_only: Tuple[bool, ...]
    tables: Tuple[torch.Tensor, ...] = ()
    dicts: Tuple[Optional[np.ndarray], ...] = ()

    def __str__(self) -> str:
        ins = ", ".join(f"r{i}={n}:{_NAMES[c]}" for i, (n, c) in enumerate(self.inputs))
        outs = ", ".join(f"r{o.reg}:{_NAMES[o.dtype]}{'?' if o.masked else ''}"
                         for o in self.outputs)
        body = "\n".join(f"  {i}" for i in self.instrs)
        tabs = "".join(f"\ntable t{i}: {t.dtype} [{t.shape[0]}]" for i, t in enumerate(self.tables))
        return f"inputs {ins}\n{body}\noutputs {outs}{tabs}"


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
    has a mask, whether it is the NULL literal, and a constant's value.
    A string value is an I32 register of codes with the ``dictionary``
    they index; a string literal has no register, only its ``text``."""

    reg: int
    dtype: int
    masked: bool
    null: bool = False
    const: Any = None
    dictionary: Optional[np.ndarray] = None
    text: Optional[str] = None
    kind: Optional[pa.DataType] = None  # declared uint16-64 or float16
    big: Optional[int] = None  # an integer literal in [2^63, 2^64), no register

    @property
    def is_str(self) -> bool:
        return self.dictionary is not None

    @property
    def stringish(self) -> bool:
        return self.dictionary is not None or self.text is not None


# registers each family reads, in the order a, b, c
_NARGS = {
    **dict.fromkeys(("CONST", "NULL"), 0),
    **dict.fromkeys(("ADD", "SUB", "MUL", "DIV", "MOD", "POW", "EQ", "NE", "LT", "LE", "GT",
                     "GE", "AND", "OR", "COAL", "NULLIF"), 2),
    **dict.fromkeys(("NEG", "ABS", "NOT", "ISNULL", "NOTNULL", "CAST", "FLOOR", "CEIL", "SIGN",
                     "NANNULL", "SQRT", "EXP", "LN", "LOG2", "LOG10", "SIN", "COS", "TAN",
                     "ROUND", "LUT", "HALF"), 1),
    "SEL": 3,
}


_BOOL_RESULTS = ("EQ", "NE", "LT", "LE", "GT", "GE", "ISNULL", "NOTNULL")


def reads(ins: Instr) -> Tuple[int, ...]:
    """The registers an instruction reads."""
    return (ins.a, ins.b, ins.c)[: _NARGS[OPS[ins.op]]]


class _Compiler:
    """Expression trees -> instructions over virtual registers (one per
    value, common subexpressions, constants and tables shared), then a
    linear-scan allocation onto as few registers as the values live at once
need."""

    def __init__(self, columns: Dict[str, Tuple[int, bool, Optional[pa.DataType]]],
                 dicts: Dict[str, np.ndarray], host: Any = ()):
        self.host = host  # the frame's host columns: refused
        # name -> (dtype code, has a mask, declared uint16-64 / float16 type)
        self.columns = columns
        self.dicts = dicts  # name -> dictionary, for the string columns
        self.inputs: Dict[str, _Val] = {}
        self.code: List[Instr] = []
        self.nvirt = 0
        self.memo: Dict[Any, _Val] = {}
        self.tables: List[np.ndarray] = []
        self.table_index: Dict[Any, int] = {}

    def _emit(self, op: str, dtype: int, *args: int, imm: Any = 0, b: Optional[int] = None,
              masked: bool = False) -> _Val:
        """``op`` over operands of ``dtype``; the value is of ``dtype`` too,
        but bool for a comparison or a null test, ``b`` for a CAST and F32
        for a HALF."""
        regs = list(args) + [0] * (3 - len(args))
        if b is not None:
            regs[1] = b
        ins = Instr(OP[op], dtype, self.nvirt, regs[0], regs[1], regs[2], imm)
        key = (ins.opcode, tuple(regs), ins.imm_bits())
        if key not in self.memo:
            out = B if op in _BOOL_RESULTS else regs[1] if op == "CAST" else \
                F32 if op == "HALF" else dtype
            self.nvirt += 1
            self.code.append(ins)
            self.memo[key] = _Val(ins.dst, out, masked, const=imm if op == "CONST" else None)
        return self.memo[key]

    def const(self, value: Any, dtype: int) -> _Val:
        return self._emit("CONST", dtype, imm=value)

    def null(self, dtype: int) -> _Val:
        return self._emit("NULL", dtype, masked=True)._replace(null=True)

    def lut(self, table: np.ndarray, v: _Val) -> _Val:
        """``table[v]``: the table's entry at each code (clamped into the
        table), with ``v``'s validity; equal tables are shared."""
        key = (table.dtype.str, table.tobytes())
        if key not in self.table_index:
            self.table_index[key] = len(self.tables)
            self.tables.append(table)
        return self._emit("LUT", _TABLE_CODES[table.dtype], v.reg, b=self.table_index[key],
                          masked=v.masked)

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
            if v.stringish:
                raise Refused(f"{e} (a cast of a string)", HOST_ENGINE)
            if e.as_type not in _FROM_PA:
                raise Refused(f"cast to {e.as_type}", HOST_ENGINE)
            v = self.cast(self.plain(v, _FROM_PA[e.as_type]), _FROM_PA[e.as_type])
        return v

    def plain(self, v: _Val, dtype: int) -> _Val:
        """A declared uint64 or float16 value as a plain register on its way
        to ``dtype``: a uint64's flipped word unflipped into its int64 bits
        for an integer, ``!= 0`` for a bool, and its value in float64,
        rounded once, for a float; a float16 is already its value in F32; a
        uint16 or uint32 is its value in its wider signed word."""
        if v.kind != _U64:
            return v._replace(kind=None)
        if dtype == B:
            return self._emit("NE", I64, v.reg, self.const(U64_FLIP, I64).reg, masked=v.masked)
        if dtype not in _FLOATS:
            return self._emit("ADD", I64, v.reg, self.const(U64_FLIP, I64).reg, masked=v.masked)
        # the word w = value - 2^63 split as hi + lo, lo = w mod 2^32 in
        # [0, 2^32): (hi + 2^63) and lo are exact float64s, so their sum
        # rounds once, as a uint64's conversion does
        span = self.const(1 << 32, I64)
        r = self._emit("MOD", I64, v.reg, span.reg, masked=v.masked)
        lo = self._emit("MOD", I64, self._emit("ADD", I64, r.reg, span.reg).reg, span.reg,
                        masked=v.masked)
        hi = self._emit("SUB", I64, v.reg, lo.reg, masked=v.masked)
        top = self._emit("ADD", F64, self.cast(hi, F64).reg, self.const(2.0 ** 63, F64).reg,
                         masked=v.masked)
        return self._emit("ADD", F64, top.reg, self.cast(lo, F64).reg, masked=v.masked)

    def declared(self, v: _Val) -> pa.DataType:
        return v.kind if v.kind is not None else _PA[v.dtype]

    def _kinded_binary(self, e: _BinaryOpExpr, a: _Val, b: _Val) -> _Val:
        """``a op b`` where a side is a declared uint16-64 or float16
        value. A compare: of two uint64 words, or of one and a literal in
        ``[0, 2^64)`` flipped like the column, as signed words; of others
        by value in the wider register. Arithmetic in the declared type
        ``_promote`` gives (None raises, as type inference does): a float16
        result in F32, rounded to float16 (``HALF``), so it equals IEEE half
        arithmetic; a uint16-64 result in the integers' wrapping arithmetic
        over the values, then reduced to its type (a uint64 flipped
        again); any other result over the plain values."""
        masked = a.masked or b.masked
        if e.op in _CMP:
            if _U64 in (a.kind, b.kind):
                u, o = (a, b) if a.kind == _U64 else (b, a)
                if o.kind != _U64 and not o.null:
                    if not (o.const is not None and o.dtype == I64 and o.const >= 0) and \
                            not (o.big is not None):
                        raise Refused(f"{e} (a uint64 compared with {self.declared(o)})",
                                      HOST_ENGINE)
                    value = o.big if o.big is not None else o.const
                    o = self.const(int(np.int64(np.uint64(value).view(np.int64))
                                       ^ np.int64(U64_FLIP)), I64)
                a, b = (u, o) if a.kind == _U64 else (o, u)
                return self._emit(_CMP[e.op], I64, self.cast(a, I64).reg, self.cast(b, I64).reg,
                                  masked=masked)
            t = self.promote(a._replace(kind=None), b._replace(kind=None), "+", e)
            return self._emit(_CMP[e.op], t, self.cast(a, t).reg, self.cast(b, t).reg,
                              masked=masked)
        ta = self.declared(b) if a.null else self.declared(a)
        tb = self.declared(a) if b.null else self.declared(b)
        tp = _promote(ta, tb, e.op)
        if tp is None:
            raise ValueError(f"can't infer type of {e}")
        op = _ARITH[e.op]
        if tp == pa.float16():
            out = self._emit(op, F32, self.cast(a, F32).reg, self.cast(b, F32).reg,
                             masked=masked)
            return self._emit("HALF", F32, out.reg, masked=masked)._replace(kind=tp)
        if tp in (_U16, _U32, _U64):
            t = I32 if tp == _U16 else I64
            raw = self._emit(op, t, self.cast(self.plain(a, I64), t).reg,
                             self.cast(self.plain(b, I64), t).reg, masked=masked)
            return self.unsigned_result(raw, tp)
        t = _FROM_PA[tp]
        return self._emit(op, t, self.cast(self.plain(a, t), t).reg,
                          self.cast(self.plain(b, t), t).reg, masked=masked)

    def unsigned_result(self, raw: _Val, tp: pa.DataType) -> _Val:
        """An integer result declared ``tp`` in the column's storage: a
        uint64's bits flipped; a uint16's or uint32's low 16 or 32 bits,
        zero-extended into its int32 or int64 word."""
        if tp == _U64:
            out = self._emit("ADD", I64, raw.reg, self.const(U64_FLIP, I64).reg, masked=raw.masked)
            return out._replace(kind=tp)
        narrow, wide, span = (I16, I32, 1 << 16) if tp == _U16 else (I32, I64, 1 << 32)
        low = self.cast(self.cast(raw, narrow), wide)
        up = self._emit("ADD", wide, low.reg, self.const(span, wide).reg, masked=raw.masked)
        out = self._emit("MOD", wide, up.reg, self.const(span, wide).reg, masked=raw.masked)
        return out._replace(masked=raw.masked, kind=tp)

    def num(self, e: ColumnExpr, what: Any) -> _Val:
        """A numeric operand of ``what``: strings are refused, as the JAX
        package sends them to its host engine; so is a uint64 (its words are
        flipped) and an integer literal beyond int64. A uint16, uint32 or
        float16 is its value in its register."""
        v = self.node(e)
        if v.stringish:
            raise Refused(f"{what} (a string where a number is needed)", HOST_ENGINE)
        if v.kind == _U64 or v.big is not None:
            raise Refused(f"{what} (of a uint64 value)", HOST_ENGINE)
        return v._replace(kind=None)

    def string(self, e: ColumnExpr, what: Any) -> _Val:
        """A string column's codes (or a transform of one) for ``what``."""
        v = self.node(e)
        if not v.is_str:
            raise Refused(f"{what} (needs a string column)", HOST_ENGINE)
        return v

    def _node(self, e: ColumnExpr) -> _Val:
        if isinstance(e, _NamedColumnExpr):
            if e.name in self.host:
                raise Refused(f"an expression over the host column {e.name}", HOST_ENGINE)
            if e.name not in self.columns:
                raise ValueError(f"{e.name} not available on device")
            if e.name not in self.inputs:
                code, masked, kind = self.columns[e.name]
                self.inputs[e.name] = _Val(self.nvirt, code, masked,
                                           dictionary=self.dicts.get(e.name), kind=kind)
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
            return _Val(-1, I32, False, text=v)
        if isinstance(v, bool):
            return self.const(v, B)
        if isinstance(v, int):
            if 2**63 <= v < 2**64:  # only a uint64 compare takes it
                return _Val(-1, I64, False, big=v)
            if not -(2**63) <= v < 2**63:
                raise Refused(f"integer literal {v} beyond int64", HOST_ENGINE)
            return self.const(v, I64)
        return self.const(float(v), F64)

    def _unary(self, e: _UnaryOpExpr) -> _Val:
        if e.op in ("IS_NULL", "NOT_NULL"):
            x = self.node(e.col)
            if x.text is not None:
                raise Refused(f"{e} (IS NULL of a string literal)", HOST_ENGINE)
            return self._emit("ISNULL" if e.op == "IS_NULL" else "NOTNULL", x.dtype, x.reg)
        x = self.num(e.col, e)
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
        if a.stringish or b.stringish:
            return self._str_compare(e.op, a, b, e)
        if (a.kind is not None or b.kind is not None) and (e.op in _CMP or e.op in _ARITH):
            return self._kinded_binary(e, a, b)
        if a.big is not None or b.big is not None:
            raise Refused(f"{e} (an integer literal beyond int64)", HOST_ENGINE)
        if e.op in ("&", "|"):
            return self._emit("AND" if e.op == "&" else "OR", B,
                              self.cast(self.plain(a, B), B).reg,
                              self.cast(self.plain(b, B), B).reg, masked=True)
        if e.op not in _CMP and e.op not in _ARITH:
            raise Refused(f"binary {e.op}", HOST_ENGINE)
        t = self.promote(a, b, "+" if e.op in _CMP else e.op, e)
        if e.op == "-" and t == B:
            raise Refused(f"{e} (bool minus bool, which the JAX package refuses too)",
                          HOST_ENGINE)
        op = _CMP[e.op] if e.op in _CMP else _ARITH[e.op]
        return self._emit(op, t, self.cast(a, t).reg, self.cast(b, t).reg,
                          masked=a.masked or b.masked)

    def _str_compare(self, op: str, a: _Val, b: _Val, what: Any) -> _Val:
        """A compare of strings (``_str_compare``, ``expr_eval.py:477``):
        against a literal, one bool table over the column's dictionary;
        of two columns, each side's rank in their union vocabulary (two
        int32 tables), then an I32 compare."""
        if op not in _CMP:
            raise Refused(f"{what} (binary {op} on strings)", HOST_ENGINE)
        if not (a.stringish and b.stringish) or (a.text is not None and b.text is not None):
            raise Refused(f"{what} (a string compared with a non-string or two literals)",
                          HOST_ENGINE)
        if b.text is not None:
            return self.lut(strings.compare_table(op, a.dictionary, b.text), a)
        if a.text is not None:
            return self.lut(strings.compare_table(strings.FLIPPED[op], b.dictionary, a.text), b)
        vocab = strings.vocabulary([a.dictionary, b.dictionary])
        ra = self.lut(strings.rank_table(vocab, a.dictionary), a)
        rb = self.lut(strings.rank_table(vocab, b.dictionary), b)
        return self._emit(_CMP[op], I32, ra.reg, rb.reg, masked=a.masked or b.masked)

    def _literal_params(self, e: _FuncExpr) -> List[Any]:
        """A string function's scalar parameters after its column: numeric
        or string literals (``_check_scalar_lit``)."""
        out = []
        for p in e.args[1:]:
            if not (isinstance(p, _LitColumnExpr) and isinstance(p.value, (int, float, str))
                    and not isinstance(p.value, bool)):
                raise Refused(f"{e} (its parameters must be literals)", HOST_ENGINE)
            out.append(p.value)
        return out

    def _string_func(self, f: str, e: _FuncExpr) -> _Val:
        args = e.args
        if f == "like":
            x = self.string(args[0], e)
            neg = args[2] if len(args) > 2 else None
            if not (neg is None or (isinstance(neg, _LitColumnExpr)
                                    and isinstance(neg.value, bool))):
                raise Refused(f"{e} (its negation must be a literal)", HOST_ENGINE)
            negated = bool(neg.value) if neg is not None else False
            pat = self.node(args[1])
            if pat.text is not None:
                return self.lut(strings.like_table(x.dictionary, pat.text, negated), x)
            if not pat.is_str:
                raise Refused(f"{e} (LIKE pattern must be a string)", HOST_ENGINE)
            no, npat = max(len(x.dictionary), 1), max(len(pat.dictionary), 1)
            if no * npat > strings.MAX_PAIR_LUT:
                raise Refused(f"{e} (a LIKE by a pattern column over {no} x {npat} dictionary "
                              f"pairs, more than {strings.MAX_PAIR_LUT})", HOST_ENGINE)
            pair = self._emit("ADD", I32, self._emit("MUL", I32, x.reg, self.const(npat, I32).reg,
                                                     masked=x.masked).reg,
                              pat.reg, masked=x.masked or pat.masked)
            return self.lut(strings.like_pair_table(x.dictionary, pat.dictionary, negated), pair)
        if f in ("length", "len"):
            x = self.string(args[0], e)
            return self.lut(strings.length_table(x.dictionary), x)
        if f in strings.DICT_TRANSFORMS or f in strings.SUBSTRING or f == "replace":
            x = self.string(args[0], e)
            params = self._literal_params(e)
            return x._replace(dictionary=strings.transformed_dictionary(f, params, x.dictionary))
        if f == "concat":
            return self._concat(e)
        if f == "nullif":  # a string NULLIF: a's codes, NULL where a = b
            a = self.string(args[0], e)
            eq = self._str_compare("==", a, self.node(args[1]), e)
            return self._emit("NULLIF", I32, a.reg, eq.reg, masked=True)._replace(
                dictionary=a.dictionary)
        raise Refused(f"function {e.func}", HOST_ENGINE)

    def _concat(self, e: _FuncExpr) -> _Val:
        """CONCAT of literals and string columns: literals alone make a
        literal; one column gets the literals around its dictionary's
        entries; several compose their codes in mixed radix
        (``((c1 * |d2|) + c2) * |d3| + c3 ...``, I32 arithmetic) over the
        cross product of their dictionaries."""
        parts = [self.node(a) for a in e.args]
        if not all(p.stringish for p in parts):
            raise Refused(f"{e} (CONCAT of non-strings)", HOST_ENGINE)
        cols = [p for p in parts if p.is_str]
        if not cols:
            return _Val(-1, I32, False, text="".join(p.text for p in parts))  # type: ignore
        if len(cols) == 1:
            i = next(j for j, p in enumerate(parts) if p.is_str)
            pre = "".join(p.text for p in parts[:i])  # type: ignore[misc]
            post = "".join(p.text for p in parts[i + 1:])  # type: ignore[misc]
            return cols[0]._replace(dictionary=strings.affixed_dictionary(
                pre, cols[0].dictionary, post))
        dicts = [p.dictionary for p in cols]
        total = strings.concat_size(dicts)  # type: ignore[arg-type]
        if total > strings.MAX_COMPOSED_DICT:
            raise Refused(f"{e} (a CONCAT of {total} dictionary combinations, more than "
                          f"{strings.MAX_COMPOSED_DICT})", HOST_ENGINE)
        code = cols[0]
        for p in cols[1:]:
            size = self.const(max(len(p.dictionary), 1), I32)  # type: ignore[arg-type]
            scaled = self._emit("MUL", I32, code.reg, size.reg, masked=code.masked)
            code = self._emit("ADD", I32, scaled.reg, p.reg, masked=code.masked or p.masked)
        template = [None if p.is_str else p.text for p in parts]
        return code._replace(dictionary=strings.concat_dictionary(template, dicts))  # type: ignore

    def _func(self, e: _FuncExpr) -> _Val:
        f = e.func.lower()
        args = e.args
        if f in ("like", "length", "len", "concat", "replace", *strings.SUBSTRING,
                 *strings.DICT_TRANSFORMS):
            return self._string_func(f, e)
        if f == "nullif" and any(self.node(a).stringish for a in args[:2]):
            return self._string_func(f, e)
        if f == "coalesce":
            vals = [self.num(a, e) for a in args]
            t = next((v.dtype for v in vals if not v.null), F64)
            acc = self.cast(vals[0], t)
            for v in vals[1:]:
                acc = self._emit("COAL", t, acc.reg, self.cast(v, t).reg, masked=True)
            return acc._replace(masked=True, null=False, const=None)
        if f == "case_when":
            if len(args) < 3 or len(args) % 2 == 0:
                raise ValueError("case_when takes cond/value pairs plus a default")
            vals = [self.num(a, e) for a in args]
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
            cond, yes, no = (self.num(a, e) for a in args)
            t = no.dtype if yes.null else yes.dtype
            return self._emit("SEL", t, self.cast(cond, B).reg, self.cast(yes, t).reg,
                              self.cast(no, t).reg, masked=True)
        if f == "nullif":
            a, b = self.num(args[0], e), self.num(args[1], e)
            t = self.promote(a, b, "+", e)
            eq = self._emit("EQ", t, self.cast(a, t).reg, self.cast(b, t).reg)
            return self._emit("NULLIF", a.dtype, a.reg, eq.reg, masked=True)
        if f == "mod":
            a, b = self.num(args[0], e), self.num(args[1], e)
            t = self.promote(a, b, "+", e)
            if t == B:
                raise Refused(f"{e} (mod of bools)", HOST_ENGINE)
            out = self._emit("MOD", t, self.cast(a, t).reg, self.cast(b, t).reg, masked=True)
            return self.cast(out, t if a.null else a.dtype)
        if f in ("power", "pow"):
            a, b = self.num(args[0], e), self.num(args[1], e)
            return self._emit("POW", F64, self.cast(a, F64).reg, self.cast(b, F64).reg,
                              masked=a.masked or b.masked)
        if f == "round":
            x = self.cast(self.num(args[0], e), F64)
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
            x = self.num(args[0], e)
            return self._emit("ABS", x.dtype, x.reg, masked=x.masked)
        if f in ("floor", "ceil", "ceiling", "sign"):
            x = self.num(args[0], e)
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
            x = self.cast(self.num(args[0], e), F64)
            return self._emit(_FLOAT_FUNCS[f], F64, x.reg, masked=x.masked)
        raise Refused(f"function {e.func}", HOST_ENGINE)

    def _common_type(self, vals: List[_Val], what: Any) -> int:
        t = vals[0].dtype if vals else F64
        for v in vals[1:]:
            t = self.promote(_Val(0, t, False), v, "+", what)
        return t

    def output(self, e: ColumnExpr, v: _Val, dt: Optional[torch.dtype]) -> _Val:
        """``v`` as an output of dtype ``dt`` (None: its own). A string
        output is its codes, re-coded by a LUT onto the distinct entries
        where its dictionary holds one twice (``finalize_string_result``,
        ``expr_eval.py:588``)."""
        if v.text is not None:
            raise Refused(f"{e} (a string literal as a column)", HOST_ENGINE)
        if v.big is not None:
            raise Refused(f"{e} (an integer literal beyond int64 as a column)", HOST_ENGINE)
        if dt == torch.float16:  # stored as float16 from its F32 register
            v = self.plain(v, F32)
            if v.dtype == F64:  # rounded once, not through float32's nearest
                v = self._emit("HALF", F64, v.reg, masked=v.masked)
            return self.cast(v, F32)._replace(dtype=F16, kind=pa.float16())
        if v.kind is not None and dt is not None and CODES.get(dt) != v.dtype:
            v = self.plain(v, CODES.get(dt, F64))
        if v.is_str:
            if dt not in (None, torch.int32):
                raise Refused(f"{e} (a string as {dt})", HOST_ENGINE)
            can = strings.canonical(v.dictionary)  # type: ignore[arg-type]
            if can is not None:
                v = self.lut(can[0], v)._replace(dictionary=can[1])
            return v
        if dt is not None:
            if dt not in CODES:
                raise Refused(f"{e} as {dt}", HOST_ENGINE)
            v = self.cast(v, CODES[dt])
        return v

    def finish(self, outs: List[_Val], device: Optional[torch.device]) -> Program:
        """Allocates registers: the inputs take ``0 .. nin - 1``; a register
        is free again after the last instruction that reads its value,
        unless that value is an output. The tables the live LUTs read go
        to ``device``."""
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
        used = sorted({ins.b for ins in self.code if ins.op == OP["LUT"]})
        table_of = {old: new for new, old in enumerate(used)}
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
            if ins.op == OP["LUT"]:
                fields["b"] = table_of[ins.b]
            instrs.append(ins._replace(dst=dst, **fields))
        value_reads = {r for ins in self.code if OPS[ins.op] not in ("ISNULL", "NOTNULL")
                       for r in reads(ins)} | keep
        dev = torch.device("cpu") if device is None else device
        return Program(
            tuple((name, F16 if v.kind == pa.float16() else v.dtype) for name, v in inputs),
            tuple(instrs),
            tuple(Output(phys[v.reg], v.dtype, v.masked) for v in outs), max(nregs, 1),
            tuple(v.reg not in value_reads for _, v in inputs),
            tuple(torch.from_numpy(self.tables[t]).to(dev) for t in used),
            tuple(v.dictionary for v in outs),
        )


def compile_program(
    exprs: Sequence[ColumnExpr],
    out_dtypes: Sequence[Optional[torch.dtype]],
    columns: Dict[str, Tuple[Any, ...]],
    dicts: Optional[Dict[str, np.ndarray]] = None,
    device: Optional[torch.device] = None,
) -> Program:
    """``exprs`` over a frame whose ``columns`` are ``name -> (dtype, has
    a mask[, declared uint16-64 or float16 type])`` (a dtype of None: a
    host column, which an expression may not read) and whose string
    columns' codes index ``dicts``, each output converted to its
    ``out_dtypes`` entry (None: the type it computes in; a string output
    is int32 codes; float16 stored from an F32 register), its tables on
    ``device`` (default: the CPU). Raises ``Refused`` for what K6 does
    not evaluate."""
    if not exprs:
        raise ValueError("a program computes at least one expression")
    comp = _Compiler({n: (F32 if c[0] == torch.float16 else CODES[c[0]], c[1],
                          c[2] if len(c) > 2 else
                          pa.float16() if c[0] == torch.float16 else None)
                      for n, c in columns.items() if c[0] in CODES or c[0] == torch.float16},
                     dict(dicts or {}), {n for n, c in columns.items() if c[0] is None})
    outs = [comp.output(e, comp.node(e), dt) for e, dt in zip(exprs, out_dtypes)]
    prog = comp.finish(outs, device)
    for ins in prog.instrs:
        assert ins.dtype in _VALID[OPS[ins.op]], f"no kernel for {ins}"
    return prog


def remap_program(table: torch.Tensor) -> Program:
    """One LUT over one int32 column (its mask kept by the caller): a
    string key's codes re-coded into another dictionary
    (``harmonize_string_keys``). ``table`` is int32 on the device the
    program runs on."""
    return Program((("codes", I32),), (Instr(OP["LUT"], I32, 1, 0, 0),),
                   (Output(1, I32, False),), 2, (False,), (table,), (None,))


def lut_program(table: torch.Tensor, masked: bool) -> Program:
    """One LUT over one int32 column of codes, its mask kept where
    ``masked``: each row's entry of ``table`` (any dtype K6 holds, or
    float16: a float32 table stored back as float16, exactly) at its
    code, as ``alter_columns`` casts a string's dictionary or re-codes
    segment ids into a new dictionary."""
    out = F16 if table.dtype == torch.float16 else CODES[table.dtype]
    if out == F16:
        table = table.to(torch.float32)
    code = CODES[table.dtype]
    return Program((("codes", I32),), (Instr(OP["LUT"], code, 1, 0, 0),),
                   (Output(1, out, masked),), 2, (False,), (table,), (None,))


class ProgramCache:
    """Compiled programs by the expressions' ``__uuid__``, the wanted
    output dtypes, the frame's column dtypes and masks and its string
    columns' dictionaries (by identity: an entry keeps them alive), on
    the engine's device."""

    def __init__(self) -> None:
        self._programs: Dict[Any, Tuple[Program, Any]] = {}

    def get(self, exprs: Sequence[ColumnExpr], out_dtypes: Sequence[Optional[torch.dtype]],
            columns: Dict[str, Tuple[Any, ...]],
            dicts: Optional[Dict[str, np.ndarray]] = None,
            device: Optional[torch.device] = None) -> Program:
        dicts = dicts or {}
        key = (tuple(e.__uuid__() for e in exprs), tuple(out_dtypes),
               tuple(sorted((n, *map(str, c)) for n, c in columns.items())),
               tuple(sorted((n, id(d)) for n, d in dicts.items())), str(device))
        hit = self._programs.get(key)
        if hit is None:
            prog = compile_program(exprs, out_dtypes, columns, dicts, device)
            hit = self._programs[key] = (prog, list(dicts.values()))
        return hit[0]

    def __len__(self) -> int:
        return len(self._programs)



Masked = Tuple[torch.Tensor, Optional[torch.Tensor]]

_MASK64 = (1 << 64) - 1
# structure -> generated kernel; (structure, device) -> its loaded function
_KERNELS: Dict[Any, Any] = {}
_FUNCTIONS: Dict[Tuple[Any, int], Tuple[Any, Tuple[Any, Any]]] = {}
_SMS: Dict[int, int] = {}


def kernel_dir() -> Path:
    """Where generated sources and their cubins go (git-ignored)."""
    return build.BUILD_DIR / "k6"


def _mode(filter: bool, row_valid: Optional[torch.Tensor]) -> str:
    return "columns" if not filter else "row_valid" if row_valid is not None else "prefix"


def build_kernels(specs: Sequence[Tuple[Program, Sequence[bool], str]]) -> List[Any]:
    """The generated kernels (``expr_codegen.Kernel``) of ``specs``, each
    ``(program, which inputs come with a mask, mode)`` with ``mode`` one
    of ``expr_codegen.MODES``: one ``nvcc -cubin`` for each that has no
    cubin in ``kernel_dir()`` yet, at most one a CPU core at once. A
    kernel is keyed by its source, which depends on the program's
    structure only; a cubin's name covers its source, ``expr_ops.cuh``
    and the flags. Counts the builds and their wall seconds on
    ``expr_program_cuda``; raises ``RuntimeError`` with ``nvcc``'s output
    where a build fails. Holds ``build.LOCK``: runner threads that first
    need one kernel at once build it once."""
    from fugue_tpu_torch.kernels import expr_codegen

    with build.LOCK:
        kernels = []
        for program, masked, mode in specs:
            key = expr_codegen.structure(program, masked, mode)
            kernel = _KERNELS.get(key)
            if kernel is None:
                kernel = _KERNELS[key] = expr_codegen.generate(key)
            kernels.append(kernel)
        todo = {k.name: k for k in kernels if not (kernel_dir() / f"{k.name}.cubin").exists()}
        if todo:
            start = time.perf_counter()
            jobs = []
            for name, kernel in todo.items():
                src = kernel_dir() / f"{name}.cu"
                src.parent.mkdir(parents=True, exist_ok=True)
                tmp = src.with_name(f"{src.name}.tmp{os.getpid()}")
                tmp.write_text(kernel.source)
                os.replace(tmp, src)
                jobs.append((name, [*expr_codegen.CUBIN_FLAGS, f"-I{build.KERNEL_DIR}", str(src)],
                             kernel_dir() / f"{name}.cubin"))
            try:
                build.compile_jobs(jobs, parallel=os.cpu_count())
            finally:
                expr_program_cuda.builds += len(todo)
                expr_program_cuda.build_seconds += time.perf_counter() - start
        return kernels


def _function(program: Program, masked: Tuple[bool, ...], mode: str, device: int
              ) -> Tuple[Any, Tuple[Any, Any]]:
    """The kernel of ``program`` and its vector and scalar entry points
    loaded on ``device``, built first where needed."""
    from fugue_tpu_torch.kernels import cubin, expr_codegen

    key = (expr_codegen.structure(program, masked, mode), device)
    hit = _FUNCTIONS.get(key)
    if hit is None:
        with build.LOCK:
            hit = _FUNCTIONS.get(key)
            if hit is None:
                kernel, = build_kernels([(program, masked, mode)])
                module = cubin.Module((kernel_dir() / f"{kernel.name}.cubin").read_bytes(),
                                      device)
                hit = _FUNCTIONS[key] = (kernel, (
                    module.function(kernel.name),
                    module.function(kernel.name + expr_codegen.SCALAR)))
    return hit


def pack_params(kernel: Any, program: Program, inputs: Sequence[Masked], outs: Sequence[Masked],
                n: int, nrows: int, row_valid: Optional[torch.Tensor],
                keep: Optional[torch.Tensor], count: Optional[torch.Tensor]
                ) -> Tuple[bytes, bool]:
    """The generated kernel's ``Params`` struct, byte for byte (one 8-byte
    field each of ``kernel.fields``), and whether every row pointer is
    aligned for the kernel's vector path."""
    vals: List[int] = []
    aligned = True
    for kind, i in kernel.fields:
        if kind == "n":
            vals.append(n)
        elif kind == "nrows":
            vals.append(nrows)
        elif kind == "row_valid":
            vals.append(row_valid.data_ptr())  # type: ignore[union-attr]
        elif kind == "keep":
            vals.append(keep.data_ptr())  # type: ignore[union-attr]
        elif kind == "count":
            vals.append(count.data_ptr())  # type: ignore[union-attr]
        elif kind == "in":
            vals.append(inputs[i][0].data_ptr())
        elif kind == "inm":
            vals.append(inputs[i][1].data_ptr())  # type: ignore[union-attr]
        elif kind == "out":
            vals.append(outs[i][0].data_ptr())
        elif kind == "outm":
            vals.append(outs[i][1].data_ptr())  # type: ignore[union-attr]
        elif kind == "tab":
            vals.append(program.tables[i].data_ptr())
        elif kind == "tablen":
            vals.append(int(program.tables[i].shape[0]))
        else:  # "imm"
            vals.append(program.instrs[i].imm_bits())
        if kind in _ROW_POINTERS:
            size = 1 if kind not in ("in", "out") else DTYPES[
                program.inputs[i][1] if kind == "in" else program.outputs[i].dtype].itemsize
            aligned = aligned and vals[-1] % (kernel.vec_width * size) == 0
    return struct.pack(f"<{len(vals)}Q", *[v & _MASK64 for v in vals]), aligned


# the pointers a row reads or writes, which the vector path needs aligned
_ROW_POINTERS = frozenset(("row_valid", "keep", "in", "inm", "out", "outm"))


def _check_inputs(program: Program, inputs: Sequence[Masked], n: int,
                  device: torch.device) -> None:
    if len(inputs) != len(program.inputs):
        raise ValueError(f"{len(inputs)} inputs for a program of {len(program.inputs)}")
    for t in program.tables:
        if t.device != device or t.dtype not in CODES \
                or t.dim() != 1 or t.shape[0] < 1 or not t.is_contiguous():
            raise ValueError(f"a table of {t.dtype} {tuple(t.shape)} on {t.device}: the kernel "
                             f"takes dense, non-empty tables of a dtype it holds on {device}")
    for (name, code), (v, m) in zip(program.inputs, inputs):
        for t, what, dtype in ((v, name, DTYPES[code]), (m, f"{name} mask", torch.bool)):
            if t is None:
                continue
            if t.device != device or t.dtype != dtype:
                raise ValueError(f"{what} is {t.dtype} on {t.device}, expected {dtype} on {device}")
            if tuple(t.shape) != (n,) or (n > 1 and t.stride(0) != 1):
                raise ValueError(f"{what} must be a dense 1-D tensor of {n} rows")


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
    launch of the kernel generated for ``program``'s structure
    (``expr_codegen``) over ``n`` rows on ``device`` (a CUDA device), on
    PyTorch's current stream, built at first use (``build_kernels``).
    Raises on anything else, on a failed build and on a refused launch;
    the filter's count stays on the card. ``launches`` grows by one where
    it launches, ``filter_launches`` too in filter mode; ``builds`` and
    ``build_seconds`` count the kernels built and the wall seconds it
    took. An output whose validity is an input's mask unchanged gets that
    mask tensor, as the twin's does."""
    from fugue_tpu_torch.kernels.expr_codegen import THREADS

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
        outs: List[Masked] = []
    index = device.index if device.index is not None else torch.cuda.current_device()
    masked = tuple(m is not None for _, m in inputs)
    kernel, fns = _function(program, masked, _mode(filter, row_valid), index)
    if not filter:
        outs = [(torch.empty((n,), dtype=DTYPES[o.dtype], device=device),
                 None if not o.masked else inputs[q][1] if q is not None
                 else torch.empty((n,), dtype=torch.bool, device=device))
                for o, q in zip(program.outputs, kernel.mask_aliases)]
    params, vec = pack_params(kernel, program, inputs, outs, n, nrows_arg, row_valid, keep,
                              count)
    fn = fns[0 if vec else 1]
    if kernel.indirect:  # over a launch's parameter bytes: the struct from device memory
        held = torch.frombuffer(bytearray(params), dtype=torch.uint8).to(device)
        params = struct.pack("<Q", held.data_ptr())
    # columns mode: one block a tile of rows, all at once (faster on the
    # card than one resident wave looping over the rows). A filter block
    # ends in two barriers and an atomic, so a filter takes one resident
    # wave (8 blocks of 256 an SM) that loops over the tiles.
    per_block = THREADS * (kernel.vec_width if vec else kernel.rows_per_thread)
    grid = min(-(-n // per_block), 2**31 - 1)
    if filter:
        if index not in _SMS:
            _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
        grid = min(grid, 8 * _SMS[index])
    fn.launch(grid, THREADS, torch.cuda.current_stream(device).cuda_stream, params)
    expr_program_cuda.launches += 1
    expr_program_cuda.filter_launches += int(filter)
    return (keep, count) if filter else outs


expr_program_cuda.launches = 0  # type: ignore[attr-defined]
expr_program_cuda.filter_launches = 0  # type: ignore[attr-defined]
expr_program_cuda.builds = 0  # type: ignore[attr-defined]
expr_program_cuda.build_seconds = 0.0  # type: ignore[attr-defined]
