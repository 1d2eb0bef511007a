"""The column expression tree: named columns, literals, unary and binary
operators, casts and function calls (scalar functions and aggregations).

A trimmed copy of ``fugue_tpu/column/expressions.py:15`` (``ColumnExpr``)
holding what the port's slices evaluate. ``__uuid__`` is the same identity
as the original's, so two spellings of one expression dedup to one
aggregate payload, and ``infer_type`` gives the original's declared types.
"""

from typing import Any, Dict, List, Optional, Union

import pyarrow as pa

from fugue_tpu_torch.schema import _SIMPLE_TYPES, Schema, type_to_expr
from fugue_tpu_torch.utils.assertion import assert_or_throw
from fugue_tpu_torch.utils.hash import to_uuid

# the variance family (``fugue_tpu/column/functions.py:14``), here so that
# ``infer_type`` and the aggregate's checks read one definition
VARIANCE_FUNCS = (
    "stddev", "stddev_samp", "stddev_pop",
    "variance", "var_samp", "var_pop",
)

_PY_TYPES: Dict[Any, pa.DataType] = {
    int: pa.int64(),
    float: pa.float64(),
    str: pa.string(),
    bool: pa.bool_(),
    bytes: pa.binary(),
}


class ColumnExpr:
    """Base of all column expressions."""

    def __init__(self) -> None:
        self._as_name = ""
        self._as_type: Optional[pa.DataType] = None

    @property
    def name(self) -> str:
        """The inherent name ('' when the expression has none)."""
        return ""

    @property
    def as_name(self) -> str:
        return self._as_name

    @property
    def as_type(self) -> Optional[pa.DataType]:
        return self._as_type

    @property
    def output_name(self) -> str:
        return self._as_name if self._as_name != "" else self.name

    def alias(self, as_name: str) -> "ColumnExpr":
        res = self._copy()
        res._as_name = as_name
        res._as_type = self._as_type
        return res

    def cast(self, data_type: Any) -> "ColumnExpr":
        """The expression converted to ``data_type`` (a pyarrow type, a
        type name of the schema syntax, or ``int``/``float``/``str``/
        ``bool``/``bytes``; ``:46``)."""
        res = self._copy()
        res._as_name = self._as_name
        if data_type is None or isinstance(data_type, pa.DataType):
            res._as_type = data_type
        elif isinstance(data_type, str):
            assert_or_throw(
                data_type.lower() in _SIMPLE_TYPES,
                ValueError(f"can't cast to {data_type!r}"),
            )
            res._as_type = _SIMPLE_TYPES[data_type.lower()]
        else:
            assert_or_throw(
                data_type in _PY_TYPES, ValueError(f"can't cast to {data_type!r}")
            )
            res._as_type = _PY_TYPES[data_type]
        return res

    def _copy(self) -> "ColumnExpr":  # pragma: no cover - overridden
        raise NotImplementedError

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        """Output type against an input schema; None when not inferrable."""
        return self._as_type

    def infer_schema_field(self, schema: Schema) -> pa.Field:
        name = self.output_name
        assert_or_throw(name != "", ValueError(f"{self} has no output name"))
        tp = self.infer_type(schema)
        assert_or_throw(tp is not None, ValueError(f"can't infer type of {self}"))
        return pa.field(name, tp)

    def __eq__(self, other: Any) -> "ColumnExpr":  # type: ignore[override]
        return _BinaryOpExpr("==", self, _to_col(other))

    def __ne__(self, other: Any) -> "ColumnExpr":  # type: ignore[override]
        return _BinaryOpExpr("!=", self, _to_col(other))

    def __lt__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("<", self, _to_col(other))

    def __le__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("<=", self, _to_col(other))

    def __gt__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr(">", self, _to_col(other))

    def __ge__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr(">=", self, _to_col(other))

    def __add__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("+", self, _to_col(other))

    def __radd__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("+", _to_col(other), self)

    def __sub__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("-", self, _to_col(other))

    def __rsub__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("-", _to_col(other), self)

    def __mul__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("*", self, _to_col(other))

    def __rmul__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("*", _to_col(other), self)

    def __truediv__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("/", self, _to_col(other))

    def __rtruediv__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("/", _to_col(other), self)

    def __and__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("&", self, _to_col(other))

    def __rand__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("&", _to_col(other), self)

    def __or__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("|", self, _to_col(other))

    def __ror__(self, other: Any) -> "ColumnExpr":
        return _BinaryOpExpr("|", _to_col(other), self)

    def __invert__(self) -> "ColumnExpr":
        return _UnaryOpExpr("~", self)

    def __neg__(self) -> "ColumnExpr":
        return _UnaryOpExpr("-", self)

    def is_null(self) -> "ColumnExpr":
        return _UnaryOpExpr("IS_NULL", self)

    def not_null(self) -> "ColumnExpr":
        return _UnaryOpExpr("NOT_NULL", self)

    def __uuid__(self) -> str:
        return to_uuid(
            type(self).__name__, self._as_name, str(self._as_type), self._uuid_keys()
        )

    def _uuid_keys(self) -> List[Any]:  # pragma: no cover - overridden
        return []

    def __hash__(self) -> int:
        return hash(self.__uuid__())

    def __bool__(self) -> bool:
        raise ValueError("ColumnExpr can't be used as a boolean")

    def __repr__(self) -> str:
        return str(self)


def _to_col(obj: Any) -> ColumnExpr:
    if isinstance(obj, ColumnExpr):
        return obj
    return lit(obj)


def _with_cast(body: str, tp: Optional[pa.DataType]) -> str:
    return body if tp is None else f"CAST({body} AS {type_to_expr(tp)})"


class _NamedColumnExpr(ColumnExpr):
    def __init__(self, name: str):
        super().__init__()
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    @property
    def wildcard(self) -> bool:
        return self._name == "*"

    def _copy(self) -> ColumnExpr:
        return _NamedColumnExpr(self._name)

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self._as_type is not None:
            return self._as_type
        if self.wildcard:
            return None
        return schema[self._name].type if self._name in schema else None

    def _uuid_keys(self) -> List[Any]:
        return [self._name]

    def __str__(self) -> str:
        res = _with_cast(self._name, self._as_type)
        if self._as_name != "":
            return f"{res} AS {self._as_name}"
        return res


class _LitColumnExpr(ColumnExpr):
    def __init__(self, value: Any):
        super().__init__()
        assert_or_throw(
            value is None or isinstance(value, (int, float, str, bool)),
            NotImplementedError(f"{value!r} is not a valid literal"),
        )
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    def _copy(self) -> ColumnExpr:
        return _LitColumnExpr(self._value)

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self._as_type is not None:
            return self._as_type
        if self._value is None:
            return pa.null()
        if isinstance(self._value, bool):
            return pa.bool_()
        if isinstance(self._value, int):
            return pa.int64()
        if isinstance(self._value, float):
            return pa.float64()
        return pa.string()

    def _uuid_keys(self) -> List[Any]:
        return [self._value]

    def __str__(self) -> str:
        if self._value is None:
            body = "NULL"
        elif isinstance(self._value, bool):
            body = "TRUE" if self._value else "FALSE"
        elif isinstance(self._value, str):
            body = "'" + self._value.replace("'", "''") + "'"
        else:
            body = str(self._value)
        if self._as_name != "":
            return f"{body} AS {self._as_name}"
        return body


class _UnaryOpExpr(ColumnExpr):
    """``-x``, ``NOT x`` (``~``), ``x IS NULL`` and ``x IS NOT NULL``
    (``:268``)."""

    def __init__(self, op: str, col: ColumnExpr):
        super().__init__()
        self._op = op
        self._col = col

    @property
    def op(self) -> str:
        return self._op

    @property
    def col(self) -> ColumnExpr:
        return self._col

    def _copy(self) -> ColumnExpr:
        return _UnaryOpExpr(self._op, self._col)

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self._as_type is not None:
            return self._as_type
        if self._op in ("IS_NULL", "NOT_NULL"):
            return pa.bool_()
        return self._col.infer_type(schema)

    def _uuid_keys(self) -> List[Any]:
        return [self._op, self._col.__uuid__()]

    def __str__(self) -> str:
        if self._op == "IS_NULL":
            body = f"{self._col} IS NULL"
        elif self._op == "NOT_NULL":
            body = f"{self._col} IS NOT NULL"
        elif self._op == "~":
            body = f"(NOT {self._col})"
        else:
            body = f"{self._op}({self._col})"
        if self._as_name != "":
            return f"{body} AS {self._as_name}"
        return body


COMPARISON_OPS = ("==", "!=", "<", "<=", ">", ">=")
LOGICAL_OPS = ("&", "|")


class _BinaryOpExpr(ColumnExpr):
    def __init__(self, op: str, left: ColumnExpr, right: ColumnExpr):
        super().__init__()
        self._op = op
        self._left = left
        self._right = right

    @property
    def op(self) -> str:
        return self._op

    @property
    def left(self) -> ColumnExpr:
        return self._left

    @property
    def right(self) -> ColumnExpr:
        return self._right

    def _copy(self) -> ColumnExpr:
        return _BinaryOpExpr(self._op, self._left, self._right)

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self._as_type is not None:
            return self._as_type
        if self._op in COMPARISON_OPS or self._op in LOGICAL_OPS:
            return pa.bool_()
        lt = self._left.infer_type(schema)
        rt = self._right.infer_type(schema)
        if lt is None or rt is None:
            return None
        return _promote(lt, rt, self._op)

    def _uuid_keys(self) -> List[Any]:
        return [self._op, self._left.__uuid__(), self._right.__uuid__()]

    def __str__(self) -> str:
        op = {"==": "=", "&": "AND", "|": "OR"}.get(self._op, self._op)
        body = f"({self._left} {op} {self._right})"
        if self._as_name != "":
            return f"{body} AS {self._as_name}"
        return body


class _FuncExpr(ColumnExpr):
    def __init__(
        self,
        func: str,
        *args: Any,
        arg_distinct: bool = False,
        is_aggregation: bool = False,
    ):
        super().__init__()
        self._func = func
        self._args: List[ColumnExpr] = [_to_col(a) for a in args]
        self._arg_distinct = arg_distinct
        self._is_agg = is_aggregation

    @property
    def func(self) -> str:
        return self._func

    @property
    def args(self) -> List[ColumnExpr]:
        return self._args

    @property
    def arg_distinct(self) -> bool:
        return self._arg_distinct

    @property
    def is_aggregation(self) -> bool:
        return self._is_agg

    def _copy(self) -> ColumnExpr:
        return _FuncExpr(
            self._func,
            *self._args,
            arg_distinct=self._arg_distinct,
            is_aggregation=self._is_agg,
        )

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        """The declared result types (``fugue_tpu/column/expressions.py:395-457``):
        count is int64; avg, median and the variance family float64; min,
        max, first and last keep the argument's type, and so does sum
        except that an integer sum is int64. Of the scalar functions:
        COALESCE takes its first non-null argument's type, CASE WHEN the
        promotion of its value branches (a NULL default left out), IF its
        THEN branch's (else its ELSE branch's), ``abs``, NULLIF and
        ``mod`` their first argument's; floor, ceil and sign are int64,
        the rest of the numeric functions float64."""
        if self._as_type is not None:
            return self._as_type
        f = self._func.lower()
        if f in ("count", "count_distinct"):
            return pa.int64()
        if f in ("avg", "mean", "median", *VARIANCE_FUNCS):
            return pa.float64()
        if f in ("min", "max", "sum", "first", "last") and len(self._args) == 1:
            t = self._args[0].infer_type(schema)
            if f == "sum" and t is not None and pa.types.is_integer(t):
                return pa.int64()
            return t
        if f == "coalesce":
            types = [a.infer_type(schema) for a in self._args]
            types = [t for t in types if t is not None and not pa.types.is_null(t)]
            return types[0] if types else None
        if f == "like":
            return pa.bool_()
        if f in ("abs", "nullif"):
            return self._args[0].infer_type(schema)
        if f in (
            "round", "sqrt", "exp", "ln", "log", "log2", "log10",
            "sin", "cos", "tan", "power", "pow",
        ):
            return pa.float64()
        if f in ("floor", "ceil", "ceiling", "sign", "length", "len"):
            return pa.int64()
        if f == "mod":
            t = self._args[0].infer_type(schema)
            return t if t is not None else pa.int64()
        if f in ("if", "iif") and len(self._args) == 3:
            return self._args[1].infer_type(schema) or self._args[2].infer_type(schema)
        if f in (
            "upper", "ucase", "lower", "lcase", "trim", "ltrim", "rtrim",
            "reverse", "substring", "substr", "concat", "replace",
        ):
            return pa.string()
        if f == "case_when":
            # value branches: args 1, 3, ... and the trailing default
            vals = [
                a for i, a in enumerate(self._args)
                if i % 2 == 1 or i == len(self._args) - 1
            ]
            types = [a.infer_type(schema) for a in vals]
            types = [t for t in types if t is not None and not pa.types.is_null(t)]
            if not types:
                return None
            out = types[0]
            for t in types[1:]:
                if t == out:
                    continue
                p = _promote(out, t, "+")
                if p is None:
                    return None
                out = p
            return out
        return None

    def _uuid_keys(self) -> List[Any]:
        return [
            self._func,
            self._arg_distinct,
            self._is_agg,
            [a.__uuid__() for a in self._args],
        ]

    def __str__(self) -> str:
        distinct = "DISTINCT " if self._arg_distinct else ""
        args = ",".join(str(a) for a in self._args)
        body = _with_cast(f"{self._func.upper()}({distinct}{args})", self._as_type)
        if self._as_name != "":
            return f"{body} AS {self._as_name}"
        return body


def _promote(
    lt: pa.DataType, rt: pa.DataType, op: str
) -> Optional[pa.DataType]:
    """The declared type of ``lt op rt`` (``:479``): float64 for ``/``,
    else the higher of the two in bool < int8 < ... < float64. Two
    different types outside that ladder (uint8 beside another type
    included) have none."""
    if op == "/":
        return pa.float64()
    if lt == rt:
        return lt
    numeric_rank = [
        pa.bool_(), pa.int8(), pa.int16(), pa.int32(), pa.int64(),
        pa.float16(), pa.float32(), pa.float64(),
    ]
    if lt in numeric_rank and rt in numeric_rank:
        return numeric_rank[
            max(numeric_rank.index(lt), numeric_rank.index(rt))
        ]
    if pa.types.is_string(lt) or pa.types.is_string(rt):
        return pa.string()
    return None


def col(obj: Union[str, ColumnExpr], alias: str = "") -> ColumnExpr:
    """Reference a column by name (``col("*")`` is the wildcard)."""
    if isinstance(obj, ColumnExpr):
        return obj.alias(alias) if alias != "" else obj
    if isinstance(obj, str):
        res: ColumnExpr = _NamedColumnExpr(obj)
        return res.alias(alias) if alias != "" else res
    raise ValueError(f"invalid column reference {obj!r}")


def lit(obj: Any, alias: str = "") -> ColumnExpr:
    res: ColumnExpr = _LitColumnExpr(obj)
    return res.alias(alias) if alias != "" else res


def null() -> ColumnExpr:
    """The NULL literal (``:509``)."""
    return lit(None)


def function(name: str, *args: Any, arg_distinct: bool = False) -> ColumnExpr:
    """A scalar function call by name (``:517``): ``function("mod",
    col("a"), 7)``."""
    return _FuncExpr(name, *args, arg_distinct=arg_distinct)
