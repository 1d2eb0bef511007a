"""The column expression tree: named columns, literals, ``+ - * /`` and
function calls (aggregations).

A trimmed copy of ``fugue_tpu/column/expressions.py:15`` (``ColumnExpr``)
holding what the port's slice evaluates. ``__uuid__`` is the same identity
as the original's, so two spellings of one expression dedup to one
aggregate payload.
"""

from typing import Any, List, Optional, Union

import pyarrow as pa

from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw
from fugue_tpu_torch.utils.hash import to_uuid

# the variance family (``fugue_tpu/column/functions.py:14``), here so that
# ``infer_type`` and the aggregate's checks read one definition
VARIANCE_FUNCS = (
    "stddev", "stddev_samp", "stddev_pop",
    "variance", "var_samp", "var_pop",
)


class ColumnExpr:
    """Base of all column expressions."""

    def __init__(self) -> None:
        self._as_name = ""

    @property
    def name(self) -> str:
        """The inherent name ('' when the expression has none)."""
        return ""

    @property
    def as_name(self) -> str:
        return self._as_name

    @property
    def output_name(self) -> str:
        return self._as_name if self._as_name != "" else self.name

    def alias(self, as_name: str) -> "ColumnExpr":
        res = self._copy()
        res._as_name = as_name
        return res

    def _copy(self) -> "ColumnExpr":  # pragma: no cover - overridden
        raise NotImplementedError

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        """Output type against an input schema; None when not inferrable."""
        return None

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

    def __uuid__(self) -> str:
        # "None" stands where the original hashes its (absent) cast type
        return to_uuid(
            type(self).__name__, self._as_name, "None", self._uuid_keys()
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
        if self.wildcard:
            return None
        return schema[self._name].type if self._name in schema else None

    def _uuid_keys(self) -> List[Any]:
        return [self._name]

    def __str__(self) -> str:
        if self._as_name != "":
            return f"{self._name} AS {self._as_name}"
        return self._name


class _LitColumnExpr(ColumnExpr):
    def __init__(self, value: Any):
        super().__init__()
        assert_or_throw(
            value is None or isinstance(value, (int, float, bool)),
            NotImplementedError(f"{value!r} is not a numeric literal"),
        )
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    def _copy(self) -> ColumnExpr:
        return _LitColumnExpr(self._value)

    def infer_type(self, schema: Schema) -> Optional[pa.DataType]:
        if self._value is None:
            return pa.null()
        if isinstance(self._value, bool):
            return pa.bool_()
        if isinstance(self._value, int):
            return pa.int64()
        return pa.float64()

    def _uuid_keys(self) -> List[Any]:
        return [self._value]

    def __str__(self) -> str:
        if self._value is None:
            body = "NULL"
        elif isinstance(self._value, bool):
            body = "TRUE" if self._value else "FALSE"
        else:
            body = str(self._value)
        if self._as_name != "":
            return f"{body} AS {self._as_name}"
        return body


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
        lt = self._left.infer_type(schema)
        rt = self._right.infer_type(schema)
        if lt is None or rt is None:
            return None
        return _promote(lt, rt, self._op)

    def _uuid_keys(self) -> List[Any]:
        return [self._op, self._left.__uuid__(), self._right.__uuid__()]

    def __str__(self) -> str:
        body = f"({self._left} {self._op} {self._right})"
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
        """The aggregations' result types
        (``fugue_tpu/column/expressions.py:395-425``): count is int64;
        avg, median and the variance family float64; min, max, first and
        last keep the argument's type, and so does sum except that an
        integer sum is int64."""
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
        body = f"{self._func.upper()}({distinct}{args})"
        if self._as_name != "":
            return f"{body} AS {self._as_name}"
        return body


def _promote(
    lt: pa.DataType, rt: pa.DataType, op: str
) -> Optional[pa.DataType]:
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
