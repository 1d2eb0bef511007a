"""Aggregation constructors: ``sum``, ``avg``/``mean``, ``count``,
``count_distinct``, ``min``, ``max``, ``first`` and ``last``, the scalar
``like``, ``case_when`` and ``coalesce``, and ``is_agg`` (a trimmed copy
of ``fugue_tpu/column/functions.py:14-104``), and ``VARIANCE_FUNCS``. As in
the original, median and the variance family have no constructor: they
are ``_FuncExpr(name, col, is_aggregation=True)``."""

import builtins
from typing import Any

from fugue_tpu_torch.column.expressions import (
    VARIANCE_FUNCS,
    ColumnExpr,
    _BinaryOpExpr,
    _FuncExpr,
    _to_col,
    _UnaryOpExpr,
)
from fugue_tpu_torch.utils.assertion import assert_or_throw

__all__ = [
    "VARIANCE_FUNCS", "avg", "case_when", "coalesce", "count", "count_distinct", "first",
    "is_agg", "last", "like", "max", "mean", "min", "sum",
]


def _agg(name: str, col: Any, arg_distinct: bool = False) -> ColumnExpr:
    return _FuncExpr(
        name, _to_col(col), arg_distinct=arg_distinct, is_aggregation=True
    )


def sum(col: Any) -> ColumnExpr:  # noqa: A001
    return _agg("sum", col)


def avg(col: Any) -> ColumnExpr:
    return _agg("avg", col)


mean = avg


def count(col: Any) -> ColumnExpr:
    return _agg("count", col)


def count_distinct(col: Any) -> ColumnExpr:
    return _agg("count", col, arg_distinct=True)


def min(col: Any) -> ColumnExpr:  # noqa: A001
    return _agg("min", col)


def max(col: Any) -> ColumnExpr:  # noqa: A001
    return _agg("max", col)


def first(col: Any) -> ColumnExpr:
    return _agg("first", col)


def last(col: Any) -> ColumnExpr:
    return _agg("last", col)


def like(col: Any, pattern: str, negated: bool = False) -> ColumnExpr:
    """SQL ``LIKE`` with a literal pattern (``%`` and ``_`` wildcards;
    ``:67``)."""
    assert_or_throw(isinstance(pattern, str), ValueError("LIKE pattern must be a string"))
    return _FuncExpr("like", _to_col(col), pattern, bool(negated))


def case_when(*args: Any) -> ColumnExpr:
    """``CASE WHEN c1 THEN v1 [WHEN c2 THEN v2 ...] ELSE d END``: condition
    and value pairs, then the default (``:75``)."""
    assert_or_throw(
        len(args) >= 3 and len(args) % 2 == 1,
        ValueError("case_when takes cond/value pairs plus a default"),
    )
    return _FuncExpr("case_when", *[_to_col(a) for a in args])


def coalesce(*args: Any) -> ColumnExpr:
    """The first non-null argument of each row (``:88``)."""
    assert_or_throw(len(args) > 0, ValueError("coalesce requires at least one arg"))
    return _FuncExpr("coalesce", *[_to_col(a) for a in args])


def is_agg(column: Any) -> bool:
    """Whether the expression holds an aggregation at any level (``:93``)."""
    if isinstance(column, _FuncExpr) and column.is_aggregation:
        return True
    if isinstance(column, _BinaryOpExpr):
        return is_agg(column.left) or is_agg(column.right)
    if isinstance(column, _UnaryOpExpr):
        return is_agg(column.col)
    if isinstance(column, _FuncExpr):
        return builtins.any(is_agg(a) for a in column.args)
    return False
