"""Aggregation constructors: ``sum``, ``avg``/``mean``, ``count``,
``count_distinct``, ``min``, ``max``, ``first`` and ``last`` (a trimmed
copy of ``fugue_tpu/column/functions.py:14-64``), and ``VARIANCE_FUNCS``.
As in the original, median and the variance family have no constructor:
they are ``_FuncExpr(name, col, is_aggregation=True)``."""

from typing import Any

from fugue_tpu_torch.column.expressions import VARIANCE_FUNCS, ColumnExpr, _FuncExpr, _to_col

__all__ = [
    "VARIANCE_FUNCS", "avg", "count", "count_distinct", "first", "last", "max", "mean",
    "min", "sum",
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
