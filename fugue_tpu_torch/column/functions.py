"""Aggregation constructors ``sum``, ``avg``/``mean``, ``count`` and the
rest of the original's names (a trimmed copy of
``fugue_tpu/column/functions.py:40``). Only sum/avg/count run in the port's
slice; the engine refuses the others with ``NotImplementedError``."""

from typing import Any

from fugue_tpu_torch.column.expressions import ColumnExpr, _FuncExpr, _to_col


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
