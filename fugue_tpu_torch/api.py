"""The port's entry points: ``transform``, ``aggregate``, ``select``,
``filter``, ``assign`` and ``join``, run straight on the engine with no
workflow DAG (the DAG is not ported yet).

``transform`` mirrors ``fugue_tpu/workflow/api.py:15`` for a transformer
annotated ``Dict[str, torch.Tensor] -> Dict[str, torch.Tensor]``, the
counterpart of the JAX package's ``Dict[str, jax.Array]`` parameter
(code ``"j"``, ``fugue_tpu/jax_backend/registry.py:25-32``). ``select``,
``filter``, ``assign`` and ``aggregate`` mirror
``fugue_tpu/execution/api.py:306-351``, ``join``
``fugue_tpu/execution/api.py:129-150``. All take pandas, arrow or a
``TorchDataFrame``; they return pandas, or the ``TorchDataFrame`` when
``as_fugue=True`` or the input was one.
"""

import typing
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.column.expressions import ColumnExpr, col, lit
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.execution.factory import make_execution_engine
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.torch_backend.execution_engine import TorchExecutionEngine

def _engine(engine: Any, df: Any) -> TorchExecutionEngine:
    if engine is None and isinstance(df, TorchDataFrame):
        return make_execution_engine(device=df.device)
    return make_execution_engine(engine)


def _is_tensor_dict(hint: Any) -> bool:
    """``Dict[str, torch.Tensor]`` or ``dict[str, torch.Tensor]``."""
    return typing.get_origin(hint) is dict and typing.get_args(hint) == (str, torch.Tensor)


def _check_torch_transformer(func: Callable, engine: TorchExecutionEngine) -> None:
    try:
        hints = typing.get_type_hints(func)
    except (NameError, TypeError):
        hints = {}
    params = [h for k, h in hints.items() if k != "return"]
    if not (params and _is_tensor_dict(params[0]) and _is_tensor_dict(hints.get("return"))):
        engine._unported(
            "map",
            f"transformer {getattr(func, '__name__', func)!r} (the port runs "
            "only functions annotated Dict[str, torch.Tensor] -> "
            "Dict[str, torch.Tensor]; other transformers need the host map "
            "engine)",
            "ROADMAP.md queue 1 item 2",
        )


def _result(res: TorchDataFrame, df: Any, as_fugue: bool) -> Any:
    if as_fugue or isinstance(df, TorchDataFrame):
        return res
    return res.as_pandas()


def transform(
    df: Any,
    using: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
    schema: Any,
    engine: Any = None,
    as_fugue: bool = False,
    partition: Any = None,
) -> Any:
    """Run ``using`` over whole columns of ``df`` on the engine's device;
    ``schema`` names and types the output columns. ``partition``
    (``{"by": [...]}``, a key or a list of keys) hands ``using`` the
    segment id of each row's group as ``_segment_ids`` and the size of the
    id space as ``_num_segments`` (``TorchMapEngine._compiled_map`` says
    how a torch transformer uses them)."""
    e = _engine(engine, df)
    _check_torch_transformer(using, e)
    res = e.map_engine.map_dataframe(
        df, using, schema, None if partition is None else PartitionSpec(partition)
    )
    return _result(res, df, as_fugue)


def aggregate(
    df: Any,
    partition_by: Any = None,
    engine: Any = None,
    as_fugue: bool = False,
    **agg_kwcols: ColumnExpr,
) -> Any:
    """Aggregate ``df`` by the ``partition_by`` keys:
    ``aggregate(df, "k", s=sum(col("v")), c=count(col("v")))``."""
    e = _engine(engine, df)
    cols = [v.alias(k) for k, v in agg_kwcols.items()]
    spec = None if partition_by is None else PartitionSpec(by=partition_by)
    return _result(e.aggregate(df, spec, cols), df, as_fugue)


def select(
    df: Any,
    *columns: Union[str, ColumnExpr],
    where: Optional[ColumnExpr] = None,
    having: Optional[ColumnExpr] = None,
    distinct: bool = False,
    engine: Any = None,
    as_fugue: bool = False,
) -> Any:
    """``SELECT columns FROM df [WHERE where] [GROUP BY the columns that
    are not aggregations] [HAVING having]``:
    ``select(df, "k", sum(col("v")).alias("s"), where=col("v") > 0)``."""
    e = _engine(engine, df)
    cols = SelectColumns(*[col(c) if isinstance(c, str) else c for c in columns],
                         arg_distinct=distinct)
    return _result(e.select(df, cols, where=where, having=having), df, as_fugue)


def filter(  # noqa: A001
    df: Any, condition: ColumnExpr, engine: Any = None, as_fugue: bool = False
) -> Any:
    """The rows of ``df`` where ``condition`` is true (not false, not
    NULL)."""
    e = _engine(engine, df)
    return _result(e.filter(df, condition), df, as_fugue)


def assign(df: Any, engine: Any = None, as_fugue: bool = False, **columns: Any) -> Any:
    """``df`` with new or replaced columns: ``assign(df, w=col("v") * 2)``;
    a value that is not an expression is a literal."""
    e = _engine(engine, df)
    cols = [(v if isinstance(v, ColumnExpr) else lit(v)).alias(k) for k, v in columns.items()]
    return _result(e.assign(df, cols), df, as_fugue)


def join(
    df1: Any,
    df2: Any,
    *dfs: Any,
    how: str,
    on: Optional[List[str]] = None,
    engine: Any = None,
    as_fugue: bool = False,
) -> Any:
    """``df1`` joined to ``df2``, then the result to each of ``dfs`` in
    turn, all by ``how`` (inner, left_outer, right_outer, full_outer,
    semi, anti or cross) on the keys ``on`` (default: the columns the two
    frames share): ``join(facts, dims, how="inner", on=["k"])``."""
    e = _engine(engine, df1)
    res = e.join(df1, df2, how=how, on=on)
    for df in dfs:
        res = e.join(res, df, how=how, on=on)
    return _result(res, df1, as_fugue)
