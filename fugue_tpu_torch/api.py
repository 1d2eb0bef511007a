"""The port's entry points: ``transform``, ``aggregate``, ``select``,
``filter``, ``assign``, ``join``, ``union``, ``subtract``, ``intersect``,
``distinct``, ``dropna``, ``fillna``, ``sample``, ``take``,
``repartition``, ``raw_sql`` and ``zip`` (``transform`` of a zip is a
co-transform), run straight on the engine with no workflow DAG (the DAG
is not ported yet). ``aggregate`` of a ``LocalDataFrameIterableDataFrame``
streams it chunk by chunk.

``transform`` mirrors ``fugue_tpu/workflow/api.py:15`` for a transformer
annotated ``Dict[str, torch.Tensor] -> Dict[str, torch.Tensor]``, the
counterpart of the JAX package's ``Dict[str, jax.Array]`` parameter
(code ``"j"``, ``fugue_tpu/jax_backend/registry.py:25-32``). ``select``,
``filter``, ``assign`` and ``aggregate`` mirror
``fugue_tpu/execution/api.py:306-351``, ``join``
``fugue_tpu/execution/api.py:129-150``, the set operations, ``distinct``,
``dropna``, ``fillna``, ``sample``, ``take`` and ``repartition``
``fugue_tpu/execution/api.py:96-276``, ``raw_sql``
``fugue_tpu/workflow/api.py:77``. All take pandas, arrow or a
``TorchDataFrame``; they return pandas, or the ``TorchDataFrame`` when
``as_fugue=True`` or the input was one.
"""

import typing
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.collections.sql import StructuredRawSQL, interleave_sql
from fugue_tpu_torch.column.expressions import ColumnExpr, col, lit
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.execution.factory import make_execution_engine
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.torch_backend.execution_engine import TorchExecutionEngine
from fugue_tpu_torch.torch_backend.zipped import TorchZippedDataFrame

def _engine(engine: Any, df: Any) -> TorchExecutionEngine:
    if engine is None and isinstance(df, TorchDataFrame):
        return make_execution_engine(device=df.device)
    return make_execution_engine(engine)


def _is_tensor_dict(hint: Any) -> bool:
    """``Dict[str, torch.Tensor]`` or ``dict[str, torch.Tensor]``."""
    return typing.get_origin(hint) is dict and typing.get_args(hint) == (str, torch.Tensor)


def _check_torch_transformer(func: Callable, engine: TorchExecutionEngine, n: int = 1,
                             op: str = "map") -> None:
    """Refuses (counted under ``op``) a function that is not annotated
    with ``n`` ``Dict[str, torch.Tensor]`` parameters (one a zipped member
    for a cotransformer) and a ``Dict[str, torch.Tensor]`` return."""
    try:
        hints = typing.get_type_hints(func)
    except (NameError, TypeError):
        hints = {}
    params = [h for k, h in hints.items() if k != "return"]
    if not (len(params) == n and all(_is_tensor_dict(p) for p in params)
            and _is_tensor_dict(hints.get("return"))):
        what = "transformer" if op == "map" else "cotransformer"
        engine._unported(
            op,
            f"{what} {getattr(func, '__name__', func)!r} (the port runs only functions "
            f"annotated with {n} Dict[str, torch.Tensor] parameter(s) -> "
            f"Dict[str, torch.Tensor]; other {what}s need the host engine)",
            "ROADMAP.md queue 1 item 2(b)" if op == "comap" else "ROADMAP.md queue 1 item 2",
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
    how a torch transformer uses them). Where ``df`` is a zip (``zip``),
    ``using`` is a cotransformer, one dict a member
    (``TorchExecutionEngine.comap``), as ``dag.df(a).partition_by("k").
    zip(b).transform(cm, schema=...)`` runs it in the JAX package."""
    spec = None if partition is None else PartitionSpec(partition)
    if isinstance(df, TorchZippedDataFrame):
        e = _engine(engine, df.frames[0])
        _check_torch_transformer(using, e, len(df.frames), "comap")
        return _result(e.comap(df, using, schema, spec), df, as_fugue)
    e = _engine(engine, df)
    _check_torch_transformer(using, e)
    return _result(e.map_engine.map_dataframe(df, using, schema, spec), df, as_fugue)


def zip(*dfs: Any, how: str = "inner", partition: Any = None,  # noqa: A001
        engine: Any = None) -> TorchZippedDataFrame:
    """The frames ``dfs`` zipped by ``how`` (inner, left_outer,
    right_outer, full_outer or cross) on ``partition``'s keys (default:
    the columns they all have; none for cross), for ``transform`` to
    co-transform: ``transform(zip(a, b, partition="k"), cm, schema)``
    calls ``cm(a_dict, b_dict)`` once over every key, the dicts in the
    members' order (``TorchExecutionEngine.comap`` gives their ABI). Pass
    a dict ``{name: frame}`` as the one argument to name the members; the
    names stay on the handle."""
    frames: Any = dfs[0] if len(dfs) == 1 and isinstance(dfs[0], dict) else list(dfs)
    first = next(iter(frames.values()) if isinstance(frames, dict) else iter(frames), None)
    e = _engine(engine, first)
    return e.zip(frames, how=how, partition_spec=None if partition is None
                 else PartitionSpec(partition))


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


def _fold(op: str, df1: Any, df2: Any, dfs: Any, distinct: bool, engine: Any,
          as_fugue: bool) -> Any:
    """``df1`` and ``df2`` through the engine's ``op``, then the result and
    each of ``dfs`` in turn."""
    e = _engine(engine, df1)
    res = getattr(e, op)(df1, df2, distinct=distinct)
    for df in dfs:
        res = getattr(e, op)(res, df, distinct=distinct)
    return _result(res, df1, as_fugue)


def union(df1: Any, df2: Any, *dfs: Any, distinct: bool = True, engine: Any = None,
          as_fugue: bool = False) -> Any:
    """The rows of every frame (of one schema), each distinct row once
    unless ``distinct=False``: ``union(a, b, c)``."""
    return _fold("union", df1, df2, dfs, distinct, engine, as_fugue)


def subtract(df1: Any, df2: Any, *dfs: Any, distinct: bool = True, engine: Any = None,
             as_fugue: bool = False) -> Any:
    """``df1 EXCEPT df2`` (then of each of ``dfs``), or ``EXCEPT ALL``
    with ``distinct=False``."""
    return _fold("subtract", df1, df2, dfs, distinct, engine, as_fugue)


def intersect(df1: Any, df2: Any, *dfs: Any, distinct: bool = True, engine: Any = None,
              as_fugue: bool = False) -> Any:
    """``df1 INTERSECT df2`` (then with each of ``dfs``), or ``INTERSECT
    ALL`` with ``distinct=False``."""
    return _fold("intersect", df1, df2, dfs, distinct, engine, as_fugue)


def distinct(df: Any, engine: Any = None, as_fugue: bool = False) -> Any:
    """Each distinct row of ``df`` once, at its first occurrence."""
    e = _engine(engine, df)
    return _result(e.distinct(df), df, as_fugue)


def dropna(df: Any, how: str = "any", thresh: Optional[int] = None,
           subset: Optional[List[str]] = None, engine: Any = None, as_fugue: bool = False) -> Any:
    """The rows of ``df`` without a null (``how="any"``), with a value
    (``"all"``) or with at least ``thresh`` values in ``subset`` (default:
    every column); a float NaN is a value here, as in the JAX package."""
    e = _engine(engine, df)
    return _result(e.dropna(df, how=how, thresh=thresh, subset=subset), df, as_fugue)


def fillna(df: Any, value: Any, subset: Optional[List[str]] = None, engine: Any = None,
           as_fugue: bool = False) -> Any:
    """``df`` with the nulls (and a float's NaN) of ``subset`` (default:
    every column) filled with ``value``, or of each column of a dict with
    its value: ``fillna(df, {"a": 0, "s": "none"})``."""
    e = _engine(engine, df)
    return _result(e.fillna(df, value=value, subset=subset), df, as_fugue)


def sample(df: Any, n: Optional[int] = None, frac: Optional[float] = None,
           replace: bool = False, seed: Optional[int] = None, engine: Any = None,
           as_fugue: bool = False) -> Any:
    """``n`` rows, or a fraction ``frac`` of them, drawn at random (the
    same ones for the same ``seed``), with or without replacement."""
    e = _engine(engine, df)
    return _result(e.sample(df, n=n, frac=frac, replace=replace, seed=seed), df, as_fugue)


def take(df: Any, n: int, presort: str = "", na_position: str = "last", partition: Any = None,
         engine: Any = None, as_fugue: bool = False) -> Any:
    """The first ``n`` rows of ``df`` under ``presort`` (``"a asc, b
    desc"``; none: row order), of each partition of ``partition`` where
    given, nulls first or last by ``na_position``:
    ``take(df, 10, presort="v desc", partition="k")``."""
    e = _engine(engine, df)
    spec = None if partition is None else PartitionSpec(partition)
    return _result(e.take(df, n=n, presort=presort, na_position=na_position,
                          partition_spec=spec), df, as_fugue)


def repartition(df: Any, partition: Any, engine: Any = None, as_fugue: bool = False) -> Any:
    """``df`` reordered into the partitions of ``partition``:
    ``repartition(df, {"algo": "hash", "num": 8, "by": ["k"]})`` puts
    equal keys together, ``"rand"`` shuffles the rows."""
    e = _engine(engine, df)
    return _result(e.repartition(df, PartitionSpec(partition)), df, as_fugue)


def raw_sql(*statements: Any, engine: Any = None, as_fugue: bool = False) -> Any:
    """A SQL SELECT mixing string fragments and frames, run on the
    engine's SQL facet (``fugue_tpu/workflow/api.py:77``, without the
    workflow DAG): ``raw_sql("SELECT k, SUM(v) AS s FROM", df, "GROUP BY
    k ORDER BY s DESC LIMIT 10")``. Joins, set operations, DISTINCT,
    subqueries, CTEs, window functions, NOT IN and ORDER BY/LIMIT/OFFSET
    run on the card; a shape the algebra bridge does not lower raises
    ``NotImplementedError`` naming ROADMAP.md queue 1 item 2(b)."""
    parts, dfs = interleave_sql(statements)
    frames = list(dfs.values())
    e = _engine(engine, next((f for f in frames if isinstance(f, TorchDataFrame)), None))
    res = e.sql_engine.select(dfs, StructuredRawSQL(parts))
    if as_fugue or any(isinstance(f, TorchDataFrame) for f in frames):
        return res
    return res.as_pandas()
