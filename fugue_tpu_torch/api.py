"""The port's entry points: ``transform``, ``out_transform`` and
``raw_sql`` run a one-step workflow DAG (``fugue_tpu_torch/workflow/api.py``,
``fugue_tpu/workflow/api.py:15-77``) through the port's own tasks,
extensions and runner; ``aggregate``, ``select``, ``filter``, ``assign``,
``join``, ``union``, ``subtract``, ``intersect``, ``distinct``,
``dropna``, ``fillna``, ``sample``, ``take``, ``repartition``, ``zip``
(``transform`` of a zip is a co-transform), ``load`` and ``save`` run
straight on the engine, as ``fugue_tpu/execution/api.py`` does; and the
frame's own column operations and conversions (``rename``,
``drop_columns``, ``select_columns``, ``alter_columns``, ``head``,
``peek_array``, ``peek_dict``, ``as_array``, ``as_array_iterable``,
``as_dict_iterable``, ``fugue_tpu/dataframe/api.py:70-128``), which take a
frame of the port, pandas or arrow. ``aggregate`` of a
``LocalDataFrameIterableDataFrame`` streams it chunk by chunk.

``transform`` runs a transformer annotated ``Dict[str, torch.Tensor] ->
Dict[str, torch.Tensor]``, the counterpart of the JAX package's
``Dict[str, jax.Array]`` parameter (code ``"j"``,
``fugue_tpu/jax_backend/registry.py:25-32``), over whole columns on the
card. ``select``, ``filter``, ``assign`` and ``aggregate`` mirror
``fugue_tpu/execution/api.py:306-351``, ``join``
``fugue_tpu/execution/api.py:129-150``, the set operations, ``distinct``,
``dropna``, ``fillna``, ``sample``, ``take`` and ``repartition``
``fugue_tpu/execution/api.py:96-276``, ``load`` and ``save``
``fugue_tpu/execution/api.py:278-300``. All take pandas, arrow or a
``TorchDataFrame``; they return pandas, or the ``TorchDataFrame`` when
``as_fugue=True`` or the input was one.
"""

from typing import Any, Dict, Iterable, List, Optional, Union

import pandas as pd
import pyarrow as pa

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.column.expressions import ColumnExpr, col, lit
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.dataframe import ArrowDataFrame, DataFrame
from fugue_tpu_torch.dataframe.utils import pandas_to_table
from fugue_tpu_torch.execution.factory import make_execution_engine
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.torch_backend.zipped import TorchZippedDataFrame
from fugue_tpu_torch.workflow.api import out_transform, raw_sql, transform  # noqa: F401


def _engine(engine: Any, df: Any, conf: Any = None) -> Any:
    return make_execution_engine(engine, conf, infer_by=[df])


def _result(res: TorchDataFrame, df: Any, as_fugue: bool) -> Any:
    if as_fugue or isinstance(df, TorchDataFrame):
        return res
    return res.as_pandas()


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


def load(path: Union[str, List[str]], format_hint: Any = None, columns: Any = None,
         engine: Any = None, engine_conf: Any = None, as_fugue: bool = False,
         **kwargs: Any) -> Any:
    """The files at ``path`` (parquet, csv or json; a file, a folder of
    part files or a hive folder) on the engine's device:
    ``load("data.parquet", engine=e)``; with ``engine_conf``
    ``{"fugue.torch.io.batch_rows": n}`` a parquet load streams and stays
    in storage until a device operation needs it
    (``TorchExecutionEngine.load_df``). Returns pandas, or the
    ``TorchDataFrame`` with ``as_fugue=True``."""
    e = _engine(engine, None, engine_conf)
    return _result(e.load_df(path, format_hint=format_hint, columns=columns, **kwargs), None,
                   as_fugue)


def save(df: Any, path: str, format_hint: Any = None, mode: str = "overwrite",
         partition: Any = None, force_single: bool = False, engine: Any = None,
         engine_conf: Any = None, **kwargs: Any) -> None:
    """Writes ``df`` to ``path`` (``mode`` overwrite, append or error;
    ``partition``'s keys as a hive folder unless ``force_single``):
    ``save(result, "out.parquet", engine=e)``
    (``TorchExecutionEngine.save_df``)."""
    e = _engine(engine, df, engine_conf)
    e.save_df(df, path, format_hint=format_hint, mode=mode,
              partition_spec=None if partition is None else PartitionSpec(partition),
              force_single=force_single, **kwargs)


# ---- the frame's column operations and conversions (``fugue_tpu/dataframe/api.py:70-128``) ----

def _as_frame(df: Any) -> DataFrame:
    """``as_fugue_df``: a frame of the port as it is; pandas or arrow as an
    ``ArrowDataFrame`` on the host (the reference's local frames), with no
    upload."""
    if isinstance(df, DataFrame):
        return df
    if isinstance(df, pd.DataFrame):
        return ArrowDataFrame(pandas_to_table(df))
    if isinstance(df, pa.Table):
        return ArrowDataFrame(df)
    raise NotImplementedError(f"no conversion from {type(df)} to a DataFrame")


def _adjust(result: DataFrame, original: Any, as_fugue: bool) -> Any:
    """The result as a frame of the port, or as the original's own kind
    (pandas, arrow) where it was one and ``as_fugue`` is not set."""
    if as_fugue or isinstance(original, DataFrame):
        return result
    if isinstance(original, pd.DataFrame):
        return result.as_pandas()
    if isinstance(original, pa.Table):
        return result.as_arrow()
    return result


def rename(df: Any, columns: Dict[str, Any], as_fugue: bool = False) -> Any:
    """``df`` with columns renamed ``{old: new}`` at once."""
    if len(columns) == 0:
        return df
    return _adjust(_as_frame(df).rename(columns), df, as_fugue)


def drop_columns(df: Any, columns: List[str], as_fugue: bool = False) -> Any:
    return _adjust(_as_frame(df).drop(columns), df, as_fugue)


def select_columns(df: Any, columns: List[Any], as_fugue: bool = False) -> Any:
    return _adjust(_as_frame(df)[columns], df, as_fugue)


def alter_columns(df: Any, columns: Any, as_fugue: bool = False) -> Any:
    """``df`` with the columns of the schema expression ``columns`` cast to
    their new types (on the card for a ``TorchDataFrame``)."""
    return _adjust(_as_frame(df).alter_columns(columns), df, as_fugue)


def head(df: Any, n: int, columns: Optional[List[str]] = None, as_fugue: bool = False) -> Any:
    """The first ``n`` rows (of ``columns``): a local frame, or the
    original's kind."""
    return _adjust(_as_frame(df).head(n, columns), df, as_fugue)


def peek_array(df: Any) -> List[Any]:
    return _as_frame(df).peek_array()


def peek_dict(df: Any) -> Dict[str, Any]:
    return _as_frame(df).peek_dict()


def as_array(df: Any, columns: Optional[List[str]] = None, type_safe: bool = False
             ) -> List[Any]:
    return _as_frame(df).as_array(columns, type_safe)


def as_array_iterable(df: Any, columns: Optional[List[str]] = None, type_safe: bool = False
                      ) -> Iterable[Any]:
    return _as_frame(df).as_array_iterable(columns, type_safe)


def as_dict_iterable(df: Any, columns: Optional[List[str]] = None) -> Iterable[Dict[str, Any]]:
    return _as_frame(df).as_dict_iterable(columns)
