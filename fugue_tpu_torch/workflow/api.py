"""The DAG's front door (a port of ``fugue_tpu/workflow/api.py``:
``transform`` ``:15``, ``out_transform`` ``:56``, ``raw_sql`` ``:77``):
each builds a one-step ``FugueWorkflow`` and runs it on the engine, which
is the one given, else the context engine, else a torch engine on the
device of a port frame among the inputs, else on CUDA. ``explain``
(``:100``) is ROADMAP.md queue 1 item 11."""

from typing import Any, List, Optional

from fugue_tpu_torch.collections.sql import StructuredRawSQL, interleave_sql
from fugue_tpu_torch.collections.yielded import Yielded
from fugue_tpu_torch.dataframe.dataframe import DataFrame
from fugue_tpu_torch.execution.factory import make_execution_engine
from fugue_tpu_torch.torch_backend.zipped import TorchZippedDataFrame
from fugue_tpu_torch.workflow.workflow import FugueWorkflow


def transform(df: Any, using: Any, schema: Any = None, params: Any = None, partition: Any = None,
              callback: Any = None, ignore_errors: Optional[List[type]] = None,
              persist: bool = False, as_local: bool = False, as_fugue: bool = False,
              engine: Any = None, engine_conf: Any = None) -> Any:
    """``using`` (a function annotated ``Dict[str, torch.Tensor] ->
    Dict[str, torch.Tensor]``, a Transformer or a registered alias) over
    ``df``, partitioned by ``partition`` where given; over a zip
    (``ft.zip``), ``using`` is a cotransformer. The result is pandas,
    or the engine's frame with ``as_fugue`` or where ``df`` is a frame
    (``:49-52``); ``as_local`` brings it to the host first."""
    dag = FugueWorkflow()
    src = dag.create_data(df)
    if partition is not None:
        src = src.partition(partition)
    tdf = src.transform(using, schema=schema, params=params, ignore_errors=ignore_errors,
                        callback=callback)
    if persist:
        tdf = tdf.persist()
    tdf.yield_dataframe_as("result", as_local=as_local)
    dag.run(make_execution_engine(engine, engine_conf, infer_by=[df]))
    result = dag.yields["result"].result  # type: ignore[attr-defined]
    if as_fugue or isinstance(df, (DataFrame, Yielded, TorchZippedDataFrame)):
        return result
    return result.as_pandas()


def out_transform(df: Any, using: Any, params: Any = None, partition: Any = None,
                  callback: Any = None, ignore_errors: Optional[List[type]] = None,
                  engine: Any = None, engine_conf: Any = None) -> None:
    """``using`` over ``df`` for its side effects only (``:56``)."""
    dag = FugueWorkflow()
    src = dag.create_data(df)
    if partition is not None:
        src = src.partition(partition)
    src.out_transform(using, params=params, ignore_errors=ignore_errors, callback=callback)
    dag.run(make_execution_engine(engine, engine_conf, infer_by=[df]))


def raw_sql(*statements: Any, engine: Any = None, engine_conf: Any = None,
            as_fugue: bool = False, as_local: bool = False) -> Any:
    """A SELECT mixing string fragments and frames, on the engine's SQL
    facet: ``raw_sql("SELECT k, SUM(v) AS s FROM", df, "GROUP BY k")``
    (``:77``). Pandas, or the engine's frame with ``as_fugue`` or where
    a frame of the port was among the inputs."""
    dag = FugueWorkflow()
    parts, dfs = interleave_sql(statements)
    named = {k: dag.create_data(v) for k, v in dfs.items()}
    tdf = dag.select(StructuredRawSQL(parts), dfs=named if len(named) > 0 else None)
    tdf.yield_dataframe_as("result", as_local=as_local)
    dag.run(make_execution_engine(engine, engine_conf, infer_by=list(dfs.values())))
    result = dag.yields["result"].result  # type: ignore[attr-defined]
    if as_fugue or any(isinstance(x, DataFrame) for x in dfs.values()):
        return result
    return result.as_pandas()
