"""``FugueWorkflow``: the lazy DAG, built as tasks and run by ``run(engine)``
(a port of ``fugue_tpu/workflow/workflow.py``: ``WorkflowDataFrame``
``:104-521``, ``FugueWorkflow`` ``:523-1236``, ``FugueWorkflowResult``
``:1238``).

Left out, each raising ``NotImplementedError`` naming its ROADMAP.md item
(counted in the engine's ``fallbacks["workflow"]`` where a run has an
engine): the static analysis gate ``fugue.analysis=error``, ``analyze``
and ``explain`` and the optimizer's rewrite phase ``fugue.optimize=on``
(queue 1 item 11; under ``auto``, the default, the reference rewrites for
JAX engines only, so a torch DAG runs as written, and under the default
``warn`` the analyzer would only log); retries, timeouts, ``resume`` and
``fault_tolerant`` (item 10); the trace, the profiler and the HTTP RPC
server (item 13); ``yield_table_as`` (item 16).
"""

import logging
from typing import Any, Callable, Dict, List, Optional, Union
from uuid import uuid4

import pandas as pd

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.collections.sql import StructuredRawSQL, interleave_sql
from fugue_tpu_torch.collections.yielded import PhysicalYielded, Yielded
from fugue_tpu_torch.column.expressions import ColumnExpr, col, lit
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.constants import (
    FUGUE_CONF_ANALYSIS,
    FUGUE_CONF_OBS_ENABLED,
    FUGUE_CONF_OPTIMIZE,
    FUGUE_CONF_WORKFLOW_CONCURRENCY,
    FUGUE_CONF_WORKFLOW_EXCEPTION_HIDE,
    FUGUE_CONF_WORKFLOW_EXCEPTION_INJECT,
    FUGUE_CONF_WORKFLOW_EXCEPTION_OPTIMIZE,
    FUGUE_CONF_WORKFLOW_RESUME,
    FUGUE_CONF_WORKFLOW_RETRY_MAX_ATTEMPTS,
    FUGUE_CONF_WORKFLOW_TIMEOUT,
    typed_conf_get,
)
from fugue_tpu_torch.dataframe.dataframe import DataFrame, YieldedDataFrame
from fugue_tpu_torch.execution.factory import make_execution_engine
from fugue_tpu_torch.extensions.builtins import (
    Aggregate,
    AlterColumns,
    AssertEqFunc,
    AssertNotEqFunc,
    Assign,
    CreateData,
    Distinct,
    DropColumns,
    Dropna,
    Fillna,
    Filter,
    Load,
    Rename,
    RunJoin,
    RunOutputTransformer,
    RunSetOperation,
    RunSQLSelect,
    RunTransformer,
    Sample,
    Save,
    SaveAndUse,
    Select,
    SelectColumnsP,
    Show,
    Take,
    Zip,
)
from fugue_tpu_torch.rpc.base import make_rpc_server, to_rpc_handler
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw
from fugue_tpu_torch.utils.callsite import extract_user_callsite
from fugue_tpu_torch.utils.exception import add_error_note, prune_traceback
from fugue_tpu_torch.utils.hash import to_uuid
from fugue_tpu_torch.utils.params import ParamDict
from fugue_tpu_torch.workflow.checkpoint import CheckpointPath, StrongCheckpoint, WeakCheckpoint
from fugue_tpu_torch.workflow.fault import CancelToken, RetryPolicy, RunStats, execute_with_policy
from fugue_tpu_torch.workflow.runner import DAGRunner, TaskNode
from fugue_tpu_torch.workflow.tasks import (
    CreateTask,
    FugueTask,
    OutputTask,
    ProcessTask,
    TaskContext,
)

ITEM_FAULTS = "ROADMAP.md queue 1 item 10 (retries, timeouts and resume)"
ITEM_PLANNER = "ROADMAP.md queue 1 item 11 (the static analyzer and the optimizer)"
ITEM_OBS = "ROADMAP.md queue 1 item 13 (tracing, profiling and the HTTP RPC server)"
ITEM_TABLES = "ROADMAP.md queue 1 item 16 (the device table catalog)"
_OFF = ("off", "false", "0", "none", "")
_log = logging.getLogger(__name__)
_told_analysis: List[bool] = []


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the torch engine yet; see {item}")


class WorkflowDataFrame:
    """A frame of a workflow DAG (``:104``): each method adds a task;
    nothing runs until ``FugueWorkflow.run``."""

    def __init__(self, workflow: "FugueWorkflow", task: FugueTask):
        self._workflow = workflow
        self._task = task
        self._pending_partition: Optional[PartitionSpec] = None

    @property
    def workflow(self) -> "FugueWorkflow":
        return self._workflow

    @property
    def task(self) -> FugueTask:
        return self._task

    @property
    def partition_spec(self) -> PartitionSpec:
        return self._pending_partition or PartitionSpec()

    def __uuid__(self) -> str:
        return self._task.__uuid__()

    def partition(self, *args: Any, **kwargs: Any) -> "WorkflowDataFrame":
        res = WorkflowDataFrame(self._workflow, self._task)
        res._pending_partition = PartitionSpec(*args, **kwargs)
        return res

    def partition_by(self, *keys: str, **kwargs: Any) -> "WorkflowDataFrame":
        return self.partition(by=list(keys), **kwargs)

    def per_partition_by(self, *keys: str) -> "WorkflowDataFrame":
        return self.partition(by=list(keys), algo="coarse")

    def per_row(self) -> "WorkflowDataFrame":
        return self.partition("per_row")

    def transform(self, using: Any, schema: Any = None, params: Any = None,
                  pre_partition: Any = None, ignore_errors: Optional[List[type]] = None,
                  callback: Any = None) -> "WorkflowDataFrame":
        if pre_partition is None and self._pending_partition is not None:
            pre_partition = self._pending_partition
        task = ProcessTask(
            RunTransformer,
            params=dict(transformer=using, schema=schema, params=ParamDict(params),
                        ignore_errors=ignore_errors or [],
                        rpc_handler=None if callback is None else to_rpc_handler(callback)),
            partition_spec=PartitionSpec(pre_partition), input_tasks=[self._task])
        return self._workflow.add(task)

    def out_transform(self, using: Any, params: Any = None, pre_partition: Any = None,
                      ignore_errors: Optional[List[type]] = None, callback: Any = None) -> None:
        if pre_partition is None and self._pending_partition is not None:
            pre_partition = self._pending_partition
        task = OutputTask(
            RunOutputTransformer,
            params=dict(transformer=using, params=ParamDict(params),
                        ignore_errors=ignore_errors or [],
                        rpc_handler=None if callback is None else to_rpc_handler(callback)),
            partition_spec=PartitionSpec(pre_partition), input_tasks=[self._task])
        self._workflow.add(task)

    def process(self, using: Any, schema: Any = None, params: Any = None,
                pre_partition: Any = None) -> "WorkflowDataFrame":
        return self._workflow.process(self, using=using, schema=schema, params=params,
                                      pre_partition=pre_partition or self._pending_partition)

    def output(self, using: Any, params: Any = None, pre_partition: Any = None) -> None:
        self._workflow.output(self, using=using, params=params,
                              pre_partition=pre_partition or self._pending_partition)

    def join(self, *dfs: "WorkflowDataFrame", how: str, on: Optional[List[str]] = None
             ) -> "WorkflowDataFrame":
        return self._workflow.join(self, *dfs, how=how, on=on)

    def inner_join(self, *dfs: Any, on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="inner", on=on)

    def semi_join(self, *dfs: Any, on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="semi", on=on)

    def anti_join(self, *dfs: Any, on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="anti", on=on)

    def left_outer_join(self, *dfs: Any, on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="left_outer", on=on)

    def right_outer_join(self, *dfs: Any, on: Optional[List[str]] = None
                         ) -> "WorkflowDataFrame":
        return self.join(*dfs, how="right_outer", on=on)

    def full_outer_join(self, *dfs: Any, on: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self.join(*dfs, how="full_outer", on=on)

    def cross_join(self, *dfs: Any) -> "WorkflowDataFrame":
        return self.join(*dfs, how="cross")

    def union(self, *dfs: Any, distinct: bool = True) -> "WorkflowDataFrame":
        return self._workflow.set_op("union", self, *dfs, distinct=distinct)

    def subtract(self, *dfs: Any, distinct: bool = True) -> "WorkflowDataFrame":
        return self._workflow.set_op("subtract", self, *dfs, distinct=distinct)

    def intersect(self, *dfs: Any, distinct: bool = True) -> "WorkflowDataFrame":
        return self._workflow.set_op("intersect", self, *dfs, distinct=distinct)

    def distinct(self) -> "WorkflowDataFrame":
        return self._add_process(Distinct)

    def dropna(self, how: str = "any", thresh: Optional[int] = None,
               subset: Optional[List[str]] = None) -> "WorkflowDataFrame":
        params: Dict[str, Any] = dict(how=how, subset=subset)
        if thresh is not None:
            params["thresh"] = thresh
        return self._add_process(Dropna, params=params)

    def fillna(self, value: Any, subset: Optional[List[str]] = None) -> "WorkflowDataFrame":
        return self._add_process(Fillna, params=dict(value=value, subset=subset))

    def sample(self, n: Optional[int] = None, frac: Optional[float] = None,
               replace: bool = False, seed: Optional[int] = None) -> "WorkflowDataFrame":
        params: Dict[str, Any] = dict(replace=replace)
        for k, v in (("n", n), ("frac", frac), ("seed", seed)):
            if v is not None:
                params[k] = v
        return self._add_process(Sample, params=params)

    def take(self, n: int, presort: str = "", na_position: str = "last"
             ) -> "WorkflowDataFrame":
        return self._add_process(Take, params=dict(n=n, presort=presort,
                                                   na_position=na_position),
                                 partition_spec=self._pending_partition)

    def select(self, *columns: Union[str, ColumnExpr], where: Optional[ColumnExpr] = None,
               having: Optional[ColumnExpr] = None, distinct: bool = False
               ) -> "WorkflowDataFrame":
        cols = SelectColumns(*[col(c) if isinstance(c, str) else c for c in columns],
                             arg_distinct=distinct)
        return self._add_process(Select, params=dict(columns=cols, where=where, having=having))

    def filter(self, condition: ColumnExpr) -> "WorkflowDataFrame":
        return self._add_process(Filter, params=dict(condition=condition))

    def assign(self, **columns: Any) -> "WorkflowDataFrame":
        cols = [(v if isinstance(v, ColumnExpr) else lit(v)).alias(k) for k, v in columns.items()]
        return self._add_process(Assign, params=dict(columns=cols))

    def aggregate(self, **agg_kwcols: ColumnExpr) -> "WorkflowDataFrame":
        return self._add_process(Aggregate,
                                 params=dict(columns=[v.alias(k) for k, v in agg_kwcols.items()]),
                                 partition_spec=self._pending_partition)

    def rename(self, *args: Dict[str, str], **kwargs: str) -> "WorkflowDataFrame":
        columns: Dict[str, str] = {}
        for a in args:
            columns.update(a)
        columns.update(kwargs)
        return self._add_process(Rename, params=dict(columns=columns))

    def alter_columns(self, columns: Any) -> "WorkflowDataFrame":
        return self._add_process(AlterColumns, params=dict(columns=str(columns)))

    def drop(self, columns: List[str], if_exists: bool = False) -> "WorkflowDataFrame":
        return self._add_process(DropColumns, params=dict(columns=columns, if_exists=if_exists))

    def __getitem__(self, columns: List[Any]) -> "WorkflowDataFrame":
        return self._add_process(SelectColumnsP, params=dict(columns=columns))

    def zip(self, *dfs: "WorkflowDataFrame", how: str = "inner", partition: Any = None,
            temp_path: Optional[str] = None, to_file_threshold: int = -1
            ) -> "WorkflowDataFrame":
        return self._workflow.zip(self, *dfs, how=how,
                                  partition=partition or self._pending_partition,
                                  temp_path=temp_path, to_file_threshold=to_file_threshold)

    def persist(self) -> "WorkflowDataFrame":
        self._task.checkpoint = WeakCheckpoint(lazy=False)
        return self

    def weak_checkpoint(self, lazy: bool = False, **kwargs: Any) -> "WorkflowDataFrame":
        self._task.checkpoint = WeakCheckpoint(lazy=lazy, **kwargs)
        return self

    def checkpoint(self, **kwargs: Any) -> "WorkflowDataFrame":
        """A strong checkpoint in the run's temporary folder, removed after
        the run (``:364``)."""
        self._task.checkpoint = StrongCheckpoint(obj_id=str(uuid4()), deterministic=False,
                                                 permanent=False, **kwargs)
        return self

    def strong_checkpoint(self, **kwargs: Any) -> "WorkflowDataFrame":
        return self.checkpoint(**kwargs)

    def deterministic_checkpoint(self, namespace: Any = None, **kwargs: Any
                                 ) -> "WorkflowDataFrame":
        self._task.checkpoint = StrongCheckpoint(obj_id=self._task.content_uuid(),
                                                 deterministic=True, permanent=True,
                                                 namespace=namespace, **kwargs)
        return self

    def broadcast(self) -> "WorkflowDataFrame":
        self._task.broadcast_result = True
        return self

    def fault_tolerant(self, *args: Any, **kwargs: Any) -> "WorkflowDataFrame":
        """``:392``: a task's retry and timeout policy."""
        raise _unported("fault_tolerant (a task's retries and timeout)", ITEM_FAULTS)

    def yield_dataframe_as(self, name: str, as_local: bool = False) -> None:
        y = YieldedDataFrame(self._task.__uuid__())
        self._task.yields.append(y)
        self._task.yield_as_local = as_local
        self._workflow.register_yield(name, y)

    def yield_file_as(self, name: str, **kwargs: Any) -> None:
        if not isinstance(self._task.checkpoint, StrongCheckpoint):
            # a random namespace a DAG build (``:429-440``): a rebuilt DAG
            # over other data never reads a stale yield
            kwargs.setdefault("namespace", str(uuid4()))
            self._task.checkpoint = StrongCheckpoint(obj_id=self._task.__uuid__(),
                                                     deterministic=True, permanent=True, **kwargs)
        y = PhysicalYielded(self._task.__uuid__(), "file")
        self._task.checkpoint.yielded = y  # type: ignore[attr-defined]
        self._workflow.register_yield(name, y)

    def yield_table_as(self, name: str, **kwargs: Any) -> None:
        """``:445``: a yield through the SQL engine's table catalog."""
        raise _unported("yield_table_as (the table checkpoint)", ITEM_TABLES)

    def save(self, path: str, fmt: str = "", mode: str = "overwrite", partition: Any = None,
             single: bool = False, **kwargs: Any) -> None:
        self._workflow.add(OutputTask(
            Save, params=dict(path=path, fmt=fmt, mode=mode, single=single, params=kwargs),
            partition_spec=PartitionSpec(partition or self._pending_partition),
            input_tasks=[self._task]))

    def save_and_use(self, path: str, fmt: str = "", mode: str = "overwrite",
                     partition: Any = None, single: bool = False, **kwargs: Any
                     ) -> "WorkflowDataFrame":
        return self._add_process(
            SaveAndUse, params=dict(path=path, fmt=fmt, mode=mode, single=single, params=kwargs),
            partition_spec=PartitionSpec(partition or self._pending_partition))

    def show(self, n: int = 10, with_count: bool = False, title: Optional[str] = None) -> None:
        self._workflow.add(OutputTask(
            Show, params=dict(n=n, with_count=with_count, title=title or ""),
            input_tasks=[self._task]))

    def assert_eq(self, *dfs: "WorkflowDataFrame", **params: Any) -> None:
        self._workflow.assert_eq(self, *dfs, **params)

    def assert_not_eq(self, *dfs: "WorkflowDataFrame", **params: Any) -> None:
        self._workflow.assert_not_eq(self, *dfs, **params)

    def _add_process(self, ext: Any, params: Any = None,
                     partition_spec: Optional[PartitionSpec] = None) -> "WorkflowDataFrame":
        return self._workflow.add(ProcessTask(ext, params=params,
                                              partition_spec=partition_spec or PartitionSpec(),
                                              input_tasks=[self._task]))


class FugueWorkflow:
    """Builds and runs a workflow DAG (``:523``)."""

    def __init__(self, compile_conf: Any = None):
        self._tasks: List[FugueTask] = []
        self._yields: Dict[str, Yielded] = {}
        self._conf = ParamDict(compile_conf)
        # the last task's frame is made on access: a frame held here would
        # make a cycle with the workflow it holds, and the DAG with its
        # results would live until a garbage collection, whose frees on
        # the card run in whichever call it interrupts
        self._last_task: Optional[FugueTask] = None

    @property
    def yields(self) -> Dict[str, Yielded]:
        return self._yields

    @property
    def tasks(self) -> List[FugueTask]:
        return list(self._tasks)

    @property
    def last_df(self) -> Optional[WorkflowDataFrame]:
        return None if self._last_task is None else WorkflowDataFrame(self, self._last_task)

    def register_yield(self, name: str, y: Yielded) -> None:
        assert_or_throw(name not in self._yields, ValueError(f"duplicated yield {name}"))
        self._yields[name] = y

    def add(self, task: FugueTask) -> WorkflowDataFrame:
        task.callsite = extract_user_callsite(
            typed_conf_get(self._conf, FUGUE_CONF_WORKFLOW_EXCEPTION_INJECT),
            [typed_conf_get(self._conf, FUGUE_CONF_WORKFLOW_EXCEPTION_HIDE)])
        self._tasks.append(task)
        if not isinstance(task, OutputTask):
            self._last_task = task
        return WorkflowDataFrame(self, task)

    def create(self, using: Any, schema: Any = None, params: Any = None) -> WorkflowDataFrame:
        if isinstance(using, (DataFrame, pd.DataFrame)):
            # a frame is the data: the same task as ``df(data)``
            assert_or_throw(params is None or len(ParamDict(params)) == 0,
                            ValueError("params not allowed when creating from a dataframe"))
            return self.create_data(using, schema)
        return self.add(CreateTask(using, params=ParamDict(params), schema=schema))

    def df(self, data: Any, schema: Any = None) -> WorkflowDataFrame:
        return self.create_data(data, schema)

    def create_data(self, data: Any, schema: Any = None) -> WorkflowDataFrame:
        if isinstance(data, WorkflowDataFrame):
            assert_or_throw(data.workflow is self, ValueError("dataframe from another workflow"))
            return data
        return self.add(CreateTask(CreateData, params=dict(
            data=data, schema=None if schema is None else str(Schema(schema)))))

    def load(self, path: str, fmt: str = "", columns: Any = None, **kwargs: Any
             ) -> WorkflowDataFrame:
        return self.add(CreateTask(Load, params=dict(path=path, fmt=fmt, columns=columns,
                                                     params=kwargs)))

    def process(self, *dfs: Any, using: Any, schema: Any = None, params: Any = None,
                pre_partition: Any = None) -> WorkflowDataFrame:
        inputs, names = self._resolve_dfs(*dfs)
        return self.add(ProcessTask(using, params=ParamDict(params), schema=schema,
                                    partition_spec=PartitionSpec(pre_partition),
                                    input_tasks=inputs, input_names=names))

    def output(self, *dfs: Any, using: Any, params: Any = None, pre_partition: Any = None
               ) -> None:
        inputs, names = self._resolve_dfs(*dfs)
        self.add(OutputTask(using, params=ParamDict(params),
                            partition_spec=PartitionSpec(pre_partition), input_tasks=inputs,
                            input_names=names))

    def transform(self, *dfs: Any, using: Any, **kwargs: Any) -> WorkflowDataFrame:
        assert_or_throw(len(dfs) == 1, ValueError("transform takes 1 df"))
        return self.create_data(dfs[0]).transform(using, **kwargs)

    def out_transform(self, *dfs: Any, using: Any, **kwargs: Any) -> None:
        assert_or_throw(len(dfs) == 1, ValueError("out_transform takes 1 df"))
        self.create_data(dfs[0]).out_transform(using, **kwargs)

    def join(self, *dfs: Any, how: str, on: Optional[List[str]] = None) -> WorkflowDataFrame:
        inputs, names = self._resolve_dfs(*dfs)
        return self.add(ProcessTask(RunJoin, params=dict(how=how, on=on or []),
                                    input_tasks=inputs, input_names=names))

    def set_op(self, how: str, *dfs: Any, distinct: bool = True) -> WorkflowDataFrame:
        inputs, names = self._resolve_dfs(*dfs)
        return self.add(ProcessTask(RunSetOperation, params=dict(how=how, distinct=distinct),
                                    input_tasks=inputs, input_names=names))

    def union(self, *dfs: Any, distinct: bool = True) -> WorkflowDataFrame:
        return self.set_op("union", *dfs, distinct=distinct)

    def subtract(self, *dfs: Any, distinct: bool = True) -> WorkflowDataFrame:
        return self.set_op("subtract", *dfs, distinct=distinct)

    def intersect(self, *dfs: Any, distinct: bool = True) -> WorkflowDataFrame:
        return self.set_op("intersect", *dfs, distinct=distinct)

    def zip(self, *dfs: Any, how: str = "inner", partition: Any = None,
            temp_path: Optional[str] = None, to_file_threshold: int = -1) -> WorkflowDataFrame:
        inputs, names = self._resolve_dfs(*dfs)
        return self.add(ProcessTask(
            Zip, params=dict(how=how, temp_path=temp_path, to_file_threshold=to_file_threshold),
            partition_spec=PartitionSpec(partition), input_tasks=inputs, input_names=names))

    def select(self, *statements: Any, statement: Any = None,
               dfs: Optional[Dict[str, Any]] = None, dialect: Optional[str] = None
               ) -> WorkflowDataFrame:
        """A SELECT on the engine's SQL facet: one statement (positional or
        ``statement=``) with ``dfs={name: df}``, or fragments and frames
        interleaved (``:703``)."""
        if statement is not None:
            assert_or_throw(len(statements) == 0,
                            ValueError("pass the statement positionally OR by keyword"))
            statements = (statement,)
        if len(statements) == 1 and isinstance(statements[0], (str, StructuredRawSQL)):
            statement = statements[0]
        else:
            parts, inline = interleave_sql(statements)
            statement = StructuredRawSQL(parts, dialect=dialect)
            dfs = {**(dfs or {}), **inline}
        named = {k: self.create_data(v) for k, v in (dfs or {}).items()}
        if isinstance(statement, str):
            statement = StructuredRawSQL([(False, statement)], dialect=dialect)
        return self.add(ProcessTask(
            RunSQLSelect, params=dict(statement=statement),
            input_tasks=[v.task for v in named.values()],
            input_names=list(named.keys()) if len(named) > 0 else None))

    def assert_eq(self, *dfs: Any, **params: Any) -> None:
        self.output(*dfs, using=AssertEqFunc, params=params)

    def assert_not_eq(self, *dfs: Any, **params: Any) -> None:
        self.output(*dfs, using=AssertNotEqFunc, params=params)

    def show(self, *dfs: Any, n: int = 10, with_count: bool = False,
             title: Optional[str] = None) -> None:
        self.output(*dfs, using=Show, params=dict(n=n, with_count=with_count, title=title or ""))

    def analyze(self, *args: Any, **kwargs: Any) -> List[Any]:
        """``:762``: the static analyzer."""
        raise _unported("analyze (the static analyzer)", ITEM_PLANNER)

    def explain(self, *args: Any, **kwargs: Any) -> Any:
        """``:796``: EXPLAIN, the optimizer's plan."""
        raise _unported("explain (the optimizer's plan report)", ITEM_PLANNER)

    def _setting(self, e: Any, key: str) -> Any:
        """``key``'s value: the engine's conf (the run's conf merged into
        it) where it holds the key, else the workflow's compile conf."""
        return typed_conf_get(e.conf if key in e.conf else self._conf, key)

    def _refuse_unported(self, e: Any) -> None:
        """Refuses (``fallbacks["workflow"]``) what the run's conf asks
        for and the port leaves out (the module's docstring)."""
        optimize = str(self._setting(e, FUGUE_CONF_OPTIMIZE)).strip().lower()
        if optimize in ("on", "true", "1"):
            e._unported("workflow", f"{FUGUE_CONF_OPTIMIZE}={optimize} (the rewrite phase)",
                        ITEM_PLANNER)
        assert_or_throw(optimize in _OFF or optimize == "auto", ValueError(
            f"invalid {FUGUE_CONF_OPTIMIZE} mode {optimize!r}: expected off | on | auto"))
        analysis = str(self._setting(e, FUGUE_CONF_ANALYSIS)).strip().lower()
        if analysis == "error":
            e._unported("workflow", f"{FUGUE_CONF_ANALYSIS}=error (the analysis gate)",
                        ITEM_PLANNER)
        assert_or_throw(analysis in _OFF or analysis in ("warn", "true", "on", "1"), ValueError(
            f"invalid {FUGUE_CONF_ANALYSIS} mode {analysis!r}: expected off | warn | error"))
        if analysis not in _OFF and not _told_analysis:
            _told_analysis.append(True)
            _log.info("%s=%s: the static analyzer is not ported (%s); the DAG runs unchecked",
                      FUGUE_CONF_ANALYSIS, analysis, ITEM_PLANNER)
        for key, asked in (
            (FUGUE_CONF_WORKFLOW_RETRY_MAX_ATTEMPTS, lambda v: v > 1),
            (FUGUE_CONF_WORKFLOW_TIMEOUT, lambda v: v > 0),
            (FUGUE_CONF_WORKFLOW_RESUME, bool),
        ):
            value = self._setting(e, key)
            if asked(value):
                e._unported("workflow", f"{key}={value}", ITEM_FAULTS)
        if self._setting(e, FUGUE_CONF_OBS_ENABLED):
            e._unported("workflow", f"{FUGUE_CONF_OBS_ENABLED} (the trace and the profiler)",
                        ITEM_OBS)

    def run(self, engine: Any = None, conf: Any = None, cancel_token: Any = None
            ) -> "FugueWorkflowResult":
        """Runs the DAG on ``engine`` (``:876``; ``:978-1083``, without
        the analysis gate, the rewrite phase, the manifest and the
        profiler). ``cancel_token``, a ``CancelToken`` of the caller's,
        cancels the run at the next task where it is set."""
        e = make_execution_engine(engine, conf)
        self._refuse_unported(e)
        try:
            rpc_server = make_rpc_server(e.conf)
        except NotImplementedError:
            e._count_fallback("workflow")
            raise
        checkpoint_path = CheckpointPath(e)
        token = cancel_token if cancel_token is not None else CancelToken()
        stats = RunStats()
        ctx = TaskContext(e, rpc_server, checkpoint_path, cancel_token=token)
        concurrency = typed_conf_get(e.conf, FUGUE_CONF_WORKFLOW_CONCURRENCY)
        started_rpc = in_ctx = False
        try:
            rpc_server.start()
            started_rpc = True
            e.as_context()
            in_ctx = True
            checkpoint_path.init_temp_path(str(uuid4()))
            index_of = {id(t): i for i, t in enumerate(self._tasks)}
            nodes = [
                TaskNode(t.__uuid__() + f"_{i}", self._make_task_func(t, ctx, token),
                         [inp.__uuid__() + f"_{index_of[id(inp)]}" for inp in t.inputs],
                         name=t.name, callsite=t.callsite)
                for i, t in enumerate(self._tasks)
            ]
            try:
                DAGRunner(concurrency).run(nodes, cancel_token=token)
            except Exception as ex:
                if typed_conf_get(self._conf, FUGUE_CONF_WORKFLOW_EXCEPTION_OPTIMIZE):
                    hide = [typed_conf_get(self._conf, FUGUE_CONF_WORKFLOW_EXCEPTION_HIDE),
                            "concurrent.futures.", "threading"]
                    raise ex.with_traceback(prune_traceback(ex.__traceback__, hide)
                                            ) from ex.__cause__
                raise
        finally:
            if in_ctx:
                e.stop_context()
            checkpoint_path.remove_temp_path()
            if started_rpc:
                rpc_server.stop()
        return FugueWorkflowResult(self._yields, stats=stats)

    def _make_task_func(self, task: FugueTask, ctx: TaskContext, token: CancelToken
                        ) -> Callable:
        def run_task(inputs: List[Any]) -> Any:
            try:
                return execute_with_policy(lambda: task.execute(ctx, inputs), RetryPolicy(),
                                           token=token)
            except Exception as ex:
                self._reraise_with_callsite(task, ex)

        return run_task

    def _reraise_with_callsite(self, task: FugueTask, ex: Exception) -> None:
        """The failing task's name and the user's line that defined it, as
        a note on the error (``:1209``)."""
        note = f"in task {task.name}"
        if task.callsite:
            note += ", defined at:\n" + "\n".join(task.callsite)
        add_error_note(ex, note)
        raise ex

    def __enter__(self) -> "FugueWorkflow":
        return self

    def __exit__(self, exc_type: Any, *args: Any) -> None:
        if exc_type is None:
            self.run()

    def __uuid__(self) -> str:
        return to_uuid([t.__uuid__() for t in self._tasks])

    def _resolve_dfs(self, *dfs: Any) -> Any:
        if len(dfs) == 1 and isinstance(dfs[0], dict):
            named = {k: self.create_data(v) for k, v in dfs[0].items()}
            return [v.task for v in named.values()], list(named.keys())
        return [self.create_data(d).task for d in dfs], None


class FugueWorkflowResult:
    """A run's yields and fault statistics (``:1238``)."""

    def __init__(self, yields: Dict[str, Yielded], stats: Any = None):
        self._yields = yields
        self._stats = stats

    @property
    def yields(self) -> Dict[str, Yielded]:
        return self._yields

    @property
    def fault_stats(self) -> Dict[str, Any]:
        return self._stats.as_dict() if self._stats is not None else {}

    def __getitem__(self, name: str) -> Any:
        y = self._yields[name]
        return y.result if isinstance(y, YieldedDataFrame) else y
