"""Workflow tasks: units of the DAG whose ids are made from their specs,
so that the same DAG built twice gives the same ids (a port of
``fugue_tpu/workflow/tasks.py``: ``FugueTask`` ``:36``, ``TaskContext``
``:179``, ``CreateTask`` ``:196``, ``ProcessTask`` ``:209``,
``OutputTask`` ``:245``). The optimizer's in-memory result cache in front
of deterministic checkpoints (``:113-148``) is ROADMAP.md queue 1 item 11."""

from typing import Any, Dict, List, Optional

import pandas as pd
import pyarrow as pa

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.collections.yielded import Yielded
from fugue_tpu_torch.dataframe.dataframe import DataFrame, YieldedDataFrame
from fugue_tpu_torch.dataframe.dataframes import DataFrames
from fugue_tpu_torch.extensions.convert import _to_creator, _to_outputter, _to_processor
from fugue_tpu_torch.extensions.validation import validate_input_schema, validate_partition_spec
from fugue_tpu_torch.utils.hash import content_digest, to_uuid
from fugue_tpu_torch.utils.params import ParamDict
from fugue_tpu_torch.workflow.checkpoint import Checkpoint


def _ext_uuid(ext: Any) -> str:
    if hasattr(ext, "__uuid__"):
        return ext.__uuid__()
    if isinstance(ext, type):
        return to_uuid(f"{ext.__module__}.{ext.__qualname__}")
    return to_uuid(ext)


class FugueTask:
    """A node of the DAG (``:36``)."""

    def __init__(self, extension: Any, params: Any = None, schema: Any = None,
                 partition_spec: Optional[PartitionSpec] = None,
                 input_tasks: Optional[List["FugueTask"]] = None,
                 input_names: Optional[List[str]] = None):
        self.extension = extension
        self.params = ParamDict(params)
        self.schema = schema
        self.partition_spec = partition_spec or PartitionSpec()
        self.inputs = input_tasks or []
        self.input_names = input_names
        self.checkpoint: Checkpoint = Checkpoint()
        self.broadcast_result = False
        self.yields: List[Yielded] = []
        self.yield_as_local = False
        self.callsite: List[str] = []
        self._uuid: Optional[str] = None

    def __uuid__(self) -> str:
        if self._uuid is None:
            self._uuid = self._identity(False)
        return self._uuid

    def content_uuid(self) -> str:
        """The id of a deterministic checkpoint, which outlives the objects
        the task reads: ``__uuid__`` with the pandas frames and arrow
        tables of this task and those before it hashed by their rows
        (``content_digest``) where ``__uuid__`` takes each object's own id."""
        return self._identity(True)

    def _identity(self, by_content: bool) -> str:
        return to_uuid(
            type(self).__name__, _ext_uuid(self.extension), self._params_uuid(by_content),
            str(self.schema), self.partition_spec.__uuid__(),
            [t._identity(True) if by_content else t.__uuid__() for t in self.inputs],
            self.input_names)

    def _params_uuid(self, by_content: bool) -> Any:
        res: Dict[str, Any] = {}
        for k, v in self.params.items():
            if hasattr(v, "__uuid__"):
                res[k] = v.__uuid__()
            elif by_content and isinstance(v, (pd.DataFrame, pa.Table)):
                res[k] = content_digest(v)
            elif isinstance(v, (list, dict, str, int, float, bool, type(None))):
                res[k] = v
            else:
                res[k] = to_uuid(v)
        return res

    @property
    def name(self) -> str:
        ext = self.extension
        if isinstance(ext, type):
            base = ext.__name__
        elif callable(ext) and hasattr(ext, "__name__"):
            base = ext.__name__
        else:
            base = type(ext).__name__
        return f"{base}_{self.__uuid__()[:8]}"

    def execute(self, ctx: "TaskContext", inputs: List[Any]) -> Any:
        raise NotImplementedError  # pragma: no cover

    def _try_skip(self, ctx: "TaskContext") -> Optional[Any]:
        """The frame of a deterministic checkpoint whose file exists: the
        task's work is skipped (``:125``)."""
        cached = self.checkpoint.try_load(ctx.checkpoint_path)
        return None if cached is None else self._finalize(ctx, cached, run_checkpoint=False)

    def _finalize(self, ctx: "TaskContext", df: Any, run_checkpoint: bool = True) -> Any:
        if run_checkpoint:
            df = self.checkpoint.run(df, ctx.checkpoint_path)
        if self.broadcast_result:
            df = ctx.engine.broadcast(df)
        for y in self.yields:
            if isinstance(y, YieldedDataFrame):
                y.set_value(ctx.engine.convert_yield_dataframe(df, self.yield_as_local))
        return df

    def _setup_extension(self, ext: Any, ctx: "TaskContext") -> None:
        ext._params = self.params
        ext._workflow_conf = ctx.engine.conf
        ext._execution_engine = ctx.engine
        ext._partition_spec = self.partition_spec
        ext._rpc_server = ctx.rpc_server


class TaskContext:
    def __init__(self, engine: Any, rpc_server: Any, checkpoint_path: Any,
                 cancel_token: Any = None):
        self.engine = engine
        self.rpc_server = rpc_server
        self.checkpoint_path = checkpoint_path
        self.cancel_token = cancel_token


class CreateTask(FugueTask):
    def execute(self, ctx: TaskContext, inputs: List[Any]) -> Any:
        cached = self._try_skip(ctx)
        if cached is not None:
            return cached
        creator = _to_creator(self.extension, self.schema)
        self._setup_extension(creator, ctx)
        return self._finalize(ctx, ctx.engine.to_df(creator.create()))


class ProcessTask(FugueTask):
    def execute(self, ctx: TaskContext, inputs: List[Any]) -> Any:
        # the validations hold for the workflow, not the data: they run
        # even where a checkpoint skips the work (``:210-232``)
        processor = _to_processor(self.extension, self.schema)
        self._setup_extension(processor, ctx)
        rules = processor.validation_rules
        validate_partition_spec(rules, self.partition_spec)
        if "input_has" in rules or "input_is" in rules:
            inputs = [i if isinstance(i, DataFrame) else ctx.engine.to_df(i) for i in inputs]
            for i in inputs:
                validate_input_schema(rules, i.schema)
        cached = self._try_skip(ctx)
        if cached is not None:
            return cached
        df = processor.process(self._make_dfs(ctx, inputs))
        return self._finalize(ctx, ctx.engine.to_df(df))

    def _make_dfs(self, ctx: TaskContext, inputs: List[Any]) -> DataFrames:
        engine_inputs = [ctx.engine.to_df(i) for i in inputs]
        if self.input_names is not None:
            return DataFrames(dict(zip(self.input_names, engine_inputs)))
        return DataFrames(engine_inputs)


class OutputTask(FugueTask):
    def execute(self, ctx: TaskContext, inputs: List[Any]) -> Optional[Any]:
        outputter = _to_outputter(self.extension)
        self._setup_extension(outputter, ctx)
        validate_partition_spec(outputter.validation_rules, self.partition_spec)
        dfs = DataFrames(dict(zip(self.input_names, inputs)) if self.input_names is not None
                         else inputs)
        for in_df in dfs.values():
            validate_input_schema(outputter.validation_rules, in_df.schema)
        outputter.process(dfs)
        return inputs[0] if len(inputs) > 0 else None
