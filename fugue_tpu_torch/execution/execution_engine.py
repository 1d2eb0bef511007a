"""The engine's base classes, trimmed from
``fugue_tpu/execution/execution_engine.py``: ``FugueEngineBase`` (``:55``),
``EngineFacet`` (``:76``), ``MapEngine`` (``:98``), ``SQLEngine``
(``:125``) and ``ExecutionEngine`` (``:161``), with the surface the
workflow and its built-in extensions call: ``conf``, ``log``, the
``map_engine`` and ``sql_engine`` facets, the relational methods,
``to_df``, ``persist``, ``broadcast``, ``zip``/``comap``,
``load_df``/``save_df``, ``convert_yield_dataframe``, ``load_yielded`` and
the context an engine enters while a workflow runs on it
(``try_get_context_engine`` finds it).

The reference's default bodies of ``select``, ``filter``, ``assign``,
``aggregate`` and the serialized ``zip``/``comap`` evaluate on the host
with pandas; here they are abstract, since the port's one engine runs
them on its device and the host engine is ROADMAP.md queue 1 item 2(b).
"""

import logging
from abc import ABC, abstractmethod
from contextvars import ContextVar
from threading import RLock, local
from typing import Any, Callable, List, Optional, Union

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.collections.sql import StructuredRawSQL
from fugue_tpu_torch.collections.yielded import PhysicalYielded, Yielded
from fugue_tpu_torch.column.expressions import ColumnExpr
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.dataframe.dataframe import DataFrame, YieldedDataFrame
from fugue_tpu_torch.utils.params import ParamDict

_CONTEXT_ENGINE: ContextVar[Optional["ExecutionEngine"]] = ContextVar(
    "fugue_tpu_torch_engine", default=None)
_GLOBAL_LOCK = RLock()
_GLOBAL_ENGINE: List[Optional["ExecutionEngine"]] = [None]


class FugueEngineBase(ABC):
    @property
    def log(self) -> logging.Logger:
        return logging.getLogger(type(self).__name__)

    @property
    @abstractmethod
    def conf(self) -> ParamDict:  # pragma: no cover - interface
        raise NotImplementedError

    @abstractmethod
    def to_df(self, df: Any, schema: Any = None) -> DataFrame:  # pragma: no cover
        raise NotImplementedError


class EngineFacet(FugueEngineBase):
    """A facet of an engine (its map or SQL engine), sharing its conf and
    log."""

    def __init__(self, execution_engine: "ExecutionEngine"):
        self._execution_engine = execution_engine

    @property
    def execution_engine(self) -> "ExecutionEngine":
        return self._execution_engine

    @property
    def conf(self) -> ParamDict:
        return self._execution_engine.conf

    @property
    def log(self) -> logging.Logger:
        return self._execution_engine.log

    def to_df(self, df: Any, schema: Any = None) -> DataFrame:
        return self._execution_engine.to_df(df, schema)


class MapEngine(EngineFacet):
    """The map primitive a transform lowers to (``:98``)."""

    @abstractmethod
    def map_dataframe(
        self,
        df: DataFrame,
        map_func: Callable[..., Any],
        output_schema: Any,
        partition_spec: PartitionSpec,
        on_init: Optional[Callable[[int, DataFrame], Any]] = None,
        map_func_format_hint: Optional[str] = None,
    ) -> DataFrame:  # pragma: no cover - interface
        raise NotImplementedError


class SQLEngine(EngineFacet):
    """The SQL facet: a SELECT over named frames (``:125``)."""

    @abstractmethod
    def select(self, dfs: Any, statement: StructuredRawSQL) -> DataFrame:  # pragma: no cover
        raise NotImplementedError

    @abstractmethod
    def load_table(self, table: str, **kwargs: Any) -> DataFrame:  # pragma: no cover
        raise NotImplementedError


class ExecutionEngine(FugueEngineBase):
    """The backend contract (``:161``)."""

    def __init__(self, conf: Any = None):
        self._conf = ParamDict(conf)
        self._map_engine: Optional[MapEngine] = None
        self._sql_engine: Optional[SQLEngine] = None
        self._in_context_count = 0
        self._is_global = False
        # a ContextVar token is reset by the thread that set it: each
        # thread keeps its own stack (``:187-192``)
        self._ctx_local = local()
        self._ctx_lock = RLock()
        self._stopped = False

    # ---- context (``:204-314``) ---------------------------------------
    @property
    def in_context(self) -> bool:
        return self._in_context_count > 0

    def as_context(self) -> "ExecutionEngine":
        """Makes this the context engine: ``with engine.as_context():``."""
        with self._ctx_lock:
            self._in_context_count += 1
        stack = getattr(self._ctx_local, "tokens", None)
        if stack is None:
            stack = self._ctx_local.tokens = []
        stack.append(_CONTEXT_ENGINE.set(self))
        return self

    def __enter__(self) -> "ExecutionEngine":
        return self

    def __exit__(self, *args: Any) -> None:
        self.stop_context()

    def stop_context(self) -> None:
        stack = getattr(self._ctx_local, "tokens", None)
        if stack:
            _CONTEXT_ENGINE.reset(stack.pop())
        with self._ctx_lock:
            if self._in_context_count == 0:
                return
            self._in_context_count -= 1
            should_stop = self._in_context_count == 0 and not self._is_global
        if should_stop:
            self.stop()

    def set_global(self) -> "ExecutionEngine":
        with _GLOBAL_LOCK:
            old = _GLOBAL_ENGINE[0]
            if old is not None and old is not self:
                old._is_global = False
            self._is_global = True
            _GLOBAL_ENGINE[0] = self
        return self

    def unset_global(self) -> None:
        with _GLOBAL_LOCK:
            if _GLOBAL_ENGINE[0] is self:
                _GLOBAL_ENGINE[0] = None
            self._is_global = False

    def stop(self) -> None:
        with self._ctx_lock:
            if not self._stopped:
                self._stopped = True
                self.stop_engine()

    def stop_engine(self) -> None:  # pragma: no cover - hook
        pass

    # ---- facets --------------------------------------------------------
    @property
    def conf(self) -> ParamDict:
        return self._conf

    @property
    def map_engine(self) -> MapEngine:
        assert self._map_engine is not None
        return self._map_engine

    @map_engine.setter
    def map_engine(self, engine: MapEngine) -> None:
        self._map_engine = engine

    @property
    def sql_engine(self) -> SQLEngine:
        assert self._sql_engine is not None
        return self._sql_engine

    @sql_engine.setter
    def sql_engine(self, engine: SQLEngine) -> None:
        self._sql_engine = engine

    def get_current_parallelism(self) -> int:
        return 1

    # ---- the primitives the built-in extensions call --------------------
    @abstractmethod
    def persist(self, df: Any, lazy: bool = False, **kwargs: Any) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    def broadcast(self, df: Any) -> DataFrame:
        """One device holds every frame whole: a broadcast is ``to_df``."""
        return self.to_df(df)

    @abstractmethod
    def repartition(self, df: Any, partition_spec: PartitionSpec) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def join(self, df1: Any, df2: Any, how: str, on: Optional[List[str]] = None) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def union(self, df1: Any, df2: Any, distinct: bool = True) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def subtract(self, df1: Any, df2: Any, distinct: bool = True) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def intersect(self, df1: Any, df2: Any, distinct: bool = True) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def distinct(self, df: Any) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def dropna(self, df: Any, how: str = "any", thresh: Optional[int] = None,
               subset: Optional[List[str]] = None) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def fillna(self, df: Any, value: Any, subset: Optional[List[str]] = None) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def sample(self, df: Any, n: Optional[int] = None, frac: Optional[float] = None,
               replace: bool = False, seed: Optional[int] = None) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def take(self, df: Any, n: int, presort: str, na_position: str = "last",
             partition_spec: Optional[PartitionSpec] = None) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def select(self, df: Any, cols: SelectColumns, where: Optional[ColumnExpr] = None,
               having: Optional[ColumnExpr] = None) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def filter(self, df: Any, condition: ColumnExpr) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def assign(self, df: Any, columns: List[ColumnExpr]) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def aggregate(self, df: Any, partition_spec: Optional[PartitionSpec],
                  agg_cols: List[ColumnExpr]) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def zip(self, dfs: Any, how: str = "inner", partition_spec: Optional[PartitionSpec] = None,
            temp_path: Optional[str] = None, to_file_threshold: int = -1) -> Any:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def comap(self, df: Any, map_func: Callable[..., Any], output_schema: Any,
              partition_spec: Optional[PartitionSpec] = None,
              on_init: Optional[Callable[[int, Any], Any]] = None) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def load_df(self, path: Union[str, List[str]], format_hint: Any = None,
                columns: Any = None, **kwargs: Any) -> DataFrame:
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def save_df(self, df: Any, path: str, format_hint: Any = None, mode: str = "overwrite",
                partition_spec: Optional[PartitionSpec] = None, force_single: bool = False,
                **kwargs: Any) -> None:
        raise NotImplementedError  # pragma: no cover

    # ---- yields (``:756-775``) -----------------------------------------
    def convert_yield_dataframe(self, df: DataFrame, as_local: bool) -> DataFrame:
        return df.as_local() if as_local else df

    def load_yielded(self, df: Yielded) -> DataFrame:
        if isinstance(df, YieldedDataFrame):
            return self.to_df(df.result)
        if isinstance(df, PhysicalYielded):
            if df.storage_type == "file":
                return self.load_df(df.name)
            return self.sql_engine.load_table(df.name)
        raise ValueError(f"can't load {df}")

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


def try_get_context_engine() -> Optional[ExecutionEngine]:
    """The engine of the current context, else the global one
    (``fugue_tpu/execution/factory.py:92``)."""
    eng = _CONTEXT_ENGINE.get()
    return eng if eng is not None else _GLOBAL_ENGINE[0]
