"""The ``DataFrame`` base: a schema-carrying frame with metadata and the
conversions and column operations every frame has (trimmed from
``fugue_tpu/dataframe/dataframe.py:23`` and ``fugue_tpu/dataset/dataset.py``).

A subclass implements ``count``, ``as_arrow``, ``peek_array``,
``as_local_bounded``, ``_drop_cols``, ``_select_cols``, ``rename``,
``alter_columns`` and ``head``; the rest is derived here: ``peek_dict``
(``:106``), ``as_local`` (``:110``), ``as_array``/``as_array_iterable``
and ``as_dict_iterable`` through the local frame, ``drop`` (``:133``),
``__getitem__`` (``:144``) and ``show`` (``:228``). A frame's workflow
identity (``__uuid__``) is its own, not its class and schema as in the
reference (``:155-159``), where two frames of one schema share a task id
(ROADMAP.md queue 3). ``YieldedDataFrame`` (``:206``) is the handle of a
frame a workflow yields."""

from abc import ABC, abstractmethod
from typing import Any, Dict, Iterable, List, Optional
from uuid import uuid4

import pandas as pd
import pyarrow as pa

from fugue_tpu_torch.collections.yielded import Yielded
from fugue_tpu_torch.schema import Schema, type_to_expr
from fugue_tpu_torch.utils.assertion import assert_or_throw


class DataFrameEmptyError(ValueError):
    """A peek at a frame with no rows (``fugue_tpu/dataset/dataset.py:16``)."""


class DataFrame(ABC):
    def __init__(self, schema: Any):
        self._schema = schema if isinstance(schema, Schema) else Schema(schema)
        self._schema.assert_not_empty()
        self._metadata: Optional[Dict[str, Any]] = None

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    # ---- metadata (``fugue_tpu/dataset/dataset.py:27-37``) ----------------
    @property
    def metadata(self) -> Dict[str, Any]:
        if self._metadata is None:
            self._metadata = {}
        return self._metadata

    @property
    def has_metadata(self) -> bool:
        return self._metadata is not None and len(self._metadata) > 0

    def reset_metadata(self, metadata: Any) -> None:
        self._metadata = dict(metadata) if metadata is not None else None

    # ---- the interface --------------------------------------------------
    @property
    @abstractmethod
    def is_local(self) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def is_bounded(self) -> bool:
        return True

    @property
    def empty(self) -> bool:
        return self.count() == 0

    def assert_not_empty(self) -> None:
        assert_or_throw(not self.empty, DataFrameEmptyError("dataframe is empty"))

    @abstractmethod
    def count(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    @abstractmethod
    def as_arrow(self, type_safe: bool = False) -> pa.Table:  # pragma: no cover
        raise NotImplementedError

    @abstractmethod
    def peek_array(self) -> List[Any]:  # pragma: no cover - interface
        """The first row as a list; raises on an empty frame."""
        raise NotImplementedError

    @abstractmethod
    def as_local_bounded(self) -> "LocalBoundedDataFrame":  # pragma: no cover
        raise NotImplementedError

    @abstractmethod
    def _drop_cols(self, cols: List[str]) -> "DataFrame":  # pragma: no cover
        raise NotImplementedError

    @abstractmethod
    def _select_cols(self, cols: List[str]) -> "DataFrame":  # pragma: no cover
        raise NotImplementedError

    @abstractmethod
    def rename(self, columns: Dict[str, str]) -> "DataFrame":  # pragma: no cover
        raise NotImplementedError

    @abstractmethod
    def alter_columns(self, columns: Any) -> "DataFrame":  # pragma: no cover
        """The frame with some columns cast to new types, in place."""
        raise NotImplementedError

    @abstractmethod
    def head(self, n: int, columns: Optional[List[str]] = None
             ) -> "LocalBoundedDataFrame":  # pragma: no cover - interface
        raise NotImplementedError

    # ---- derived --------------------------------------------------------
    def as_pandas(self) -> pd.DataFrame:
        return self.as_arrow().to_pandas(ignore_metadata=True, date_as_object=False)

    def peek_dict(self) -> Dict[str, Any]:
        return dict(zip(self.schema.names, self.peek_array()))

    def as_local(self) -> "LocalDataFrame":
        return self.as_local_bounded()

    def as_array(self, columns: Optional[List[str]] = None, type_safe: bool = False
                 ) -> List[Any]:
        return self.as_local_bounded().as_array(columns, type_safe)

    def as_array_iterable(self, columns: Optional[List[str]] = None, type_safe: bool = False
                          ) -> Iterable[Any]:
        return self.as_local_bounded().as_array_iterable(columns, type_safe)

    def as_dict_iterable(self, columns: Optional[List[str]] = None
                         ) -> Iterable[Dict[str, Any]]:
        names = self.schema.names if columns is None else columns
        for row in self.as_array_iterable(columns, type_safe=True):
            yield dict(zip(names, row))

    def drop(self, columns: List[str]) -> "DataFrame":
        schema = self.schema.exclude(columns)  # every name must be there
        assert_or_throw(len(schema) > 0, ValueError("can't drop all columns"))
        assert_or_throw(len(set(columns)) == len(columns),
                        ValueError(f"invalid columns to drop {columns}"))
        return self._drop_cols(list(columns))

    def __getitem__(self, columns: List[str]) -> "DataFrame":
        assert_or_throw(isinstance(columns, list) and len(columns) > 0,
                        ValueError("columns must be a non-empty list"))
        assert_or_throw(all(c in self.schema for c in columns),
                        KeyError(f"{columns} not all in {self.schema}"))
        return self._select_cols(columns)

    def show(self, n: int = 10, with_count: bool = False, title: Optional[str] = None
             ) -> None:
        """Prints the first ``n`` rows as a table (``:228``, one extra row
        read to tell whether there are more)."""
        rows = self.head(n + 1).as_array(type_safe=True)
        print(build_show_text(rows[:n], self.schema, title or f"{type(self).__name__}",
                              self.count() if with_count else None, len(rows) > n))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.schema})"

    def __uuid__(self) -> str:
        """This frame object's identity in a workflow's task ids: drawn
        once, so that the same frame gives the same ids and two frames
        never share one."""
        if getattr(self, "_uuid", None) is None:
            self._uuid = str(uuid4())
        return self._uuid


class LocalDataFrame(DataFrame):
    """A frame held wholly in host memory."""

    @property
    def is_local(self) -> bool:
        return True


class LocalBoundedDataFrame(LocalDataFrame):
    def as_local_bounded(self) -> "LocalBoundedDataFrame":
        return self


def build_show_text(rows: List[List[Any]], schema: Schema, title: Optional[str],
                    count: Optional[int], truncated: bool) -> str:
    """The text ``show`` prints (``fugue_tpu/utils/display.py:13``)."""
    headers = [f"{f.name}:{type_to_expr(f.type)}" for f in schema.fields]
    cells = [["NULL" if v is None else str(v) for v in row] for row in rows]
    widths = [max([len(h)] + [len(r[i]) for r in cells]) for i, h in enumerate(headers)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = ([title] if title else []) + [
        sep, "|" + "|".join(f" {h.ljust(w)} " for h, w in zip(headers, widths)) + "|", sep]
    lines += ["|" + "|".join(f" {c.ljust(w)} " for c, w in zip(r, widths)) + "|" for r in cells]
    lines.append(sep)
    if truncated:
        lines.append("(showing first rows only)")
    if count is not None:
        lines.append(f"Total count: {count}")
    return "\n".join(lines)


class YieldedDataFrame(Yielded):
    """The handle of a frame a workflow run yields (``:206``)."""

    def __init__(self, yid: str):
        super().__init__(yid)
        self._df: Any = None

    @property
    def is_set(self) -> bool:
        return self._df is not None

    def set_value(self, df: DataFrame) -> None:
        self._df = df

    @property
    def result(self) -> DataFrame:
        assert_or_throw(self.is_set, ValueError("value is not set"))
        return self._df
