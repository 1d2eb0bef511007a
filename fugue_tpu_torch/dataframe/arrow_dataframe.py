"""``ArrowDataFrame``: a local frame over an arrow table (trimmed from
``fugue_tpu/dataframe/arrow_dataframe.py:22``); what ``as_local`` and
``head`` of a ``TorchDataFrame`` return."""

from typing import Any, Dict, Iterable, List, Optional

import pyarrow as pa

from fugue_tpu_torch.dataframe.arrow_utils import cast_table, rows_to_table, table_to_rows
from fugue_tpu_torch.dataframe.dataframe import DataFrame, LocalBoundedDataFrame
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw


class ArrowDataFrame(LocalBoundedDataFrame):
    """An arrow table with ``schema`` (the table's own by default; a given
    schema's names must be the table's, and its types are cast to), or
    rows with a schema."""

    def __init__(self, df: Any = None, schema: Any = None):
        if df is None:
            super().__init__(schema)
            self._native = self.schema.create_empty_arrow()
        elif isinstance(df, pa.Table):
            super().__init__(Schema(df.schema) if schema is None else schema)
            assert_or_throw(set(self.schema.names) == set(df.schema.names),
                            ValueError(f"schema {self.schema} doesn't match table columns"))
            df = df.select(self.schema.names)
            self._native = df if df.schema == self.schema.pa_schema else \
                cast_table(df, self.schema)
        elif isinstance(df, Iterable):
            super().__init__(schema)
            self._native = rows_to_table(df, self.schema)
        else:
            raise ValueError(f"can't initialize ArrowDataFrame with {type(df)}")

    @property
    def native(self) -> pa.Table:
        return self._native

    def count(self) -> int:
        return self._native.num_rows

    def as_arrow(self, type_safe: bool = False) -> pa.Table:
        return self._native

    def peek_array(self) -> List[Any]:
        self.assert_not_empty()
        return next(iter(table_to_rows(self._native.slice(0, 1))))

    def _drop_cols(self, cols: List[str]) -> DataFrame:
        schema = self.schema.exclude(cols)
        return ArrowDataFrame(self._native.select(schema.names), schema)

    def _select_cols(self, cols: List[str]) -> DataFrame:
        schema = self.schema.extract(cols)
        return ArrowDataFrame(self._native.select(schema.names), schema)

    def rename(self, columns: Dict[str, str]) -> DataFrame:
        schema = self.schema.rename(columns)
        return ArrowDataFrame(self._native.rename_columns(schema.names), schema)

    def alter_columns(self, columns: Any) -> DataFrame:
        schema = self.schema.alter(columns)
        if schema == self.schema:
            return self
        return ArrowDataFrame(cast_table(self._native, schema), schema)

    def as_array(self, columns: Optional[List[str]] = None, type_safe: bool = False
                 ) -> List[Any]:
        return list(table_to_rows(self._native, columns))

    def as_array_iterable(self, columns: Optional[List[str]] = None, type_safe: bool = False
                          ) -> Iterable[Any]:
        yield from table_to_rows(self._native, columns)

    def head(self, n: int, columns: Optional[List[str]] = None) -> LocalBoundedDataFrame:
        assert_or_throw(n >= 0, ValueError("n must be >= 0"))
        table = self._native if columns is None else self._native.select(columns)
        schema = self.schema if columns is None else self.schema.extract(columns)
        return ArrowDataFrame(table.slice(0, n), schema)
