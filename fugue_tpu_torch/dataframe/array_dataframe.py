"""``ArrayDataFrame``: a local frame over a list of rows (trimmed from
``fugue_tpu/dataframe/array_dataframe.py:11``). ``to_df(rows, schema)``
takes rows through it, as ``native_execution_engine.py:294-297`` does."""

from typing import Any, Dict, Iterable, List, Optional

import pyarrow as pa

from fugue_tpu_torch.dataframe.arrow_utils import cast_table, rows_to_table, table_to_rows
from fugue_tpu_torch.dataframe.dataframe import DataFrame, LocalBoundedDataFrame
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw


class ArrayDataFrame(LocalBoundedDataFrame):
    """Rows (each a list) with ``schema``; conversions are type-unsafe
    unless asked."""

    def __init__(self, df: Any = None, schema: Any = None):
        super().__init__(schema)
        self._native: List[Any] = [] if df is None else [list(r) for r in df]

    @property
    def native(self) -> List[Any]:
        return self._native

    def count(self) -> int:
        return len(self._native)

    def as_arrow(self, type_safe: bool = False) -> pa.Table:
        return rows_to_table(self._native, self.schema)

    def peek_array(self) -> List[Any]:
        self.assert_not_empty()
        return list(self._native[0])

    def _by_schema(self, schema: Schema) -> "ArrayDataFrame":
        idx = [self.schema.index_of_key(n) for n in schema.names]
        return ArrayDataFrame([[row[i] for i in idx] for row in self._native], schema)

    def _drop_cols(self, cols: List[str]) -> DataFrame:
        return self._by_schema(self.schema.exclude(cols))

    def _select_cols(self, cols: List[str]) -> DataFrame:
        return self._by_schema(self.schema.extract(cols))

    def rename(self, columns: Dict[str, str]) -> DataFrame:
        return ArrayDataFrame(self._native, self.schema.rename(columns))

    def alter_columns(self, columns: Any) -> DataFrame:
        schema = self.schema.alter(columns)
        if schema == self.schema:
            return self
        table = cast_table(rows_to_table(self._native, self.schema), schema)
        return ArrayDataFrame(table_to_rows(table), schema)

    def as_array(self, columns: Optional[List[str]] = None, type_safe: bool = False
                 ) -> List[Any]:
        return list(self.as_array_iterable(columns, type_safe))

    def as_array_iterable(self, columns: Optional[List[str]] = None, type_safe: bool = False
                          ) -> Iterable[Any]:
        if type_safe:
            yield from table_to_rows(self.as_arrow(), columns)
        elif columns is None:
            yield from self._native
        else:
            idx = [self.schema.index_of_key(n) for n in columns]
            for row in self._native:
                yield [row[i] for i in idx]

    def head(self, n: int, columns: Optional[List[str]] = None) -> LocalBoundedDataFrame:
        assert_or_throw(n >= 0, ValueError("n must be >= 0"))
        schema = self.schema if columns is None else self.schema.extract(columns)
        return ArrayDataFrame(list(self.as_array_iterable(columns))[:n], schema)
