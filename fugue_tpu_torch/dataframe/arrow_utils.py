"""Rows <-> arrow at the host boundary, and the cast rules of
``alter_columns`` (a copy of ``fugue_tpu/dataframe/arrow_utils.py:20-183``:
``table_to_rows``, ``rows_to_table``, ``cols_to_table``, ``cast_table``).

``as_array`` gives Python values (datetime, date, Decimal, bytes, a dict
for a map or a struct, a list for a list); ``None`` is the one null, and a
NaN or NaT becomes None on the way in (``from_pandas=True``)."""

from typing import Any, Iterable, Iterator, List, Optional

import pandas as pd
import pyarrow as pa

from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw


def _normalize_cell(value: Any, tp: pa.DataType) -> Any:
    if value is None:
        return None
    if pa.types.is_map(tp):
        return dict(value) if isinstance(value, list) else value
    if pa.types.is_list(tp) or pa.types.is_large_list(tp):
        return [_normalize_cell(v, tp.value_type) for v in value]
    if pa.types.is_struct(tp):
        return {f.name: _normalize_cell(value.get(f.name), f.type) for f in tp}
    if pa.types.is_timestamp(tp) and isinstance(value, pd.Timestamp):
        return value.to_pydatetime()
    return value


def _needs_normalize(tp: pa.DataType) -> bool:
    return (pa.types.is_map(tp) or pa.types.is_list(tp) or pa.types.is_large_list(tp)
            or pa.types.is_struct(tp) or pa.types.is_timestamp(tp))


def table_to_rows(table: pa.Table, columns: Optional[List[str]] = None
                  ) -> Iterator[List[Any]]:
    """The table's rows as lists of Python values (``:47``)."""
    if columns is not None:
        table = table.select(columns)
    cols = [c.to_pylist() for c in table.columns]
    norm = [(_needs_normalize(f.type), f.type) for f in table.schema]
    for row in zip(*cols) if cols else iter([]):
        yield [_normalize_cell(v, tp) if fn else v for v, (fn, tp) in zip(row, norm)]


def rows_to_table(rows: Iterable[Any], schema: Schema) -> pa.Table:
    """An arrow table of ``schema`` from rows (lists, tuples or dicts)
    (``:73``)."""
    names = schema.names
    cols: List[List[Any]] = [[] for _ in names]
    for row in rows:
        if isinstance(row, dict):
            for i, n in enumerate(names):
                cols[i].append(row.get(n))
        else:
            assert_or_throw(len(row) == len(names),
                            ValueError(f"row width {len(row)} != schema width {len(names)}"))
            for i, v in enumerate(row):
                cols[i].append(v)
    arrays = []
    for values, field in zip(cols, schema.fields):
        if pa.types.is_map(field.type):
            values = [list(v.items()) if isinstance(v, dict) else v for v in values]
        try:
            arrays.append(pa.array(values, type=field.type, from_pandas=True))
        except (pa.ArrowTypeError, pa.ArrowInvalid):
            # ISO strings into a date or timestamp column: inferred, then cast
            arrays.append(pa.array(values, from_pandas=True).cast(field.type, safe=False))
    return pa.Table.from_arrays(arrays, schema=schema.pa_schema)


def str_to_bool(v: Any) -> Any:
    """``cast_table``'s string to bool: ``true``/``1`` and ``false``/``0``
    in any case, blanks trimmed; anything else raises (``:164-172``)."""
    if v is None:
        return None
    lv = v.strip().lower()
    if lv in ("true", "1"):
        return True
    if lv in ("false", "0"):
        return False
    raise ValueError(f"can't cast {v!r} to bool")


def cast_array(arr: pa.Array, tp: pa.DataType) -> pa.Array:
    """One column cast by ``cast_table``'s rules (``:150-182``): a timestamp
    or bool to a string as Python's ``str`` gives it (to the second,
    ``True``/``False``), a string to a bool by ``str_to_bool``, the rest by
    arrow's unsafe cast."""
    if arr.type == tp:
        return arr
    if pa.types.is_string(tp) and (pa.types.is_timestamp(arr.type)
                                   or pa.types.is_boolean(arr.type)):
        return pa.array([None if v is None else str(v) for v in arr.to_pylist()],
                        type=pa.string())
    if pa.types.is_boolean(tp) and pa.types.is_string(arr.type):
        return pa.array([str_to_bool(v) for v in arr.to_pylist()], type=pa.bool_())
    return arr.cast(tp, safe=False)


def cast_table(table: pa.Table, schema: Schema) -> pa.Table:
    """A table cast to a schema of the same width (``:144``)."""
    assert_or_throw(table.num_columns == len(schema), ValueError("column count mismatch in cast"))
    arrays = [cast_array(col.combine_chunks(), field.type)
              for col, field in zip(table.columns, schema.fields)]
    return pa.Table.from_arrays(arrays, schema=schema.pa_schema)
