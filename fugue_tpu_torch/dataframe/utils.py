"""Frame helpers: the join schemas (a copy of
``fugue_tpu/dataframe/utils.py:175-215``, ``get_join_schemas``), and a
local frame's arrow table as ``to_df`` types it (``pandas_to_table``,
``arrow_to_table``: the rules of ``fugue_tpu/dataframe/arrow_utils.py:108-141``
and of ``PandasDataFrame`` / ``ArrowDataFrame`` with a schema)."""

from typing import Any, Iterable, Optional, Tuple

import pandas as pd
import pyarrow as pa

from fugue_tpu_torch.dataframe.dataframe import DataFrame
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw

# every join type, normalised: lower case, no "_" and no spaces
JOIN_TYPES = (
    "semi", "leftsemi", "anti", "leftanti", "inner", "leftouter", "rightouter",
    "fullouter", "cross",
)


def normalize_join_type(how: str) -> str:
    """``how`` lower-cased with ``_`` and spaces removed: ``"LEFT_OUTER"``
    is ``"leftouter"``."""
    return how.lower().replace("_", "").replace(" ", "")


def get_join_schemas(
    df1: DataFrame, df2: DataFrame, how: str, on: Optional[Iterable[str]]
) -> Tuple[Schema, Schema]:
    """``(key schema, output schema)`` of a join. With no ``on``, the keys
    are the columns the two frames share; a cross join has none and its
    frames share no column. Semi and anti joins output the left schema;
    the others the left schema, then the right's columns that are not
    keys."""
    how = normalize_join_type(how)
    assert_or_throw(how in JOIN_TYPES, ValueError(f"invalid join type {how}"))
    on = list(on) if on is not None else []
    assert_or_throw(len(on) == len(set(on)), ValueError(f"duplicated on keys {on}"))
    schema1, schema2 = df1.schema, df2.schema
    if how == "cross":
        assert_or_throw(len(on) == 0, ValueError("cross join can't have keys"))
        assert_or_throw(
            len(schema1.intersect(schema2.names).names) == 0,
            ValueError("cross join dataframes can't share columns"),
        )
        return Schema(), schema1 + schema2
    if len(on) == 0:
        on = [n for n in schema1.names if n in schema2]
    assert_or_throw(len(on) > 0, SyntaxError("no join keys found"))
    missing = [k for k in on if k not in schema1 or k not in schema2]
    assert_or_throw(
        len(missing) == 0, KeyError(f"join keys {missing} not in both dataframes")
    )
    schema_on = schema1.extract(on)
    assert_or_throw(
        schema_on == schema2.extract(on), ValueError(f"join key types mismatch on {on}")
    )
    if how in ("semi", "leftsemi", "anti", "leftanti"):
        return schema_on, schema1
    other = Schema([f for f in schema2.fields if f.name not in schema_on.names])
    return schema_on, schema1 + other


def normalize_dataframe_schema(df: pd.DataFrame) -> Schema:
    """The schema of a pandas frame (``arrow_utils.py:131``): each column's
    arrow type, but an object column that is empty or all null is ``str``
    (arrow alone would type it ``null``)."""
    fields = []
    for name in df.columns:
        assert_or_throw(isinstance(name, str), ValueError(f"column name {name!r} must be str"))
        s = df[name]
        if s.dtype == object and (len(s) == 0 or s.isna().all()):
            fields.append(pa.field(name, pa.string()))
        else:
            fields.append(pa.field(name, pa.Array.from_pandas(s).type))
    return Schema(fields)


def pandas_to_table(df: pd.DataFrame, schema: Any = None) -> pa.Table:
    """A pandas frame as arrow: typed by ``normalize_dataframe_schema``, or
    by ``schema``, whose names must be the frame's columns (in any order;
    the schema's order is taken), as ``PandasDataFrame(df, schema)``
    coerces it (``pandas_dataframe.py:29-36``, ``arrow_utils.py:108-122``:
    ``safe=False``)."""
    if schema is None:
        return pa.Table.from_pandas(df, schema=normalize_dataframe_schema(df).pa_schema,
                                    preserve_index=False)
    schema = Schema(schema)
    assert_or_throw(set(schema.names) == set(df.columns),
                    ValueError(f"schema {schema} doesn't match columns {list(df.columns)}"))
    return pa.Table.from_pandas(df[schema.names], schema=schema.pa_schema, preserve_index=False,
                                safe=False)


def arrow_to_table(table: pa.Table, schema: Any = None) -> pa.Table:
    """An arrow table as is, or with ``schema``'s columns (the same names,
    in its order) cast to its types (``ArrowDataFrame(df, schema)``,
    ``arrow_dataframe.py:34-44``)."""
    if schema is None:
        return table
    schema = Schema(schema)
    assert_or_throw(set(schema.names) == set(table.schema.names),
                    ValueError(f"schema {schema} doesn't match table columns"))
    table = table.select(schema.names)
    return table if table.schema == schema.pa_schema else table.cast(schema.pa_schema)
