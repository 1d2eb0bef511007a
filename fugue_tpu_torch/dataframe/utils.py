"""Frame helpers: the join schemas (a copy of
``fugue_tpu/dataframe/utils.py:175-215``, ``get_join_schemas``)."""

from typing import Iterable, Optional, Tuple

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
