"""The frame's column operations and conversions in the port's api
(``rename``, ``drop_columns``, ``select_columns``, ``alter_columns``,
``head``, ``peek_array``, ``peek_dict``, ``as_array``,
``as_array_iterable``, ``as_dict_iterable``) against the reference's
(``fugue_tpu/dataframe/api.py:70-128``): on pandas and arrow inputs, which
both answer on the host, and on the port's ``TorchDataFrame`` against the
JAX engine's frame on its one-device mesh. Values are compared exactly."""

from typing import Any, Callable, Dict

import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu.dataframe.api as ref
import fugue_tpu_torch as ft
from test_torch_types import jax_df, types_table
from test_torch_join import _jax_engine

_CALLS: Dict[str, Callable[[Any, Any], Any]] = {
    "rename": lambda api, df: api.rename(df, {"k": "kk", "v": "k"}),
    "drop_columns": lambda api, df: api.drop_columns(df, ["w", "h"]),
    "select_columns": lambda api, df: api.select_columns(df, ["u", "k"]),
    "alter_columns": lambda api, df: api.alter_columns(df, "k:long,a:double"),
    "head": lambda api, df: api.head(df, 3, ["k", "u"]),
    "peek_array": lambda api, df: api.peek_array(df),
    "peek_dict": lambda api, df: api.peek_dict(df),
    "as_array": lambda api, df: api.as_array(df, ["u", "a"], type_safe=True),
    "as_array_iterable": lambda api, df: list(api.as_array_iterable(df, type_safe=True)),
    "as_dict_iterable": lambda api, df: list(api.as_dict_iterable(df, ["k", "w"])),
}


def _plain(x: Any) -> Any:
    """A result as comparable Python values: frames as their row lists and
    column names."""
    if isinstance(x, pd.DataFrame):
        return list(x.columns), pa.Table.from_pandas(x, preserve_index=False).to_pylist()
    if isinstance(x, pa.Table):
        return x.column_names, x.to_pylist()
    if hasattr(x, "as_arrow"):
        t = x.as_arrow()
        return str(x.schema), t.to_pylist()
    return x


@pytest.mark.parametrize("kind", ["pandas", "arrow", "frame"])
@pytest.mark.parametrize("call", sorted(_CALLS))
def test_api_matches_the_reference(call: str, kind: str) -> None:
    table = types_table(21, n=12).drop_null()
    if kind == "pandas":
        got_in: Any = table.to_pandas()
        want_in: Any = table.to_pandas()
    elif kind == "arrow":
        got_in, want_in = table, table
    else:
        te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
        got_in, want_in = te.to_df(table), jax_df(je, table)
    got, want = _CALLS[call](ft, got_in), _CALLS[call](ref, want_in)
    assert _plain(got) == _plain(want)


def test_rename_with_nothing_returns_the_frame() -> None:
    table = types_table(22, n=5)
    assert ft.rename(table, {}) is table
