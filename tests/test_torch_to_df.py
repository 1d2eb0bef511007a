"""``to_df`` types a pandas frame as the reference does (an empty or
all-null object column is ``str``, ``arrow_utils.normalize_dataframe_schema``)
and takes ``schema`` as the reference's ``to_df(df, schema)`` does, held
against ``JaxExecutionEngine`` pinned to one device; ``transform`` and
``aggregate`` of an empty frame with a string column run."""

from typing import Dict

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu_torch import col
from fugue_tpu_torch.column import functions as ff
from test_torch_join import _jax_engine

FRAMES = {
    "all-null object": lambda: pd.DataFrame({"a": [1, 2], "s": [None, None]}),
    "empty object": lambda: pd.DataFrame({"a": pd.Series([], dtype="int64"),
                                          "s": pd.Series([], dtype=object)}),
    "NaN-only object": lambda: pd.DataFrame({"a": [1.5, 2.5],
                                             "s": pd.Series([np.nan, None], dtype=object)}),
    "str column": lambda: pd.DataFrame({"a": [1, 2], "s": ["x", None]}),
    "empty str column": lambda: pd.DataFrame({"a": pd.Series([], dtype="int64"),
                                              "s": pd.Series([], dtype=str)}),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_to_df_infers_types_as_the_reference(name: str) -> None:
    pdf = FRAMES[name]()
    got = ft.make_execution_engine(device="cpu").to_df(pdf)
    want = _jax_engine().to_df(pdf)
    assert str(got.schema) == str(want.schema)
    assert got.as_arrow().to_pylist() == want.as_arrow().to_pylist()


@pytest.mark.parametrize("schema", ["s:str,a:long", "a:double,s:str", "a:int,s:str"])
def test_to_df_with_a_schema_names_and_types_as_the_reference(schema: str) -> None:
    pdf = pd.DataFrame({"a": [1, 2, 3], "s": ["x", None, "z"]})
    te = ft.make_execution_engine(device="cpu")
    got, want = te.to_df(pdf, schema), _jax_engine().to_df(pdf, schema)
    assert str(got.schema) == str(want.schema) == str(ft.Schema(schema))
    assert got.as_arrow().to_pylist() == want.as_arrow().to_pylist()
    assert str(te.persist(pdf, schema).schema) == str(want.schema)
    table = pa.Table.from_pandas(pdf, preserve_index=False)
    assert te.to_df(table, schema).as_arrow().to_pylist() == want.as_arrow().to_pylist()


def test_to_df_refusals() -> None:
    te = ft.make_execution_engine(device="cpu")
    pdf = pd.DataFrame({"a": [1, 2]})
    with pytest.raises(ValueError, match="schema must be None"):
        te.to_df(te.to_df(pdf), "a:long")
    with pytest.raises(ValueError, match="doesn't match"):
        te.to_df(pdf, "b:long")


def test_transform_and_aggregate_of_an_empty_frame_with_a_string_column() -> None:
    te = ft.make_execution_engine(device="cpu")
    pdf = pd.DataFrame({"k": pd.Series([], dtype="int64"), "s": pd.Series([], dtype=object)})

    def double(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": cols["k"], "k2": cols["k"] * 2}

    out = ft.transform(pdf, double, schema="k:long,k2:long", engine=te)
    assert len(out) == 0 and list(out.columns) == ["k", "k2"]
    agg = ft.aggregate(pdf, ["k"], engine=te, n=ff.count(col("s")))
    assert len(agg) == 0 and list(agg.columns) == ["k", "n"]
