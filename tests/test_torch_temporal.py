"""Timestamp and date columns on the port (int64 microseconds and int32
days on the card) against ``JaxExecutionEngine`` pinned to one CPU
device: the arrow round trip with nulls, group keys (a date bins by its
stats, a timestamp takes the sort path), MIN/MAX/FIRST/LAST keeping the
column's type, filters and a join on a date key. Compared as arrow tables
row for row, float sums within rtol 1e-12."""

from typing import Any

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu
import fugue_tpu.column.expressions as jx
import fugue_tpu_torch as ft
import fugue_tpu_torch.column.expressions as tx
from fugue_tpu.column import functions as jff
from fugue_tpu.jax_backend.dataframe import JaxDataFrame
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.column import functions as ff
from test_torch_join import _jax_df, _jax_engine
from test_torch_strings import compare_tables

DAY_US = 86_400_000_000


def temporal_table(seed: int = 11, n: int = 120) -> pa.Table:
    """``d`` date32 over 30 days, ``ts`` a microsecond timestamp with 10 %
    nulls, ``tms`` a millisecond one with a time zone, ``v`` float64."""
    rng = np.random.default_rng(seed)
    days = rng.integers(18_000, 18_030, n).astype(np.int32)
    ts = days.astype(np.int64) * DAY_US + rng.integers(0, DAY_US, n)
    return pa.table({
        "d": pa.array(days, pa.int32()).cast(pa.date32()),
        "ts": pa.array(ts, pa.int64(), mask=rng.random(n) < 0.1).cast(pa.timestamp("us")),
        "tms": pa.array(ts // 1000, pa.int64()).cast(pa.timestamp("ms", tz="UTC")),
        "v": pa.array(np.round(rng.standard_normal(n), 4)),
    })


@pytest.mark.parametrize("tp", [pa.timestamp("us"), pa.timestamp("ms", tz="UTC"),
                                pa.timestamp("s"), pa.date32()],
                         ids=["us", "ms_utc", "s", "date"])
def test_round_trip_with_nulls(tp):
    if tp == pa.date32():
        arr = pa.array([0, None, -1_000, 19_000, None, 5], pa.int32()).cast(tp)
    else:
        arr = pa.array([0, None, -1_000_000, 1_700_000_000, None, 5], pa.int64()).cast(tp)
    table = pa.table({"a": arr})
    te = ft.make_execution_engine(device="cpu")
    tdf = te.to_df(table)
    col = tdf.blocks.columns["a"]
    assert col.data.dtype == (torch.int32 if tp == pa.date32() else torch.int64)
    assert col.stats is not None and col.mask is not None
    assert tdf.as_arrow().equals(table)
    je = _jax_engine()
    ref = JaxDataFrame.from_table(table, je._mesh, JSchema(table.schema))
    assert ref.as_arrow().equals(tdf.as_arrow())


def _engines() -> Any:
    return ft.make_execution_engine(device="cpu"), _jax_engine()


@pytest.mark.parametrize("key", ["d", "ts"])
def test_temporal_group_keys_match_jax(key):
    te, je = _engines()
    table = temporal_table()
    df = table.to_pandas()
    aggs_t = [ff.sum(tx.col("v")).alias("s"), ff.avg(tx.col("v")).alias("m"),
              ff.count(tx.col("v")).alias("c"), ff.min(tx.col("tms")).alias("lo"),
              ff.max(tx.col("tms")).alias("hi"), ff.first(tx.col("tms")).alias("f")]
    aggs_j = [jff.sum(jx.col("v")).alias("s"), jff.avg(jx.col("v")).alias("m"),
              jff.count(jx.col("v")).alias("c"), jff.min(jx.col("tms")).alias("lo"),
              jff.max(jx.col("tms")).alias("hi"), jff.first(jx.col("tms")).alias("f")]
    if key == "d":
        aggs_t += [ff.min(tx.col("ts")).alias("tlo"), ff.max(tx.col("ts")).alias("thi")]
        aggs_j += [jff.min(jx.col("ts")).alias("tlo"), jff.max(jx.col("ts")).alias("thi")]
    tres = te.aggregate(te.to_df(table), PartitionSpec(by=[key]), aggs_t)
    jres = je.aggregate(_jax_df(je, df), fugue_tpu.PartitionSpec(by=[key]), aggs_j)
    compare_tables(tres.as_arrow(), jres.as_arrow(), {"s": 1e-12, "m": 1e-12})
    assert tres.schema["lo"].type == pa.timestamp("ms", tz="UTC")
    assert te.fallbacks == {}


def test_date_group_by_matches_pandas():
    table = temporal_table(n=300)
    df = table.to_pandas(date_as_object=False)
    te = ft.make_execution_engine(device="cpu")
    got = ft.aggregate(table, "d", engine=te, s=ff.sum(tx.col("v")), c=ff.count(tx.col("*")),
                       lo=ff.min(tx.col("ts")), hi=ff.max(tx.col("ts")))
    want = df.groupby("d").agg(s=("v", "sum"), c=("v", "size"), lo=("ts", "min"),
                               hi=("ts", "max")).reset_index()
    got = got.sort_values("d").reset_index(drop=True)
    assert got["d"].tolist() == want["d"].tolist() and got["c"].tolist() == want["c"].tolist()
    assert got["lo"].tolist() == want["lo"].tolist() and got["hi"].tolist() == want["hi"].tolist()
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-12)


def test_temporal_filters_match_jax():
    te, je = _engines()
    table = temporal_table()
    df = table.to_pandas()
    mid = 18_015 * DAY_US
    for tc, jc in (
        (tx.col("ts") > mid, jx.col("ts") > mid),
        (tx.col("ts").is_null() | (tx.col("d") < tx.col("d")), jx.col("ts").is_null()),
        ((tx.col("ts") >= tx.col("ts")) & (tx.col("v") > 0.0),
         (jx.col("ts") >= jx.col("ts")) & (jx.col("v") > 0.0)),
    ):
        compare_tables(te.filter(te.to_df(table), tc).as_arrow(),
                       je.filter(_jax_df(je, df), jc).as_arrow())


@pytest.mark.parametrize("how", ["inner", "left_outer", "full_outer", "semi"])
def test_join_on_a_date_key_matches_jax(how):
    te, je = _engines()
    table = temporal_table()
    left = table.select(["d", "v"]).to_pandas()
    days = pa.array(np.arange(18_010, 18_040, 3, dtype=np.int32)).cast(pa.date32())
    right = pa.table({"d": days, "w": pa.array(np.arange(len(days), dtype=np.int64))}).to_pandas()
    tres = te.join(te.to_df(left), te.to_df(right), how=how, on=["d"])
    jres = je.join(_jax_df(je, left), _jax_df(je, right), how=how, on=["d"])
    compare_tables(tres.as_arrow(), jres.as_arrow())
