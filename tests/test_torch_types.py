"""The rest of the frame's column types on the port: uint16-64 and float16
on the card, binary, nested, decimal and null columns beside them on the
host, held against the JAX engine pinned to one CPU device (frames on its
mesh, ``test_torch_join._jax_df``), or against numpy where the reference
is wrong (MIN of a uint64 raises there, ROADMAP.md queue 3).

Tolerances: every key, count, extremum, row and exported value exactly;
a float16 SUM within one float16 ulp of numpy's float64 sum rounded to
float16 (the port sums in float32 and rounds once; the reference declares
float16 too); AVG of a float16 within rtol 1e-3 of numpy's float64 mean
(the port's float32 sum over the count)."""

import decimal
from typing import Any, Dict, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu.collections.partition import PartitionSpec as JSpec
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.column.expressions import _FuncExpr as _JFuncExpr
from fugue_tpu.jax_backend.dataframe import JaxDataFrame
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.column.expressions import _FuncExpr
from fugue_tpu_torch.column.sql import SelectColumns
from test_torch_join import _jax_engine

N = 400
U63 = 2**63


def types_table(seed: int, n: int = N, host: bool = False) -> pa.Table:
    """``k`` int32 over 6 groups, ``a`` uint16 (65535 among them), ``w``
    uint32 around 2^31 up to 2^32 - 1, ``u`` uint64 over 40 values half
    above 2^63 (2^64 - 1 among them), ``h`` float16 in [0, 600) and 2 %
    60000 (a group's sum overflows float16 to inf), ``v``
    float64; a tenth of a, w and h null. ``host`` adds a binary, a
    list<int32> and a decimal(12,2) column with nulls."""
    rng = np.random.default_rng(seed)
    table = np.concatenate([rng.integers(0, 2**40, 20, dtype=np.uint64),
                            rng.integers(U63, 2**64 - 2, 19, dtype=np.uint64),
                            np.array([2**64 - 1], dtype=np.uint64)])

    def nulls() -> np.ndarray:
        return rng.random(n) < 0.1

    cols: Dict[str, Any] = {
        "k": pa.array(rng.integers(0, 6, n).astype(np.int32)),
        "a": pa.array(rng.choice(np.array([0, 1, 7, 300, 65534, 65535], np.uint16), n),
                      mask=nulls()),
        "w": pa.array(rng.integers(2**31 - 5, 2**31 + 5, n).astype(np.uint32)
                      | np.where(rng.random(n) < 0.1, np.uint32(2**32 - 1), np.uint32(0)),
                      mask=nulls()),
        # no nulls: the reference reads a nullable uint64 through float64
        # (``jax_backend/blocks.py:451``), so those are held against numpy
        "u": pa.array(table[rng.integers(0, len(table), n)]),
        "h": pa.array(np.where(rng.random(n) < 0.02, 60000, rng.random(n) * 600)
                      .astype(np.float16), mask=nulls()),
        "v": pa.array(rng.standard_normal(n)),
    }
    if host:
        cols["b"] = pa.array([None if i % 9 == 0 else bytes(rng.integers(0, 256, i % 5))
                              for i in range(n)], pa.binary())
        cols["l"] = pa.array([None if i % 7 == 0 else list(range(i % 4)) for i in range(n)],
                             pa.list_(pa.int32()))
        cols["d"] = pa.array([None if i % 11 == 0 else decimal.Decimal(i * 37 - 5000) / 100
                              for i in range(n)], pa.decimal128(12, 2))
    return pa.table(cols)


def port() -> Any:
    return ft.make_execution_engine(device="cpu")


def jax_df(je: Any, table: pa.Table) -> Any:
    return JaxDataFrame.from_table(table, je._mesh, JSchema(table.schema))


def by_key(table: pa.Table, *keys: str) -> pa.Table:
    """Rows ordered by ``keys`` (nulls last), in Python: group orders differ
    by route, and arrow cannot sort a float16."""
    cols = [table.column(k).to_pylist() for k in keys]
    order = sorted(range(table.num_rows),
                   key=lambda i: tuple((c[i] is None, 0 if c[i] is None else c[i]) for c in cols))
    return table.take(pa.array(order, pa.int64()))


# ---- round trips ------------------------------------------------------------

@pytest.mark.parametrize("name", ["a", "w", "u", "h", "b", "l", "d"])
def test_round_trip_of_every_type(name: str) -> None:
    """to_df -> as_arrow gives each column back exactly, as the JAX
    package's frame does; device columns for a, w, u, h, host for b, l, d."""
    table = types_table(1, host=True).select([name, "k"])
    te, je = port(), _jax_engine()
    got = te.to_df(table)
    assert got.blocks.columns[name].on_device == (name in "awuh")
    assert got.as_arrow().equals(table)
    assert got.as_arrow().equals(jax_df(je, table).as_arrow())


def test_null_column_round_trips() -> None:
    table = pa.table({"n": pa.array([None] * 5), "k": pa.array(np.arange(5))})
    got = port().to_df(table)
    assert not got.blocks.columns["n"].on_device and got.as_arrow().equals(table)


# ---- group-by -------------------------------------------------------------

_PAYLOADS = [(f, c) for c in ("a", "w", "h") for f in ("sum", "avg", "count", "min", "max")] + [
    ("sum", "u"), ("avg", "u"), ("count", "u"), ("max", "u")]


@pytest.mark.parametrize("func,name", _PAYLOADS, ids=[f"{f}-{c}" for f, c in _PAYLOADS])
def test_groupby_payloads_match_the_reference(func: str, name: str) -> None:
    table = types_table(2)
    te, je = port(), _jax_engine()
    got = ft.aggregate(te.to_df(table), "k", engine=te, as_fugue=True,
                       x=getattr(ff, func)(col(name))).as_arrow()
    want = je.aggregate(jax_df(je, table), JSpec(by=["k"]),
                        [getattr(jff, func)(jcol(name)).alias("x")]).as_arrow()
    got, want = by_key(got, "k"), by_key(want, "k")
    assert got.schema == want.schema
    if func == "sum" and name == "h":  # one float16 ulp of numpy's float64 sum, rounded
        pdf = table.to_pandas()
        exact = pdf.groupby("k")["h"].apply(lambda s: s.dropna().astype(np.float64).sum())
        exact16 = exact.to_numpy().astype(np.float16)
        g = got.column("x").to_numpy()
        assert np.all((g == exact16) | (np.abs(g.astype(np.float64) - exact16.astype(np.float64))
                                        <= np.spacing(np.abs(exact16)).astype(np.float64)))
        assert np.isinf(g).any() and not np.isinf(g).all()
    elif func == "avg" and name == "h":  # against numpy's float64 mean
        pdf = table.to_pandas()
        exact = pdf.groupby("k")["h"].apply(lambda s: s.dropna().astype(np.float64).mean())
        np.testing.assert_allclose(got.column("x").to_numpy(), exact.to_numpy(), rtol=1e-3)
    else:
        assert got.equals(want)


def test_min_of_uint64_against_numpy() -> None:
    """The reference raises ``OverflowError`` here (ROADMAP.md queue 3); the
    port's MIN (and MAX) equal numpy's."""
    table = types_table(3)
    te, je = port(), _jax_engine()
    got = by_key(ft.aggregate(te.to_df(table), "k", engine=te, as_fugue=True,
                              lo=ff.min(col("u")), hi=ff.max(col("u"))).as_arrow(), "k")
    pdf = table.to_pandas()
    u = table.column("u").to_numpy(zero_copy_only=False)
    for k, lo, hi in zip(*(got.column(c).to_pylist() for c in ("k", "lo", "hi"))):
        vals = u[(pdf["k"].to_numpy() == k) & table.column("u").is_valid().to_numpy(
            zero_copy_only=False)].astype(np.uint64)
        assert (lo, hi) == (int(vals.min()), int(vals.max()))
    assert str(got.schema) == "k: int32\nlo: uint64\nhi: uint64"
    with pytest.raises(OverflowError):
        je.aggregate(jax_df(je, table), JSpec(by=["k"]), [jff.min(jcol("u")).alias("lo")])


_VALUE_AGGS = ["median", "variance", "var_samp", "var_pop", "stddev", "stddev_samp",
               "stddev_pop"]


@pytest.mark.parametrize("func", _VALUE_AGGS)
def test_median_and_variance_of_uint64_against_numpy(func: str) -> None:
    """MEDIAN and the variance family of a uint64 read its values (half of
    them above 2^63) in float64, each rounded once, as numpy's conversion
    does; they are held against numpy rather than the reference, whose
    uint64 reads go through float64 unreliably. The median exactly; the
    variance family within rtol 1e-12 (numpy and the port add the squared
    deviations in different orders)."""
    table = types_table(17)
    te = port()
    got = by_key(ft.aggregate(te.to_df(table), "k", engine=te, as_fugue=True,
                              x=_FuncExpr(func, col("u"), is_aggregation=True)).as_arrow(), "k")
    assert got.schema.field("x").type == pa.float64()
    k = table.column("k").to_numpy()
    u = table.column("u").to_numpy().astype(np.float64)
    ddof = 0 if func.endswith("_pop") else 1
    for key, x in zip(*(got.column(c).to_pylist() for c in ("k", "x"))):
        vals = u[k == key]
        if func == "median":
            assert x == np.median(vals)
        else:
            want = np.var(vals, ddof=ddof)
            want = np.sqrt(want) if func.startswith("stddev") else want
            np.testing.assert_allclose(x, want, rtol=1e-12)


@pytest.mark.parametrize("frame", ["partition", "rows"])
def test_window_sums_and_extrema_of_uint64_against_numpy(frame: str) -> None:
    """A window's SUM of a uint64 wraps its values' int64 bits, as the
    group-by's does, and its MAX orders by value: over the whole
    partition and over a running ROWS frame, against numpy."""
    table = types_table(18).select(["k", "u"]).append_column(
        "o", pa.array(np.arange(N, dtype=np.int64)))
    over = "PARTITION BY k" + ("" if frame == "partition" else
                               " ORDER BY o ROWS BETWEEN 2 PRECEDING AND CURRENT ROW")
    te = port()
    got = ft.raw_sql(f"SELECT k, o, SUM(u) OVER ({over}) AS s, MAX(u) OVER ({over}) AS m FROM",
                     te.to_df(table), "ORDER BY o", engine=te, as_fugue=True).as_arrow()
    k, u = table.column("k").to_numpy(), table.column("u").to_numpy()
    want_s, want_m = [], []
    for i in range(N):
        rows = np.flatnonzero(k == k[i])
        if frame == "rows":
            rows = rows[(rows <= i)][-3:]
        want_s.append(int(np.add.reduce(u[rows].view(np.int64))))
        want_m.append(int(u[rows].max()))
    assert got.column("o").to_pylist() == list(range(N))
    assert got.column("s").to_pylist() == want_s
    assert got.column("m").to_pylist() == want_m
    assert got.schema.field("m").type == pa.uint64()


@pytest.mark.parametrize("key", ["a", "w", "u", "h"])
def test_groupby_keys_match_the_reference(key: str) -> None:
    """uint16 and uint32 keys bin (values above 2^31 included), a uint64
    key above 2^63 and a float16 key take the sort path."""
    table = types_table(4)
    te, je = port(), _jax_engine()
    got = ft.aggregate(te.to_df(table), key, engine=te, as_fugue=True,
                       n=ff.count(col("v")), s=ff.sum(col("k"))).as_arrow()
    want = je.aggregate(jax_df(je, table), JSpec(by=[key]),
                        [jff.count(jcol("v")).alias("n"), jff.sum(jcol("k")).alias("s")])
    assert by_key(got, key).equals(by_key(want.as_arrow(), key))


def test_distinct_counts_of_unsigned_and_half_values() -> None:
    table = types_table(5)
    te, je = port(), _jax_engine()
    aggs = [("cu", "u"), ("cw", "w"), ("ch", "h")]
    got = te.aggregate(te.to_df(table), _spec(["k"]),
                       [_FuncExpr("count", col(c), arg_distinct=True, is_aggregation=True).alias(n)
                        for n, c in aggs])
    want = je.aggregate(jax_df(je, table), JSpec(by=["k"]),
                        [_JFuncExpr("count", jcol(c), arg_distinct=True, is_aggregation=True)
                         .alias(n)
                         for n, c in aggs])
    assert by_key(got.as_arrow(), "k").equals(by_key(want.as_arrow(), "k"))


def _spec(by: List[str]) -> Any:
    from fugue_tpu_torch.collections.partition import PartitionSpec

    return PartitionSpec(by=by)


# ---- rows: compares, take, joins, set operations ----------------------------

_FILTERS = {
    "u_above_2_63": (lambda c: c("u") > U63, lambda c: c("u") > U63),
    "u_at_most_2_63": (lambda c: c("u") <= U63, lambda c: c("u") <= U63),
    "u_eq_max": (lambda c: c("u") == 2**64 - 1, lambda c: c("u") == 2**64 - 1),
    "w_above_2_31": (lambda c: c("w") >= 2**31, lambda c: c("w") >= 2**31),
    "a_vs_w": (lambda c: c("a") < c("w"), lambda c: c("a") < c("w")),
    "h_below": (lambda c: c("h") < 100.5, lambda c: c("h") < 100.5),
    "w_is_null": (lambda c: c("w").is_null(), lambda c: c("w").is_null()),
}


@pytest.mark.parametrize("case", sorted(_FILTERS))
def test_compares_on_unsigned_and_half_columns(case: str) -> None:
    table = types_table(6)
    te, je = port(), _jax_engine()
    mk_t, mk_j = _FILTERS[case]
    got = te.filter(te.to_df(table), mk_t(col)).as_arrow()
    want = je.filter(jax_df(je, table), mk_j(jcol)).as_arrow()
    assert got.num_rows > 0 and got.equals(want)


@pytest.mark.parametrize("presort", ["u desc", "u", "w desc", "a", "h desc"])
def test_take_by_unsigned_and_half_keys(presort: str) -> None:
    table = types_table(7).drop_null()
    te, je = port(), _jax_engine()
    got = te.take(te.to_df(table), 7, presort=presort).as_arrow()
    want = je.take(jax_df(je, table), 7, presort=presort).as_arrow()
    assert got.equals(want)


@pytest.mark.parametrize("how", ["inner", "left_outer", "semi", "anti"])
@pytest.mark.parametrize("key", ["u", "w", "a"])
def test_joins_on_unsigned_keys(key: str, how: str) -> None:
    left = types_table(8).select([key, "k", "v"])
    right = types_table(9, n=60).select([key, "h"])
    right = right.filter(right.column(key).is_valid()).group_by(key).aggregate(
        [("h", "count")]).rename_columns([key, "h"]) if how in ("inner", "left_outer") else right
    te, je = port(), _jax_engine()
    got = te.join(te.to_df(left), te.to_df(right), how=how, on=[key]).as_arrow()
    want = je.join(jax_df(je, left), jax_df(je, right), how=how, on=[key]).as_arrow()
    assert by_key(got, key, "k", "v").equals(by_key(want, key, "k", "v"))


@pytest.mark.parametrize("op", ["union", "intersect", "subtract", "distinct"])
def test_set_operations_on_unsigned_and_half_columns(op: str) -> None:
    t1 = types_table(10, n=120).select(["a", "u", "h"])
    t2 = types_table(10, n=80).select(["a", "u", "h"])
    te, je = port(), _jax_engine()
    if op == "distinct":
        got, want = te.distinct(te.to_df(t1)), je.distinct(jax_df(je, t1))
    else:
        got = getattr(te, op)(te.to_df(t1), te.to_df(t2))
        want = getattr(je, op)(jax_df(je, t1), jax_df(je, t2))
    assert by_key(got.as_arrow(), "a", "u", "h").equals(by_key(want.as_arrow(), "a", "u", "h"))


# ---- host columns -----------------------------------------------------------

def test_host_columns_ride_a_filter_select_head_and_export() -> None:
    """A mask-only filter keeps the host columns' matching rows, a
    pass-through select renames and reorders them, ``head`` of the masked
    frame takes only its rows, and the export takes them at the same
    positions as the device columns, as the JAX package's do."""
    table = types_table(11, host=True)
    te, je = port(), _jax_engine()
    tf, jf = te.to_df(table), jax_df(je, table)
    filt_t, filt_j = te.filter(tf, col("k") > 2), je.filter(jf, jcol("k") > 2)
    assert filt_t.as_arrow().equals(filt_j.as_arrow())
    assert filt_t.head(5).as_arrow().equals(filt_j.head(5).as_arrow())
    from fugue_tpu.column.sql import SelectColumns as JSelect

    got = te.select(filt_t, SelectColumns(col("d"), col("b").alias("bb"), col("u"), col("l")))
    want = je.select(filt_j, JSelect(jcol("d"), jcol("b").alias("bb"), jcol("u"), jcol("l")))
    assert got.as_arrow().equals(want.as_arrow())
    assert got.count() == want.count()


def test_host_columns_ride_sample_dropna_fillna_and_repartition() -> None:
    table = types_table(12, host=True)
    te = port()
    tf = te.to_df(table)
    kept = te.dropna(tf, subset=["a"]).as_arrow()
    assert kept.equals(table.filter(table.column("a").is_valid()))
    filled = te.fillna(tf, 9, subset=["a"]).as_arrow()
    assert filled.column("b").equals(table.column("b"))
    assert filled.column("a").null_count == 0
    sample = te.sample(tf, n=50, seed=3).as_arrow()
    rows = table.to_pylist()
    assert sample.num_rows == 50 and all(r in rows for r in sample.to_pylist())
    from fugue_tpu_torch.collections.partition import PartitionSpec

    same = te.repartition(tf, PartitionSpec(algo="hash", num=3, by=["b"]))
    assert same is tf  # a host key leaves the frame as it is, as the JAX package does
    moved = te.repartition(tf, PartitionSpec(algo="hash", num=3, by=["k"])).as_arrow()
    order = [("k", "ascending"), ("v", "ascending")]
    assert moved.sort_by(order).equals(table.sort_by(order))
    assert te.fallbacks == {}


_REFUSED = {
    "union": lambda te, f: te.union(f, f),
    "intersect": lambda te, f: te.intersect(f, f),
    "subtract": lambda te, f: te.subtract(f, f),
    "distinct": lambda te, f: te.distinct(f),
    "join": lambda te, f: te.join(f, f[["k", "v"]], how="inner", on=["k", "v"]),
    "take": lambda te, f: te.take(f, 3, presort="k"),
    "dropna": lambda te, f: te.dropna(f, subset=["l"]),
    "fillna": lambda te, f: te.fillna(f, {"d": 1}),
    "aggregate": lambda te, f: te.aggregate(f, _spec(["b"]), [ff.count(col("v")).alias("n")]),
    "filter": lambda te, f: te.filter(f, col("d") > 1),
    "select": lambda te, f: te.select(f, SelectColumns(col("d").cast("double").alias("x"))),
    "map": lambda te, f: ft.transform(f, _tensor_udf, "*", engine=te),
    "zip": lambda te, f: ft.zip(f, f[["k", "v"]], partition="k", engine=te),
    "sql_select": lambda te, f: ft.raw_sql("SELECT k, b FROM", f, "ORDER BY k", engine=te),
}


def _tensor_udf(df: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return df


@pytest.mark.parametrize("op", sorted(_REFUSED))
def test_host_column_refusals_name_item_2b(op: str) -> None:
    """What the JAX package sends to its host engine when a host column
    takes part raises naming ROADMAP.md queue 1 item 2(b), counted in
    ``fallbacks``; the port never answers on the host instead."""
    te = port()
    frame = te.to_df(types_table(13, n=50, host=True))
    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\(b\)"):
        _REFUSED[op](te, frame)
    assert sum(te.fallbacks.values()) == 1


# ---- expressions --------------------------------------------------------------

@pytest.mark.parametrize("expr", ["a + 1", "u * 2", "w - 1", "a + w"])
def test_unsigned_arithmetic_raises_as_the_reference(expr: str) -> None:
    table = types_table(14)
    te, je = port(), _jax_engine()
    from fugue_tpu.column.sql import SelectColumns as JSelect

    def build(c: Any) -> Any:
        x, y = expr.split(" ")[0], expr.split(" ")[2]
        other = c(y) if y.isalpha() else int(y)
        return {"+": c(x) + other, "*": c(x) * other, "-": c(x) - other}[expr.split(" ")[1]]

    with pytest.raises(ValueError, match="infer"):
        te.select(te.to_df(table), SelectColumns(build(col).alias("x")))
    with pytest.raises(ValueError):
        je.select(jax_df(je, table), JSelect(build(jcol).alias("x")))


@pytest.mark.parametrize("case", ["h_times_2", "h_plus_h", "a_plus_a", "u_plus_u",
                                  "w_times_w", "u_over_3", "u_as_double", "h_as_double"])
def test_same_type_arithmetic_and_casts_match_the_reference(case: str) -> None:
    """float16 arithmetic in float16 (60000 * 2 overflows to inf), unsigned
    arithmetic wrapping in its type, division and casts by value."""
    table = types_table(15)
    te, je = port(), _jax_engine()
    from fugue_tpu.column.sql import SelectColumns as JSelect

    exprs = {
        "h_times_2": lambda c: c("h") * 2, "h_plus_h": lambda c: c("h") + c("h"),
        "a_plus_a": lambda c: c("a") + c("a"), "u_plus_u": lambda c: c("u") + c("u"),
        "w_times_w": lambda c: c("w") * c("w"), "u_over_3": lambda c: c("u") / 3,
        "u_as_double": lambda c: c("u").cast("double"),
        "h_as_double": lambda c: c("h").cast("double"),
    }[case]
    got = te.select(te.to_df(table), SelectColumns(col("k"), exprs(col).alias("x")))
    want = je.select(jax_df(je, table), JSelect(jcol("k"), exprs(jcol).alias("x")))
    if case == "u_over_3":  # the reference's quotient is off by an ulp here: numpy's
        u = table.column("u").to_numpy()
        assert got.as_arrow().column("x").to_pylist() == [float(x) / 3 for x in u]
        assert str(got.schema) == str(want.schema)
        return
    assert got.as_arrow().equals(want.as_arrow())


# ---- alter_columns ----------------------------------------------------------

_ALTER_SOURCES = {
    "b": pa.array([True, False, None, True]),
    "i": pa.array([1, -2, None, 300], pa.int32()),
    "l": pa.array([2**40, -3, None, 0], pa.int64()),
    "f": pa.array([1.5, -2.0, None, 0.25], pa.float64()),
    "s": pa.array(["1", "2", None, "3"]),
    "dt": pa.array([pd.Timestamp("2020-01-01 03:04:05"), pd.Timestamp("1969-12-31 23:00:00"),
                    None, pd.Timestamp("2024-02-29")], pa.timestamp("us")),
    "d": pa.array([pd.Timestamp("2020-01-01").date(), pd.Timestamp("1969-12-31").date(), None,
                   pd.Timestamp("2024-02-29").date()], pa.date32()),
    "u": pa.array([1, U63 + 5, None, 2**64 - 1], pa.uint64()),
    "a": pa.array([1, 65535, None, 7], pa.uint16()),
    # float64 to float16 rounds once (float32 first would round 1 + 2^-11 +
    # 2^-30 to a tie, then down); -0.0 prints apart from 0.0
    "g": pa.array([1 + 2**-11 + 2**-30, -0.0, None, 70000.0, 1e-8, 0.0, 65519.0]),
    "h": pa.array([1.5, 60000, None, -0.0, 0.0, 6e-8], pa.float16()),
}
_ALTER_TARGETS = {
    "b": ["int", "long", "double", "str"],
    "i": ["bool", "long", "double", "float", "str", "uint32", "float16"],
    "l": ["int", "double", "str", "datetime", "uint64", "float16"],
    "f": ["int", "long", "bool", "str", "float", "float16"],
    "s": ["int", "double", "long", "float16"],
    "dt": ["str", "date", "long"],
    "d": ["str", "datetime", "int"],
    "u": ["long", "double", "str", "bool", "float16"],
    "a": ["int", "long", "double", "str", "uint32", "float16"],
    "g": ["float16", "str", "float"],
    "h": ["str", "double", "int", "uint16"],
}
_ALTER_CASES = [(s, t) for s, ts in _ALTER_TARGETS.items() for t in ts]


@pytest.mark.parametrize("src,dst", _ALTER_CASES, ids=[f"{s}-{t}" for s, t in _ALTER_CASES])
def test_alter_columns_matrix_matches_the_reference(src: str, dst: str) -> None:
    """Each cast on the card (K6 among numbers, dates and timestamps, a
    dictionary LUT from a string, a factorization to one) against the JAX
    frame's ``alter_columns`` (``cast_table`` at the host boundary)."""
    source = _ALTER_SOURCES[src]
    table = pa.table({"x": source, "k": pa.array(np.arange(len(source)))})
    te, je = port(), _jax_engine()
    got = te.to_df(table).alter_columns(f"x:{dst}")
    want = jax_df(je, table).alter_columns(f"x:{dst}")
    assert str(got.schema) == str(want.schema)
    assert got.as_arrow().equals(want.as_arrow())


_HOST_SOURCES = {
    "dec": pa.array([decimal.Decimal("1.25"), None, decimal.Decimal("-3.50"),
                     decimal.Decimal("7")], pa.decimal128(12, 2)),
    "bin": pa.array([b"ab", None, b"", b"xyz"], pa.binary()),
    "lst": pa.array([[1, 2], None, [], [3]], pa.list_(pa.int32())),
    "s": pa.array(["1.5", None, "x", "7"]),
    "f": pa.array([1.25, None, -3.5, 7.0]),
}
_HOST_CASTS = [("dec", "double"), ("dec", "str"), ("dec", "int"), ("dec", "decimal(10,2)"),
               ("bin", "str"), ("lst", "[long]"), ("s", "bytes"), ("f", "decimal(10,2)")]


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
@pytest.mark.parametrize("src,dst", _HOST_CASTS, ids=[f"{s}-{t}" for s, t in _HOST_CASTS])
def test_alter_columns_from_or_to_a_host_type_matches_the_reference(src: str, dst: str,
                                                                    masked: bool) -> None:
    """A cast from or to a host type is made on the host by
    ``cast_table``'s rules (a device column read back whole first, a
    device result uploaded), over a prefix frame and after a filter,
    against the JAX frame's ``alter_columns``."""
    table = pa.table({"x": _HOST_SOURCES[src], "k": pa.array(np.arange(4))})
    from fugue_tpu.column import col as jc

    te, je = port(), _jax_engine()
    got, want = te.to_df(table), jax_df(je, table)
    if masked:
        got, want = te.filter(got, col("k") != 1), je.filter(want, jc("k") != 1)
    got, want = got.alter_columns(f"x:{dst}"), want.alter_columns(f"x:{dst}")
    assert str(got.schema) == str(want.schema)
    assert got.as_arrow().equals(want.as_arrow())


_NO_CAST = [("b", "float16"), ("d", "double"), ("dt", "int"), ("h", "bool")]


@pytest.mark.parametrize("src,dst", _NO_CAST, ids=[f"{s}-{t}" for s, t in _NO_CAST])
def test_alter_columns_raises_where_arrow_has_no_cast(src: str, dst: str) -> None:
    """Where arrow has no cast, the port raises arrow's error, as the
    reference's ``cast_table`` does."""
    table = pa.table({"x": _ALTER_SOURCES[src]})
    je = _jax_engine()
    with pytest.raises(pa.ArrowNotImplementedError):
        jax_df(je, table).alter_columns(f"x:{dst}").as_arrow()
    with pytest.raises(pa.ArrowNotImplementedError):
        port().to_df(table).alter_columns(f"x:{dst}")


def test_alter_columns_of_a_dictionary_entry_that_casts_to_null() -> None:
    """A string column whose dictionary holds a null entry: its rows come
    out null (the entries' validity read by a second LUT), beside the
    column's own nulls, as ``cast_table`` casts the decoded strings."""
    from fugue_tpu_torch.torch_backend.alter import alter_blocks
    from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn

    codes = torch.tensor([0, 1, 2, 1, 0, 2], dtype=torch.int32)
    mask = torch.tensor([True, True, True, False, True, True])
    strings = ft.Schema("x:str")
    blocks = TorchBlocks(6, {"x": TorchColumn(pa.string(), codes, mask, (0, 2),
                                              dictionary=np.array(["1", None, "0"], object))},
                         torch.device("cpu"))
    from fugue_tpu.dataframe.arrow_utils import cast_table
    from fugue_tpu.schema import Schema as JSchema_

    decoded = pa.table({"x": pa.array(["1", None, "0", None, "1", "0"])})
    for dst in ("int", "double", "float16", "bool"):
        got = alter_blocks(blocks, strings, ft.Schema(f"x:{dst}")).columns["x"]
        want = cast_table(decoded, JSchema_(f"x:{dst}")).column("x")
        assert got.mask.tolist() == want.is_valid().to_pylist()
        vals = got.data.tolist()
        assert [v if ok else None for v, ok in zip(vals, got.mask.tolist())] == \
            want.to_pylist()


def test_alter_columns_of_strings_raises_on_a_bad_value() -> None:
    table = pa.table({"x": pa.array(["1", "x", None])})
    with pytest.raises(Exception):
        port().to_df(table).alter_columns("x:int").as_arrow()
    with pytest.raises(Exception):
        port().to_df(table).alter_columns("x:bool").as_arrow()


# ---- streaming ---------------------------------------------------------------

def test_stream_with_uint64_keys_above_2_63_matches_the_reference() -> None:
    """Chunks whose uint64 keys sit above 2^63 (which the reference's
    stream raises ``OverflowError`` on) fold by their stored words: the sums
    and counts of a uint32 and a uint64 payload match the stream tests'
    Python oracle (the uint64's int64 sum wraps, as the bounded aggregate's
    does); MIN of the uint64 payload takes the bounded aggregate (counted
    in ``fallbacks``), which equals numpy."""
    schema = "key:uint64,k2:uint32,p:uint64,q:uint32"

    def make() -> List[pd.DataFrame]:
        rng = np.random.default_rng(16)
        return [pd.DataFrame({
            "key": (rng.integers(0, 5, 200).astype(np.uint64) + np.uint64(U63 + 10)),
            "k2": rng.integers(2**32 - 3, 2**32, 200).astype(np.uint32),
            "p": rng.integers(U63, 2**64 - 1, 200, dtype=np.uint64),
            "q": rng.integers(2**31, 2**32, 200).astype(np.uint32)}) for _ in range(3)]

    te = port()
    got = ft.aggregate(ft.LocalDataFrameIterableDataFrame(iter(make()), schema), ["key", "k2"],
                       engine=te, as_fugue=True, sq=ff.sum(col("q")), cq=ff.count(col("q")),
                       s=ff.sum(col("p")), c=ff.count(col("p"))).as_arrow()
    assert te.stream_stats["chunks"] == 3 and te.fallbacks == {}
    assert str(got.schema) == ("key: uint64\nk2: uint32\nsq: int64\ncq: int64\ns: int64\n"
                               "c: int64")
    # the Python oracle: per key the wrapped int64 sum of the payload's bits
    pdf = pd.concat(make())
    oracle = {(int(k), int(k2)): (int(np.add.reduce(g["p"].to_numpy().view(np.int64))), len(g),
                                  int(g["q"].astype(np.int64).sum()), len(g))
              for (k, k2), g in pdf.groupby(["key", "k2"])}
    assert {(r["key"], r["k2"]): (r["s"], r["c"], r["sq"], r["cq"])
            for r in got.to_pylist()} == oracle
    lo = ft.aggregate(ft.LocalDataFrameIterableDataFrame(iter(make()), schema), ["key"],
                      engine=te, as_fugue=True, m=ff.min(col("p"))).as_arrow()
    assert te.fallbacks == {"aggregate": 1}
    mins = pdf.groupby("key")["p"].min()
    assert {r["key"]: r["m"] for r in lo.to_pylist()} == {int(k): int(v)
                                                          for k, v in mins.items()}


def test_chip_smoke_types_phase_on_cpu() -> None:
    """``chip_smoke``'s types phase at a small size, on the twins."""
    import tempfile

    import chip_smoke as cs

    saved = cs.TYPES_GROUPS, cs.TYPES_DISTINCT
    cs.TYPES_GROUPS, cs.TYPES_DISTINCT = 32, 1 << 7
    try:
        cpu = __import__("torch").device("cpu")
        stats = cs.types_paths(cpu, 30_000, cs.SEED, join_rows=2_000)
        assert [s["case"] for s in stats][-1] == "alter"
        assert cs.types_sku(cpu, 20_000, cs.STRING_SEED)["back_to_str"]["dictionary"] > 0
        assert cs.types_alter(cpu)["casts"] == len(cs.TYPES_ALTER) + 1
        with tempfile.TemporaryDirectory() as tmp:
            assert cs.types_host(cpu, 5_000, cs.SEED, tmp)["kept"] > 0
    finally:
        cs.TYPES_GROUPS, cs.TYPES_DISTINCT = saved
