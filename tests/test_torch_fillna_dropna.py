"""The port's ``fillna`` and ``dropna`` (``TorchExecutionEngine`` on the
CPU, where K6 and K14 run as their twins) against ``JaxExecutionEngine``
pinned to one CPU device, on the same seeded frames built on that
engine's mesh: the cases of ``tests/fugue_tpu/jax_backend/
test_fillna_take_sample.py`` and of ``fugue_tpu_test/execution_suite.py``
(``:263-300``), then seeded frames of every column type with nulls and
NaN. Results are compared as arrow tables row for row and exactly
(``test_torch_set_ops.assert_same_rows``).

A fill the column cannot hold exactly (2.5 into an int64) is answered
by the JAX package's host engine; the port refuses it naming ROADMAP.md
queue 1 item 2(b). The JAX package keeps an integer column's stats when
it fills it, so a group-by on the filled column drops the filled rows
(ROADMAP.md queue 3); the port widens the stats, held against pandas."""

from typing import Any

import numpy as np
import pandas as pd
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu.column import col as jcol
from test_torch_join import _jax_df, _jax_engine
from test_torch_set_ops import NAMES, assert_same_rows

DF = pd.DataFrame({
    "a": [1.0, None, 3.0, None],
    "b": [None, "x", "y", None],
    "c": pd.array([1, 2, None, 4], dtype="Int64"),
})


def _engines(pdf: pd.DataFrame) -> Any:
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    return te, je, te.to_df(pdf), _jax_df(je, pdf)


def typed_frame(seed: int, n: int = 70) -> pd.DataFrame:
    """Every column type the card holds, each with nulls; ``f`` and ``h``
    with NaN too."""
    rng = np.random.default_rng(seed)

    def nulls(arr: Any, dtype: str) -> Any:
        a = pd.array(arr, dtype=dtype)
        a[rng.random(n) < 0.2] = pd.NA
        return a

    s = NAMES[rng.integers(0, 4, n)].copy()
    s[rng.random(n) < 0.2] = None
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.1] = np.nan
    f[rng.random(n) < 0.15] = None
    h = rng.standard_normal(n).astype(np.float32)
    h[rng.random(n) < 0.1] = np.nan
    ts = pd.Series(pd.to_datetime("2022-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n),
                                                                     unit="s"))
    ts[rng.random(n) < 0.2] = pd.NaT
    d = pd.Series(np.datetime64("2020-01-01") + rng.integers(0, 400, n)).astype("datetime64[s]")
    d[rng.random(n) < 0.2] = pd.NaT
    return pd.DataFrame({
        "i": nulls(rng.integers(-5, 5, n), "Int64"),
        "j": nulls(rng.integers(0, 9, n), "Int32"),
        "e": nulls(rng.integers(-3, 3, n), "Int8"),
        "u": rng.integers(0, 255, n).astype(np.uint8),
        "b": nulls(rng.random(n) < 0.5, "boolean"),
        "f": f,
        "h": h,
        "s": s,
        "ts": ts,
        "d": d.dt.date,
    })


def test_fillna_scalar_dict_and_subset():
    te, je, t, j = _engines(DF)
    for kw in (dict(value=-1, subset=["a", "c"]), dict(value={"a": 0.5, "b": "zz", "c": 7}),
               dict(value=0, subset=["c"])):
        assert_same_rows(te.fillna(t, **kw), je.fillna(j, **kw))
    assert te.fallbacks == {}


def test_fillna_after_filter_stays_lazy():
    te, je, t, j = _engines(DF)
    ft_, jf = te.filter(t, ft.col("c") > 1), je.filter(j, jcol("c") > 1)
    got = te.fillna(ft_, value=9.0, subset=["a"])
    assert not got.blocks.nrows_known
    assert_same_rows(got, je.fillna(jf, value=9.0, subset=["a"]))
    assert got.as_arrow().to_pylist() == [{"a": 9.0, "b": "x", "c": 2},
                                          {"a": 9.0, "b": None, "c": 4}]


def test_fillna_inexact_int_fill_is_refused_naming_the_host_engine():
    """2.5 into an int64 column: the JAX package answers on its host
    engine; the port raises naming queue 1 item 2(b) and counts it. An
    exact float fill (2.0) stays on the card."""
    pdf = pd.DataFrame({"c": pd.array([1, None, 3], dtype="Int64")})
    te, je, t, j = _engines(pdf)
    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\(b\)"):
        te.fillna(t, value=2.5)
    assert te.fallbacks == {"fillna": 1}
    got = te.fillna(t, value=2.0)
    assert_same_rows(got, je.fillna(j, value=2.0))
    assert got.as_pandas()["c"].tolist() == [1, 2, 3]


def test_fillna_none_raises_as_the_jax_package():
    te, je, t, j = _engines(DF)
    for value in (None, {"a": None}):
        with pytest.raises(ValueError, match="can't"):
            te.fillna(t, value)
        with pytest.raises(ValueError, match="can't"):
            je.fillna(j, value)


def test_execution_suite_cases():
    a = pd.DataFrame({"x": pd.array([1, None, None], dtype="Int64"), "y": ["a", "b", None]})
    te, je, t, j = _engines(a)
    for kw in (dict(), dict(how="all"), dict(thresh=1), dict(subset=["y"])):
        assert_same_rows(te.dropna(t, **kw), je.dropna(j, **kw))
    assert te.dropna(t).as_pandas().values.tolist() == [[1, "a"]]
    for kw in (dict(value=0, subset=["x"]), dict(value={"x": -1, "y": "z"})):
        assert_same_rows(te.fillna(t, **kw), je.fillna(j, **kw))
    assert te.fillna(t, {"x": -1, "y": "z"}).as_pandas().values.tolist() == [
        [1, "a"], [-1, "b"], [-1, "z"]]


FILLS = {
    "every_column": {"i": 7, "j": -1, "e": 100, "u": 3, "b": True, "f": -0.0, "h": 2.5,
                     "s": "zz", "ts": "2030-05-06 07:08:09", "d": "1999-12-31"},
    "string_in_dictionary": {"s": "bob", "f": 1e300},
    "bool_as_int": {"b": 0, "j": 2147483647},
}


@pytest.mark.parametrize("fills", sorted(FILLS))
def test_fillna_every_type_matches_jax(fills):
    te, je, t, j = _engines(typed_frame(21))
    got = te.fillna(t, FILLS[fills])
    assert_same_rows(got, je.fillna(j, FILLS[fills]))
    assert te.fallbacks == {}
    for name in FILLS[fills]:
        if name != "u":  # no nulls and no float: left as it is
            assert got.blocks.columns[name].mask is None


def test_fillna_string_gets_a_new_dictionary_and_the_source_keeps_its_own():
    """A string fill not in the dictionary extends a new dictionary; the
    JAX package appends it to the source column's (a difference of
    representation: both decode the same)."""
    te, je, t, j = _engines(typed_frame(3))
    before = t.blocks.columns["s"].dictionary.tolist()
    got = te.fillna(t, {"s": "new"})
    assert t.blocks.columns["s"].dictionary.tolist() == before
    assert got.blocks.columns["s"].dictionary.tolist() == before + ["new"]
    assert_same_rows(got, je.fillna(j, {"s": "new"}))
    assert_same_rows(t, j)  # the sources still decode as before


@pytest.mark.parametrize("ncols", [17, 20])
def test_fillna_of_more_columns_than_one_program_takes(ncols, monkeypatch):
    """More fill columns than the interpreter's program took (16, ROADMAP.md
    queue 2 item 17, now retired): one K6 program fills them all, in one
    launch."""
    from fugue_tpu_torch.torch_backend import expr_eval

    rng = np.random.default_rng(8)
    pdf = pd.DataFrame({f"c{i}": np.where(rng.random(30) < 0.3, np.nan, rng.random(30))
                        for i in range(ncols)})
    te, je, t, j = _engines(pdf)
    runs = []
    real = expr_eval.run_program
    monkeypatch.setattr(expr_eval, "run_program",
                        lambda prog, blocks, **kw: runs.append(prog) or real(prog, blocks, **kw))
    got = te.fillna(t, 0.25)
    assert len(runs) == 1 and len(runs[0].outputs) == ncols
    assert_same_rows(got, je.fillna(j, 0.25))


def test_fillna_widens_the_stats_the_group_by_bins_by():
    """The JAX package keeps an integer column's stats when it fills it,
    so its group-by on the filled column drops the filled rows (ROADMAP.md
    queue 3); the port's equals pandas."""
    pdf = pd.DataFrame({"k": pd.array([1, None, 3, None, 2], dtype="Int32"),
                        "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    te = ft.make_execution_engine(device="cpu")
    filled = te.fillna(pdf, 100, subset=["k"])
    assert filled.blocks.columns["k"].stats == (0, 100)
    got = ft.aggregate(filled, "k", engine=te, s=ft.functions.sum(ft.col("v"))).as_pandas()
    want = pdf.fillna({"k": 100}).groupby("k", as_index=False)["v"].sum()
    assert got.sort_values("k")["s"].tolist() == want["v"].tolist()


DROPS = [dict(), dict(how="all"), dict(thresh=5), dict(thresh=10), dict(thresh=0),
         dict(subset=["i", "s"]), dict(how="all", subset=["f", "ts", "d"]),
         dict(subset=["u", "h"]), dict(subset=["i", "i"])]


@pytest.mark.parametrize("filtered", [False, True], ids=["prefix", "filtered"])
@pytest.mark.parametrize("kw", DROPS, ids=[str(d) for d in DROPS])
def test_dropna_matches_jax(kw, filtered):
    te, je, t, j = _engines(typed_frame(13))
    if filtered:
        t, j = te.filter(t, ft.col("e") != 0), je.filter(j, jcol("e") != 0)
    got = te.dropna(t, **kw)
    assert not got.blocks.nrows_known
    assert_same_rows(got, je.dropna(j, **kw))
    assert te.fallbacks == {}


def test_dropna_refusals_and_entry_points():
    te = ft.make_execution_engine(device="cpu")
    with pytest.raises(KeyError):
        te.dropna(DF, subset=["nope"])
    with pytest.raises(ValueError, match="how"):
        te.dropna(DF, how="some")
    out = ft.dropna(DF, how="all", subset=["a", "b"], engine=te)
    assert out["b"].tolist()[1:] == ["x", "y"] and out["a"].tolist()[0] == 1.0
    out = ft.fillna(DF, {"a": 0.0}, engine=te)
    assert out["a"].tolist() == [1.0, 0.0, 3.0, 0.0]
    assert isinstance(ft.dropna(te.to_df(DF), engine=te), ft.TorchDataFrame)
    assert torch.equal(ft.dropna(te.to_df(DF)).blocks.row_valid,
                       torch.tensor([False, False, False, False]))
