"""The port's SQL SELECT (``fugue_tpu_torch.raw_sql`` on
``TorchExecutionEngine(device="cpu")``, the kernels' twins) against the
JAX engine pinned to one CPU device (``fugue_tpu.workflow.api.raw_sql``),
on the same frames made from seeded numpy: joins, set operations,
DISTINCT, scalar subqueries, CTEs, IN/EXISTS, ORDER BY/LIMIT/OFFSET with
nulls first and last, and SQL's three-valued NOT IN (the plain case, an
empty right side, a null on the right). The JAX frames are built on the
engine's one-device mesh (``test_torch_join._jax_df``: its ``to_df`` of
pandas takes every forced device, whose join paths raise, ROADMAP.md
queue 3), and its ``fallbacks`` must stay empty, so that the reference
really ran its device plans.

Results are compared as arrow tables (``assert_sql_equal``): the same
schema, the same nulls (the port's float NaN read as null, as the JAX
package's ``as_arrow`` gives it), strings decoded, every other value bit
for bit unless a float tolerance is given; row for row under an ORDER BY
over a unique key, else as sorted row sets."""

from typing import Any, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu_torch as ft
from fugue_tpu.workflow.api import raw_sql as jax_raw_sql
from test_torch_join import _jax_df, _jax_engine
from test_torch_set_ops import relational_table


def frames(seed: int = 7) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """``a``: 400 rows of an int64 key over 12 values, a float ``v`` with
    5 % NaN, an int ``i`` with nulls and a string ``s`` with nulls; ``b``:
    9 keys with a payload ``w``."""
    rng = np.random.default_rng(seed)
    n = 400
    v = rng.standard_normal(n)
    v[rng.random(n) < 0.05] = np.nan
    i = pd.array(rng.integers(-50, 50, n), dtype="Int64")
    i[rng.random(n) < 0.1] = pd.NA
    s = pd.array(rng.choice(["ann", "bob", "cy", "dee"], n), dtype=object)
    s[rng.random(n) < 0.1] = None
    a = pd.DataFrame({"k": rng.integers(0, 12, n).astype(np.int64), "v": v, "i": i, "s": s,
                      "o": rng.permutation(n).astype(np.int64)})
    b = pd.DataFrame({"k": np.arange(9, dtype=np.int64), "w": rng.random(9)})
    return a, b


def run_both(*parts: Any) -> Tuple[Any, Any, Any]:
    """The statement on the port (CPU) and on the JAX engine; returns the
    port's result, the JAX engine's and the port's engine. Both engines'
    ``fallbacks`` must be empty."""
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    got = ft.raw_sql(*parts, engine=te, as_fugue=True)
    want = jax_raw_sql(*[p if isinstance(p, str) else _jax_df(je, p) for p in parts],
                       engine=je, as_fugue=True)
    assert je.fallbacks == {}, je.fallbacks
    assert te.fallbacks == {}, te.fallbacks
    return got, want, te


def _columns(table: pa.Table) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """Per column its name, validity and values (strings as objects)."""
    out = []
    for name in table.column_names:
        c = table.column(name).combine_chunks()
        valid = c.is_valid().to_numpy(zero_copy_only=False)
        if pa.types.is_string(c.type) or pa.types.is_large_string(c.type):
            vals = np.asarray(c.to_pylist(), dtype=object)
        else:
            fill = False if pa.types.is_boolean(c.type) else 0
            vals = c.fill_null(fill).to_numpy(zero_copy_only=False)
        out.append((name, valid, vals))
    return out


def _sorted_rows(table: pa.Table) -> pa.Table:
    """The rows of ``table`` in one canonical order (nulls last)."""
    if table.num_rows == 0:
        return table
    keys = [(n, "ascending") for n in table.column_names]
    return table.take(pa.compute.sort_indices(table, sort_keys=keys))


def assert_sql_equal(got: Any, want: Any, *, ordered: bool = True,
                     atol: Optional[dict] = None, rtol: float = 1e-9) -> None:
    """The port's frame and the JAX package's: the same schema, then per
    column the same nulls and values; a float column named in ``atol``
    within ``rtol`` and that column's absolute tolerance (a number, or an
    array over the rows), every other value exactly (floats bit for
    bit). ``ordered=False`` compares the rows as sorted sets."""
    g, w = relational_table(got), want.as_arrow()
    assert str(got.schema) == str(want.schema), (got.schema, want.schema)
    assert g.num_rows == w.num_rows, (g.num_rows, w.num_rows)
    if not ordered:
        g, w = _sorted_rows(g), _sorted_rows(w)
    for (name, gv, ga), (_, wv, wa) in zip(_columns(g), _columns(w)):
        np.testing.assert_array_equal(gv, wv, err_msg=f"nulls of {name}")
        if atol is not None and name in atol:
            _assert_close(ga, wa, gv, atol[name], rtol, name)
        elif ga.dtype.kind == "f":
            np.testing.assert_array_equal(ga[gv].view(np.uint8), wa[gv].view(np.uint8),
                                          err_msg=f"values of {name}")
        else:
            np.testing.assert_array_equal(ga[gv], wa[gv], err_msg=f"values of {name}")


def _assert_close(ga: np.ndarray, wa: np.ndarray, valid: np.ndarray, atol: Any, rtol: float,
                  name: str) -> None:
    a = np.broadcast_to(np.asarray(atol, dtype=float), ga.shape)[valid]
    diff = np.abs(ga[valid].astype(float) - wa[valid].astype(float))
    bound = rtol * np.abs(wa[valid].astype(float)) + a
    assert np.all(diff <= bound), f"values of {name} differ by up to {diff.max()}"


def test_join_group_by_order_by():
    a, b = frames()
    got, want, te = run_both("SELECT a.k, SUM(v) AS s, AVG(w) AS m, COUNT(*) AS c FROM", a,
                             "AS a JOIN", b, "AS b ON a.k = b.k GROUP BY a.k ORDER BY k")
    assert_sql_equal(got, want)
    assert te.strategy_counts.get("join_expand", 0) + te.strategy_counts.get("join_unique", 0) == 1


@pytest.mark.parametrize("how", ["LEFT JOIN", "RIGHT JOIN", "FULL OUTER JOIN", "LEFT SEMI JOIN",
                                 "LEFT ANTI JOIN"])
def test_join_kinds_using(how):
    a, b = frames(3)
    cols = "k, o, v" if "SEMI" in how or "ANTI" in how else "k, o, v, w"
    got, want, _ = run_both(f"SELECT {cols} FROM", a, f"AS a {how}", b, "AS b USING (k)")
    assert_sql_equal(got, want, ordered=False)


@pytest.mark.parametrize("op", ["UNION", "UNION ALL", "EXCEPT", "EXCEPT ALL", "INTERSECT",
                                "INTERSECT ALL"])
def test_set_operations(op):
    a, _ = frames(11)
    got, want, _ = run_both("SELECT k, s FROM", a, "WHERE v > 0", op, "SELECT k, s FROM", a,
                            "WHERE i > 0 ORDER BY k, s NULLS FIRST")
    assert_sql_equal(got, want)


def test_distinct_and_where():
    a, _ = frames(5)
    got, want, _ = run_both("SELECT DISTINCT k, s FROM", a, "WHERE i IS NOT NULL AND k < 9")
    assert_sql_equal(got, want, ordered=False)


def test_scalar_subquery_inlined():
    a, _ = frames(9)
    got, want, _ = run_both("SELECT k, o, v FROM", a, "WHERE v > (SELECT AVG(v) FROM", a,
                            ") ORDER BY o")
    assert_sql_equal(got, want)


def test_cte_read_twice_runs_once(monkeypatch):
    a, _ = frames(13)
    te = ft.make_execution_engine(device="cpu")
    calls = []
    select = te.select

    def counted(*args: Any, **kw: Any) -> Any:
        calls.append(1)
        return select(*args, **kw)

    monkeypatch.setattr(te, "select", counted)
    parts = ("WITH t AS (SELECT k, v FROM", a, "WHERE v > 0.5) SELECT k FROM t UNION ALL "
             "SELECT k FROM t ORDER BY k")
    got = ft.raw_sql(*parts, engine=te, as_fugue=True)
    je = _jax_engine()
    want = jax_raw_sql(parts[0], _jax_df(je, a), parts[2], engine=je, as_fugue=True)
    assert je.fallbacks == {} and te.fallbacks == {}
    assert_sql_equal(got, want)
    assert len(calls) == 3  # the CTE's projection once, each branch's once


def test_in_and_exists_subqueries():
    a, b = frames(17)
    got, want, _ = run_both("SELECT k, o FROM", a, "WHERE k IN (SELECT k FROM", b,
                            "WHERE w > 0.3) ORDER BY o")
    assert_sql_equal(got, want)
    got, want, _ = run_both("SELECT k, o FROM", a, "AS a WHERE NOT EXISTS (SELECT * FROM", b,
                            "AS b WHERE b.k = a.k) ORDER BY o")
    assert_sql_equal(got, want)


@pytest.mark.parametrize("order", [
    "ORDER BY v DESC, o LIMIT 25",
    "ORDER BY v NULLS FIRST, o LIMIT 30 OFFSET 5",
    "ORDER BY i DESC NULLS LAST, o",
    "ORDER BY s NULLS FIRST, k DESC, o LIMIT 40",
    "ORDER BY 2 DESC, 1 LIMIT 7 OFFSET 390",
    "LIMIT 10",
])
def test_order_by_limit_offset(order):
    a, _ = frames(19)
    got, want, _ = run_both("SELECT o, k, v, i, s FROM", a, order)
    assert_sql_equal(got, want)


def test_order_by_a_filtered_frame_with_offset_past_the_end():
    a, _ = frames(21)
    got, want, _ = run_both("SELECT o, v FROM", a, "WHERE k = 3 ORDER BY v, o LIMIT 5 OFFSET 1000")
    assert_sql_equal(got, want)
    assert got.count() == 0


def _not_in_right(case: str) -> pd.DataFrame:
    if case == "empty_right":
        return pd.DataFrame({"k": pd.array([], dtype="Int64")})
    k = pd.array([1, 4, 7, 9], dtype="Int64")
    if case == "null_on_right":
        k[2] = pd.NA
    return pd.DataFrame({"k": k})


@pytest.mark.parametrize("case", ["plain", "empty_right", "null_on_right"])
def test_not_in_three_valued(case):
    a, _ = frames(23)
    a = a.assign(k=pd.array(a["k"], dtype="Int64"))
    a.loc[::17, "k"] = pd.NA
    right = _not_in_right(case)
    got, want, _ = run_both("SELECT k, o FROM", a, "WHERE k NOT IN (SELECT k FROM", right,
                            ") ORDER BY o")
    assert_sql_equal(got, want)
    nulls = int(a["k"].isna().sum())
    if case == "empty_right":
        assert got.count() == len(a)  # every row, a null key too
    elif case == "null_on_right":
        assert got.count() == 0
    else:
        assert got.count() == int((~a["k"].isin([1, 4, 7, 9]) & a["k"].notna()).sum())
        assert got.count() < len(a) - nulls


def test_not_in_count_stays_lazy():
    a, _ = frames(29)
    te = ft.make_execution_engine(device="cpu")
    out = ft.raw_sql("SELECT k, o FROM", a, "WHERE k NOT IN (SELECT k FROM",
                     _not_in_right("plain"), ")", engine=te, as_fugue=True)
    assert not out.blocks.nrows_known
    assert out.count() == int((~a["k"].isin([1, 4, 7, 9])).sum())


def test_a_shape_the_bridge_does_not_lower_is_refused_and_counted():
    a, b = frames(31)
    te = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md queue 1 item 2\(b\)"):
        ft.raw_sql("SELECT a.o FROM", a, "AS a JOIN", b, "AS b ON a.k < b.k", engine=te)
    assert te.fallbacks == {"sql_select": 1}


def test_a_device_plan_that_raises_is_not_caught():
    a, b = frames(37)
    te = ft.make_execution_engine(device="cpu")
    with pytest.raises(ValueError, match="schema mismatch"):
        ft.raw_sql("SELECT k, o FROM", a, "UNION SELECT k, w FROM", b, engine=te)
    assert te.fallbacks == {}


def test_raw_sql_returns_pandas_or_the_torch_frame():
    a, _ = frames(41)
    te = ft.make_execution_engine(device="cpu")
    out = ft.raw_sql("SELECT k, COUNT(*) AS c FROM", a, "GROUP BY k ORDER BY k", engine=te)
    assert isinstance(out, pd.DataFrame)
    pd.testing.assert_series_equal(out["c"], a.groupby("k").size().reset_index(drop=True),
                                   check_names=False, check_dtype=False)
    tdf = te.to_df(a)
    assert isinstance(ft.raw_sql("SELECT k FROM", tdf, "LIMIT 3"), ft.TorchDataFrame)
