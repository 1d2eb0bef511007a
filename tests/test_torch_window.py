"""The port's window functions through ``fugue_tpu_torch.raw_sql`` (on
``TorchExecutionEngine(device="cpu")``: K15's and K16's twins, the
group-by and K10's for whole-partition aggregates) against the JAX engine
pinned to one CPU device, on the statements of
``tests/fugue_tpu/sql_frontend/test_device_window_frames.py`` and
``test_window_functions.py``: every ranking function, the default running
frame, ROWS, GROUPS and RANGE frames (numeric offsets, descending keys,
float offsets, null keys), lag/lead with and without defaults,
first/last/nth_value, strings, ties across peers, NaN and nulls in the
order key and the argument.

Tolerances (``assert_sql_equal``): ranks, counts, integer sums, extrema,
positional values and nulls exactly; a float64 frame sum or average
within rtol 1e-9 plus an atol of 1e-12 times the largest absolute prefix
sum (in window order) of the row's partition (``prefix_atol``): the JAX
package takes frame sums as differences of one float64 prefix sum over
all sorted rows, the port per partition."""

from typing import Any, Dict, Optional

import numpy as np
import pandas as pd
import pytest

import fugue_tpu_torch as ft
from test_torch_sql_select import assert_sql_equal, run_both

ATOL_FACTOR = 1e-12


def _df() -> pd.DataFrame:
    """``tests/fugue_tpu/sql_frontend/test_device_window_frames.py``'s
    frame, with an int ``i`` (nulls) and a date ``d`` beside it."""
    rng = np.random.default_rng(23)
    df = pd.DataFrame({
        "k": rng.integers(0, 5, 60).astype(np.int64),
        "o": rng.permutation(60).astype(np.int64),
        "v": np.round(rng.random(60) * 10, 3),
        "s": rng.choice(["apple", "pear", "fig", "yuzu"], 60),
        "i": pd.array(rng.integers(-20, 20, 60), dtype="Int64"),
        "d": rng.integers(0, 12, 60).astype(np.int32),
    })
    df.loc[::8, "v"] = np.nan
    df.loc[3::9, "i"] = pd.NA
    return df


def prefix_atol(df: pd.DataFrame, by: str, order: str, arg: str, desc: bool = False
                ) -> Dict[Any, float]:
    """Per partition key, ``ATOL_FACTOR`` times the largest absolute
    prefix sum of ``arg``'s valid values in the window's order."""
    out = {}
    for key, g in df.groupby(by):
        vals = g.sort_values(order, ascending=not desc, kind="stable")[arg]
        pre = np.cumsum(vals.astype(float).fillna(0.0).to_numpy())
        out[key] = ATOL_FACTOR * float(np.abs(pre).max()) if len(pre) else 0.0
    return out


def check(head: str, tail: str = "ORDER BY k, o", df: Optional[pd.DataFrame] = None,
          sums: Optional[Dict[str, Any]] = None) -> Any:
    """``head`` over the frame, then ``tail``, on both engines; the float
    sum columns of ``sums`` (name -> (arg, order[, desc])) within the
    stated tolerance, everything else exactly."""
    df = _df() if df is None else df
    got, want, te = run_both(head, df, tail)
    atol = None
    if sums:
        keys = got.as_pandas()["k"]
        atol = {name: keys.map(prefix_atol(df, "k", *spec)).to_numpy()
                for name, spec in sums.items()}
    assert_sql_equal(got, want, atol=atol)
    return got


def test_rows_frame_sum_count_avg():
    check("SELECT k, o, SUM(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS ms,"
          " COUNT(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS mc,"
          " AVG(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS ma FROM",
          sums={"ms": ("o", "v"), "ma": ("o", "v")})


def test_rows_frame_count_star_and_empty_frames():
    check("SELECT k, o, COUNT(*) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 1 FOLLOWING AND 2 FOLLOWING) AS c,"
          " SUM(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 1 FOLLOWING AND 2 FOLLOWING) AS s FROM", sums={"s": ("o", "v")})


def test_rows_frame_min_max():
    check("SELECT k, o, MIN(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) AS lo,"
          " MAX(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 3 PRECEDING AND CURRENT ROW) AS hi,"
          " MIN(i) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS ilo FROM")


def test_rows_unbounded_spellings_and_wide_offsets():
    check("SELECT k, o, SUM(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS r,"
          " SUM(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS t,"
          " SUM(i) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 100 PRECEDING AND 70 FOLLOWING) AS wi FROM",
          sums={"r": ("o", "v"), "t": ("o", "v")})


def test_lag_lead():
    check("SELECT k, o, LAG(v) OVER (PARTITION BY k ORDER BY o) AS l1,"
          " LEAD(v, 2) OVER (PARTITION BY k ORDER BY o) AS l2,"
          " LAG(v, 1, -1) OVER (PARTITION BY k ORDER BY o) AS l3,"
          " LEAD(i, 3, 7) OVER (PARTITION BY k ORDER BY o) AS l4 FROM")


def test_lag_lead_of_strings():
    check("SELECT k, o, s, LAG(s) OVER (PARTITION BY k ORDER BY o) AS p,"
          " LEAD(s) OVER (PARTITION BY k ORDER BY o) AS nx FROM")


def test_first_last_nth():
    check("SELECT k, o, FIRST_VALUE(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS f,"
          " LAST_VALUE(v) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS l,"
          " NTH_VALUE(v, 2) OVER (PARTITION BY k ORDER BY o"
          " ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING) AS n2 FROM")


def test_first_last_default_frame_and_strings():
    check("SELECT k, o, FIRST_VALUE(v) OVER (PARTITION BY k ORDER BY o) AS f,"
          " LAST_VALUE(v) OVER (PARTITION BY k ORDER BY o) AS l,"
          " FIRST_VALUE(s) OVER (PARTITION BY k ORDER BY o) AS fs FROM")


def test_running_desc_nulls_first_over_nan():
    check("SELECT k, o, SUM(v) OVER (PARTITION BY k ORDER BY v DESC NULLS FIRST) AS s,"
          " COUNT(*) OVER (PARTITION BY k ORDER BY v DESC NULLS FIRST) AS c FROM",
          sums={"s": ("v", "v", True)})


def test_range_spellings_of_default_frames():
    check("SELECT k, o, SUM(v) OVER (PARTITION BY k ORDER BY o"
          " RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS r,"
          " SUM(v) OVER (PARTITION BY k ORDER BY o"
          " RANGE BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS t FROM",
          sums={"r": ("o", "v"), "t": ("o", "v")})


def test_running_peers_share_their_groups_last_value():
    dd = pd.DataFrame({"k": [1] * 6, "o": [1, 1, 2, 2, 2, 3],
                       "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]})
    got = check("SELECT k, o, v, SUM(v) OVER (PARTITION BY k ORDER BY o) AS s FROM",
                "ORDER BY o, v", df=dd)
    assert list(got.as_pandas()["s"]) == [3.0, 3.0, 15.0, 15.0, 15.0, 21.0]


def test_groups_frames():
    check("SELECT k, o, SUM(v) OVER (PARTITION BY k ORDER BY o"
          " GROUPS BETWEEN 1 PRECEDING AND CURRENT ROW) AS s,"
          " COUNT(v) OVER (PARTITION BY k ORDER BY v"
          " GROUPS BETWEEN 2 PRECEDING AND 1 FOLLOWING) AS c,"
          " MAX(i) OVER (PARTITION BY k ORDER BY d"
          " GROUPS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS mx FROM",
          sums={"s": ("o", "v")})


def test_groups_frame_ties_share_groups():
    dd = pd.DataFrame({"k": [1] * 6, "o": [1, 1, 2, 2, 2, 5],
                       "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]})
    got = check("SELECT k, o, v, SUM(v) OVER (PARTITION BY k ORDER BY o"
                " GROUPS BETWEEN 1 PRECEDING AND CURRENT ROW) AS s FROM", "ORDER BY o, v",
                df=dd)
    assert list(got.as_pandas()["s"]) == [3.0, 3.0, 15.0, 15.0, 15.0, 18.0]


def test_range_offsets():
    check("SELECT k, o, SUM(v) OVER (PARTITION BY k ORDER BY o"
          " RANGE BETWEEN 5 PRECEDING AND 5 FOLLOWING) AS s,"
          " AVG(v) OVER (PARTITION BY k ORDER BY o"
          " RANGE BETWEEN 10 PRECEDING AND CURRENT ROW) AS a,"
          " SUM(i) OVER (PARTITION BY k ORDER BY d"
          " RANGE BETWEEN 2 PRECEDING AND 1 FOLLOWING) AS si FROM",
          sums={"s": ("o", "v"), "a": ("o", "v")})


def test_range_desc_and_float_offsets():
    check("SELECT k, o, MIN(v) OVER (PARTITION BY k ORDER BY v DESC"
          " RANGE BETWEEN 2.5 PRECEDING AND 0 FOLLOWING) AS m FROM")


def test_range_null_keys_resolve_to_their_peer_group():
    dd = pd.DataFrame({"k": [1] * 5, "o": [0, 1, 2, 3, 4], "x": [1.0, 2.0, None, None, 9.0],
                       "v": [10.0, 20.0, 1.0, 2.0, 40.0]})
    got = check("SELECT k, o, v, SUM(v) OVER (PARTITION BY k ORDER BY x"
                " RANGE BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS s FROM", "ORDER BY o", df=dd)
    assert list(got.as_pandas()["s"]) == [30.0, 30.0, 3.0, 3.0, 40.0]


def test_range_and_groups_first_last_value():
    check("SELECT k, o, FIRST_VALUE(v) OVER (PARTITION BY k ORDER BY o"
          " GROUPS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS f,"
          " LAST_VALUE(v) OVER (PARTITION BY k ORDER BY o"
          " RANGE BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS l FROM")


def test_range_offsetless_spellings():
    dd = pd.DataFrame({"k": [1, 1, 1], "o": [1, 2, 2], "v": [1.0, 2.0, 3.0]})
    got = check("SELECT k, o, v, SUM(v) OVER (PARTITION BY k ORDER BY o"
                " RANGE BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) AS s,"
                " SUM(v) OVER (PARTITION BY k ORDER BY o"
                " RANGE BETWEEN CURRENT ROW AND CURRENT ROW) AS c FROM", "ORDER BY o, v", df=dd)
    assert [tuple(x) for x in got.as_pandas()[["o", "s", "c"]].to_numpy()] == [
        (1, 6.0, 1.0), (2, 5.0, 5.0), (2, 5.0, 5.0)]


def test_ranking_family_with_ties_and_nulls():
    check("SELECT k, o, ROW_NUMBER() OVER (PARTITION BY k ORDER BY d, o) AS rn,"
          " RANK() OVER (PARTITION BY k ORDER BY d) AS r,"
          " DENSE_RANK() OVER (PARTITION BY k ORDER BY d DESC) AS dr,"
          " RANK() OVER (ORDER BY v NULLS FIRST) AS rv,"
          " NTILE(4) OVER (PARTITION BY k ORDER BY o) AS nt,"
          " PERCENT_RANK() OVER (PARTITION BY k ORDER BY d) AS pr,"
          " CUME_DIST() OVER (ORDER BY i DESC) AS cd FROM")


def test_rank_over_two_keys_and_a_string():
    check("SELECT k, o, RANK() OVER (PARTITION BY k ORDER BY s DESC, d) AS r,"
          " DENSE_RANK() OVER (ORDER BY s, i NULLS FIRST) AS dr FROM")


def test_whole_partition_aggregates():
    check("SELECT k, o, SUM(v) OVER (PARTITION BY k) AS s, AVG(v) OVER (PARTITION BY k) AS m,"
          " COUNT(*) OVER (PARTITION BY k) AS c, MIN(i) OVER (PARTITION BY k) AS lo,"
          " MAX(d) OVER (PARTITION BY k) AS hi, SUM(i) OVER () AS si FROM")


def test_running_min_max_and_integer_sums():
    check("SELECT k, o, MIN(v) OVER (PARTITION BY k ORDER BY o DESC) AS lo,"
          " MAX(v) OVER (ORDER BY o) AS hi, SUM(i) OVER (PARTITION BY k ORDER BY d) AS si,"
          " AVG(i) OVER (PARTITION BY k ORDER BY o) AS ai FROM")


def test_timestamp_max_over_partition():
    df = _df().assign(ts=pd.to_datetime("2024-01-01") + pd.to_timedelta(np.arange(60), "h"))
    check("SELECT k, o, MAX(ts) OVER (PARTITION BY k) AS m,"
          " MIN(ts) OVER (PARTITION BY k ORDER BY o) AS r FROM", df=df)


@pytest.mark.parametrize("statement,what", [
    ("SELECT k, o, LAG(i, 1, 0.5) OVER (PARTITION BY k ORDER BY o) AS p FROM",
     "float default"),
    ("SELECT k, o, SUM(s) OVER (PARTITION BY k ORDER BY o) AS p FROM", "string column"),
    ("SELECT k, o, SUM(v) OVER (PARTITION BY k ORDER BY o"
     " ROWS BETWEEN CURRENT ROW AND 2147483647 FOLLOWING) AS s FROM", "does not lower"),
    ("SELECT k, o, SUM(v * 2) OVER (PARTITION BY k ORDER BY o) AS s FROM", "does not lower"),
])
def test_refusals_name_roadmap_item_2b_and_count(statement, what):
    """What the JAX package answers on its host runner (its device plan
    declines, or the bridge does not lower it) raises naming ROADMAP.md
    queue 1 item 2(b) and counts one refused ``sql_select``."""
    te = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError, match=rf"(?s){what}.*queue 1 item 2\(b\)"):
        ft.raw_sql(statement, _df(), engine=te)
    assert te.fallbacks == {"sql_select": 1}


def test_partition_by_a_string_and_integer_positional_values():
    check("SELECT k, o, RANK() OVER (PARTITION BY s ORDER BY o) AS r,"
          " SUM(i) OVER (PARTITION BY s ORDER BY d) AS si,"
          " LAG(d, 2, 5) OVER (PARTITION BY k ORDER BY o) AS lg FROM")


def test_windows_over_an_empty_frame():
    got = check("SELECT k, o, RANK() OVER (PARTITION BY k ORDER BY o) AS r, SUM(v) OVER"
                " (PARTITION BY k ORDER BY o ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS s,"
                " MIN(v) OVER (PARTITION BY k ORDER BY d GROUPS BETWEEN 1 PRECEDING AND 1"
                " FOLLOWING) AS m FROM", df=_df().iloc[:0])
    assert got.count() == 0
