"""DISTINCT aggregations and the keyless aggregate of the port, against
``JaxExecutionEngine.aggregate`` on one CPU device, and the CPU rehearsal
of ``chip_smoke.py``'s full group-by phase.

DISTINCT counts each (keys, value) once through the first-occurrence mask
of the keys' and the argument's factorization: COUNT/SUM/AVG DISTINCT on
binned keys stay on the binned packed aggregate, as in the JAX package;
MIN/MAX DISTINCT are MIN/MAX. The keyless aggregate runs the keyed
machinery over one segment.

Tolerances, as in ``test_torch_segment_aggs.py``: everything exactly
except float sums and means (rtol 1e-5) and the variance family (rtol
1e-9); values compared where the mask is valid, and nulls in the same
places."""

from typing import Dict, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import chip_smoke
import fugue_tpu_torch as ft
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.column.expressions import VARIANCE_FUNCS, _FuncExpr
from test_torch_segment_aggs import _frames, compare, inexact_of, run_both

N = 2000
CPU = torch.device("cpu")


def _data(seed: int = 41) -> pa.Table:
    """An int32 key ``k`` (binned), a float32 key ``g`` (the sort path) and
    DISTINCT arguments with many repeats: ``u`` int32 with nulls, ``f``
    float32 with NaN, -0.0 and +0.0, ``b`` bool."""
    rng = np.random.default_rng(seed)
    f = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 7.0, 1e30])[rng.integers(0, 7, N)]
    return pa.table({
        "k": pa.array(rng.integers(0, 6, N).astype(np.int32)),
        "g": pa.array(rng.choice([-1.5, 0.0, 4.0], N).astype(np.float32)),
        "u": pa.array(rng.integers(-20, 40, N).astype(np.int32), mask=rng.random(N) < 0.1),
        "f": pa.array(f.astype(np.float32)),
        "b": pa.array(rng.random(N) < 0.4),
    })


_PACKED = ("count", "sum", "avg")
_ALL = ("count", "sum", "avg", "min", "max", "median", *VARIANCE_FUNCS)


def _distinct(funcs: Tuple[str, ...], cols: Tuple[str, ...]) -> Dict[str, Tuple[str, str, bool]]:
    return {f"{f}_{c}": (f, c, True) for f in funcs for c in cols}


@pytest.mark.parametrize("layout", ["prefix", "prefix_short", "masked"])
@pytest.mark.parametrize("keys", [["k"], ["g"], None], ids=["binned", "sort", "keyless"])
def test_packed_distinct_matches_jax(keys, layout):
    """COUNT/SUM/AVG DISTINCT: on binned keys the binned packed aggregate
    (no generic branch), else the generic branch or the keyless one."""
    aggs = _distinct(_PACKED, ("u", "f"))
    aggs["n"] = ("count", "u", False)
    tres, jres, te = run_both(_frames(_data(), layout), keys, aggs)
    compare(tres, jres, inexact_of(aggs))
    assert te.fallbacks == {}
    assert ("generic" in te.strategy_counts) == (keys == ["g"])


@pytest.mark.parametrize("layout", ["prefix", "masked"])
@pytest.mark.parametrize("keys", [["k"], ["g"], None], ids=["binned", "sort", "keyless"])
def test_every_distinct_form_matches_jax(keys, layout):
    """Each DISTINCT form the JAX package runs on its device: count, sum,
    avg, min, max, median and the variance family."""
    aggs = _distinct(_ALL, ("u", "f", "b"))
    tres, jres, te = run_both(_frames(_data(), layout), keys, aggs)
    compare(tres, jres, inexact_of(aggs))
    assert te.fallbacks == {}


def test_min_max_distinct_are_min_max():
    tres = ft.aggregate(_data(), "k", engine=ft.make_execution_engine(device="cpu"),
                        a=ff.min(ft.col("f")), b=ff.max(ft.col("u")),
                        c=ff.count(ft.col("u")))
    plain = tres.sort_values("k").reset_index(drop=True)
    aggs = {"a": ("min", "f", True), "b": ("max", "u", True), "c": ("count", "u", False)}
    dres, _, _ = run_both(_data(), ["k"], aggs)
    pd.testing.assert_frame_equal(dres.as_pandas().sort_values("k").reset_index(drop=True),
                                  plain)


def test_distinct_counts_match_numpy():
    """COUNT(DISTINCT u) and SUM(DISTINCT u) by k against pandas' own
    ``nunique`` and the sum of the unique values."""
    table = _data()
    out = ft.aggregate(table, "k", engine=ft.make_execution_engine(device="cpu"),
                       c=ff.count_distinct(ft.col("u")),
                       s=_FuncExpr("sum", ft.col("u"), arg_distinct=True, is_aggregation=True))
    pdf = table.to_pandas()
    want = pdf.groupby("k")["u"].agg(["nunique", lambda x: x.dropna().unique().sum()])
    got = out.set_index("k").sort_index()
    np.testing.assert_array_equal(got["c"].to_numpy(), want["nunique"].to_numpy())
    np.testing.assert_array_equal(got["s"].to_numpy(), want.iloc[:, 1].to_numpy())


@pytest.mark.parametrize("layout", ["prefix", "prefix_short", "masked"])
def test_keyless_aggregate_matches_jax(layout):
    """Every function with no keys: one row."""
    aggs = {f"{f}_{c}": (f, c, False) for f in ("min", "max", "first", "last", "median",
                                                "sum", "avg", "count", *VARIANCE_FUNCS)
            for c in ("u", "f", "b")}
    aggs["n"] = ("count", "*", False)
    tres, jres, te = run_both(_frames(_data(), layout), None, aggs)
    compare(tres, jres, inexact_of(aggs))
    assert tres.count() == 1 and te.strategy_counts["global"] == 1


def test_keyless_aggregate_of_a_frame_with_no_real_row():
    """A masked frame whose every row is gone: counts 0, and every other
    aggregate NULL, FIRST and LAST included (``:3398-3411``)."""
    tdf, jdf = _frames(_data(), "masked")
    tdf.blocks.row_valid = torch.zeros_like(tdf.blocks.row_valid)
    jdf.native.row_valid = jdf.native.row_valid & False
    aggs = {f"{f}_u": (f, "u", False) for f in ("min", "first", "last", "median", "sum",
                                                "count", "var_pop")}
    tres, jres, _ = run_both((tdf, jdf), None, aggs)
    compare(tres, jres, inexact_of(aggs))
    row = tres.as_pandas().iloc[0]
    assert row["count_u"] == 0 and row.drop("count_u").isna().all()


@pytest.mark.parametrize("func", ["first", "last"])
def test_first_last_distinct_raise(func):
    """The JAX package answers FIRST/LAST DISTINCT on its host engine; the
    port refuses them, naming the ROADMAP item, and counts the refusal."""
    engine = ft.make_execution_engine(device="cpu")
    expr = _FuncExpr(func, ft.col("u"), arg_distinct=True, is_aggregation=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 2"):
        ft.aggregate(_data(), "k", engine=engine, x=expr)
    assert engine.fallbacks == {"aggregate": 1}


@pytest.mark.parametrize("layout", ["prefix", "prefix_short", "masked"])
@pytest.mark.parametrize("keys", [["k"], ["g"], []], ids=["binned", "sort", "keyless"])
def test_distinct_masks_are_the_first_occurrences(keys, layout):
    """``_distinct_masks`` (one K13 launch a DISTINCT argument, its twin
    here) equals the gather it replaced, ``first_idx[seg] == row``, on
    every real row, and sets no row that is not real, on frames with such
    rows."""
    from fugue_tpu_torch.torch_backend import groupby
    from fugue_tpu_torch.torch_backend.execution_engine import _distinct_masks

    blocks = _frames(_data(), layout)[0].blocks
    masks = _distinct_masks(blocks, keys, {"cu": "u", "cf": "f", "su": "u", "cb": "b"})
    assert list(masks) == ["u", "f", "b"]
    real = blocks.validity()
    rows = torch.arange(blocks.padded_nrows, dtype=torch.int32)
    for arg, mask in masks.items():
        fr = groupby.factorize_keys(blocks, keys + [arg])
        first = fr.first_idx.index_select(0, fr.seg.clamp(max=fr.num_segments - 1).long())
        assert torch.equal(mask & real, (first == rows) & real)
        assert not (mask & ~real).any()
        assert int(mask.sum()) == int(fr.num_groups_dev)


def test_chip_smoke_full_groupby_on_cpu():
    """The full group-by phase of ``chip_smoke.py`` at a small size on the
    CPU (the card runs it at 100M rows): keyed and keyless, each checked
    against its numpy/pandas oracle inside the phase."""
    stats = chip_smoke.full_groupby(CPU, 20_000, 64, 500, 42, 1)
    assert [s["case"] for s in stats] == ["keyed", "keyless"]
    for s in stats:
        assert s["launches"] == dict.fromkeys(s["launches"], 0)  # the CPU runs the twins
        assert s["max_rel_err"]["sd"] < 1e-9
