"""The rest of the group-by (``groupby.segment_aggs``: min, max, first,
last, median and the variance family beside count/sum/avg) and the twins
of its kernels (``segment_extrema_reference``, ``segment_sq_dev_reference``
in ``fugue_tpu_torch/kernels/reference.py``), against numpy and against
``JaxExecutionEngine.aggregate`` on one CPU device.

The same seeded numpy data is a frame on both sides, in three layouts:
a prefix frame, a prefix frame whose padding holds real-looking rows, and
a masked frame. Keys: an int32 key with nulls (the binned
factorization: the generic branch with its ``occupied`` bins), a float32
key (the sort path) and none (the keyless aggregate).

Tolerances: keys, counts, integer sums, min, max, first, last and median
exactly (a float's sign of zero and NaN included); float sums and means
at rtol 1e-5 (float32 sums in different orders); the variance family at
rtol 1e-9 (two-pass float64 on both sides, summed in different orders).
Values are compared only where the result's mask is valid, and the masks
(nulls) must be equal. The JAX package's generic branch rounds the mean
of an integer or bool column to float32 (ROADMAP.md queue 3), so that
mean is also held against numpy, at rtol 1e-12."""

from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu.collections.partition import PartitionSpec as JPartitionSpec
from fugue_tpu.column import col as jcol
from fugue_tpu.column.expressions import _FuncExpr as JFunc
from fugue_tpu.execution import make_execution_engine as make_jax_engine
from fugue_tpu.jax_backend import blocks as jblocks
from fugue_tpu.jax_backend.dataframe import JaxDataFrame
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.column.expressions import VARIANCE_FUNCS, _FuncExpr
from fugue_tpu_torch.kernels.reference import (
    Extremum,
    extremum_fill,
    segment_extrema_reference,
    segment_sq_dev_reference,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import blocks as tblocks
from fugue_tpu_torch.torch_backend import groupby
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame

N = 2000
_SHORT = N // 2 + 7
_SPECIAL = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, -np.inf, 3.0e38, 7.0])
_I64 = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0, 1, 2**40, -(2**53) - 1])


def _data(seed: int = 31, n: int = N) -> pa.Table:
    """Keys ``k`` (int32 with nulls) and ``g`` (float32), and payloads of
    every dtype: special floats, int64 extremes, narrow ints, bools, some
    with nulls."""
    rng = np.random.default_rng(seed)

    def nulls(p: float) -> np.ndarray:
        return rng.random(n) < p

    return pa.table({
        "k": pa.array(rng.integers(0, 12, n).astype(np.int32), mask=nulls(0.1)),
        "g": pa.array(rng.choice([-0.5, 0.0, 2.5, 9.0], n).astype(np.float32)),
        "f32": pa.array(_SPECIAL[rng.integers(0, 9, n)].astype(np.float32), mask=nulls(0.15)),
        "f64": pa.array(np.where(rng.random(n) < 0.05, np.nan, rng.standard_normal(n) * 1e3)),
        "i64": pa.array(_I64[rng.integers(0, len(_I64), n)]),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8), mask=nulls(0.2)),
        "u8": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "b": pa.array(rng.random(n) < 0.3, mask=nulls(0.1)),
    })


def jax_device() -> Any:
    return jax.devices()[0]


def _frames(table: pa.Table, layout: str) -> Tuple[TorchDataFrame, JaxDataFrame]:
    """The same rows as a port frame and a JAX frame, in one layout:
    ``prefix``, ``prefix_short`` (only the first ``_SHORT`` rows real) or
    ``masked`` (a ``row_valid`` mask)."""
    port = tblocks.from_arrow(table, Schema(table.schema), torch.device("cpu"))
    ref = jblocks.from_arrow(table, JSchema(table.schema), jblocks.make_mesh([jax_device()]))
    if layout == "prefix_short":
        port._nrows = ref._nrows = _SHORT
    elif layout == "masked":
        valid = np.random.default_rng(5).random(table.num_rows) < 0.6
        port.row_valid, port._nrows = torch.from_numpy(valid), None
        ref.row_valid, ref._nrows = jnp.asarray(valid), None
    return (TorchDataFrame(port, Schema(table.schema)),
            JaxDataFrame(ref, JSchema(table.schema)))


def _rows(blocks: Any, n: int) -> np.ndarray:
    """The positions of a result's real rows."""
    if blocks.row_valid is None:
        return np.arange(n)
    return np.nonzero(np.asarray(blocks.row_valid))[0]


def compare(tres: Any, jres: Any, inexact: Dict[str, float]) -> None:
    """A port result against the JAX engine's, on the device columns (the
    JAX package's ``as_arrow`` turns NaN into null): the same schema, the
    same row layout (a binned result's ``row_valid`` included), per column
    the same null mask and, where valid, the same values: exactly (the
    sign of a float zero and NaN included) unless ``inexact`` gives the
    column's rtol."""
    tb, jb = tres.blocks, jres.native
    assert str(tres.schema) == str(jres.schema)
    assert (tb.row_valid is None) == (jb.row_valid is None)
    n = tb.nrows
    assert n == jb.nrows
    if tb.row_valid is not None:
        np.testing.assert_array_equal(tb.row_valid.numpy(), np.asarray(jb.row_valid))
    rows = _rows(tb, n)
    for name in tres.schema.names:
        g, w = tb.columns[name], jb.columns[name]
        gv, wv = g.data.numpy()[rows], np.asarray(w.data)[rows]
        gm = np.ones(len(rows), bool) if g.mask is None else g.mask.numpy()[rows]
        wm = np.ones(len(rows), bool) if w.mask is None else np.asarray(w.mask)[rows]
        np.testing.assert_array_equal(gm, wm, err_msg=f"nulls of {name}")
        gv, wv = gv[gm], wv[wm]
        assert gv.dtype == wv.dtype, name
        if name in inexact:
            np.testing.assert_allclose(gv, wv, rtol=inexact[name], atol=0, err_msg=name)
        elif gv.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv), err_msg=name)
            keep = ~np.isnan(gv)
            np.testing.assert_array_equal(gv[keep].view(np.uint8), wv[keep].view(np.uint8),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=name)


def run_both(table_or_frames: Any, keys: Optional[List[str]],
             aggs: Dict[str, Tuple[str, str, bool]]) -> Tuple[Any, Any, Any]:
    """The aggregate ``{name: (function, column, distinct)}`` by ``keys``
    on the port (CPU) and on the JAX engine pinned to one device; returns
    both results and the port's engine."""
    te = ft.make_execution_engine(device="cpu")
    je = make_jax_engine("jax", {"fugue.jax.devices": "0"})
    frames = table_or_frames
    tin, jin = frames if isinstance(frames, tuple) else _frames(frames, "prefix")
    tcols = [_FuncExpr(f, ft.col(c), arg_distinct=d, is_aggregation=True).alias(n)
             for n, (f, c, d) in aggs.items()]
    jcols = [JFunc(f, jcol(c), arg_distinct=d, is_aggregation=True).alias(n)
             for n, (f, c, d) in aggs.items()]
    tres = te.aggregate(tin, None if keys is None else PartitionSpec(by=keys), tcols)
    jres = je.aggregate(je.to_df(jin), None if keys is None else JPartitionSpec(by=keys), jcols)
    return tres, jres, te


def inexact_of(aggs: Dict[str, Tuple[str, str, bool]]) -> Dict[str, float]:
    """Each inexact column's rtol: float sums and every mean 1e-5, the
    variance family 1e-9."""
    out = {}
    for name, (f, c, _) in aggs.items():
        if f == "avg" or (f == "sum" and c.startswith("f")):
            out[name] = 1e-5
        elif f in VARIANCE_FUNCS:
            out[name] = 1e-9
    return out


_PAYLOADS = ("f32", "f64", "i64", "i8", "u8", "b")
_GROUPS = {
    "extrema": ("min", "max", "first", "last"),
    "variance": VARIANCE_FUNCS,
    "median": ("median",),
    "sums": ("sum", "avg", "count"),
}
_KEYS = {"binned": ["k"], "sort": ["g"], "keyless": None}


def _aggs(group: str) -> Dict[str, Tuple[str, str, bool]]:
    return {f"{f}_{c}": (f, c, False) for f in _GROUPS[group] for c in _PAYLOADS}


@pytest.mark.parametrize("layout", ["prefix", "prefix_short", "masked"])
@pytest.mark.parametrize("keys", sorted(_KEYS))
@pytest.mark.parametrize("group", sorted(_GROUPS))
def test_aggregate_matches_jax(group, keys, layout):
    """Every function of the JAX package's ``_DEVICE_AGGS`` over payloads
    of every dtype, by a binned key, a sort-path key and none, in each
    layout."""
    aggs = _aggs(group)
    tres, jres, te = run_both(_frames(_data(), layout), _KEYS[keys], aggs)
    compare(tres, jres, inexact_of(aggs))
    assert te.fallbacks == {}
    route = "global" if keys == "keyless" else "generic"
    if group != "sums" or keys != "binned":
        assert te.strategy_counts[route] == 1


def test_one_row_group_has_no_sample_variance():
    """A group of one row: its population variance is 0, its sample
    variance and standard deviation NULL (pandas' ddof=1 gives NaN)."""
    table = pa.table({"k": pa.array([0, 1, 1], type=pa.int32()),
                      "v": pa.array([5.0, 1.0, 4.0])})
    aggs = {f: (f, "v", False) for f in VARIANCE_FUNCS}
    tres, jres, _ = run_both(table, ["k"], aggs)
    compare(tres, jres, inexact_of(aggs))
    out = tres.as_pandas().set_index("k")
    assert out.loc[0, "var_pop"] == 0.0 and out.loc[0, "stddev_pop"] == 0.0
    assert out.loc[0, ["variance", "var_samp", "stddev", "stddev_samp"]].isna().all()
    assert out.loc[1, "variance"] == 4.5


@pytest.mark.parametrize("keys", sorted(_KEYS))
def test_empty_frame(keys):
    """No rows at all: no group by keys, one row of counts 0 and NULLs
    without them."""
    aggs = {name: spec for group in _GROUPS for name, spec in _aggs(group).items()}
    tres, jres, _ = run_both(_data().slice(0, 0), _KEYS[keys], aggs)
    compare(tres, jres, inexact_of(aggs))
    assert tres.count() == (1 if keys == "keyless" else 0)


def test_mean_of_integers_matches_numpy():
    """The JAX package's generic branch casts the mean of an integer
    column to float32 before the float64 result type (``groupby.py:641``,
    ROADMAP.md queue 3); the port keeps float64, held here against numpy
    at rtol 1e-12 on the sort path, where the JAX package is off by more
    than float64 rounding."""
    rng = np.random.default_rng(3)
    g = rng.choice([0.5, 1.5, 2.5], N).astype(np.float32)
    i = rng.integers(0, 10**6, N)
    table = pa.table({"g": pa.array(g), "i": pa.array(i)})
    tres, jres, _ = run_both(table, ["g"], {"m": ("avg", "i", False)})
    got = tres.as_pandas().sort_values("g")["m"].to_numpy()
    want = np.array([i[g == x].mean() for x in (0.5, 1.5, 2.5)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    jax_m = np.asarray(jres.native.columns["m"].data)[:3]
    assert np.max(np.abs(jax_m - want) / want) > 1e-12


_TWIN_DTYPES = [np.float32, np.float64, np.int64, np.int32, np.int16, np.int8, np.uint8,
                np.bool_]


def _values(rng: np.random.Generator, n: int, dtype: Any) -> np.ndarray:
    if dtype in (np.float32, np.float64):
        return _SPECIAL[rng.integers(0, len(_SPECIAL), n)].astype(dtype)
    if dtype == np.int64:
        return _I64[rng.integers(0, len(_I64), n)]
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    info = np.iinfo(dtype)
    return rng.integers(int(info.min), int(info.max) + 1, n).astype(dtype)


def _segments(rng: np.random.Generator, n: int, num: int) -> np.ndarray:
    """Segment ids with rows outside ``[0, num)`` and segment 3 empty."""
    seg = rng.integers(-1, num + 2, n).astype(np.int32)
    seg[seg == 3] = 4
    return seg


def _np_extremum(v: np.ndarray, dtype: Any, is_max: bool) -> Any:
    """One segment's min or max by the JAX package's rules: NaN wins,
    -0.0 is below +0.0, an empty segment gets the type's fill."""
    if len(v) == 0:
        return extremum_fill(torch.from_numpy(np.zeros(1, dtype)).dtype, is_max)
    if v.dtype.kind == "f":
        if np.isnan(v).any():
            return np.nan
        m = v.max() if is_max else v.min()
        if m == 0:
            zeros = np.signbit(v[v == 0])
            neg = zeros.all() if is_max else zeros.any()
            return -0.0 if neg else 0.0
        return m
    return v.max() if is_max else v.min()


@pytest.mark.parametrize("layout", ["prefix", "masked"])
@pytest.mark.parametrize("dtype", _TWIN_DTYPES, ids=lambda d: np.dtype(d).name)
def test_segment_extrema_reference_matches_numpy(dtype, layout):
    """K4's twin: each segment's min and max (a masked payload and the
    same payload unmasked), and its first and last counted row, against
    numpy; floats compared bit for bit."""
    rng = np.random.default_rng(7)
    n, num = 600, 9
    seg = _segments(rng, n, num)
    values = _values(rng, n, dtype)
    mask = rng.random(n) < 0.8
    if layout == "prefix":
        rows: Dict[str, Any] = {"nrows": n - 50}
        real = np.arange(n) < n - 50
    else:
        real = rng.random(n) < 0.7
        rows = {"row_valid": torch.from_numpy(real)}
    real &= (seg >= 0) & (seg < num)
    t = torch.from_numpy
    got = segment_extrema_reference(
        t(seg), num, [Extremum(t(values), t(mask), True, True),
                      Extremum(t(values), None, False, True)],
        first=True, last=True, **rows)
    assert got.mins[1] is None
    for q, m in ((0, mask), (1, np.ones(n, bool))):
        for is_max in ((False, True) if q == 0 else (True,)):
            res = (got.maxs if is_max else got.mins)[q]
            assert res.dtype == t(values).dtype
            want = np.array([_np_extremum(values[real & m & (seg == s)], dtype, is_max)
                             for s in range(num)]).astype(dtype)
            res = res.numpy()
            if res.dtype.kind == "f":
                np.testing.assert_array_equal(np.isnan(res), np.isnan(want))
                keep = ~np.isnan(want)
                np.testing.assert_array_equal(res[keep].view(np.uint8), want[keep].view(np.uint8))
            else:
                np.testing.assert_array_equal(res, want)
    pos = [np.nonzero(real & (seg == s))[0] for s in range(num)]
    np.testing.assert_array_equal(got.first.numpy(), [p[0] if len(p) else -1 for p in pos])
    np.testing.assert_array_equal(got.last.numpy(), [p[-1] if len(p) else -1 for p in pos])
    assert got.first.dtype == torch.int32 and got.first[3] == -1


@pytest.mark.parametrize("layout", ["prefix", "prefix_short", "masked"])
@pytest.mark.parametrize("keys", [["k"], ["g"]], ids=["binned", "sort"])
def test_first_row_is_the_factorization_first_idx(keys, layout):
    """``first`` is the value at ``Factorized.first_idx``: that row is the
    first row K4's twin finds in each occupied segment."""
    tdf, _ = _frames(_data(), layout)
    blocks = tdf.blocks
    fr = groupby.factorize_keys(blocks, keys)
    ext = segment_extrema_reference(fr.seg, fr.num_segments, [], first=True,
                                    **groupby.frame_rows(blocks))
    occ = torch.ones(fr.num_segments, dtype=torch.bool) if fr.occupied is None else fr.occupied
    assert torch.equal(ext.first[occ], fr.first_idx[occ])
    assert bool((ext.first[~occ] == -1).all())


def test_segment_sq_dev_reference_matches_numpy():
    """K5's twin: per payload (float32 masked, float64) the float64 sum of
    squared deviations from each segment's mean, at rtol 1e-12."""
    rng = np.random.default_rng(9)
    n, num = 800, 7
    seg = _segments(rng, n, num)
    f32 = (rng.standard_normal(n) * 10).astype(np.float32)
    f64 = rng.standard_normal(n) * 1e6
    mask = rng.random(n) < 0.7
    means = rng.standard_normal((2, num)) * 5
    real = (np.arange(n) < n - 30) & (seg >= 0) & (seg < num)
    t = torch.from_numpy
    got = segment_sq_dev_reference(t(seg), num, [(t(f32), t(mask)), (t(f64), None)],
                                   t(means), nrows=n - 30)
    assert got.dtype == torch.float64 and got.shape == (2, num)
    for q, (v, m) in enumerate(((f32, mask), (f64, np.ones(n, bool)))):
        want = [np.sum((v[real & m & (seg == s)].astype(np.float64) - means[q, s]) ** 2)
                for s in range(num)]
        np.testing.assert_allclose(got[q].numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", _TWIN_DTYPES, ids=lambda d: np.dtype(d).name)
def test_segment_median_matches_numpy(dtype):
    """``segment_median`` (one sort of a packed word for values of up to 32
    bits, two stable sorts for int64 and float64) against numpy's median
    of each segment's effective, non-NaN values."""
    rng = np.random.default_rng(13)
    n, num = 700, 6
    seg = rng.integers(0, num + 1, n).astype(np.int32)  # num: rows that are not real
    values = _values(rng, n, dtype)
    eff = rng.random(n) < 0.75
    if values.dtype.kind == "f":
        eff &= ~np.isnan(values)
    counts = np.bincount(seg[eff & (seg < num)], minlength=num + 1)[:num].astype(np.int32)
    t = torch.from_numpy
    got = groupby.segment_median(t(values), t(eff), t(seg), num, t(counts)).numpy()
    for s in range(num):
        v = values[eff & (seg == s)].astype(np.float64)
        assert got[s] == np.median(v), s


@pytest.mark.parametrize("funcs,calls", [
    (("sum", "avg", "count"), 1),
    (("var_pop", "median"), 1),
    (("sum", "stddev"), 2),
])
def test_fused_sums_run_once_unless_float32_sums_meet_variance(monkeypatch, funcs, calls):
    """The fused kernel runs once per plan; the variance's float64 first
    pass takes a launch of its own only beside float32 sums, which keep
    their float32 accumulation."""
    seen = []
    twin = groupby.binned_sums_reference

    def counting(*args, **kwargs):
        seen.append(kwargs.get("f64", False))
        return twin(*args, **kwargs)

    monkeypatch.setattr(groupby, "binned_sums_reference", counting)
    table = pa.table({"g": pa.array(np.float32([0.5, 0.5, 1.5])),
                      "v": pa.array(np.float32([1.0, 2.0, 4.0]))})
    ft.aggregate(table, "g", engine=ft.make_execution_engine(device="cpu"),
                 **{f: _FuncExpr(f, ft.col("v"), is_aggregation=True) for f in funcs})
    assert len(seen) == calls
    assert seen[-1] == any(f in VARIANCE_FUNCS for f in funcs)


@pytest.mark.parametrize("layout", ["prefix", "masked"])
@pytest.mark.parametrize("group", ["extrema", "median", "variance"])
def test_zipf_skewed_key_matches_jax(group, layout):
    """A binned key drawn Zipf(1.1) over 64 values, so that one segment
    holds about a fifth of the rows (the hot segment of K4's and K5's
    Zipf shape): every function of the groups K4, K5 and the median
    compute, over every payload dtype. (The sums of these payloads by
    this key meet a fault of the reference:
    ``test_float32_mean_beside_float64_matches_numpy``.)"""
    rng = np.random.default_rng(17)
    p = 1.0 / np.arange(1, 65) ** 1.1
    key = rng.choice(64, N, p=p / p.sum()).astype(np.int32)
    table = _data()
    table = table.set_column(table.schema.get_field_index("k"), "k", pa.array(key))
    aggs = _aggs(group)
    tres, jres, te = run_both(_frames(table, layout), ["k"], aggs)
    compare(tres, jres, inexact_of(aggs))
    assert te.fallbacks == {}


def _edge_table(kind: str) -> pa.Table:
    """Payloads of one kind of edge: every value NaN (``all_nan``), every
    value null (``all_null``), or one row (``one_row``)."""
    n = 1 if kind == "one_row" else 50
    rng = np.random.default_rng(23)
    f64 = rng.standard_normal(n) * 100
    i64 = rng.integers(-(2**40), 2**40, n)
    mask = np.ones(n, bool) if kind == "all_null" else None
    if kind == "all_nan":
        f64 = np.full(n, np.nan)
    return pa.table({
        "f32": pa.array(f64.astype(np.float32), mask=mask),
        "f64": pa.array(f64, mask=mask),
        "i64": pa.array(i64, mask=mask),
    })


def test_float32_mean_beside_float64_matches_numpy():
    """The generic branch (a bool's SUM sends the plan there) with a
    float64 payload beside a float32 one: the port sums both in float64,
    as both engines' binned branches do, so the float32 mean of a group
    whose float32 sum overflows is still its mean; the JAX package's
    generic branch sums the float32 payload in float32 and gives inf
    (ROADMAP.md queue 3). Held against numpy at rtol 1e-12."""
    v = np.float32([3e38, 3e38, 7.0, 1.5, 0, 0, 0, 0, 1, 2])
    table = pa.table({"k": pa.array(np.int32([0] * 8 + [1] * 2)), "v": pa.array(v),
                      "w": pa.array(v.astype(np.float64)), "b": pa.array(v > 1)})
    aggs = {"m": ("avg", "v", False), "n": ("avg", "w", False), "c": ("sum", "b", False)}
    tres, jres, te = run_both(table, ["k"], aggs)
    assert te.strategy_counts["generic"] == 1
    got = tres.blocks.columns["m"].data.numpy()[:2]
    want = [v[:8].astype(np.float64).mean(), 1.5]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.isinf(np.asarray(jres.native.columns["m"].data)[0])


_EDGES = [("all_nan", "prefix"), ("all_nan", "masked"), ("all_null", "prefix"),
          ("all_null", "masked"), ("one_row", "prefix")]


@pytest.mark.parametrize("kind,layout", _EDGES)
def test_keyless_edges_match_jax(kind, layout):
    """The keyless aggregate (one segment: K4 and K5 fold every row into
    one pending value) over payloads that are all NaN, all null or one
    row: min, max, first, last, count, sum, the variance family and
    median of each, and the mean of the floats (the JAX package rounds an
    integer mean to float32, ROADMAP.md queue 3)."""
    funcs = ("min", "max", "first", "last", "count", "sum", "median", *VARIANCE_FUNCS)
    aggs = {f"{f}_{c}": (f, c, False) for f in funcs for c in ("f32", "f64", "i64")}
    aggs.update({f"avg_{c}": ("avg", c, False) for c in ("f32", "f64")})
    tres, jres, te = run_both(_frames(_edge_table(kind), layout), None, aggs)
    compare(tres, jres, inexact_of(aggs))
    assert te.strategy_counts["global"] == 1
