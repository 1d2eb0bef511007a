"""The fused binned aggregate: its plain twin
(``fugue_tpu_torch/kernels/reference.py::binned_sums_reference``) and the
engine's aggregate, which runs it, against the JAX package on one CPU
device.

Each case holds the twin against the JAX package's ``inline_seg`` +
``segment_sums(strategy="scatter")`` over the same rows, and the port's
``aggregate`` against ``JaxExecutionEngine``'s. Where the JAX package is
wrong (ROADMAP.md queue 3: ``inline_seg`` wraps int8/int16 keys whose span
does not fit the type, ``decode_bin_keys`` wraps int64 keys outside
int32), the segment ids come from numpy and the aggregate is held against
a pandas group-by instead. Inputs come from a seeded numpy generator.

Tolerances: keys, counts and integer sums exactly; float sums at rtol
1e-6 in float64 and 1e-5 in float32, since the two sum the same rows in a
different order (the float values are positive, so no sum cancels)."""

from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu
import fugue_tpu_torch as ft
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.execution import make_execution_engine as make_jax_engine
from fugue_tpu.execution.api import aggregate as jaggregate
from fugue_tpu.jax_backend import groupby as jgroupby
from fugue_tpu_torch.kernels.reference import MAX_KEYS, BinKey, binned_sums_reference
from fugue_tpu_torch.torch_backend import blocks as tblocks
from fugue_tpu_torch.torch_backend import groupby

N = 3000
_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-6}


def _nullable(values: np.ndarray, valid: np.ndarray, dtype: str) -> Any:
    out = pd.array(values, dtype=dtype)
    out[~valid] = pd.NA
    return out


def _frame(case: str) -> pd.DataFrame:
    rng = np.random.default_rng(7)
    k = rng.integers(-20, 45, N).astype(np.int32)
    # positive values: a relative bound on a sum that cancels would say
    # nothing about the summation order
    v = (rng.random(N) + 0.5).astype(np.float32)
    if case == "two_keys_one_nullable":
        # null slots hold 0, so the ingest bounds include 0
        k2 = rng.integers(-5, 4, N)
        return pd.DataFrame({
            "k": (k % 7).astype(np.int32),
            "k2": _nullable(k2, rng.random(N) < 0.8, "Int64"),
            "v": v,
        })
    if case == "int8_and_bool_keys_wide_span":
        return pd.DataFrame({
            "k": rng.integers(-100, 101, N).astype(np.int8),
            "b": rng.random(N) < 0.5,
            "v": v.astype(np.float64),
        })
    if case == "int16_key_wide_span":
        return pd.DataFrame({
            "k": np.concatenate([[-20000, 20000], rng.integers(-20000, 20001, N - 2)]).astype(np.int16),
            "v": v.astype(np.float64),
        })
    if case == "int64_key_near_-2^40":
        return pd.DataFrame({
            "k": rng.integers(-(2**40), -(2**40) + 50, N).astype(np.int64),
            "i": rng.integers(-(2**40), 2**40, N).astype(np.int64),
        })
    if case in ("masked_float_and_int_payloads", "count_star_and_count_col"):
        return pd.DataFrame({
            "k": k,
            "v": _nullable(v.astype(np.float64), rng.random(N) < 0.7, "Float64"),
            "i": _nullable(rng.integers(-(2**40), 2**40, N), rng.random(N) < 0.6, "Int64"),
        })
    if case == "masked_layout_frame":
        return pd.DataFrame({"k": (k % 5).astype(np.int32), "k2": k, "v": v})
    if case == "five_keys":
        # more keys than the kernel reads: the engine passes their segment
        # ids as its one key
        cols = {f"k{j}": rng.integers(-1, 2 + j % 2, N).astype(np.int32) for j in range(5)}
        return pd.DataFrame({**cols, "v": v})
    assert case in ("one_int32_key", "prefix_frame_pad_gt_nrows")
    return pd.DataFrame({"k": k, "v": v})


# (output name, function, column or "*") per case
_AGGS: Dict[str, List[Tuple[str, str, str]]] = {
    "one_int32_key": [("s", "sum", "v"), ("m", "avg", "v"), ("c", "count", "v")],
    "two_keys_one_nullable": [("s", "sum", "v"), ("n", "count", "*")],
    "int8_and_bool_keys_wide_span": [("s", "sum", "v"), ("c", "count", "v")],
    "int16_key_wide_span": [("s", "sum", "v"), ("c", "count", "v")],
    "int64_key_near_-2^40": [("t", "sum", "i"), ("c", "count", "i")],
    "masked_float_and_int_payloads": [
        ("s", "sum", "v"), ("m", "avg", "v"), ("t", "sum", "i"), ("a", "avg", "i"),
    ],
    "count_star_and_count_col": [("n", "count", "*"), ("c", "count", "v"), ("d", "count", "i")],
    "prefix_frame_pad_gt_nrows": [("s", "sum", "v"), ("n", "count", "*")],
    "masked_layout_frame": [("s", "sum", "s1"), ("m", "avg", "s1"), ("n", "count", "*"),
                            ("c", "count", "c1")],
    "five_keys": [("s", "sum", "v"), ("n", "count", "*")],
}
_KEYS = {
    "two_keys_one_nullable": ["k", "k2"],
    "int8_and_bool_keys_wide_span": ["k", "b"],
    "masked_layout_frame": ["k"],
    "five_keys": [f"k{j}" for j in range(5)],
}
# the JAX package's inline_seg wraps these keys; its decode wraps the last
_NUMPY_SEG = ("int8_and_bool_keys_wide_span", "int16_key_wide_span")
_PANDAS_ORACLE = _NUMPY_SEG + ("int64_key_near_-2^40",)
_PREFIX_NROWS = N // 2 + 3


def _agg_exprs(case: str, col: Callable, ff: Any) -> Dict[str, Any]:
    out = {}
    for name, fn, arg in _AGGS[case]:
        target = col("*") if arg == "*" else col(arg)
        out[name] = getattr(ff, fn)(target)
    return out


def _torch_shrink(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Keeps the columns at full length and declares fewer rows: a prefix
    frame whose padding holds real-looking values past ``_nrows``."""
    return {"k": a["k"], "v": a["v"], "_nrows": torch.tensor(_PREFIX_NROWS)}


def _jax_shrink(a: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return {"k": a["k"], "v": a["v"], "_nrows": jnp.int32(_PREFIX_NROWS)}


def _port_input(case: str, engine: Any) -> Any:
    """The port's frame that the case aggregates."""
    pdf = _frame(case)
    if case == "prefix_frame_pad_gt_nrows":
        return ft.transform(pdf, _torch_shrink, schema="k:int,v:float", engine=engine,
                            as_fugue=True)
    if case == "masked_layout_frame":
        return ft.aggregate(pdf, partition_by=["k", "k2"], engine=engine, as_fugue=True,
                            s1=ft.functions.sum(ft.col("v")),
                            c1=ft.functions.count(ft.col("v")))
    return engine.to_df(pdf)


def _jax_input(case: str, engine: Any) -> Any:
    pdf = _frame(case)
    if case == "prefix_frame_pad_gt_nrows":
        return fugue_tpu.transform(pdf, _jax_shrink, schema="k:int,v:float", engine=engine,
                                   as_fugue=True)
    if case == "masked_layout_frame":
        return jaggregate(pdf, partition_by=["k", "k2"], engine=engine, as_fugue=True,
                          s1=jff.sum(jcol("v")), c1=jff.count(jcol("v")))
    return pdf


def _pandas_oracle(case: str, keys: List[str]) -> pd.DataFrame:
    pdf = _frame(case)
    g = pdf.groupby(keys, dropna=False)
    cols = {}
    for name, fn, arg in _AGGS[case]:
        if fn == "sum":
            cols[name] = g[arg].sum(min_count=1)
        else:
            assert fn == "count"
            cols[name] = g.size() if arg == "*" else g[arg].count()
    return pd.DataFrame(cols).reset_index()


def _twin_vs_jax(case: str, tdf: Any, keys: List[str]) -> None:
    """``binned_sums_reference`` over the frame the engine aggregates, with
    the payloads the engine gives it, against the JAX package's segment
    sums over the same rows."""
    blocks = tdf.blocks
    spec = groupby.bin_spec(blocks, keys)
    assert spec is not None
    data = {k: blocks.columns[k].data for k in keys}
    masks = {k: blocks.columns[k].mask for k in keys}
    value_cols = sorted({a for _, _, a in _AGGS[case] if a != "*"})
    floats, ints, counts = [], [], []
    for c in value_cols:
        col = blocks.columns[c]
        (floats if col.data.is_floating_point() else ints).append((col.data, col.mask))
        if col.mask is not None:
            counts.append(col.mask)
    rows: Dict[str, Any] = (
        {"nrows": blocks.nrows} if blocks.row_valid is None else {"row_valid": blocks.row_valid}
    )
    bkeys = groupby.bin_keys(spec, data, masks)
    if len(bkeys) > MAX_KEYS:  # as the engine does: the segment ids are the key
        seg = groupby.inline_seg(spec, data, masks, blocks.validity())
        bkeys = [BinKey(seg, None, 0, spec.total)]
    f, c, i = binned_sums_reference(bkeys, floats=floats, counts=counts, ints=ints, **rows)

    pad_n = blocks.padded_nrows
    valid = (
        blocks.row_valid.numpy() if blocks.row_valid is not None
        else np.arange(pad_n) < blocks.nrows
    )
    if case in _NUMPY_SEG:
        seg = np.zeros(pad_n, dtype=np.int64)
        for k, kmin, span, masked in zip(spec.names, spec.mins, spec.spans, spec.masked):
            code = data[k].numpy().astype(np.int64) - kmin
            if masked:
                code = np.where(masks[k].numpy(), code, span - 1)
            seg = seg * span + code
        jseg = jnp.asarray(np.where(valid, seg, spec.total).astype(np.int32))
    else:
        jseg = jgroupby.inline_seg(
            jgroupby.BinSpec(*spec),
            {k: jnp.asarray(data[k].numpy()) for k in keys},
            {k: jnp.asarray(masks[k].numpy()) for k in keys if masks[k] is not None},
            jnp.asarray(valid),
        )

    def eff(m: Optional[torch.Tensor]) -> np.ndarray:
        return valid if m is None else valid & m.numpy()

    jf, jc, ji = jgroupby.segment_sums(
        [jnp.asarray(np.where(eff(m), v.numpy(), 0)) for v, m in floats],
        [jnp.asarray(valid)] + [jnp.asarray(eff(m)) for m in counts],
        jseg, spec.total, strategy="scatter",
        int_payloads=[jnp.asarray(np.where(eff(m), v.numpy(), 0)) for v, m in ints],
    )
    assert f.shape[0] == len(jf) and c.shape[0] == len(jc) and i.shape[0] == len(ji)
    for got, want in zip(f.numpy(), jf):
        want = np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=_RTOL[got.dtype], atol=1e-12)
    for got, want in zip(list(c.numpy()) + list(i.numpy()), list(jc) + list(ji)):
        np.testing.assert_array_equal(got, np.asarray(want))


def _sorted(table: pa.Table, keys: List[str]) -> pa.Table:
    return table.sort_by([(k, "ascending", "at_end") for k in keys])


def _assert_same(got: pa.Table, want: pa.Table, names: List[str],
                 rtols: Dict[str, float]) -> None:
    assert got.num_rows == want.num_rows
    for name in names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(g.type):
            gv = g.to_numpy(zero_copy_only=False)
            wv = np.asarray(w.to_numpy(zero_copy_only=False), dtype=np.float64)
            assert np.array_equal(np.isnan(gv), np.isnan(wv))
            np.testing.assert_allclose(gv, wv, rtol=rtols[name], atol=1e-12)
        else:
            assert g.to_pylist() == w.to_pylist()  # exact, nulls included


@pytest.mark.parametrize("case", sorted(_AGGS))
def test_binned_aggregate_matches_jax(case):
    keys = _KEYS.get(case, ["k"])
    te = ft.make_execution_engine("torch", device="cpu")
    tdf = _port_input(case, te)
    if case == "prefix_frame_pad_gt_nrows":
        assert tdf.blocks.row_valid is None and tdf.blocks.padded_nrows > tdf.blocks.nrows
    if case == "masked_layout_frame":
        assert tdf.blocks.row_valid is not None
    _twin_vs_jax(case, tdf, keys)

    before = te.strategy_counts.get("reference", 0)
    tagg = ft.aggregate(tdf, partition_by=keys, engine=te, as_fugue=True,
                        **_agg_exprs(case, ft.col, ft.functions))
    assert te.strategy_counts["reference"] == before + 1
    got = _sorted(tagg.as_arrow(), keys)
    names = [n for n, _, _ in _AGGS[case]]
    # a float result (a sum, or an avg dividing one) carries the rounding
    # of its payload's accumulation type
    rtols = {
        n: _RTOL[np.dtype(tdf.blocks.columns[a].data.numpy().dtype)]
        if tdf.blocks.columns[a].data.is_floating_point() else _RTOL[np.dtype(np.float64)]
        for n, _, a in _AGGS[case] if a != "*"
    }
    if case in _PANDAS_ORACLE:
        want = pa.Table.from_pandas(_pandas_oracle(case, keys), preserve_index=False)
        want = _sorted(want, keys)
        _assert_same(got, want, keys + names, rtols)
        return
    je = make_jax_engine("jax", {"fugue.jax.devices": "0"})
    jagg = jaggregate(_jax_input(case, je), partition_by=keys, engine=je, as_fugue=True,
                      **_agg_exprs(case, jcol, jff))
    assert str(tagg.schema) == str(jagg.schema)
    _assert_same(got, _sorted(jagg.as_arrow(), keys), keys + names, rtols)


def _read_row_valid(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    assert "_row_valid" in a
    return {"k": a["k"], "rv": a["_row_valid"]}


@pytest.mark.parametrize("layout", ["prefix", "prefix_pad_gt_nrows", "masked"])
def test_transformer_reading_row_valid_gets_the_mask(layout):
    """``_row_valid`` is built on first access, and it is the frame's row
    membership in each layout."""
    engine = ft.make_execution_engine(device="cpu")
    pdf = _frame("one_int32_key")
    if layout == "prefix":
        src, want = engine.to_df(pdf), np.ones(N, dtype=bool)
    elif layout == "prefix_pad_gt_nrows":
        src = ft.transform(pdf, _torch_shrink, schema="k:int,v:float", engine=engine,
                           as_fugue=True)
        want = np.arange(N) < _PREFIX_NROWS
    else:
        # even keys only: every other bin of the result is empty
        src = ft.aggregate(pdf.assign(k=pdf["k"] * 2), partition_by="k", engine=engine,
                           as_fugue=True, c=ft.functions.count(ft.col("v")))
        want = src.blocks.row_valid.numpy()
        assert 0 < want.sum() < want.shape[0]
    out = ft.transform(src, _read_row_valid, schema="k:int,rv:bool", engine=engine,
                       as_fugue=True)
    np.testing.assert_array_equal(out.blocks.columns["rv"].data.numpy(), want)


def test_headline_udf_builds_no_validity(monkeypatch):
    """The headline path (a UDF that never reads ``_row_valid``, then a
    one-key aggregate) builds no validity mask: the kernel skips padding
    rows itself, as XLA drops the unread mask from the JAX program."""
    calls = []
    real = tblocks.materialize_validity

    def counted(*args: Any) -> torch.Tensor:
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(tblocks, "materialize_validity", counted)
    engine = ft.make_execution_engine(device="cpu")

    def udf(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": a["k"], "v2": a["v"] * 2.0 + 1.0}

    out = ft.transform(_frame("one_int32_key"), udf, schema="k:int,v2:float",
                       engine=engine, as_fugue=True)
    agg = ft.aggregate(out, partition_by="k", engine=engine, as_fugue=True,
                       s=ft.functions.sum(ft.col("v2")), c=ft.functions.count(ft.col("v2")))
    assert agg.as_pandas()["c"].sum() == N
    assert calls == []
