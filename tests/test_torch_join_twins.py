"""The twins of the join kernels (``join_build_reference``,
``join_probe_reference``, ``join_expand_reference``) against the JAX
package's own join program (``expand_join``'s count program and the
expansion of ``relational.py:568-577``) on its segment ids, also with a
build key of more than 255 rows and a numpy model of K8 at each place of
its table (with semi, anti and NOT IN against the JAX engine); the ``unique``
flag of ``from_arrow`` against the JAX package's; joins on keys where the
JAX package is wrong (ROADMAP.md queue 3: subnormal float keys merged with
0.0, nullable int64 keys beyond 2^53 ingested through float64) and a
``hypothesis`` property over random frames, both against a numpy
sort-merge (``chip_smoke.numpy_join``); and ``chip_smoke.py``'s join phases
at a small size on the CPU; ``fugue_tpu_torch.join`` over three frames
against the JAX package's ``join``."""

from typing import Any, Dict, Optional

import hypothesis.strategies as st
import jax
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch
from hypothesis import given, settings

import chip_smoke
import fugue_tpu_torch as ft
from fugue_tpu.column import col as jcol
from fugue_tpu.jax_backend import blocks as jblocks
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.kernels.reference import (
    join_build_reference,
    join_expand_reference,
    join_probe_reference,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import blocks as tblocks
from fugue_tpu_torch.torch_backend import relational
from test_torch_join import HOWS, _jax_df, _jax_engine, assert_tables_equal


def _capture_count_program(je: Any) -> Dict[str, Any]:
    """Wraps the JAX engine's ``_jit_cached`` so that the expansion's
    count program (``expand_join``'s ``_count_prog``) records its
    arguments and outputs."""
    seen: Dict[str, Any] = {}
    orig = je._jit_cached

    def spy(key: Any, fn: Any, *a: Any, **kw: Any) -> Any:
        compiled = orig(key, fn, *a, **kw)
        if not (isinstance(key, tuple) and key and key[0] == "join_count"):
            return compiled

        def run(*args: Any) -> Any:
            out = compiled(*args)
            seen.update(key=key, args=args, out=out)
            return out

        return run

    je._jit_cached = spy
    return seen


def _t(x: Any) -> Optional[torch.Tensor]:
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("how", ["inner", "left_outer", "full_outer"])
@pytest.mark.parametrize("filtered", [False, True])
def test_twins_match_the_jax_programs_intermediates(how, filtered):
    """On the JAX program's own segment ids, K7's, K8's and K9's twins
    give its ``m``, ``start``, ``cstart2``, ``total`` and right-unmatched
    rows, the port's ``order2`` its grouped order, and K9's twin the left
    and right row of every output row (``:568-577``), read from row-number
    columns of the JAX engine's output."""
    rng = np.random.default_rng(11)
    k1 = pd.array(rng.integers(0, 9, 70), dtype="Int64")
    k1[rng.random(70) < 0.15] = pd.NA
    k2 = pd.array(rng.integers(2, 12, 50), dtype="Int64")
    k2[rng.random(50) < 0.15] = pd.NA
    left = pd.DataFrame({"k": k1, "v": rng.standard_normal(70), "lrow": np.arange(70)})
    right = pd.DataFrame({"k": k2, "w": rng.integers(0, 99, 50), "rrow": np.arange(50)})
    _check_intermediates(left, right, how, filtered)


def _check_intermediates(left: pd.DataFrame, right: pd.DataFrame, how: str,
                         filtered: bool, probe: Any = join_probe_reference) -> None:
    """The body of the test above for any frames: ``probe`` is K8's
    twin, or a model of K8 with its signature."""
    je = _jax_engine()
    seen = _capture_count_program(je)
    jl, jr = _jax_df(je, left), _jax_df(je, right)
    if filtered:
        jl, jr = je.filter(jl, jcol("v") > -0.5), je.filter(jr, jcol("w") < 70)
    out = je.join(jl, jr, how=how, on=["k"]).as_arrow()
    S = seen["key"][2]
    seg1, seg2, rv1, n1, v2, null1, null2 = (_t(a) for a in seen["args"])
    m, start, order2, cstart2, total, r_total, order_un2 = (_t(a) for a in seen["out"])
    rows1 = {"nrows": int(n1)} if rv1 is None else {"row_valid": rv1}
    counts2 = join_build_reference(seg2, S, row_valid=v2, nulls=null2)
    assert torch.equal(torch.cumsum(counts2, 0) - counts2, cstart2.to(torch.int64))
    match2 = v2 if null2 is None else v2 & ~null2
    order = torch.sort(torch.where(match2, seg2, S), stable=True).indices
    assert torch.equal(order, order2.to(torch.int64))
    pr = probe(seg1, counts2, "expand", nulls=null1, outer=how != "inner", **rows1)
    assert torch.equal(pr.m, m.to(torch.int32))
    assert int(pr.total) == int(total)
    mine_start = torch.cumsum(pr.reps, 0, dtype=torch.int64) - pr.reps
    assert torch.equal(mine_start, start.to(torch.int64))
    li, ri = join_expand_reference(mine_start, pr.m, seg1, cstart2.to(torch.int64), order,
                                   int(pr.total))
    lrow = out.column("lrow").to_numpy(zero_copy_only=False)[: int(pr.total)]
    rrow = out.column("rrow").fill_null(-1).to_numpy(zero_copy_only=False)[: int(pr.total)]
    np.testing.assert_array_equal(li.numpy(), lrow)
    np.testing.assert_array_equal(ri.numpy(), rrow)
    if how == "full_outer":
        counts1 = join_build_reference(seg1, S, nulls=null1, **rows1)
        un = probe(seg2, counts1, "anti", row_valid=v2, nulls=null2)
        assert int(un.total) == int(r_total)
        R = int(r_total)
        assert torch.equal(relational._compact(un.keep, R).to(torch.int64),
                           order_un2[:R].to(torch.int64))


def _wide_key_sides() -> Any:
    """A left side of 90 rows over keys 0-9 with nulls, and a right side
    whose key 5 holds 300 rows (past the 255 of K8's byte entry), the
    others a few each, with nulls; row-number columns on both."""
    rng = np.random.default_rng(31)
    k1 = pd.array(rng.integers(0, 10, 90), dtype="Int64")
    k1[rng.random(90) < 0.1] = pd.NA
    k2 = pd.array(np.concatenate([np.full(300, 5), rng.integers(2, 12, 40)]), dtype="Int64")
    k2[300:][rng.random(40) < 0.2] = pd.NA
    n2 = len(k2)
    left = pd.DataFrame({"k": k1, "v": rng.standard_normal(90), "lrow": np.arange(90)})
    right = pd.DataFrame({"k": k2, "w": rng.integers(0, 99, n2), "rrow": np.arange(n2)})
    return left, right


@pytest.mark.parametrize("copy", ["copy", "none"])
@pytest.mark.parametrize("how", ["inner", "left_outer", "full_outer", "semi", "anti",
                                 "not_in"])
def test_a_build_key_of_more_than_255_rows_matches_jax(how, copy, monkeypatch):
    """A build key of 300 rows, which K8's byte entry escapes to its int32
    count: semi and anti joins and SQL's NOT IN against the JAX engine's
    (arrow tables row for row), and the expansions' intermediates against
    its program's (``_check_intermediates``), with ``probe_model`` (a
    numpy model of K8) as K8, with every table of bytes or slots copied to
    shared memory and with none."""
    from fugue_tpu_torch.kernels import join as kjoin
    from test_torch_join_probe_model import SHARED_LIMITS, place_of, probe_model
    from test_torch_sql_select import assert_sql_equal, run_both

    monkeypatch.setattr(kjoin, "PROBE_SHARED_BYTES", SHARED_LIMITS[copy])
    seen = []

    def probe(seg: Any, table: Any, mode: str, **kw: Any) -> Any:
        rec: Dict[str, Any] = {}
        out = probe_model(seg, table, mode, record=rec, **kw)
        assert rec["place"] == place_of(mode, SHARED_LIMITS[copy])
        seen.append(mode)
        return out

    left, right = _wide_key_sides()
    if how in ("inner", "left_outer", "full_outer"):
        _check_intermediates(left, right, how, False, probe=probe)
        assert "expand" in seen
        return
    # the port's joins with the model as K8 (the CPU's kernel_for picks the twin)
    monkeypatch.setattr(relational, "join_probe_reference", probe)
    if how == "not_in":
        a = left[["k", "lrow"]]
        got, want, _ = run_both("SELECT k, lrow FROM", a, "WHERE k NOT IN (SELECT k FROM",
                                right[["k"]].dropna(), ") ORDER BY lrow")
        assert_sql_equal(got, want)
        assert got.count() == int((~a["k"].isin(right["k"].dropna()) & a["k"].notna()).sum())
    else:
        te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
        got = te.join(te.to_df(left), te.to_df(right[["k", "w"]]), how=how, on=["k"])
        want = je.join(_jax_df(je, left), _jax_df(je, right[["k", "w"]]), how=how, on=["k"])
        assert_tables_equal(got.as_arrow(), want.as_arrow())
    assert set(seen) == {how}


@pytest.mark.parametrize("name,values,nullable", [
    ("monotone", np.arange(-5, 40, 3, dtype=np.int64), False),
    ("not_monotone", np.array([1, 3, 2, 4], dtype=np.int32), False),
    ("repeated", np.array([1, 2, 2, 4], dtype=np.int16), False),
    ("masked", np.arange(10, dtype=np.int64), True),
    ("uint8_extremes", np.array([0, 1, 254, 255], dtype=np.uint8), False),
    ("uint8_wrapping", np.array([255, 0], dtype=np.uint8), False),
    ("int64_extremes", np.array([np.iinfo(np.int64).min, -1, np.iinfo(np.int64).max]), False),
    ("float", np.arange(5, dtype=np.float64), False),
    ("bool", np.array([False, True]), False),
    ("one_row", np.array([7], dtype=np.int32), False),
    ("over_4m_rows", np.arange(4_000_001, dtype=np.int32), False),
])
def test_unique_flag_matches_jax_from_arrow(name, values, nullable):
    arr = pa.array(values, mask=np.arange(len(values)) == 1 if nullable else None)
    table = pa.table({"k": arr})
    port = tblocks.from_arrow(table, Schema(table.schema), torch.device("cpu"))
    ref = jblocks.from_arrow(table, JSchema(table.schema), jblocks.make_mesh([jax.devices()[0]]))
    assert port.columns["k"].unique == ref.columns["k"].unique
    assert port.columns["k"].unique == (name in ("monotone", "uint8_extremes",
                                                  "int64_extremes", "one_row"))


def test_keys_the_reference_gets_wrong_match_numpy():
    """Subnormal float keys (XLA on the CPU merges them with 0.0) and
    nullable int64 keys beyond 2^53 (ingested through float64): the port
    against ``chip_smoke.numpy_join``."""
    sub = np.float64(5e-324)
    big = 2**53 + 1
    for lk, rk in (
        (np.array([sub, 0.0, 2 * sub, 1.0]), np.array([0.0, sub, 1.0])),
        (pd.array([big, big - 1, None, 7], dtype="Int64"), pd.array([big - 1, big, 7],
                                                                    dtype="Int64")),
    ):
        left = pd.DataFrame({"k": lk, "v": np.arange(4.0)})
        right = pd.DataFrame({"k": rk, "w": np.arange(3.0) + 10})
        lv, rv = left["k"].notna().to_numpy(), right["k"].notna().to_numpy()
        # the distinct keys as codes, so numpy_join compares them exactly
        both = pd.concat([left["k"], right["k"]]).dropna().to_numpy()
        codes = {v: i for i, v in enumerate(sorted(set(both.tolist())))}
        k1 = np.array([codes.get(x, 0) if ok else 0 for x, ok in zip(left["k"].tolist(), lv)])
        k2 = np.array([codes.get(x, 0) if ok else 0 for x, ok in zip(right["k"].tolist(), rv)])
        te = ft.make_execution_engine(device="cpu")
        for how in ("inner", "left_outer", "full_outer", "semi", "anti"):
            got = te.join(left, right, how=how, on=["k"]).as_arrow()
            li, ri = chip_smoke.numpy_join(k1, lv, k2, rv, how, len(codes))
            lk_vals = left["k"].to_numpy(dtype=object)
            rk_vals = right["k"].to_numpy(dtype=object)
            want_k = [lk_vals[i] if i >= 0 else rk_vals[r]
                      for i, r in zip(li, ri if ri is not None else [0] * len(li))]
            assert got.column("k").to_pylist() == [None if pd.isna(x) else x for x in want_k]
            assert got.column("v").to_pylist() == [None if i < 0 else float(i) for i in li]
            if ri is not None:
                assert got.column("w").to_pylist() == [None if r < 0 else 10.0 + r for r in ri]


def _numpy_table(left: pd.DataFrame, right: pd.DataFrame, how: str) -> pa.Table:
    """The join of two frames of a nullable int64 ``k`` and a float64
    payload (``v`` left, ``w`` right) by ``chip_smoke.numpy_join``, in the
    port's output layout: the key from the left row, or from the right row
    under right outer and in a full outer join's tail."""
    k1, ok1 = left["k"].to_numpy(np.int64, na_value=0), left["k"].notna().to_numpy()
    k2, ok2 = right["k"].to_numpy(np.int64, na_value=0), right["k"].notna().to_numpy()
    dom = int(max(k1.max(initial=0), k2.max(initial=0))) + 1
    if how == "right_outer":
        ri, li = chip_smoke.numpy_join(k2, ok2, k1, ok1, "left_outer", dom)
    else:
        li, ri = chip_smoke.numpy_join(k1, ok1, k2, ok2, how, dom)

    def pick(values: np.ndarray, valid: np.ndarray, idx: np.ndarray) -> pa.Array:
        hit = idx >= 0
        out, ok = np.zeros(len(idx), values.dtype), np.zeros(len(idx), bool)
        out[hit], ok[hit] = values[idx[hit]], valid[idx[hit]]
        return pa.array(out, mask=~ok)

    cols = {}
    if how == "right_outer":
        cols["k"] = pick(k2, ok2, ri)
    elif how == "full_outer":
        tail = li < 0
        cols["k"] = pick(np.concatenate([k1, k2]), np.concatenate([ok1, ok2]),
                         np.where(tail, ri + len(k1), li))
    else:
        cols["k"] = pick(k1, ok1, li)
    cols["v"] = pick(left["v"].to_numpy(), np.ones(len(k1), bool), li)
    if ri is not None:
        cols["w"] = pick(right["w"].to_numpy(), np.ones(len(k2), bool), ri)
    return pa.table(cols)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(
    how=st.sampled_from(HOWS[:-1]),
    n1=st.integers(0, 12),
    n2=st.integers(0, 12),
    span=st.integers(1, 6),
    nulls=st.booleans(),
    seed=st.integers(0, 2**16),
)
def test_random_joins_match_numpy(how, n1, n2, span, nulls, seed):
    rng = np.random.default_rng(seed)

    def side(n: int, payload: str) -> pd.DataFrame:
        k = pd.array(rng.integers(0, span, n), dtype="Int64")
        if nulls:
            k[rng.random(n) < 0.3] = pd.NA
        return pd.DataFrame({"k": k, payload: rng.standard_normal(n)})

    left, right = side(n1, "v"), side(n2, "w")
    got = ft.make_execution_engine(device="cpu").join(left, right, how=how, on=["k"])
    assert_tables_equal(got.as_arrow(), _numpy_table(left, right, how))


def test_chip_smoke_join_phases_on_cpu():
    """``chip_smoke.py``'s join paths at a small size on the CPU (the card
    runs them at 5M-100M rows), each checked by itself against numpy,
    with no kernel launched (the CPU runs the twins)."""
    cpu = torch.device("cpu")
    for stats in [chip_smoke.join_3b(cpu, 4000, 1),
                  chip_smoke.join_expand(cpu, 4000, 1, row_for_row=True),
                  *chip_smoke.join_kinds(cpu, (4000, 2000), (30, 7), 1)]:
        assert not any(stats["launches"].values()), stats["case"]
    assert stats["case"] == "cross" and stats["output_rows"] == 210


def test_api_join_chains_three_frames():
    rng = np.random.default_rng(8)
    a = pd.DataFrame({"k": rng.integers(0, 6, 30).astype(np.int64), "a": rng.random(30)})
    b = pd.DataFrame({"k": rng.integers(0, 6, 20).astype(np.int64), "b": rng.random(20)})
    c = pd.DataFrame({"k": rng.integers(0, 8, 10).astype(np.int64), "c": rng.random(10)})
    from fugue_tpu.execution.api import join as jjoin

    je = _jax_engine()
    for how in ("inner", "full_outer"):
        got = ft.join(a, b, c, how=how, on=["k"],
                      engine=ft.make_execution_engine(device="cpu"))
        assert isinstance(got, pd.DataFrame)
        want = jjoin(_jax_df(je, a), _jax_df(je, b), _jax_df(je, c), how=how, on=["k"],
                     engine=je, as_fugue=True)
        assert_tables_equal(pa.Table.from_pandas(got, preserve_index=False),
                            want.as_arrow())
    te = ft.make_execution_engine(device="cpu")
    out = ft.join(a, b, c, how="inner", on=["k"], engine=te, as_fugue=True)
    assert isinstance(out, ft.TorchDataFrame)
    assert te.strategy_counts == {"join_expand": 2}
