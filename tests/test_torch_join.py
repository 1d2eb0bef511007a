"""The port's joins (``TorchExecutionEngine.join``) against
``JaxExecutionEngine.join`` pinned to one CPU device, on the same frames
made from seeded numpy: every join type over int64, int32 (binned), bool,
nullable and two-column (int32 and float64: the sort path) keys, with
many-to-many duplicates; the readbacks of each route and the refusals.
``tests/test_torch_join_layouts.py`` runs the same comparison over
all-null keys, empty sides and filtered (masked) inputs, and
``tests/test_torch_join_twins.py`` holds the kernels' twins; both import
this file's helpers.

The outputs are compared as arrow tables row for row: schemas equal,
nulls equal, values exact (floats bit for bit). The JAX package's
``as_arrow`` turns a NaN into a null, so no frame here holds one."""

from typing import Any, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import fugue_tpu_torch as ft
from fugue_tpu.column import col as jcol
from fugue_tpu.execution import make_execution_engine as make_jax_engine
from fugue_tpu.jax_backend.dataframe import JaxDataFrame
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.torch_backend import relational

HOWS = ["inner", "left_outer", "right_outer", "full_outer", "semi", "anti", "cross"]


def _frame(rng: np.random.Generator, n: int, case: str, payload: str) -> pd.DataFrame:
    """One side of a case: keys and a payload column named ``payload``."""
    if case == "int64":
        cols = {"k": rng.integers(-3, 12, n).astype(np.int64)}
    elif case == "int32_binned":
        cols = {"k": rng.integers(0, 9, n).astype(np.int32)}
    elif case == "two_keys_float":
        cols = {"k": rng.integers(0, 3, n).astype(np.int32),
                "f": rng.choice([-1.5, -0.0, 0.0, 2.25, 7.0], n)}
    elif case == "bool_key":
        cols = {"k": rng.random(n) < 0.4}
    elif case == "nullable":
        k = pd.array(rng.integers(0, 8, n), dtype="Int64")
        k[rng.random(n) < 0.25] = pd.NA
        cols = {"k": k}
    elif case == "all_null":
        cols = {"k": pd.array([pd.NA] * n, dtype="Int32")}
    else:
        raise ValueError(case)
    cols[payload] = rng.integers(-100, 100, n).astype(np.int32) if payload == "w" else \
        rng.standard_normal(n)
    return pd.DataFrame(cols)


KEY_CASES = ["int64", "int32_binned", "two_keys_float", "bool_key", "nullable"]
LAYOUT_CASES = ["all_null", "empty_left", "empty_right", "both_empty", "filtered"]


def _case(case: str) -> Tuple[pd.DataFrame, pd.DataFrame, List[str]]:
    """``(left, right, keys)`` of a case: 60 left rows and 40 right rows
    over few keys (many-to-many), or an empty side."""
    rng = np.random.default_rng(sum(map(ord, case)))
    base = {"empty_left": "int64", "empty_right": "int64", "both_empty": "int64",
            "filtered": "nullable"}.get(case, case)
    left, right = _frame(rng, 60, base, "v"), _frame(rng, 40, base, "w")
    if case in ("empty_left", "both_empty"):
        left = left.iloc[:0]
    if case in ("empty_right", "both_empty"):
        right = right.iloc[:0]
    return left, right, ["k", "f"] if base == "two_keys_float" else ["k"]


def _jax_engine() -> Any:
    return make_jax_engine("jax", {"fugue.jax.devices": "0"})


def _jax_df(je: Any, df: pd.DataFrame) -> Any:
    """``df`` as a frame on the JAX engine's one-device mesh (its
    ``to_df`` of pandas takes every device, whose join paths raise on this
    JAX version: ROADMAP.md queue 3)."""
    table = pa.Table.from_pandas(df, preserve_index=False)
    return JaxDataFrame.from_table(table, je._mesh, JSchema(table.schema))


def _sides(te: Any, je: Any, left: Any, right: Any, filtered: bool) -> Tuple[Any, ...]:
    """Both engines' frames of both sides; ``filtered``: each side through
    a filter first (masked layout, lazy count)."""
    tl, tr, jl, jr = te.to_df(left), te.to_df(right), _jax_df(je, left), _jax_df(je, right)
    if filtered:
        tl, jl = te.filter(tl, ft.col("v") > -0.5), je.filter(jl, jcol("v") > -0.5)
        w = "w" if "w" in right.columns else "r_w"  # a cross join's right side is renamed
        tr, jr = te.filter(tr, ft.col(w) < 50), je.filter(jr, jcol(w) < 50)
        assert not tl.blocks.nrows_known and not tr.blocks.nrows_known
    return tl, tr, jl, jr


def assert_tables_equal(got: pa.Table, want: pa.Table) -> None:
    """Row for row: the same schema, per column the same nulls and, where
    valid, the same values (floats bit for bit)."""
    assert got.schema == want.schema, (got.schema, want.schema)
    assert got.num_rows == want.num_rows
    for name in got.column_names:
        g, w = got.column(name).combine_chunks(), want.column(name).combine_chunks()
        gv = g.is_valid().to_numpy(zero_copy_only=False)
        np.testing.assert_array_equal(gv, w.is_valid().to_numpy(zero_copy_only=False),
                                      err_msg=f"nulls of {name}")
        ga = g.fill_null(False if pa.types.is_boolean(g.type) else 0).to_numpy(
            zero_copy_only=False)[gv]
        wa = w.fill_null(False if pa.types.is_boolean(w.type) else 0).to_numpy(
            zero_copy_only=False)[gv]
        np.testing.assert_array_equal(ga.view(np.uint8), wa.view(np.uint8),
                                      err_msg=f"values of {name}")


def _run(how: str, left: Any, right: Any, keys: Optional[List[str]],
         filtered: bool = False) -> Tuple[Any, Any, Any]:
    """The join on the port (CPU) and on the JAX engine; returns the
    port's result, the JAX engine's and the port's engine."""
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    tl, tr, jl, jr = _sides(te, je, left, right, filtered)
    return te.join(tl, tr, how=how, on=keys), je.join(jl, jr, how=how, on=keys), te


def check_join_matches_jax(case: str, how: str) -> None:
    """One case of ``_case`` joined by ``how`` on both engines: the same
    arrow table and schema, the route counted, no refusal."""
    left, right, keys = _case(case)
    if how == "cross":  # a cross join's frames share no column
        right = right.rename(columns={c: f"r_{c}" for c in right.columns})
        keys = None
    tres, jres, te = _run(how, left, right, keys, filtered=case == "filtered")
    assert_tables_equal(tres.as_arrow(), jres.as_arrow())
    assert str(tres.schema) == str(jres.schema)
    route = {"semi": "join_mask", "anti": "join_mask"}.get(how, "join_expand")
    assert te.strategy_counts == {route: 1}
    assert te.fallbacks == {}


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", KEY_CASES)
def test_join_matches_jax(case, how):
    check_join_matches_jax(case, how)


def test_readbacks_by_route():
    """Semi, anti and the unique right route read nothing back; the
    expansion route reads its output size once, full outer included."""
    rng = np.random.default_rng(3)
    left = pd.DataFrame({"k": rng.integers(0, 30, 200).astype(np.int64), "v": rng.random(200)})
    mono = pd.DataFrame({"k": np.arange(0, 40, dtype=np.int64), "w": rng.random(40)})
    dup = pd.DataFrame({"k": rng.integers(0, 40, 80).astype(np.int64), "w": rng.random(80)})
    te = ft.make_execution_engine(device="cpu")
    for right, how, readbacks, lazy in (
        (dup, "semi", 0, True), (dup, "anti", 0, True), (mono, "inner", 0, True),
        (mono, "left_outer", 0, True), (dup, "inner", 1, False), (dup, "full_outer", 1, False),
        (dup, "right_outer", 1, False), (mono, "full_outer", 1, False),
    ):
        before = relational.readbacks
        res = te.join(left, right, how=how, on=["k"])
        assert relational.readbacks - before == readbacks, how
        assert res.blocks.nrows_known != lazy, how


def test_unique_route_keeps_the_left_columns():
    rng = np.random.default_rng(4)
    left = pd.DataFrame({"k": rng.integers(0, 9, 50).astype(np.int32), "v": rng.random(50)})
    dims = pd.DataFrame({"k": np.arange(6, dtype=np.int32), "w": rng.random(6)})
    te = ft.make_execution_engine(device="cpu")
    tl = te.to_df(left)
    res = te.join(tl, dims, how="inner", on=["k"])
    for name in ("k", "v"):
        assert res.blocks.columns[name] is tl.blocks.columns[name]
    assert res.blocks.columns["k"].stats == (0, 8)


def test_refused_joins_count_as_fallbacks():
    te = ft.make_execution_engine(device="cpu")
    # a float16 column, refused here before it was ported, now joins; a
    # frame that holds a host column (binary) goes to the JAX package's
    # host engine, so the port refuses it
    halves = pd.DataFrame({"k": [1, 2], "h": np.array([0.5, 1.5], dtype=np.float16)})
    res = te.join(halves, pd.DataFrame({"k": [1]}), how="inner", on=["k"])
    assert res.as_pandas().to_dict("list") == {"k": [1], "h": [0.5]}
    blobs = pd.DataFrame({"k": [1, 2], "b": [b"x", b"yz"]})
    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\(b\)"):
        te.join(blobs, pd.DataFrame({"k": [1]}), how="inner", on=["k"])
    assert te.fallbacks == {"join": 1}
    # a string column, refused here before strings were ported, now joins
    strings = pd.DataFrame({"k": [1, 2], "s": ["a", "b"]})
    res = te.join(strings, pd.DataFrame({"k": [1]}), how="inner", on=["k"])
    assert res.as_pandas().to_dict("list") == {"k": [1], "s": ["a"]}
    assert te.fallbacks == {"join": 1}
    with pytest.raises(ValueError, match="invalid join type"):
        te.join(pd.DataFrame({"k": [1]}), pd.DataFrame({"k": [1]}), how="sideways")
