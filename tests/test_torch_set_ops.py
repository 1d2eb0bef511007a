"""The port's set operations and ``distinct`` (``TorchExecutionEngine``
on the CPU, where K7, K12 and K13 run as their twins) against
``JaxExecutionEngine`` pinned to one CPU device, on the same seeded
frames built on that engine's mesh: ``union``, ``intersect`` and
``subtract``, DISTINCT and ALL, over numeric, bool, string and date
columns with nulls, -0.0 and NaN; filtered (masked, lazy-count) inputs;
an empty side; the cases of ``fugue_tpu_test/execution_suite.py:233-262``;
and the ``ft.*`` entry points.

Results are compared as arrow tables row for row and exactly (every op
here selects rows and computes no value): the same schema, the same
nulls, strings decoded, other values bit for bit. The JAX package's
``as_arrow`` turns a NaN into a null, so the port's NaN is read as null
before the compare (``relational_table``)."""

from typing import Any, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import fugue_tpu_torch as ft
from fugue_tpu.column import col as jcol
from test_torch_join import _jax_df, _jax_engine, assert_tables_equal
from test_torch_strings import compare_tables

NAMES = np.array(["ann", "bob", "cy", "dee", "eve"], dtype=object)


def relational_table(frame: Any) -> pa.Table:
    """A frame's arrow table with every float NaN read as null, as the
    JAX package's ``as_arrow`` gives it."""
    table = frame.as_arrow()
    cols = []
    for c in table.columns:
        c = c.combine_chunks()
        if pa.types.is_floating(c.type):
            c = pc.if_else(pc.is_nan(c), pa.scalar(None, c.type), c)
        cols.append(c)
    return pa.Table.from_arrays(cols, schema=table.schema)


def assert_same_rows(got: Any, want: Any) -> None:
    """The port's frame and the JAX package's, row for row: strings
    decoded and compared as values, every other column bit for bit."""
    g, w = relational_table(got), want.as_arrow()
    compare_tables(g, w)
    plain = [f.name for f in g.schema if not pa.types.is_string(f.type)]
    if plain:
        assert_tables_equal(g.select(plain), w.select(plain))


def mixed_frame(seed: int, n: int) -> pd.DataFrame:
    """Few distinct rows, many repeats: ``k`` int32 with nulls (binned),
    ``f`` float64 over -0.0, 0.0, NaN and two values, ``b`` bool, ``s`` a
    string with nulls, ``d`` a date32."""
    rng = np.random.default_rng(seed)
    k = pd.array(rng.integers(0, 3, n), dtype="Int32")
    k[rng.random(n) < 0.2] = pd.NA
    s = NAMES[rng.integers(0, 3, n)].copy()
    s[rng.random(n) < 0.15] = None
    return pd.DataFrame({
        "k": k,
        "f": rng.choice([-0.0, 0.0, np.nan, 1.5, -2.0], n),
        "b": rng.random(n) < 0.5,
        "s": s,
        "d": (np.datetime64("2021-03-01") + rng.integers(0, 2, n)).astype("datetime64[s]").astype(
            "datetime64[D]"),
    })


def int64_frame(seed: int, n: int) -> pd.DataFrame:
    """An int64 column beyond the bins (the sort path) and an int8."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "x": rng.choice([-(2**40), 7, 2**40, 123456789012], n).astype(np.int64),
        "y": rng.integers(-2, 2, n).astype(np.int8),
    })


FRAMES = {"mixed": mixed_frame, "int64_sort_path": int64_frame}


def _frames(case: str, filtered: bool = False) -> List[Any]:
    """Both engines' frames of both sides (60 and 45 rows) of ``case``;
    ``filtered``: each through a filter first (a masked layout with a
    lazy count)."""
    make = FRAMES[case]
    a, b = make(11, 60), make(12, 45)
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    ta, tb, ja, jb = te.to_df(a), te.to_df(b), _jax_df(je, a), _jax_df(je, b)
    if filtered:
        name = a.columns[0]
        ta, tb = (te.filter(t, ft.col(name).not_null()) for t in (ta, tb))
        ja, jb = (je.filter(j, jcol(name).not_null()) for j in (ja, jb))
        assert not ta.blocks.nrows_known
    return [te, je, ta, tb, ja, jb]


@pytest.mark.parametrize("distinct", [True, False], ids=["distinct", "all"])
@pytest.mark.parametrize("op", ["intersect", "subtract", "union"])
@pytest.mark.parametrize("case", sorted(FRAMES))
def test_set_ops_match_jax(case, op, distinct):
    te, je, ta, tb, ja, jb = _frames(case)
    got = getattr(te, op)(ta, tb, distinct=distinct)
    # the count stays lazy until the compare reads the frame back
    assert got.blocks.nrows_known == (op == "union" and not distinct)
    assert_same_rows(got, getattr(je, op)(ja, jb, distinct=distinct))
    assert te.fallbacks == {}


@pytest.mark.parametrize("distinct", [True, False], ids=["distinct", "all"])
@pytest.mark.parametrize("op", ["intersect", "subtract"])
def test_set_ops_over_filtered_inputs_match_jax(op, distinct):
    te, je, ta, tb, ja, jb = _frames("mixed", filtered=True)
    assert_same_rows(getattr(te, op)(ta, tb, distinct=distinct),
                     getattr(je, op)(ja, jb, distinct=distinct))


@pytest.mark.parametrize("op", ["intersect", "subtract", "union"])
def test_set_ops_with_an_empty_side_match_jax(op):
    a, b = mixed_frame(3, 20), mixed_frame(4, 10).iloc[:0]
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    for x, y in ((a, b), (b, a)):
        got = getattr(te, op)(te.to_df(x), te.to_df(y))
        want = getattr(je, op)(_jax_df(je, x), _jax_df(je, y))
        assert_same_rows(got, want)


@pytest.mark.parametrize("case", sorted(FRAMES) + ["filtered"])
def test_distinct_matches_jax(case):
    te, je, ta, _, ja, _ = _frames("mixed" if case == "filtered" else case,
                                   filtered=case == "filtered")
    got = te.distinct(ta)
    assert not got.blocks.nrows_known
    assert_same_rows(got, je.distinct(ja))


def test_execution_suite_cases():
    """``execution_suite.py``'s union, subtract/intersect and distinct
    cases (``:233-270``) on both engines."""
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    a = pd.DataFrame({"x": [1, 1, 2], "y": ["a", "a", "b"]})
    b = pd.DataFrame({"x": [2, 3], "y": ["b", "c"]})
    ta, tb, ja, jb = te.to_df(a), te.to_df(b), _jax_df(je, a), _jax_df(je, b)
    for op, kw in (("union", {}), ("union", {"distinct": False}), ("subtract", {}),
                   ("intersect", {})):
        assert_same_rows(getattr(te, op)(ta, tb, **kw), getattr(je, op)(ja, jb, **kw))
    assert te.union(ta, tb).as_pandas().values.tolist() == [[1, "a"], [2, "b"], [3, "c"]]
    assert te.subtract(ta, tb).as_pandas().values.tolist() == [[1, "a"]]
    assert te.intersect(ta, tb).as_pandas().values.tolist() == [[2, "b"]]
    c = pd.DataFrame({"x": pd.array([1, 1, None], dtype="Int64"), "y": ["a", "a", None]})
    assert_same_rows(te.distinct(te.to_df(c)), je.distinct(_jax_df(je, c)))


@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_schema_mismatch_raises_as_the_jax_package(op):
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    a, b = pd.DataFrame({"x": [1]}), pd.DataFrame({"z": [1]})
    with pytest.raises(ValueError, match="schema mismatch"):
        getattr(te, op)(a, b)
    with pytest.raises(ValueError, match="schema mismatch"):
        getattr(je, op)(_jax_df(je, a), _jax_df(je, b))


def test_entry_points_fold_their_frames():
    """``ft.union``, ``ft.intersect`` and ``ft.subtract`` take any number
    of frames and return pandas, or the frame when given one."""
    te = ft.make_execution_engine(device="cpu")
    a = pd.DataFrame({"x": [1, 2, 3, 3]})
    b = pd.DataFrame({"x": [3, 4]})
    c = pd.DataFrame({"x": [3, 5]})
    assert ft.union(a, b, c, engine=te)["x"].tolist() == [1, 2, 3, 4, 5]
    assert ft.union(a, b, c, distinct=False, engine=te)["x"].tolist() == [1, 2, 3, 3, 3, 4, 3, 5]
    assert ft.intersect(a, b, c, engine=te)["x"].tolist() == [3]
    assert ft.subtract(a, b, c, engine=te)["x"].tolist() == [1, 2]
    assert ft.intersect(a, b, distinct=False, engine=te)["x"].tolist() == [3]
    assert ft.subtract(a, b, distinct=False, engine=te)["x"].tolist() == [1, 2, 3]
    assert ft.distinct(a, engine=te)["x"].tolist() == [1, 2, 3]
    out = ft.intersect(te.to_df(a), b)
    assert isinstance(out, ft.TorchDataFrame) and out.as_pandas()["x"].tolist() == [3]
