"""``filter``, ``assign`` and ``select`` of the port (``TorchExecutionEngine``
on the CPU, where K6 runs as its twin) against ``JaxExecutionEngine``
pinned to one CPU device (``{"fugue.jax.devices": "0"}``), on the same
seeded frames in the prefix, short-prefix and masked layouts.

Compared on the device columns (the JAX package's ``as_arrow`` turns NaN
into null): the same schema, the same row layout (a filter's
``row_valid``), nulls in the same places and, where valid, the same
values bit for bit, except float sums and means of an aggregate (rtol
1e-5, float32 sums in other orders). Expressions stay where the JAX
package computes in its declared types (``test_torch_expr_program.py``
holds the rest against numpy). Also: a filtered frame's count stays lazy
through ``transform`` and ``aggregate``; each call is one K6 launch (one
program run); refusals raise ``NotImplementedError`` naming their
ROADMAP.md item and count in ``fallbacks``; and the CPU rehearsal of
``chip_smoke.py``'s three K6 paths."""

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import chip_smoke
import fugue_tpu
import fugue_tpu.column.expressions as jx
import fugue_tpu_torch as ft
import fugue_tpu_torch.column.expressions as tx
from fugue_tpu.column import functions as jff
from fugue_tpu.column.sql import SelectColumns as JSelect
from fugue_tpu.execution import make_execution_engine as make_jax_engine
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.torch_backend import expr_eval
from test_torch_segment_aggs import _frames, compare

N = 1500
CPU = torch.device("cpu")


def _data(seed: int = 11, n: int = N) -> pa.Table:
    """An int32 key ``k``, an int64 ``g`` with few values, payloads of
    several dtypes with nulls, NaN, -0.0 and infinities."""
    rng = np.random.default_rng(seed)
    special = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, 7.0, 0.5])

    def nulls(p: float) -> np.ndarray:
        return rng.random(n) < p

    return pa.table({
        "k": pa.array(rng.integers(0, 9, n).astype(np.int32)),
        "g": pa.array(rng.integers(-3, 3, n).astype(np.int64)),
        "f32": pa.array(np.where(rng.random(n) < 0.3, special[rng.integers(0, 8, n)],
                                 rng.standard_normal(n)).astype(np.float32), mask=nulls(0.1)),
        "f64": pa.array(rng.standard_normal(n) * 100, mask=nulls(0.15)),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8), mask=nulls(0.2)),
        "i32": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
        "b": pa.array(rng.random(n) < 0.4, mask=nulls(0.1)),
    })


def _engines() -> Any:
    return ft.make_execution_engine(device="cpu"), make_jax_engine("jax", {"fugue.jax.devices": "0"})


def _both(build: Any) -> Any:
    """``build(module)`` for the port's and the JAX package's expressions."""
    return build(tx, ff), build(jx, jff)


_CONDITIONS = {
    "pipeline": lambda m, f: ((m.col("f32") >= 0.5) & (m.col("i8") != 7)) | m.col("f64").is_null(),
    "not_bool": lambda m, f: ~m.col("b"),
    "kleene": lambda m, f: m.col("b") | (m.col("f64") > 10.0),
    "coalesce": lambda m, f: f.coalesce(m.col("i8"), 0) > 3,
    "numeric": lambda m, f: m.col("f64"),
    "null": lambda m, f: m.lit(None),
    "case_when": lambda m, f: f.case_when(m.col("g") > 0, m.col("b"), m.col("f32") < 0.0),
}


@pytest.mark.parametrize("layout", ["prefix", "prefix_short", "masked"])
@pytest.mark.parametrize("cond", sorted(_CONDITIONS))
def test_filter_matches_jax(cond, layout):
    te, je = _engines()
    tin, jin = _frames(_data(), layout)
    tc, jc = _both(_CONDITIONS[cond])
    tres, jres = te.filter(tin, tc), je.filter(jin, jc)
    assert tres.blocks._nrows is None and tres.blocks.row_valid is not None  # lazy count
    compare(tres, jres, {})
    assert tres.count() == jres.count()
    assert te.fallbacks == {}


def _assign_cols(m: Any, f: Any) -> list:
    return [
        f.case_when(m.col("f64") > 0.0, m.col("f64") * 2.0 - 1.0,
                    f.coalesce(m.col("f64"), 0.0)).alias("w"),
        (m.col("i32") * m.col("g")).alias("ig"),
        (m.col("i8") * m.col("i8")).alias("i8"),  # replaces a column, wraps in int8
        m.col("k").alias("k2"),
        (m.col("b") - m.col("i8")).alias("bm"),
        m.col("f32").cast(pa.int32()).alias("fi"),
        m._FuncExpr("round", m.col("f64") / m.col("f64"), 0).alias("one"),
    ]


@pytest.mark.parametrize("layout", ["prefix", "masked"])
def test_assign_matches_jax(layout):
    te, je = _engines()
    tin, jin = _frames(_data(), layout)
    tcols, jcols = _both(_assign_cols)
    tres, jres = te.assign(tin, tcols), je.assign(jin, jcols)
    compare(tres, jres, {})
    # a bare reference keeps its column's mask and stats
    assert tres.blocks.columns["k2"].stats == tin.blocks.columns["k"].stats
    assert tres.blocks.columns["w"].stats is None


def _projection(m: Any, f: Any) -> list:
    return [m.col("k"), (m.col("f64") + m.col("f32")).alias("s"),
            m.col("i8").alias("j"), (m.col("i32") > m.col("g")).alias("gt")]


@pytest.mark.parametrize("layout", ["prefix", "masked"])
def test_projection_matches_jax(layout):
    te, je = _engines()
    tin, jin = _frames(_data(), layout)
    tcols, jcols = _both(_projection)
    where_t, where_j = _both(lambda m, f: m.col("f32") > 0.0)
    for where in (False, True):
        tres = te.select(tin, SelectColumns(*tcols), where=where_t if where else None)
        jres = je.select(jin, JSelect(*jcols), where=where_j if where else None)
        compare(tres, jres, {})
    wild = te.select(tin, SelectColumns(tx.col("*"), (tx.col("i32") * 2).alias("d")))
    assert wild.schema.names == [*tin.schema.names, "d"]


_GROUP_SELECTS = {
    "plain": (lambda m, f: [m.col("k"), f.sum(m.col("f64")).alias("s"),
                            f.count(m.col("*")).alias("c")], None, None),
    "computed_key": (lambda m, f: [(m.col("g") * 2).alias("g2"),
                                   f.max(m.col("i8") + m.col("i32")).alias("mx"),
                                   f.min(m.col("f64")).alias("mn")], None, None),
    "where_having": (
        lambda m, f: [m.col("k"), f.sum(m.col("f32") * 2).alias("s"),
                      f.count(m.col("*")).alias("c")],
        lambda m, f: m.col("f32") < 0.9,
        lambda m, f: (f.count(m.col("*")) > 100) & (f.max(m.col("i32")) > 990)),
    "keyless_having": (lambda m, f: [f.sum(m.col("i32") - m.col("g")).alias("t")], None,
                       lambda m, f: f.sum(m.col("i32") - m.col("g")) > 0),
}


@pytest.mark.parametrize("layout", ["prefix", "masked"])
@pytest.mark.parametrize("case", sorted(_GROUP_SELECTS))
def test_groupby_select_matches_jax(case, layout):
    te, je = _engines()
    tin, jin = _frames(_data(), layout)
    cols, where, having = _GROUP_SELECTS[case]
    tcols, jcols = _both(cols)
    tw, jw = _both(where) if where else (None, None)
    th, jh = _both(having) if having else (None, None)
    tres = te.select(tin, SelectColumns(*tcols), where=tw, having=th)
    jres = je.select(jin, JSelect(*jcols), where=jw, having=jh)
    compare(tres, jres, {"s": 1e-5})
    assert te.fallbacks == {}


def test_filtered_frame_feeds_transform_and_aggregate():
    """filter -> transform -> aggregate equals the JAX engine's, and the
    filter's count is never read: still lazy after the transform."""
    te, je = _engines()
    tin, jin = _frames(_data(), "prefix")
    tc, jc = _both(_CONDITIONS["pipeline"])
    tkept = te.filter(tin, tc)

    def tudf(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": a["k"], "v2": a["i32"] * 2 + 1}

    def judf(a: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return {"k": a["k"], "v2": a["i32"] * jnp.int32(2) + jnp.int32(1)}

    tout = ft.transform(tkept, tudf, "k:int,v2:int", engine=te)
    assert tkept.blocks._nrows is None and tout.blocks._nrows is None
    jout = fugue_tpu.transform(je.filter(jin, jc), judf, "k:int,v2:int", engine=je,
                               as_fugue=True)
    tres = ft.aggregate(tout, "k", engine=te, as_fugue=True, s=ff.sum(tx.col("v2")),
                        c=ff.count(tx.col("*")))
    jres = je.aggregate(jout, fugue_tpu.PartitionSpec(by=["k"]),
                        [jff.sum(jx.col("v2")).alias("s"), jff.count(jx.col("*")).alias("c")])
    compare(tres, jres, {})
    assert tkept.blocks._nrows is None
    assert tkept.count() == je.filter(jin, jc).count()


def test_bool_minus_int_matches_jax():
    """ROADMAP.md queue 3's example: SUM by k of b - i, b = [T, F, T], an
    int8 i = [1, 2, 3], k = [0, 0, 1], is [-2, -2]."""
    table = pa.table({"b": pa.array([True, False, True]), "i": pa.array([1, 2, 3], pa.int8()),
                      "k": pa.array([0, 0, 1], pa.int32())})
    te, je = _engines()
    got = ft.aggregate(table, "k", engine=te, s=ff.sum(tx.col("b") - tx.col("i")))
    want = je.aggregate(je.to_df(table.to_pandas()), fugue_tpu.PartitionSpec(by=["k"]),
                        [jff.sum(jx.col("b") - jx.col("i")).alias("s")]).as_pandas()
    assert got.sort_values("k")["s"].tolist() == [-2, -2] == want.sort_values("k")["s"].tolist()


def test_each_call_runs_one_program(monkeypatch):
    """One K6 program (one launch on the card) per filter, assign,
    projection and aggregate argument list with expressions; none for
    bare columns."""
    calls = []
    real = expr_eval.run_program

    def counting(program: Any, blocks: Any, **kw: Any) -> Any:
        calls.append(kw.get("filter", False))
        return real(program, blocks, **kw)

    monkeypatch.setattr(expr_eval, "run_program", counting)
    te = ft.make_execution_engine(device="cpu")
    tin = te.to_df(_data())
    kept = te.filter(tin, tx.col("f32") > 0.0)
    te.assign(kept, [(tx.col("i32") * 2).alias("a"), tx.col("f64").alias("b2"),
                     (tx.col("g") + 1).alias("c")])
    te.select(kept, SelectColumns(tx.col("k"), (tx.col("f64") - 1.0).alias("d")))
    te.aggregate(kept, ft.collections.partition.PartitionSpec(by=["k"]),
                 [ff.sum(tx.col("f64") * 2.0).alias("s"), ff.avg(tx.col("i32") + 1).alias("m"),
                  ff.count(tx.col("f32")).alias("c")])
    te.aggregate(kept, None, [ff.sum(tx.col("f64")).alias("s")])
    assert calls == [True, False, False, False]


def test_program_cache_reuses_compiled_programs():
    te = ft.make_execution_engine(device="cpu")
    tin = te.to_df(_data())
    for _ in range(3):
        te.filter(tin, tx.col("f32") > 0.0)
        te.assign(tin, [(tx.col("i32") * 2).alias("a")])
    assert len(te._programs) == 2


_REFUSED = {
    "select_distinct": (lambda e, df: e.select(df, SelectColumns(tx.col("k"), arg_distinct=True)),
                        "select", "queue 1 item 2(b)"),
    # an int column beside a string literal, a string function of an int
    # column: the JAX package answers both on its host engine
    "string_literal": (lambda e, df: e.filter(df, tx.col("k") == "a"), "filter",
                       "queue 1 item 2(b)"),
    "string_function": (lambda e, df: e.assign(df, [tx.function("upper", tx.col("k")).alias("u")]),
                        "assign", "queue 1 item 2(b)"),
    "unknown_function": (lambda e, df: e.filter(df, tx.function("atan", tx.col("f64")) > 0),
                         "filter", "queue 1 item 2(b)"),
    "having_without_aggregation": (
        lambda e, df: e.select(df, SelectColumns(tx.col("k")), having=tx.col("k") > 0),
        "select", "queue 1 item 2(b)"),
    "aggregation_expression": (
        lambda e, df: e.select(df, SelectColumns(tx.col("k"), (ff.sum(tx.col("f64")) * 2)
                                                 .alias("s"))), "select", "queue 1 item 2(b)"),
    "bool_minus_bool": (lambda e, df: e.assign(df, [(tx.col("b") - tx.col("b")).alias("x")]),
                        "assign", "queue 1 item 2(b)"),
    "shadowing_computed_key": (
        lambda e, df: e.select(df, SelectColumns((tx.col("k") * 2).alias("k"),
                                                 ff.sum(tx.col("f64")).alias("s"))),
        "select", "queue 1 item 2(b)"),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_refusals_name_their_roadmap_item_and_count(case):
    run, op, item = _REFUSED[case]
    te = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError,
                       match=item.replace("(", r"\(").replace(")", r"\)")):
        run(te, te.to_df(_data()))
    assert te.fallbacks == {op: 1}


def test_api_entry_points_return_pandas():
    pdf = _data().to_pandas()
    kept = ft.filter(pdf, tx.col("i32") > 0, engine=ft.make_execution_engine(device="cpu"))
    assert isinstance(kept, pd.DataFrame) and (kept["i32"] > 0).all()
    out = ft.assign(pdf, engine=ft.make_execution_engine(device="cpu"), t=tx.col("i32") * 2,
                    one=1)
    assert out["t"].tolist() == (pdf["i32"] * 2).tolist() and set(out["one"]) == {1}
    sel = ft.select(pdf, "k", ff.count(tx.col("*")).alias("c"), where=tx.col("i32") > 0,
                    engine=ft.make_execution_engine(device="cpu"))
    want = pdf[pdf["i32"] > 0].groupby("k").size()
    assert sel.sort_values("k")["c"].tolist() == want.tolist()


def test_chip_smoke_k6_paths_on_cpu():
    """``chip_smoke.py``'s filtered pipeline, WHERE/HAVING select and
    config-3 select at 20k rows on the CPU (the card runs them at 100M and
    10M), each checked against numpy inside the phase."""
    stats = chip_smoke.filtered_paths(CPU, 20_000, 64, 42, 1)
    stats.append(chip_smoke.config3_select(CPU, 20_000, 1))
    assert [s["case"] for s in stats] == ["filtered_pipeline", "where_having", "config3_select"]
    assert stats[0]["count_lazy_after_run"] and stats[0]["kept_rows"] > 0
    assert 0 < stats[1]["having_survivors"] < stats[1]["groups_before_having"]
