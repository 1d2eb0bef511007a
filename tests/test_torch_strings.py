"""String columns on the port (``TorchExecutionEngine`` on the CPU, where
K6 runs as its twin) against ``JaxExecutionEngine`` pinned to one CPU
device, on the same seeded frames built on that engine's mesh: the map
ABI's passthrough and remap (``_<name>_dict``, mirroring
``tests/fugue_tpu/jax_backend/test_string_abi_placement.py``), the string
predicates of ``tests/fugue_tpu/sql_frontend/test_device_string_predicates.py``
through ``filter``, ``select`` and ``assign``, LIKE, the dictionary
transforms, string group keys and COUNT(DISTINCT) of a string.

Results are compared as arrow tables row for row: the same schema, the
same nulls, decoded strings, keys and counts exactly, float sums and means
within rtol 1e-12 (float64 sums in another order). Also the compiled
programs' LUT instructions (a string predicate stays inside the one K6
launch) and the refusals that name ROADMAP.md queue 1 item 2(b)."""

from typing import Any, Dict

import jax
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu
import fugue_tpu.column.expressions as jx
import fugue_tpu_torch as ft
import fugue_tpu_torch.column.expressions as tx
from fugue_tpu.column import functions as jff
from fugue_tpu.column.sql import SelectColumns as JSelect
from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.kernels import expr_program as ep
from fugue_tpu_torch.torch_backend import expr_eval, strings
from test_torch_join import _jax_df, _jax_engine

FRUITS = ["apple", "apricot", "banana", "fig", "yuzu"]


def fruit_frame(seed: int = 31, n: int = 80) -> pd.DataFrame:
    """``s`` over five fruits with a null every ninth row, ``t`` over three
    (a different dictionary), ``p`` LIKE patterns, ``v`` float64 and ``k``
    int32."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "s": rng.choice(FRUITS, n).astype(object),
        "t": rng.choice(["apple", "kiwi", "fig"], n).astype(object),
        "p": rng.choice(["a%", "%g", "_i_", "%an%", "apple"], n).astype(object),
        "v": np.round(rng.random(n) * 10, 3),
        "k": rng.integers(0, 4, n).astype(np.int32),
    })
    df.loc[::9, "s"] = None
    df.loc[5::11, "p"] = None
    return df


def compare_tables(got: pa.Table, want: pa.Table, inexact: Dict[str, float] = {}) -> None:
    """Row for row: the same schema, per column the same nulls and, where
    valid, the same values (strings decoded; floats bit for bit unless
    ``inexact`` gives the column's rtol)."""
    assert got.schema == want.schema, (got.schema, want.schema)
    assert got.num_rows == want.num_rows
    for name in got.column_names:
        g, w = got.column(name).combine_chunks(), want.column(name).combine_chunks()
        gv = g.is_valid().to_numpy(zero_copy_only=False)
        np.testing.assert_array_equal(gv, w.is_valid().to_numpy(zero_copy_only=False),
                                      err_msg=f"nulls of {name}")
        ga = np.asarray(g.to_pylist(), dtype=object)[gv]
        wa = np.asarray(w.to_pylist(), dtype=object)[gv]
        if name in inexact:
            np.testing.assert_allclose(ga.astype(float), wa.astype(float), rtol=inexact[name],
                                       atol=0, err_msg=name)
        else:
            assert ga.tolist() == wa.tolist(), name


def engines() -> Any:
    return ft.make_execution_engine(device="cpu"), _jax_engine()


def both(build: Any) -> Any:
    """``build(module, functions)`` for the port's and the JAX package's
    expressions."""
    return build(tx, ff), build(jx, jff)


def _like(m: Any, f: Any, *args: Any) -> Any:
    return m._FuncExpr("like", *args)


def _fn(m: Any, name: str, *args: Any) -> Any:
    return m._FuncExpr(name, *args)


PREDICATES = {
    "eq": lambda m, f: m.col("s") == "apple",
    "ne": lambda m, f: m.col("s") != "apple",
    "in": lambda m, f: (m.col("s") == "apple") | (m.col("s") == "fig"),
    "not_in": lambda m, f: ~((m.col("s") == "apple") | (m.col("s") == "fig")),
    "lt": lambda m, f: m.col("s") < "banana",
    "ge": lambda m, f: m.col("s") >= "fig",
    "le_between_entries": lambda m, f: m.col("s") <= "b",
    "gt_absent": lambda m, f: m.col("s") > "durian",
    "absent_matches_nothing": lambda m, f: m.col("s") == "durian",
    "literal_on_the_left": lambda m, f: m.lit("banana") > m.col("s"),
    "column_eq_column": lambda m, f: m.col("s") == m.col("t"),
    "column_lt_column": lambda m, f: m.col("s") < m.col("t"),
    "like_prefix": lambda m, f: f.like(m.col("s"), "ap%"),
    "like_infix": lambda m, f: f.like(m.col("s"), "%an%"),
    "not_like": lambda m, f: f.like(m.col("s"), "_ig", negated=True),
    "like_and_number": lambda m, f: f.like(m.col("s"), "%a%") & (m.col("v") > 3.0),
    "like_by_pattern_column": lambda m, f: _like(m, f, m.col("s"), m.col("p"), False),
    "is_null": lambda m, f: m.col("s").is_null(),
    "length": lambda m, f: _fn(m, "length", m.col("s")) > 4,
    "upper_eq": lambda m, f: _fn(m, "upper", m.col("s")) == "APPLE",
    "nullif_is_null": lambda m, f: _fn(m, "nullif", m.col("s"), "fig").is_null(),
    "concat_like": lambda m, f: f.like(_fn(m, "concat", m.col("s"), "-", m.col("t")),
                                       "%p%-f%"),
    "substring_eq": lambda m, f: _fn(m, "substring", m.col("s"), 2, 3) == "pri",
}


@pytest.mark.parametrize("layout", ["prefix", "filtered"])
@pytest.mark.parametrize("case", sorted(PREDICATES))
def test_filter_matches_jax(case, layout):
    te, je = engines()
    df = fruit_frame()
    tin, jin = te.to_df(df), _jax_df(je, df)
    if layout == "filtered":
        tin, jin = te.filter(tin, tx.col("v") > 2.0), je.filter(jin, jx.col("v") > 2.0)
    tc, jc = both(PREDICATES[case])
    tres, jres = te.filter(tin, tc), je.filter(jin, jc)
    assert tres.blocks._nrows is None  # the count stays lazy
    compare_tables(tres.as_arrow(), jres.as_arrow())
    assert te.fallbacks == {} and je.fallbacks == {}, (te.fallbacks, je.fallbacks)


def _assigned(m: Any, f: Any) -> list:
    s, t = m.col("s"), m.col("t")
    return [
        _fn(m, "upper", s).alias("u"), _fn(m, "lower", _fn(m, "upper", t)).alias("lo"),
        _fn(m, "reverse", s).alias("r"), _fn(m, "substring", s, 2, 3).alias("sub"),
        _fn(m, "substr", s, 3).alias("tail"), _fn(m, "replace", s, "a", "A").alias("rep"),
        _fn(m, "concat", s, "!").alias("bang"), _fn(m, "concat", "<", s, "-", t, ">").alias("st"),
        _fn(m, "length", s).alias("n"), _fn(m, "nullif", s, "fig").alias("nf"),
        _fn(m, "nullif", s, t).alias("nt"), f.like(s, "a%").alias("l"), (s == t).alias("e"),
        s.alias("s2"), f.case_when(s == "apple", m.col("v"), -m.col("v")).alias("w"),
    ]


def test_assign_matches_jax():
    te, je = engines()
    df = fruit_frame()
    tcols, jcols = both(_assigned)
    tres = te.assign(te.to_df(df), tcols)
    jres = je.assign(_jax_df(je, df), jcols)
    compare_tables(tres.as_arrow(), jres.as_arrow())
    assert te.fallbacks == {}
    cols = tres.blocks.columns
    # a bare reference keeps its dictionary and stats; a computed string
    # gets its codes' bounds
    assert cols["s2"].dictionary is cols["s"].dictionary and cols["s2"].stats == cols["s"].stats
    assert cols["u"].stats == (0, len(cols["u"].dictionary) - 1)


def test_projection_matches_jax():
    te, je = engines()
    df = fruit_frame()
    tcols, jcols = both(lambda m, f: [
        m.col("s"), _fn(m, "upper", m.col("t")).alias("ut"), (m.col("s") < m.col("t")).alias("lt"),
        # CASE s WHEN 'apple' THEN 1 WHEN 'fig' THEN 2 ELSE 0 END
        f.case_when(m.col("s") == "apple", 1, m.col("s") == "fig", 2, 0).alias("c")])
    tw, jw = both(lambda m, f: f.like(m.col("t"), "%i%"))
    tres = te.select(te.to_df(df), SelectColumns(*tcols), where=tw)
    jres = je.select(_jax_df(je, df), JSelect(*jcols), where=jw)
    compare_tables(tres.as_arrow(), jres.as_arrow())


def test_transformed_dictionaries_are_made_canonical():
    """TRIM folds ``"a "`` and ``" a"`` into ``"a"``: the result is
    re-coded by a LUT onto the distinct entries, so a group-by on it sees
    one code per string."""
    te, je = engines()
    df = pd.DataFrame({"s": ["a ", "a", " a", "b", None, "b ", "c"], "v": np.arange(7.0)})
    tcols, jcols = both(lambda m, f: [_fn(m, "trim", m.col("s")).alias("u"), m.col("v")])
    tres = te.assign(te.to_df(df), tcols)
    jres = je.assign(_jax_df(je, df), jcols)
    compare_tables(tres.as_arrow(), jres.as_arrow())
    assert list(tres.blocks.columns["u"].dictionary) == ["a", "b", "c"]
    tg = ft.aggregate(tres, "u", engine=te, as_fugue=True, c=ff.count(tx.col("*")),
                      s=ff.sum(tx.col("v")))
    jg = je.aggregate(jres, fugue_tpu.PartitionSpec(by=["u"]),
                      [jff.count(jx.col("*")).alias("c"), jff.sum(jx.col("v")).alias("s")])
    compare_tables(tg.as_arrow(), jg.as_arrow())
    assert sorted(tg.as_pandas()["c"].tolist()) == [1, 1, 2, 3]


_GROUP_SELECTS = {
    "string_key_where_like": (
        lambda m, f: [m.col("s"), f.count(m.col("*")).alias("n"), f.sum(m.col("v")).alias("tv")],
        lambda m, f: f.like(m.col("s"), "%a%"), None),
    "conditional_aggregate": (
        lambda m, f: [m.col("t"), f.sum(f.case_when(m.col("s") == "apple", m.col("v"), 0.0))
                      .alias("av")], None, None),
    "conditional_aggregate_binned_key": (
        lambda m, f: [m.col("s"), f.sum(f.case_when(m.col("t") == "apple", m.col("v"), 0.0))
                      .alias("av")], None, None),
    "computed_string_key": (
        lambda m, f: [_fn(m, "upper", _fn(m, "substring", m.col("s"), 1, 2)).alias("u"),
                      f.count(m.col("*")).alias("c"), f.avg(m.col("v")).alias("m")], None, None),
    "two_keys_having": (
        lambda m, f: [m.col("s"), m.col("k"), f.count(m.col("*")).alias("c"),
                      f.max(m.col("v")).alias("mx")],
        lambda m, f: m.col("t") != "kiwi", lambda m, f: f.count(m.col("*")) > 1),
    "count_of_a_string": (
        lambda m, f: [m.col("k"), f.count(m.col("s")).alias("c"),
                      f.count(_fn(m, "upper", m.col("s"))).alias("cu")], None, None),
}


@pytest.mark.parametrize("case", sorted(_GROUP_SELECTS))
def test_groupby_select_matches_jax(case):
    te, je = engines()
    df = fruit_frame()
    cols, where, having = _GROUP_SELECTS[case]
    tcols, jcols = both(cols)
    tw, jw = both(where) if where else (None, None)
    th, jh = both(having) if having else (None, None)
    tres = te.select(te.to_df(df), SelectColumns(*tcols), where=tw, having=th)
    jres = je.select(_jax_df(je, df), JSelect(*jcols), where=jw, having=jh)
    compare_tables(tres.as_arrow(), jres.as_arrow(), {"tv": 1e-12, "av": 1e-12, "m": 1e-12})
    assert te.fallbacks == {} and je.fallbacks == {}, (te.fallbacks, je.fallbacks)


@pytest.mark.parametrize("keys", [["s"], ["s", "k"], []], ids=["s", "s_k", "none"])
def test_count_distinct_of_a_string_matches_jax(keys):
    te, je = engines()
    df = fruit_frame()
    tres = te.aggregate(te.to_df(df), PartitionSpec(by=keys) if keys else None,
                        [ff.count_distinct(tx.col("t")).alias("d"),
                         ff.count(tx.col("s")).alias("c"), ff.sum(tx.col("v")).alias("sv")])
    jres = je.aggregate(_jax_df(je, df), fugue_tpu.PartitionSpec(by=keys) if keys else None,
                        [jff.count_distinct(jx.col("t")).alias("d"),
                         jff.count(jx.col("s")).alias("c"), jff.sum(jx.col("v")).alias("sv")])
    compare_tables(tres.as_arrow(), jres.as_arrow(), {"sv": 1e-12})


def test_programs_are_not_reused_across_dictionaries():
    """One engine, one expression, two frames whose dictionaries differ:
    each gets its own tables (the JAX package keys its programs by a
    dictionary fingerprint for the same reason)."""
    te = ft.make_execution_engine(device="cpu")
    d1 = pd.DataFrame({"s": ["a", "b", "a"], "v": [1.0, 16.0, 2.0]})
    d2 = pd.DataFrame({"s": ["b", "c", "b"], "v": [15.0, 7.0, 25.0]})
    total = ff.sum(ff.case_when(tx.col("s") == "b", tx.col("v"), 0.0)).alias("t")
    got = [te.select(te.to_df(d), SelectColumns(total)).as_pandas()["t"].tolist()
           for d in (d1, d2)]
    assert got == [[16.0], [40.0]]
    kept = [te.filter(te.to_df(d), tx.col("s") == "b").as_pandas()["v"].tolist()
            for d in (d1, d2)]
    assert kept == [[16.0], [15.0, 25.0]]


# --- the map ABI: string columns through a transformer ---

MAPPING = {"A": "Apple", "B": "Banana", "C": "Carrot"}


def _letters(n: int = 100, nulls: bool = False) -> pd.DataFrame:
    rng = np.random.default_rng(0)
    vals = rng.choice(["A", "B", "C"], n).astype(object)
    if nulls:
        vals[::7] = None
    return pd.DataFrame({"id": np.arange(n), "value": vals})


def torch_map_letter(arrs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    d = arrs["_value_dict"]
    remapped = np.array([MAPPING.get(s, s) for s in d.tolist()], dtype=object)
    return {"id": arrs["id"], "value": arrs["value"], "_value_dict": remapped}


def jax_map_letter(arrs: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    d = arrs["_value_dict"]
    remapped = np.array([MAPPING.get(s, s) for s in d.tolist()], dtype=object)
    return {"id": arrs["id"], "value": arrs["value"], "_value_dict": remapped}


@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
def test_string_remap_transform_matches_jax(nulls):
    """BASELINE config 1 (``bench.py:696-770``): codes passed through, the
    decode table remapped on the host, schema ``"*"``."""
    te, je = engines()
    pdf = _letters(nulls=nulls)
    tout = ft.transform(te.to_df(pdf), torch_map_letter, schema="*", engine=te)
    jout = fugue_tpu.transform(_jax_df(je, pdf), jax_map_letter, schema="*", engine=je,
                               as_fugue=True)
    compare_tables(tout.as_arrow(), jout.as_arrow())
    expect = pdf.assign(value=pdf["value"].map(MAPPING))
    pd.testing.assert_frame_equal(tout.as_pandas(), expect, check_dtype=False)
    # the codes passed through: the transform moved no data on the card
    assert tout.blocks.columns["value"].data is te.to_df(tout).blocks.columns["value"].data
    assert te.fallbacks == {}


def test_string_passthrough_keeps_dictionary():
    te = ft.make_execution_engine(device="cpu")
    tin = te.to_df(_letters())

    def double_id(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"id": a["id"] * 2, "value": a["value"], "code": a["value"]}

    out = ft.transform(tin, double_id, schema="id:long,value:str,code:int", engine=te)
    col = out.blocks.columns
    assert col["value"].dictionary is tin.blocks.columns["value"].dictionary
    assert col["value"].stats == (0, 2)
    # passed-through codes keep a dictionary only on a string field
    assert col["code"].dictionary is None
    pdf = out.as_pandas()
    assert (pdf["value"] == _letters()["value"]).all()
    assert pdf["code"].tolist() == tin.blocks.columns["value"].data.tolist()


def test_distinct_dictionaries_do_not_alias():
    te = ft.make_execution_engine(device="cpu")

    def bang(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        d = a["_value_dict"]
        return {"value": a["value"],
                "_value_dict": np.array([s + "!" for s in d.tolist()], dtype=object)}

    out1 = ft.transform(pd.DataFrame({"value": ["x", "y"] * 16}), bang, "value:str", engine=te)
    out2 = ft.transform(pd.DataFrame({"value": ["p", "q"] * 16}), bang, "value:str", engine=te)
    assert set(out1["value"]) == {"x!", "y!"} and set(out2["value"]) == {"p!", "q!"}


def test_string_output_without_dictionary_is_refused():
    te = ft.make_execution_engine(device="cpu")

    def swap(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"id": a["id"], "value": a["id"] % 3}

    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\(b\)"):
        ft.transform(_letters(), swap, schema="*", engine=te)
    assert te.fallbacks == {"map": 1}


def test_partitioned_transform_on_a_string_key_matches_jax():
    """A string partition key bins by its codes: ``_segment_ids`` over the
    dictionary's codes, as the JAX engine's."""
    te, je = engines()
    df = fruit_frame()

    def tdemean(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        num = a["_num_segments"]
        seg = a["_segment_ids"].long()
        sums = torch.zeros(num + 1, dtype=torch.float64).index_add_(0, seg, a["v"])[:num]
        cnt = torch.zeros(num + 1, dtype=torch.float64).index_add_(
            0, seg, torch.ones_like(a["v"]))[:num]
        mean = (sums / cnt.clamp(min=1)).index_select(0, seg.clamp(max=num - 1))
        return {"s": a["s"], "d": a["v"] - mean}

    def jdemean(a: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        num, seg = a["_num_segments"], a["_segment_ids"]
        sums = jax.ops.segment_sum(a["v"], seg, num_segments=num)
        cnt = jax.ops.segment_sum(jax.numpy.ones_like(a["v"]), seg, num_segments=num)
        mean = (sums / jax.numpy.maximum(cnt, 1))[jax.numpy.clip(seg, 0, num - 1)]
        return {"s": a["s"], "d": a["v"] - mean}

    tout = ft.transform(te.to_df(df), tdemean, "s:str,d:double", engine=te, partition="s")
    jout = fugue_tpu.transform(_jax_df(je, df), jdemean, "s:str,d:double", engine=je,
                               partition={"by": ["s"]}, as_fugue=True)
    compare_tables(tout.as_arrow(), jout.as_arrow(), {"d": 1e-12})


# --- the compiled programs: string predicates inside the one launch ---


def _program(expr: Any, df: pd.DataFrame) -> ep.Program:
    blocks = ft.make_execution_engine(device="cpu").to_df(df).blocks
    return ep.compile_program([expr], [None], expr_eval._columns(blocks), expr_eval._dicts(blocks))


def test_string_predicates_compile_to_lut_instructions():
    df = fruit_frame()
    lut = ep.OP["LUT"]
    cond = (ff.like(tx.col("s"), "a%") & (tx.col("t") != "kiwi")) | (tx.col("v") > 9.0)
    prog = _program(cond, df)
    assert sum(i.op == lut for i in prog.instrs) == 2 and len(prog.tables) == 2
    assert all(t.dtype == torch.bool for t in prog.tables)
    # two columns: two rank tables and an int32 compare
    prog = _program(tx.col("s") < tx.col("t"), df)
    assert [ep.OPS[i.op] for i in prog.instrs] == ["LUT", "LUT", "LT"]
    # a dictionary transform costs no instruction
    prog = _program(tx._FuncExpr("upper", tx.col("s")), df)
    assert prog.instrs == () and set(prog.dicts[0]) == {f.upper() for f in FRUITS}
    prog = _program(tx._FuncExpr("length", tx.col("s")), df)
    assert prog.tables[0].dtype == torch.int64


def test_lut_twin_clamps_its_index():
    """The twin gathers at the index clamped into the table, as the kernel
    does, with the index's validity."""
    table = torch.tensor([10, 20, 30], dtype=torch.int64)
    prog = ep.Program((("c", ep.I32),), (ep.Instr(ep.OP["LUT"], ep.I64, 1, 0, 0),),
                      (ep.Output(1, ep.I64, True),), 2, (False,), (table,), (None,))
    from fugue_tpu_torch.kernels.reference import expr_program_reference

    codes = torch.tensor([-4, 0, 1, 2, 9], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True])
    (v, m), = expr_program_reference(prog, [(codes, mask)], 5)
    assert v.tolist() == [10, 10, 20, 30, 30] and m.tolist() == mask.tolist()


def test_like_regex_is_anchored_and_dotall():
    """The port's copy of ``compile_like_regex``: ``red`` does not match
    ``"red\\n"``; ``%`` and ``_`` match newlines; regex characters are
    literal."""
    from fugue_tpu.column.pandas_eval import compile_like_regex as jcompile
    from fugue_tpu_torch.column.like import compile_like_regex

    values = ["red", "red\n", "red\nx", "r.d", "rad", "10.5%", "10x5", "(a)", "a\\b"]
    for pattern in ("red", "r%", "red_", "r.d", "10.5%", "(a)", "a\\b", "%", "_"):
        got = [compile_like_regex(pattern).fullmatch(v) is not None for v in values]
        assert got == [jcompile(pattern).fullmatch(v) is not None for v in values], pattern


_REFUSED = {
    "min_of_a_string": lambda e, df: e.aggregate(df, PartitionSpec(by=["k"]),
                                                 [ff.min(tx.col("s")).alias("m")]),
    "sum_of_a_string": lambda e, df: e.aggregate(df, None, [ff.sum(tx.col("s")).alias("m")]),
    "string_case_branch": lambda e, df: e.assign(df, [ff.case_when(
        tx.col("v") > 1.0, tx.col("s"), tx.col("t")).alias("x")]),
    "coalesce_of_strings": lambda e, df: e.assign(df, [ff.coalesce(tx.col("s"), tx.col("t"))
                                                       .alias("x")]),
    "cast_of_a_string": lambda e, df: e.assign(df, [tx.col("s").cast(pa.int32()).alias("x")]),
    "string_compared_with_a_number": lambda e, df: e.filter(df, tx.col("s") == 3),
    "string_literal_column": lambda e, df: e.assign(df, [tx.lit("x").alias("x")]),
    "string_as_a_condition": lambda e, df: e.filter(df, tx.col("s")),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_refusals_name_queue_1_item_2b(case):
    te = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\(b\)"):
        _REFUSED[case](te, te.to_df(fruit_frame()))
    assert sum(te.fallbacks.values()) == 1


def test_program_over_the_table_cap_is_refused():
    """Nine LIKE patterns that each match another entry need nine tables
    (equal tables are shared), one more than the interpreter's cap of
    eight (ROADMAP.md queue 2 item 17, now retired): the filter computes
    in one program and equals the JAX engine's."""
    te, je = engines()
    df = pd.DataFrame({"s": [f"a{i}" for i in range(12)] + [None, "b"]})
    tc, jc = both(lambda m, f: f.like(m.col("s"), "a0"))
    for i in range(1, 9):
        tc = tc | ff.like(tx.col("s"), f"a{i}")
        jc = jc | jff.like(jx.col("s"), f"a{i}")
    tres, jres = te.filter(te.to_df(df), tc), je.filter(_jax_df(je, df), jc)
    compare_tables(tres.as_arrow(), jres.as_arrow())
    assert tres.count() == 9 and te.fallbacks == {}
    prog = _program(tc, df)
    assert len(prog.tables) == 9


def test_dynamic_like_over_the_pair_cap_is_refused(monkeypatch):
    monkeypatch.setattr(strings, "MAX_PAIR_LUT", 4)
    te = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\(b\)"):
        te.filter(fruit_frame(), tx._FuncExpr("like", tx.col("s"), tx.col("p"), False))
    assert te.fallbacks == {"filter": 1}


def test_chip_smoke_string_paths_on_cpu():
    """``chip_smoke.py``'s string paths (predicates and group-by, the
    string-keyed join, the date group-by) and its config 1 at small sizes
    on the CPU, each checked inside the phase against pandas/numpy."""
    import chip_smoke

    stats = chip_smoke.string_paths(torch.device("cpu"), 30_000, 1, dims=400)
    assert [s["case"] for s in stats] == ["config1_map", "string_groupby", "string_upper_groupby",
                                          "string_join", "date_groupby"]
