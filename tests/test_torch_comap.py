"""Zip and co-transform on the port (``ft.zip`` + ``ft.transform`` on
``device="cpu"``, K17/K18's twins) against the JAX engine pinned to one
CPU device (``FugueWorkflow`` zip + transform over frames on its mesh, as
``tests/fugue_tpu/jax_backend/test_comap_compiled.py:_run_both`` runs
it), with inputs from numpy seeds: every zip type, three members, a
string key whose dictionaries differ, three members whose rows straddle
the kernels' row tile, per-segment, row-aligned and
explicit-``_nrows`` outputs, an over-reporting ``_nrows``, an empty
intersection and BASELINE config 4 at its small shape (``bench.py:921``,
100 groups of 50). Neither engine may fall back. Keys and counts are
exact, float sums within rtol 1e-9. The refusals (a presort, a
cotransformer that is not ``Dict[str, torch.Tensor]``, the ambiguous
output length, a string output without its dictionary) name ROADMAP.md
queue 1 item 2(b) and count in ``fallbacks["comap"]``."""

from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu.workflow import FugueWorkflow
from test_torch_join import _jax_df, _jax_engine

I32MIN = -(2**31)
RTOL = 1e-9


# ---- the JAX package's cotransformers (test_comap_compiled.py) ----------

def j_seg_sum(d: Dict[str, jax.Array], col: str) -> jax.Array:
    return jax.ops.segment_sum(jnp.where(d["_row_valid"], d[col], 0), d["_segment_ids"],
                               num_segments=d["_num_segments"])


def j_seg_count(d: Dict[str, jax.Array]) -> jax.Array:
    return jax.ops.segment_sum(d["_row_valid"].astype(jnp.int32), d["_segment_ids"],
                               num_segments=d["_num_segments"])


def j_seg_key(d: Dict[str, jax.Array], col: str) -> jax.Array:
    return jax.ops.segment_max(jnp.where(d["_row_valid"], d[col].astype(jnp.int32), I32MIN),
                               d["_segment_ids"], num_segments=d["_num_segments"])


def j_sums(a: Dict[str, jax.Array], b: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return {"k": j_seg_key(a, "k"), "s": j_seg_sum(a, "v") + j_seg_sum(b, "w")}


def j_counts(a: Dict[str, jax.Array], b: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return {"k": jnp.maximum(j_seg_key(a, "k"), j_seg_key(b, "k")), "na": j_seg_count(a),
            "nb": j_seg_count(b)}


def j_rows(a: Dict[str, jax.Array], b: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    s = a["_num_segments"]
    sw = j_seg_sum(b, "w")
    return {"k": a["k"], "d": a["v"] + sw[jnp.clip(a["_segment_ids"], 0, s - 1)]}


def j_exact(a: Dict[str, jax.Array], b: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    k = j_seg_key(a, "k")
    return {"k": k, "s": j_seg_sum(a, "v") + j_seg_sum(b, "w"), "_nrows": jnp.int32(k.shape[0])}


def j_three(a: Dict[str, jax.Array], b: Dict[str, jax.Array],
            c: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return {"k": j_seg_key(a, "k"), "s": j_seg_sum(a, "v") + j_seg_sum(b, "w") * 2
            + j_seg_sum(c, "x") * 3, "n": j_seg_count(c)}


def j_strings(a: Dict[str, jax.Array], b: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return {"s": j_seg_key(a, "s"), "_s_dict": a["_s_dict"],
            "t": j_seg_sum(a, "v") + j_seg_sum(b, "w")}


# ---- the port's: the same over _num_segments + 1 buckets ----------------

def t_seg_sum(d: Dict[str, torch.Tensor], col: str) -> torch.Tensor:
    s = d["_num_segments"]
    out = torch.zeros((s + 1,), dtype=d[col].dtype)
    return out.index_add_(0, d["_segment_ids"].long(),
                          torch.where(d["_row_valid"], d[col], 0))[:s]


def t_seg_count(d: Dict[str, torch.Tensor]) -> torch.Tensor:
    s = d["_num_segments"]
    return torch.bincount(d["_segment_ids"].long(), minlength=s + 1)[:s].to(torch.int32)


def t_seg_key(d: Dict[str, torch.Tensor], col: str) -> torch.Tensor:
    s = d["_num_segments"]
    out = torch.full((s + 1,), I32MIN, dtype=torch.int32)
    vals = torch.where(d["_row_valid"], d[col].to(torch.int32), I32MIN)
    return out.scatter_reduce_(0, d["_segment_ids"].long(), vals, "amax")[:s]


def t_sums(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": t_seg_key(a, "k"), "s": t_seg_sum(a, "v") + t_seg_sum(b, "w")}


def t_counts(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": torch.maximum(t_seg_key(a, "k"), t_seg_key(b, "k")), "na": t_seg_count(a),
            "nb": t_seg_count(b)}


def t_rows(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    s = a["_num_segments"]
    sw = t_seg_sum(b, "w")
    return {"k": a["k"], "d": a["v"] + sw[a["_segment_ids"].long().clamp(0, s - 1)]}


def t_exact(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    k = t_seg_key(a, "k")
    return {"k": k, "s": t_seg_sum(a, "v") + t_seg_sum(b, "w"),
            "_nrows": torch.tensor(k.shape[0], dtype=torch.int32)}


def t_over(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = t_exact(a, b)
    out["_nrows"] = out["_nrows"] + 3
    return out


def j_over(a: Dict[str, jax.Array], b: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    out = j_exact(a, b)
    out["_nrows"] = out["_nrows"] + 3
    return out


def t_three(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
            c: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": t_seg_key(a, "k"), "s": t_seg_sum(a, "v") + t_seg_sum(b, "w") * 2
            + t_seg_sum(c, "x") * 3, "n": t_seg_count(c)}


def t_strings(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    return {"s": t_seg_key(a, "s"), "_s_dict": a["_s_dict"],
            "t": t_seg_sum(a, "v") + t_seg_sum(b, "w")}


# ---- running both --------------------------------------------------------

def run_jax(frames: List[pd.DataFrame], cm: Any, schema: str, how: str,
            keys: Optional[List[str]]) -> pa.Table:
    je = _jax_engine()
    dag = FugueWorkflow()
    zs = [dag.df(_jax_df(je, f)) for f in frames]
    first = zs[0].partition_by(*keys) if keys else zs[0]
    first.zip(*zs[1:], how=how).transform(cm, schema=schema).yield_dataframe_as(
        "out", as_local=True)
    dag.run(je)
    assert je.fallbacks == {}, je.fallbacks
    return dag.yields["out"].result.as_arrow()


def run_port(frames: List[pd.DataFrame], cm: Any, schema: str, how: str,
             keys: Optional[List[str]], te: Any = None) -> pa.Table:
    te = te or ft.make_execution_engine(device="cpu")
    z = ft.zip(*frames, how=how, partition=keys, engine=te)
    out = ft.transform(z, cm, schema, engine=te, as_fugue=True)
    assert te.fallbacks == {}, te.fallbacks
    return out.as_arrow()


def assert_same(got: pa.Table, want: pa.Table, keys: List[str]) -> None:
    """The same schema and rows (sorted by ``keys``): integers and strings
    exactly, floats within ``RTOL``."""
    assert got.schema == want.schema, (got.schema, want.schema)
    g = got.to_pandas().sort_values(keys, kind="stable").reset_index(drop=True)
    w = want.to_pandas().sort_values(keys, kind="stable").reset_index(drop=True)
    assert len(g) == len(w), (len(g), len(w))
    for c in g.columns:
        if g[c].dtype.kind == "f":
            np.testing.assert_allclose(g[c].to_numpy(), w[c].to_numpy(), rtol=RTOL)
        else:
            assert g[c].tolist() == w[c].tolist(), c


def both(frames: List[pd.DataFrame], jcm: Any, tcm: Any, schema: str, how: str = "inner",
         keys: Optional[List[str]] = None, sort: Optional[List[str]] = None) -> pa.Table:
    keys = ["k"] if keys is None and how != "cross" else keys
    got = run_port(frames, tcm, schema, how, keys)
    assert_same(got, run_jax(frames, jcm, schema, how, keys), sort or keys or [])
    return got


def sides(seed: int, na: int = 400, nb: int = 60, ka: int = 50, kb: int = 60
          ) -> List[pd.DataFrame]:
    rng = np.random.default_rng(seed)
    return [pd.DataFrame({"k": rng.integers(0, ka, na).astype(np.int64), "v": rng.random(na)}),
            pd.DataFrame({"k": rng.integers(10, 10 + kb, nb).astype(np.int64),
                          "w": rng.random(nb)})]


@pytest.mark.parametrize("how", ["inner", "left_outer", "right_outer", "full_outer"])
def test_every_zip_type_matches_the_reference(how: str) -> None:
    got = both(sides(1), j_counts, t_counts, "k:long,na:long,nb:long", how=how)
    a, b = sides(1)
    ka, kb = set(a.k), set(b.k)
    want = {"inner": ka & kb, "left_outer": ka, "right_outer": kb, "full_outer": ka | kb}[how]
    assert set(got.column("k").to_pylist()) == want


def test_cross_zip_is_one_group() -> None:
    a, b = sides(2, na=30, nb=7)

    def jc(x: Dict[str, jax.Array], y: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return {"n": jnp.stack([x["_nrows"], y["_nrows"]]).astype(jnp.int64),
                "s": jnp.stack([j_seg_sum(x, "v")[0], j_seg_sum(y, "w")[0]]),
                "_nrows": jnp.int32(2)}

    def tc(x: Dict[str, torch.Tensor], y: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"n": torch.stack([x["_nrows"], y["_nrows"]]).to(torch.int64),
                "s": torch.stack([t_seg_sum(x, "v")[0], t_seg_sum(y, "w")[0]]),
                "_nrows": torch.tensor(2, dtype=torch.int32)}

    got = both([a, b.rename(columns={"k": "kb"})], jc, tc, "n:long,s:double", how="cross",
               sort=["n"])
    assert sorted(got.column("n").to_pylist()) == [7, 30]


def test_per_segment_output_and_config4_small() -> None:
    """BASELINE config 4 at ``_SMALL`` (``bench.py:930-945``): 100 groups
    of 50, seed 3; also against pandas."""
    groups, per = 100, 50
    rng = np.random.default_rng(3)
    a = pd.DataFrame({"k": np.repeat(np.arange(groups, dtype=np.int64), per),
                      "v": rng.random(groups * per)})
    b = pd.DataFrame({"k": np.arange(groups, dtype=np.int64), "w": rng.random(groups)})
    got = both([a, b], j_sums, t_sums, "k:long,s:double").to_pandas().sort_values("k")
    want = a.groupby("k").v.sum() + b.groupby("k").w.sum()
    np.testing.assert_allclose(got.s.to_numpy(), want.to_numpy(), rtol=RTOL)
    assert got.k.tolist() == list(range(groups))


def test_row_aligned_output() -> None:
    rng = np.random.default_rng(8)
    a = pd.DataFrame({"k": rng.integers(0, 8, 100).astype(np.int64), "v": rng.random(100)})
    b = pd.DataFrame({"k": np.arange(1, 8, dtype=np.int64), "w": rng.random(7)})
    got = both([a, b], j_rows, t_rows, "k:long,d:double", sort=["k", "d"])
    assert got.num_rows == int((a.k != 0).sum())  # key 0 has no b rows: inner drops them


def test_explicit_nrows_output() -> None:
    got = both(sides(4), j_exact, t_exact, "k:long,s:double")
    assert got.num_rows > 0


def test_over_reporting_nrows_is_rejected_with_the_references_message() -> None:
    frames = sides(5)
    with pytest.raises(Exception) as want:
        run_jax(frames, j_over, "k:long,s:double", "inner", ["k"])
    with pytest.raises(ValueError) as got:
        run_port(frames, t_over, "k:long,s:double", "inner", ["k"])
    msg = str(got.value)
    assert "reported _nrows=" in msg
    assert msg.replace("torch", "jax") in str(want.value)


def test_empty_intersection_is_empty() -> None:
    a = pd.DataFrame({"k": np.array([1, 2], dtype=np.int64), "v": [1.0, 2.0]})
    b = pd.DataFrame({"k": np.array([3, 4], dtype=np.int64), "w": [1.0, 2.0]})
    assert both([a, b], j_sums, t_sums, "k:long,s:double").num_rows == 0


def test_three_members() -> None:
    rng = np.random.default_rng(6)
    a, b = sides(6, ka=40)
    c = pd.DataFrame({"k": rng.integers(5, 45, 90).astype(np.int64), "x": rng.random(90)})
    got = both([a, b, c], j_three, t_three, "k:long,s:double,n:long")
    assert set(got.column("k").to_pylist()) == set(a.k) & set(b.k) & set(c.k)


def j_three_counts(a: Dict[str, jax.Array], b: Dict[str, jax.Array],
                   c: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    k = jnp.maximum(jnp.maximum(j_seg_key(a, "k"), j_seg_key(b, "k")), j_seg_key(c, "k"))
    return {"k": k, "na": j_seg_count(a), "nb": j_seg_count(b), "nc": j_seg_count(c),
            "s": j_seg_sum(a, "v") + j_seg_sum(b, "w") * 2 + j_seg_sum(c, "x") * 3}


def t_three_counts(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
                   c: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    k = torch.maximum(torch.maximum(t_seg_key(a, "k"), t_seg_key(b, "k")), t_seg_key(c, "k"))
    return {"k": k, "na": t_seg_count(a), "nb": t_seg_count(b), "nc": t_seg_count(c),
            "s": t_seg_sum(a, "v") + t_seg_sum(b, "w") * 2 + t_seg_sum(c, "x") * 3}


def j_three_cross(a: Dict[str, jax.Array], b: Dict[str, jax.Array],
                  c: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return {"n": jnp.stack([a["_nrows"], b["_nrows"], c["_nrows"]]).astype(jnp.int64),
            "s": jnp.stack([j_seg_sum(a, "v")[0], j_seg_sum(b, "w")[0], j_seg_sum(c, "x")[0]]),
            "_nrows": jnp.int32(3)}


def t_three_cross(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
                  c: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"n": torch.stack([a["_nrows"], b["_nrows"], c["_nrows"]]).to(torch.int64),
            "s": torch.stack([t_seg_sum(a, "v")[0], t_seg_sum(b, "w")[0],
                              t_seg_sum(c, "x")[0]]),
            "_nrows": torch.tensor(3, dtype=torch.int32)}


# K17's and K18's row tile (kRowTile in fugue_tpu_torch/kernels/comap.cu)
TILE_ROWS = 1024


@pytest.mark.parametrize("how", ["inner", "left_outer", "right_outer", "full_outer", "cross"])
def test_three_members_straddling_the_row_tile(how: str) -> None:
    """Three members of 1,023, 1 and 1,025 rows, so that the stacked rows'
    member boundaries fall one row before a row tile's edge and one row
    past it, with a member of one row between: every zip type."""
    rng = np.random.default_rng(12)
    na, nc = TILE_ROWS - 1, TILE_ROWS + 1
    a = pd.DataFrame({"k": np.sort(rng.integers(0, 300, na)).astype(np.int64),
                      "v": rng.random(na)})
    b = pd.DataFrame({"k": np.array([int(a.k.iloc[na // 2])], dtype=np.int64), "w": [0.5]})
    c = pd.DataFrame({"k": rng.integers(100, 400, nc).astype(np.int64), "x": rng.random(nc)})
    if how == "cross":
        frames = [a.rename(columns={"k": "ka"}), b.rename(columns={"k": "kb"}),
                  c.rename(columns={"k": "kc"})]
        got = both(frames, j_three_cross, t_three_cross, "n:long,s:double", how=how, sort=["n"])
        assert sorted(got.column("n").to_pylist()) == [1, na, nc]
        return
    got = both([a, b, c], j_three_counts, t_three_counts,
               "k:long,na:long,nb:long,nc:long,s:double", how=how)
    ka, kb, kc = set(a.k), set(b.k), set(c.k)
    want = {"inner": ka & kb & kc, "left_outer": ka, "right_outer": kc,
            "full_outer": ka | kb | kc}[how]
    assert set(got.column("k").to_pylist()) == want


def test_string_key_with_different_dictionaries() -> None:
    rng = np.random.default_rng(9)
    names = np.array([f"n{i:03d}" for i in range(40)], dtype=object)
    a = pd.DataFrame({"s": names[rng.integers(0, 30, 200)], "v": rng.random(200)})
    b = pd.DataFrame({"s": names[rng.integers(10, 40, 50)][::-1], "w": rng.random(50)})
    got = both([a, b], j_strings, t_strings, "s:str,t:double", keys=["s"])
    assert set(got.column("s").to_pylist()) == set(a.s) & set(b.s)


def test_untraceable_cotransformer_runs_whole_column() -> None:
    """``test_untraceable_cotransformer_falls_back_to_host_loop``
    (``test_comap_compiled.py:257``): the JAX package cannot trace
    ``float()`` and answers on its host group loop; torch runs it eagerly
    over every group at once, which over the one key gives the same
    answer."""
    def cm_concrete(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        total = float(torch.where(a["_row_valid"], a["v"], 0.0).sum())
        total += float(torch.where(b["_row_valid"], b["w"], 0.0).sum())
        k = int(torch.where(a["_row_valid"], a["k"], 0).max())
        return {"k": torch.tensor([k]), "s": torch.tensor([total]),
                "_nrows": torch.tensor(1)}

    a = pd.DataFrame({"k": np.array([1, 1], dtype=np.int64), "v": [1.0, 2.0]})
    b = pd.DataFrame({"k": np.array([1], dtype=np.int64), "w": [10.0]})
    got = run_port([a, b], cm_concrete, "k:long,s:double", "inner", ["k"])
    assert got.to_pylist() == [{"k": 1, "s": 13.0}]


def _refused(te: Any, run: Any) -> None:
    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\(b\)"):
        run()
    assert te.fallbacks == {"comap": 1}, te.fallbacks


def test_presort_is_refused() -> None:
    te = ft.make_execution_engine(device="cpu")
    z = ft.zip(*sides(7), partition={"by": ["k"], "presort": "v"}, engine=te)
    _refused(te, lambda: ft.transform(z, t_sums, "k:long,s:double", engine=te))


def test_non_tensor_cotransformer_is_refused() -> None:
    def cm_pandas(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
        return a

    te = ft.make_execution_engine(device="cpu")
    z = ft.zip(*sides(7), partition="k", engine=te)
    _refused(te, lambda: ft.transform(z, cm_pandas, "k:long,s:double", engine=te))


def test_ambiguous_length_is_refused() -> None:
    """Member 0 holds one row a key of the dense range 0..95: its row count
    equals the segment space (``test_comap_compiled.py:205``)."""
    ks = list(range(96))
    ks[0], ks[95] = ks[95], ks[0]
    a = pd.DataFrame({"k": np.array(ks, dtype=np.int64), "v": np.arange(96.0)})
    b = pd.DataFrame({"k": np.arange(95, dtype=np.int64), "w": np.ones(95)})
    te = ft.make_execution_engine(device="cpu")
    z = ft.zip(a, b, partition="k", engine=te)
    _refused(te, lambda: ft.transform(z, t_rows, "k:long,d:double", engine=te))


def test_string_output_without_dictionary_is_refused() -> None:
    def cm(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"s": t_seg_key(a, "k")}

    te = ft.make_execution_engine(device="cpu")
    z = ft.zip(*sides(7), partition="k", engine=te)
    _refused(te, lambda: ft.transform(z, cm, "s:str", engine=te))


def test_zip_errors_match_the_reference() -> None:
    te = ft.make_execution_engine(device="cpu")
    a, b = sides(3)
    with pytest.raises(ValueError, match="cross zip can't have keys"):
        ft.zip(a, b, how="cross", partition="k", engine=te)
    with pytest.raises(ValueError, match="can't zip 0 dataframes"):
        te.zip([])
    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\(b\)"):
        ft.zip(a, b, how="semi", engine=te)
    z = ft.zip({"x": a, "y": b}, engine=te)
    assert z.names == ["x", "y"] and z.keys == ["k"]
    with pytest.raises(NotImplementedError, match="only supports comap"):
        z.count()


def test_on_init_runs_once_with_the_members_empty_frames() -> None:
    """``comap`` takes a workflow's cotransformer runner, as
    ``map_dataframe`` takes a transformer's; a bare function is refused
    (the JAX package sends it to its host group loop)."""
    from fugue_tpu_torch.extensions.builtins import _TransformerRunner
    from fugue_tpu_torch.extensions.convert import _to_transformer

    te = ft.make_execution_engine(device="cpu")
    seen: List[Any] = []
    z = ft.zip({"x": sides(3)[0], "y": sides(3)[1]}, partition="k", engine=te)
    with pytest.raises(NotImplementedError, match=r"'t_sums'.*queue 1 item 2\(b\)"):
        te.comap(z, t_sums, "k:long,s:double")
    assert te.fallbacks == {"comap": 1}
    runner = _TransformerRunner(z, _to_transformer(t_sums, "k:long,s:double"), [])
    te.comap(z, runner.run, "k:long,s:double", on_init=lambda i, dfs: seen.append((i, dfs)))
    assert len(seen) == 1 and seen[0][0] == 0
    assert sorted(seen[0][1]) == ["x", "y"]
    assert [f.count() for f in seen[0][1].values()] == [0, 0]
