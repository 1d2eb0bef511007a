"""The port's workflow DAG (``fugue_tpu_torch/workflow/``) against the JAX
package's (``fugue_tpu/workflow/``): the same DAG built in each package
over the same inputs (numpy seeds), the port on ``device="cpu"`` (the
kernels' twins) and the JAX engine pinned to one CPU device with its
frames on its mesh (``test_torch_join._jax_df``); the port's transformers
are annotated ``Dict[str, torch.Tensor]``, the JAX package's
``Dict[str, jax.Array]``. Keys and counts are exact; float sums within
rtol 1e-9 (float64) or 1e-5 (float32). Neither engine may fall back.

Also: checkpoints (weak, strong, deterministic on ``tmp_path``, the
second run skipping the task), yields, engine inference, concurrency,
``module``, task-id determinism, a frame's task identity (the reference
gives two frames of one schema one id, ROADMAP.md queue 3), the reference's
``out_transform`` of a device function (it raises, queue 3), and each
left-out part of the DAG refused, naming its ROADMAP.md item and counted
in ``fallbacks``."""

from typing import Any, Callable, Dict, List

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
from fugue_tpu.workflow import FugueWorkflow as JFugueWorkflow
from fugue_tpu.workflow import module as jmodule
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.workflow import FugueWorkflow, module
from test_torch_join import _jax_df, _jax_engine

T = Dict[str, torch.Tensor]
J = Dict[str, jax.Array]


# ---- transformers, each in both packages ----------------------------------

def t_v2(d: T) -> T:
    return {"k": d["k"], "v2": d["v"] * 2.0 + 1.0}


def j_v2(d: J) -> J:
    return {"k": d["k"], "v2": d["v"] * 2.0 + 1.0}


def t_center(d: T) -> T:
    """``center_within_group`` (``tests/fugue_tpu/jax_backend/
    test_transformer_abi.py:19``) in torch: sums over ``_num_segments +
    1`` buckets, the last (the sentinel id) cut off."""
    seg, num, valid = d["_segment_ids"].long(), d["_num_segments"], d["_row_valid"]
    v2 = torch.where(valid, d["v"] * 2.0 + 1.0, 0.0)
    zeros = torch.zeros(num + 1, dtype=v2.dtype)
    total = zeros.clone().index_add_(0, seg, v2)[:num]
    count = zeros.index_add_(0, seg, valid.to(v2.dtype))[:num]
    mean = total / torch.clamp(count, min=1.0)
    return {"k": d["k"], "c": v2 - mean[torch.clamp(seg, 0, num - 1)]}


def j_center(d: J) -> J:
    seg, num, valid = d["_segment_ids"], d["_num_segments"], d["_row_valid"]
    v2 = jnp.where(valid, d["v"] * 2.0 + 1.0, 0.0)
    total = jax.ops.segment_sum(v2, seg, num_segments=num)
    count = jax.ops.segment_sum(jnp.where(valid, 1.0, 0.0), seg, num_segments=num)
    mean = total / jnp.maximum(count, 1.0)
    return {"k": d["k"], "c": v2 - mean[jnp.clip(seg, 0, num - 1)]}


def t_config4(a: T, b: T) -> T:
    """``cm_jax`` of ``bench.py:958-976``: the key and SUM(a.v) + SUM(b.w)."""
    s = a["_num_segments"]

    def seg_sum(d: T, c: str) -> torch.Tensor:
        out = torch.zeros(s + 1, dtype=d[c].dtype)
        return out.index_add_(0, d["_segment_ids"].long(),
                              torch.where(d["_row_valid"], d[c], 0.0))[:s]

    key = torch.full((s + 1,), -(2**31), dtype=torch.int64).scatter_reduce_(
        0, a["_segment_ids"].long(), torch.where(a["_row_valid"], a["k"], -(2**31)), "amax")[:s]
    return {"k": key, "s": seg_sum(a, "v") + seg_sum(b, "w")}


def j_config4(a: J, b: J) -> J:
    s = a["_num_segments"]
    sa = jax.ops.segment_sum(jnp.where(a["_row_valid"], a["v"], 0.0), a["_segment_ids"],
                             num_segments=s)
    sb = jax.ops.segment_sum(jnp.where(b["_row_valid"], b["w"], 0.0), b["_segment_ids"],
                             num_segments=s)
    k = jax.ops.segment_max(jnp.where(a["_row_valid"], a["k"].astype(jnp.int32), -(2**31)),
                            a["_segment_ids"], num_segments=s)
    return {"k": k, "s": sa + sb}


# ---- frames and comparison -----------------------------------------------

def frame(seed: int, n: int = 600, groups: int = 7) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, groups, n).astype(np.int64),
                         "v": rng.random(n), "u": rng.integers(0, 5, n).astype(np.int32)})


def headline_frame(n: int = 5000, groups: int = 64) -> pd.DataFrame:
    """The headline's data at a small size (``bench.py:539-541``)."""
    rng = np.random.default_rng(42)
    return pd.DataFrame({"k": rng.integers(0, groups, n).astype(np.int32),
                         "v": rng.random(n).astype(np.float32)})


def cpu_engine(conf: Any = None) -> Any:
    return ft.make_execution_engine(device="cpu", conf=conf)


def as_pandas(res: Any) -> pd.DataFrame:
    return res if isinstance(res, pd.DataFrame) else res.as_pandas()


def assert_same(got: Any, want: Any, keys: List[str], rtol: float = 1e-9) -> None:
    """The same columns and rows (sorted by ``keys``): integers and
    strings exactly, floats within ``rtol``."""
    g = as_pandas(got).sort_values(keys, kind="stable").reset_index(drop=True)
    w = as_pandas(want).sort_values(keys, kind="stable").reset_index(drop=True)
    assert list(g.columns) == list(w.columns) and len(g) == len(w), (g, w)
    for c in g.columns:
        gc, wc = g[c].to_numpy(), w[c].to_numpy()
        if gc.dtype.kind == "f":
            assert np.allclose(gc, wc.astype(np.float64), rtol=rtol, atol=0, equal_nan=True), c
        else:
            assert (gc == wc).all(), c


def run_port(build: Callable[[Any, Callable], None], conf: Any = None, te: Any = None
             ) -> Dict[str, Any]:
    """The port's DAG ``build(dag, frame)`` run on a CPU engine; its
    yields' results. ``frame(pdf)`` is what the DAG reads a pandas input
    as."""
    te = te or cpu_engine(conf)
    dag = FugueWorkflow()
    build(dag, lambda pdf: pdf)
    dag.run(te)
    assert te.fallbacks == {}, te.fallbacks
    return {k: y.result for k, y in dag.yields.items()}


def run_jax(build: Callable[[Any, Callable], None], conf: Any = None) -> Dict[str, Any]:
    je = _jax_engine()
    dag = JFugueWorkflow()
    build(dag, lambda pdf: _jax_df(je, pdf))
    dag.run(je, conf)
    assert je.fallbacks == {}, je.fallbacks
    return {k: y.result for k, y in dag.yields.items()}


# ---- transform --------------------------------------------------------------

@pytest.mark.parametrize("partitioned", [False, True], ids=["whole_column", "partitioned"])
def test_transform_matches_jax(partitioned):
    pdf = frame(1)

    def build(tf: Callable, schema: str) -> Callable:
        def b(dag: Any, fr: Callable) -> None:
            src = dag.df(fr(pdf))
            src = src.partition_by("k") if partitioned else src
            src.transform(tf, schema=schema).yield_dataframe_as("r", as_local=True)
        return b

    tf, jf, schema = ((t_center, j_center, "k:long,c:double") if partitioned
                      else (t_v2, j_v2, "k:long,v2:double"))
    got, want = run_port(build(tf, schema))["r"], run_jax(build(jf, schema))["r"]
    assert_same(got.as_pandas().reset_index(), want.as_pandas().reset_index(), ["index"])


def test_headline_transform_then_aggregate_matches_jax():
    """The headline (``bench.py:573-600``) at 5,000 rows: transform, then
    SUM, AVG and COUNT of ``v2`` by ``k``, through ``transform`` +
    ``aggregate`` (the port's as one DAG too)."""
    pdf = headline_frame()
    aggs = dict(s=ff.sum(ft.col("v2")), m=ff.avg(ft.col("v2")), c=ff.count(ft.col("v2")))
    te = cpu_engine()
    src = te.persist(te.to_df(pdf))
    out = ft.transform(src, t_v2, schema="k:int,v2:float", engine=te, as_fugue=True)
    got = ft.aggregate(out, partition_by="k", engine=te, as_fugue=True, **aggs)
    je = _jax_engine()
    jout = fugue_tpu.transform(_jax_df(je, pdf), j_v2, schema="k:int,v2:float", engine=je,
                               as_fugue=True)
    from fugue_tpu.execution.api import aggregate as jaggregate

    want = jaggregate(jout, partition_by="k", engine=je, as_fugue=True,
                      s=jff.sum(jcol("v2")), m=jff.avg(jcol("v2")), c=jff.count(jcol("v2")))
    assert_same(got, want, ["k"], rtol=1e-5)

    def build(dag: Any, fr: Callable) -> None:
        dag.df(src).transform(t_v2, schema="k:int,v2:float").partition_by("k").aggregate(
            **aggs).yield_dataframe_as("r")

    dag_got = run_port(build, te=te)["r"]
    assert isinstance(dag_got, ft.TorchDataFrame)
    assert_same(dag_got, got, ["k"], rtol=0)
    assert te.fallbacks == {} and je.fallbacks == {}


def test_out_transform_runs_the_function_once():
    """``out_transform`` of a device function runs it once over the whole
    columns, for its side effect; the JAX package's compiled map raises for
    such a function (ROADMAP.md queue 3, next test)."""
    pdf = frame(2)
    seen: List[float] = []

    def record(d: T) -> None:
        seen.append(float(torch.where(d["_row_valid"], d["v"], 0.0).sum()))

    te = cpu_engine()
    assert ft.out_transform(pdf, record, engine=te) is None
    assert len(seen) == 1 and np.isclose(seen[0], pdf["v"].sum(), rtol=1e-12)
    ft.out_transform(pdf, record, partition="k", engine=te)
    assert len(seen) == 2 and te.fallbacks == {}


def test_reference_out_transform_of_a_device_function_raises():
    """ROADMAP.md queue 3: the JAX package's ``out_transform`` of a
    ``Dict[str, jax.Array]`` function fails in its compiled map, which
    wants the output transformer's dummy column (or a dict)."""
    from fugue_tpu.workflow.api import out_transform as jout_transform

    def record(d: J) -> None:
        pass

    def record_dict(d: J) -> J:
        return {"k": d["k"]}

    je = _jax_engine()
    with pytest.raises(ValueError, match="must return a dict"):
        jout_transform(_jax_df(je, frame(2)), record, engine=je)
    with pytest.raises(ValueError, match="missing column _fugue_output_dummy"):
        jout_transform(_jax_df(je, frame(2)), record_dict, engine=je)


@pytest.mark.parametrize("groups", [100])
def test_config4_zip_cotransform_matches_jax(groups):
    """BASELINE config 4 (``bench.py:921-989``) at 100 groups of 50:
    ``dag.df(a)``, ``partition_by("k").zip(zb)``, the cotransform,
    ``yield_dataframe_as(as_local=True)``."""
    rng = np.random.default_rng(3)
    a = pd.DataFrame({"k": np.repeat(np.arange(groups, dtype=np.int64), 50),
                      "v": rng.random(groups * 50)})
    b = pd.DataFrame({"k": np.arange(groups, dtype=np.int64), "w": rng.random(groups)})

    def build(cm: Callable) -> Callable:
        def b_(dag: Any, fr: Callable) -> None:
            za, zb = dag.df(fr(a)), dag.df(fr(b))
            za.partition_by("k").zip(zb).transform(cm, schema="k:long,s:double"
                                                   ).yield_dataframe_as("out", as_local=True)
        return b_

    got, want = run_port(build(t_config4))["out"], run_jax(build(j_config4))["out"]
    assert_same(got, want, ["k"])
    sums = a.groupby("k")["v"].sum().to_numpy() + b["w"].to_numpy()
    assert np.allclose(as_pandas(got).sort_values("k")["s"].to_numpy(), sums, rtol=1e-12)


# ---- the relational built-ins -------------------------------------------

def _relational(dag: Any, fr: Callable, col: Any, fns: Any) -> None:
    a, b = dag.df(fr(frame(4))), dag.df(fr(frame(5, n=300, groups=9)))
    a.select("k", "v", where=col("v") > 0.3).yield_dataframe_as("select", as_local=True)
    a.filter(col("u") >= 2).yield_dataframe_as("filter", as_local=True)
    a.assign(w=col("v") * 3 + col("u")).yield_dataframe_as("assign", as_local=True)
    a.partition_by("k").aggregate(s=fns.sum(col("v")), n=fns.count(col("u"))
                                  ).yield_dataframe_as("aggregate", as_local=True)
    bs = b.rename(v="w", u="x")
    for how in ("inner", "left_outer", "semi", "anti"):
        a.join(bs, how=how, on=["k"]).yield_dataframe_as(f"join_{how}", as_local=True)
    a1, a2 = a[["k", "u"]], b[["k", "u"]]
    a1.union(a2).yield_dataframe_as("union", as_local=True)
    a1.union(a2, distinct=False).yield_dataframe_as("union_all", as_local=True)
    a1.subtract(a2).yield_dataframe_as("subtract", as_local=True)
    a1.intersect(a2).yield_dataframe_as("intersect", as_local=True)
    a1.distinct().yield_dataframe_as("distinct", as_local=True)
    a.take(3, presort="v desc").yield_dataframe_as("take", as_local=True)
    a.partition_by("k").take(2, presort="v").yield_dataframe_as("take_by", as_local=True)
    a.sample(n=50, seed=7).yield_dataframe_as("sample", as_local=True)


_KEYS = {"select": ["k", "v"], "filter": ["k", "v"], "assign": ["k", "v"], "aggregate": ["k"],
         "join_inner": ["k", "v", "w"], "join_left_outer": ["k", "v", "w"],
         "join_semi": ["k", "v"], "join_anti": ["k", "v"], "union": ["k", "u"],
         "union_all": ["k", "u"], "subtract": ["k", "u"], "intersect": ["k", "u"],
         "distinct": ["k", "u"], "take": ["v"], "take_by": ["k", "v"]}


def test_relational_builtins_match_jax():
    got = run_port(lambda dag, fr: _relational(dag, fr, ft.col, ff))
    want = run_jax(lambda dag, fr: _relational(dag, fr, jcol, jff))
    for name, keys in _KEYS.items():
        assert_same(got[name], want[name], keys)
    # a sample without replacement: its count and that its rows are the input's
    s = as_pandas(got["sample"])
    assert len(s) == len(as_pandas(want["sample"])) == 50
    assert s.merge(frame(4), on=["k", "v", "u"]).shape[0] == 50


def test_raw_sql_matches_jax():
    from fugue_tpu.workflow.api import raw_sql as jraw_sql

    a, b = frame(6), frame(7, n=200)
    head, mid, tail = ("SELECT k, SUM(v) AS s, COUNT(*) AS c FROM", "WHERE u > 1 AND k NOT IN "
                       "(SELECT k FROM", "WHERE v > 0.99) GROUP BY k ORDER BY k")
    te = cpu_engine()
    got = ft.raw_sql(head, a, mid, b, tail, engine=te)
    je = _jax_engine()
    want = jraw_sql(head, _jax_df(je, a), mid, _jax_df(je, b), tail, engine=je, as_local=True)
    assert isinstance(got, pd.DataFrame) and len(got) > 0
    assert_same(got, want.as_pandas(), ["k"])
    assert isinstance(ft.raw_sql(head, te.to_df(a), mid, b, tail, engine=te), ft.TorchDataFrame)
    assert te.fallbacks == {} and je.fallbacks == {}


# ---- checkpoints and yields -------------------------------------------------

def test_persist_and_weak_checkpoint_match_jax(monkeypatch):
    pdf = frame(8)

    def build(tf: Callable) -> Callable:
        def b(dag: Any, fr: Callable) -> None:
            x = dag.df(fr(pdf)).transform(tf, schema="k:long,v2:double").persist()
            x.yield_dataframe_as("a", as_local=True)
            y = dag.df(fr(pdf)).transform(tf, schema="k:long,v2:double").weak_checkpoint(
                lazy=True)
            y.yield_dataframe_as("b", as_local=True)
        return b

    te = cpu_engine()
    persisted: List[bool] = []
    real = te.persist
    monkeypatch.setattr(te, "persist", lambda df, **kw: persisted.append(kw["lazy"]) or real(
        df, **kw))
    got, want = run_port(build(t_v2), te=te), run_jax(build(j_v2))
    assert persisted == [False, True]
    for name in ("a", "b"):
        assert_same(got[name].as_pandas().reset_index(), want[name].as_pandas().reset_index(),
                    ["index"])


def test_strong_and_deterministic_checkpoints_skip_the_rerun(tmp_path):
    """A deterministic checkpoint's file, keyed by the task's id, makes a
    second run of the same DAG skip the task (the transformer does not
    run); a strong checkpoint lives in the run's temporary folder, removed
    after the run. Both give the JAX package's answer."""
    pdf = frame(9)
    calls: List[int] = []

    def counted(d: T) -> T:
        calls.append(1)
        return t_v2(d)

    conf = {"fugue.workflow.checkpoint.path": str(tmp_path)}
    te = cpu_engine(conf)
    src = te.persist(te.to_df(pdf))

    def build(strong: bool) -> FugueWorkflow:
        dag = FugueWorkflow()
        x = dag.df(src).transform(counted, schema="k:long,v2:double")
        (x.checkpoint() if strong else x.deterministic_checkpoint()).yield_dataframe_as(
            "r", as_local=True)
        return dag

    results = []
    for strong, want_calls in ((False, 1), (False, 0), (True, 1)):
        dag = build(strong)
        calls.clear()
        dag.run(te)
        assert len(calls) == want_calls, (strong, calls)
        results.append(dag.yields["r"].result.as_pandas())
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"{build(False).tasks[-1].__uuid__()}.parquet"]
    jdag = JFugueWorkflow()
    je = _jax_engine()
    jdag.df(_jax_df(je, pdf)).transform(j_v2, schema="k:long,v2:double"
                                        ).yield_dataframe_as("r", as_local=True)
    jdag.run(je)
    for got in results:
        assert_same(got.reset_index(), jdag.yields["r"].result.as_pandas().reset_index(),
                    ["index"])
    assert te.fallbacks == {}


def test_a_frames_task_identity_is_its_own(tmp_path):
    """ROADMAP.md queue 3: the JAX package hashes a frame into its task id
    by ``repr`` (class and schema), so a deterministic checkpoint hands a
    DAG over another frame of the same schema the first frame's data. The
    port's frames, its zips, and pandas and arrow inputs each have their
    own identity, so each run keeps its own."""
    conf = {"fugue.workflow.checkpoint.path": str(tmp_path / "port")}
    jconf = {"fugue.workflow.checkpoint.path": str(tmp_path / "jax")}
    first, second = frame(10), frame(11)

    def sums(run: Callable[[Any], Any], wrap: Callable[[pd.DataFrame], Any]) -> List[float]:
        return [float(as_pandas(run(wrap(p)))["v2"].sum()) for p in (first, second)]

    te = cpu_engine(conf)

    def port_run(df: Any) -> Any:
        dag = FugueWorkflow()
        dag.df(df).transform(t_v2, schema="k:long,v2:double").deterministic_checkpoint(
            ).yield_dataframe_as("r", as_local=True)
        dag.run(te)
        return dag.yields["r"].result

    je = _jax_engine()

    def jax_run(df: Any) -> Any:
        dag = JFugueWorkflow()
        dag.df(df).transform(j_v2, schema="k:long,v2:double").deterministic_checkpoint(
            ).yield_dataframe_as("r", as_local=True)
        dag.run(je, jconf)
        return dag.yields["r"].result

    want = [float((p["v"] * 2 + 1).sum()) for p in (first, second)]
    assert np.allclose(sums(port_run, lambda p: te.to_df(p)), want)
    assert np.allclose(sums(port_run, lambda p: p), want)
    assert np.allclose(sums(port_run, lambda p: pa.Table.from_pandas(p)), want)

    def zip_run(df: pd.DataFrame) -> Any:
        z = ft.zip(te.to_df(df), te.to_df(df.rename(columns={"v": "w"})), partition="k",
                   engine=te)
        dag = FugueWorkflow()
        dag.df(z).transform(t_config4, schema="k:long,s:double").deterministic_checkpoint(
            ).yield_dataframe_as("r", as_local=True)
        dag.run(te)
        return dag.yields["r"].result.as_pandas().rename(columns={"s": "v2"})

    assert np.allclose(sums(zip_run, lambda p: p), [float((p["v"] * 2).sum())
                                                    for p in (first, second)])
    wrong = sums(jax_run, lambda p: _jax_df(je, p))
    assert np.isclose(wrong[0], want[0]) and np.isclose(wrong[1], want[0])  # the stale frame


def test_local_data_is_hashed_only_for_a_deterministic_checkpoint(tmp_path, monkeypatch):
    """A pandas or arrow input has an id of its own in the task ids, with
    no pass over its rows; a deterministic checkpoint hashes the rows, so
    an equal copy (as in a later process) reuses the file and a frame
    changed in place recomputes."""
    te = cpu_engine({"fugue.workflow.checkpoint.path": str(tmp_path)})
    pdf = frame(23)
    calls: List[int] = []

    def counted(d: T) -> T:
        calls.append(1)
        return t_v2(d)

    def run(df: Any) -> float:
        dag = FugueWorkflow()
        dag.df(df).transform(counted, schema="k:long,v2:double").deterministic_checkpoint(
            ).yield_dataframe_as("r", as_local=True)
        dag.run(te)
        return float(dag.yields["r"].result.as_pandas()["v2"].sum())

    hashed = pd.util.hash_pandas_object

    def unhashed(*args: Any, **kwargs: Any) -> Any:
        raise AssertionError("a task id read the rows")

    monkeypatch.setattr(pd.util, "hash_pandas_object", unhashed)
    out = ft.transform(pdf, t_v2, schema="k:long,v2:double", engine=te)
    assert len(out) == len(pdf)
    assert FugueWorkflow().df(pdf).transform(t_v2, schema="k:long,v2:double"
                                             )._task.__uuid__()
    monkeypatch.setattr(pd.util, "hash_pandas_object", hashed)
    for df, want_calls in ((pdf, 1), (pdf.copy(), 0), (pa.Table.from_pandas(pdf), 1),
                           (pa.Table.from_pandas(pdf), 0)):
        calls.clear()
        assert np.isclose(run(df), float((pdf["v"] * 2 + 1).sum()))
        assert len(calls) == want_calls
    pdf.loc[0, "v"] += 100.0
    calls.clear()
    assert np.isclose(run(pdf), float((pdf["v"] * 2 + 1).sum())) and len(calls) == 1


@pytest.mark.parametrize("as_local", [False, True])
def test_yield_dataframe_as_matches_jax(as_local):
    pdf = frame(12)

    def build(tf: Callable) -> Callable:
        def b(dag: Any, fr: Callable) -> None:
            dag.df(fr(pdf)).transform(tf, schema="k:long,v2:double").yield_dataframe_as(
                "r", as_local=as_local)
        return b

    got, want = run_port(build(t_v2))["r"], run_jax(build(j_v2))["r"]
    assert got.is_local == want.is_local == as_local
    assert isinstance(got, ft.TorchDataFrame) != as_local
    assert_same(got.as_pandas().reset_index(), want.as_pandas().reset_index(), ["index"])


# ---- engines, concurrency, modules, identity -------------------------------

def test_engine_inference_and_the_context_engine(monkeypatch):
    """With no engine, a port frame decides the engine and its device; the
    context engine comes first; else the engine is on CUDA (which this
    machine lacks)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    te = cpu_engine()
    src = te.to_df(frame(13))
    out = ft.transform(src, t_v2, schema="k:long,v2:double")
    assert isinstance(out, ft.TorchDataFrame) and out.device == torch.device("cpu")
    z = ft.zip(src, te.to_df(frame(14).rename(columns={"v": "w"})), partition="k", engine=te)
    assert len(ft.transform(z, t_config4, "k:long,s:double").as_pandas()) == 7
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.transform(frame(13), t_v2, schema="k:long,v2:double")
    with te.as_context():
        assert len(ft.transform(frame(13), t_v2, schema="k:long,v2:double")) == 600
        assert ft.make_execution_engine() is te
    assert te.fallbacks == {}


def test_concurrency_2_matches_the_serial_run():
    """Two independent branches on two runner threads at once equal the
    serial run and the JAX package's."""
    a, b = frame(15), frame(16, n=900)

    def build(tf: Callable, col: Any, fns: Any) -> Callable:
        def bld(dag: Any, fr: Callable) -> None:
            x = dag.df(fr(a)).partition_by("k").transform(tf, schema="k:long,c:double")
            y = dag.df(fr(b)).filter(col("u") > 1).partition_by("k").aggregate(
                s=fns.sum(col("v")))
            x.yield_dataframe_as("x", as_local=True)
            y.yield_dataframe_as("y", as_local=True)
            x.partition_by("k").aggregate(m=fns.max(col("c"))).inner_join(y).yield_dataframe_as(
                "xy", as_local=True)
        return bld

    serial = run_port(build(t_center, ft.col, ff))
    parallel = run_port(build(t_center, ft.col, ff), conf={"fugue.workflow.concurrency": 2})
    want = run_jax(build(j_center, jcol, jff), conf={"fugue.workflow.concurrency": 2})
    for name, keys in (("x", ["k", "c"]), ("y", ["k"]), ("xy", ["k"])):
        assert_same(parallel[name], serial[name], keys, rtol=0)
        assert_same(parallel[name], want[name], keys)


def test_engine_counters_hold_under_threads():
    """A workflow's runner threads count into one engine's
    ``strategy_counts`` and ``fallbacks``: no update is lost."""
    import sys
    import threading

    te = cpu_engine()

    def work() -> None:
        for _ in range(2000):
            te._count_strategy("x")
            te._count_fallback("y")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert te.strategy_counts == {"x": 32000} and te.fallbacks == {"y": 32000}


def test_module_decorator_matches_jax():
    @module
    def doubled_sums(df: Any) -> Any:
        return df.transform(t_v2, schema="k:long,v2:double").partition_by("k").aggregate(
            s=ff.sum(ft.col("v2")))

    @jmodule
    def jdoubled_sums(df: Any) -> Any:
        return df.transform(j_v2, schema="k:long,v2:double").partition_by("k").aggregate(
            s=jff.sum(jcol("v2")))

    @module(as_method=True, name="port_doubled")
    def as_method(df: Any) -> Any:
        return doubled_sums(df)

    pdf = frame(17)
    got = run_port(lambda dag, fr: doubled_sums(dag.df(fr(pdf))).yield_dataframe_as(
        "r", as_local=True))
    method = run_port(lambda dag, fr: dag.df(fr(pdf)).port_doubled().yield_dataframe_as(
        "r", as_local=True))
    want = run_jax(lambda dag, fr: jdoubled_sums(dag.df(fr(pdf))).yield_dataframe_as(
        "r", as_local=True))
    assert_same(got["r"], want["r"], ["k"])
    assert_same(method["r"], want["r"], ["k"])


def test_task_ids_are_deterministic():
    """The same DAG built twice gives the same task ids; a changed
    parameter changes the ids of its task and of the tasks after it, not
    of those before."""
    src = cpu_engine().to_df(frame(18))

    def build(threshold: float) -> List[str]:
        dag = FugueWorkflow()
        x = dag.df(src).transform(t_v2, schema="k:long,v2:double")
        x.filter(ft.col("v2") > threshold).partition_by("k").aggregate(s=ff.sum(ft.col("v2")))
        return [t.__uuid__() for t in dag.tasks]

    one, again, other = build(1.5), build(1.5), build(2.5)
    assert one == again and len(set(one)) == 4
    assert one[:2] == other[:2] and one[2] != other[2] and one[3] != other[3]


def test_a_failing_task_names_itself_and_keeps_its_error_type():
    def broken(d: T) -> T:
        raise KeyError("no such column")

    with pytest.raises(KeyError, match="no such column") as info:
        ft.transform(frame(19), broken, schema="k:long", engine=cpu_engine())
    assert any("in task RunTransformer_" in n for n in info.value.__notes__)


# ---- what the DAG leaves out ------------------------------------------------

def _dag_with(conf: Any = None) -> Any:
    te = cpu_engine(conf)
    dag = FugueWorkflow()
    dag.df(frame(20)).transform(t_v2, schema="k:long,v2:double").yield_dataframe_as("r")
    return te, lambda: dag.run(te)


def _pandas_tf(df: pd.DataFrame) -> pd.DataFrame:
    return df


def _pandas_cm(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
    return a


_REFUSED = {
    "pandas_transformer": ("map", r"item 2\(b\)", lambda te: ft.transform(
        frame(21), _pandas_tf, schema="*", engine=te)),
    "ignore_errors": ("map", r"item 2\(b\)", lambda te: ft.transform(
        frame(21), t_v2, schema="k:long,v2:double", ignore_errors=[KeyError], engine=te)),
    "pandas_cotransformer": ("comap", r"item 2\(b\)", lambda te: ft.transform(
        ft.zip(frame(21), frame(22), partition="k", engine=te),
        _pandas_cm, schema="k:long", engine=te)),
    "optimize_on": ("workflow", "item 11", {"fugue.optimize": "on"}),
    "analysis_error": ("workflow", "item 11", {"fugue.analysis": "error"}),
    "retries": ("workflow", "item 10", {"fugue.workflow.retry.max_attempts": 2}),
    "timeout": ("workflow", "item 10", {"fugue.workflow.timeout": 5}),
    "resume": ("workflow", "item 10", {"fugue.workflow.resume": True}),
    "obs": ("workflow", "item 13", {"fugue.obs.enabled": True}),
    "http_rpc": ("workflow", "item 13", {"fugue.rpc.server": "http"}),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_left_out_parts_raise_and_count(case):
    op, item, how = _REFUSED[case]
    if isinstance(how, dict):
        te, run = _dag_with(how)
    else:
        te = cpu_engine()
        run = lambda: how(te)  # noqa: E731
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}"):
        run()
    assert te.fallbacks == {op: 1}, te.fallbacks


@pytest.mark.parametrize("case,item", [
    ("native_engine", r"item 2\(b\)"), ("explain", "item 11"), ("analyze", "item 11"),
    ("fault_tolerant", "item 10"), ("yield_table_as", "item 16"),
])
def test_left_out_parts_without_an_engine_raise(case, item):
    dag = FugueWorkflow()
    x = dag.df(frame(23))
    run = {"native_engine": lambda: dag.run("native"), "explain": dag.explain,
           "analyze": dag.analyze, "fault_tolerant": lambda: x.fault_tolerant(max_attempts=3),
           "yield_table_as": lambda: x.yield_table_as("t")}[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}"):
        run()


def test_the_default_modes_run_as_written():
    """Under ``fugue.optimize=auto`` and ``fugue.analysis=warn`` (and
    ``off``) the DAG runs; an unknown mode raises as in the reference."""
    for conf in ({}, {"fugue.optimize": "auto", "fugue.analysis": "warn"},
                 {"fugue.optimize": "off", "fugue.analysis": "off"}):
        te, run = _dag_with(conf)
        run()
        assert te.fallbacks == {}
    with pytest.raises(ValueError, match="invalid fugue.optimize mode"):
        _dag_with({"fugue.optimize": "sometimes"})[1]()


def test_chip_smoke_workflow_phase_on_cpu(monkeypatch):
    """``chip_smoke.workflow_paths`` at small sizes on the CPU: the
    headline through the DAG beside the direct lowering (the same
    answers), config 4 through the DAG against numpy, the DAG of the rest
    serially and at concurrency 2, and the checkpoint's second run."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "CONFIG4_GROUPS", 100)
    monkeypatch.setattr(chip_smoke, "CONFIG4_BIG_GROUPS", 300)
    out = {st["case"]: st for st in chip_smoke.workflow_paths(torch.device("cpu"), 50_000, 1)}
    assert sorted(out) == sorted([
        "headline_dag", "workflow_config4_inner", "workflow_config4_inner_100m",
        "workflow_rest_concurrency1", "workflow_rest_concurrency2",
        "workflow_deterministic_checkpoint"])
    assert out["headline_dag"]["tasks_a_run"] == 2
    assert all(not st.get("fallbacks") for st in out.values())
