"""The port's ``load_df``/``save_df`` (``ft.load``, ``ft.save``) and its
host boundary (``blocks.to_arrow``, ``TorchDataFrame.head``) against
``JaxExecutionEngine`` pinned to one device, on the CPU: parquet, csv and
json loads of a file, a folder of parts and a column list; saves in every
mode, partitioned and as one file; a masked aggregate's result saved
compacted through one gather (K10's twin here); heads and empty exports;
BASELINE config 5 end to end (``bench.py:1000-1088``) at small size."""

import os
from typing import Any, Dict, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu_torch import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.torch_backend import blocks as tblocks
from test_torch_join import _jax_df, _jax_engine


ROWS = 2_000


def assert_tables_equal(got: pa.Table, want: pa.Table) -> None:
    """The same schema and the same rows, values exactly (the frames hold no
    NaN, which the reference reads as null)."""
    assert got.schema.remove_metadata() == want.schema.remove_metadata(), (got.schema,
                                                                           want.schema)
    assert got.to_pylist() == want.to_pylist()


def sample_frame(n: int = ROWS, seed: int = 5) -> pd.DataFrame:
    """An int64, a float64 with nulls, a string with nulls and a bool, from
    a seeded generator."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "a": rng.integers(-1000, 1000, n),
        "f": pd.array(np.where(rng.random(n) < 0.1, np.nan, rng.random(n)), dtype="Float64"),
        "s": [None if i % 7 == 0 else f"v{i % 23}" for i in range(n)],
        "b": rng.random(n) < 0.5,
    })


def port(**conf: Any) -> Any:
    return ft.make_execution_engine(conf=conf, device="cpu")


def write_inputs(root: Any) -> Dict[str, str]:
    """The sample frame as parquet, csv (with a header), line-delimited
    json and a folder of three parquet parts."""
    table = pa.Table.from_pandas(sample_frame(), preserve_index=False)
    paths = {fmt: str(root / f"x.{fmt}") for fmt in ("parquet", "csv", "json")}
    pq.write_table(table, paths["parquet"])
    pacsv.write_csv(table, paths["csv"])
    with open(paths["json"], "w") as fp:
        for row in table.to_pylist():
            fp.write(pd.io.json.ujson_dumps(row) + "\n")
    folder = root / "parts"
    folder.mkdir()
    for j, lo in enumerate(range(0, ROWS, 700)):
        pq.write_table(table.slice(lo, 700), str(folder / f"part-{j}.parquet"))
    paths["folder"] = str(folder)
    return paths


@pytest.mark.parametrize("case", ["parquet", "csv", "json", "folder", "columns"])
def test_load_matches_the_reference(tmp_path: Any, case: str) -> None:
    paths = write_inputs(tmp_path)
    path = paths["parquet" if case == "columns" else case]
    kw: Dict[str, Any] = {"columns": ["s", "a"]} if case == "columns" else {}
    if case == "folder":
        kw["format_hint"] = "parquet"
    got = port().load_df(path, **kw)
    assert not got.is_pending and got.count() == ROWS
    want = _jax_engine().load_df(path, **kw)
    assert_tables_equal(got.as_arrow(), want.as_arrow())
    assert_tables_equal(ft.load(path, engine=port(), as_fugue=True, **kw).as_arrow(),
                        want.as_arrow())


def _read(path: str, fmt: str) -> Any:
    if fmt == "parquet":
        return pq.read_table(path).to_pylist()
    with open(path, "rb") as fp:
        return fp.read()


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json"])
def test_save_round_trips_in_every_mode(tmp_path: Any, fmt: str) -> None:
    pdf = sample_frame(300)
    more = sample_frame(100, seed=6)
    if fmt == "csv":  # a csv append reads the old rows as text: a null is no number
        pdf, more = pdf.dropna(), more.dropna()
    te, je = port(), _jax_engine()
    files: Dict[str, str] = {}
    for name, engine, frame, extra in (("port", te, te.to_df, te.to_df),
                                       ("jax", je, lambda d: _jax_df(je, d),
                                        lambda d: _jax_df(je, d))):
        path = files[name] = str(tmp_path / f"{name}.{fmt}")
        engine.save_df(frame(pdf), path, format_hint=fmt)
        engine.save_df(frame(pdf), path, format_hint=fmt, mode="overwrite")
        engine.save_df(extra(more), path, format_hint=fmt, mode="append")
        with pytest.raises(FileExistsError):
            engine.save_df(frame(pdf), path, format_hint=fmt, mode="error")
    assert _read(files["port"], fmt) == _read(files["jax"], fmt)
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".")]  # no temp file left
    if fmt == "parquet":
        back = te.load_df(files["port"]).as_arrow()
        assert_tables_equal(back, te.to_df(pd.concat([pdf, more])).as_arrow())


def test_partitioned_and_single_file_saves_match_the_reference(tmp_path: Any) -> None:
    pdf = sample_frame(500).assign(g=lambda d: d["a"] % 3)
    te, je = port(), _jax_engine()
    for name, engine, frame in (("port", te, te.to_df(pdf)), ("jax", je, _jax_df(je, pdf))):
        engine.save_df(frame, str(tmp_path / name), format_hint="parquet",
                       partition_spec=ft.api.PartitionSpec(by=["g"]))
        engine.save_df(frame, str(tmp_path / f"{name}.parquet"),
                       partition_spec=ft.api.PartitionSpec(by=["g"]), force_single=True)
    for suffix in ("", ".parquet"):
        got = te.load_df(str(tmp_path / f"port{suffix}"), format_hint="parquet").as_arrow()
        want = je.load_df(str(tmp_path / f"jax{suffix}"), format_hint="parquet").as_arrow()
        assert sorted(got.to_pylist(), key=str) == sorted(want.to_pylist(), key=str)
    assert os.path.isdir(tmp_path / "port") and os.path.isfile(tmp_path / "port.parquet")
    ft.save(pdf, str(tmp_path / "port"), format_hint="parquet", partition={"by": ["g"]},
            engine=te)  # overwrite replaces the folder
    assert te.load_df(str(tmp_path / "port"), format_hint="parquet").count() == 500


def test_masked_aggregate_saved_compacted(tmp_path: Any, monkeypatch: Any) -> None:
    """An aggregate's result (a masked frame over its bins) is compacted
    by one gather of every column before its export."""
    rng = np.random.default_rng(8)
    pdf = pd.DataFrame({"k": rng.integers(0, 40, 3_000).astype(np.int32) * 3,
                        "v": rng.random(3_000)})
    te = port()
    res = ft.aggregate(te.to_df(pdf), "k", s=ff.sum(col("v")), c=ff.count(col("v")),
                       engine=te, as_fugue=True)
    assert res.blocks.row_valid is not None and not res.blocks.nrows_known
    calls = []
    real = tblocks.gather_rows
    monkeypatch.setattr(tblocks, "gather_rows",
                        lambda cols, idx, **kw: calls.append(len(cols)) or real(cols, idx, **kw))
    path = str(tmp_path / "agg.parquet")
    te.save_df(res, path)
    assert calls == [3]  # one launch over k, s and c
    got = pq.read_table(path).to_pandas().sort_values("k").reset_index(drop=True)
    want = pdf.groupby("k").agg(s=("v", "sum"), c=("v", "count")).reset_index()
    np.testing.assert_array_equal(got["k"], want["k"])
    np.testing.assert_array_equal(got["c"], want["c"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-12)


def test_heads_and_empty_exports_match_the_reference() -> None:
    pdf = sample_frame(400)
    te, je = port(), _jax_engine()
    tf, jf = te.to_df(pdf), _jax_df(je, pdf)
    filt_t = te.filter(tf, col("a") > 200)
    from fugue_tpu.column import col as jcol

    filt_j = je.filter(jf, jcol("a") > 200)
    for got, want in ((tf, jf), (filt_t, filt_j)):
        for n, cols in ((0, None), (7, None), (5, ["s", "a"]), (10_000, None)):
            assert_tables_equal(got.head(n, cols), want.head(n, cols).as_arrow())
    none_t = te.filter(tf, col("a") > 5_000)
    none_j = je.filter(jf, jcol("a") > 5_000)
    assert_tables_equal(none_t.as_arrow(), none_j.as_arrow())
    empty = te.to_df(pdf.iloc[:0])
    assert empty.as_arrow().num_rows == 0 and empty.as_arrow().schema == none_t.as_arrow().schema


def test_export_rows_are_the_frames_rows_after_later_exports() -> None:
    te = port()
    frame = te.filter(te.to_df(sample_frame(300)), col("a") > 0)
    first = frame.as_arrow()
    kept = first.to_pylist()
    second = frame.as_arrow()
    assert first.to_pylist() == kept == second.to_pylist()
    assert frame.blocks.nrows == len(kept)


def config5_both(tmp_path: Any, n: int, batch_rows: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """BASELINE config 5 (``bench.py:1000-1088``) at ``n`` rows: the
    parquet file of ``k`` int32 over [0, 128) and ``v`` float32 from
    ``default_rng(4)``, loaded, ``v2 = v * 0.5``, ``sum(v2)`` and
    ``count(v2)`` by ``k``, saved as parquet; on the port and on the JAX
    engine (``batch_rows`` > 0: both streamed). Returns each saved
    output's columns sorted by ``k``."""
    import jax
    import jax.numpy as jnp

    from fugue_tpu import transform as jtransform
    from fugue_tpu.column import col as jcol
    from fugue_tpu.column import functions as jff
    from fugue_tpu.execution import make_execution_engine as make_jax_engine
    from fugue_tpu.execution.api import aggregate as jaggregate

    rng = np.random.default_rng(4)
    pdf = pd.DataFrame({"k": rng.integers(0, 128, n).astype(np.int32),
                        "v": rng.random(n).astype(np.float32)})
    src = str(tmp_path / "src.parquet")
    pdf.to_parquet(src)

    def udf(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": a["k"], "v2": a["v"] * 0.5}

    def jax_udf(a: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        return {"k": a["k"], "v2": a["v"] * jnp.float32(0.5)}

    te = port(**{"fugue.torch.io.batch_rows": batch_rows})
    df = te.load_df(src, format_hint="parquet")
    assert df.is_pending == (batch_rows > 0)
    out = ft.transform(df, udf, schema="k:int,v2:float", engine=te, as_fugue=True)
    agg = ft.aggregate(out, partition_by="k", s=ff.sum(col("v2")), c=ff.count(col("v2")),
                       engine=te, as_fugue=True)
    te.save_df(agg, str(tmp_path / "out_torch.parquet"), format_hint="parquet")
    je = make_jax_engine("jax", {"fugue.jax.devices": "0", "fugue.jax.io.batch_rows": batch_rows})
    jdf = je.load_df(src, format_hint="parquet")
    jout = jtransform(jdf, jax_udf, schema="k:int,v2:float", engine=je, as_fugue=True)
    jagg = jaggregate(jout, partition_by="k", s=jff.sum(jcol("v2")), c=jff.count(jcol("v2")),
                      engine=je, as_fugue=True)
    je.save_df(jagg, str(tmp_path / "out_jax.parquet"), format_hint="parquet")
    got, want = ({c: t[c].to_numpy() for c in ("k", "s", "c")} for t in (
        pq.read_table(str(tmp_path / f"out_{name}.parquet")).to_pandas().sort_values("k")
        for name in ("torch", "jax")))
    assert te.fallbacks == {}
    return got, want


def test_config5_end_to_end_matches_the_reference(tmp_path: Any) -> None:
    got, want = config5_both(tmp_path, 4_000, 0)
    np.testing.assert_array_equal(got["k"], want["k"])
    np.testing.assert_array_equal(got["c"], want["c"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-5)
