"""The port's streamed parquet ingest (``fugue.torch.io.batch_rows`` > 0,
``torch_backend/ingest.py``) against its eager load and against
``JaxExecutionEngine`` pinned to one device, on the CPU (the stager writes
straight into the column tensors there; the pinned slabs and copy stream
run on the card in ``chip_smoke.io_paths``).

The streamed frame's columns, masks, stats, ``unique`` flags and
dictionaries equal the eager load's bit for bit, with ``batch_rows``
dividing the rows and not, a mask first needed in a late batch, strings
whose values first appear in later batches, timestamps, dates, nullable
ints and bools, an empty file and a folder of parts; its rows equal the
JAX engine's streamed load. A hive folder, parts of different schemas,
csv and a schema expression load eagerly. ``head`` reads only leading
batches, a select of bare columns stays lazy and narrows the read,
``pruning`` keeps the row groups the reference keeps, and the pipelined
save writes the one-shot save's file in row groups of at most
``batch_rows``."""

import os
from typing import Any, Dict, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu.execution import make_execution_engine as make_jax_engine
from fugue_tpu.jax_backend import ingest as jingest
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.torch_backend import ingest
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from test_torch_io import assert_tables_equal, config5_both

ROWS = 1_500
ROW_GROUP = 400


def mixed_table(n: int, seed: int = 7) -> pa.Table:
    """Every type the card holds, from a seeded generator: a strictly
    increasing int64 (unique), an int32 key, float64 with nulls, a string
    whose values first appear in later rows, with nulls, a bool, a
    nullable bool, a timestamp, a date, a uint8 and an Int64 whose nulls
    are all in the last 40 rows (a mask first needed in a late batch)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    late = idx >= n - 40
    return pa.table({
        "i": pa.array(idx * 3 - 7, type=pa.int64()),
        "k": pa.array(rng.integers(0, 50, n).astype(np.int32)),
        "f": pa.array(rng.random(n), mask=rng.random(n) < 0.1),
        "s": pa.array([f"s{min(i // 97, 40)}-{i % 3}" for i in idx], mask=idx % 11 == 0,
                      type=pa.string()),
        "b": pa.array(idx % 2 == 0),
        "nb": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.2),
        "t": pa.array(1_577_836_800_000_000 + idx.astype(np.int64) * 3_600_000_000,
                      type=pa.timestamp("us")),
        "d": pa.array((18_000 + idx % 500).astype(np.int32), type=pa.date32()),
        "u": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "li": pa.array(np.where(late, 0, idx), mask=late, type=pa.int64()),
    })


def write(path: str, table: pa.Table, row_group: int = ROW_GROUP) -> str:
    pq.write_table(table, path, row_group_size=row_group)
    return path


def port(batch_rows: int = 0, **conf: Any) -> Any:
    return ft.make_execution_engine(conf={"fugue.torch.io.batch_rows": batch_rows, **conf},
                                    device="cpu")


def jax_engine(batch_rows: int = 0) -> Any:
    return make_jax_engine("jax", {"fugue.jax.devices": "0",
                                   "fugue.jax.io.batch_rows": batch_rows})


def assert_blocks_equal(got: Any, want: Any) -> None:
    """Two device frames alike bit for bit: rows, columns, masks, stats,
    ``unique`` flags and dictionaries."""
    assert got.nrows == want.nrows and list(got.columns) == list(want.columns)
    for name, g in got.columns.items():
        w = want.columns[name]
        assert g.pa_type == w.pa_type, name
        assert torch.equal(g.data.view(torch.uint8), w.data.view(torch.uint8)), name
        assert (g.mask is None) == (w.mask is None), name
        if g.mask is not None:
            assert torch.equal(g.mask, w.mask), name
        assert (g.stats, g.unique) == (w.stats, w.unique), name
        assert (g.dictionary is None) == (w.dictionary is None), name
        if g.dictionary is not None:
            assert list(g.dictionary) == list(w.dictionary), name


@pytest.mark.parametrize("batch_rows", [100, 137, 5_000])
def test_streamed_load_equals_the_eager_load(tmp_path: Any, batch_rows: int) -> None:
    path = write(str(tmp_path / "m.parquet"), mixed_table(ROWS))
    streamed = port(batch_rows).load_df(path)
    assert streamed.is_pending and streamed.count() == ROWS  # from the footer
    eager = port().load_df(path)
    assert not eager.is_pending
    assert_blocks_equal(streamed.blocks, eager.blocks)
    assert streamed.blocks.columns["i"].unique and not streamed.blocks.columns["li"].unique
    assert streamed.blocks.columns["li"].mask is not None


@pytest.mark.parametrize("batch_rows", [100, 137])
def test_streamed_load_matches_the_reference(tmp_path: Any, batch_rows: int) -> None:
    table = mixed_table(ROWS).drop_columns(["u"])  # the reference casts uint8 on its host
    path = write(str(tmp_path / "m.parquet"), table)
    got = port(batch_rows).load_df(path)
    want = jax_engine(batch_rows).load_df(path)
    jb = want.blocks
    for name, c in got.blocks.columns.items():
        assert c.unique == jb.columns[name].unique, name
        if name in ("i", "k", "t", "d"):
            assert c.stats == jb.columns[name].stats, name
    assert_tables_equal(got.as_arrow(), want.as_arrow())


def test_stream_unique_key_ending_at_zero(tmp_path: Any) -> None:
    path = write(str(tmp_path / "uz.parquet"), pa.table({"k": np.array([-2, -1, 0])}), 2)
    assert port().load_df(path).blocks.columns["k"].unique
    assert port(2).load_df(path).blocks.columns["k"].unique
    assert port(1).load_df(path).blocks.columns["k"].unique


def test_streamed_load_of_an_empty_file_and_of_parts(tmp_path: Any) -> None:
    empty = write(str(tmp_path / "e.parquet"), mixed_table(0))
    s, e = port(64).load_df(empty), port().load_df(empty)
    assert s.is_pending and s.count() == 0
    assert_blocks_equal(s.blocks, e.blocks)
    assert s.as_arrow().num_rows == 0
    folder = tmp_path / "parts"
    folder.mkdir()
    table = mixed_table(ROWS)
    for j, lo in enumerate(range(0, ROWS, 600)):
        write(str(folder / f"part-{j}.parquet"), table.slice(lo, 600))
    (folder / "_SUCCESS").write_text("")
    s = port(256).load_df(str(folder), format_hint="parquet")
    e = port().load_df(str(folder), format_hint="parquet")
    assert s.is_pending and s.count() == ROWS
    assert_blocks_equal(s.blocks, e.blocks)
    assert_tables_equal(s.as_arrow(), pa.Table.from_batches(table.to_batches()))


def test_streamed_load_falls_back_to_the_eager_read(tmp_path: Any) -> None:
    pdf = pd.DataFrame({"g": ["a", "b"] * 50, "v": np.arange(100, dtype=np.int64)})
    hive = str(tmp_path / "hive")
    ft.save(pdf, hive, format_hint="parquet", partition="g", engine=port())
    got = port(16).load_df(hive, format_hint="parquet")
    assert not got.is_pending
    want = jax_engine(16).load_df(hive, format_hint="parquet")
    assert sorted(got.as_arrow().to_pylist(), key=str) == \
        sorted(want.as_arrow().to_pylist(), key=str)
    het = tmp_path / "het"
    het.mkdir()
    write(str(het / "p0.parquet"), pa.table({"a": np.arange(3), "b": np.arange(3.0)}))
    write(str(het / "p1.parquet"), pa.table({"a": np.arange(2)}))
    got = port(16).load_df(str(het), format_hint="parquet")
    assert not got.is_pending
    assert got.as_arrow().to_pylist() == \
        jax_engine(16).load_df(str(het), format_hint="parquet").as_arrow().to_pylist()
    csv = str(tmp_path / "x.csv")
    ft.save(pdf, csv, engine=port(), header=True)
    assert not port(16).load_df(csv, header=True).is_pending
    path = write(str(tmp_path / "m.parquet"), mixed_table(50))
    expr = port(16).load_df(path, columns="k:long,i:int")
    assert not expr.is_pending and str(expr.schema) == "k:long,i:int"


def test_head_reads_only_leading_batches(tmp_path: Any, monkeypatch: Any) -> None:
    path = write(str(tmp_path / "m.parquet"), mixed_table(ROWS))
    seen: List[int] = []
    real = ingest.pq.ParquetFile

    class Counting(real):  # type: ignore[misc, valid-type]
        def iter_batches(self, *args: Any, **kwargs: Any) -> Any:
            for b in super().iter_batches(*args, **kwargs):
                seen.append(b.num_rows)
                yield b

    monkeypatch.setattr(ingest.pq, "ParquetFile", Counting)
    frame = port(100).load_df(path)
    head = frame.head(5)
    assert frame.is_pending and sum(seen) <= 100
    assert head.to_pylist() == mixed_table(ROWS).slice(0, 5).to_pylist()
    narrow = frame.head(3, ["s", "i"])
    assert narrow.schema.names == ["s", "i"] and frame.is_pending


def test_bare_column_select_stays_lazy_and_narrows(tmp_path: Any, monkeypatch: Any) -> None:
    path = write(str(tmp_path / "m.parquet"), mixed_table(ROWS))
    engine = port(128)
    frame = engine.load_df(path)
    picked = engine.select(frame, SelectColumns(ft.col("s"), ft.col("k")))
    assert isinstance(picked, TorchDataFrame) and picked.is_pending
    assert picked.schema.names == ["s", "k"] and picked.count() == ROWS
    asked: List[Any] = []
    real = ingest.pq.ParquetFile.iter_batches

    def spy(self: Any, *args: Any, **kwargs: Any) -> Any:
        asked.append(kwargs.get("columns"))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(ingest.pq.ParquetFile, "iter_batches", spy)
    assert list(picked.blocks.columns) == ["s", "k"]
    assert asked and all(c == ["s", "k"] for c in asked)
    eager = port().load_df(path, columns=["s", "k"]).blocks
    assert_blocks_equal(picked.blocks, eager)
    computed = engine.select(engine.load_df(path), SelectColumns((ft.col("k") + 1).alias("k1")))
    assert not computed.is_pending  # an expression needs the device copy


def test_pruning_keeps_the_reference_row_groups(tmp_path: Any) -> None:
    table = pa.table({"k": np.arange(2_000, dtype=np.int64),
                      "v": np.random.default_rng(3).random(2_000)})
    path = write(str(tmp_path / "p.parquet"), table, 250)
    md = pq.ParquetFile(path).metadata
    for pruning in ([["k", ">", 1_100]], [["k", "<=", 300], ["v", ">", 0.0]],
                    [["k", "==", 999]], [["k", ">", 5_000]]):
        assert ingest._row_groups_surviving(md, pruning) == \
            jingest._row_groups_surviving(md, pruning)
        got = port(100).load_df(path, pruning=pruning)
        want = jax_engine(100).load_df(path, pruning=pruning)
        assert got.count() == want.count()
        assert_tables_equal(got.as_arrow(), want.as_arrow())


def test_pipelined_save_writes_the_one_shot_file(tmp_path: Any) -> None:
    table = mixed_table(ROWS)
    one_shot, piped = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    frame = port().to_df(table)
    port(256, **{"fugue.torch.io.pipeline": False}).save_df(frame, one_shot)
    port(256).save_df(frame, piped)
    a, b = pq.read_table(one_shot), pq.read_table(piped)
    assert a.equals(b) and a.equals(frame.as_arrow())
    groups = [pq.ParquetFile(piped).metadata.row_group(g).num_rows
              for g in range(pq.ParquetFile(piped).metadata.num_row_groups)]
    assert max(groups) <= 256 and sum(groups) == ROWS
    with pytest.raises(FileExistsError):
        port(256).save_df(frame, piped, mode="error")


def test_config5_streamed_end_to_end(tmp_path: Any) -> None:
    """BASELINE config 5 (``bench.py:1000-1088``) at 4,000 rows on both
    engines, streamed: keys and counts exactly, float sums within
    rtol 1e-5 (float32 sums in another order)."""
    got, want = config5_both(tmp_path, 4_000, 512)
    np.testing.assert_array_equal(got["k"], want["k"])
    np.testing.assert_array_equal(got["c"], want["c"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-5)


def test_host_read_of_a_lazy_frame_makes_no_device_copy(tmp_path: Any, monkeypatch: Any) -> None:
    path = write(str(tmp_path / "m.parquet"), mixed_table(300))
    frame = port(64).load_df(path)
    called: Dict[str, int] = {"stream": 0}
    real = ingest._stream_to_blocks

    def spy(*args: Any, **kwargs: Any) -> Any:
        called["stream"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(ingest, "_stream_to_blocks", spy)
    table = frame.as_arrow()
    assert table.equals(pq.read_table(path)) and called["stream"] == 0
    assert frame.as_arrow() is table  # kept
    assert_blocks_equal(frame.blocks, port().load_df(path).blocks)
    assert called["stream"] == 0  # the kept table is uploaded, not re-read


def test_unported_column_types_refuse_a_streamed_load(tmp_path: Any) -> None:
    path = write(str(tmp_path / "u.parquet"), pa.table({"a": pa.array([1, 2], pa.uint32())}))
    for batch_rows in (0, 16):
        engine = port(batch_rows)
        with pytest.raises(NotImplementedError, match="queue 1 item 1"):
            engine.load_df(path)
        assert engine.fallbacks == {"load_df": 1}
    assert os.path.exists(path)
