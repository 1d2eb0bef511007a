"""Streamed parquet ingest and the pipelined save
(``fugue_tpu/jax_backend/ingest.py``).

A load with ``fugue.torch.io.batch_rows`` > 0 reads the parquet files as
record batches of that many rows. Each column's rows go into pinned host
slabs (``_Stager``: two a column); a full slab ships to the column's
device tensor by one non-blocking copy on a copy stream of its own, and
the host waits on that copy's event only before it refills the slab, so
the copies run while later batches decode. String columns are
dictionary-encoded a batch at a time and re-coded through a running
dictionary in first-seen order; integer stats and the proof that a
column strictly increases (its ``unique`` flag) are carried across
batches. The result is the eager load's to the bit: the same codes,
dictionaries, masks, stats and flags.

The frame stays LAZY (``TorchDataFrame.from_lazy``): the stream runs when
a device operation first touches its blocks; ``count`` is read from the
files' metadata, a host read goes through pyarrow with no device trip,
``head`` reads only the leading batches. A hive-partitioned or empty
directory, part files of different schemas, another format than parquet,
a schema expression for ``columns`` and reader options go to the eager
load (``try_stream_load`` returns None).

The save of a prefix frame with ``batch_rows`` > 0 (``try_pipelined_save``)
writes row groups of at most ``batch_rows`` rows while the next chunk is
copied from the card into pinned memory, with no thread: the copies of
chunk k + 1 are enqueued on the copy stream before chunk k is encoded.
Rows and their order are the one-shot save's: each chunk goes through the
same ``host_table``.

On the CPU no pinned memory and no stream is used: the rows are written
straight into the column tensors, and the save reads them there."""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from fugue_tpu_torch.constants import FUGUE_CONF_TORCH_IO_PIPELINE, typed_conf_get
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend.blocks import (
    _UNIQUE_CHECK_MAX,
    TorchBlocks,
    TorchColumn,
    _int_like_stats,
    copy_to_host,
    device_values,
    host_table,
    is_string_type,
    padded_len,
    torch_dtype,
    write_rows,
)
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.utils.io import infer_format

SLABS = 2  # pinned slabs a column: one fills while the other's copy runs


def _row_groups_surviving(md: Any, pruning: List[Any]) -> Optional[List[int]]:
    """The row groups a conjunctive ``[col, op, literal]`` predicate cannot
    refute by the group's column statistics (``:45``). Pruning by any
    subset of a conjunction is sound; a column without statistics keeps
    the group. None: the statistics could not be read, keep every group."""
    try:
        keep: List[int] = []
        for g in range(md.num_row_groups):
            rg = md.row_group(g)
            stats: Dict[str, Any] = {}
            for j in range(rg.num_columns):
                cmeta = rg.column(j)
                st = cmeta.statistics
                if st is not None and st.has_min_max:
                    stats[cmeta.path_in_schema] = st
            alive = True
            for name, op, val in pruning:
                st = stats.get(name)
                if st is None or not isinstance(val, (int, float)):
                    continue
                mn, mx = st.min, st.max
                if not isinstance(mn, (int, float)) or not isinstance(mx, (int, float)):
                    continue
                if ((op == ">" and not mx > val) or (op == ">=" and not mx >= val)
                        or (op == "<" and not mn < val) or (op == "<=" and not mn <= val)
                        or (op == "==" and not (mn <= val <= mx))):
                    alive = False
                    break
            if alive:
                keep.append(g)
        return keep
    except Exception:  # statistics of another layout: keep every group
        return None


def try_stream_load(engine: Any, path: Any, format_hint: Optional[str], columns: Any,
                    batch_rows: int, pruning: Optional[List[Any]] = None,
                    **kwargs: Any) -> Optional[TorchDataFrame]:
    """A lazy frame streaming a parquet load (``:90``), or None where the
    load needs the eager path. ``pruning`` (conjunctive ``[col, op,
    literal]`` triples) skips the row groups whose statistics refute it;
    it is advisory, a filter after the load applies the whole condition.
    A column type the card does not hold raises ``NotImplementedError``
    (counted in ``engine.fallbacks``) when the load is planned."""
    if batch_rows <= 0 or len(kwargs) > 0 or isinstance(columns, str):
        return None
    paths = [path] if isinstance(path, str) else list(path)
    try:
        if infer_format(paths[0], format_hint or None) != "parquet":
            return None
    except NotImplementedError:
        return None
    fs = engine.fs
    files: List[str] = []
    for p in paths:
        if fs.isdir(p):
            children = [fs.join(p, f) for f in fs.listdir(p)
                        if not f.startswith(".") and not f.startswith("_")]
            if len(children) == 0 or any(fs.isdir(c) for c in children):
                return None  # empty or hive-partitioned: the dataset read
            files.extend(sorted(children))
        else:
            if not fs.exists(p):
                return None  # the eager path raises
            files.append(p)

    # the files' footers only: rows, schema, row groups
    arrow_schema: Optional[pa.Schema] = None
    group_meta: List[Tuple[str, List[int], Optional[List[int]]]] = []
    for f in files:
        with fs.open_input_stream(f) as fp:
            pf = pq.ParquetFile(fp)
            md = pf.metadata
            if arrow_schema is None:
                arrow_schema = pf.schema_arrow
            elif pf.schema_arrow != arrow_schema:
                return None  # parts of other schemas: the eager read unifies them
            g_rows = [md.row_group(i).num_rows for i in range(md.num_row_groups)]
            group_meta.append((f, g_rows, _row_groups_surviving(md, pruning) if pruning
                               else None))
    row_groups: Optional[Dict[str, List[int]]] = None
    if pruning and all(k is not None for _, _, k in group_meta):
        # a load whose every group is refuted streams unpruned (the filter
        # drops the rows) rather than planning a frame of no batch
        if sum(sum(rows[g] for g in keep) for _, rows, keep in group_meta) > 0:  # type: ignore
            row_groups = {f: list(keep) for f, _, keep in group_meta}  # type: ignore
    nrows = sum(sum(rows[g] for g in (range(len(rows)) if row_groups is None
                                      else row_groups[f])) for f, rows, _ in group_meta)
    assert arrow_schema is not None
    base_schema = arrow_schema
    device = engine.device

    def plan(sel: Optional[List[str]]) -> TorchDataFrame:
        """The lazy frame over the columns ``sel`` (all by default), from
        the footers read once."""
        a_schema = base_schema if sel is None else pa.schema([base_schema.field(c) for c in sel])
        schema = Schema(a_schema)
        engine._check_types("load_df", schema)

        def groups_of(f: str) -> Optional[List[int]]:
            return None if row_groups is None else row_groups[f]

        def load_blocks() -> TorchBlocks:
            return _stream_to_blocks(fs, files, schema, device, nrows, batch_rows, sel,
                                     row_groups)

        def load_table() -> pa.Table:
            tables = []
            for f in files:
                groups = groups_of(f)
                if groups is not None and len(groups) == 0:
                    continue  # every row group refuted
                with fs.open_input_stream(f) as fp:
                    tables.append(pq.read_table(fp, columns=sel) if groups is None
                                  else pq.ParquetFile(fp).read_row_groups(groups, columns=sel))
            return tables[0] if len(tables) == 1 else pa.concat_tables(tables)

        def load_head(n: int) -> pa.Table:
            """The first ``n`` rows, reading batches only until they are
            covered."""
            batches = []
            remaining = n
            for f in files:
                groups = groups_of(f)
                if remaining <= 0:
                    break
                if groups is not None and len(groups) == 0:
                    continue
                with fs.open_input_stream(f) as fp:
                    for b in pq.ParquetFile(fp).iter_batches(
                            batch_size=max(min(batch_rows, n), 1), columns=sel,
                            row_groups=groups):
                        batches.append(b.slice(0, remaining))
                        remaining -= min(b.num_rows, remaining)
                        if remaining <= 0:
                            break
            return pa.Table.from_batches(batches, schema=a_schema)

        return TorchDataFrame.from_lazy(load_blocks, load_table, device, schema, nrows,
                                        load_head, plan)

    return plan(list(columns) if columns is not None else None)


class _Stager:
    """The rows of one device column (or mask) during a streamed load, in
    row order (``_ShardStager``, ``:288``, for one device). On the card:
    the column's tensor and ``SLABS`` pinned slabs of ``slab_rows`` rows;
    rows go into the slab being filled, and a full slab ships by one
    non-blocking copy on ``stream``, with an event the host waits on
    before it refills that slab. On the CPU (``stream`` None): rows are
    written straight into the column tensor. ``valid_rows``: rows ``[0,
    valid_rows)`` hold True (a mask first needed in a later batch)."""

    def __init__(self, pad_n: int, dtype: torch.dtype, device: torch.device, slab_rows: int,
                 stream: Optional[Any], valid_rows: int = 0):
        self.data = torch.empty((pad_n,), dtype=dtype, device=device)
        self.stream = stream
        self.end = valid_rows  # rows written
        if stream is None:
            self.view = self.data.numpy()
            self.view[:valid_rows] = True
            return
        # the tensor is written on the copy stream: the allocator must not
        # reuse it before that stream's work is done, and the copy stream
        # must not write it before the work that freed it is done
        self.data.record_stream(stream)
        stream.wait_stream(torch.cuda.current_stream(device))
        if valid_rows:
            with torch.cuda.stream(stream):
                self.data[:valid_rows].fill_(True)
        self.slabs = [torch.empty((slab_rows,), dtype=dtype, pin_memory=True)
                      for _ in range(SLABS)]
        self.events: List[Optional[Any]] = [None] * SLABS
        self.k = 0  # the slab being filled
        self.lo = valid_rows  # the first row of slab k

    def write(self, values: np.ndarray) -> None:
        """The next ``len(values)`` rows."""
        n = len(values)
        if self.stream is None:
            self.view[self.end:self.end + n] = values
            self.end += n
            return
        rows = int(self.slabs[0].shape[0])
        pos = 0
        while pos < n:
            fill = self.end - self.lo
            take = min(rows - fill, n - pos)
            write_rows(self.slabs[self.k].numpy()[fill:fill + take], values[pos:pos + take], None)
            pos += take
            self.end += take
            if self.end - self.lo == rows:
                self._ship()

    def _ship(self) -> None:
        """Ships slab k's rows, then waits until the next slab's last copy
        is done, before the host refills it."""
        rows = self.end - self.lo
        if rows == 0:
            return
        with torch.cuda.stream(self.stream):
            self.data[self.lo:self.end].copy_(self.slabs[self.k][:rows], non_blocking=True)
            shipped = torch.cuda.Event()
            shipped.record(self.stream)
        self.events[self.k] = shipped
        self.k = (self.k + 1) % SLABS
        self.lo = self.end
        waiting = self.events[self.k]
        if waiting is not None:
            waiting.synchronize()
            self.events[self.k] = None

    def finish(self) -> torch.Tensor:
        """Ships the last rows, writes 0 in the padding rows and returns
        the column tensor."""
        if self.stream is None:
            self.view[self.end:] = 0
            return self.data
        self._ship()
        if self.end < int(self.data.shape[0]):
            with torch.cuda.stream(self.stream):
                self.data[self.end:].zero_()
        return self.data


def _stream_to_blocks(fs: Any, files: List[str], schema: Schema, device: torch.device,
                      nrows: int, batch_rows: int, columns: Optional[List[str]],
                      row_groups: Optional[Dict[str, List[int]]]) -> TorchBlocks:
    """The files' batches streamed into device columns (``:316``). The
    current stream waits for the copy stream before the frame is handed
    on, so no kernel reads a column while its rows are in flight."""
    pad_n = padded_len(nrows)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    stagers = {f.name: _Stager(pad_n, torch_dtype(f.type), device, batch_rows, stream)
               for f in schema.fields}
    masks: Dict[str, _Stager] = {}
    # a string column's running dictionary: value -> code, in first-seen order
    dicts: Dict[str, Dict[Any, int]] = {f.name: {} for f in schema.fields
                                        if is_string_type(f.type)}
    stats: Dict[str, Optional[Tuple[int, int]]] = {}
    # an integer column still strictly increasing: its last value (None
    # before the first batch); gated on size as the eager check is
    monotonic: Dict[str, Optional[int]] = {
        f.name: None for f in schema.fields
        if pa.types.is_integer(f.type) and 0 < nrows <= _UNIQUE_CHECK_MAX}

    def write_mask(name: str, valid: Optional[np.ndarray], offset: int, n: int) -> None:
        """A batch's validity (``_mask_write``, ``:638``): the mask is made
        when a batch first has nulls, its earlier rows valid."""
        st = masks.get(name)
        if st is None:
            if valid is None:
                return
            st = masks[name] = _Stager(pad_n, torch.bool, device, batch_rows, stream,
                                       valid_rows=offset)
        st.write(np.ones((n,), dtype=np.bool_) if valid is None else valid)

    offset = 0
    for fname in files:
        groups = None if row_groups is None else row_groups.get(fname)
        if groups is not None and len(groups) == 0:
            continue  # every row group refuted
        with fs.open_input_stream(fname) as fp:
            for batch in pq.ParquetFile(fp).iter_batches(batch_size=batch_rows, columns=columns,
                                                         row_groups=groups):
                n = batch.num_rows
                if n == 0:
                    continue
                for f in schema.fields:
                    arr = batch.column(batch.schema.get_field_index(f.name))
                    values, valid = _decode(f.name, f.type, arr, dicts, stats, monotonic)
                    stagers[f.name].write(values)
                    write_mask(f.name, valid, offset, n)
                offset += n

    cols: Dict[str, TorchColumn] = {}
    for f in schema.fields:
        data = stagers[f.name].finish()
        mask = masks[f.name].finish() if f.name in masks else None
        if f.name in dicts:
            dictionary = np.empty((len(dicts[f.name]),), dtype=object)
            for v, code in dicts[f.name].items():
                dictionary[code] = v
            cols[f.name] = TorchColumn(f.type, data, mask, (0, max(len(dictionary) - 1, 0)),
                                       dictionary=dictionary)
            continue
        # membership, not the value: a last value of 0 still proves it
        cols[f.name] = TorchColumn(f.type, data, mask, stats.get(f.name, (0, 0)),
                                   unique=mask is None and f.name in monotonic)
    if stream is not None:
        torch.cuda.current_stream(device).wait_stream(stream)
    return TorchBlocks(nrows, cols, device)


def _decode(name: str, tp: pa.DataType, arr: pa.Array, dicts: Dict[str, Dict[Any, int]],
            stats: Dict[str, Optional[Tuple[int, int]]],
            monotonic: Dict[str, Optional[int]]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One batch of one column as the card holds it (``_decode_into``,
    ``:561``): its values (0 at nulls) and its validity where it has
    nulls; a string's codes through the running dictionary; the column's
    stats and its strictly increasing run carried on."""
    if is_string_type(tp):
        enc = arr.dictionary_encode()
        local, valid = device_values(enc.indices, pa.int32())
        gdict = dicts[name]
        remap = np.empty((len(enc.dictionary),), dtype=np.int32)
        for i, v in enumerate(enc.dictionary.to_pylist()):
            remap[i] = gdict.setdefault(v, len(gdict))
        if len(remap) == 0:  # every row null
            return np.zeros((len(arr),), dtype=np.int32), valid
        codes = remap[local if valid is None else np.where(valid, local, 0)]
        return (codes if valid is None else np.where(valid, codes, 0).astype(np.int32)), valid
    values, valid = device_values(arr, tp)
    if valid is not None:
        values = np.where(valid, values, 0).astype(values.dtype, copy=False)
    s = _int_like_stats(values)
    if name not in stats:
        stats[name] = s
    elif s is not None and stats[name] is not None:
        prev = stats[name]
        stats[name] = (min(prev[0], s[0]), max(prev[1], s[1]))  # type: ignore[index]
    if name in monotonic:
        last = monotonic[name]
        if valid is None and bool((values[1:] > values[:-1]).all()) and (
                last is None or values[0] > last):
            monotonic[name] = values[-1]
        else:
            del monotonic[name]
    return values, valid


def _chunk_view(blocks: TorchBlocks, lo: int, hi: int) -> TorchBlocks:
    """Rows ``[lo, hi)`` of a prefix frame as a prefix frame of views
    (``:438``)."""
    return TorchBlocks(hi - lo, {
        name: TorchColumn(c.pa_type, c.data[lo:hi], None if c.mask is None else c.mask[lo:hi],
                          c.stats, dictionary=c.dictionary)
        for name, c in blocks.columns.items()}, blocks.device)


def try_pipelined_save(engine: Any, tdf: TorchDataFrame, path: str,
                       format_hint: Optional[str], mode: str, partition_cols: Any,
                       batch_rows: int, kwargs: Dict[str, Any]) -> bool:
    """The save of a prefix frame on the device as parquet row groups of
    ``batch_rows`` rows, chunk k + 1 copied from the card while chunk k
    is encoded (``:459``). False where the general save applies: another
    format, a partitioned, appending or directory target, a masked frame
    (its export compacts it first), a frame still in storage, no rows, or
    ``fugue.torch.io.pipeline`` off."""
    if batch_rows <= 0 or partition_cols or mode not in ("overwrite", "error"):
        return False
    if not typed_conf_get(engine.conf, FUGUE_CONF_TORCH_IO_PIPELINE):
        return False
    try:
        if infer_format(path, format_hint or None) != "parquet":
            return False
    except NotImplementedError:
        return False
    if tdf.is_pending:
        return False
    blocks = tdf.blocks
    if blocks.row_valid is not None or blocks.nrows <= 0:
        return False
    fs = engine.fs
    if fs.exists(path):
        if mode == "error":
            raise FileExistsError(path)
        if fs.isdir(path):
            return False
    kwargs = {k: v for k, v in kwargs.items() if k != "batch_rows"}
    nrows, schema = blocks.nrows, tdf.schema
    spans = [(lo, min(lo + batch_rows, nrows)) for lo in range(0, nrows, batch_rows)]
    stream = None
    if blocks.device.type == "cuda":
        stream = torch.cuda.Stream(blocks.device)
        stream.wait_stream(torch.cuda.current_stream(blocks.device))

    def fetch(span: Tuple[int, int]) -> Any:
        return copy_to_host(_chunk_view(blocks, *span), schema.names, stream)

    def write_all(fp: Any) -> None:
        writer = None
        try:
            pending = fetch(spans[0])
            for i in range(len(spans)):
                following = fetch(spans[i + 1]) if i + 1 < len(spans) else None
                table = host_table(pending, schema)
                if writer is None:
                    writer = pq.ParquetWriter(fp, table.schema, **kwargs)
                writer.write_table(table, row_group_size=batch_rows)
                pending = following
        finally:
            if writer is not None:
                writer.close()

    fs.write_file_atomic(path, write_all)
    return True
