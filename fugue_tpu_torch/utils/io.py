"""Host file I/O of the port: parquet, csv and json loads and saves of
arrow tables over local files (``fugue_tpu/utils/io.py``, its lake
branches refused: ``lake://`` and every other scheme but ``file`` raise
``NotImplementedError`` naming ROADMAP.md queue 1 item 13, through
``fs.local.check_uri``).

A path may be one file or a directory of part files; a parquet directory
(flat or hive-partitioned) is read as a pyarrow dataset. A single-file
save is atomic (a dot-hidden temp file, then a rename)."""

import io as _stdio
import json
from typing import Any, Callable, Dict, List, Optional, Union

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson
import pyarrow.parquet as pq

from fugue_tpu_torch.dataframe.utils import arrow_to_table
from fugue_tpu_torch.fs.local import LocalFileSystem, check_uri
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw

_FORMATS = {".parquet": "parquet", ".csv": "csv", ".json": "json"}

TableOrLoader = Union[pa.Table, Callable[[], pa.Table]]


def spec_partition_cols(partition_spec: Any, force_single: bool) -> Optional[List[str]]:
    """A partition spec's keys as hive partition columns, unless a single
    file was forced (``:39``)."""
    if partition_spec is None or force_single:
        return None
    by = list(partition_spec.partition_by)
    return by if len(by) > 0 else None


def infer_format(path: str, format_hint: Optional[str] = None) -> str:
    """``format_hint``, or the format of ``path``'s suffix (``:50``)."""
    if format_hint is not None:
        assert_or_throw(format_hint in ("parquet", "csv", "json"),
                        NotImplementedError(f"invalid format {format_hint}"))
        return format_hint
    for suffix, fmt in _FORMATS.items():
        if path.endswith(suffix):
            return fmt
    raise NotImplementedError(f"can't infer format of {path}")


def part_files(fs: LocalFileSystem, path: str) -> List[str]:
    """``path``, or a directory's part files (names starting with ``.`` or
    ``_`` skipped), sorted (``:63``)."""
    if fs.isdir(path):
        files = sorted(fs.join(path, f) for f in fs.listdir(path)
                       if not f.startswith(".") and not f.startswith("_"))
        assert_or_throw(len(files) > 0, FileNotFoundError(f"no part files in {path}"))
        return files
    assert_or_throw(fs.exists(path), FileNotFoundError(path))
    return [path]


def load_df(path: Union[str, List[str]], format_hint: Optional[str] = None,
            columns: Any = None, fs: Optional[LocalFileSystem] = None,
            **kwargs: Any) -> pa.Table:
    """The files at ``path`` (one path or several) as one arrow table
    (``:76``). ``columns`` is a list of names, or a schema expression
    (``"a:int,b:str"``) whose columns are selected and cast."""
    fs = fs or LocalFileSystem()
    paths = [path] if isinstance(path, str) else list(path)
    for p in paths:
        check_uri(p)
    fmt = infer_format(paths[0], format_hint)
    tables = []
    for p in paths:
        if fmt == "parquet" and fs.isdir(p):
            # a dataset read: flat part folders and hive layouts, whose
            # partition columns arrive dictionary-encoded and are decoded
            pa_fs, local_path = fs.pyarrow_fs(p)
            t = pq.read_table(local_path, columns=columns if isinstance(columns, list) else None,
                              filesystem=pa_fs, **kwargs)
            for i, f in enumerate(t.schema):
                if pa.types.is_dictionary(f.type):
                    t = t.set_column(i, f.name, t.column(i).cast(f.type.value_type))
            tables.append(t)
            continue
        for f in part_files(fs, p):
            # each file gets its own copy: the csv branch pops options
            tables.append(_load_single(fs, f, fmt, columns, dict(kwargs)))
    table = tables[0] if len(tables) == 1 else pa.concat_tables(tables)
    if isinstance(columns, str):  # a schema expression: select and cast
        schema = Schema(columns)
        return arrow_to_table(table.select(schema.names), schema)
    return table


def _load_single(fs: LocalFileSystem, path: str, fmt: str, columns: Any,
                 kwargs: Dict[str, Any]) -> pa.Table:
    """One file (``:196``): parquet; csv with a header (or ``header=False``
    and named ``columns``), its values kept as text unless typed by a
    schema expression or ``infer_schema=True``; line-delimited json."""
    cols = columns if isinstance(columns, list) else None
    if fmt == "parquet":
        pa_fs, local_path = fs.pyarrow_fs(path)
        return pq.read_table(local_path, columns=cols, filesystem=pa_fs, **kwargs)
    if fmt == "csv":
        header = bool(kwargs.pop("header", True))
        infer = bool(kwargs.pop("infer_schema", False))
        schema: Optional[Schema] = None
        read_opts = pacsv.ReadOptions()
        convert_opts = pacsv.ConvertOptions()
        if isinstance(columns, str):
            assert_or_throw(not infer, ValueError(
                "can't set typed columns together with infer_schema=True"))
            schema = Schema(columns)
        names: Optional[List[str]] = None
        if not header:
            assert_or_throw(columns is not None,
                            ValueError("columns must be set when csv has no header"))
            names = schema.names if schema is not None else list(columns)
            read_opts.column_names = names
        if schema is not None:
            convert_opts.column_types = {f.name: f.type for f in schema.fields
                                         if not pa.types.is_nested(f.type)}
        elif not infer:
            if names is None:
                import csv as _csv

                with fs.open_input_stream(path) as raw:
                    names = next(_csv.reader(_stdio.TextIOWrapper(raw, newline="")))
            convert_opts.column_types = {n: pa.string() for n in names}
        with fs.open_input_stream(path) as fp:
            table = pacsv.read_csv(fp, read_options=read_opts, convert_options=convert_opts)
        return table.select(cols) if cols is not None else table
    if fmt == "json":
        with fs.open_input_stream(path) as fp:
            table = pajson.read_json(fp)
        return table.select(cols) if cols is not None else table
    raise NotImplementedError(fmt)


def save_df(df: TableOrLoader, path: str, format_hint: Optional[str] = None,
            mode: str = "overwrite", force_single: bool = False,
            partition_cols: Optional[List[str]] = None,
            fs: Optional[LocalFileSystem] = None, **kwargs: Any) -> None:
    """Writes ``df`` (an arrow table, or a function that exports one, run
    only once the target checks pass) to ``path`` (``:258``). ``mode``:
    ``overwrite`` (a directory target is removed first; a file is
    replaced by the atomic write), ``append`` (a new part file in a
    directory; a single file read, concatenated and rewritten) or
    ``error`` (``FileExistsError`` where ``path`` exists).
    ``partition_cols``: a hive-partitioned parquet dataset.
    ``batch_rows`` bounds parquet row groups; it is never passed on to
    pyarrow."""
    fs = fs or LocalFileSystem()
    check_uri(path)
    assert_or_throw(mode in ("overwrite", "append", "error"),
                    NotImplementedError(f"invalid mode {mode}"))
    fmt = infer_format(path, format_hint)
    batch_rows = int(kwargs.pop("batch_rows", 0) or 0)
    if fs.exists(path):
        if mode == "error":
            raise FileExistsError(path)
        if mode == "overwrite" and (fs.isdir(path) or partition_cols):
            fs.rm(path, recursive=True)
    table = df() if callable(df) else df
    if partition_cols:
        assert_or_throw(fmt == "parquet",
                        NotImplementedError(f"partitioned save not supported for {fmt}"))
        pa_fs, local_path = fs.pyarrow_fs(path)
        pq.write_to_dataset(table, root_path=local_path, partition_cols=list(partition_cols),
                            filesystem=pa_fs, **kwargs)
        return
    if mode == "append" and fs.exists(path):
        if fs.isdir(path):
            target = fs.join(path, f"part-{len(fs.listdir(path))}.{fmt}")
            _save_single(fs, table, target, fmt, kwargs, batch_rows)
            return
        # the existing file read with the header convention it was written
        # with (csv: none by default), then cast to the new data's types
        load_kw: Dict[str, Any] = {}
        load_cols: Any = None
        if fmt == "csv":
            load_kw["header"] = bool(kwargs.get("header", False))
            if not load_kw["header"]:
                load_cols = list(table.schema.names)
        old = _load_single(fs, path, fmt, load_cols, load_kw)
        if old.schema != table.schema:
            old = arrow_to_table(old.select(table.schema.names), Schema(table.schema))
        table = pa.concat_tables([old, table])
    _save_single(fs, table, path, fmt, kwargs, batch_rows)


def _save_single(fs: LocalFileSystem, table: pa.Table, path: str, fmt: str,
                 kwargs: Dict[str, Any], batch_rows: int = 0) -> None:
    """One file, atomically (``:332``): parquet (row groups of at most
    ``batch_rows`` rows where given), csv (no header unless
    ``header=True``), line-delimited json."""
    if fmt == "parquet":
        if batch_rows > 0:
            def _write_batched(fp: Any) -> None:
                with pq.ParquetWriter(fp, table.schema, **kwargs) as w:
                    for batch in table.to_batches(max_chunksize=batch_rows):
                        w.write_batch(batch)

            fs.write_file_atomic(path, _write_batched)
            return
        fs.write_file_atomic(path, lambda fp: pq.write_table(table, fp, **kwargs))
        return
    if fmt == "csv":
        opts = pacsv.WriteOptions(include_header=bool(kwargs.pop("header", False)))
        fs.write_file_atomic(path, lambda fp: pacsv.write_csv(table, fp, opts))
        return
    if fmt == "json":
        def _write_json(fp: Any) -> None:
            text = _stdio.TextIOWrapper(fp, encoding="utf-8")
            for row in table.to_pylist():
                text.write(json.dumps(row, default=str) + "\n")
            text.flush()
            text.detach()  # the caller closes the binary stream

        fs.write_file_atomic(path, _write_json)
        return
    raise NotImplementedError(fmt)
