"""``alter_columns`` on the card: each altered column cast to its new type
by the rules of the reference's ``cast_table``
(``fugue_tpu/dataframe/arrow_utils.py:144``), which casts at the host
boundary and uploads again (``jax_backend/dataframe.py:292-298``).

- **Among bool, the integers, unsigned, floats, date and timestamp**: every
  altered column is a cast expression over the stored values
  (``_cast_expr``), all of them in ONE K6 program and launch.
- **From a string**: the dictionary is cast on the host by the same rules
  (``arrow_utils.cast_array``: ``"true"``/``"1"``, dates, timestamps,
  numbers; a value that does not convert raises as there), then one K6
  LUT launch reads each row's value from that table by its code (and a
  second, of the entries' validity, clears the rows of an entry that
  casts to null).
- **To a string**: the column is factorized on the card (the group-by's K1
  or sort route, ``groupby.factorize_keys``); its distinct values (one
  per segment, gathered at each segment's first row) are formatted on the
  host by ``cast_array`` (``str(datetime)`` to the second,
  ``True``/``False``) and made distinct, and one K6 LUT launch re-codes
  the segment ids into the new dictionary's codes.

The host work is O(dictionary) or O(segments), never O(rows), where
both types are device types. A cast from or to a host type (binary,
nested, decimal) is made on the host, where that column lives or its
result will, as ``cast_table`` makes it; a device result is uploaded. A
cast that arrow has not (bool, date or timestamp to float16, a
timestamp to a number, ...) raises arrow's error, as ``cast_table``
does. A NaN, an infinity or a float beyond the target's range cast to an
integer follows K6's rule (NaN as 0, the rest saturating); ``cast_table``
gives what the host CPU's conversion gives there."""

from typing import Dict, List

import numpy as np
import pyarrow as pa
import torch

from fugue_tpu_torch.column.expressions import ColumnExpr, col, function, lit
from fugue_tpu_torch.dataframe.arrow_utils import cast_array
from fugue_tpu_torch.kernels.expr_program import lut_program
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import expr_eval, groupby
from fugue_tpu_torch.torch_backend.blocks import (
    TorchBlocks,
    TorchColumn,
    U64_FLIP,
    _NP_DTYPES,
    blocks_with_columns,
    copy_to_host,
    from_arrow,
    from_storage,
    host_table,
    is_string_type,
    pad_rows,
    to_storage,
    torch_dtype,
)

_DAY_US = 86_400_000_000
# the integer type each stored arrow type computes in on the card
_STORED = {
    pa.date32(): pa.int32(), pa.uint16(): pa.int32(), pa.uint32(): pa.int64(),
    pa.uint64(): pa.int64(),
}


def _stored(tp: pa.DataType) -> pa.DataType:
    return pa.int64() if pa.types.is_timestamp(tp) else _STORED.get(tp, tp)


def _cast_expr(name: str, src: pa.DataType, dst: pa.DataType) -> ColumnExpr:
    """The cast ``src -> dst`` of column ``name`` over its stored values,
    as arrow's unsafe cast computes it: a uint64 by its value (a float or
    bool) or its int64 bits (an integer); a date to a timestamp in
    microseconds; a timestamp to a date by its day (floor); a value to a
    uint16 or uint32 reduced modulo 2^16 or 2^32; a value to a uint64 as
    its int64 bits, flipped; a value to a float16 through its float64
    value, rounded once to float16 as the program stores it
    (``expr_program``'s ``HALF``)."""
    x: ColumnExpr = col(name)
    if pa.types.is_float16(dst):  # its value in float64, rounded once where it is stored
        return x.cast(pa.float64())
    if src == pa.uint64():  # K6 reads a uint64's value out of its flipped word
        if pa.types.is_floating(dst) or pa.types.is_boolean(dst):
            return x.cast(dst)
        x, src = x.cast(pa.int64()), pa.int64()  # the uint64's int64 bits
    if pa.types.is_date32(src) and pa.types.is_timestamp(dst):
        return x.cast(pa.int64()) * lit(_DAY_US)
    if pa.types.is_timestamp(src) and pa.types.is_date32(dst):
        return function("floor", x.cast(pa.float64()) / lit(float(_DAY_US))).cast(pa.int32())
    if dst in (pa.uint16(), pa.uint32()):
        bits = 16 if dst == pa.uint16() else 32
        wide = _stored(dst)
        low = x.cast(pa.int16() if bits == 16 else pa.int32()).cast(wide)
        return function("mod", low + lit(1 << bits), lit(1 << bits))
    if dst == pa.uint64():
        return x.cast(pa.int64()) + lit(U64_FLIP)
    if pa.types.is_boolean(dst):
        return x != lit(0)
    return x.cast(_stored(dst))


def _host_cast(blocks: TorchBlocks, name: str, src: pa.DataType, dst: pa.DataType
               ) -> TorchColumn:
    """A cast from or to a host type, on the host as ``cast_table`` makes
    it (the column lives there, or its result will): a host column's arrow
    values, or a device column read back whole (its padded rows, through
    ``copy_to_host``'s pinned wave), cast by ``cast_array``. A result of a
    host type stays a host column; of a device type it is uploaded as
    ``from_arrow`` uploads a column."""
    c = blocks.columns[name]
    if c.on_device:
        pad_n = blocks.padded_nrows
        whole = TorchBlocks(pad_n, {name: c}, blocks.device)
        values = host_table(copy_to_host(whole, [name]), Schema([pa.field(name, src)]))
        arr = values.column(name).combine_chunks()
    else:
        arr = c.host.combine_chunks()  # type: ignore[union-attr]
    cast = cast_array(arr, dst)
    if torch_dtype(dst) is None:
        return TorchColumn.of_host(dst, cast)
    up = from_arrow(pa.table({name: cast}), Schema([pa.field(name, dst)]),
                    blocks.device).columns[name]
    pad_n = max(blocks.padded_nrows, int(up.data.shape[0]))  # type: ignore[union-attr]
    return TorchColumn(dst, pad_rows(up.data, pad_n),  # type: ignore[arg-type]
                       None if up.mask is None else pad_rows(up.mask, pad_n), up.stats,
                       dictionary=up.dictionary)


def _from_string(c: TorchColumn, dst: pa.DataType, n: int) -> TorchColumn:
    """A string column as ``dst``: its dictionary cast on the host, then one
    K6 LUT launch by code."""
    dictionary = pa.array(list(c.dictionary), type=pa.string())  # type: ignore[arg-type]
    cast = cast_array(dictionary, dst)
    if is_string_type(dst):
        return c
    if pa.types.is_timestamp(dst):
        cast = cast.cast(pa.timestamp("us")).view(pa.int64())
    elif pa.types.is_date32(dst):
        cast = cast.view(pa.int32())
    values = to_storage(cast.fill_null(pa.scalar(0).cast(cast.type)).to_numpy(
        zero_copy_only=False), dst)
    table = np.ascontiguousarray(values.astype(_NP_DTYPES[torch_dtype(dst)]))
    if len(table) == 0:  # no value to read: every row null
        table = np.zeros((1,), dtype=table.dtype)
    codes = c.data.contiguous()
    prog = lut_program(torch.from_numpy(table).to(c.data.device), c.mask is not None)
    (values_t, mask), = expr_eval.run_lut(prog, codes, c.mask, n)
    if cast.null_count:  # an entry that casts to null: its rows' mask cleared
        ok = torch.from_numpy(cast.is_valid().to_numpy(zero_copy_only=False))
        (valid, _), = expr_eval.run_lut(lut_program(ok.to(c.data.device), False), codes,
                                        None, n)
        mask = valid if mask is None else mask & valid
    stats = None
    if table.dtype.kind in "iub" and len(table):
        stats = (int(table.min()), int(table.max()))
    return TorchColumn(dst, values_t, mask, stats)


def _to_string(blocks: TorchBlocks, name: str, src: pa.DataType) -> TorchColumn:
    """A column as strings: factorized on the card (a float by its bits),
    its segments' values formatted on the host, the segment ids re-coded
    by one K6 LUT."""
    c = blocks.columns[name]
    keys = blocks
    if c.data.is_floating_point():  # by its bits: -0.0 prints apart from 0.0
        bits = {2: pa.int16(), 4: pa.int32(), 8: pa.int64()}[c.data.element_size()]
        keys = blocks_with_columns(blocks, {name: TorchColumn(
            bits, c.data.view(torch_dtype(bits)), c.mask)})  # type: ignore[arg-type]
    fr = groupby.factorize_keys(keys, [name])
    first = fr.first_idx.clamp(0, blocks.padded_nrows - 1).to(torch.int64)
    vals = c.data.index_select(0, first).cpu().numpy()
    valid = torch.ones(fr.num_segments, dtype=torch.bool) if c.mask is None else \
        c.mask.index_select(0, first).cpu()
    if fr.occupied is not None:
        valid = valid & fr.occupied.cpu()
    valid_np = valid.numpy()
    if pa.types.is_timestamp(src):
        arr = pa.array(vals, type=pa.int64()).cast(pa.timestamp("us")).cast(src)
    elif pa.types.is_date32(src):
        arr = pa.array(vals, type=pa.int32()).cast(src)
    else:
        arr = pa.array(from_storage(vals, src), type=src)
    text = cast_array(arr, pa.string()).to_pylist()
    text = [t if ok else "" for t, ok in zip(text, valid_np)]
    dictionary, codes = np.unique(np.asarray(text, dtype=object).astype(str), return_inverse=True)
    table = np.ascontiguousarray(codes.astype(np.int32).reshape(-1))
    if len(table) == 0:
        table = np.zeros((1,), dtype=np.int32)
    prog = lut_program(torch.from_numpy(table).to(c.data.device), c.mask is not None)
    (codes_t, _), = expr_eval.run_lut(prog, fr.seg.contiguous(), c.mask, blocks.padded_nrows)
    dictionary = dictionary.astype(object)
    return TorchColumn(pa.string(), codes_t, c.mask, (0, max(len(dictionary) - 1, 0)),
                       dictionary=dictionary)


def alter_blocks(blocks: TorchBlocks, schema: Schema, new_schema: Schema) -> TorchBlocks:
    """``blocks`` (of ``schema``) with each column whose type differs in
    ``new_schema`` cast on the card."""
    cols: Dict[str, TorchColumn] = dict(blocks.columns)
    n = blocks.padded_nrows
    casts: List[str] = []
    for f_old, f_new in zip(schema.fields, new_schema.fields):
        src, dst, name = f_old.type, f_new.type, f_old.name
        if src == dst:
            continue
        c = blocks.columns[name]
        cast_array(pa.array([], type=src), dst)  # raises where arrow has no such cast
        if not c.on_device or torch_dtype(dst) is None:
            cols[name] = _host_cast(blocks, name, src, dst)
        elif c.is_string:
            cols[name] = _from_string(c, dst, n)
        elif is_string_type(dst):
            cols[name] = _to_string(blocks, name, src)
        else:
            casts.append(name)
    if casts:
        srcs = {f.name: f.type for f in schema.fields}
        dsts = {f.name: f.type for f in new_schema.fields}
        exprs = [_cast_expr(nm, srcs[nm], dsts[nm]) for nm in casts]
        results = expr_eval.evaluate(blocks, exprs, [torch_dtype(dsts[nm]) for nm in casts],
                                     expr_eval.ProgramCache())
        for nm, r in zip(casts, results):
            cols[nm] = TorchColumn(dsts[nm], r.values, r.mask, None)
    return blocks_with_columns(blocks, {f.name: cols[f.name] for f in new_schema.fields})

