"""Device block layer: a frame's columns as tensors on one ``torch.device``.

The port of ``fugue_tpu/jax_backend/blocks.py``. Numeric and bool columns
are tensors on the engine's device, with a bool validity mask (True =
valid) when the column has nulls; null slots hold 0. Rows are padded to
``padded_len`` (one device: a frame of 0 rows keeps one padding row, so
no tensor is empty). Row membership has the original's two layouts:
*prefix* (rows ``[0, nrows)`` are real) and *masked* (a bool ``row_valid``
tensor marks real rows, produced by the aggregate). A masked frame's row
count may be LAZY: a 0-d device tensor read back only when the host needs
the number.

Integer-like columns carry host-known ``(min, max)`` ``stats`` captured at
ingest and carried through passthrough map outputs, so the group-by can
bin keys without reading bounds back from the card. An integer column
that ingest proves strictly increasing is ``unique``, which lets a join
against it take the sync-free unique-right route.

String columns are dictionary-coded as in the original: int32 codes on
the card (a null row holds code 0 and is flagged in the mask) and the
decode table, ``dictionary``, on the host; their stats are ``(0,
len(dictionary) - 1)``, so a string key bins with no readback. A
timestamp is int64 microseconds since the epoch and a date32 int32 days,
each with its ``(min, max)`` stats. uint16-64, float16, binary, nested
and decimal columns are not ported yet (ROADMAP.md queue 1 item 1):
``from_arrow`` raises ``NotImplementedError`` naming the type's case
rather than keeping them on the host.

The host boundary: ``from_arrow`` writes each column once into a pinned
buffer (padding included) and ships it with one non-blocking copy;
``to_arrow`` compacts a masked frame on the card (``leading_rows``: one
readback of the count, K10 over every column and mask), then reads every
column back in one wave of non-blocking copies into one pinned buffer,
exactly the frame's rows a column (``copy_to_host``), and builds the
table over it after one synchronize (``host_table``). The table keeps
that pinned buffer as its own memory, so no later export can reuse it
while the table lives. On the CPU no pinned memory is used: the columns'
own tensors are written and read.
"""

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from fugue_tpu_torch.kernels.gather import gather_rows
from fugue_tpu_torch.kernels.reference import GatherColumn
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw
from fugue_tpu_torch.utils.validity import materialize_validity

_TORCH_DTYPES: Dict[pa.DataType, torch.dtype] = {
    pa.bool_(): torch.bool,
    pa.int8(): torch.int8,
    pa.int16(): torch.int16,
    pa.int32(): torch.int32,
    pa.int64(): torch.int64,
    pa.uint8(): torch.uint8,
    pa.float32(): torch.float32,
    pa.float64(): torch.float64,
}

_US = pa.timestamp("us")


def is_string_type(tp: pa.DataType) -> bool:
    return pa.types.is_string(tp) or pa.types.is_large_string(tp)


def is_temporal(tp: pa.DataType) -> bool:
    """A timestamp (int64 microseconds on the card) or a date32 (int32
    days)."""
    return pa.types.is_timestamp(tp) or pa.types.is_date32(tp)


def torch_dtype(tp: pa.DataType) -> torch.dtype:
    """The tensor dtype of a device column of arrow type ``tp``: int32 for
    a string's codes and a date32's days, int64 for a timestamp's
    microseconds. Raises ``NotImplementedError`` for the types the port
    does not hold yet."""
    if is_string_type(tp) or pa.types.is_date32(tp):
        return torch.int32
    if pa.types.is_timestamp(tp):
        return torch.int64
    if tp not in _TORCH_DTYPES:
        raise NotImplementedError(
            f"column type {tp} is not ported to the card yet ({_unported_case(tp)}); "
            "see ROADMAP.md queue 1 item 1"
        )
    return _TORCH_DTYPES[tp]


def _unported_case(tp: pa.DataType) -> str:
    """Which of ROADMAP.md queue 1 item 1's cases a refused type is."""
    if pa.types.is_unsigned_integer(tp) or pa.types.is_float16(tp):
        return "a uint16-64 or float16 column"
    if pa.types.is_binary(tp) or pa.types.is_large_binary(tp) or \
            pa.types.is_fixed_size_binary(tp):
        return "a binary column, which the reference keeps on the host"
    if pa.types.is_nested(tp):
        return "a nested (list, struct or map) column, which the reference keeps on the host"
    if pa.types.is_decimal(tp):
        return "a decimal column, which the reference keeps on the host"
    if pa.types.is_null(tp):
        return "a column of arrow's null type"
    return f"a {tp} column"


def is_integer_like(tp: pa.DataType) -> bool:
    return pa.types.is_integer(tp) or pa.types.is_boolean(tp)


def keeps_stats(tp: pa.DataType) -> bool:
    """Whether a column of type ``tp`` holds integer-like values whose
    ``(min, max)`` the group-by bins by: integers, bools, temporal values
    and string codes."""
    return is_integer_like(tp) or is_temporal(tp) or is_string_type(tp)


class TorchColumn:
    """One column: device data + optional mask (True = valid) + host-known
    ``(min, max)`` bounds of the VALID values of an integer-like column
    (a superset bound is fine) + ``unique``: no two real rows hold the same
    value, proven on the host at ingest + ``dictionary``, the host decode
    table of a string column's int32 codes (an object ``np.ndarray``).
    Port of ``jax_backend/blocks.py:73``."""

    def __init__(
        self,
        pa_type: pa.DataType,
        data: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        stats: Optional[Tuple[int, int]] = None,
        unique: bool = False,
        dictionary: Optional[np.ndarray] = None,
    ):
        self.pa_type = pa_type
        self.data = data
        self.mask = mask
        self.stats = stats
        self.unique = unique
        self.dictionary = dictionary

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None

    def with_data(self, data: torch.Tensor, mask: Optional[torch.Tensor]) -> "TorchColumn":
        """The same logical column over other rows (a gather, a stack):
        type, stats and dictionary kept, ``unique`` dropped
        (``jax_backend/blocks.py:109``)."""
        return TorchColumn(self.pa_type, data, mask, self.stats, dictionary=self.dictionary)


def padded_len(n: int) -> int:
    """Padded row count on one device (``jax_backend/blocks.py:236`` with
    ``ndev=1``): ``n``, and 1 for an empty frame."""
    return max(n, 1)


def pad_rows(v: torch.Tensor, target: int) -> torch.Tensor:
    """``v`` with its row axis zero-padded to ``target``
    (``jax_backend/execution_engine.py:3814``)."""
    n = int(v.shape[0])
    if n == target:
        return v
    return torch.cat([v, torch.zeros((target - n,), dtype=v.dtype, device=v.device)])


class TorchBlocks:
    """All columns of a frame + row membership. Port of
    ``jax_backend/blocks.py:255``.

    Invariant: either ``row_valid`` is a bool tensor over the padded rows
    (masked layout; ``nrows`` may be lazy, a pending 0-d device tensor),
    or ``row_valid`` is None and ``nrows`` is a known int with prefix
    layout (rows ``[0, nrows)`` real)."""

    def __init__(
        self,
        nrows: Optional[int],
        columns: Dict[str, TorchColumn],
        device: torch.device,
        row_valid: Optional[torch.Tensor] = None,
        nrows_dev: Optional[torch.Tensor] = None,
    ):
        assert_or_throw(
            nrows is not None or row_valid is not None,
            ValueError("lazy nrows requires a row_valid mask"),
        )
        self._nrows = nrows
        self._nrows_dev = nrows_dev
        self.columns = columns
        self.device = device
        self.row_valid = row_valid
        # key factorizations of this frame by key tuple
        # (groupby.factorize_keys; jax_backend/blocks.py:281)
        self.factorize_cache: Dict[Any, Any] = {}

    @property
    def nrows(self) -> int:
        """True row count; reads the card back if lazy (``read_scalar``)."""
        if self._nrows is None:
            self._nrows = read_scalar(self._nrows_dev if self._nrows_dev is not None
                                      else self.row_valid.sum())  # type: ignore[union-attr]
        return self._nrows

    @property
    def nrows_known(self) -> bool:
        return self._nrows is not None

    def nrows_tensor(self) -> torch.Tensor:
        """The row count as a 0-d int32 device tensor, with no readback."""
        if self._nrows is not None:  # a fill, not a copy from the host
            return torch.full((), self._nrows, dtype=torch.int32, device=self.device)
        if self._nrows_dev is not None:
            return self._nrows_dev.to(torch.int32)
        return self.row_valid.sum().to(torch.int32)  # type: ignore

    @property
    def padded_nrows(self) -> int:
        for c in self.columns.values():
            return int(c.data.shape[0])
        return padded_len(self.nrows)

    def validity(self) -> torch.Tensor:
        """Bool tensor over padded rows: True = real row."""
        return materialize_validity(
            self.row_valid, self.padded_nrows, self._nrows, self.device
        )


def read_scalar(t: torch.Tensor) -> int:
    """A 0-d integer tensor's value. On the card it is copied into a pinned
    scalar and the current stream waited for (a copy to pageable memory,
    as ``int(t)`` makes, is staged through the driver's own buffer)."""
    if t.device.type != "cuda":
        return int(t)
    host = torch.empty((), dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return int(host)


def blocks_with_columns(blocks: TorchBlocks, columns: Dict[str, TorchColumn]) -> TorchBlocks:
    """A new column set over the same rows, a lazy count included
    (``jax_backend/execution_engine.py:3724``)."""
    return TorchBlocks(
        blocks._nrows, columns, blocks.device, row_valid=blocks.row_valid,
        nrows_dev=blocks._nrows_dev,
    )


def gather_indices(blocks: TorchBlocks, idx: torch.Tensor, scattered: bool = False
                   ) -> TorchBlocks:
    """Every column of the frame at the rows ``idx`` (an integer tensor of
    real rows), as a prefix frame of ``len(idx)`` rows
    (``jax_backend/blocks.py:620``, ``_gather_program`` ``:652``): all the
    columns and masks through K10 ``gather_rows`` (one launch for up to
    ``gather.MAX_COLUMNS`` columns; its twin on the CPU), types, stats and
    dictionaries kept. Padding rows repeat index 0, as there.
    ``scattered``: ``idx`` reads the rows at random (a permutation, a hash
    or sort order), which lets K10 take its slab route."""
    new_n = int(idx.shape[0])
    pad = padded_len(new_n)
    idx = idx.to(device=blocks.device, dtype=torch.int32)
    if pad != new_n:
        idx = torch.cat([idx, torch.zeros((pad - new_n,), dtype=torch.int32, device=idx.device)])
    names = list(blocks.columns)
    got = gather_rows([GatherColumn(blocks.columns[n].data.contiguous(),
                                    None if blocks.columns[n].mask is None
                                    else blocks.columns[n].mask.contiguous()) for n in names],
                      idx, scattered=scattered)
    cols = {n: blocks.columns[n].with_data(v, m) for n, (v, m) in zip(names, got)}
    return TorchBlocks(new_n, cols, blocks.device)


def device_nbytes(blocks: TorchBlocks) -> int:
    """A frame's device footprint in bytes: column data, masks and
    ``row_valid`` (``jax_backend/blocks.py:362``)."""
    tensors = [blocks.row_valid] + [
        t for c in blocks.columns.values() for t in (c.data, c.mask)
    ]
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _int_like_stats(values: np.ndarray) -> Optional[Tuple[int, int]]:
    """Host-side ``(min, max)`` of null-filled integer-like ingest data
    (``jax_backend/blocks.py:371``): a superset bound of the valid values,
    which is what bin factorization needs."""
    if values.size == 0:
        return (0, 0)
    if values.dtype == np.bool_:
        return (0, 1)
    if values.dtype.kind in "iu":
        return (int(values.min()), int(values.max()))
    return None


_UNIQUE_CHECK_MAX = 4_000_000  # the host check runs only up to dimension-table sizes


def _proven_unique(tp: pa.DataType, values: np.ndarray, has_nulls: bool) -> bool:
    """An integer column with no nulls and ``0 < n <= _UNIQUE_CHECK_MAX``
    rows whose values strictly increase (``jax_backend/blocks.py:461-476``):
    the surrogate key of a dimension table. By an element-wise compare, not
    ``np.diff``, whose subtraction wraps for unsigned and extreme values."""
    n = int(values.shape[0])
    if has_nulls or not pa.types.is_integer(tp) or not 0 < n <= _UNIQUE_CHECK_MAX:
        return False
    return bool((values[1:] > values[:-1]).all())




_NP_DTYPES: Dict[torch.dtype, Any] = {
    torch.bool: np.bool_, torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
    torch.int64: np.int64, torch.uint8: np.uint8, torch.float32: np.float32,
    torch.float64: np.float64,
}


def _device_values(arr: pa.Array, tp: pa.DataType) -> pa.Array:
    """A temporal column as the integers the card holds (``decode_device_values``,
    ``jax_backend/blocks.py:386-403``): a timestamp as int64 microseconds
    since the epoch, a date32 as int32 days; other columns as they are."""
    if pa.types.is_timestamp(tp):
        return arr.cast(_US).view(pa.int64())
    if pa.types.is_date32(tp):
        return arr.view(pa.int32())
    return arr


def device_values(arr: pa.Array, tp: pa.DataType) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A column of arrow type ``tp`` (not a string) as the card holds it:
    its values as a numpy array of the column's tensor dtype, and its
    validity where it has nulls (``jax_backend/blocks.py:438-455``). The
    values are a view of arrow's buffer where arrow's layout is the card's
    (a bool's bits are unpacked); a null slot then holds whatever arrow
    left there, and ``write_rows`` writes 0 in its place."""
    arr = _device_values(arr, tp)
    if arr.null_count == 0:
        return arr.to_numpy(zero_copy_only=False), None
    valid = pc.is_valid(arr).to_numpy(zero_copy_only=False)
    if pa.types.is_boolean(arr.type):
        return pc.fill_null(arr, False).to_numpy(zero_copy_only=False), valid
    data = np.frombuffer(arr.buffers()[1], dtype=_NP_DTYPES[torch_dtype(tp)],
                         count=arr.offset + len(arr))
    return data[arr.offset:], valid


def write_rows(dst: np.ndarray, values: np.ndarray, valid: Optional[np.ndarray]) -> None:
    """``values`` into ``dst`` (as many rows), 0 where ``valid`` is False."""
    dst[...] = values
    if valid is not None:
        dst[~valid] = 0


def _host_rows(pad_n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A column's staging rows: pinned memory for the card, on the CPU the
    column's own tensor."""
    return torch.empty((pad_n,), dtype=dtype, pin_memory=device.type == "cuda")


def _ship(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The staged rows on ``device``: on the card one non-blocking copy on
    the current stream (PyTorch's pinned cache takes the buffer back once
    the copy is done), on the CPU the tensor itself."""
    if device.type != "cuda":
        return host
    data = torch.empty(host.shape, dtype=host.dtype, device=device)
    data.copy_(host, non_blocking=True)
    return data


def from_arrow(table: pa.Table, schema: Schema, device: torch.device) -> TorchBlocks:
    """Arrow -> device blocks (``jax_backend/blocks.py:405``): strings as
    the codes of their ``dictionary_encode``, masks where a column has
    nulls (a null slot holds 0 in the column's own type, so int64 values
    stay exact), host-side key stats and the ``unique`` flag. Each column
    and mask is written once, chunk by chunk, into its staging rows
    (pinned memory for the card; the padding written there too) and
    shipped with no wait; ``persist`` waits for the upload."""
    n = table.num_rows
    pad_n = padded_len(n)
    cols: Dict[str, TorchColumn] = {}
    for field in schema.fields:
        tp = field.type
        dtype = torch_dtype(tp)  # raises for a type the card does not hold
        column = table.column(field.name)
        if column.type != tp:
            column = column.cast(tp)
        dictionary: Optional[np.ndarray] = None
        if is_string_type(tp):  # jax_backend/blocks.py:420-437
            enc = column.combine_chunks().dictionary_encode()
            parts = [device_values(enc.indices, pa.int32())]
            dictionary = np.asarray(enc.dictionary.to_pylist(), dtype=object)
        else:
            parts = [device_values(chunk, tp) for chunk in column.chunks]
        data = _host_rows(pad_n, dtype, device)
        view = data.numpy()
        mask = None
        if any(valid is not None for _, valid in parts):
            mask = _host_rows(pad_n, torch.bool, device)
            mask.numpy()[n:] = False
        at = 0
        for values, valid in parts:
            write_rows(view[at:at + len(values)], values, valid)
            if mask is not None:
                mask.numpy()[at:at + len(values)] = True if valid is None else valid
            at += len(values)
        view[n:] = 0
        stats = (0, max(len(dictionary) - 1, 0)) if dictionary is not None else \
            _int_like_stats(view[:n])
        unique = dictionary is None and _proven_unique(tp, view[:n], mask is not None)
        cols[field.name] = TorchColumn(tp, _ship(data, device),
                                       None if mask is None else _ship(mask, device), stats,
                                       unique, dictionary)
    return TorchBlocks(n, cols, device)


def leading_rows(blocks: TorchBlocks, n: Optional[int] = None) -> TorchBlocks:
    """The frame's first ``n`` real rows (all of them by default) as a
    prefix frame, in order. A masked frame is compacted on its device: its
    kept positions by ``torch.nonzero`` (one readback, the kept count,
    which also materializes a lazy row count), then one K10 launch a
    ``gather.MAX_COLUMNS`` columns with their masks (``gather_indices``,
    direct route). A prefix frame's columns are not copied."""
    if blocks.row_valid is None:
        return TorchBlocks(blocks.nrows if n is None else min(n, blocks.nrows), blocks.columns,
                           blocks.device)
    idx = torch.nonzero(blocks.row_valid).flatten()
    blocks._nrows = int(idx.shape[0])
    if n is not None:
        idx = idx[:n]
    if not blocks.columns:
        return TorchBlocks(int(idx.shape[0]), {}, blocks.device)
    return gather_indices(blocks, idx)


class HostRows(NamedTuple):
    """Rows ``[0, nrows)`` of a prefix frame's columns in host memory:
    ``columns[name]`` = (the column, its data, its mask or None); ``done``
    is the CUDA event recorded after the copies (None on the CPU)."""

    nrows: int
    columns: Dict[str, Tuple[TorchColumn, torch.Tensor, Optional[torch.Tensor]]]
    done: Optional[Any]


def copy_to_host(blocks: TorchBlocks, names: List[str],
                 stream: Optional[Any] = None) -> HostRows:
    """Starts the read-back of a prefix frame's columns ``names``. On the
    card each column and mask gets exactly ``nrows`` rows of one pinned
    buffer, filled by one wave of non-blocking copies on ``stream`` (the
    current stream by default), with one event after the wave; nothing
    waits here. On the CPU the host rows are the columns' own."""
    assert_or_throw(blocks.row_valid is None, ValueError("copy_to_host takes a prefix frame"))
    n = blocks.nrows
    cols = {name: blocks.columns[name] for name in names}
    if blocks.device.type != "cuda":
        return HostRows(n, {name: (c, c.data[:n], None if c.mask is None else c.mask[:n])
                            for name, c in cols.items()}, None)
    stream = stream or torch.cuda.current_stream(blocks.device)
    # one pinned buffer for the wave: each tensor's rows at a 64-byte
    # aligned offset
    tensors = [t for c in cols.values() for t in (c.data, c.mask) if t is not None]
    sizes = [-(-n * t.element_size() // 64) * 64 for t in tensors]
    buf = torch.empty((max(sum(sizes), 1),), dtype=torch.uint8, pin_memory=True)
    hosts: Dict[int, torch.Tensor] = {}
    at = 0
    with torch.cuda.stream(stream):
        for t, size in zip(tensors, sizes):
            host = buf[at:at + n * t.element_size()].view(t.dtype)
            host.copy_(t[:n], non_blocking=True)
            hosts[id(t)] = host
            at += size
        done = torch.cuda.Event()
        done.record(stream)
    return HostRows(n, {name: (c, hosts[id(c.data)],
                               None if c.mask is None else hosts[id(c.mask)])
                        for name, c in cols.items()}, done)


def _host_array(values: np.ndarray, null_np: Optional[np.ndarray], col: TorchColumn,
                tp: pa.DataType) -> pa.Array:
    """One column's host values as arrow of type ``tp``: a string through
    ``DictionaryArray.from_arrays(codes, dictionary).cast(tp)``
    (``jax_backend/blocks.py:531-541``), a timestamp or date through its
    integers' cast (``:543-560``)."""
    if col.is_string:
        indices = pa.array(values.astype(np.int32, copy=False), mask=null_np)
        dictionary = pa.array(col.dictionary, type=pa.string())
        return pa.DictionaryArray.from_arrays(indices, dictionary).cast(tp)
    if pa.types.is_timestamp(tp):
        return pa.array(values, type=pa.int64(), mask=null_np).cast(_US).cast(tp)
    if pa.types.is_date32(tp):
        return pa.array(values, type=pa.int32(), mask=null_np).cast(tp)
    return pa.array(values, type=tp, mask=null_np)


def host_table(rows: HostRows, schema: Schema) -> pa.Table:
    """Waits for ``rows``' copies (one synchronize), then builds the arrow
    table over the host tensors: numbers without a copy, a mask as nulls,
    strings decoded by their dictionary, temporal columns from their
    integers. The table owns the pinned tensors it was built on, so no
    later export reuses them while it lives; dropping it gives them back
    to PyTorch's pinned cache."""
    if rows.done is not None:
        rows.done.synchronize()
    arrays = []
    for field in schema.fields:
        col, data, mask = rows.columns[field.name]
        null_np = None if mask is None else ~mask.numpy()
        arrays.append(_host_array(data.numpy(), null_np, col, field.type))
    return pa.Table.from_arrays(arrays, schema=schema.pa_schema)


def to_arrow(blocks: TorchBlocks, schema: Schema) -> pa.Table:
    """Device blocks -> arrow, the host boundary (``jax_backend/blocks.py:491``):
    a masked frame is compacted on its device first (``leading_rows``),
    then every column and mask is read back in one wave of copies into
    pinned memory and the table built after one synchronize
    (``copy_to_host``, ``host_table``)."""
    return host_table(copy_to_host(leading_rows(blocks), schema.names), schema)
