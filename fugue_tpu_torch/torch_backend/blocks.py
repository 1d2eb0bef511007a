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
each with its ``(min, max)`` stats.

Unsigned and half columns (``torch_dtype``): a uint16 is held widened to
int32 and a uint32 to int64, each zero-extended, so every kernel reads
them as the signed integers they already take (4 and 8 B a row where
arrow has 2 and 4); a uint64 is held in int64 with its sign bit flipped
(``U64_FLIP``), so a signed compare, sort, extremum or bin of the stored
word orders the values as unsigned ones and equal values stay equal;
``to_storage`` and ``from_storage`` convert at the host boundary, and
``value_bits``/``stored_words``/``value_float64`` on the card, for every
reader of a value rather than an order (see ``groupby.agg_input``). A
float16 stays float16, 2 B a row. The column's arrow type stays the
declared one.

Binary, nested (list, struct, map), decimal and null columns are HOST
columns, as in the reference (``jax_backend/blocks.py:102`` ``on_device``):
``TorchColumn.host`` holds the arrow array over the frame's row positions
and ``data`` is None. They ride through mask-only filters and pass-through
selects and are taken at the boundary by the same kept positions as the
device columns, or by index in a gather (``gather_indices``); what would
compute on one is refused by the engine (ROADMAP.md queue 1 item 2(b)).

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

from fugue_tpu_torch.kernels import U64_FLIP
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
    pa.uint16(): torch.int32,
    pa.uint32(): torch.int64,
    pa.uint64(): torch.int64,
    pa.float16(): torch.float16,
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


def torch_dtype(tp: pa.DataType) -> Optional[torch.dtype]:
    """The tensor dtype a device column of arrow type ``tp`` is stored in:
    int32 for a string's codes, a date32's days and a uint16, int64 for a
    timestamp's microseconds, a uint32 and a (flipped) uint64, float16 for
    a float16; None for a host column: binary, nested, decimal and null
    columns, as ``jax_backend/blocks.py:124`` ``is_device_type`` leaves them
    on the host."""
    if is_string_type(tp) or pa.types.is_date32(tp):
        return torch.int32
    if pa.types.is_timestamp(tp):
        return torch.int64
    return _TORCH_DTYPES.get(tp)


def is_unsigned_wide(tp: pa.DataType) -> bool:
    """A uint16-64 column, stored in a wider or flipped signed word."""
    return tp in (pa.uint16(), pa.uint32(), pa.uint64())


def to_storage(values: np.ndarray, tp: pa.DataType) -> np.ndarray:
    """Host values of arrow type ``tp`` as the card stores them: a uint64's
    sign bit flipped (a copy); others as they are (a uint16 or uint32 is
    widened where it is written into its int32 or int64 rows)."""
    if tp == pa.uint64():
        return values.view(np.int64) ^ np.int64(U64_FLIP)
    return values


def from_storage(values: np.ndarray, tp: pa.DataType) -> np.ndarray:
    """Stored values back in the numpy dtype of arrow type ``tp``."""
    if tp == pa.uint64():
        return (values ^ np.int64(U64_FLIP)).view(np.uint64)
    if tp == pa.uint32():
        return values.astype(np.uint32)
    if tp == pa.uint16():
        return values.astype(np.uint16)
    return values


def storage_scalar(v: int, tp: pa.DataType) -> int:
    """An integer value of arrow type ``tp`` as its column stores it."""
    if tp == pa.uint64():
        return int(np.int64(np.uint64(v).view(np.int64)) ^ np.int64(U64_FLIP))
    return int(v)


def value_bits(data: torch.Tensor, tp: pa.DataType) -> torch.Tensor:
    """A device column's words as its values' bits: a uint64's int64 bits
    (the stored flip undone, in a new tensor), any other column's data as
    it is. User code (transformers, cotransformers) reads these, and an
    int64 sum of them wraps as the JAX package's does."""
    return data + U64_FLIP if tp == pa.uint64() else data


def stored_words(bits: torch.Tensor, tp: pa.DataType) -> torch.Tensor:
    """``value_bits``' inverse: values' bits of arrow type ``tp`` as its
    column stores them."""
    return bits + U64_FLIP if tp == pa.uint64() else bits


def value_float64(data: torch.Tensor, tp: pa.DataType) -> torch.Tensor:
    """A device column's values in float64, each rounded once: a uint64's
    from the high and low 32 bits of its value (both exact in float64, so
    only their sum rounds); any other column's converted."""
    if tp != pa.uint64():
        return data.to(torch.float64)
    bits = data + U64_FLIP
    hi, lo = (bits >> 32) & 0xFFFFFFFF, bits & 0xFFFFFFFF
    return hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)


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
        data: Optional[torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        stats: Optional[Tuple[int, int]] = None,
        unique: bool = False,
        dictionary: Optional[np.ndarray] = None,
        host: Optional[pa.ChunkedArray] = None,
    ):
        self.pa_type = pa_type
        self.data = data
        self.mask = mask
        self.stats = stats
        self.unique = unique
        self.dictionary = dictionary
        self.host = host  # a host column's values (``data`` is None)

    @property
    def on_device(self) -> bool:
        return self.host is None

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None

    @staticmethod
    def of_host(pa_type: pa.DataType, values: Any) -> "TorchColumn":
        """A host column over arrow ``values`` (an array or a chunked
        array), one value a row position."""
        if isinstance(values, pa.Array):
            values = pa.chunked_array([values], type=pa_type)
        return TorchColumn(pa_type, None, host=values)

    def with_data(self, data: torch.Tensor, mask: Optional[torch.Tensor]) -> "TorchColumn":
        """The same logical column over other rows (a gather, a stack):
        type, stats and dictionary kept, ``unique`` dropped
        (``jax_backend/blocks.py:109``)."""
        return TorchColumn(self.pa_type, data, mask, self.stats, dictionary=self.dictionary)


def key_data(col: TorchColumn) -> torch.Tensor:
    """A key column's values as a sort reads them: a float16 as float32
    (exact, the same order), the rest as stored."""
    return col.data.float() if col.data.dtype == torch.float16 else col.data


def host_names(blocks: "TorchBlocks", names: Optional[List[str]] = None) -> List[str]:
    """The host columns among ``names`` (every column by default)."""
    return [n for n in (blocks.columns if names is None else names)
            if not blocks.columns[n].on_device]


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
            if c.on_device:
                return int(c.data.shape[0])
        if self.row_valid is not None:
            return int(self.row_valid.shape[0])
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
    hosts = host_names(blocks)
    # a host column is taken by the same rows (``jax_backend/blocks.py:636-638``)
    host_idx = pa.array(idx.cpu().numpy()) if hosts else None
    if pad != new_n:
        idx = torch.cat([idx, torch.zeros((pad - new_n,), dtype=torch.int32, device=idx.device)])
    names = [n for n in blocks.columns if n not in hosts]
    got = gather_rows([GatherColumn(blocks.columns[n].data.contiguous(),
                                    None if blocks.columns[n].mask is None
                                    else blocks.columns[n].mask.contiguous()) for n in names],
                      idx, scattered=scattered) if names else []
    taken = {n: blocks.columns[n].with_data(v, m) for n, (v, m) in zip(names, got)}
    for n in hosts:
        c = blocks.columns[n]
        taken[n] = TorchColumn.of_host(c.pa_type, c.host.take(host_idx))
    return TorchBlocks(new_n, {n: taken[n] for n in blocks.columns}, blocks.device)


def device_nbytes(blocks: TorchBlocks) -> int:
    """A frame's device footprint in bytes: column data, masks and
    ``row_valid`` (``jax_backend/blocks.py:362``)."""
    tensors = [blocks.row_valid] + [
        t for c in blocks.columns.values() if c.on_device for t in (c.data, c.mask)
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
    torch.int64: np.int64, torch.uint8: np.uint8, torch.float16: np.float16,
    torch.float32: np.float32, torch.float64: np.float64,
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
    (a bool's bits are unpacked; a uint64 is flipped into a copy, a uint16
    or uint32 is widened where ``write_rows`` writes it); a null slot then
    holds whatever arrow left there, and ``write_rows`` writes 0 in its
    place."""
    arr = _device_values(arr, tp)
    if arr.null_count == 0:
        return to_storage(arr.to_numpy(zero_copy_only=False), tp), None
    valid = pc.is_valid(arr).to_numpy(zero_copy_only=False)
    if pa.types.is_boolean(arr.type):
        return pc.fill_null(arr, False).to_numpy(zero_copy_only=False), valid
    data = np.frombuffer(arr.buffers()[1], dtype=np.dtype(arr.type.to_pandas_dtype()),
                         count=arr.offset + len(arr))
    return to_storage(data[arr.offset:], tp), valid


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
    """Arrow -> device blocks (``jax_backend/blocks.py:405``): host
    columns kept as their arrow arrays, strings as the codes of their
    ``dictionary_encode``, masks where a column has
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
        column = table.column(field.name)
        if column.type != tp:
            column = column.cast(tp)
        dtype = torch_dtype(tp)
        if dtype is None:  # a host column: kept as arrow
            cols[field.name] = TorchColumn.of_host(tp, column)
            continue
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
    return gather_indices(blocks, idx)  # host columns taken by the same positions


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
    hosts = {name: (c, c.host.slice(0, n), None) for name, c in cols.items()
             if not c.on_device}
    cols = {name: c for name, c in cols.items() if c.on_device}
    if blocks.device.type != "cuda":
        return HostRows(n, {**hosts, **{
            name: (c, c.data[:n], None if c.mask is None else c.mask[:n])
            for name, c in cols.items()}}, None)
    stream = stream or torch.cuda.current_stream(blocks.device)
    # one pinned buffer for the wave: each tensor's rows at a 64-byte
    # aligned offset
    host_cols = hosts
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
    return HostRows(n, {**host_cols, **{
        name: (c, hosts[id(c.data)], None if c.mask is None else hosts[id(c.mask)])
        for name, c in cols.items()}}, done)


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
    return pa.array(from_storage(values, tp), type=tp, mask=null_np)


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
        if not col.on_device:
            arrays.append(data.combine_chunks())
            continue
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
