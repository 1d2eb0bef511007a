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
"""

from typing import Any, Dict, Optional, Tuple

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
        """True row count; reads the card back if lazy."""
        if self._nrows is None:
            if self._nrows_dev is not None:
                self._nrows = int(self._nrows_dev)
            else:
                self._nrows = int(self.row_valid.sum())  # type: ignore
        return self._nrows

    @property
    def nrows_known(self) -> bool:
        return self._nrows is not None

    def nrows_tensor(self) -> torch.Tensor:
        """The row count as a 0-d int32 device tensor, with no readback."""
        if self._nrows is not None:
            return torch.tensor(self._nrows, dtype=torch.int32, device=self.device)
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


def _pad(arr: np.ndarray, target: int, fill: Any) -> np.ndarray:
    if arr.shape[0] == target:
        return arr
    out = np.full((target,), fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _string_column(arr: pa.Array, pad_n: int, device: torch.device) -> TorchColumn:
    """A string column as int32 codes of its ``dictionary_encode``, nulls
    as code 0 with a mask, and ``(0, len(dictionary) - 1)`` stats
    (``jax_backend/blocks.py:420-437``)."""
    enc = arr.dictionary_encode()
    indices = enc.indices
    mask: Optional[torch.Tensor] = None
    if indices.null_count > 0:
        valid = pc.is_valid(indices).to_numpy(zero_copy_only=False)
        mask = torch.from_numpy(_pad(valid, pad_n, False)).to(device)
        indices = pc.fill_null(indices, 0)
    codes = _pad(indices.to_numpy(zero_copy_only=False).astype(np.int32, copy=False), pad_n, 0)
    if not codes.flags.writeable:
        codes = codes.copy()
    dictionary = np.asarray(enc.dictionary.to_pylist(), dtype=object)
    return TorchColumn(arr.type, torch.from_numpy(codes).to(device), mask,
                       (0, max(len(dictionary) - 1, 0)), dictionary=dictionary)


def _device_values(arr: pa.Array, tp: pa.DataType) -> pa.Array:
    """A temporal column as the integers the card holds (``decode_device_values``,
    ``jax_backend/blocks.py:386-403``): a timestamp as int64 microseconds
    since the epoch, a date32 as int32 days; other columns as they are."""
    if pa.types.is_timestamp(tp):
        return arr.cast(_US).view(pa.int64())
    if pa.types.is_date32(tp):
        return arr.view(pa.int32())
    return arr


def from_arrow(table: pa.Table, schema: Schema, device: torch.device) -> TorchBlocks:
    """Arrow -> device blocks: pads rows, encodes strings, builds masks,
    captures host-side key stats and the ``unique`` flag
    (``jax_backend/blocks.py:405``). Null slots are filled with 0 in the
    column's own type, so int64 values stay exact."""
    n = table.num_rows
    pad_n = padded_len(n)
    cols: Dict[str, TorchColumn] = {}
    for field in schema.fields:
        tdtype = torch_dtype(field.type)
        arr = table.column(field.name).combine_chunks()
        if arr.type != field.type:
            arr = arr.cast(field.type)
        if is_string_type(field.type):
            cols[field.name] = _string_column(arr, pad_n, device)
            continue
        arr = _device_values(arr, field.type)
        mask: Optional[torch.Tensor] = None
        if arr.null_count > 0:
            valid = pc.is_valid(arr).to_numpy(zero_copy_only=False)
            mask = torch.from_numpy(_pad(valid, pad_n, False)).to(device)
            arr = pc.fill_null(arr, False if tdtype == torch.bool else 0)
        values = arr.to_numpy(zero_copy_only=False)
        stats = _int_like_stats(values)
        unique = _proven_unique(field.type, values, mask is not None)
        data = _pad(np.ascontiguousarray(values), pad_n, 0)
        if not data.flags.writeable:
            # a zero-copy view of arrow memory: the frame gets its own copy
            data = data.copy()
        cols[field.name] = TorchColumn(
            field.type, torch.from_numpy(data).to(device), mask, stats, unique
        )
    return TorchBlocks(n, cols, device)


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


def to_arrow(blocks: TorchBlocks, schema: Schema) -> pa.Table:
    """Device blocks -> arrow (``jax_backend/blocks.py:491``). The host
    boundary: a masked frame is compacted here with one readback of its
    validity mask, and its lazy row count materializes; string codes are
    decoded by their dictionary."""
    take: Optional[np.ndarray] = None
    if blocks.row_valid is not None:
        take = np.nonzero(blocks.row_valid.cpu().numpy())[0]
        blocks._nrows = int(take.shape[0])
        n = blocks._nrows
    else:
        n = blocks.nrows
    arrays = []
    for field in schema.fields:
        col = blocks.columns[field.name]
        full = col.data.cpu().numpy()
        values = full[take] if take is not None else full[:n]
        null_np: Optional[np.ndarray] = None
        if col.mask is not None:
            m_full = ~col.mask.cpu().numpy()
            null_np = m_full[take] if take is not None else m_full[:n]
        arrays.append(_host_array(values, null_np, col, field.type))
    return pa.Table.from_arrays(arrays, schema=schema.pa_schema)
