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
bin keys without reading bounds back from the card.

String, timestamp, date, uint16-64 and float16 columns are not ported
yet (ROADMAP.md queue 1 item 1): ``from_arrow`` raises
``NotImplementedError`` for them rather than keeping them on the host.
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw

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

def torch_dtype(tp: pa.DataType) -> torch.dtype:
    """The tensor dtype of a device column of arrow type ``tp``; raises
    ``NotImplementedError`` for the types the port does not hold yet."""
    if tp not in _TORCH_DTYPES:
        raise NotImplementedError(
            f"column type {tp} is not ported to the card yet; see ROADMAP.md "
            "queue 1 item 1 (strings, temporal and wide unsigned columns)"
        )
    return _TORCH_DTYPES[tp]


def is_integer_like(tp: pa.DataType) -> bool:
    return pa.types.is_integer(tp) or pa.types.is_boolean(tp)


class TorchColumn:
    """One column: device data + optional mask (True = valid) + host-known
    ``(min, max)`` bounds of the VALID values of an integer-like column
    (a superset bound is fine). Port of ``jax_backend/blocks.py:73``."""

    def __init__(
        self,
        pa_type: pa.DataType,
        data: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        stats: Optional[Tuple[int, int]] = None,
    ):
        self.pa_type = pa_type
        self.data = data
        self.mask = mask
        self.stats = stats


def padded_len(n: int) -> int:
    """Padded row count on one device (``jax_backend/blocks.py:236`` with
    ``ndev=1``): ``n``, and 1 for an empty frame."""
    return max(n, 1)


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


def materialize_validity(
    row_valid: Optional[torch.Tensor], pad_n: int, nrows: Optional[int],
    device: torch.device,
) -> torch.Tensor:
    """The one validity convention (``jax_backend/groupby.py:40``): a
    masked frame passes its mask; a prefix frame materializes
    ``arange < nrows``."""
    if row_valid is not None:
        return row_valid
    return torch.arange(pad_n, dtype=torch.int32, device=device) < nrows


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


def _pad(arr: np.ndarray, target: int, fill: Any) -> np.ndarray:
    if arr.shape[0] == target:
        return arr
    out = np.full((target,), fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def from_arrow(table: pa.Table, schema: Schema, device: torch.device) -> TorchBlocks:
    """Arrow -> device blocks: pads rows, builds masks, captures host-side
    key stats (``jax_backend/blocks.py:405``). Null slots are filled with 0
    in the column's own type, so int64 values stay exact."""
    n = table.num_rows
    pad_n = padded_len(n)
    cols: Dict[str, TorchColumn] = {}
    for field in schema.fields:
        tdtype = torch_dtype(field.type)
        arr = table.column(field.name).combine_chunks()
        if arr.type != field.type:
            arr = arr.cast(field.type)
        mask: Optional[torch.Tensor] = None
        if arr.null_count > 0:
            valid = pc.is_valid(arr).to_numpy(zero_copy_only=False)
            mask = torch.from_numpy(_pad(valid, pad_n, False)).to(device)
            arr = pc.fill_null(arr, False if tdtype == torch.bool else 0)
        values = arr.to_numpy(zero_copy_only=False)
        stats = _int_like_stats(values)
        data = _pad(np.ascontiguousarray(values), pad_n, 0)
        if not data.flags.writeable:
            # a zero-copy view of arrow memory: the frame gets its own copy
            data = data.copy()
        cols[field.name] = TorchColumn(
            field.type, torch.from_numpy(data).to(device), mask, stats
        )
    return TorchBlocks(n, cols, device)


def to_arrow(blocks: TorchBlocks, schema: Schema) -> pa.Table:
    """Device blocks -> arrow (``jax_backend/blocks.py:491``). The host
    boundary: a masked frame is compacted here with one readback of its
    validity mask, and its lazy row count materializes."""
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
        arrays.append(pa.array(values, type=field.type, mask=null_np))
    return pa.Table.from_arrays(arrays, schema=schema.pa_schema)
