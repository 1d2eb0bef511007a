"""``TorchDataFrame``: a frame whose columns live as tensors on one
``torch.device`` (port of ``fugue_tpu/jax_backend/dataframe.py:33``).

``to_df`` uploads at once. A frame that ``load_df`` streams is LAZY
(``from_lazy``, ``jax_backend/dataframe.py:74``): it stays in storage
until a device operation first touches ``blocks``, which then streams
its record batches to the device; ``count`` comes from the files'
metadata, ``as_arrow`` reads the files on the host with no device trip
(and keeps the table, which a later ``blocks`` uploads), ``head`` reads
only the leading batches, and a select of bare columns narrows the load
at the source. The row count of a masked frame (an aggregate's result)
stays a 0-d device tensor until ``count()`` or an export reads it."""

from typing import Callable, List, NamedTuple, Optional

import pyarrow as pa
import torch

from fugue_tpu_torch.dataframe import DataFrame
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend.blocks import (
    TorchBlocks,
    from_arrow,
    leading_rows,
    to_arrow,
)
from fugue_tpu_torch.utils.assertion import assert_or_throw


class _LazyState(NamedTuple):
    """Loaders of a frame still in storage (``jax_backend/dataframe.py:22``)."""

    load_blocks: Callable[[], TorchBlocks]  # streams the batches to the device
    load_table: Callable[[], pa.Table]  # reads the files on the host
    nrows: int  # from the files' metadata
    load_head: Callable[[int], pa.Table]  # reads only leading batches
    narrow: Callable[[List[str]], "TorchDataFrame"]  # the load of fewer columns


class TorchDataFrame(DataFrame):
    def __init__(self, blocks: TorchBlocks, schema: Schema):
        super().__init__(schema)
        self._blocks: Optional[TorchBlocks] = blocks
        self._device = blocks.device
        self._lazy: Optional[_LazyState] = None
        self._pending: Optional[pa.Table] = None  # read on the host, not uploaded

    @staticmethod
    def from_lazy(load_blocks: Callable[[], TorchBlocks], load_table: Callable[[], pa.Table],
                  device: torch.device, schema: Schema, nrows: int,
                  load_head: Callable[[int], pa.Table],
                  narrow: Callable[[List[str]], "TorchDataFrame"]) -> "TorchDataFrame":
        """A frame still in storage (``jax_backend/dataframe.py:74``):
        ``load_blocks()`` when a device operation first needs it,
        ``load_table()`` for a host read, ``load_head(n)`` for the first
        ``n`` rows, ``narrow(names)`` for the load of fewer columns."""
        res = TorchDataFrame.__new__(TorchDataFrame)
        DataFrame.__init__(res, schema)
        res._blocks = None
        res._device = device
        res._lazy = _LazyState(load_blocks, load_table, nrows, load_head, narrow)
        res._pending = None
        return res

    @property
    def is_pending(self) -> bool:
        """True while the frame has no device copy yet."""
        return self._blocks is None

    @property
    def blocks(self) -> TorchBlocks:
        """The device blocks, loaded on first touch: a lazy frame streams
        its batches, a frame read on the host uploads its table."""
        if self._blocks is None:
            if self._lazy is not None:
                self._blocks = self._lazy.load_blocks()
                self._lazy = None
            else:
                assert self._pending is not None
                self._blocks = from_arrow(self._pending, self.schema, self._device)
                self._pending = None
        return self._blocks

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def is_local(self) -> bool:
        return False

    def count(self) -> int:
        if self._blocks is not None:
            return self._blocks.nrows
        if self._lazy is not None:
            return self._lazy.nrows
        assert self._pending is not None
        return self._pending.num_rows

    def as_arrow(self) -> pa.Table:
        """The frame in host memory (``jax_backend/dataframe.py:195``): the
        device copy through ``to_arrow``; a lazy frame's files read on the
        host, the table kept for a later touch."""
        if self._blocks is not None:
            return to_arrow(self._blocks, self.schema)
        if self._lazy is not None:
            self._pending = self._lazy.load_table()
            self._lazy = None
        assert self._pending is not None
        return self._pending

    def head(self, n: int, columns: Optional[List[str]] = None) -> pa.Table:
        """The first ``n`` rows (of ``columns``) as an arrow table
        (``jax_backend/dataframe.py:300``): of a lazy frame, only the
        leading batches read; of a masked frame, the first ``n`` kept rows
        gathered on the device before their export."""
        assert_or_throw(n >= 0, ValueError("n must be >= 0"))
        src = self if columns is None else self._select_schema(self.schema.extract(columns))
        if src._lazy is not None:
            return src._lazy.load_head(n)
        if src._blocks is None:
            return src.as_arrow().slice(0, n)
        return to_arrow(leading_rows(src._blocks, n), src.schema)

    def _select_schema(self, schema: Schema) -> "TorchDataFrame":
        """The columns of ``schema`` (``jax_backend/dataframe.py:222``):
        of a lazy frame, its load re-planned over those columns only."""
        names = list(schema.names)
        if self._lazy is not None:
            return self._lazy.narrow(names)
        if self._blocks is None:
            assert self._pending is not None
            res = TorchDataFrame.__new__(TorchDataFrame)
            DataFrame.__init__(res, schema)
            res._blocks, res._device, res._lazy = None, self._device, None
            res._pending = self._pending.select(names)
            return res
        return TorchDataFrame(_subset_blocks(self._blocks, names), schema)


def _subset_blocks(blocks: TorchBlocks, names: List[str]) -> TorchBlocks:
    return TorchBlocks(blocks._nrows, {n: blocks.columns[n] for n in names}, blocks.device,
                       row_valid=blocks.row_valid, nrows_dev=blocks._nrows_dev)

