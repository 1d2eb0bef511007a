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
stays a 0-d device tensor until ``count()`` or an export reads it.

The rest of the frame's surface is the reference's
(``jax_backend/dataframe.py:176-330``): ``peek_array`` and ``head`` read
back only the rows they return, ``as_local`` is an ``ArrowDataFrame`` that
keeps the metadata, ``rename``, ``drop`` and ``__getitem__`` touch no
tensor, and ``alter_columns`` casts on the card (``alter.alter_blocks``)."""

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import pyarrow as pa
import torch

from fugue_tpu_torch.dataframe import ArrowDataFrame, DataFrame, LocalBoundedDataFrame
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

    def peek_array(self) -> List[Any]:
        """The first row (``jax_backend/dataframe.py:176``): one row read
        back."""
        self.assert_not_empty()
        return self.head(1).as_array(type_safe=True)[0]

    def as_local_bounded(self) -> LocalBoundedDataFrame:
        """The frame as an ``ArrowDataFrame``, its metadata kept (``:188``)."""
        res = ArrowDataFrame(self.as_arrow(), self.schema)
        if self.has_metadata:
            res.reset_metadata(self.metadata)
        return res

    def _drop_cols(self, cols: List[str]) -> DataFrame:
        return self._select_schema(self.schema.exclude(cols))

    def _select_cols(self, cols: List[str]) -> DataFrame:
        return self._select_schema(self.schema.extract(cols))

    def rename(self, columns: Dict[str, str]) -> DataFrame:
        """The frame with columns renamed (``:258``): the same columns under
        new names; a lazy frame stays lazy and a pending table is renamed on
        the host."""
        schema = self.schema.rename(columns)
        mapping, names = dict(columns), schema.names
        if self._blocks is None and self._lazy is not None:
            lazy = self._lazy
            return TorchDataFrame.from_lazy(
                lambda: _rename_blocks(lazy.load_blocks(), mapping),
                lambda: lazy.load_table().rename_columns(names), self._device, schema,
                lazy.nrows, lambda n: lazy.load_head(n).rename_columns(names),
                lambda sel: lazy.narrow([_inverse(mapping, x) for x in sel]).rename(
                    {_inverse(mapping, x): x for x in sel}))
        if self._blocks is None:
            assert self._pending is not None
            return TorchDataFrame._of_pending(self._pending.rename_columns(names), schema,
                                              self._device)
        return TorchDataFrame(_rename_blocks(self._blocks, mapping), schema)

    def alter_columns(self, columns: Any) -> DataFrame:
        """The frame with some columns cast (``:292``), computed on the card
        (``alter.alter_blocks``)."""
        from fugue_tpu_torch.torch_backend.alter import alter_blocks

        schema = self.schema.alter(columns)
        if schema == self.schema:
            return self
        return TorchDataFrame(alter_blocks(self.blocks, self.schema, schema), schema)

    @staticmethod
    def _of_pending(table: pa.Table, schema: Schema, device: torch.device) -> "TorchDataFrame":
        res = TorchDataFrame.__new__(TorchDataFrame)
        DataFrame.__init__(res, schema)
        res._blocks, res._device, res._lazy = None, device, None
        res._pending = table
        return res

    def as_arrow(self, type_safe: bool = False) -> pa.Table:
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

    def head(self, n: int, columns: Optional[List[str]] = None) -> LocalBoundedDataFrame:
        """The first ``n`` rows (of ``columns``) as an ``ArrowDataFrame``
        (``jax_backend/dataframe.py:300``): of a lazy frame, only the
        leading batches read; of a masked frame, the first ``n`` kept rows
        gathered on the device before their export."""
        assert_or_throw(n >= 0, ValueError("n must be >= 0"))
        src = self if columns is None else self._select_schema(self.schema.extract(columns))
        if src._lazy is not None:
            table = src._lazy.load_head(n)
        elif src._blocks is None:
            table = src.as_arrow().slice(0, n)
        else:
            table = to_arrow(leading_rows(src._blocks, n), src.schema)
        return ArrowDataFrame(table, src.schema)

    def _select_schema(self, schema: Schema) -> "TorchDataFrame":
        """The columns of ``schema`` (``jax_backend/dataframe.py:222``):
        of a lazy frame, its load re-planned over those columns only."""
        names = list(schema.names)
        if self._lazy is not None:
            return self._lazy.narrow(names)
        if self._blocks is None:
            assert self._pending is not None
            return TorchDataFrame._of_pending(self._pending.select(names), schema, self._device)
        return TorchDataFrame(_subset_blocks(self._blocks, names), schema)


def _subset_blocks(blocks: TorchBlocks, names: List[str]) -> TorchBlocks:
    return TorchBlocks(blocks._nrows, {n: blocks.columns[n] for n in names}, blocks.device,
                       row_valid=blocks.row_valid, nrows_dev=blocks._nrows_dev)



def _rename_blocks(blocks: TorchBlocks, mapping: Dict[str, str]) -> TorchBlocks:
    """The same columns under new names (``jax_backend/dataframe.py:342``)."""
    return TorchBlocks(blocks._nrows, {mapping.get(n, n): c for n, c in blocks.columns.items()},
                       blocks.device, row_valid=blocks.row_valid, nrows_dev=blocks._nrows_dev)


def _inverse(mapping: Dict[str, str], name: str) -> str:
    """The old name of a renamed column ``name``."""
    for old, new in mapping.items():
        if new == name:
            return old
    return name
