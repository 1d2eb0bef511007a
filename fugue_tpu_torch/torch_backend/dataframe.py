"""``TorchDataFrame``: a frame whose columns live as tensors on one
``torch.device`` (port of ``fugue_tpu/jax_backend/dataframe.py:33``).

Ingest is eager: the engine uploads at ``to_df``. The row count of a
masked frame (an aggregate's result) stays a 0-d device tensor until
``count()`` or an export reads it."""

import pyarrow as pa
import torch

from fugue_tpu_torch.dataframe import DataFrame
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, to_arrow


class TorchDataFrame(DataFrame):
    def __init__(self, blocks: TorchBlocks, schema: Schema):
        super().__init__(schema)
        self._blocks = blocks

    @property
    def blocks(self) -> TorchBlocks:
        return self._blocks

    @property
    def device(self) -> torch.device:
        return self._blocks.device

    @property
    def is_local(self) -> bool:
        return False

    def count(self) -> int:
        return self._blocks.nrows

    def as_arrow(self) -> pa.Table:
        return to_arrow(self._blocks, self.schema)
