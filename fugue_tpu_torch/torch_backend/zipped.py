"""``TorchZippedDataFrame``: the co-partition a zip records (port of
``fugue_tpu/jax_backend/zipped.py:38-131``).

Zipping does no work: the handle holds the member frames as they are on
the card, their names, the zip type, the keys with their schema and the
partition spec. Its one consumer is ``TorchExecutionEngine.comap``
(``compiled_comap``), which co-factorizes the members' keys and runs the
cotransformer once over whole columns. Every other frame operation
raises, as in the original. The JAX package's serialized zip (partitions
pickled into blob rows, ``fugue_tpu/execution/execution_engine.py:969``)
and its host group loop (``zipped.device_comap``) are host work, not
ported (ROADMAP.md queue 1 item 2(b))."""

from typing import Any, Dict, List

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.utils.hash import to_uuid

_FUGUE_SER_NO = "_fugue_ser_no"  # ``fugue_tpu/execution/execution_engine.py:43``
_ONLY_COMAP = "a zipped dataframe only supports comap/cotransform (transform of the zip)"


class TorchZippedDataFrame:
    """A co-partition handle over frames on one device (not a frame: its
    only consumer is ``TorchExecutionEngine.comap``). A cross zip has no
    keys; its schema is the serialized path's marker column, since a frame
    schema cannot be empty (the original's choice)."""

    def __init__(
        self,
        frames: List[TorchDataFrame],
        names: List[str],
        how: str,
        keys: List[str],
        key_schema: Schema,
        zip_spec: PartitionSpec,
    ):
        self.schema = key_schema if key_schema.names else Schema([(_FUGUE_SER_NO, "int")])
        self.key_schema = key_schema
        self.frames = frames
        self.names = names
        self.how = how
        self.keys = keys
        self.zip_spec = zip_spec

    def __uuid__(self) -> str:
        """The zip's identity in a workflow's task ids: its members' own
        (``DataFrame.__uuid__``), names, zip type, keys and partition spec."""
        return to_uuid([f.__uuid__() for f in self.frames], self.names, self.how, self.keys,
                       self.zip_spec.__uuid__())

    def count(self) -> int:
        raise NotImplementedError(_ONLY_COMAP)

    def as_arrow(self) -> Any:
        raise NotImplementedError(_ONLY_COMAP)

    def as_pandas(self) -> Any:
        raise NotImplementedError(_ONLY_COMAP)

    def peek_array(self) -> List[Any]:
        raise NotImplementedError(_ONLY_COMAP)

    def rename(self, columns: Dict[str, str]) -> Any:
        raise NotImplementedError(_ONLY_COMAP)

    def head(self, n: int, columns: Any = None) -> Any:
        raise NotImplementedError(_ONLY_COMAP)
