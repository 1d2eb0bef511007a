"""``ExtensionContext``: what every extension sees when it runs (a copy of
``fugue_tpu/extensions/context.py``; the partition cursor a host partition
loop sets is left out, as the port runs no such loop)."""

from typing import Any, Dict

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.params import ParamDict


class ExtensionContext:
    """Params, engine, partition, callback and validation rules, set by
    the workflow before the extension runs."""

    @property
    def params(self) -> ParamDict:
        return getattr(self, "_params", ParamDict())

    @property
    def workflow_conf(self) -> ParamDict:
        return getattr(self, "_workflow_conf", ParamDict())

    @property
    def execution_engine(self) -> Any:
        e = getattr(self, "_execution_engine", None)
        assert e is not None, "execution_engine not set"
        return e

    @property
    def output_schema(self) -> Schema:
        s = getattr(self, "_output_schema", None)
        assert s is not None, "output_schema not set"
        return s

    @property
    def key_schema(self) -> Schema:
        return getattr(self, "_key_schema", Schema())

    @property
    def partition_spec(self) -> PartitionSpec:
        return getattr(self, "_partition_spec", PartitionSpec())

    @property
    def has_callback(self) -> bool:
        return getattr(self, "_callback", None) is not None

    @property
    def callback(self) -> Any:
        c = getattr(self, "_callback", None)
        assert c is not None, "callback not set"
        return c

    @property
    def rpc_server(self) -> Any:
        s = getattr(self, "_rpc_server", None)
        assert s is not None, "rpc_server not set"
        return s

    @property
    def validation_rules(self) -> Dict[str, Any]:
        return {}
