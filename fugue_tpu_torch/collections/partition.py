"""``PartitionSpec``: the partition keys of a map or an aggregate.

A trimmed copy of ``fugue_tpu/collections/partition.py:58`` holding the
``by`` keys, the only part the port's slice reads.
"""

from typing import Any, List

from fugue_tpu_torch.utils.assertion import assert_or_throw


class PartitionSpec:
    """``PartitionSpec(by=["k"])``, ``PartitionSpec(["k"])``,
    ``PartitionSpec("k")`` or a copy of another spec."""

    def __init__(self, *args: Any, **kwargs: Any):
        self._partition_by: List[str] = []
        for a in args:
            self._update(a)
        if kwargs:
            self._update(kwargs)

    def _update(self, obj: Any) -> None:
        if obj is None:
            return
        if isinstance(obj, PartitionSpec):
            self._partition_by = obj.partition_by
        elif isinstance(obj, str):
            self._update(dict(by=[obj]))
        elif isinstance(obj, (list, tuple)):
            self._update(dict(by=list(obj)))
        elif isinstance(obj, dict):
            for k, v in obj.items():
                assert_or_throw(
                    k in ("by", "partition_by"),
                    SyntaxError(f"unknown partition spec key {k}"),
                )
                v = [v] if isinstance(v, str) else list(v)
                assert_or_throw(
                    len(set(v)) == len(v),
                    SyntaxError(f"duplicated keys in {v}"),
                )
                self._partition_by = v
        else:
            raise SyntaxError(f"can't interpret partition spec {obj!r}")

    @property
    def empty(self) -> bool:
        return len(self._partition_by) == 0

    @property
    def partition_by(self) -> List[str]:
        return list(self._partition_by)

    def __repr__(self) -> str:
        return f"PartitionSpec(by={self._partition_by})"
