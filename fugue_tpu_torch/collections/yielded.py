"""Handles of results that outlive a workflow run (a copy of
``fugue_tpu/collections/yielded.py``: ``Yielded`` ``:9``,
``PhysicalYielded`` ``:30``)."""

from typing import Any

from fugue_tpu_torch.utils.assertion import assert_or_throw


class Yielded:
    """A uuid-identified handle whose value is set when the workflow that
    produces it runs."""

    def __init__(self, yid: str):
        self._yid = yid

    def __uuid__(self) -> str:
        return self._yid

    @property
    def is_set(self) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def __copy__(self) -> "Yielded":
        return self

    def __deepcopy__(self, memo: Any) -> "Yielded":
        return self


class PhysicalYielded(Yielded):
    """A result kept in permanent storage: a file path (or a table name,
    ROADMAP.md queue 1 item 16)."""

    def __init__(self, yid: str, storage_type: str):
        super().__init__(yid)
        assert_or_throw(storage_type in ("file", "table"),
                        ValueError(f"invalid storage type {storage_type}"))
        self._storage_type = storage_type
        self._name = ""

    @property
    def is_set(self) -> bool:
        return self._name != ""

    @property
    def storage_type(self) -> str:
        return self._storage_type

    def set_value(self, name: str) -> None:
        self._name = name

    @property
    def name(self) -> str:
        assert_or_throw(self.is_set, ValueError("value is not set"))
        return self._name
