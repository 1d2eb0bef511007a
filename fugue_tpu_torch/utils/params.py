"""``ParamDict``: the string-keyed dict with typed getters that carries
confs and extension parameters (a copy of ``fugue_tpu/utils/params.py``)."""

from typing import Any, Dict, Iterable, Optional, Tuple, Type, TypeVar, Union, no_type_check

T = TypeVar("T")

_BOOL_TRUE = {"true", "yes", "1", "on"}
_BOOL_FALSE = {"false", "no", "0", "off"}


def to_bool(obj: Any) -> bool:
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, (int, float)):
        return obj != 0
    if isinstance(obj, str):
        low = obj.strip().lower()
        if low in _BOOL_TRUE:
            return True
        if low in _BOOL_FALSE:
            return False
    raise ValueError(f"can't convert {obj!r} to bool")


def _convert(value: Any, ttype: Type[T]) -> T:
    if ttype is object or ttype is Any:  # type: ignore
        return value
    if isinstance(value, ttype):
        return value  # type: ignore
    if ttype is bool:
        return to_bool(value)  # type: ignore
    if ttype is int:
        if isinstance(value, str):
            return int(value.strip())  # type: ignore
        if isinstance(value, float) and value.is_integer():
            return int(value)  # type: ignore
        raise ValueError(f"can't convert {value!r} to int")
    if ttype is float:
        if isinstance(value, (int, str)):
            return float(value)  # type: ignore
        raise ValueError(f"can't convert {value!r} to float")
    if ttype is str:
        return str(value)  # type: ignore
    if issubclass(ttype, dict) and isinstance(value, dict):
        return ttype(value)  # type: ignore
    if issubclass(ttype, list) and isinstance(value, (list, tuple)):
        return ttype(value)  # type: ignore
    raise ValueError(f"can't convert {value!r} to {ttype}")


class ParamDict(Dict[str, Any]):
    """A dict, an iterable of key/value tuples or another ParamDict, with
    typed getters (``:50``)."""

    OVERWRITE = 0
    THROW = 1
    IGNORE = 2

    def __init__(self, data: Any = None, deep: bool = True):
        super().__init__()
        self.update(data, deep=deep)

    @no_type_check
    def update(self, other: Any = None, on_dup: int = 0, deep: bool = True) -> "ParamDict":
        if other is None:
            return self
        if isinstance(other, dict):
            items: Iterable[Tuple[Any, Any]] = other.items()
        elif isinstance(other, Iterable):
            items = other
        else:
            raise ValueError(f"{other!r} is not iterable or a dict")
        for k, v in items:
            if not isinstance(k, str):
                raise ValueError(f"key {k!r} is not a string")
            if k in self:
                if on_dup == ParamDict.THROW:
                    raise KeyError(f"duplicated key {k}")
                if on_dup == ParamDict.IGNORE:
                    continue
            if deep and isinstance(v, dict):
                v = dict(v)
            super().__setitem__(k, v)
        return self

    def get(self, key: Union[int, str], default: T) -> T:  # type: ignore[override]
        """The value converted to ``type(default)``; ``default`` where the
        key is missing."""
        key = self._resolve_key(key, must_exist=False)
        if key is None or key not in self:
            return default
        value = self[key]
        if default is None:
            return value
        return _convert(value, type(default))

    def get_or_none(self, key: Union[int, str], ttype: Type[T]) -> Optional[T]:
        key = self._resolve_key(key, must_exist=False)
        if key is None or key not in self:
            return None
        return _convert(self[key], ttype)

    def get_or_throw(self, key: Union[int, str], ttype: Type[T]) -> T:
        key = self._resolve_key(key, must_exist=True)
        return _convert(self[key], ttype)

    def _resolve_key(self, key: Union[int, str], must_exist: bool) -> Optional[str]:
        if isinstance(key, int):
            keys = list(self.keys())
            if 0 <= key < len(keys):
                return keys[key]
            if must_exist:
                raise KeyError(f"index {key} out of range")
            return None
        if must_exist and key not in self:
            raise KeyError(f"{key} not found")
        return key
