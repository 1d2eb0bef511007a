"""``to_uuid`` (copy of ``fugue_tpu/utils/hash.py:34``): deterministic
identity of column expressions, used for aggregate payload dedup."""

import hashlib
import inspect
import json
import uuid
from typing import Any


def _normalize(obj: Any) -> Any:
    """Convert an arbitrary object into a deterministic, json-able
    structure (identical specs hash identically across processes)."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, bytes):
        return obj.hex()
    if isinstance(obj, dict):
        return {
            str(k): _normalize(v)
            for k, v in sorted(obj.items(), key=lambda x: str(x[0]))
        }
    if isinstance(obj, (list, tuple)):
        return [_normalize(x) for x in obj]
    if isinstance(obj, type):
        return f"type:{obj.__module__}.{obj.__qualname__}"
    if inspect.isfunction(obj) or inspect.isbuiltin(obj):
        try:
            src = inspect.getsource(obj)
        except (OSError, TypeError):
            src = obj.__qualname__
        return f"func:{obj.__module__}.{obj.__qualname__}:{src}"
    if hasattr(obj, "__uuid__"):
        return f"uuid:{obj.__uuid__()}"
    return f"repr:{type(obj).__module__}.{type(obj).__qualname__}:{obj!r}"


def to_uuid(*args: Any) -> str:
    """Deterministic uuid string from arbitrary objects."""
    m = hashlib.md5()
    for a in args:
        m.update(
            json.dumps(_normalize(a), sort_keys=True, default=str).encode()
        )
    return str(uuid.UUID(m.hexdigest()))
