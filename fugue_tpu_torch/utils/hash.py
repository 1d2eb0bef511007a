"""``to_uuid`` (copy of ``fugue_tpu/utils/hash.py:8-39``): deterministic
identity of column expressions (aggregate payload dedup) and of workflow
tasks (deterministic checkpoints).

One departure: the reference hashes a pandas frame or an arrow table by
``repr``, which shows only the first and last rows of a long frame, so
two frames that differ in between share a task id there (ROADMAP.md
queue 3). Here such an object has an id of its own, drawn once, as a
frame of the port has (``__uuid__``): no pass over its rows at each task
id. A deterministic checkpoint, which outlives the object, hashes the
rows themselves (``content_digest``, ``FugueTask.content_uuid``)."""

import hashlib
import inspect
import json
import uuid
import weakref
from typing import Any, Dict

import pandas as pd
import pyarrow as pa

# a function's identity string by the function, while it runs the code it
# was read for: the source is read once, not at every task id (the
# reference reads it each time, a tokenizing pass over the function)
_FUNC_IDS: "weakref.WeakKeyDictionary[Any, Any]" = weakref.WeakKeyDictionary()


# a pandas frame's or an arrow table's id by ``id()`` (neither hashes), for
# as long as the object lives
_DATA_IDS: Dict[int, str] = {}


def _data_id(obj: Any) -> str:
    key = id(obj)
    known = _DATA_IDS.get(key)
    if known is None:
        known = _DATA_IDS[key] = str(uuid.uuid4())
        weakref.finalize(obj, _DATA_IDS.pop, key, None)
    return known


def content_digest(obj: Any) -> str:
    """md5 of a pandas frame's or an arrow table's column names, types and
    values; a random id where the values do not hash (fail closed: the
    task recomputes)."""
    m = hashlib.md5()
    try:
        if isinstance(obj, pd.DataFrame):
            m.update(repr([(str(c), str(t)) for c, t in obj.dtypes.items()]).encode())
            m.update(pd.util.hash_pandas_object(obj, index=True).to_numpy().tobytes())
        else:
            m.update(str(obj.schema).encode())
            for col in obj.columns:
                for chunk in col.chunks:
                    for buf in chunk.buffers():
                        m.update(b"-" if buf is None else memoryview(buf))
    except TypeError:
        return str(uuid.uuid4())
    return m.hexdigest()


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
        known = _FUNC_IDS.get(obj) if inspect.isfunction(obj) else None
        if known is not None and known[0] is obj.__code__:
            return known[1]
        try:
            src = inspect.getsource(obj)
        except (OSError, TypeError):
            src = obj.__qualname__
        res = f"func:{obj.__module__}.{obj.__qualname__}:{src}"
        if inspect.isfunction(obj):
            _FUNC_IDS[obj] = (obj.__code__, res)
        return res
    if hasattr(obj, "__uuid__"):
        return f"uuid:{obj.__uuid__()}"
    if isinstance(obj, (pd.DataFrame, pa.Table)):
        return f"data:{type(obj).__qualname__}:{_data_id(obj)}"
    return f"repr:{type(obj).__module__}.{type(obj).__qualname__}:{obj!r}"


def to_uuid(*args: Any) -> str:
    """Deterministic uuid string from arbitrary objects."""
    m = hashlib.md5()
    for a in args:
        m.update(
            json.dumps(_normalize(a), sort_keys=True, default=str).encode()
        )
    return str(uuid.UUID(m.hexdigest()))
