"""Schema hints and comment annotations of interfaceless extensions (a
copy of ``fugue_tpu/extensions/schema_hint.py``)."""

import inspect
import linecache
import re
import weakref
from typing import Any, Dict, List, Optional

from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw

_COMMENT_ANNO_RE = re.compile(r"^\s*#\s*(\w+)\s*:\s*(.*)$")
_ANNOTATIONS: "weakref.WeakKeyDictionary[Any, Any]" = weakref.WeakKeyDictionary()


def parse_comment_annotation(func: Any, key: str) -> Optional[str]:
    """The value of a ``# key: value`` comment line right above a ``def``."""
    return parse_comment_annotations(func).get(key)


def parse_comment_annotations(func: Any) -> Dict[str, str]:
    """The consecutive comment lines (decorators skipped) right above the
    function's ``def``, the nearest first; read once a function while it
    runs the code they were read for (``hash._FUNC_IDS``' rule)."""
    known = _ANNOTATIONS.get(func) if inspect.isfunction(func) else None
    if known is not None and known[0] is func.__code__:
        return dict(known[1])
    res = _read_annotations(func)
    if inspect.isfunction(func):
        _ANNOTATIONS[func] = (func.__code__, dict(res))
    return res


def _read_annotations(func: Any) -> Dict[str, str]:
    try:
        file = inspect.getsourcefile(func)
        _, lineno = inspect.getsourcelines(func)
        assert file is not None
        # the lines ``getsourcelines`` read (``linecache``), not the file
        # read again for every transform as in the reference
        all_lines = linecache.getlines(file)
    except (OSError, TypeError, AssertionError):
        return {}
    res: Dict[str, str] = {}
    i = lineno - 2
    while i >= 0:
        if all_lines[i].strip().startswith("@"):
            i -= 1
            continue
        m = _COMMENT_ANNO_RE.match(all_lines[i])
        if m is None:
            break
        res.setdefault(m.group(1), m.group(2).strip())
        i -= 1
    return res


def split_top_level(expr: str) -> List[str]:
    """``expr`` split at commas outside ``[]{}<>()``."""
    parts: List[str] = []
    depth = 0
    buf = ""
    for ch in expr:
        if ch in "[{(<":
            depth += 1
        elif ch in "]})>":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(buf)
            buf = ""
        else:
            buf += ch
    if buf.strip() != "":
        parts.append(buf)
    return [p.strip() for p in parts]


def apply_schema_hint(input_schema: Schema, hint: Any) -> Schema:
    """A transformer's schema hint resolved against its input schema:
    ``"a:int,b:str"``, ``"*"`` (the input's columns), ``"-b"`` (dropped),
    ``"+c:int"`` (added), mixed with commas (``:66``)."""
    if isinstance(hint, Schema):
        return hint
    if callable(hint):
        return Schema(hint(input_schema))
    assert_or_throw(isinstance(hint, str), ValueError(f"invalid schema hint {hint!r}"))
    if "*" not in hint and not hint.startswith(("+", "-")):
        return Schema(hint)
    res = Schema()  # ``fugue_tpu/schema.py:462`` ``Schema.transform``
    for s in split_top_level(hint):
        if s == "*":
            res = res + input_schema
        elif s.startswith("-"):  # names res does not hold are ignored
            drop = {x.strip() for x in s[1:].split(",")}
            res = Schema([f for f in res.fields if f.name not in drop])
        else:
            res = res + (s[1:] if s.startswith("+") else s)
    return res
