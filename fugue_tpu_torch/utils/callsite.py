"""User-callsite attribution: the last user (non-framework) frames of the
stack where a workflow task was defined, spliced into the task's errors
(``fugue_tpu/utils/callsite.py``). The frames are walked from the caller
out and only the kept ones are formatted, where the reference formats the
whole stack (``traceback.extract_stack``) first: the same lines, less
host work a task."""

import functools
import importlib
import linecache
import os
import sys
from typing import List, Optional


@functools.lru_cache(maxsize=None)
def package_dir(prefix: str) -> Optional[str]:
    """The directory of the package named by a hide prefix
    (``'fugue_tpu_torch.'``), or None if it does not import."""
    try:
        f = getattr(importlib.import_module(prefix.rstrip(".")), "__file__", None)
    except Exception:
        return None
    if f is None:
        return None
    return os.path.dirname(os.path.abspath(f)).replace("\\", "/") + "/"


def extract_user_callsite(inject: int, hide_prefixes: List[str]) -> List[str]:
    """The current stack's last ``inject`` frames outside the hidden
    packages, outermost first, as display strings (``:36``)."""
    if inject <= 0:
        return []
    pkg_dirs = [d for d in (package_dir(p) for p in hide_prefixes if p) if d]
    frames: List[List[str]] = []
    f = sys._getframe(1)
    while f is not None and len(frames) < inject:
        code = f.f_code
        if not any(code.co_filename.replace("\\", "/").startswith(d) for d in pkg_dirs):
            entry = [f'  File "{code.co_filename}", line {f.f_lineno}, in {code.co_name}']
            line = linecache.getline(code.co_filename, f.f_lineno).strip()
            if line:
                entry.append(f"    {line}")
            frames.append(entry)
        f = f.f_back
    return [line for entry in reversed(frames) for line in entry]
