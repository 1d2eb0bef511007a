"""Error-trace surgery for workflow failures: framework frames pruned from
a traceback, and a note naming the failing task and where the user defined
it (a copy of ``fugue_tpu/utils/exception.py``)."""

from types import TracebackType
from typing import List, Optional


def prune_traceback(tb: Optional[TracebackType], hide_prefixes: List[str]
                    ) -> Optional[TracebackType]:
    """The frames of ``tb`` whose module is not under a hide prefix; the
    deepest frame at least (``:20``)."""
    frames: List[TracebackType] = []
    cur = tb
    while cur is not None:
        frames.append(cur)
        cur = cur.tb_next
    kept = [f for f in frames if not _is_hidden(f, hide_prefixes)] or frames[-1:]
    next_tb: Optional[TracebackType] = None
    for f in reversed(kept):
        next_tb = TracebackType(next_tb, f.tb_frame, f.tb_lasti, f.tb_lineno)
    return next_tb


def _match_module(module: str, prefix: str) -> bool:
    """``module`` is the package ``prefix`` names or a module of it."""
    p = prefix.rstrip(".")
    return module == p or module.startswith(p + ".")


def _is_hidden(tb: TracebackType, prefixes: List[str]) -> bool:
    module = tb.tb_frame.f_globals.get("__name__", "")
    return any(_match_module(module, p) for p in prefixes if p != "")


def add_error_note(ex: BaseException, note: str) -> None:
    """A PEP-678 note on ``ex`` (``:60``)."""
    ex.add_note(note)
