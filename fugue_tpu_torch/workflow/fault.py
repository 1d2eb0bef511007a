"""What the runner needs of ``fugue_tpu/workflow/fault.py``: the retry
policy at its defaults (``RetryPolicy`` ``:162``: one attempt, no
timeout), the cancel token (``CancelToken`` ``:231``), the run's fault
statistics (``RunStats`` ``:273``) and one attempt of a task
(``execute_with_policy`` ``:388``). Retries, timeouts, resuming a run
from its manifest and the degraded re-run on a cheaper tier (``:364``,
``:507``) are ROADMAP.md queue 1 item 10: a conf or a task that asks for
them is refused where the run starts (``workflow.py``)."""

import threading
from typing import Any, Callable, Optional

from fugue_tpu_torch.exceptions import TaskCancelledError


class RetryPolicy:
    """One attempt and no timeout: the reference's defaults."""

    max_attempts = 1
    timeout = 0.0


class CancelToken:
    """Set by the runner when a task fails; tasks not yet started see it
    and do not start (``:231``)."""

    def __init__(self) -> None:
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def raise_if_cancelled(self) -> None:
        if self._event.is_set():
            raise TaskCancelledError("cancelled by a failing sibling task")


class RunStats:
    """The run's fault statistics (``:273``): with one attempt a task and
    no resume, every count stays empty."""

    def as_dict(self) -> dict:
        return {"retries": {}, "recoveries": {}, "degradations": {}, "device_recoveries": {},
                "resumed": [], "integrity_rejected": {}, "memory": {}}


def execute_with_policy(fn: Callable[[], Any], policy: RetryPolicy, *,
                        token: Optional[CancelToken] = None) -> Any:
    """One attempt of ``fn`` (``:388`` at ``max_attempts`` 1), after a
    check of the cancel token."""
    if token is not None:
        token.raise_if_cancelled()
    return fn()
