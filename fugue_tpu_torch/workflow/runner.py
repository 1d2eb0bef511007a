"""The DAG runner (a port of ``fugue_tpu/workflow/runner.py``:
``TaskNode`` ``:55``, ``DAGRunner`` ``:76``): tasks in dependency order,
one at a time, or on up to ``fugue.workflow.concurrency`` worker threads
at once. A failure stops the launch of new tasks; the runner waits for
the running ones, then raises the one error as it is, or a
``WorkflowRuntimeError`` listing every failed task. Per-task timeouts are
ROADMAP.md queue 1 item 10 and refused before a run starts, so no task
here has one. Tasks on two threads launch their kernels on one device at
once, each on its thread's current stream."""

import threading
from concurrent.futures import FIRST_COMPLETED, Future, wait
from typing import Any, Callable, Dict, List, Optional, Set

from fugue_tpu_torch.exceptions import TaskCancelledError, TaskFailure, WorkflowRuntimeError
from fugue_tpu_torch.utils.assertion import assert_or_throw
from fugue_tpu_torch.workflow.fault import CancelToken


class TaskNode:
    def __init__(self, task_id: str, func: Callable[[List[Any]], Any], dependencies: List[str],
                 name: Optional[str] = None, callsite: Optional[List[str]] = None):
        self.task_id = task_id
        self.func = func
        self.dependencies = dependencies
        self.name = name or task_id
        self.callsite = list(callsite or [])


class DAGRunner:
    """Runs tasks in dependency order; their results by task id."""

    def __init__(self, concurrency: int = 1):
        self._concurrency = max(1, concurrency)

    def run(self, nodes: List[TaskNode], cancel_token: Optional[CancelToken] = None
            ) -> Dict[str, Any]:
        by_id = {n.task_id: n for n in nodes}
        for n in nodes:
            for d in n.dependencies:
                assert_or_throw(d in by_id, ValueError(f"unknown dependency {d}"))
        results: Dict[str, Any] = {}
        token = cancel_token if cancel_token is not None else CancelToken()
        if self._concurrency > 1:
            return self._run_parallel(nodes, results, token)
        for n in self._topological(nodes):
            token.raise_if_cancelled()
            try:
                results[n.task_id] = n.func([results[d] for d in n.dependencies])
            except BaseException:
                token.cancel()
                raise
        return results

    def _topological(self, nodes: List[TaskNode]) -> List[TaskNode]:
        done: Set[str] = set()
        ordered: List[TaskNode] = []
        remaining = list(nodes)
        while remaining:
            still = [n for n in remaining if not all(d in done for d in n.dependencies)]
            ready = [n for n in remaining if all(d in done for d in n.dependencies)]
            assert_or_throw(len(ready) > 0, ValueError("cycle detected in workflow DAG"))
            for n in ready:
                ordered.append(n)
                done.add(n.task_id)
            remaining = still
        return ordered

    def _run_parallel(self, nodes: List[TaskNode], results: Dict[str, Any],
                      token: CancelToken) -> Dict[str, Any]:
        """``:152``, without the timeout supervision."""
        pending = {n.task_id: n for n in nodes}
        running: Dict[Future, TaskNode] = {}
        failures: List[TaskFailure] = []
        while running or (pending and not failures and not token.cancelled):
            if not failures and not token.cancelled:
                free = self._concurrency - len(running)
                ready = [n for n in pending.values()
                         if all(d in results for d in n.dependencies)][:max(0, free)]
                for n in ready:
                    del pending[n.task_id]
                    running[self._spawn(n, [results[d] for d in n.dependencies], token)] = n
                if not running:
                    assert_or_throw(not pending, ValueError("cycle detected in workflow DAG"))
                    break
            finished, _ = wait(list(running.keys()), return_when=FIRST_COMPLETED)
            for f in finished:
                n = running.pop(f)
                err = f.exception()
                if err is None:
                    results[n.task_id] = f.result()
                elif not isinstance(err, TaskCancelledError):
                    failures.append(TaskFailure(n.task_id, n.name, err, n.callsite))
                    token.cancel()
        if failures:
            if len(failures) == 1:
                raise failures[0].error
            raise WorkflowRuntimeError(failures)
        if len(results) < len(nodes):
            token.raise_if_cancelled()
        return results

    def _spawn(self, node: TaskNode, deps: List[Any], token: CancelToken) -> Future:
        """One worker: a daemon thread resolving a future (``:253``)."""
        f: Future = Future()

        def work() -> None:
            if not f.set_running_or_notify_cancel():  # pragma: no cover
                return
            try:
                token.raise_if_cancelled()
                result = node.func(deps)
            except BaseException as ex:
                f.set_exception(ex)
                return
            f.set_result(result)

        threading.Thread(target=work, daemon=True, name=f"fugue-task-{node.task_id}").start()
        return f
