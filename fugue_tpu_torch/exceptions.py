"""The port's errors: a trimmed copy of
``fugue_tpu/exceptions.py:13-181`` (``FugueError``, the workflow compile
branch and ``FugueSQLError``/``FugueSQLSyntaxError``, ``:176-181``; the
runtime branch and ``FugueSQLRuntimeError``, ``:81-82``, ``:180-181``; the
workflow's validation, interfaceless and task errors, ``:53``, ``:76``,
``:85-155``), and ``SQLExecutionError`` of
``fugue_tpu/sql_frontend/select_runner.py:33``."""


class FugueError(Exception):
    """Base of every framework-raised error."""


class FugueWorkflowError(FugueError):
    """Workflow-level errors."""


class FugueWorkflowCompileError(FugueWorkflowError):
    """The workflow (or its SQL) is malformed."""


class FugueSQLError(FugueWorkflowCompileError):
    """FugueSQL-related compile error."""


class FugueSQLSyntaxError(FugueSQLError):
    """FugueSQL/SELECT text failed to parse."""


class FugueWorkflowRuntimeError(FugueWorkflowError):
    """Raised while executing a workflow."""


class FugueSQLRuntimeError(FugueWorkflowRuntimeError):
    """A SQL statement failed during execution."""


class SQLExecutionError(FugueSQLRuntimeError, ValueError):
    """An invalid SQL statement: an unknown table or column, or a window
    function's argument or frame that no engine runs."""


class FugueWorkflowCompileValidationError(FugueWorkflowCompileError):
    """A workflow fails an extension's compile-time validation rules
    (``fugue_tpu/exceptions.py:53``)."""


class FugueInterfacelessError(FugueWorkflowCompileError):
    """A function can't be adapted into the requested extension
    (``fugue_tpu/exceptions.py:76``)."""


class FugueWorkflowRuntimeValidationError(FugueWorkflowRuntimeError):
    """An input fails an extension's runtime validation rules
    (``fugue_tpu/exceptions.py:85``)."""


class TaskFailure:
    """One task's failure inside a workflow run: its display name, the user
    callsite where it was defined, and the error (``fugue_tpu/exceptions.py:89``)."""

    def __init__(self, task_id: str, task_name: str, error: BaseException, callsite=None):
        self.task_id = task_id
        self.task_name = task_name
        self.error = error
        self.callsite = list(callsite or [])

    def describe(self) -> str:
        lines = [f"[task {self.task_name}] {type(self.error).__name__}: {self.error}"]
        if self.callsite:
            lines.append("  defined at:")
            lines.extend("  " + c for c in self.callsite)
        return "\n".join(lines)


class WorkflowRuntimeError(FugueWorkflowRuntimeError):
    """The parallel runner's failure of two tasks or more
    (``fugue_tpu/exceptions.py:119``): ``failures`` lists each, the first
    chained as ``__cause__``."""

    def __init__(self, failures):
        self.failures = list(failures)
        super().__init__(f"{len(self.failures)} task(s) failed:\n"
                         + "\n".join(f.describe() for f in self.failures))
        if self.failures:
            self.__cause__ = self.failures[0].error

    @property
    def errors(self):
        return [f.error for f in self.failures]


class TaskCancelledError(FugueWorkflowRuntimeError):
    """A task was cancelled because a sibling failed; it never ran
    (``fugue_tpu/exceptions.py:153``)."""
