"""The SQL front end's errors: a trimmed copy of
``fugue_tpu/exceptions.py:13-181`` (``FugueError``, the workflow compile
branch and ``FugueSQLError``/``FugueSQLSyntaxError``, ``:176-181``; the
runtime branch and ``FugueSQLRuntimeError``, ``:81-82``, ``:180-181``),
and ``SQLExecutionError`` of ``fugue_tpu/sql_frontend/select_runner.py:33``."""


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
