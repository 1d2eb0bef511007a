"""The SQL front end's errors: a trimmed copy of
``fugue_tpu/exceptions.py:13-181`` (``FugueError``, the workflow compile
branch and ``FugueSQLError``/``FugueSQLSyntaxError``, ``:176-181``)."""


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
