"""``assert_or_throw`` (copy of ``fugue_tpu/utils/assertion.py:4``)."""

from typing import Any, Callable, Union


def assert_or_throw(
    cond: bool, exception: Union[None, str, Exception, Callable[[], Any]] = None
) -> None:
    """Raise when ``cond`` is falsy.

    ``exception`` may be a message string (raises ``AssertionError``), an
    exception instance, or a zero-arg callable evaluated lazily (so building
    expensive messages costs nothing on the happy path).
    """
    if cond:
        return
    if exception is None:
        raise AssertionError()
    if callable(exception) and not isinstance(exception, Exception):
        exception = exception()
    if isinstance(exception, Exception):
        raise exception
    raise AssertionError(str(exception))
