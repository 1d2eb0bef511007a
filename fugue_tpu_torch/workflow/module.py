"""``module``: a reusable sub-DAG function, taking and returning workflow
frames (a copy of ``fugue_tpu/workflow/module.py``)."""

import inspect
from typing import Any, Callable, Optional

from fugue_tpu_torch.utils.assertion import assert_or_throw
from fugue_tpu_torch.workflow.workflow import WorkflowDataFrame


def module(func: Optional[Callable] = None, as_method: bool = False, name: Optional[str] = None,
           on_dup: str = "overwrite") -> Any:
    """Marks a function as a workflow module; with ``as_method=True`` it
    also becomes a ``WorkflowDataFrame`` method."""

    def deco(fn: Callable) -> Callable:
        sig = inspect.signature(fn)

        def wrapper(*args: Any, **kwargs: Any) -> Any:
            return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        if as_method:
            method_name = name or fn.__name__
            assert_or_throw(len(sig.parameters) > 0,
                            ValueError("as_method module needs a WorkflowDataFrame param"))

            def method(self: WorkflowDataFrame, *args: Any, **kwargs: Any) -> Any:
                return fn(self, *args, **kwargs)

            if hasattr(WorkflowDataFrame, method_name) and on_dup == "throw":
                raise KeyError(f"{method_name} already exists")
            setattr(WorkflowDataFrame, method_name, method)
        return wrapper

    return deco(func) if func is not None else deco
