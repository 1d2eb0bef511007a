"""``make_execution_engine``: the port's engine factory (after
``fugue_tpu/execution/factory.py:116-156``, with the engine names and the
inference that ``fugue_tpu/jax_backend/registry.py:80-83`` registers for
its own frames). The port keeps no plugin registry: it knows one engine,
``"torch"``."""

from typing import Any, List, Optional

from fugue_tpu_torch.execution.execution_engine import ExecutionEngine, try_get_context_engine
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.torch_backend.execution_engine import TorchExecutionEngine, TorchSQLEngine
from fugue_tpu_torch.torch_backend.zipped import TorchZippedDataFrame
from fugue_tpu_torch.utils.params import ParamDict


def _infer_device(objs: List[Any]) -> Any:
    """The device of the first port frame (or zip) among ``objs``, as the
    JAX package infers its engine from a JAX frame; None if none is one."""
    for o in objs:
        if isinstance(o, TorchZippedDataFrame) and o.frames:
            return o.frames[0].device
        if isinstance(o, TorchDataFrame):
            return o.device
    return None


def make_execution_engine(
    engine: Any = None, conf: Any = None, infer_by: Optional[List[Any]] = None,
    **kwargs: Any,
) -> ExecutionEngine:
    """An engine from anything engine-like (``:116``):

    - an engine instance is returned as it is, ``conf`` merged into its own;
    - a pair ``(engine, sql_engine)`` makes ``engine`` and gives it that SQL
      engine (``None``, ``"torch"`` or a ``TorchSQLEngine``: the port has
      one);
    - ``None``: the context engine (``try_get_context_engine``) where there
      is one, else a ``TorchExecutionEngine`` on the device of a port frame
      among ``infer_by``, else on ``kwargs["device"]`` (default CUDA);
    - ``"torch"`` (any case) or the class: a new ``TorchExecutionEngine(conf,
      **kwargs)``.

    Any other engine (``"native"``, ``"jax"``, a plugin's) raises
    ``NotImplementedError`` naming ROADMAP.md queue 1 item 2(b)."""
    conf = ParamDict(conf)
    if isinstance(engine, tuple):
        res = make_execution_engine(engine[0], conf, infer_by, **kwargs)
        sql = engine[1]
        if not (sql is None or isinstance(sql, TorchSQLEngine)
                or (isinstance(sql, str) and sql.lower() == "torch")):
            raise NotImplementedError(
                f"SQL engine {sql!r}: the torch port runs only its own SQL engine; "
                "see ROADMAP.md queue 1 item 2(b) (the host engine)")
        if isinstance(sql, TorchSQLEngine):
            res.sql_engine = sql
        return res
    if isinstance(engine, ExecutionEngine):
        if len(conf) > 0:
            engine.conf.update(conf)
        return engine
    if engine is None:
        ctx = try_get_context_engine()
        if ctx is not None:
            if len(conf) > 0:
                ctx.conf.update(conf)
            return ctx
        device = _infer_device(infer_by or [])
        if device is not None:
            kwargs["device"] = device
        return TorchExecutionEngine(conf, **kwargs)
    if (isinstance(engine, str) and engine.lower() == "torch") or engine is TorchExecutionEngine:
        return TorchExecutionEngine(conf, **kwargs)
    raise NotImplementedError(
        f"engine {engine!r}: the torch port runs only its own engine ('torch'); "
        "the native engine and the plugin registry are ROADMAP.md queue 1 item 2(b) "
        "(the host engine)"
    )
