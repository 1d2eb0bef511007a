"""``make_execution_engine``: the port's engine factory (in place of
``fugue_tpu/execution/factory.py:116`` and the engine names that
``fugue_tpu/jax_backend/registry.py`` registers). The port registers
nothing in the JAX package's plugin registry; it knows one engine."""

from typing import Any

from fugue_tpu_torch.torch_backend.execution_engine import TorchExecutionEngine


def make_execution_engine(
    engine: Any = None, conf: Any = None, device: Any = None
) -> TorchExecutionEngine:
    """``None`` or ``"torch"`` -> a new ``TorchExecutionEngine(conf,
    device)``; an engine instance is returned as it is."""
    if isinstance(engine, TorchExecutionEngine):
        return engine
    if engine is None or (isinstance(engine, str) and engine.lower() == "torch"):
        return TorchExecutionEngine(conf, device=device)
    raise NotImplementedError(
        f"engine {engine!r}: the torch port runs only its own engine "
        "('torch'); the native engine and the plugin registry are "
        "ROADMAP.md queue 1 item 2"
    )
