from fugue_tpu_torch.execution.factory import make_execution_engine

__all__ = ["make_execution_engine"]
