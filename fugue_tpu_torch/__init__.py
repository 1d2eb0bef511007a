"""fugue_tpu_torch: the PyTorch/CUDA port of fugue_tpu for an NVIDIA H100.

It imports nothing of ``fugue_tpu`` or of JAX; the JAX package stays
beside it as the reference the port is tested against. The slice ported
so far is the main path: ``transform`` of a ``Dict[str, torch.Tensor]``
transformer, then ``aggregate`` with sum/avg/count by integer keys, whose
per-row reduction is a hand-written CUDA kernel
(``fugue_tpu_torch/kernels/segment_sums.cu``).
"""

from fugue_tpu_torch.api import aggregate, transform
from fugue_tpu_torch.column import col, lit
from fugue_tpu_torch.column import functions
from fugue_tpu_torch.execution import make_execution_engine
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.torch_backend.execution_engine import TorchExecutionEngine

__all__ = [
    "Schema",
    "TorchDataFrame",
    "TorchExecutionEngine",
    "aggregate",
    "col",
    "functions",
    "lit",
    "make_execution_engine",
    "transform",
]
