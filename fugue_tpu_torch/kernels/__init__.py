"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (``reference.py``). Sources are built with ``nvcc`` at first use
(``build.py``); nothing here compiles or touches a card at import."""

from typing import Any, Union

import torch


def kernel_for(where: Union[torch.Tensor, torch.device], cuda: Any, twin: Any, what: str) -> Any:
    """``cuda`` (a kernel's wrapper) for a CUDA tensor or device, ``twin``
    (its plain version) for a CPU one; there is no fallback between
    them, and any other device raises."""
    device = where.device if isinstance(where, torch.Tensor) else where
    if device.type == "cuda":
        return cuda
    if device.type == "cpu":
        return twin
    raise NotImplementedError(f"{what} on {device}")
