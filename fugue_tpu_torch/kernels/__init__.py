"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (``reference.py``). Sources are built with ``nvcc`` at first use
(``build.py``); nothing here compiles or touches a card at import."""

from typing import Any, Union

import torch

# a uint64 column's words on the card: its values with the sign bit flipped,
# so a signed order of the words is the unsigned order of the values
# (``torch_backend/blocks.py``); one definition for the kernels and the frame
U64_FLIP = -(1 << 63)


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
