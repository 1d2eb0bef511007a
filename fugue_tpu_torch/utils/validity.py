"""The one row-validity convention (``fugue_tpu/jax_backend/groupby.py:40``),
shared by the frame layer and the kernels' plain twins."""

from typing import Optional

import torch


def materialize_validity(
    row_valid: Optional[torch.Tensor], pad_n: int, nrows: Optional[int],
    device: torch.device,
) -> torch.Tensor:
    """Bool[pad_n]: True = real row. A masked frame passes its
    ``row_valid`` (bytes read as flags); a prefix frame's first ``nrows``
    rows are True, built as a fill rather than an index compare."""
    if row_valid is not None:
        return row_valid if row_valid.dtype == torch.bool else row_valid != 0
    valid = torch.zeros((pad_n,), dtype=torch.bool, device=device)
    valid[:nrows] = True
    return valid
