"""Plain PyTorch twins of the port's CUDA kernels: the CPU path, and the
oracle each kernel is held against on the card."""

from typing import Tuple

import torch


def segment_sums_reference(
    seg: torch.Tensor,
    fpack: torch.Tensor,
    cpack: torch.Tensor,
    ipack: torch.Tensor,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-segment sums of packed payloads, with ``index_add_``; the twin
    of ``segment_sums.cu`` and of ``groupby.segment_sums(strategy="scatter")``
    in the JAX package (``fugue_tpu/jax_backend/groupby.py:219``).

    ``seg`` int32[n]; ``fpack`` [F, n] float32/float64, summed in its own
    dtype; ``cpack`` [C, n] bool or uint8, read as flags: the rows whose
    byte is non-zero are counted in int32; ``ipack`` [I, n] int64, summed
    in int64. Rows with ``seg < 0`` or ``seg >= total``
    contribute nothing. Returns ``([F, total], [C, total], [I, total])``."""
    keep = (seg >= 0) & (seg < total)
    # dropped rows land in one extra bin that is cut off at the end
    idx = torch.where(keep, seg, total).long()

    def _sums(pack: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        acc = torch.zeros((pack.shape[0], total + 1), dtype=dtype, device=seg.device)
        acc.index_add_(1, idx, pack.to(dtype))
        return acc[:, :total].contiguous()

    return (
        _sums(fpack, fpack.dtype),
        _sums(cpack != 0, torch.int32),
        _sums(ipack, torch.int64),
    )
