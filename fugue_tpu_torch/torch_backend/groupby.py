"""Group-by on the card: static key binning + the fused binned sums.

The port of ``fugue_tpu/jax_backend/groupby.py``'s binned path. When
every key is integer-like with host-known bounds, segment ids are a
mixed-radix combination of ``key - min``, computed inside the fused
kernel with the row validity and the sums: no sort, no segment-id tensor,
and the segment count is the static bin count, so no output shape needs
a readback. Empty bins are dropped lazily through an occupancy mask.

The JAX package's other segment-sum strategies (one-hot matmul, bf16
matmul, sorted scatter) were built for the TPU's matrix unit and are not
carried over: the port has one, the hand-written CUDA kernel
(``kernels/segment_sums.cu``), with its plain twin on the CPU. Keys with
no bin spec need the sort factorization, which is not ported yet.
"""

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from fugue_tpu_torch.kernels.reference import (
    BinKey,
    Payload,
    bin_segments,
    binned_sums_reference,
)
from fugue_tpu_torch.kernels.segment_sums import binned_sums_cuda
from fugue_tpu_torch.torch_backend.blocks import TorchBlocks

_MAX_BINS = 1 << 22  # static-binning cap (``groupby.py:451``)


class BinSpec(NamedTuple):
    """Static mixed-radix key binning (``groupby.py:53``): enough to
    compute segment ids and to decode key values from bin indices."""

    names: Tuple[str, ...]
    mins: Tuple[int, ...]
    spans: Tuple[int, ...]  # includes the +1 null bucket where masked
    masked: Tuple[bool, ...]
    total: int


def bin_spec(blocks: TorchBlocks, keys: List[str]) -> Optional[BinSpec]:
    """BinSpec for ``keys`` when all are integer-like with bounds (ingest
    stats, else ONE device min/max readback, cached on the columns); None
    for float keys or more than ``_MAX_BINS`` bins (``groupby.py:64``)."""
    missing: List[str] = []
    for k in keys:
        col = blocks.columns[k]
        if col.data.is_floating_point():
            return None
        if col.stats is None:
            missing.append(k)
    if missing:
        _fill_stats_from_device(blocks, missing)
    spans: List[int] = []
    mins: List[int] = []
    masked: List[bool] = []
    total = 1
    for k in keys:
        col = blocks.columns[k]
        lo, hi = col.stats  # type: ignore[misc]
        span = int(hi) - int(lo) + 1
        if span <= 0 or span > _MAX_BINS:
            return None
        if col.mask is not None:
            span += 1  # null bucket
        spans.append(span)
        mins.append(int(lo))
        masked.append(col.mask is not None)
        total *= span
        if total > _MAX_BINS:
            return None
    return BinSpec(tuple(keys), tuple(mins), tuple(spans), tuple(masked), total)


def _fill_stats_from_device(blocks: TorchBlocks, names: List[str]) -> None:
    """Missing int-key bounds from ``torch.aminmax`` over each column, with
    one readback for all of them (``groupby.py:109``)."""
    datas = [blocks.columns[k].data for k in names]
    bounds = torch.stack(
        [
            torch.stack(
                torch.aminmax(d.to(torch.int32) if d.dtype == torch.bool else d)
            ).to(torch.int64)
            for d in datas
        ]
    ).cpu()
    for k, b in zip(names, bounds.tolist()):
        blocks.columns[k].stats = (int(b[0]), int(b[1]))


def bin_keys(
    spec: BinSpec,
    key_data: Dict[str, torch.Tensor],
    key_masks: Dict[str, Optional[torch.Tensor]],
) -> List[BinKey]:
    """The key columns of ``spec`` as the fused kernel takes them: dense
    (a transformer may return views)."""
    return [
        BinKey(
            key_data[name].contiguous(),
            key_masks[name].contiguous() if has_mask else None,  # type: ignore[union-attr]
            kmin,
            span,
        )
        for name, kmin, span, has_mask in zip(
            spec.names, spec.mins, spec.spans, spec.masked
        )
    ]


def inline_seg(
    spec: BinSpec,
    key_data: Dict[str, torch.Tensor],
    key_masks: Dict[str, Optional[torch.Tensor]],
    valid_rows: torch.Tensor,
) -> torch.Tensor:
    """Mixed-radix segment id per row (``groupby.py:120``); invalid rows get
    the out-of-range sentinel ``spec.total``."""
    return bin_segments(bin_keys(spec, key_data, key_masks), valid_rows)


def decode_bin_keys(
    spec: BinSpec, dtypes: Dict[str, torch.dtype], device: torch.device
) -> Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Key ``(values, mask)`` per bin index (``groupby.py:141``): arithmetic
    over ``arange(total)``, no representative-row gather."""
    b = torch.arange(spec.total, dtype=torch.int64, device=device)
    out: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
    stride = spec.total
    for name, kmin, span, has_mask in zip(
        spec.names, spec.mins, spec.spans, spec.masked
    ):
        stride //= span
        code = (b // stride) % span
        mask: Optional[torch.Tensor] = None
        if has_mask:
            mask = code != span - 1
            code = torch.where(mask, code, 0)
        out[name] = ((code + kmin).to(dtypes[name]), mask)
    return out


def binned_sums(
    keys: Sequence[BinKey],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    floats: Sequence[Payload] = (),
    counts: Sequence[torch.Tensor] = (),
    ints: Sequence[Payload] = (),
    occupancy: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segment ids, row validity and every sum-type reduction of an
    aggregate in one pass, with the contract of
    ``kernels.reference.binned_sums_reference``. CUDA keys go to the fused
    kernel, CPU keys to its plain twin; there is no fallback between
    them."""
    args = dict(nrows=nrows, row_valid=row_valid, floats=floats, counts=counts,
                ints=ints, occupancy=occupancy)
    device = keys[0].data.device
    if device.type == "cuda":
        return binned_sums_cuda(keys, **args)  # type: ignore[arg-type]
    if device.type == "cpu":
        return binned_sums_reference(keys, **args)  # type: ignore[arg-type]
    raise NotImplementedError(f"binned sums on {device}")


def segment_sums(
    float_payloads: List[torch.Tensor],
    count_payloads: List[torch.Tensor],
    seg: torch.Tensor,
    num_segments: int,
    int_payloads: Optional[List[torch.Tensor]] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Per-segment sums over precomputed segment ids (``groupby.py:219``):
    ``binned_sums`` with ``seg`` as its one key. ``float_payloads`` sum in
    the widest float dtype present (float32 when all are float32);
    ``count_payloads`` (bool/0-1) sum exactly in int32; ``int_payloads``
    sum exactly in int64. Rows with ``seg < 0`` or ``seg >= num_segments``
    contribute nothing."""
    f, c, i = binned_sums(
        [BinKey(seg, None, 0, num_segments)],
        nrows=int(seg.shape[0]),
        floats=[(p, None) for p in float_payloads],
        counts=count_payloads,
        ints=[(p, None) for p in int_payloads or []],
        occupancy=False,
    )
    return list(f), list(c), list(i)
