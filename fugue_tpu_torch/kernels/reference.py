"""Plain PyTorch twins of the port's CUDA kernels (``segment_sums.cu``,
``factorize.cu``): the CPU path, and the oracle each kernel is held
against on the card."""

from typing import Optional, NamedTuple, Sequence, Tuple

import torch

from fugue_tpu_torch.utils.validity import materialize_validity

# a payload column and its null mask (True = valid; None: all valid)
Payload = Tuple[torch.Tensor, Optional[torch.Tensor]]
MAX_KEYS = 4  # key columns the fused kernel reads


class BinKey(NamedTuple):
    """One key column of the binned aggregate: its values (bool or an
    integer type, read in its own type), its null mask (True = valid), the
    smallest value ``kmin`` and the ``span`` of codes, the null bucket
    ``span - 1`` included where the key is masked."""

    data: torch.Tensor
    mask: Optional[torch.Tensor]
    kmin: int
    span: int


def bin_total(keys: Sequence[BinKey]) -> int:
    """The segment count: the product of the spans, below 2^31."""
    total = 1
    for k in keys:
        if int(k.span) < 1:
            raise ValueError(f"span {k.span} must be at least 1")
        total *= int(k.span)
    if total >= 2**31:
        raise ValueError(f"{total} segments: at most 2^31 - 1")
    return total


def bin_segments(keys: Sequence[BinKey], valid_rows: torch.Tensor) -> torch.Tensor:
    """Mixed-radix segment id per row, the first key most significant:
    the port's ``groupby.inline_seg`` (``fugue_tpu/jax_backend/groupby.py:120``).
    Invalid rows get the out-of-range sentinel ``bin_total(keys)``."""
    combined: Optional[torch.Tensor] = None
    for k in keys:
        key = k.data
        if key.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8):
            # key - kmin may not fit the narrow type; it always fits int32
            key = key.to(torch.int32)
        # in the key's own type the difference may wrap in between, but
        # its true value lies in [0, span) and so comes out right
        code = (key - k.kmin).to(torch.int32)
        if k.mask is not None:
            code = torch.where(k.mask, code, k.span - 1)
        combined = code if combined is None else combined * k.span + code
    return torch.where(valid_rows, combined, bin_total(keys))  # type: ignore


def _binned_rows(
    keys: Sequence[BinKey], nrows: Optional[int], row_valid: Optional[torch.Tensor]
) -> torch.Tensor:
    """The rows a binned kernel accepts: real rows (a prefix frame's first
    ``nrows``, or a masked frame's non-zero ``row_valid`` bytes) whose
    every key code lies in ``[0, span)``."""
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"{len(keys)} keys: the kernel takes 1 to {MAX_KEYS}")
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    n = int(keys[0].data.shape[0])
    valid = materialize_validity(row_valid, n, nrows, keys[0].data.device)
    for k in keys:
        code = k.data.to(torch.int64) - int(k.kmin)
        if k.mask is not None:
            code = torch.where(k.mask, code, int(k.span) - 1)
        valid = valid & (code >= 0) & (code < int(k.span))
    return valid


def binned_sums_reference(
    keys: Sequence[BinKey],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    floats: Sequence[Payload] = (),
    counts: Sequence[torch.Tensor] = (),
    ints: Sequence[Payload] = (),
    occupancy: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segment ids, row validity and per-segment sums of a binned
    aggregate: the twin of ``segment_sums.cu`` and of the per-row part of
    the JAX package's ``_binned_packed_aggregate`` program
    (``fugue_tpu/jax_backend/execution_engine.py:3500-3574``), built from
    ``bin_segments`` (``groupby.inline_seg``) and
    ``segment_sums_reference``.

    ``keys``: 1-4 ``BinKey``; a row with any code (``key - kmin``, or
    ``span - 1`` where null) outside ``[0, span)`` is dropped. Rows: pass
    ``nrows`` for a prefix frame (rows ``>= nrows`` are dropped) or
    ``row_valid`` for a masked frame (rows whose byte is zero are
    dropped). ``floats``: float32/float64 payloads with optional masks,
    summed in float64 if any is float64, else in float32; ``counts``:
    bool/uint8 flags, the accepted rows whose byte is non-zero counted in
    int32; ``ints``: integer payloads with optional masks, summed in
    int64. A masked payload adds only where its mask holds. With
    ``occupancy``, count row 0 counts every accepted row and the flags
    follow it. Returns ``([F, total], [occupancy + C, total], [I,
    total])``."""
    n = int(keys[0].data.shape[0])
    device = keys[0].data.device
    seg = bin_segments(keys, _binned_rows(keys, nrows, row_valid))
    fdtype = torch.float64 if any(v.dtype == torch.float64 for v, _ in floats) else torch.float32

    def _pack(pays: Sequence[Payload], dtype: torch.dtype) -> torch.Tensor:
        rows = [(v if m is None else torch.where(m, v, 0)).to(dtype) for v, m in pays]
        if not rows:
            return torch.empty((0, n), dtype=dtype, device=device)
        return torch.stack(rows)

    flags = [torch.ones((n,), dtype=torch.bool, device=device)] if occupancy else []
    flags += [c != 0 for c in counts]
    cpack = torch.stack(flags) if flags else torch.empty((0, n), dtype=torch.bool, device=device)
    return segment_sums_reference(
        seg, _pack(floats, fdtype), cpack, _pack(ints, torch.int64), bin_total(keys)
    )


def segment_sums_reference(
    seg: torch.Tensor,
    fpack: torch.Tensor,
    cpack: torch.Tensor,
    ipack: torch.Tensor,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-segment sums of packed payloads, with ``index_add_``; the twin
    of ``segment_sums.cu`` over precomputed segment ids and of
    ``groupby.segment_sums(strategy="scatter")`` in the JAX package
    (``fugue_tpu/jax_backend/groupby.py:219``).

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


def bin_factorize_reference(
    keys: Sequence[BinKey],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Binned key factorization: the twin of K1 in ``factorize.cu`` and of
    the JAX package's ``_bin_core`` (``fugue_tpu/jax_backend/groupby.py:481``).

    ``keys`` and the rows as for ``binned_sums_reference``: a row that is
    not real, or has a key code outside ``[0, span)``, has no bin. Returns
    ``(seg, first_idx, occupied, count)``: ``seg`` int32[n], the row's bin
    (``bin_total(keys)`` where it has none); ``first_idx`` int32[total],
    the first row of each bin, ``n - 1`` where the bin is empty;
    ``occupied`` bool[total]; ``count`` the occupied bins, an int32 0-d
    tensor."""
    n = int(keys[0].data.shape[0])
    device = keys[0].data.device
    valid = _binned_rows(keys, nrows, row_valid)
    seg = bin_segments(keys, valid)
    total = bin_total(keys)
    pos = torch.arange(n, dtype=torch.int32, device=device)
    # rows with no bin land in one extra bin that is cut off at the end
    first = torch.full((total + 1,), n, dtype=torch.int32, device=device)
    first.scatter_reduce_(0, seg.long(), torch.where(valid, pos, n), "amin")
    first = first[:total]
    occupied = first < n
    return seg, first.clamp(max=n - 1), occupied, occupied.sum(dtype=torch.int32)


def _code_bits(c: torch.Tensor) -> torch.Tensor:
    """A sort code as the integers the kernel compares: floats bit for bit
    (they come canonical: no NaN, no -0.0)."""
    if c.dtype == torch.float32:
        return c.view(torch.int32)
    if c.dtype == torch.float64:
        return c.view(torch.int64)
    return c


def sort_boundaries_reference(
    codes: Sequence[torch.Tensor],
    order: torch.Tensor,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group ids in sorted order: the twin of K2 in ``factorize.cu`` and of
    the boundary-and-scan tail of the JAX package's
    ``_sort_factorize_core`` (``fugue_tpu/jax_backend/groupby.py:554``).

    ``order`` int64[n] is the sorted permutation of the rows, real rows
    first (a prefix frame's rows below ``nrows``, or a masked frame's
    non-zero ``row_valid`` bytes); a real position opens a group where any
    of ``codes`` differs from the position before it, and the first real
    position always does. Returns ``(seg_sorted, count)``: ``seg_sorted``
    int32[n] the group of each sorted position, -1 where it is not real;
    ``count`` the groups, an int32 0-d tensor."""
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    n = int(order.shape[0])
    real = row_valid[order] != 0 if row_valid is not None else order < nrows
    opens = torch.zeros((n,), dtype=torch.bool, device=order.device)
    opens[0] = True
    for c in codes:
        sc = _code_bits(c[order])
        opens[1:] |= sc[1:] != sc[:-1]
    opens &= real
    seg_sorted = torch.cumsum(opens, 0, dtype=torch.int32) - 1
    return torch.where(real, seg_sorted, -1), opens.sum(dtype=torch.int32)


def sort_finish_reference(
    seg_sorted: torch.Tensor, order: torch.Tensor, num: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group ids in row order and the first row of each group: the twin of
    K3 in ``factorize.cu`` and of the JAX package's
    ``_sort_factorize_finish`` (``fugue_tpu/jax_backend/groupby.py:582``).

    ``seg_sorted`` and ``order`` as ``sort_boundaries_reference`` takes and
    gives them, ``num`` the group count. Returns ``(seg, first_idx)``:
    ``seg`` int32[n], ``num`` where the row is not real; ``first_idx``
    int32[num], the row at each group's first sorted position."""
    n = int(order.shape[0])
    real = seg_sorted >= 0
    seg = torch.empty((n,), dtype=torch.int32, device=order.device)
    seg.scatter_(0, order, torch.where(real, seg_sorted, num))
    opens = real.clone()
    opens[1:] &= seg_sorted[1:] != seg_sorted[:-1]
    first_idx = torch.empty((num,), dtype=torch.int32, device=order.device)
    first_idx[seg_sorted[opens].long()] = order[opens].to(torch.int32)
    return seg, first_idx


def sort_factorize_reference(
    codes: Sequence[torch.Tensor],
    order: torch.Tensor,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The sort path after the sorts, as the twins of K2 and K3 with the
    one readback of the group count between them (``groupby.py:548``):
    ``(seg, first_idx, num)``."""
    seg_sorted, count = sort_boundaries_reference(
        codes, order, nrows=nrows, row_valid=row_valid
    )
    num = int(count)
    seg, first_idx = sort_finish_reference(seg_sorted, order, num)
    return seg, first_idx, num
