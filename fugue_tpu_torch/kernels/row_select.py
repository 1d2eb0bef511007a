"""The wrappers of ``row_select.cu``: check their tensors, allocate the
outputs and launch the row-selection kernels on PyTorch's current stream.

- ``rank_keep_cuda`` (K12): keep flags by each row's rank under a sort's
  permutation, within its segment, against one limit (a device scalar)
  or one per segment, with the kept count;
- ``first_row_mask_cuda`` (K13): each segment's first row where its
  predicate holds, with the count;
- ``null_count_keep_cuda`` (K14): dropna's keep flags from the columns'
  null masks, with the count.

Each has the contract of its twin in ``reference.py``. Each wrapper's
``launches`` grows by one where it launches its kernel and nowhere
else."""

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.factorize import (
    _check,
    _check_rows,
    _device_and_stream,
    _require_cuda,
)
from fugue_tpu_torch.kernels.reference import DROPNA_HOWS, FIRST_ROW_MODES, RANK_MODES


def _bind() -> ctypes.CDLL:
    lib = build.load("row_select")
    if lib.fugue_rank_keep.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(i)
        lib.fugue_rank_keep.argtypes = [
            ll, p, ll, p,  # n, order, nrows, row_valid
            p, p, i,  # seg, starts, num
            p, p, i,  # limit, limits, ge
            p, p, i, p, ip,  # keep, count, device, stream, launched
        ]
        lib.fugue_first_row_mask.argtypes = [
            ll, p, p, p, i,  # num, first_idx, occupied, counts, mode
            ll, p, p, i, p, ip,  # n, keep, count, device, stream, launched
        ]
        lib.fugue_null_count_keep.argtypes = [
            ll, ll, p,  # n, nrows, row_valid
            p, i, i, i, i,  # masks, nmasks, ncols, mode, thresh
            p, p, i, p, ip,  # keep, count, device, stream, launched
        ]
        for fn in (lib.fugue_rank_keep, lib.fugue_first_row_mask, lib.fugue_null_count_keep):
            fn.restype = i
        lib.fugue_row_select_error_string.argtypes = [i]
        lib.fugue_row_select_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fugue_row_select_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def rank_keep_cuda(
    order: torch.Tensor,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    seg: Optional[torch.Tensor] = None,
    starts: Optional[torch.Tensor] = None,
    limit: Optional[torch.Tensor] = None,
    limits: Optional[torch.Tensor] = None,
    mode: str = "lt",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12, with the contract of ``reference.rank_keep_reference``:
    ``(keep bool[n], count int32 0-d)``. ``order`` is the dense int64
    permutation ``torch.sort`` gives; ``seg`` dense int32 [n], ``starts``
    dense int64 [S], ``limit`` an int64 0-d tensor, ``limits`` dense
    int32 [S], all on its CUDA device. Raises on anything else, on a
    failed build and on a refused launch."""
    _require_cuda(order, "rank_keep_cuda")
    if mode not in RANK_MODES:
        raise ValueError(f"rank mode {mode!r}: one of {RANK_MODES}")
    if (limit is None) == (limits is None):
        raise ValueError("pass exactly one of limit (one scalar) and limits (one per segment)")
    if (seg is None) != (starts is None) or (limits is not None and seg is None):
        raise ValueError("seg and starts go together, and limits needs them")
    device = order.device
    n = int(order.shape[0])
    _check(order, "order", (torch.int64,), n, device)
    nrows_arg = _check_rows(n, nrows, row_valid, device)
    num = 0
    if seg is not None:
        num = int(starts.shape[0])  # type: ignore[union-attr]
        if not 1 <= num < 2**31:
            raise ValueError(f"{num} segments: the kernel takes 1 to 2^31 - 1")
        _check(seg, "seg", (torch.int32,), n, device)
        _check(starts, "starts", (torch.int64,), num, device)  # type: ignore[arg-type]
    if limits is not None:
        _check(limits, "limits", (torch.int32,), num, device)
    if limit is not None and (limit.device != device or limit.dtype != torch.int64
                              or limit.dim() != 0):
        raise ValueError(f"limit must be an int64 0-d tensor on {device}")
    keep = torch.empty((n,), dtype=torch.bool, device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_rank_keep(
        n, order.data_ptr(), nrows_arg, _ptr(row_valid), _ptr(seg), _ptr(starts), num,
        _ptr(limit), _ptr(limits), int(mode == "ge"), keep.data_ptr(), count.data_ptr(),
        index, stream, ctypes.byref(launched),
    )
    _raise_on(lib, err, "rank_keep")
    if launched.value:
        rank_keep_cuda.launches += 1
    return keep, count


rank_keep_cuda.launches = 0  # type: ignore[attr-defined]


def first_row_mask_cuda(
    first_idx: torch.Tensor,
    n: int,
    *,
    occupied: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,
    mode: str = "all",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13, with the contract of ``reference.first_row_mask_reference``:
    ``(keep bool[n], count int32 0-d)``. ``first_idx`` is dense int32
    [S] on a CUDA device, ``occupied`` dense bool [S] and ``counts`` dense
    int32 [S] beside it. With no segment the mask is cleared and nothing
    is launched."""
    _require_cuda(first_idx, "first_row_mask_cuda")
    if mode not in FIRST_ROW_MODES:
        raise ValueError(f"first-row mode {mode!r}: one of {FIRST_ROW_MODES}")
    if (mode == "all") != (counts is None):
        raise ValueError("counts go with the hit and miss modes only")
    if not 1 <= n < 2**31:
        raise ValueError(f"{n} rows: the kernel takes 1 to 2^31 - 1")
    device = first_idx.device
    num = int(first_idx.shape[0])
    _check(first_idx, "first_idx", (torch.int32,), num, device)
    if occupied is not None:
        _check(occupied, "occupied", (torch.bool,), num, device)
    if counts is not None:
        _check(counts, "counts", (torch.int32,), num, device)
    keep = torch.empty((n,), dtype=torch.bool, device=device)
    count = torch.empty((), dtype=torch.int32, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_first_row_mask(
        num, first_idx.data_ptr() if num else None, _ptr(occupied), _ptr(counts),
        FIRST_ROW_MODES.index(mode), n, keep.data_ptr(), count.data_ptr(), index, stream,
        ctypes.byref(launched),
    )
    _raise_on(lib, err, "first_row_mask")
    if launched.value:
        first_row_mask_cuda.launches += 1
    return keep, count


first_row_mask_cuda.launches = 0  # type: ignore[attr-defined]


def null_count_keep_cuda(
    masks: Sequence[torch.Tensor],
    ncols: int,
    n: int,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    how: str = "any",
    thresh: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14, with the contract of ``reference.null_count_keep_reference``:
    ``(keep bool[n], count int32 0-d)``. ``masks`` are dense bool [n] on
    ``device`` (a CUDA device), read through one device array of their
    pointers, so their number has no cap."""
    if how not in DROPNA_HOWS:
        raise ValueError(f"dropna how {how!r}: one of {DROPNA_HOWS}")
    if device is None:
        device = masks[0].device if masks else (
            row_valid.device if row_valid is not None else torch.device("cpu"))
    if device.type != "cuda":
        raise ValueError("null_count_keep_cuda takes CUDA tensors only")
    if not len(masks) <= ncols < 2**31:
        raise ValueError(f"{ncols} columns with {len(masks)} masks")
    nrows_arg = _check_rows(n, nrows, row_valid, device)
    for j, m in enumerate(masks):
        _check(m, f"mask {j}", (torch.bool,), n, device)
    ptrs = None
    if masks:
        ptrs = torch.tensor([m.data_ptr() for m in masks], dtype=torch.int64).to(device)
    keep = torch.empty((n,), dtype=torch.bool, device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    mode = 2 if thresh is not None else DROPNA_HOWS.index(how)
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_null_count_keep(
        n, nrows_arg, _ptr(row_valid), _ptr(ptrs), len(masks), ncols, mode,
        int(thresh or 0), keep.data_ptr(), count.data_ptr(), index, stream,
        ctypes.byref(launched),
    )
    _raise_on(lib, err, "null_count_keep")
    if launched.value:
        null_count_keep_cuda.launches += 1
    return keep, count


null_count_keep_cuda.launches = 0  # type: ignore[attr-defined]
