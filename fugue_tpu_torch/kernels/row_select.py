"""The wrappers of ``row_select.cu``: check their tensors, allocate the
outputs and launch the row-selection kernels on PyTorch's current stream.

- ``rank_keep_cuda`` (K12): keep flags by each sorted position's rank
  within its segment (the segment read in sorted order), against one
  limit (a device scalar) or one per segment, with the kept count;
- ``first_row_mask_cuda`` (K13): each segment's first row where its
  predicate holds, with the count;
- ``null_count_keep_cuda`` (K14): dropna's keep flags from the columns'
  null masks, with the count (16 rows a load a mask, the mask pointers by
  value).

K12 and K13 partition their kept rows by slab of 2^18 rows into scratch
buckets, then build each slab's bits in shared memory and write its part
of the keep mask once (``row_select.cu``); the wrapper allocates the
scratch (4 bytes a row), the mask and the count.

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
from fugue_tpu_torch.kernels.reference import DROPNA_HOWS, FIRST_ROW_MODES, check_rank_args


def _bind() -> ctypes.CDLL:
    lib = build.load("row_select")
    if lib.fugue_rank_keep.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(i)
        lib.fugue_rank_keep.argtypes = [
            ll, p,  # n, order
            p, i, i, i, p, ll,  # seg, seg_bytes, word, shift, starts, num
            p, p, i,  # limit, limits, ge
            p, p, p, p, i, p, ip,  # slots, fill, keep, count, device, stream, launched
        ]
        lib.fugue_first_row_mask.argtypes = [
            ll, p, p, p, i,  # num, first_idx, occupied, counts, mode
            ll, p, p, p, p, i, p, ip,  # n, slots, fill, keep, count, device, stream, launched
        ]
        lib.fugue_null_count_keep.argtypes = [
            ll, ll, p,  # n, nrows, row_valid
            ctypes.POINTER(p), p, i, i, i, i,  # masks, dev_masks, nmasks, ncols, mode, thresh
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


SLAB_ROWS = 1 << 18  # row_select.cu's kSlabRows


def _outputs(n: int, device: torch.device) -> Tuple[int, int, torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """K12's and K13's scratch, keep mask and count, uninitialised (the
    launch clears the fill counts and writes the rest): ``(slots, fill,
    scratch, keep, count)``, ``slots`` and ``fill`` the addresses in
    ``scratch`` of a bucket of ``SLAB_ROWS`` int32 offsets a slab of rows
    (4 bytes a row) and of each bucket's fill count."""
    nslabs = -(-n // SLAB_ROWS)
    scratch = torch.empty((nslabs * (SLAB_ROWS + 1),), dtype=torch.int32, device=device)
    slots = scratch.data_ptr()
    return (slots, slots + 4 * nslabs * SLAB_ROWS, scratch,
            torch.empty((n,), dtype=torch.bool, device=device),
            torch.empty((), dtype=torch.int32, device=device))


def rank_keep_cuda(
    order: torch.Tensor,
    *,
    seg: Optional[torch.Tensor] = None,
    word_shift: Optional[int] = None,
    starts: Optional[torch.Tensor] = None,
    limit: Optional[torch.Tensor] = None,
    limits: Optional[torch.Tensor] = None,
    mode: str = "lt",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12, with the contract of ``reference.rank_keep_reference``:
    ``(keep bool[n], count int32 0-d)``. ``order`` is the dense int64
    permutation ``torch.sort`` gives; ``seg`` dense [n] in sorted order
    (an int32 id, or with ``word_shift`` an int32 or int64 K11 word),
    ``starts`` dense int64 [S], ``limit`` an int64 0-d tensor, ``limits``
    dense int32 [S], all on its CUDA device. Raises on anything else, on a
    failed build and on a refused launch."""
    _require_cuda(order, "rank_keep_cuda")
    check_rank_args(seg, word_shift, starts, limit, limits, mode)
    device = order.device
    n = int(order.shape[0])
    if not 1 <= n < 2**31:
        raise ValueError(f"{n} rows: the kernel takes 1 to 2^31 - 1")
    _check(order, "order", (torch.int64,), n, device)
    num = 0
    if seg is not None:
        num = int(starts.shape[0])  # type: ignore[union-attr]
        if num >= 2**31:
            raise ValueError(f"{num} segments: the kernel takes at most 2^31 - 1")
        _check(seg, "seg", (seg.dtype,), n, device)
        _check(starts, "starts", (torch.int64,), num, device)  # type: ignore[arg-type]
    if limits is not None:
        _check(limits, "limits", (torch.int32,), num, device)
    if limit is not None and (limit.device != device or limit.dtype != torch.int64
                              or limit.dim() != 0):
        raise ValueError(f"limit must be an int64 0-d tensor on {device}")
    slots, fill, _scratch, keep, count = _outputs(n, device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_rank_keep(
        n, order.data_ptr(), _ptr(seg), 0 if seg is None else seg.element_size(),
        int(word_shift is not None), int(word_shift or 0), _ptr(starts) or None, num,
        _ptr(limit), _ptr(limits) or None, int(mode == "ge"), slots, fill, keep.data_ptr(),
        count.data_ptr(), index, stream, ctypes.byref(launched),
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
    int32 [S] beside it. With no segment the launch clears the mask."""
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
    slots, fill, _scratch, keep, count = _outputs(n, device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_first_row_mask(
        num, first_idx.data_ptr() if num else None, _ptr(occupied), _ptr(counts),
        FIRST_ROW_MODES.index(mode), n, slots, fill, keep.data_ptr(), count.data_ptr(), index,
        stream, ctypes.byref(launched),
    )
    _raise_on(lib, err, "first_row_mask")
    if launched.value:
        first_row_mask_cuda.launches += 1
    return keep, count


first_row_mask_cuda.launches = 0  # type: ignore[attr-defined]


PARAM_MASKS = 64  # row_select.cu's kParamMasks: mask pointers passed by value
_ROUTES = {1: "vector", 2: "scalar"}  # fugue_null_count_keep's *launched


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
    ``device`` (a CUDA device). Up to ``PARAM_MASKS`` of them go to the
    kernel by value, so the call copies nothing to the card; more go
    through a device array of their pointers, copied from pinned memory
    without blocking. ``last_path`` names the route: ``"vector"`` (every
    mask, ``row_valid`` and the output 16-byte aligned: 16 rows a load) or
    ``"scalar"``."""
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
    ptrs = [m.data_ptr() for m in masks]
    dev_ptrs = None
    if len(masks) > PARAM_MASKS:
        dev_ptrs = torch.tensor(ptrs, dtype=torch.int64, pin_memory=True).to(device,
                                                                             non_blocking=True)
    keep = torch.empty((n,), dtype=torch.bool, device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    mode = 2 if thresh is not None else DROPNA_HOWS.index(how)
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_null_count_keep(
        n, nrows_arg, _ptr(row_valid), (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs),
        _ptr(dev_ptrs), len(masks), ncols, mode, int(thresh or 0), keep.data_ptr(),
        count.data_ptr(), index, stream, ctypes.byref(launched),
    )
    _raise_on(lib, err, "null_count_keep")
    if launched.value:
        null_count_keep_cuda.launches += 1
        null_count_keep_cuda.last_path = _ROUTES[launched.value]
    return keep, count


null_count_keep_cuda.launches = 0  # type: ignore[attr-defined]
null_count_keep_cuda.last_path = None  # type: ignore[attr-defined]
