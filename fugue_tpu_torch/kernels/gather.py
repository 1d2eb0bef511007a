"""The wrapper of ``gather.cu``: ``gather_rows_cuda`` (K10) checks the
columns and the index, allocates the outputs and gathers every column of
one join side in one launch per ``MAX_COLUMNS`` columns on PyTorch's
current stream, with the contract of ``reference.gather_rows_reference``.
Its ``launches`` grows by one where it launches the kernel and nowhere
else."""

import ctypes
from typing import List, Optional, Sequence

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.factorize import _check, _device_and_stream, _ptrs, _require_cuda
from fugue_tpu_torch.kernels.reference import GatherColumn, Payload

MAX_COLUMNS = 8  # per launch, as gather.cu takes them


def _bind() -> ctypes.CDLL:
    lib = build.load("gather")
    if lib.fugue_gather_rows.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pp, ip = ctypes.POINTER(p), ctypes.POINTER(i)
        lib.fugue_gather_rows.argtypes = [
            ll, p, i,  # n, idx, ncols
            pp, pp, pp, pp, ip,  # data, out, mask, out_mask, width
            i, p, ip,  # device, stream, launched
        ]
        lib.fugue_gather_rows.restype = i
        lib.fugue_gather_error_string.argtypes = [i]
        lib.fugue_gather_error_string.restype = ctypes.c_char_p
    return lib


def gather_rows_cuda(
    columns: Sequence[GatherColumn], idx: torch.Tensor, *, outer: bool = False
) -> List[Payload]:
    """K10. ``idx`` is a dense int32 CUDA tensor of -1 or rows of the
    columns; each column a dense 1-D tensor of one length on its device,
    with an optional bool mask. Raises on anything else, on a failed
    build and on a refused launch."""
    _require_cuda(idx, "gather_rows_cuda")
    device = idx.device
    n = int(idx.shape[0])
    if n >= 2**31:
        raise ValueError(f"{n} output rows: the kernel takes at most 2^31 - 1")
    _check(idx, "idx", (torch.int32,), n, device)
    outs: List[Payload] = []
    for j, (values, mask) in enumerate(columns):
        src = int(values.shape[0])
        if not 1 <= src < 2**31:
            raise ValueError(f"column {j} has {src} rows: the kernel takes 1 to 2^31 - 1")
        _check(values, f"column {j}", (values.dtype,), src, device)
        if mask is not None:
            _check(mask, f"column {j} mask", (torch.bool,), src, device)
        out_mask: Optional[torch.Tensor] = None
        if mask is not None or outer:
            out_mask = torch.empty((n,), dtype=torch.bool, device=device)
        outs.append((torch.empty((n,), dtype=values.dtype, device=device), out_mask))
    lib = _bind()
    index, stream = _device_and_stream(device)
    for lo in range(0, len(columns), MAX_COLUMNS):
        part = range(lo, min(lo + MAX_COLUMNS, len(columns)))
        launched = ctypes.c_int(0)
        err = lib.fugue_gather_rows(
            n, idx.data_ptr(), len(part),
            _ptrs([columns[c].values for c in part]), _ptrs([outs[c][0] for c in part]),
            _ptrs([columns[c].mask for c in part]), _ptrs([outs[c][1] for c in part]),
            (ctypes.c_int * len(part))(*[columns[c].values.element_size() for c in part]),
            index, stream, ctypes.byref(launched),
        )
        if err != 0:
            msg = lib.fugue_gather_error_string(err).decode()
            raise RuntimeError(f"gather_rows kernel launch failed: {msg} ({err})")
        if launched.value:
            gather_rows_cuda.launches += 1
    return outs


gather_rows_cuda.launches = 0  # type: ignore[attr-defined]
