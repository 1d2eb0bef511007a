"""The wrappers of ``segment_reduce.cu``: check their tensors, allocate
and fill the outputs and launch the per-segment reduction kernels on
PyTorch's current stream.

- ``segment_extrema_cuda`` (K4): per payload the min and/or max over each
  segment, and the first and last counted row of each segment;
- ``segment_sq_dev_cuda`` (K5): per payload the float64 sum of squared
  deviations from each segment's mean.

Each has the contract of its twin in ``reference.py``. More than
``MAX_PAYLOADS`` payloads are split over launches. Each wrapper's
``launches`` grows by one where it launches its kernel and nowhere else;
its ``last_path`` names where the last launch kept its tables:
``"shared"`` (1-8 replicas per block in shared memory, merged into the
global tables at the end) or ``"global"`` (updated in place)."""

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.factorize import _check, _device_and_stream, _ptrs, _require_cuda
from fugue_tpu_torch.kernels.reference import Extrema, Extremum, Payload

MAX_PAYLOADS = 8  # per launch, as segment_reduce.cu takes them
MAX_TABLES = 2 * MAX_PAYLOADS + 2  # per fill or decode launch
_PATHS = {1: "shared", 2: "global"}
# dtype codes of bin_keys.cuh
_CODES = {
    torch.bool: 0, torch.uint8: 1, torch.int8: 2, torch.int16: 3,
    torch.int32: 4, torch.int64: 5, torch.float32: 6, torch.float64: 7, torch.float16: 8,
}
_FLOATS = (torch.float32, torch.float64)


def _bind() -> ctypes.CDLL:
    lib = build.load("segment_reduce")
    if lib.fugue_segment_extrema.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pp, ip = ctypes.POINTER(p), ctypes.POINTER(i)
        lib.fugue_segment_extrema.argtypes = [
            ll, p, p, i,  # n, row_valid, seg, num
            i, pp, pp, ip,  # payloads: count, data, masks, codes
            i, pp, ip, ip, ip,  # tables: count, outs, wide, is_max, src
            i, p, ip,  # device, stream, path
        ]
        lib.fugue_segment_sq_dev.argtypes = [
            ll, p, p, i,  # n, row_valid, seg, num
            i, pp, pp, ip,  # payloads: count, data, masks, codes
            p, p,  # mean, out
            i, p, ip,  # device, stream, path
        ]
        lib.fugue_segment_extrema_fill.argtypes = [
            i, pp, ip, ip, i, i, p,  # tables: count, codes, wide, is_max; num, device, stream
        ]
        lib.fugue_segment_extrema_decode.argtypes = [
            i, pp, ip, ip, ip, pp, i, i, p,  # ... and each table's dtype code and output
        ]
        for fn in (lib.fugue_segment_extrema, lib.fugue_segment_sq_dev,
                   lib.fugue_segment_extrema_fill, lib.fugue_segment_extrema_decode):
            fn.restype = i
        lib.fugue_reduce_error_string.argtypes = [i]
        lib.fugue_reduce_error_string.restype = ctypes.c_char_p
    return lib


def _check_seg(seg: torch.Tensor, num: int, nrows: Optional[int],
               row_valid: Optional[torch.Tensor], fn: str) -> Tuple[int, int]:
    """``(n, rows to scan)`` of a launch over ``seg``."""
    _require_cuda(seg, fn)
    n = int(seg.shape[0])
    if not 1 <= n < 2**31:
        raise ValueError(f"{n} rows: the kernels take 1 to 2^31 - 1")
    if not 1 <= num < 2**31:
        raise ValueError(f"num {num} outside [1, 2^31 - 1]")
    _check(seg, "seg", (torch.int32,), n, seg.device)
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    if row_valid is not None:
        _check(row_valid, "row_valid", (torch.bool, torch.uint8), n, seg.device)
        scan = n
    else:
        if not 0 <= int(nrows) <= n:  # type: ignore[arg-type]
            raise ValueError(f"nrows {nrows} outside [0, {n}]")
        scan = int(nrows)  # type: ignore[arg-type]
    return n, scan


def _ints(xs: Sequence[int]) -> "ctypes.Array":
    return (ctypes.c_int * max(len(xs), 1))(*xs)


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fugue_reduce_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _tables(lib: ctypes.CDLL, decode: bool, tables: List[Tuple[torch.Tensor, bool, int,
                                                                Optional[torch.Tensor]]],
            num: int, index: int, stream: int) -> None:
    """Fill K4's code tables ``(codes, is_max, dtype code, output)`` with
    their identities, or decode them into their outputs (dtype code -1:
    a last row's table into int32 indexes), one launch a ``MAX_TABLES``."""
    for lo in range(0, len(tables), MAX_TABLES):
        part = tables[lo:lo + MAX_TABLES]
        codes = _ptrs([c for c, _, _, _ in part])
        wide = _ints([c.element_size() == 8 for c, _, _, _ in part])
        is_max = _ints([int(m) for _, m, _, _ in part])
        if decode:
            err = lib.fugue_segment_extrema_decode(
                len(part), codes, wide, is_max, _ints([d for _, _, d, _ in part]),
                _ptrs([o for _, _, _, o in part]), num, index, stream)
        else:
            err = lib.fugue_segment_extrema_fill(len(part), codes, wide, is_max, num, index,
                                                 stream)
        _raise_on(lib, err, "segment_extrema's table")


def segment_extrema_cuda(
    seg: torch.Tensor,
    num: int,
    payloads: Sequence[Extremum],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    first: bool = False,
    last: bool = False,
) -> Extrema:
    """K4, with the contract of ``reference.segment_extrema_reference``.
    ``seg`` is a dense int32 CUDA tensor; payloads and masks dense 1-D
    tensors of its rows on its device. Raises on anything else, on a
    failed build and on a refused launch. The code tables are filled
    before the launches and decoded into the payloads' dtypes after them,
    each in one launch for every table."""
    n, scan = _check_seg(seg, num, nrows, row_valid, "segment_extrema_cuda")
    device = seg.device
    for j, p in enumerate(payloads):
        _check(p.values, f"payload {j}", tuple(_CODES), n, device)
        if p.mask is not None:
            _check(p.mask, f"payload {j} mask", (torch.bool,), n, device)
    # each table: (payload index or -1 for the row index, is_max)
    wanted = [(j, is_max) for j, p in enumerate(payloads)
              for is_max, want in ((False, p.min), (True, p.max)) if want]
    codes = {key: torch.empty((num,), device=device, dtype=torch.int64
                              if payloads[key[0]].values.element_size() == 8 else torch.int32)
             for key in wanted}
    outs = {key: torch.empty((num,), dtype=payloads[key[0]].values.dtype, device=device)
            for key in wanted}
    rows = [(-1, False)] * first + [(-1, True)] * last
    for key in rows:
        codes[key] = torch.empty((num,), dtype=torch.int32, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    keys = wanted + rows
    _tables(lib, False, [(codes[k], k[1], 0, None) for k in keys], num, index, stream)
    used = sorted({j for j, _ in wanted})
    for c in range(0, max(len(used), 1), MAX_PAYLOADS):
        srcs = used[c:c + MAX_PAYLOADS]
        local = {j: q for q, j in enumerate(srcs)}
        tables = [(local[j], is_max, codes[(j, is_max)]) for j, is_max in wanted if j in local]
        if c == 0:  # the row tables ride with the first launch
            tables += [(-1, key[1], codes[key]) for key in rows]
        path = ctypes.c_int(0)
        err = lib.fugue_segment_extrema(
            scan, None if row_valid is None else row_valid.data_ptr(), seg.data_ptr(), num,
            len(srcs), _ptrs([payloads[j].values for j in srcs]),
            _ptrs([payloads[j].mask for j in srcs]),
            _ints([_CODES[payloads[j].values.dtype] for j in srcs]),
            len(tables), _ptrs([t for _, _, t in tables]),
            _ints([t.element_size() == 8 for _, _, t in tables]),
            _ints([int(is_max) for _, is_max, _ in tables]),
            _ints([src for src, _, _ in tables]),
            index, stream, ctypes.byref(path),
        )
        _raise_on(lib, err, "segment_extrema")
        if path.value != 0:
            segment_extrema_cuda.launches += 1
            segment_extrema_cuda.last_path = _PATHS[path.value]
    if last:
        outs[(-1, True)] = torch.empty((num,), dtype=torch.int32, device=device)
    decoded = [(codes[k], k[1], _CODES[payloads[k[0]].values.dtype], outs[k]) for k in wanted]
    if last:
        decoded.append((codes[(-1, True)], True, -1, outs[(-1, True)]))
    _tables(lib, True, decoded, num, index, stream)
    mins = [outs.get((j, False)) for j in range(len(payloads))]
    maxs = [outs.get((j, True)) for j in range(len(payloads))]
    return Extrema(mins, maxs, codes[(-1, False)] if first else None,
                   outs[(-1, True)] if last else None)


segment_extrema_cuda.launches = 0  # type: ignore[attr-defined]
segment_extrema_cuda.last_path = None  # type: ignore[attr-defined]


def segment_sq_dev_cuda(
    seg: torch.Tensor,
    num: int,
    payloads: Sequence[Payload],
    means: torch.Tensor,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5, with the contract of ``reference.segment_sq_dev_reference``:
    float64 [P, num]. ``seg`` is a dense int32 CUDA tensor, payloads
    float32/float64 dense 1-D tensors of its rows with optional bool
    masks, ``means`` a float64 [P, num] tensor on its device."""
    n, scan = _check_seg(seg, num, nrows, row_valid, "segment_sq_dev_cuda")
    device = seg.device
    for j, (v, m) in enumerate(payloads):
        _check(v, f"payload {j}", _FLOATS, n, device)
        if m is not None:
            _check(m, f"payload {j} mask", (torch.bool,), n, device)
    if (means.device != device or means.dtype != torch.float64
            or tuple(means.shape) != (len(payloads), num)):
        raise ValueError(f"means must be float64 [{len(payloads)}, {num}] on {device}")
    means = means.contiguous()
    out = torch.zeros((len(payloads), num), dtype=torch.float64, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    for lo in range(0, len(payloads), MAX_PAYLOADS):
        part = payloads[lo:lo + MAX_PAYLOADS]
        path = ctypes.c_int(0)
        err = lib.fugue_segment_sq_dev(
            scan, None if row_valid is None else row_valid.data_ptr(), seg.data_ptr(), num,
            len(part), _ptrs([v for v, _ in part]), _ptrs([m for _, m in part]),
            _ints([_CODES[v.dtype] for v, _ in part]),
            means[lo:].data_ptr(), out[lo:].data_ptr(), index, stream, ctypes.byref(path),
        )
        _raise_on(lib, err, "segment_sq_dev")
        if path.value != 0:
            segment_sq_dev_cuda.launches += 1
            segment_sq_dev_cuda.last_path = _PATHS[path.value]
    return out


segment_sq_dev_cuda.launches = 0  # type: ignore[attr-defined]
segment_sq_dev_cuda.last_path = None  # type: ignore[attr-defined]
