"""The wrapper of ``segment_sums.cu``: checks its tensors, allocates the
outputs and launches the fused binned-aggregate kernel on PyTorch's
current stream.

``binned_sums_cuda.launches`` counts the kernel's launches (it grows by
one where the kernel is launched and nowhere else);
``binned_sums_cuda.last_path`` names the path of the last call:
``"shared"`` (block replicas in shared memory), ``"global"`` (atomics
straight into the outputs) or ``"none"`` (nothing to sum, no launch), and
``binned_sums_cuda.last_variant`` the ``Variant`` the last launch took
(and its grid). ``segment_sums_cuda`` is the one-key form of the same
kernel over precomputed segment ids."""

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.reference import (
    MAX_KEYS,
    BinKey,
    Payload,
    bin_total,
    float_sum_dtype,
)

MAX_PAYLOADS = 8  # of each kind per launch; more are split over launches
_PATHS = {0: "none", 1: "shared", 2: "global"}
# dtype codes of segment_sums.cu
_CODES = {
    torch.bool: 0, torch.uint8: 1, torch.int8: 2, torch.int16: 3,
    torch.int32: 4, torch.int64: 5, torch.float32: 6, torch.float64: 7, torch.float16: 8,
}
_INT_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)
_FLOAT_DTYPES = (torch.float16, torch.float32, torch.float64)
_FLAG_DTYPES = (torch.bool, torch.uint8)


class Variant(NamedTuple):
    """A launch variant of the kernel; 0 takes the kernel's default.
    ``vec``: rows per tile, 1 or 4 (4 needs every column aligned to its
    tile, else 1 is taken); ``unroll``: tiles per thread per loop
    iteration, 1, 2 or 4; ``replicas``: shared-memory accumulator replicas
    per block, 1 (one per block) to 8 (one per warp)."""

    vec: int = 0
    unroll: int = 0
    replicas: int = 0


def _bind() -> ctypes.CDLL:
    return build.load("segment_sums", _declare)


def _declare(lib: ctypes.CDLL) -> None:
    """The library's argument types, set once as it loads."""
    fn = lib.fugue_binned_sums
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp, ip, llp = ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(ll)
    fn.argtypes = [
        ll, p, i,  # n, row_valid, nkeys
        pp, pp, ip, llp, llp,  # key data, masks, codes, kmin, span
        i, pp, pp, ip, i,  # nf, data, masks, codes, f64
        i, pp,  # nc, flags
        i, pp, pp, ip,  # ni, data, masks, codes
        i, p, p, p,  # occupancy, fout, cout, iout
        i, i, i,  # vec, unroll, replicas
        i, p, ip,  # device, stream, info
    ]
    fn.restype = i
    lib.fugue_cuda_error_string.argtypes = [i]
    lib.fugue_cuda_error_string.restype = ctypes.c_char_p


def _check(t: torch.Tensor, name: str, dtypes: Tuple[torch.dtype, ...], n: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the keys on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != (n,) or (n > 1 and t.stride(0) != 1):
        raise ValueError(f"{name} must be a dense 1-D tensor of {n} rows")


def _ptrs(ts: Sequence[Optional[torch.Tensor]]) -> "ctypes.Array":
    return (ctypes.c_void_p * max(len(ts), 1))(
        *[None if t is None else t.data_ptr() for t in ts]
    )


def _ints(xs: Sequence[int], ctype: type) -> "ctypes.Array":
    return (ctype * max(len(xs), 1))(*xs)


def binned_sums_cuda(
    keys: Sequence[BinKey],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    floats: Sequence[Payload] = (),
    counts: Sequence[torch.Tensor] = (),
    ints: Sequence[Payload] = (),
    occupancy: bool = True,
    f64: bool = False,
    variant: Optional[Variant] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused kernel, with the contract of
    ``reference.binned_sums_reference``. Every tensor must be a dense 1-D
    CUDA tensor of the keys' length on one device; raises on anything
    else, on a failed build and on a refused launch. ``variant`` is for
    measuring the kernel's variants; the default is the kernel's own."""
    if len(keys) == 0 or not keys[0].data.is_cuda:
        raise ValueError("binned_sums_cuda takes CUDA tensors only")
    if len(keys) > MAX_KEYS:
        raise ValueError(f"{len(keys)} keys: the kernel takes 1 to {MAX_KEYS}")
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    device = keys[0].data.device
    n = int(keys[0].data.shape[0])
    total = bin_total(keys)
    for j, k in enumerate(keys):
        _check(k.data, f"key {j}", _INT_DTYPES, n, device)
        if k.mask is not None:
            _check(k.mask, f"key {j} mask", (torch.bool,), n, device)
    if row_valid is not None:
        _check(row_valid, "row_valid", _FLAG_DTYPES, n, device)
        scan_n = n
    else:
        if not 0 <= int(nrows) <= n:  # type: ignore[arg-type]
            raise ValueError(f"nrows {nrows} outside [0, {n}]")
        scan_n = int(nrows)  # type: ignore[arg-type]
    for j, (v, m) in enumerate(floats):
        _check(v, f"float payload {j}", _FLOAT_DTYPES, n, device)
        if m is not None:
            _check(m, f"float payload {j} mask", (torch.bool,), n, device)
    for j, c in enumerate(counts):
        _check(c, f"count flags {j}", _FLAG_DTYPES, n, device)
    for j, (v, m) in enumerate(ints):
        _check(v, f"int payload {j}", _INT_DTYPES, n, device)
        if m is not None:
            _check(m, f"int payload {j} mask", (torch.bool,), n, device)
    fdtype = float_sum_dtype(floats, f64)
    occ = int(bool(occupancy))
    fout = torch.zeros((len(floats), total), dtype=fdtype, device=device)
    cout = torch.zeros((occ + len(counts), total), dtype=torch.int32, device=device)
    iout = torch.zeros((len(ints), total), dtype=torch.int64, device=device)
    var = variant or Variant()
    lib = _bind()
    stream = torch.cuda.current_stream(device).cuda_stream
    key_args = (
        _ptrs([k.data for k in keys]),
        _ptrs([k.mask for k in keys]),
        _ints([_CODES[k.data.dtype] for k in keys], ctypes.c_int),
        _ints([int(k.kmin) for k in keys], ctypes.c_longlong),
        _ints([int(k.span) for k in keys], ctypes.c_longlong),
    )
    binned_sums_cuda.last_path = "none"
    parts = max(
        1, *(-(-len(x) // MAX_PAYLOADS) for x in (floats, counts, ints))
    )
    for part in range(parts):
        lo, hi = part * MAX_PAYLOADS, (part + 1) * MAX_PAYLOADS
        fs, cs, is_ = floats[lo:hi], counts[lo:hi], ints[lo:hi]
        # the occupancy row is counted once, by the first launch
        occ_j = occ if part == 0 else 0
        crow = 0 if part == 0 else occ + lo
        info = (ctypes.c_int * 5)()
        err = lib.fugue_binned_sums(
            scan_n, None if row_valid is None else row_valid.data_ptr(), len(keys),
            *key_args,
            len(fs), _ptrs([v for v, _ in fs]), _ptrs([m for _, m in fs]),
            _ints([_CODES[v.dtype] for v, _ in fs], ctypes.c_int),
            int(fdtype == torch.float64),
            len(cs), _ptrs(list(cs)),
            len(is_), _ptrs([v for v, _ in is_]), _ptrs([m for _, m in is_]),
            _ints([_CODES[v.dtype] for v, _ in is_], ctypes.c_int),
            occ_j,
            fout[lo:].data_ptr() if len(fs) else None,
            cout[crow:].data_ptr() if len(cs) or occ_j else None,
            iout[lo:].data_ptr() if len(is_) else None,
            var.vec, var.unroll, var.replicas,
            device.index if device.index is not None else torch.cuda.current_device(),
            stream, info,
        )
        if err != 0:
            msg = lib.fugue_cuda_error_string(err).decode()
            raise RuntimeError(f"binned_sums kernel launch failed: {msg} ({err})")
        if info[0] != 0:
            binned_sums_cuda.launches += 1
            binned_sums_cuda.last_path = _PATHS[info[0]]
            binned_sums_cuda.last_variant = (Variant(info[1], info[2], info[3]), info[4])
    return fout, cout, iout


binned_sums_cuda.launches = 0  # type: ignore[attr-defined]
binned_sums_cuda.last_path = "none"  # type: ignore[attr-defined]
binned_sums_cuda.last_variant = None  # type: ignore[attr-defined]


def segment_sums_cuda(
    seg: torch.Tensor,
    fpack: torch.Tensor,
    cpack: torch.Tensor,
    ipack: torch.Tensor,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The contract of ``reference.segment_sums_reference`` as the one-key
    case of the fused kernel: ``seg`` is the key, with ``kmin = 0`` and
    ``span = total``, so a row with ``seg < 0`` or ``seg >= total`` is
    dropped. ``fpack`` [F, n], ``cpack`` [C, n] and ``ipack`` [I, n] are
    the payloads; there is no occupancy row."""
    if not seg.is_cuda:
        raise ValueError("segment_sums_cuda takes CUDA tensors only")
    if seg.dtype != torch.int32:
        raise ValueError(f"seg has dtype {seg.dtype}, expected torch.int32")
    if not 0 < total < 2**31:
        raise ValueError(f"total {total} out of range")
    rows: List[List[torch.Tensor]] = [list(pack) for pack in (fpack, cpack, ipack)]
    return binned_sums_cuda(
        [BinKey(seg, None, 0, total)],
        nrows=int(seg.shape[0]),
        floats=[(v, None) for v in rows[0]],
        counts=rows[1],
        ints=[(v, None) for v in rows[2]],
        occupancy=False,
    )
