"""The wrapper of ``gather.cu``: ``gather_rows_cuda`` (K10) checks the
columns and the index, allocates the outputs and gathers every column of
one join side, ``MAX_COLUMNS`` columns a launch on PyTorch's current
stream, with the contract of ``reference.gather_rows_reference``. Its
``launches`` grows by one for each ``MAX_COLUMNS`` columns it gathers and
nowhere else, whatever the route.

Two routes (``gather_route``): ``"direct"``, a thread an output row; and
``"slab"``, where the caller says the index reads its sources at random
(``scattered``), the sources are larger than L2 and two columns or more
pack into one pass: the output positions grouped by source slab, each
slab's reads then inside L2, and each output slab built in a cluster's
shared memory (``gather.cu``).
``gather_rows_cuda.last_route`` names the last call's route; after a slab
route, ``.last_fill`` holds each output slab's bucket count (each must be
its slab's rows) and ``.last_sources`` the source buckets' counts, starts
and cursors (``SlabSources``).

``gather_rows`` is what the callers call: the kernel for a CUDA index,
its twin for a CPU one; ``gather_rows.last_route`` is the route the
wrapper takes, or would take, for that call."""

import ctypes
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from fugue_tpu_torch.kernels import build, kernel_for
from fugue_tpu_torch.kernels.factorize import _check, _device_and_stream, _ptrs, _require_cuda
from fugue_tpu_torch.kernels.reference import GatherColumn, Payload, gather_rows_reference

MAX_COLUMNS = 8  # per launch, as gather.cu takes them
GROUP_BYTES = 8  # the slab route's elements a row a pass (kGroupBytes in gather.cu)
IMAGE_ROW_BYTES = 14  # its image's bytes a row (kImageRowBytes)
# sources of at most this many bytes (elements and masks) are read from L2
# on the direct route, whatever the index: an H100 has 50 MB of it
L2_DIRECT_BYTES = 16 << 20
# below one output slab of rows the slab route's launches outweigh its
# reads (2^kDstShift in gather.cu)
SLAB_MIN_ROWS = 1 << 17


class SlabSources(NamedTuple):
    """Step 1's source buckets (each source slab, then the holes): the
    entries counted, each bucket's start (and the total) and where the
    partition left its cursor, which must be the next bucket's start."""

    counts: torch.Tensor
    starts: torch.Tensor
    cursor: torch.Tensor


def _bind() -> ctypes.CDLL:
    return build.load("gather", _declare)


def _declare(lib: ctypes.CDLL) -> None:
    """The library's argument types, set once as it loads."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp, ip, llp = ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(ll)
    lib.fugue_gather_rows.argtypes = [
        ll, p, i,  # n, idx, ncols
        pp, pp, pp, pp, ip,  # data, out, mask, out_mask, width
        i, p, ip,  # device, stream, launched
    ]
    lib.fugue_gather_slab_shape.argtypes = [ll, ll, ip, ip, llp]
    lib.fugue_gather_slab_shape.restype = None
    lib.fugue_gather_slab_sources.argtypes = [ll, p, ll, p, p, i, p]
    lib.fugue_gather_slab_columns.argtypes = [
        ll, p, i,  # n, entries, ncols
        pp, pp, pp, pp, ip, llp,  # data, out, mask, out_mask, width, rows
        p, p, i, p, ip,  # rec, fill, device, stream, launched
    ]
    lib.fugue_gather_slab_record_bytes.argtypes = [i, ip, ip]
    lib.fugue_gather_slab_record_bytes.restype = i
    for fn in (lib.fugue_gather_rows, lib.fugue_gather_slab_sources,
               lib.fugue_gather_slab_columns):
        fn.restype = i
    lib.fugue_gather_error_string.argtypes = [i]
    lib.fugue_gather_error_string.restype = ctypes.c_char_p


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.fugue_gather_error_string(err).decode()
        raise RuntimeError(f"gather_rows kernel launch failed: {msg} ({err})")


def source_bytes(columns: Sequence[GatherColumn]) -> int:
    """The bytes the gather reads from its sources: every element and
    mask byte of every column."""
    return sum(int(v.shape[0]) * (v.element_size() + (m is not None)) for v, m in columns)


def column_groups(widths: Sequence[int], masked: Sequence[bool]) -> List[Tuple[int, int]]:
    """The slab route's column groups, as ``group_end`` in ``gather.cu``
    forms them from each ``MAX_COLUMNS`` columns: elements of at most
    ``GROUP_BYTES`` a row, packed into one record, and an image row (the
    packed elements, 4 or 8 B, and a mask byte a masked column) of at most
    ``IMAGE_ROW_BYTES``."""
    out: List[Tuple[int, int]] = []
    for lo in range(0, len(widths), MAX_COLUMNS):
        hi, g0 = min(lo + MAX_COLUMNS, len(widths)), lo
        while g0 < hi:
            g1, used, masks = g0, 0, 0
            while g1 < hi:
                w, m = used + widths[g1], masks + bool(masked[g1])
                if w > GROUP_BYTES or (8 if w > 4 else 4) + m > IMAGE_ROW_BYTES:
                    break
                used, masks, g1 = w, m, g1 + 1
            out.append((g0, g1))
            g0 = g1
    return out


def gather_route(columns: Sequence[GatherColumn], n: int, scattered: bool,
                 outer: bool = False) -> str:
    """K10's route for ``n`` output rows of ``columns``: ``"slab"`` where
    the index is scattered, the output has a slab of rows at least, the
    sources are larger than ``L2_DIRECT_BYTES`` and the slab route packs
    two columns or more into one of its passes (``column_groups``: a pass
    of one 8-byte column, 3.4 ms at 100M permuted rows, costs what the
    direct route's random reads of it do, 3.6 ms, on an NVIDIA H100 80GB
    HBM3 at 700 W; PERF.md §6); else ``"direct"``."""
    if not (scattered and n >= SLAB_MIN_ROWS and source_bytes(columns) > L2_DIRECT_BYTES):
        return "direct"
    groups = column_groups([c.values.element_size() for c in columns],
                           [c.mask is not None or outer for c in columns])
    return "slab" if len(groups) < len(columns) else "direct"


def gather_rows_cuda(
    columns: Sequence[GatherColumn], idx: torch.Tensor, *, outer: bool = False,
    scattered: bool = False,
) -> List[Payload]:
    """K10. ``idx`` is a dense int32 CUDA tensor of -1 or rows of the
    columns; each column a dense 1-D tensor of one length on its device,
    with an optional bool mask. ``scattered``: the index reads the sources
    at random (a permutation, a hash order, a sort's order), which picks
    the slab route where the sources are larger than L2. Raises on
    anything else, on a failed build and on a refused launch."""
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
    route = gather_route(columns, n, scattered, outer)
    gather_rows_cuda.last_route = route
    if n == 0 or not columns:
        return outs
    lib = _bind()
    index, stream = _device_and_stream(device)
    widths = [c.values.element_size() for c in columns]
    if route == "slab":
        _slab(lib, columns, idx, outs, widths, index, stream)
        return outs
    for lo in range(0, len(columns), MAX_COLUMNS):
        part = range(lo, min(lo + MAX_COLUMNS, len(columns)))
        launched = ctypes.c_int(0)
        err = lib.fugue_gather_rows(
            n, idx.data_ptr(), len(part),
            _ptrs([columns[c].values for c in part]), _ptrs([outs[c][0] for c in part]),
            _ptrs([columns[c].mask for c in part]), _ptrs([outs[c][1] for c in part]),
            (ctypes.c_int * len(part))(*[widths[c] for c in part]),
            index, stream, ctypes.byref(launched),
        )
        _raise_on(lib, err)
        if launched.value:
            gather_rows_cuda.launches += 1
    return outs


def _slab(lib: ctypes.CDLL, columns: Sequence[GatherColumn], idx: torch.Tensor,
          outs: List[Payload], widths: List[int], index: int, stream: Any) -> None:
    """The slab route: step 1 once, then steps 2 and 3 for each
    ``MAX_COLUMNS`` columns; its scratch is 16 or 24 B a row (8 B entries,
    8 or 16 B records) and a few ints a slab."""
    device = idx.device
    n = int(idx.shape[0])
    src_rows = max(int(c.values.shape[0]) for c in columns)
    src_shift, dst_shift, meta_ints = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    lib.fugue_gather_slab_shape(n, src_rows, ctypes.byref(src_shift), ctypes.byref(dst_shift),
                                ctypes.byref(meta_ints))
    nb = -(-src_rows >> src_shift.value) + 1
    meta = torch.empty((meta_ints.value,), dtype=torch.int32, device=device)
    entries = torch.empty((n,), dtype=torch.int64, device=device)
    parts = [range(lo, min(lo + MAX_COLUMNS, len(columns)))
             for lo in range(0, len(columns), MAX_COLUMNS)]
    rec_bytes = max(lib.fugue_gather_slab_record_bytes(
        len(part), (ctypes.c_int * len(part))(*[widths[c] for c in part]),
        (ctypes.c_int * len(part))(*[outs[c][1] is not None for c in part])) for part in parts)
    rec = torch.empty((n * rec_bytes,), dtype=torch.uint8, device=device)
    fill = meta[3 * nb + 1:]
    _raise_on(lib, lib.fugue_gather_slab_sources(n, idx.data_ptr(), src_rows, meta.data_ptr(),
                                                 entries.data_ptr(), index, stream))
    for part in parts:
        launched = ctypes.c_int(0)
        err = lib.fugue_gather_slab_columns(
            n, entries.data_ptr(), len(part),
            _ptrs([columns[c].values for c in part]), _ptrs([outs[c][0] for c in part]),
            _ptrs([columns[c].mask for c in part]), _ptrs([outs[c][1] for c in part]),
            (ctypes.c_int * len(part))(*[widths[c] for c in part]),
            (ctypes.c_longlong * len(part))(*[int(columns[c].values.shape[0]) for c in part]),
            rec.data_ptr(), fill.data_ptr(), index, stream, ctypes.byref(launched),
        )
        _raise_on(lib, err)
        if launched.value:
            gather_rows_cuda.launches += 1
    gather_rows_cuda.last_fill = fill
    gather_rows_cuda.last_shift = (src_shift.value, dst_shift.value)
    gather_rows_cuda.last_sources = SlabSources(meta[:nb], meta[nb:2 * nb + 1],
                                                meta[2 * nb + 1:3 * nb + 1])


gather_rows_cuda.launches = 0  # type: ignore[attr-defined]
gather_rows_cuda.last_route = None  # type: ignore[attr-defined]
gather_rows_cuda.last_fill = None  # type: ignore[attr-defined]
gather_rows_cuda.last_shift = None  # type: ignore[attr-defined]
gather_rows_cuda.last_sources = None  # type: ignore[attr-defined]


def gather_rows(
    columns: Sequence[GatherColumn], idx: torch.Tensor, *, outer: bool = False,
    scattered: bool = False,
) -> List[Payload]:
    """K10 (``gather_rows_cuda``) for a CUDA index, its twin for a CPU
    one; ``scattered`` as the wrapper takes it. ``gather_rows.last_route``
    is the wrapper's route for the call, on either device."""
    run = kernel_for(idx, gather_rows_cuda, gather_rows_reference, "gather rows")
    gather_rows.last_route = gather_route(columns, int(idx.shape[0]), scattered, outer)
    if run is gather_rows_reference:
        return run(columns, idx, outer=outer)
    return run(columns, idx, outer=outer, scattered=scattered)


gather_rows.last_route = None  # type: ignore[attr-defined]
