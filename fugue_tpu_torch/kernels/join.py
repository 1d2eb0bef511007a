"""The wrappers of ``join.cu``: check their tensors, allocate and fill
the outputs and launch the join kernels on PyTorch's current stream.

- ``join_build_cuda`` (K7): the build side's per-segment counts, or the
  highest row of each segment (slot mode), and for NOT IN the side's
  real rows and real rows with a null key in two device ints;
- ``join_probe_cuda`` (K8): per probe row its segment's entry, written
  by mode (semi/anti/NOT IN keep flags, the unique route's build row, the
  expansion's matches and output rows) with a device total, from a narrow
  copy of K7's table (``probe_place``);
- ``join_expand_cuda`` (K9, two launches: the probe row of each tile's
  first output, then the tiles): each output row's probe row and build
  row.

Each has the contract of its twin in ``reference.py``. Each wrapper's
``launches`` grows by one where it launches its kernel and nowhere else
(K7's slab route: one a call, for its four launches; K8: one a call,
for its narrowing launch, its probe and, at the L2 place, the launch that
releases its table's lines);
``join_build_cuda.last_path`` names where its last launch kept its
tables: ``"shared"`` (a copy per block, up to ``SHARED_MAX`` segments),
``"global"`` (the table itself, while it stays in L2: up to
``GLOBAL_MAX`` segments) or ``"slab"`` (the rows partitioned by slab of
``2^SEG_SHIFT`` segments, each slab's table built in a block's shared
memory and written once); after a slab route, ``.last_slabs`` holds its
buckets (``SlabBuckets``). ``join_probe_cuda.last_path`` names where its
last launch read its table: ``"shared"``, ``"l2"`` or ``"wide"``
(``probe_place``)."""

import ctypes
from typing import Any, NamedTuple, Optional, Tuple

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.factorize import _check, _device_and_stream, _require_cuda
from fugue_tpu_torch.kernels.reference import PROBE_MODES, Probe

SHARED_MAX = 12288  # segments of K7's shared route (kSharedMax in join.cu)
# segments of K7's global route, whose table (4 B a segment, 32 MB) stays
# in L2: at 50M rows over 2^23 segments it took 0.86 ms against the slab
# route's 1.20, over 2^24 2.29 against 1.25 (NVIDIA H100 80GB HBM3, 700 W;
# old_vs_new.py's k7_routes, PERF.md §6)
GLOBAL_MAX = 1 << 23
_PATHS = {1: "shared", 2: "global"}
# K8's places of its table (kPlace* in join.cu): a copy in each block's
# shared memory, the narrow copy read under an L2 evict-last policy, or
# K7's int32 table itself
PROBE_PLACES = ("shared", "l2", "wide")
# a block's copy of byte entries or int32 slots, at most (kProbeSharedBytes
# in join.cu): expand over 200,000 segments took 0.464-0.466 ms from it
# against 0.484-0.486 from L2, unique over 16,384 slots 0.344-0.346 against
# 0.356; bits are never copied, as they ran faster through L2 and L1 at
# every size (semi at 100M probe rows over 1024 to 10^6 segments
# 0.207-0.224 against 0.215-0.33) (NVIDIA H100 80GB HBM3, 700 W;
# old_vs_new.py, PERF.md §6)
PROBE_SHARED_BYTES = 200 * 1024
_FLAGS = (torch.bool, torch.uint8)
_EXPAND_TILE = 2048  # K9's output rows a block (kTile in join.cu)


def _bind() -> ctypes.CDLL:
    lib = build.load("join")
    if lib.fugue_join_build.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(i)
        side = [ll, ll, p, p, p, i]  # n, nrows, row_valid, nulls, seg, num
        # slots, table, stats, device, stream, path
        lib.fugue_join_build.argtypes = side + [i, p, p, i, p, ip]
        # slots, table, stats, meta, entries, device, stream, launched
        lib.fugue_join_build_slab.argtypes = side + [i, p, p, p, p, i, p, ip]
        lib.fugue_join_slab_shape.argtypes = [ll, i, i, ctypes.POINTER(ll),
                                              ctypes.POINTER(ll)]
        lib.fugue_join_slab_shape.restype = None
        lib.fugue_join_probe.argtypes = side + [
            p, p, i, i, i, p,  # table, stats, mode, outer, place, narrow
            p, p, p, p, p, p,  # keep, ridx, m, reps, count, total
            i, p, ip,  # device, stream, launched
        ]
        lib.fugue_join_expand.argtypes = [
            ll, ll, p, p, p, i, p, p, ll,  # p1, total, start, m, seg, num, cstart, order, p2
            p, p, p, i, p, ip,  # tiles, li, ri, device, stream, launched
        ]
        for fn in (lib.fugue_join_build, lib.fugue_join_build_slab, lib.fugue_join_probe,
                   lib.fugue_join_expand):
            fn.restype = i
        lib.fugue_join_error_string.argtypes = [i]
        lib.fugue_join_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fugue_join_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _side(seg: torch.Tensor, num: int, nrows: Optional[int],
          row_valid: Optional[torch.Tensor], nulls: Optional[torch.Tensor],
          fn: str) -> Tuple[int, int, Optional[int], Optional[int]]:
    """A join side's ``(n, nrows or -1, row_valid pointer, nulls
    pointer)`` after the checks."""
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
        _check(row_valid, "row_valid", _FLAGS, n, seg.device)
    elif not 0 <= int(nrows) <= n:  # type: ignore[arg-type]
        raise ValueError(f"nrows {nrows} outside [0, {n}]")
    if nulls is not None:
        _check(nulls, "nulls", (torch.bool,), n, seg.device)
    return (n, -1 if nrows is None else int(nrows),
            None if row_valid is None else row_valid.data_ptr(),
            None if nulls is None else nulls.data_ptr())


def join_build_cuda(
    seg: torch.Tensor,
    num: int,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
    slots: bool = False,
    side_counts: bool = False,
) -> Any:
    """K7, with the contract of ``reference.join_build_reference``: int32
    [num], and with ``side_counts`` also the int32 [2] side counts.
    ``seg`` is a dense int32 CUDA tensor; ``row_valid`` and ``nulls``
    dense flags of its rows on its device. Raises on anything else, on a
    failed build and on a refused launch."""
    n, nrows_arg, rv, nl = _side(seg, num, nrows, row_valid, nulls, "join_build_cuda")
    stats = torch.zeros((2,), dtype=torch.int32, device=seg.device) if side_counts else None
    lib = _bind()
    index, stream = _device_and_stream(seg.device)
    done = ctypes.c_int(0)
    if num <= GLOBAL_MAX:
        table = torch.full((num,), -1 if slots else 0, dtype=torch.int32, device=seg.device)
        err = lib.fugue_join_build(n, nrows_arg, rv, nl, seg.data_ptr(), num, int(slots),
                                   table.data_ptr(), None if stats is None else stats.data_ptr(),
                                   index, stream, ctypes.byref(done))
        path = _PATHS.get(done.value)
    else:
        table = torch.empty((num,), dtype=torch.int32, device=seg.device)
        meta_ints, entry_bytes = ctypes.c_longlong(), ctypes.c_longlong()
        lib.fugue_join_slab_shape(n, num, int(slots), ctypes.byref(meta_ints),
                                  ctypes.byref(entry_bytes))
        meta = torch.empty((meta_ints.value,), dtype=torch.int32, device=seg.device)
        entries = torch.empty((entry_bytes.value,), dtype=torch.uint8, device=seg.device)
        err = lib.fugue_join_build_slab(
            n, nrows_arg, rv, nl, seg.data_ptr(), num, int(slots), table.data_ptr(),
            None if stats is None else stats.data_ptr(), meta.data_ptr(), entries.data_ptr(),
            index, stream, ctypes.byref(done))
        path = "slab"
        nslabs = -(-num >> SEG_SHIFT)
        join_build_cuda.last_slabs = SlabBuckets(meta[:nslabs], meta[nslabs:2 * nslabs + 1],
                                                 meta[2 * nslabs + 1:3 * nslabs + 1])
    _raise_on(lib, err, "join_build")
    if done.value != 0:
        join_build_cuda.launches += 1
        join_build_cuda.last_path = path
    return table if stats is None else (table, stats)


class SlabBuckets(NamedTuple):
    """K7's slab route's buckets, one a slab of ``2^SEG_SHIFT`` segments:
    the entries counted, each bucket's start (and the total) and where the
    partition left its cursor, which must be the next bucket's start."""

    counts: torch.Tensor
    starts: torch.Tensor
    cursor: torch.Tensor


SEG_SHIFT = 15  # log2 of a slab's segments (kSegShift in join.cu)
join_build_cuda.launches = 0  # type: ignore[attr-defined]
join_build_cuda.last_path = None  # type: ignore[attr-defined]
join_build_cuda.last_slabs = None  # type: ignore[attr-defined]


def probe_entry(mode: str) -> str:
    """The entries of K8's narrow table: a bit a segment (semi, anti,
    not_in: whether its count is above 0), a byte (expand: the count, 255
    where it is 255 or more), or K7's int32 slots (unique)."""
    return {"unique": "int32", "expand": "byte"}.get(mode, "bit")


def probe_table_bytes(mode: str, num: int) -> int:
    """The bytes of K8's narrow table over ``num`` segments."""
    entry = probe_entry(mode)
    return 4 * num if entry == "int32" else num if entry == "byte" else 4 * -(-num // 32)


def probe_place(mode: str, num: int) -> str:
    """Where K8 reads its table: ``"shared"`` where byte entries or slots
    fit ``PROBE_SHARED_BYTES``; else bits and byte entries from their
    narrow copy under L2 evict-last (``"l2"``), slots from K7's table
    (``"wide"``)."""
    entry = probe_entry(mode)
    if entry != "bit" and probe_table_bytes(mode, num) <= PROBE_SHARED_BYTES:
        return "shared"
    return "wide" if entry == "int32" else "l2"


def join_probe_cuda(
    seg: torch.Tensor,
    table: torch.Tensor,
    mode: str,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
    outer: bool = False,
    stats: Optional[torch.Tensor] = None,
) -> Probe:
    """K8, with the contract of ``reference.join_probe_reference``.
    ``table`` is K7's int32 [num] output on ``seg``'s device, ``stats``
    its int32 [2] side counts (``"not_in"`` mode). The narrow table is
    scratch of this call."""
    if mode not in PROBE_MODES:
        raise ValueError(f"probe mode {mode!r}: one of {PROBE_MODES}")
    num = int(table.shape[0])
    n, nrows_arg, rv, nl = _side(seg, num, nrows, row_valid, nulls, "join_probe_cuda")
    device = seg.device
    _check(table, "table", (torch.int32,), num, device)
    if (mode == "not_in") != (stats is not None):
        raise ValueError("stats go with the not_in mode, and only with it")
    if stats is not None:
        _check(stats, "stats", (torch.int32,), 2, device)

    def out(dtype: torch.dtype, wanted: bool) -> Optional[torch.Tensor]:
        return torch.empty((n,), dtype=dtype, device=device) if wanted else None

    expand = mode == "expand"
    keep, ridx = out(torch.bool, not expand), out(torch.int32, mode == "unique")
    m, reps = out(torch.int32, expand), out(torch.int32, expand)
    total = torch.zeros((), dtype=torch.int64 if expand else torch.int32, device=device)
    place = probe_place(mode, num)
    narrow = None
    if mode != "unique":
        narrow = torch.empty((-(-probe_table_bytes(mode, num) // 128) * 128,),
                             dtype=torch.uint8, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    err = lib.fugue_join_probe(
        n, nrows_arg, rv, nl, seg.data_ptr(), num, table.data_ptr(),
        ptr(stats), PROBE_MODES.index(mode), int(outer), PROBE_PLACES.index(place), ptr(narrow),
        ptr(keep), ptr(ridx), ptr(m), ptr(reps),
        None if expand else total.data_ptr(), total.data_ptr() if expand else None,
        index, stream, ctypes.byref(launched),
    )
    _raise_on(lib, err, "join_probe")
    if launched.value:
        join_probe_cuda.launches += 1
        join_probe_cuda.last_path = place
    return Probe(keep, ridx, m, reps, total)


join_probe_cuda.launches = 0  # type: ignore[attr-defined]
join_probe_cuda.last_path = None  # type: ignore[attr-defined]


def join_expand_cuda(
    start: torch.Tensor,
    m: torch.Tensor,
    seg1: torch.Tensor,
    cstart2: torch.Tensor,
    order2: torch.Tensor,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9, with the contract of ``reference.join_expand_reference``:
    ``(li, ri)``, int32 [total]. ``start`` int64 and ``m``, ``seg1``
    int32 over the probe rows, ``cstart2`` int64 [S], ``order2`` int64
    over the build rows, all dense on one CUDA device."""
    _require_cuda(start, "join_expand_cuda")
    device = start.device
    p1, num, p2 = int(start.shape[0]), int(cstart2.shape[0]), int(order2.shape[0])
    if not 1 <= p1 < 2**31 or not 1 <= p2 < 2**31 or not 1 <= num < 2**31:
        raise ValueError(f"sides of {p1} and {p2} rows over {num} segments: the kernel "
                         "takes 1 to 2^31 - 1 of each")
    if total < 0:
        raise ValueError(f"total {total} is negative")
    _check(start, "start", (torch.int64,), p1, device)
    _check(m, "m", (torch.int32,), p1, device)
    _check(seg1, "seg1", (torch.int32,), p1, device)
    _check(cstart2, "cstart2", (torch.int64,), num, device)
    _check(order2, "order2", (torch.int64,), p2, device)
    li = torch.empty((total,), dtype=torch.int32, device=device)
    ri = torch.empty((total,), dtype=torch.int32, device=device)
    tiles = torch.empty((-(-total // _EXPAND_TILE) + 1,), dtype=torch.int64, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_join_expand(
        p1, total, start.data_ptr(), m.data_ptr(), seg1.data_ptr(), num,
        cstart2.data_ptr(), order2.data_ptr(), p2, tiles.data_ptr(), li.data_ptr(),
        ri.data_ptr(), index, stream, ctypes.byref(launched),
    )
    _raise_on(lib, err, "join_expand")
    if launched.value:
        join_expand_cuda.launches += 1
    return li, ri


join_expand_cuda.launches = 0  # type: ignore[attr-defined]
