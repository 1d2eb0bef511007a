"""The wrappers of ``window.cu``: check their tensors, allocate the outputs
and the scratch and launch the window kernels on PyTorch's current stream.

- ``window_rank_cuda`` (K15): row_number, rank, dense_rank, ntile,
  percent_rank and cume_dist of every row;
- ``window_frame_cuda`` (K16): count, sum, avg, min, max, lag/lead and
  first/last/nth_value of every row over its frame.

Both take the rows in window order (``reference.SortedWords``) and write
their outputs in row order, through the order by slab
(``order_scatter.cuh``). Each has the contract of its twin in
``reference.py``. Each wrapper's ``launches`` grows by one where it
launches its kernels (several launches of one C call, or two calls for
K16's table route) and nowhere else; its ``last_fill`` keeps each slab's
bucket count of the last call (int32, on the device) and ``last_shift``
a slab's log2 rows. K16's min/max over a frame of the
``"span"`` route reads back the longest frame between its two calls, and
sizes its sparse table to it; ``window_frame_cuda.last_levels`` keeps
that table's levels (0 where no table was built)."""

import ctypes
import math
from typing import Any, Optional, Tuple

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.factorize import _check, _device_and_stream, _require_cuda
from fugue_tpu_torch.kernels.reference import (
    AGG_ROUTES,
    BOUND_KINDS,
    FRAME_FUNCS,
    FRAME_UNITS,
    RANK_FUNCS,
    SortedWords,
    WindowFrame,
)

MAX_WORDS = 4  # kMaxWords in window.cu
# the functions' codes in window.cu
_RANK_CODES = {f: i for i, f in enumerate(RANK_FUNCS)}
_FRAME_CODES = {f: 10 + i for i, f in enumerate(FRAME_FUNCS)}
_L, _P, _D = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_double
_POSITIONS = ("ps", "pe", "gs", "ge", "cnt")


class _Args(ctypes.Structure):
    """``Args`` of ``window.cu``: every field 8 bytes, in its order."""

    _fields_ = [
        ("n", _L), ("nwords", _L), ("part_shift", _L), ("unreal", _L), ("real_below", _L),
        ("words", _P * MAX_WORDS), ("wide", _L * MAX_WORDS), ("order", _P),
        ("func", _L), ("param", _L), ("unit", _L), ("lo_kind", _L), ("hi_kind", _L),
        ("lo_n", _D), ("hi_n", _D), ("agg_route", _L), ("stage", _L), ("level", _L),
        ("values", _P), ("vmask", _P), ("is_float", _L), ("has_default", _L),
        ("default_i", _L), ("default_f", _D),
        ("key", _P), ("kmask", _P), ("key_desc", _L),
        ("ps", _P), ("pe", _P), ("gs", _P), ("ge", _P), ("cnt", _P),
        ("gstart", _P), ("gend", _P), ("skv", _P), ("snull", _P),
        ("P", _P), ("C", _P), ("M", _P), ("sv", _P), ("sm", _P),
        ("lo", _P), ("hi", _P), ("maxlen", _P), ("levels", _P), ("nlevels", _L),
        ("out", _P), ("outm", _P),
        ("state", _P), ("fwd_part", _P), ("rev_part", _P), ("fuse", _L),
        ("slab_offs", _P), ("slab_vals", _P),
    ]


def _bind() -> ctypes.CDLL:
    return build.load("window", _declare)


def _declare(lib: ctypes.CDLL) -> None:
    """The library's argument types, set once as it loads."""
    ip = ctypes.POINTER(ctypes.c_int)
    for fn in (lib.fugue_window_rank, lib.fugue_window_frame):
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, _P, ip]
        fn.restype = ctypes.c_int
    lib.fugue_window_frame_layout.argtypes = [ctypes.POINTER(_L)]
    lib.fugue_window_frame_layout.restype = None
    lib.fugue_window_error_string.argtypes = [ctypes.c_int]
    lib.fugue_window_error_string.restype = ctypes.c_char_p


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fugue_window_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class _Scratch:
    """Device buffers of one call, kept alive until it has been enqueued."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device, self.keep = n, device, []

    def of(self, dtype: torch.dtype, n: Optional[int] = None) -> torch.Tensor:
        t = torch.empty((self.n if n is None else n,), dtype=dtype, device=self.device)
        self.keep.append(t)
        return t


def _sorted_args(sw: SortedWords, what: str) -> Tuple[_Args, _Scratch, ctypes.CDLL]:
    """The checked sorted words and order of a call, in its ``_Args``."""
    order = sw.order
    _require_cuda(order, what)
    device = order.device
    n = int(order.shape[0])
    if not 1 <= n < 2**31 - 1:
        raise ValueError(f"{n} rows: the kernels take 1 to 2^31 - 2")
    if not 1 <= len(sw.words) <= MAX_WORDS:
        raise ValueError(f"{len(sw.words)} sort words: the kernels take 1 to {MAX_WORDS}")
    _check(order, "order", (torch.int64,), n, device)
    for w in sw.words:
        _check(w, "a sort word", (torch.int32, torch.int64), n, device)
    width = 8 * sw.words[0].element_size()
    if not 0 <= sw.part_shift < width:
        raise ValueError(f"part_shift {sw.part_shift} outside word 0's {width} bits")
    lib = _bind()
    s = _Scratch(n, device)
    a = _Args()
    a.n, a.nwords, a.part_shift = n, len(sw.words), sw.part_shift
    if sw.real_below is not None:
        a.unreal, a.real_below = 1, int(sw.real_below)
    for i, w in enumerate(sw.words):
        a.words[i] = w.data_ptr()
        a.wide[i] = int(w.dtype == torch.int64)
    a.order = order.data_ptr()
    return a, s, lib


def _position_arrays(a: _Args, s: _Scratch, names: Tuple[str, ...]) -> None:
    for name in names:
        setattr(a, name, s.of(torch.int32).data_ptr())


def _call(lib: ctypes.CDLL, fn: Any, a: _Args, device: torch.device, what: str) -> bool:
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    _raise_on(lib, fn(ctypes.byref(a), index, stream, ctypes.byref(launched)), what)
    return bool(launched.value)


def window_rank_cuda(sw: SortedWords, func: str, param: int = 0) -> torch.Tensor:
    """K15, with the contract of ``reference.window_rank_reference``: int64
    or float64 [n] in row order. ``sw``'s order (int64) and words (int32 or
    int64) are dense CUDA tensors of one device. Raises on anything else,
    on a failed build and on a refused launch."""
    if func not in RANK_FUNCS:
        raise ValueError(f"rank function {func!r}: one of {RANK_FUNCS}")
    if func == "ntile" and param < 1:
        raise ValueError("ntile takes at least one bucket")
    a, s, lib = _sorted_args(sw, "window_rank_cuda")
    a.func, a.param = _RANK_CODES[func], int(param)
    _position_arrays(a, s, rank_positions(func))
    fill, shift = _slab_scratch(a, s, lib, rank=True)
    out = s.of(torch.float64 if func in ("percent_rank", "cume_dist") else torch.int64)
    a.out = out.data_ptr()
    if _call(lib, lib.fugue_window_rank, a, s.device, "window_rank"):
        window_rank_cuda.launches += 1
    window_rank_cuda.last_fill, window_rank_cuda.last_shift = fill, shift
    return out


def rank_positions(func: str) -> Tuple[str, ...]:
    """The per-position arrays K15's forward scan writes for its reverse
    pass: none for row_number, rank and dense_rank (final in the forward
    scan), the partition start for ntile and cume_dist, and the peer
    group's start too for percent_rank."""
    if func in ("row_number", "rank", "dense_rank"):
        return ()
    return ("ps", "gs") if func == "percent_rank" else ("ps",)


def _slab_scratch(a: _Args, s: _Scratch, lib: ctypes.CDLL, rank: bool
                  ) -> Tuple[torch.Tensor, int]:
    """The single-pass scans' and the slab store's scratch in ``a``: the
    int32 state (two tile counters, the forward and reverse tiles' flags,
    each slab's bucket count; zeroed by the call), the tiles' published
    elements and the bucket entries. Returns the buckets' counts and a
    slab's log2 rows."""
    fwd_rows, rev_rows, fwd_bytes, rev_bytes, shift, rank_rows, rank_bytes = _layout(lib)
    if rank:
        fwd_rows, fwd_bytes = rank_rows, rank_bytes
    n = s.n
    fwd_tiles, rev_tiles = -(-n // fwd_rows), -(-n // rev_rows)
    state = s.of(torch.int32, 2 + fwd_tiles + rev_tiles + (-(-n >> shift)))
    a.state = state.data_ptr()
    a.fwd_part = s.of(torch.uint8, 2 * fwd_tiles * fwd_bytes).data_ptr()
    a.rev_part = s.of(torch.uint8, 2 * rev_tiles * rev_bytes).data_ptr()
    a.slab_offs, a.slab_vals = s.of(torch.int32).data_ptr(), s.of(torch.int64).data_ptr()
    return state[2 + fwd_tiles + rev_tiles:], shift


window_rank_cuda.launches = 0  # type: ignore[attr-defined]
window_rank_cuda.last_fill = None  # type: ignore[attr-defined]
window_rank_cuda.last_shift = 0  # type: ignore[attr-defined]


def _frame_output_float(frame: WindowFrame) -> bool:
    if frame.func in ("count", "count_star"):
        return False
    return frame.func == "avg" or frame.values.is_floating_point()  # type: ignore[union-attr]


def frame_plan(frame: WindowFrame) -> Tuple[bool, Tuple[str, ...]]:
    """How K16 takes ``frame``: whether its reverse scan computes the
    results (running and ROWS frames, whose bounds are the position's own,
    but the table route's min/max), and the per-position arrays its
    passes write and read back. The running frame's sums, counts and
    extrema read the prefix at the peer group's end alone, so they need
    none; a fused frame reads its partition start; the rest every bound
    (``frame_final``)."""
    table = frame.func in ("min", "max") and frame.route == "span"
    if frame.unit in ("running", "rows") and not table:
        if frame.unit == "running" and frame.func in ("count", "sum", "avg", "min", "max"):
            return True, ()
        return True, ("ps",)
    return False, _POSITIONS


def window_frame_cuda(sw: SortedWords, frame: WindowFrame
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K16, with the contract of ``reference.window_frame_reference``:
    ``(out, mask)`` in row order. ``frame.values`` is a dense int64 or
    float64 CUDA tensor over the rows (None for ``count_star``), its
    ``vmask`` and ``kmask`` dense bools, ``key`` dense float64; ``sw``'s
    order a permutation of the rows. ``window_frame_cuda.last_fill`` keeps
    each slab's bucket count of its store through the order in the last
    call (int32, on the device) and ``.last_shift`` its slab's log2 rows."""
    f = frame
    if f.func not in FRAME_FUNCS or f.unit not in FRAME_UNITS or f.route not in AGG_ROUTES:
        raise ValueError(f"window frame {f.func!r} over {f.unit!r} by {f.route!r}")
    if f.lo[0] not in BOUND_KINDS or f.hi[0] not in BOUND_KINDS:
        raise ValueError(f"frame bounds {f.lo}, {f.hi}: kinds are {BOUND_KINDS}")
    a, s, lib = _sorted_args(sw, "window_frame_cuda")
    device, n = s.device, s.n
    a.func, a.param = _FRAME_CODES[f.func], int(f.param or 0)
    a.unit = FRAME_UNITS.index(f.unit)
    a.lo_kind, a.hi_kind = BOUND_KINDS.index(f.lo[0]), BOUND_KINDS.index(f.hi[0])
    a.lo_n, a.hi_n = float(f.lo[1] or 0), float(f.hi[1] or 0)
    a.agg_route = AGG_ROUTES.index(f.route)
    vt = torch.int64
    if f.func != "count_star":
        if f.values is None:
            raise ValueError(f"{f.func} takes an argument")
        vt = f.values.dtype
        _check(f.values, "values", (torch.int64, torch.float64), n, device)
        a.values, a.is_float = f.values.data_ptr(), int(vt == torch.float64)
        if f.vmask is not None:
            _check(f.vmask, "vmask", (torch.bool,), n, device)
            a.vmask = f.vmask.data_ptr()
    if f.default is not None:
        a.has_default, a.default_i, a.default_f = 1, int(f.default), float(f.default)
    fuse, positions = frame_plan(f)
    _position_arrays(a, s, positions)
    offsets = f.lo[0] in ("p", "f") or f.hi[0] in ("p", "f")
    if f.unit == "groups" and offsets:
        a.gstart, a.gend = s.of(torch.int32).data_ptr(), s.of(torch.int32).data_ptr()
    if f.unit == "range" and offsets:
        if f.key is None:
            raise ValueError("a RANGE frame with offsets takes its key")
        _check(f.key, "key", (torch.float64,), n, device)
        a.key, a.key_desc = f.key.data_ptr(), int(f.key_desc)
        if f.kmask is not None:
            _check(f.kmask, "kmask", (torch.bool,), n, device)
            a.kmask = f.kmask.data_ptr()
        a.skv, a.snull = s.of(torch.float64).data_ptr(), s.of(torch.bool).data_ptr()
    aggregate = f.func in ("count", "sum", "avg", "min", "max")
    extremum = f.func in ("min", "max")
    table = extremum and f.route == "span"
    if aggregate and f.route != "loop":
        a.C = s.of(torch.int64).data_ptr()
        if f.func in ("sum", "avg"):
            a.P = s.of(vt).data_ptr()
        if extremum and f.route == "prefix":
            a.M = s.of(vt).data_ptr()
    if f.func != "count_star" and (not aggregate or f.route == "loop" or table):
        a.sv, a.sm = s.of(vt).data_ptr(), s.of(torch.bool).data_ptr()
    fill, shift = _slab_scratch(a, s, lib, rank=False)
    a.fuse = int(fuse)
    out = s.of(torch.float64 if _frame_output_float(f) else torch.int64)
    mask = None if f.func in ("count", "count_star") else s.of(torch.bool)
    a.out, a.outm = out.data_ptr(), _ptr(mask)
    window_frame_cuda.last_levels = 0
    if not table:
        launched = _call(lib, lib.fugue_window_frame, a, device, "window_frame")
    else:
        maxlen = torch.zeros((1,), dtype=torch.int32, device=device)
        a.lo, a.hi = s.of(torch.int32).data_ptr(), s.of(torch.int32).data_ptr()
        a.maxlen, a.stage = maxlen.data_ptr(), 1
        launched = _call(lib, lib.fugue_window_frame, a, device, "window_frame")
        longest = int(maxlen.item())  # the table route's one readback
        levels = max(1, int(math.floor(math.log2(longest))) + 1) if longest > 0 else 1
        a.levels, a.nlevels, a.stage = s.of(vt, levels * n).data_ptr(), levels, 2
        launched = _call(lib, lib.fugue_window_frame, a, device, "window_frame") or launched
        window_frame_cuda.last_levels = levels
    if launched:
        window_frame_cuda.launches += 1
    window_frame_cuda.last_fill, window_frame_cuda.last_shift = fill, shift
    return out, mask


def _layout(lib: ctypes.CDLL) -> Tuple[int, ...]:
    """``fugue_window_frame_layout``: K16's forward and the reverse tiles'
    positions and elements' bytes, the log2 of a slab's rows, and K15's
    forward tiles' positions and element's bytes."""
    out = (_L * 7)()
    lib.fugue_window_frame_layout(out)
    return tuple(int(v) for v in out)


window_frame_cuda.launches = 0  # type: ignore[attr-defined]
window_frame_cuda.last_levels = 0  # type: ignore[attr-defined]
window_frame_cuda.last_fill = None  # type: ignore[attr-defined]
window_frame_cuda.last_shift = 0  # type: ignore[attr-defined]
