"""The wrappers of ``comap.cu``: check their tensors, allocate the outputs
and launch the co-map membership kernels on PyTorch's current stream.

- ``comap_presence_cuda`` (K17): which members have a real row in each
  segment, one bit a member;
- ``comap_rows_cuda`` (K18): the zip rule over those bits, each row's
  liveness and re-pointed segment id, each segment's liveness, and the
  members' alive rows and the alive segments counted on the card.

Each has the contract of its twin in ``reference.py``. Each wrapper's
``launches`` grows by one where it launches its kernel and nowhere
else. ``comap_presence_cuda.last_path`` names the route of its last
launch: ``"vector"`` (``seg`` 16-byte and ``valid`` 4-byte aligned: four
rows a load) or ``"scalar"``."""

import ctypes
from typing import Optional, Tuple

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.factorize import _check, _device_and_stream, _require_cuda
from fugue_tpu_torch.kernels.reference import COMAP_HOWS, ComapRows, presence_words


def _bind() -> ctypes.CDLL:
    lib = build.load("comap")
    if lib.fugue_comap_presence.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(i)
        rows = [ll, p, p, p, p, i, ll]  # n, seg, valid, offsets, nrows, members, num
        lib.fugue_comap_presence.argtypes = rows + [p, i, p, ip]
        lib.fugue_comap_rows.argtypes = rows + [
            p, i,  # presence, rule
            p, p, p, p, p,  # row_alive, seg_out, alive, counts, alive_count
            i, p, ip,  # device, stream, launched
        ]
        for fn in (lib.fugue_comap_presence, lib.fugue_comap_rows):
            fn.restype = i
        lib.fugue_comap_error_string.argtypes = [i]
        lib.fugue_comap_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fugue_comap_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _check_layout(seg: torch.Tensor, num_segments: int, offsets: torch.Tensor,
                  nrows: torch.Tensor, valid: Optional[torch.Tensor]) -> Tuple[int, int]:
    """The stacked rows and the members, after checking the layout's
    tensors: ``seg`` dense int32 [n], ``offsets`` int64 [N + 1], ``nrows``
    int64 [N], ``valid`` bool [n], all on one CUDA device."""
    device = seg.device
    n = int(seg.shape[0])
    if not 1 <= n < 2**31:
        raise ValueError(f"{n} rows: the kernels take 1 to 2^31 - 1")
    if not 1 <= num_segments < 2**31:
        raise ValueError(f"{num_segments} segments: the kernels take 1 to 2^31 - 1")
    members = int(offsets.shape[0]) - 1
    if members < 1:
        raise ValueError("offsets must hold at least one member")
    _check(seg, "seg", (torch.int32,), n, device)
    _check(offsets, "offsets", (torch.int64,), members + 1, device)
    _check(nrows, "nrows", (torch.int64,), members, device)
    if valid is not None:
        _check(valid, "valid", (torch.bool, torch.uint8), n, device)
    return n, members


def comap_presence_cuda(
    seg: torch.Tensor,
    num_segments: int,
    offsets: torch.Tensor,
    nrows: torch.Tensor,
    *,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K17, with the contract of ``reference.comap_presence_reference``:
    the presence words, int32 [S * ceil(N / 32)], zeroed here and set by
    one launch. Raises on tensors the kernel does not take, on a failed
    build and on a refused launch."""
    _require_cuda(seg, "comap_presence_cuda")
    n, members = _check_layout(seg, num_segments, offsets, nrows, valid)
    presence = torch.zeros((num_segments * presence_words(members),), dtype=torch.int32,
                           device=seg.device)
    lib = _bind()
    index, stream = _device_and_stream(seg.device)
    launched = ctypes.c_int(0)
    err = lib.fugue_comap_presence(
        n, seg.data_ptr(), None if valid is None else valid.data_ptr(), offsets.data_ptr(),
        nrows.data_ptr(), members, num_segments, presence.data_ptr(), index, stream,
        ctypes.byref(launched))
    _raise_on(lib, err, "comap_presence")
    if launched.value:
        comap_presence_cuda.launches += 1
        comap_presence_cuda.last_path = _ROUTES[launched.value]
    return presence


_ROUTES = {1: "vector", 2: "scalar"}  # the entry points' *launched
comap_presence_cuda.launches = 0  # type: ignore[attr-defined]
comap_presence_cuda.last_path = None  # type: ignore[attr-defined]


def comap_rows_cuda(
    seg: torch.Tensor,
    presence: Optional[torch.Tensor],
    num_segments: int,
    offsets: torch.Tensor,
    nrows: torch.Tensor,
    how: str,
    *,
    valid: Optional[torch.Tensor] = None,
) -> ComapRows:
    """K18, with the contract of ``reference.comap_rows_reference``: one
    launch over the rows and the segments; the counts stay on the card.
    ``presence`` is K17's words (None for a cross zip)."""
    _require_cuda(seg, "comap_rows_cuda")
    if how not in COMAP_HOWS:
        raise ValueError(f"zip how {how!r}: one of {COMAP_HOWS}")
    n, members = _check_layout(seg, num_segments, offsets, nrows, valid)
    device = seg.device
    if how == "cross":
        presence = None
    else:
        if presence is None:
            raise ValueError(f"a {how} zip needs the presence words")
        _check(presence, "presence", (torch.int32,), num_segments * presence_words(members),
               device)
    row_alive = torch.empty((n,), dtype=torch.bool, device=device)
    seg_out = torch.empty((n,), dtype=torch.int32, device=device)
    alive = torch.empty((num_segments,), dtype=torch.bool, device=device)
    counts = torch.zeros((members,), dtype=torch.int32, device=device)
    alive_count = torch.zeros((), dtype=torch.int32, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_comap_rows(
        n, seg.data_ptr(), None if valid is None else valid.data_ptr(), offsets.data_ptr(),
        nrows.data_ptr(), members, num_segments,
        None if presence is None else presence.data_ptr(), COMAP_HOWS.index(how),
        row_alive.data_ptr(), seg_out.data_ptr(), alive.data_ptr(), counts.data_ptr(),
        alive_count.data_ptr(), index, stream, ctypes.byref(launched))
    _raise_on(lib, err, "comap_rows")
    if launched.value:
        comap_rows_cuda.launches += 1
    return ComapRows(row_alive, seg_out, alive, counts, alive_count)


comap_rows_cuda.launches = 0  # type: ignore[attr-defined]
