"""The wrapper of ``stream.cu``: check its tensors, plan the fold by slab of
slots, allocate its scratch and launch K19 ``stream_fold`` on PyTorch's
current stream, one call a chunk over every accumulator of a streaming
aggregate.

It has the contract of its twin ``reference.stream_fold_reference``; its
``launches`` grows by one where it launches its kernels and nowhere
else. ``fold_plan`` is the host's part: a slab's slots from the store's
width, the route, and the scratch a chunk needs."""

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.factorize import _check, _device_and_stream, _require_cuda
from fugue_tpu_torch.kernels.reference import FOLD_KINDS, FoldOp, Payload

# the caps of the kernel's parameters (stream.cu)
MAX_KEYS, MAX_PAYLOADS, MAX_OPS = 8, 16, 48
# a slab's accumulators in one block's shared memory (at most
# kMaxImageBytes), and the slabs a store may have (kMaxSlabs)
IMAGE_BYTES = 160 * 1024
MAX_SLABS = 1 << 14


class FoldPlan(NamedTuple):
    """How K19 folds a chunk of ``rows`` rows into a store of ``slots`` x
    ``width``: ``accumulators`` the distinct ``(kind, payload)`` of the
    ops (columns that repeat one share it in shared memory); a slab is
    ``2^shift`` slots (the most whose accumulators fit ``IMAGE_BYTES``);
    ``route`` ``"direct"`` where one slab holds the store
    (no scratch), else ``"slabs"``; ``reads`` whether an op reads each
    payload's values (not where it is only counted); ``state_ints`` the
    int32 counters, ``scratch_bytes`` all of the scratch (the counters and
    an 8-byte entry a row: its slot in its slab with the validity bits, and
    its row)."""

    route: str
    accumulators: int
    shift: int
    nslabs: int
    reads: Tuple[bool, ...]
    state_ints: int
    scratch_bytes: int


def fold_plan(width: int, slots: int, rows: int, ops: Sequence[FoldOp], npayloads: int,
              image_bytes: Optional[int] = None) -> FoldPlan:
    """The slab plan of a fold (host only, no tensor), a slab's
    accumulators in ``image_bytes`` (``IMAGE_BYTES`` unless given). Raises
    where the store has more slabs than ``MAX_SLABS``."""
    image_bytes = IMAGE_BYTES if image_bytes is None else image_bytes
    if not 1 <= width <= MAX_OPS:
        raise ValueError(f"{width} accumulators a slot: the kernel takes 1 to {MAX_OPS}")
    accs = max(1, len({(op.kind, -1 if op.kind == "rows" else op.payload) for op in ops}))
    shift = 1
    while (accs << (shift + 1)) * 8 <= image_bytes and shift < 16:
        shift += 1
    nslabs = -(-slots // (1 << shift))
    if nslabs > MAX_SLABS:
        raise ValueError(f"{slots} slots of {width} accumulators: more than {MAX_SLABS} slabs "
                         f"of {1 << shift}")
    valued = {op.payload for op in ops if op.kind not in ("rows", "count")}
    reads = tuple(j in valued for j in range(npayloads))
    if nslabs == 1:
        return FoldPlan("direct", accs, shift, 1, reads, 0, 0)
    state = 4 * nslabs + 2
    return FoldPlan("slabs", accs, shift, nslabs, reads, state, 4 * state + 8 * rows)


def _bind() -> ctypes.CDLL:
    return build.load("stream", _declare)


def _declare(lib: ctypes.CDLL) -> None:
    """The library's argument types, set once as it loads."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fugue_stream_fold.argtypes = [ll, p, ll, ll, i, p, i, p, i, p, i, p, p, p, i, p,
                                      ctypes.POINTER(i)]
    lib.fugue_stream_fold.restype = i
    lib.fugue_stream_error_string.argtypes = [i]
    lib.fugue_stream_error_string.restype = ctypes.c_char_p


def _table(rows: Sequence[Sequence[int]]) -> "ctypes.Array":
    flat = [int(v) for r in rows for v in r]
    return (ctypes.c_longlong * max(len(flat), 1))(*flat)


def stream_fold_cuda(
    keys: Sequence[torch.Tensor],
    bounds: Sequence[Tuple[int, int]],
    payloads: Sequence[Payload],
    ops: Sequence[FoldOp],
    store: torch.Tensor,
) -> torch.Tensor:
    """K19, with the contract of ``reference.stream_fold_reference``: the
    chunk's rows folded into ``store`` (dense int64 [T, A], 16-byte
    aligned) in place. ``keys`` dense int64 [n] (at most ``MAX_KEYS``),
    ``payloads`` dense int64 or float64 [n] with dense bool masks (at most
    ``MAX_PAYLOADS``), ``ops`` at most ``MAX_OPS``, one a column. Raises on anything else, on a
    failed build and on a refused launch. ``stream_fold_cuda.last_plan``
    keeps the last call's ``FoldPlan``, ``.last_fill`` each slab's bucket
    count (int32, on the device; None on the direct route)."""
    _require_cuda(keys[0], "stream_fold_cuda")
    device = keys[0].device
    n = int(keys[0].shape[0])
    if not 1 <= n < 2**31:
        raise ValueError(f"{n} rows: the kernel takes 1 to 2^31 - 1")
    if not (1 <= len(keys) <= MAX_KEYS and len(payloads) <= MAX_PAYLOADS
            and 1 <= len(ops) <= MAX_OPS):
        raise ValueError(f"{len(keys)} keys, {len(payloads)} payloads and {len(ops)} ops: "
                         f"the kernel takes 1-{MAX_KEYS}, 0-{MAX_PAYLOADS} and 1-{MAX_OPS}")
    if store.dim() != 2 or store.dtype != torch.int64 or not store.is_contiguous() \
            or store.device != device or store.data_ptr() % 16 != 0:
        raise ValueError(f"store must be a dense, 16-byte aligned int64 [T, A] tensor on {device}")
    slots, width = int(store.shape[0]), int(store.shape[1])
    if slots >= 2**31:
        raise ValueError(f"{slots} slots: the kernel takes fewer than 2^31")
    for j, k in enumerate(keys):
        _check(k, f"key {j}", (torch.int64,), n, device)
    for j, (v, m) in enumerate(payloads):
        _check(v, f"payload {j}", (torch.int64, torch.float64), n, device)
        if m is not None:
            _check(m, f"mask {j}", (torch.bool,), n, device)
    for op in ops:
        if op.kind not in FOLD_KINDS or not 0 <= op.acc < width or (
                op.kind != "rows" and not 0 <= op.payload < len(payloads)):
            raise ValueError(f"bad fold op {op}")
    if len({op.acc for op in ops}) != len(ops):
        raise ValueError("two fold ops on one accumulator column")
    plan = fold_plan(width, slots, n, ops, len(payloads))
    state = entries = None
    if plan.route == "slabs":
        state = torch.empty((plan.state_ints,), dtype=torch.int32, device=device)
        entries = torch.empty((2, n), dtype=torch.int32, device=device)  # offsets, rows
    key_table = _table([(k.data_ptr(), lo, span) for k, (lo, span) in zip(keys, bounds)])
    payload_table = _table([(v.data_ptr(), 0 if m is None else m.data_ptr(), int(read))
                            for (v, m), read in zip(payloads, plan.reads)])
    op_table = _table([(FOLD_KINDS.index(op.kind), op.payload, op.acc) for op in ops])
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_stream_fold(
        n, store.data_ptr(), slots, width, len(keys), key_table, len(payloads), payload_table,
        len(ops), op_table, plan.shift, None if state is None else state.data_ptr(),
        None if entries is None else entries[0].data_ptr(),
        None if entries is None else entries[1].data_ptr(), index, stream, ctypes.byref(launched))
    if err != 0:
        msg = lib.fugue_stream_error_string(err).decode()
        raise RuntimeError(f"stream_fold kernel launch failed: {msg} ({err})")
    if launched.value:
        stream_fold_cuda.launches += 1
    stream_fold_cuda.last_plan = plan
    stream_fold_cuda.last_fill = None if state is None else state[plan.nslabs:2 * plan.nslabs]
    return store


stream_fold_cuda.launches = 0  # type: ignore[attr-defined]
stream_fold_cuda.last_plan = None  # type: ignore[attr-defined]
stream_fold_cuda.last_fill = None  # type: ignore[attr-defined]
