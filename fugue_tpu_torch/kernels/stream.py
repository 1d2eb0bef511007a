"""The wrapper of ``stream.cu``: check its tensors and launch K19
``stream_fold`` on PyTorch's current stream, one launch a chunk over every
accumulator of a streaming aggregate.

It has the contract of its twin ``reference.stream_fold_reference``; its
``launches`` grows by one where it launches its kernel and nowhere
else."""

import ctypes
from typing import Sequence, Tuple

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.factorize import _check, _device_and_stream, _require_cuda
from fugue_tpu_torch.kernels.reference import FOLD_KINDS, FoldOp, Payload

# the caps of the kernel's parameters (stream.cu)
MAX_KEYS, MAX_PAYLOADS, MAX_OPS = 8, 16, 48


def _bind() -> ctypes.CDLL:
    lib = build.load("stream")
    if lib.fugue_stream_fold.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fugue_stream_fold.argtypes = [ll, p, ll, ll, i, p, i, p, i, p, i, p,
                                          ctypes.POINTER(i)]
        lib.fugue_stream_fold.restype = i
        lib.fugue_stream_error_string.argtypes = [i]
        lib.fugue_stream_error_string.restype = ctypes.c_char_p
    return lib


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
    chunk's rows folded into ``store`` (dense int64 [T, A]) in place, by
    one launch. ``keys`` dense int64 [n] (at most ``MAX_KEYS``),
    ``payloads`` dense int64 or float64 [n] with dense bool masks (at most
    ``MAX_PAYLOADS``), ``ops`` at most ``MAX_OPS``, each op of a payload
    next to the others of it. Raises on anything else, on a failed build
    and on a refused launch."""
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
            or store.device != device:
        raise ValueError(f"store must be a dense int64 [T, A] tensor on {device}")
    slots, width = int(store.shape[0]), int(store.shape[1])
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
    key_table = _table([(k.data_ptr(), lo, span) for k, (lo, span) in zip(keys, bounds)])
    payload_table = _table([(v.data_ptr(), 0 if m is None else m.data_ptr())
                            for v, m in payloads])
    op_table = _table([(FOLD_KINDS.index(op.kind), op.payload, op.acc) for op in ops])
    lib = _bind()
    index, stream = _device_and_stream(device)
    launched = ctypes.c_int(0)
    err = lib.fugue_stream_fold(n, store.data_ptr(), slots, width, len(keys), key_table,
                                len(payloads), payload_table, len(ops), op_table, index, stream,
                                ctypes.byref(launched))
    if err != 0:
        msg = lib.fugue_stream_error_string(err).decode()
        raise RuntimeError(f"stream_fold kernel launch failed: {msg} ({err})")
    if launched.value:
        stream_fold_cuda.launches += 1
    return store


stream_fold_cuda.launches = 0  # type: ignore[attr-defined]
