"""The wrapper of ``segment_sums.cu``: checks its tensors, allocates the
outputs and launches the kernel on PyTorch's current stream.

``segment_sums_cuda.launches`` counts the launches (it grows by one where
the kernel is launched and nowhere else) and ``segment_sums_cuda.last_path``
names the path of the last call: ``"shared"`` (block accumulators in
shared memory), ``"global"`` (atomics straight into the outputs) or
``"none"`` (nothing to sum, no launch)."""

import ctypes
from typing import Tuple

import torch

from fugue_tpu_torch.kernels import build

_PATHS = {0: "none", 1: "shared", 2: "global"}


def _bind() -> ctypes.CDLL:
    lib = build.load("segment_sums")
    fn = lib.fugue_segment_sums
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            p, ctypes.c_longlong, i,  # seg, n, total
            p, i, i,  # fpack, nf, f64
            p, i,  # cpack, nc
            p, i,  # ipack, ni
            p, p, p,  # fout, cout, iout
            i, p, ctypes.POINTER(i),  # device, stream, path
        ]
        fn.restype = i
        lib.fugue_cuda_error_string.argtypes = [i]
        lib.fugue_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtypes: Tuple[torch.dtype, ...],
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, seg on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def segment_sums_cuda(
    seg: torch.Tensor,
    fpack: torch.Tensor,
    cpack: torch.Tensor,
    ipack: torch.Tensor,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel with the contract of
    ``reference.segment_sums_reference``. Every tensor must be a
    contiguous CUDA tensor on one device; raises on anything else, on a
    failed build and on a refused launch."""
    if not seg.is_cuda:
        raise ValueError("segment_sums_cuda takes CUDA tensors only")
    device = seg.device
    n = int(seg.shape[0]) if seg.dim() == 1 else -1
    _check(seg, "seg", (torch.int32,), (n,), device)
    nf, nc, ni = int(fpack.shape[0]), int(cpack.shape[0]), int(ipack.shape[0])
    _check(fpack, "fpack", (torch.float32, torch.float64), (nf, n), device)
    _check(cpack, "cpack", (torch.bool, torch.uint8), (nc, n), device)
    _check(ipack, "ipack", (torch.int64,), (ni, n), device)
    if not 0 <= total < 2**31:
        raise ValueError(f"total {total} out of range")
    fout = torch.zeros((nf, total), dtype=fpack.dtype, device=device)
    cout = torch.zeros((nc, total), dtype=torch.int32, device=device)
    iout = torch.zeros((ni, total), dtype=torch.int64, device=device)
    lib = _bind()
    path = ctypes.c_int(0)
    err = lib.fugue_segment_sums(
        seg.data_ptr(), n, total,
        fpack.data_ptr(), nf, int(fpack.dtype == torch.float64),
        cpack.data_ptr(), nc,
        ipack.data_ptr(), ni,
        fout.data_ptr(), cout.data_ptr(), iout.data_ptr(),
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
        ctypes.byref(path),
    )
    if err != 0:
        msg = lib.fugue_cuda_error_string(err).decode()
        raise RuntimeError(f"segment_sums kernel launch failed: {msg} ({err})")
    segment_sums_cuda.last_path = _PATHS[path.value]
    if path.value != 0:
        segment_sums_cuda.launches += 1
    return fout, cout, iout


segment_sums_cuda.launches = 0  # type: ignore[attr-defined]
segment_sums_cuda.last_path = "none"  # type: ignore[attr-defined]
