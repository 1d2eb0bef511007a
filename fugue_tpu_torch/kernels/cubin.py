"""Loads cubins through the CUDA driver API (``ctypes`` over ``libcuda``)
and launches their kernels: the route of K6's generated kernels, which
are built with ``nvcc -cubin`` and so need no host compiler and no link.

A module is loaded into the device's primary context (the one PyTorch's
runtime uses), made current around each call where it is not already.
A launch takes the kernel's one struct parameter as bytes; it goes on the
caller's stream and is checked at once (a refused launch raises
``RuntimeError`` with the CUDA driver API's message)."""

import ctypes
from typing import Dict, List, Optional

_DRIVER: List[ctypes.CDLL] = []
_CONTEXTS: Dict[int, ctypes.c_void_p] = {}


def driver() -> ctypes.CDLL:
    if not _DRIVER:
        lib = ctypes.CDLL("libcuda.so.1")
        p, pp, i, u = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_uint
        ip = ctypes.POINTER(ctypes.c_int)
        sigs = {
            "cuInit": [u],
            "cuGetErrorString": [i, ctypes.POINTER(ctypes.c_char_p)],
            "cuDeviceGet": [ip, i],
            "cuDevicePrimaryCtxRetain": [pp, i],
            "cuCtxGetCurrent": [pp],
            "cuCtxPushCurrent_v2": [p],
            "cuCtxPopCurrent_v2": [pp],
            "cuModuleLoadData": [pp, p],
            "cuModuleGetFunction": [pp, p, ctypes.c_char_p],
            "cuLaunchKernel": [p, u, u, u, u, u, u, u, p, pp, pp],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i
        err = lib.cuInit(0)  # before another thread can see the driver
        _DRIVER.append(lib)
        check(err, "cuInit")
    return _DRIVER[0]


def check(result: int, what: str) -> None:
    if result != 0:
        msg = ctypes.c_char_p()
        driver().cuGetErrorString(result, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else "unknown error"
        raise RuntimeError(f"{what} failed: {text} (CUresult {result})")


class _Current:
    """The device's primary context made current for a block, where it is
    not already."""

    def __init__(self, device: int):
        ctx = _CONTEXTS.get(device)
        lib = driver()
        if ctx is None:
            dev = ctypes.c_int()
            check(lib.cuDeviceGet(ctypes.byref(dev), device), "cuDeviceGet")
            ctx = ctypes.c_void_p()
            check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev), "cuDevicePrimaryCtxRetain")
            _CONTEXTS[device] = ctx
        self.ctx = ctx
        self.pushed = False

    def __enter__(self) -> "_Current":
        lib = driver()
        cur = ctypes.c_void_p()
        check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
        if cur.value != self.ctx.value:
            check(lib.cuCtxPushCurrent_v2(self.ctx), "cuCtxPushCurrent")
            self.pushed = True
        return self

    def __exit__(self, *exc: object) -> None:
        if self.pushed:
            old = ctypes.c_void_p()
            check(driver().cuCtxPopCurrent_v2(ctypes.byref(old)), "cuCtxPopCurrent")


class Module:
    """A cubin loaded on one device."""

    def __init__(self, image: bytes, device: int):
        self.device = device
        self._image = ctypes.create_string_buffer(image, len(image))
        self.handle = ctypes.c_void_p()
        with _Current(device):
            check(driver().cuModuleLoadData(ctypes.byref(self.handle),
                                            ctypes.cast(self._image, ctypes.c_void_p)),
                  "cuModuleLoadData")

    def function(self, name: str) -> "Function":
        return Function(self, name)


class Function:
    """One kernel of a loaded cubin."""

    def __init__(self, module: Module, name: str):
        lib = driver()
        self.device = module.device
        self.name = name
        with _Current(self.device):
            fn = ctypes.c_void_p()
            check(lib.cuModuleGetFunction(ctypes.byref(fn), module.handle, name.encode()),
                  f"finding {name}")
        self.handle = fn

    def launch(self, grid: int, threads: int, stream: Optional[int], params: bytes) -> None:
        """``grid`` blocks of ``threads`` on ``stream``; ``params`` is the
        kernel's one struct argument, byte for byte."""
        if not 1 <= grid <= 0x7FFFFFFF:
            raise ValueError(f"grid of {grid} blocks")
        buf = ctypes.create_string_buffer(params, len(params))
        args = (ctypes.c_void_p * 1)(ctypes.cast(buf, ctypes.c_void_p))
        with _Current(self.device):
            check(driver().cuLaunchKernel(self.handle, grid, 1, 1, threads, 1, 1, 0, stream,
                                          args, None), f"launching {self.name}")
