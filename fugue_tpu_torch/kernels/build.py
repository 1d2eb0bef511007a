"""Builds the port's CUDA sources into shared libraries with ``nvcc`` at
first use, and loads them with ``ctypes``.

Each ``<stem>.cu`` in this directory has a plain C interface and is
compiled alone for ``sm_90a`` into ``_build/<stem>-<hash>.so``, where the
hash covers the source and the flags, so an edited source rebuilds.
``build_all`` starts one ``nvcc`` per source that is not built yet, all at
once, and waits for them. The build needs only the CUDA toolkit (no
PyTorch headers, no ``ninja``). ``nvcc`` is ``$CUDA_HOME/bin/nvcc``, else
``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Stems of every CUDA source of the port."""
    return sorted(p.stem for p in KERNEL_DIR.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand is not None and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def library_path(stem: str) -> Path:
    digest = hashlib.sha256((KERNEL_DIR / f"{stem}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build_all(stems: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every named source (default: all) that has no library yet,
    with one ``nvcc`` each, all started together. Returns each built
    source's compiler report (``-Xptxas=-v``: registers, shared memory and
    spills per kernel); raises ``RuntimeError`` with the compiler's output
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in stems if stems is not None else sources():
        out = library_path(stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / f"{stem}.cu")]
        procs[stem] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    reports: Dict[str, str] = {}
    failed: List[str] = []
    for stem, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[stem] = text
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


def load(stem: str) -> ctypes.CDLL:
    """The built library of ``<stem>.cu``, building it first if needed."""
    lib = _LOADED.get(stem)
    if lib is None:
        build_all([stem])
        lib = ctypes.CDLL(str(library_path(stem)))
        _LOADED[stem] = lib
    return lib
