"""Builds the port's CUDA sources into shared libraries with ``nvcc`` at
first use, and loads them with ``ctypes``.

Each ``<stem>.cu`` in this directory has a plain C interface and is
compiled alone for ``sm_90a`` into ``_build/<stem>-<hash>.so``, where the
hash covers the source, the shared headers (``*.cuh``) and the flags, so
an edited source or header rebuilds.
``build_all`` starts one ``nvcc`` per source that is not built yet, all at
once, and waits for them (``compile_jobs``, which also builds K6's
generated kernels: ``expr_program.py``). The build needs only the CUDA toolkit (no
PyTorch headers, no ``ninja``). ``nvcc`` is ``$CUDA_HOME/bin/nvcc``, else
``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

BUILD_TIMEOUT = 900  # seconds one nvcc may take before the build fails

_LOADED: Dict[str, ctypes.CDLL] = {}
# held while a kernel is built or loaded: a workflow's runner threads
# (``fugue.workflow.concurrency``) may first need one kernel at once
LOCK = threading.RLock()


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
    """Where ``<stem>.cu`` builds to: keyed by the source, every header of
    this directory (``*.cuh``) and the flags."""
    digest = hashlib.sha256((KERNEL_DIR / f"{stem}.cu").read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def compile_jobs(jobs: List[Tuple[str, List[str], Path]],
                 parallel: Optional[int] = None) -> Dict[str, str]:
    """Runs one ``nvcc`` a job ``(label, arguments, output)``, at most
    ``parallel`` at once (default: all together). Each writes a temporary
    file that is renamed onto its output when it succeeds (atomic: a
    concurrent build sees all or none). Returns each job's compiler
    report; raises ``RuntimeError`` with the compiler's output of every
    job that failed."""
    reports: Dict[str, str] = {}
    failed: List[str] = []
    pending = list(jobs)
    running: List[Tuple[str, subprocess.Popen, Path, Path]] = []
    limit = parallel if parallel else max(len(jobs), 1)

    def finish(label: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
        try:
            text, _ = proc.communicate(timeout=BUILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            text = proc.communicate()[0] + f"\nkilled after {BUILD_TIMEOUT} s"
        reports[label] = text
        if proc.returncode != 0:
            failed.append(f"{label} (nvcc exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)

    while pending or running:
        while pending and len(running) < limit:
            label, args, out = pending.pop(0)
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            proc = subprocess.Popen([nvcc(), *args, "-o", str(tmp)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((label, proc, tmp, out))
        finish(*running.pop(0))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


def build_all(stems: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every named source (default: all) that has no library yet,
    with one ``nvcc`` each, all started together. Returns each built
    source's compiler report (``-Xptxas=-v``: registers, shared memory and
    spills per kernel); raises ``RuntimeError`` with the compiler's output
    if any build fails."""
    with LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = [(stem, [*NVCC_FLAGS, str(KERNEL_DIR / f"{stem}.cu")], library_path(stem))
                for stem in (stems if stems is not None else sources())
                if not library_path(stem).exists()]
        return compile_jobs(jobs)


def load(stem: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The built library of ``<stem>.cu``, building it first if needed;
    ``declare`` sets its entry points' argument types once, before any
    caller sees it. Thread-safe: one build and one load a process."""
    lib = _LOADED.get(stem)
    if lib is None:
        with LOCK:
            lib = _LOADED.get(stem)
            if lib is None:
                build_all([stem])
                lib = ctypes.CDLL(str(library_path(stem)))
                declare(lib)
                _LOADED[stem] = lib
    return lib
