"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``. Libraries are built at first use
into ``eks_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited source rebuilds and a stale library is never
loaded. ``build()`` starts one ``nvcc`` per missing library, all at once.
Building and loading hold a lock, so a caller's threads that launch at once
build and load each library once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["COUNT_LOCK", "KERNEL_SOURCES", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

#: library name -> its CUDA source; every source also includes the headers
KERNEL_SOURCES = {
    "prefix_scan": "prefix_scan.cu",
    "fused_nll": "fused_nll.cu",
    "fused_nll_tv": "fused_nll_tv.cu",
}
_HEADERS = ("filter_algebra.cuh",)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()

#: held by the kernel wrappers while they add to their launch counts, which
#: a caller's threads may update at once
COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for fname in (KERNEL_SOURCES[name], *_HEADERS):
        h.update((_CSRC / fname).read_bytes())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the libraries in ``names`` (default: all) that are not built
    yet, one ``nvcc`` each, in parallel. Returns {name: (seconds, ptxas
    report)} for the libraries compiled by this call; raises with the
    compiler's output if any fails."""
    with _LOCK:
        return _build(list(KERNEL_SOURCES) if names is None else list(names))


def _build(names: list) -> dict:
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return {}
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / KERNEL_SOURCES[n])]
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    report, failed = {}, []
    for n, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {KERNEL_SOURCES[n]} for {n} (rc={proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, _library_path(n))
        report[n] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                build([name])
                lib = _LOADED[name] = ctypes.CDLL(str(_library_path(name)))
    return lib
