"""Native (C++) CSV reader and writer, bound with ``ctypes``.

``fast_csv.cpp`` parses a 3-row-header DLC CSV in one read and two passes;
``fast_csv_write.cpp`` writes a float table byte-identical to
``df.to_csv(path)``. Both are host code and copies of the JAX package's.

Each source is compiled with ``g++`` at first use into ``eks_tpu_torch/_build/``
under a name that carries a hash of the source and the flags, so an edited
source rebuilds and a stale library is never loaded. A library that cannot be
built or loaded (no compiler, a failed build) is logged once at WARNING and
its callers in ``utils.io`` take pandas; ``READS`` and ``WRITES`` count which
path each read and write took, and ``BUILT`` holds the seconds of every
library this process compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "BUILT",
    "READS",
    "WRITES",
    "load_dlc_csv_fast",
    "native_available",
    "writer_available",
    "write_dlc_csv_fast",
]

_DIR = Path(__file__).resolve().parent
_BUILD = _DIR.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: which path each CSV read and write of ``utils.io`` took
READS = {"native": 0, "pandas": 0}
WRITES = {"native": 0, "pandas": 0}
#: library name -> seconds, for the libraries compiled by this process
BUILT: dict[str, float] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(src.read_bytes())
    return _BUILD / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _load_or_build(name: str, bind) -> ctypes.CDLL | None:
    """The library of ``{name}.cpp``, compiled first if it is not built yet,
    with its ctypes signatures bound; None (logged at WARNING) when it cannot
    be built or loaded."""
    src = _DIR / f"{name}.cpp"
    try:
        path = _library_path(src)
        if not path.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            subprocess.run(
                ["g++", *_FLAGS, str(src), "-o", str(tmp)],
                check=True, capture_output=True, text=True, timeout=120,
            )
            os.replace(tmp, path)
            BUILT[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        bind(lib)
        return lib
    except (OSError, subprocess.SubprocessError, AttributeError) as e:
        # no compiler, a failed or timed-out build, a library that does not
        # load or lacks a symbol
        detail = getattr(e, "stderr", None) or e
        logger.warning(f"native {src.name} unavailable, CSVs go through pandas: {detail}")
        return None


def _bind_reader(lib) -> None:
    lib.dlc_csv_open.restype = ctypes.c_void_p
    lib.dlc_csv_open.argtypes = [ctypes.c_char_p]
    lib.dlc_csv_rows.restype = ctypes.c_int64
    lib.dlc_csv_rows.argtypes = [ctypes.c_void_p]
    lib.dlc_csv_cols.restype = ctypes.c_int64
    lib.dlc_csv_cols.argtypes = [ctypes.c_void_p]
    lib.dlc_csv_header.restype = ctypes.c_char_p
    lib.dlc_csv_header.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dlc_csv_data.restype = ctypes.POINTER(ctypes.c_double)
    lib.dlc_csv_data.argtypes = [ctypes.c_void_p]
    lib.dlc_csv_close.restype = None
    lib.dlc_csv_close.argtypes = [ctypes.c_void_p]


def _bind_writer(lib) -> None:
    for name, ctype in (
        ("dlc_csv_write_f32", ctypes.c_float),
        ("dlc_csv_write_f64", ctypes.c_double),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.c_char_p,  # header bytes
            ctypes.c_longlong,  # header length
            ctypes.POINTER(ctype),  # data
            ctypes.c_longlong,  # rows
            ctypes.c_longlong,  # cols
            ctypes.c_longlong,  # index start
        ]


def _get(name: str, bind) -> ctypes.CDLL | None:
    """The library ``name``, built and loaded once per process (a failure is
    not retried)."""
    with _lock:
        if name not in _libs:
            _libs[name] = _load_or_build(name, bind)
        return _libs[name]


def native_available() -> bool:
    """Whether the native reader is built and loaded."""
    return _get("fast_csv", _bind_reader) is not None


def writer_available() -> bool:
    """Whether the native writer is built and loaded."""
    return _get("fast_csv_write", _bind_writer) is not None


def write_dlc_csv_fast(df, path: str) -> bool:
    """Write a homogeneous float DataFrame with a unit-step integer index as
    CSV, byte-identical to ``df.to_csv(path)`` (pandas repr formatting, NaN
    as an empty field, header rows rendered by pandas itself). Returns False,
    and the caller takes pandas, for anything the native path does not cover:
    mixed column dtypes, another index, no library."""
    import pandas as pd

    lib = _get("fast_csv_write", _bind_writer)
    if lib is None:
        return False
    # per-COLUMN homogeneity: a mixed f32/f64 frame upcasts in to_numpy(),
    # which would format the f32 columns with f64 repr and break
    # byte-equality with pandas
    if len(set(df.dtypes)) != 1:
        return False
    index = df.index
    if isinstance(index, pd.RangeIndex):
        if index.step != 1:
            return False
        start = int(index.start)
    else:
        vals = np.asarray(index)
        if vals.ndim != 1 or vals.dtype.kind != "i" or (
            len(vals) > 1 and not np.array_equal(vals, np.arange(vals[0], vals[0] + len(vals)))
        ):
            return False
        start = int(vals[0]) if len(vals) else 0
    data = df.to_numpy()
    if data.dtype == np.float32:
        fn, ctype = lib.dlc_csv_write_f32, ctypes.c_float
    elif data.dtype == np.float64:
        fn, ctype = lib.dlc_csv_write_f64, ctypes.c_double
    else:
        return False
    header = df.head(0).to_csv().encode("utf-8")
    data = np.ascontiguousarray(data)
    rc = fn(
        os.fsencode(path), header, len(header),
        data.ctypes.data_as(ctypes.POINTER(ctype)),
        data.shape[0], data.shape[1], start,
    )
    return rc == 0


def load_dlc_csv_fast(path: str):
    """Parse a 3-row-header DLC CSV natively.

    Returns:
        (data (T, n_cols) float64 array, headers: list of 3 lists of cell
        strings INCLUDING the index column), or None if the native reader is
        unavailable or the file does not parse.
    """
    lib = _get("fast_csv", _bind_reader)
    if lib is None:
        return None
    handle = lib.dlc_csv_open(os.fsencode(path))
    if not handle:
        return None
    try:
        rows = lib.dlc_csv_rows(handle)
        cols = lib.dlc_csv_cols(handle)
        headers = [
            lib.dlc_csv_header(handle, i).decode("utf-8").split("\x1f")
            for i in range(3)
        ]
        buf = np.ctypeslib.as_array(lib.dlc_csv_data(handle), shape=(int(rows), int(cols)))
        data = np.array(buf, dtype=np.float64)  # copy out before close
    finally:
        lib.dlc_csv_close(handle)
    return data, headers
