"""ctypes bridge to the native TSV parser/writer (native/fastload.cc,
native/fastsave.cc), the port's copy of `hgaprec_tpu/data/native.py`.

The C sources are read in place from `<checkout>/native/`. They are
compiled with g++ on first use into `.native_build/libfastload_torch.so`:
a library of the port's own, written to a temporary file and moved into
place with `os.replace`, so two test workers, or the JAX package's own
build of `libfastload.so`, never see a half-written library. This is a
host helper, not a device kernel: when g++ is missing every function
returns False or None and the caller takes its Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRCS = [os.path.join(_ROOT, "native", "fastload.cc"),
         os.path.join(_ROOT, "native", "fastsave.cc")]
_BUILD = os.path.join(_ROOT, ".native_build")
_SO = os.path.join(_BUILD, "libfastload_torch.so")


def library_path() -> str:
    return _SO


def _build() -> None:
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.check_call(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, *_SRCS,
             "-lpthread"], stderr=subprocess.DEVNULL)
        os.replace(tmp, _SO)     # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            src_mtime = max(os.path.getmtime(s) for s in _SRCS)
            if (not os.path.exists(_SO) or
                    os.path.getmtime(_SO) < src_mtime):
                _build()
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.CalledProcessError):
            return None       # no toolchain: callers take the Python path
        lib.parse_tsv3.restype = ctypes.c_int64
        lib.parse_tsv3.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
        ]
        lib.count_lines.restype = ctypes.c_int64
        lib.count_lines.argtypes = [ctypes.c_char_p]
        lib.write_tsv_mat.restype = ctypes.c_int64
        lib.write_tsv_mat.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_tsv3(path: str) -> Optional[np.ndarray]:
    """[rows, 3] int64 array of (uid, mid, rating), or None if the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nlines = lib.count_lines(path.encode())
    if nlines < 0:
        return None
    cap = int(nlines) + 1
    u = np.empty(cap, np.int64)
    m = np.empty(cap, np.int64)
    y = np.empty(cap, np.int64)
    rows = lib.parse_tsv3(path.encode(), u, m, y, cap)
    if rows < 0:
        return None
    return np.stack([u[:rows], m[:rows], y[:rows]], axis=1)


def write_tsv_mat(path: str, x: np.ndarray, ext_ids: np.ndarray) -> bool:
    """Write `seq \\t ext \\t v0 ... vK-1` rows at %.8f (the reference
    checkpoint format, matrix.hh:1140-1166). Returns False if the native
    library is unavailable (caller falls back to Python)."""
    lib = _load()
    if lib is None:
        return False
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError("write_tsv_mat expects a 2-D array")
    ext_ids = np.ascontiguousarray(ext_ids, np.int64)
    if ext_ids.shape[0] != x.shape[0]:
        raise ValueError("ext_ids length mismatch")
    rows = lib.write_tsv_mat(path.encode(), x, x.shape[0], x.shape[1],
                             ext_ids)
    return rows == x.shape[0]
