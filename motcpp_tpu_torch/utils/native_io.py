"""ctypes bindings for the native IO runtime (``native/motcpp_io.cpp``).

Counterpart of ``motcpp_tpu/utils/native_io.py``. The source is read
where it is and never written: the library is built with ``g++`` into
``motcpp_tpu_torch/_build/`` under a name keyed on a hash of the source
and flags (``cuda_build.build``: a temporary name, then ``os.replace``,
so concurrent builds never load a half-written file), at first use,
never at import. Callers (``data/mot17.py``, ``data/mot_format.py``)
fall back to the Python parsers and writer when the toolchain or the
library is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from motcpp_tpu_torch import cuda_build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "motcpp_io.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def build() -> Path:
    """Compile the native IO library unless this source and these flags
    have been built; returns its path. Raises when ``g++`` fails."""
    return cuda_build.build(SOURCE, FLAGS, "motcpp_io", compiler="g++")


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        lib.motio_parse_floats.restype = ctypes.POINTER(ctypes.c_float)
        lib.motio_parse_floats.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.motio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.motio_write_mot.restype = ctypes.c_int
        lib.motio_write_mot.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_floats(path, max_cols: int = 1024) -> np.ndarray:
    """Parse a numeric text file to (rows, cols) float32; raises if the
    native library is unavailable (callers catch and fall back)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native io unavailable")
    rows = ctypes.c_long()
    cols = ctypes.c_int()
    ptr = lib.motio_parse_floats(
        os.fspath(path).encode(), max_cols, ctypes.byref(rows),
        ctypes.byref(cols))
    if not ptr:
        return np.zeros((0, 0), np.float32)
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(rows.value, cols.value)).copy()
    finally:
        lib.motio_free(ptr)
    return arr


def parse_detections(path):
    """MOT det file -> [(frame, [x1, y1, x2, y2, conf, cls]), ...], the
    Python parser's contract (``data/mot17.py``), with the format
    detected per file from its first data line."""
    with open(path, "r") as f:
        first = ""
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                first = line
                break
    comma = "," in first
    arr = parse_floats(path)
    rows = []
    if arr.shape[0] == 0 or arr.shape[1] < 7:
        return rows
    if comma:  # frame,-1,x,y,w,h,conf[,cls]
        for r in arr:
            cls = r[7] if arr.shape[1] > 7 else 0.0
            rows.append(
                (int(r[0]), [r[2], r[3], r[2] + r[4], r[3] + r[5], r[6], cls]))
    else:  # frame x1 y1 x2 y2 conf cls
        for r in arr:
            rows.append((int(r[0]), [r[1], r[2], r[3], r[4], r[5], r[6]]))
    return rows


def parse_embeddings(path) -> np.ndarray:
    """One embedding vector per line -> (n, d) float32."""
    return parse_floats(path, max_cols=4096)


def write_mot(path, mot_rows: np.ndarray) -> bool:
    """Append (n, 10) MOT rows in the reference's text format; False
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(mot_rows, np.float32)
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    return lib.motio_write_mot(os.fspath(path).encode(), ptr,
                               arr.shape[0]) == 0
