"""ctypes binding of the host-side beam search (``ctc_native.cpp``).

Counterpart of ``ctc_pytorch_tpu/native/__init__.py`` for the beam search
alone.  The library is compiled at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``native/build/libctc_native-<digest>.so`` (the digest
covers the source and the flags, so a changed source rebuilds).  The build
writes a temporary file and renames it into place, so processes that build
at the same moment each load a whole library.  A failed build raises with
the compiler's output: the caller asked for the native search, and nothing
falls back to the numpy one.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ctc_native.cpp"
BUILD_DIR = SOURCE.parent / "build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libctc_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError(
            f"native beam search: cannot run {CXX!r} ({exc})") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"native beam search: {CXX} failed ({proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ctc_beam_search.restype = ctypes.c_int32
            lib.ctc_beam_search.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.c_float, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def ctc_beam_search_native(
    probs: np.ndarray,
    beam_width: int,
    lm_table: Optional[np.ndarray] = None,
    lm_alpha: float = 0.0,
    blank: int = 0,
    length: Optional[int] = None,
) -> Tuple[Tuple[int, ...], float]:
    """``decode/beam.py:ctc_beam_search`` in C++: ``probs`` (T, C)
    probabilities, read as float32; the LM table as float32, summed in
    double.  Returns (best label sequence, normalised score)."""
    lib = load()
    probs = np.ascontiguousarray(probs, np.float32)
    t, c = probs.shape
    if not 0 <= blank < c:
        raise ValueError(f"blank {blank} is not a class of {c}")
    length = t if length is None else int(length)
    out_seq = np.zeros(max(t, 1), np.int32)
    out_score = ctypes.c_double(0.0)
    if lm_table is not None:
        lm_arr = np.ascontiguousarray(lm_table, np.float32)
        if (lm_arr.ndim != 2 or lm_arr.shape[0] != lm_arr.shape[1]
                or lm_arr.shape[0] <= c):
            raise ValueError(f"lm_table must be ({c + 1}+, {c + 1}+) for {c} "
                             f"classes, got {lm_arr.shape}")
        lm_ptr, lm_dim = _ptr(lm_arr, ctypes.c_float), lm_arr.shape[0]
    else:
        lm_ptr, lm_dim = ctypes.POINTER(ctypes.c_float)(), 0
    n = lib.ctc_beam_search(
        _ptr(probs, ctypes.c_float), t, c, length, beam_width, lm_ptr,
        lm_dim, lm_alpha, blank, _ptr(out_seq, ctypes.c_int32),
        ctypes.byref(out_score),
    )
    return tuple(int(x) for x in out_seq[:n]), float(out_score.value)
