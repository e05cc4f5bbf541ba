"""ctypes bindings of the host-side C++: the beam search and the batch edit
distance (``ctc_native.cpp``) and the one-pass ark reader
(``ark_native.cpp``).

Counterpart of ``ctc_pytorch_tpu/native/__init__.py``.  Both sources are
compiled at first use with ``g++ -O3 -shared -fPIC -std=c++17`` into one
library, ``native/build/libctc_native-<digest>.so`` (the digest covers the
sources and the flags, so a changed source rebuilds).  The build writes a
temporary file and renames it into place, so processes (or threads) that
build at the same moment each load a whole library.  A failed build raises
with the compiler's output: the caller asked for the native search or
reader (or edit distance), and nothing falls back to the numpy one.  Nothing is built at
import time.  ctypes releases the GIL for the length of a call, so the
reader's calls from ``SpeechDataset.preload``'s threads run in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ctc_native.cpp"
ARK_SOURCE = SOURCE.parent / "ark_native.cpp"
BUILD_DIR = SOURCE.parent / "build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> Tuple[Path, Path]:
    return SOURCE, ARK_SOURCE


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _sources())
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
        proc = subprocess.run([CXX, *CXX_FLAGS, *map(str, _sources()), "-o",
                               tmp],
                              capture_output=True, text=True, timeout=300)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError(
            f"native library: cannot run {CXX!r} ({exc})") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"native library: {CXX} failed ({proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.batch_edit_distance.restype = None
            lib.batch_edit_distance.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64)]
            lib.ctc_beam_search.restype = ctypes.c_int32
            lib.ctc_beam_search.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.c_float, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.ark_open.restype = ctypes.c_int32
            lib.ark_open.argtypes = [ctypes.c_char_p]
            lib.ark_close.restype = None
            lib.ark_close.argtypes = [ctypes.c_int32]
            lib.ark_dims_fd.restype = ctypes.c_int32
            lib.ark_dims_fd.argtypes = [
                ctypes.c_int32, ctypes.c_long, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.ark_load_processed_fd.restype = ctypes.c_int32
            lib.ark_load_processed_fd.argtypes = [
                ctypes.c_int32, ctypes.c_long, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long]
            _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def batch_edit_distance_native(refs: np.ndarray, ref_lens: np.ndarray,
                               hyps: np.ndarray, hyp_lens: np.ndarray
                               ) -> np.ndarray:
    """(B,) int64 Levenshtein distances of padded ``refs (B, N)`` and
    ``hyps (B, M)`` with their lengths, read as int32 (the JAX
    ``batch_edit_distance_native``); a length past its padding is clamped
    to it."""
    lib = load()
    refs = np.ascontiguousarray(refs, np.int32)
    hyps = np.ascontiguousarray(hyps, np.int32)
    ref_lens = np.ascontiguousarray(ref_lens, np.int32)
    hyp_lens = np.ascontiguousarray(hyp_lens, np.int32)
    b = refs.shape[0]
    if not (hyps.shape[0] == ref_lens.shape[0] == hyp_lens.shape[0] == b):
        raise ValueError(f"batch sizes differ: refs {refs.shape}, hyps "
                         f"{hyps.shape}, lengths {ref_lens.shape}, "
                         f"{hyp_lens.shape}")
    out = np.zeros(b, np.int64)
    lib.batch_edit_distance(
        _ptr(refs, ctypes.c_int32), _ptr(ref_lens, ctypes.c_int32),
        _ptr(hyps, ctypes.c_int32), _ptr(hyp_lens, ctypes.c_int32), b,
        refs.shape[1] if refs.ndim > 1 else 0,
        hyps.shape[1] if hyps.ndim > 1 else 0, _ptr(out, ctypes.c_int64))
    return out


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


ERR_FORMAT = -2  # ark_native.cpp: not an uncompressed "BFM " matrix

# cached fds for the pread reader, by path and inode: each ark file is
# opened once per process (a file written anew under the same name is
# opened anew); pread has no seek state, so threads share one fd safely
_ark_fds: Dict[Tuple[str, int], int] = {}
_ark_fd_lock = threading.Lock()


def _ark_fd(lib, path: str) -> int:
    key = (path, os.stat(path).st_ino)
    fd = _ark_fds.get(key)
    if fd is not None:
        return fd
    with _ark_fd_lock:
        fd = _ark_fds.get(key)
        if fd is None:
            fd = int(lib.ark_open(path.encode()))
            if fd < 0:
                raise OSError(f"native ark reader: cannot open {path!r}")
            _ark_fds[key] = fd
    return fd


def close_ark_files() -> None:
    """Close every cached ark fd (tests, long-lived servers)."""
    with _ark_fd_lock:
        if _lib is not None:
            for fd in _ark_fds.values():
                _lib.ark_close(fd)
        _ark_fds.clear()


def ark_load_processed_native(
    rxspec: str, left: int, right: int, skip: int, downsample: int,
) -> Optional[np.ndarray]:
    """Read the ``ark:offset`` matrix of ``rxspec`` and splice (``left`` and
    ``right`` frames, edges replicated), skip (every ``skip``-th row) and
    zero-pad it (rows to a multiple of ``downsample``) in one native pass;
    float32 ``(rows_out, cols * (left + 1 + right))``, bit for bit the
    numpy path's.

    Returns None when the entry is not an uncompressed float matrix (the
    dataset reads those through numpy: dispatch by format).  A read error
    raises ``OSError``; a failed build raises ``RuntimeError``.  The ark
    file is opened once and read by positional reads (pread): a header
    pread and a payload pread an utterance."""
    lib = load()
    if ":" in rxspec:
        path, off_s = rxspec.rsplit(":", 1)
        offset = int(off_s)
    else:
        path, offset = rxspec, 0
    fd = _ark_fd(lib, path)
    rows = ctypes.c_int32()
    cols = ctypes.c_int32()
    rc = lib.ark_dims_fd(fd, offset, ctypes.byref(rows), ctypes.byref(cols))
    if rc == ERR_FORMAT:
        return None
    if rc != 0:
        raise OSError(f"native ark reader: cannot read {rxspec!r} ({rc})")
    skip = max(skip, 1)
    downsample = max(downsample, 1)
    rows_sk = (rows.value + skip - 1) // skip
    rows_out = rows_sk + (-rows_sk) % downsample
    cols_out = cols.value * (left + 1 + right)
    out = np.empty((max(rows_out, 1), cols_out), np.float32)
    got = lib.ark_load_processed_fd(
        fd, offset, left, right, skip, downsample,
        _ptr(out, ctypes.c_float), out.shape[0],
    )
    if got < 0:
        raise OSError(f"native ark reader: cannot read {rxspec!r} ({got})")
    return out[:got]
