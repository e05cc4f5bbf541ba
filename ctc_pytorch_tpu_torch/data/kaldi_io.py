"""Kaldi ark/scp matrix I/O — self-contained replacement for ``kaldiio``.

The reference reads features with ``kaldiio.load_mat(path)`` where ``path`` is
an scp entry ``file.ark:offset`` (``timit/utils/data_loader.py:104``), and the
863 recipe parses text-format feature dumps (``my_863_corpus/steps/utils.py:
75-97``).  This module covers:

- scp files (``utt ark_path:offset``),
- binary ark matrices: float/double ("BFM "/"BDM ") and Kaldi
  CompressedMatrix format 1 ("CM "),
- text ark matrices (``utt  [\\n  v v v ...\\n  ... ]``),
- writing ``ark,scp`` pairs (uncompressed BFM) so our frontend can emit
  artifacts byte-compatible with the reference pipeline's expectations,
- text CMVN stats as written by ``compute-cmvn-stats --binary=false``
  (``timit/steps/make_feat.sh:28``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np


def read_scp(scp_path: str | Path) -> List[Tuple[str, str]]:
    """Parse ``utt rxspecifier`` lines, preserving file order."""
    items = []
    for line in Path(scp_path).read_text().splitlines():
        parts = line.strip().split(None, 1)
        if len(parts) == 2:
            items.append((parts[0], parts[1]))
    return items


def load_mat(rxspec: str) -> np.ndarray:
    """Load a matrix from an ``ark_path:offset`` specifier (kaldiio.load_mat)."""
    if ":" in rxspec:
        path, offset = rxspec.rsplit(":", 1)
        offset = int(offset)
    else:
        path, offset = rxspec, 0
    with open(path, "rb") as f:
        f.seek(offset)
        return _read_binary_matrix(f)


def mat_rows(rxspec: str) -> int | None:
    """Row count of the matrix at ``ark_path:offset`` from its header only
    (no payload read).  None when the entry isn't a plain/compressed binary
    matrix — callers fall back to a full load."""
    if ":" in rxspec:
        path, offset = rxspec.rsplit(":", 1)
        offset = int(offset)
    else:
        path, offset = rxspec, 0
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            _expect(f, b"\x00B")
            token = b""
            while len(token) < 8:
                ch = f.read(1)
                token += ch
                if ch == b" ":
                    break
            token = token.strip()
            if token in (b"FM", b"DM"):
                return _read_int32(f)
            if token == b"CM":
                f.read(8)  # min_value, range
                return struct.unpack("<ii", f.read(8))[0]
    except (OSError, ValueError):
        return None
    return None


def read_ark_entry(f) -> Tuple[str, np.ndarray]:
    """Read one ``utt <matrix>`` entry from an open binary ark stream."""
    utt = b""
    while True:
        ch = f.read(1)
        if not ch:
            raise EOFError
        if ch == b" ":
            break
        utt += ch
    return utt.decode(), _read_binary_matrix(f)


def iter_ark(ark_path: str | Path) -> Iterator[Tuple[str, np.ndarray]]:
    with open(ark_path, "rb") as f:
        while True:
            try:
                yield read_ark_entry(f)
            except EOFError:
                return


def _expect(f, token: bytes):
    got = f.read(len(token))
    if got != token:
        raise ValueError(f"expected {token!r}, got {got!r}")


def _read_int32(f) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"bad int size byte {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_binary_matrix(f) -> np.ndarray:
    _expect(f, b"\x00B")
    token = b""
    while True:
        ch = f.read(1)
        token += ch
        if ch == b" ":
            break
    token = token.strip()
    if token in (b"FM", b"DM"):
        rows = _read_int32(f)
        cols = _read_int32(f)
        dtype = np.float32 if token == b"FM" else np.float64
        data = np.frombuffer(f.read(rows * cols * dtype().itemsize), dtype=dtype)
        return data.reshape(rows, cols).astype(np.float32)
    if token == b"CM":
        return _read_compressed_matrix(f)
    if token in (b"FV", b"DV"):
        n = _read_int32(f)
        dtype = np.float32 if token == b"FV" else np.float64
        data = np.frombuffer(f.read(n * dtype().itemsize), dtype=dtype)
        return data.astype(np.float32)
    raise ValueError(f"unsupported kaldi matrix token {token!r}")


def _read_compressed_matrix(f) -> np.ndarray:
    """Kaldi CompressedMatrix format 1 (per-column 3-segment uint8 coding)."""
    min_value, rng = struct.unpack("<ff", f.read(8))
    num_rows, num_cols = struct.unpack("<ii", f.read(8))
    # per-column header: 4 uint16 percentiles (p0, p25, p75, p100)
    headers = np.frombuffer(f.read(8 * num_cols), dtype=np.uint16).reshape(
        num_cols, 4
    )
    data = np.frombuffer(f.read(num_rows * num_cols), dtype=np.uint8).reshape(
        num_cols, num_rows
    )

    def uint16_to_float(u):
        return min_value + rng * (u.astype(np.float64) / 65535.0)

    p0 = uint16_to_float(headers[:, 0])[:, None]
    p25 = uint16_to_float(headers[:, 1])[:, None]
    p75 = uint16_to_float(headers[:, 2])[:, None]
    p100 = uint16_to_float(headers[:, 3])[:, None]
    c = data.astype(np.float64)
    out = np.where(
        c <= 64,
        p0 + (p25 - p0) * (c / 64.0),
        np.where(
            c <= 192,
            p25 + (p75 - p25) * ((c - 64.0) / 128.0),
            p75 + (p100 - p75) * ((c - 192.0) / 63.0),
        ),
    )
    return out.T.astype(np.float32)


def read_text_ark(path: str | Path, feat_size: int | None = None) -> Dict[str, np.ndarray]:
    """Text-format feature dump (863's ``process_kaldi_feat`` semantics)."""
    feats: Dict[str, List[List[float]]] = {}
    utt = None
    for line in Path(path).read_text().splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[-1] == "[" or (len(parts) == 2 and parts[1] == "["):
            utt = parts[0]
            feats[utt] = []
            continue
        closing = parts[-1] == "]"
        if closing:
            parts = parts[:-1]
        if parts and utt is not None:
            row = [float(v) for v in (parts[:feat_size] if feat_size else parts)]
            feats[utt].append(row)
    return {u: np.asarray(v, np.float32) for u, v in feats.items()}


def read_cmvn_stats_text(path: str | Path) -> Tuple[np.ndarray, np.ndarray, float]:
    """Parse ``compute-cmvn-stats --binary=false`` output: a (2, dim+1) matrix
    ``[[sum..., count], [sumsq..., 0]]``.  Returns (sum, sumsq, count)."""
    text = Path(path).read_text().replace("[", " ").replace("]", " ")
    rows = [r.split() for r in text.strip().splitlines() if r.strip()]
    rows = [r for r in rows if r]
    mat = [np.asarray([float(v) for v in r]) for r in rows]
    first, second = mat[0], mat[1]
    return first[:-1], second[:-1], float(first[-1])


class ArkWriter:
    """Write ``ark,scp`` pairs of uncompressed float matrices ("BFM")."""

    def __init__(self, ark_path: str | Path, scp_path: str | Path | None = None):
        self.ark_path = Path(ark_path)
        self.scp_path = Path(scp_path) if scp_path else None
        self._ark = open(self.ark_path, "wb")
        self._scp = open(self.scp_path, "w") if self.scp_path else None

    def write(self, utt: str, mat: np.ndarray) -> None:
        mat = np.ascontiguousarray(mat, dtype=np.float32)
        self._ark.write(utt.encode() + b" ")
        offset = self._ark.tell()
        self._ark.write(b"\x00BFM ")
        self._ark.write(b"\x04" + struct.pack("<i", mat.shape[0]))
        self._ark.write(b"\x04" + struct.pack("<i", mat.shape[1]))
        self._ark.write(mat.tobytes())
        if self._scp:
            self._scp.write(f"{utt} {self.ark_path}:{offset}\n")

    def close(self) -> None:
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
