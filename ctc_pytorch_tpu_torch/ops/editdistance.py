"""Levenshtein edit distance (copy of ``ctc_pytorch_tpu/ops/editdistance.py``
``edit_distance`` and ``batch_edit_distance``), matching the pure-python DP
in ``timit/utils/ctcDecoder.py:131-149`` (unit costs for ins/del/sub); its
batched form over padded arrays on the host (``padded_edit_distance``: the
native C++ of ``native/ctc_native.cpp``, whose plain twin is the numpy DP
``padded_edit_distance_plain``) and on the device
(``padded_edit_distance_device``)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Classic O(|ref|*|hyp|) DP, identical costs to ctcDecoder.py:131-149."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1)
    cur = np.empty(m + 1, dtype=np.int64)
    ref = list(ref)
    hyp_arr = np.asarray(list(hyp))
    for i in range(1, n + 1):
        cur[0] = i
        sub = prev[:-1] + (hyp_arr != ref[i - 1])
        # insertion needs a left-to-right scan; do it with a running min
        np.minimum(sub, prev[1:] + 1, out=cur[1:])
        for j in range(1, m + 1):  # resolve the sequential insertion term
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev, cur = cur, prev
    return int(prev[m])


def batch_edit_distance(refs: List[np.ndarray],
                        hyps: List[np.ndarray]) -> np.ndarray:
    """Edit distance for each (ref, hyp) pair."""
    return np.array([edit_distance(r, h) for r, h in zip(refs, hyps)])


def padded_edit_distance(refs: np.ndarray, ref_lens: np.ndarray,
                         hyps: np.ndarray, hyp_lens: np.ndarray) -> np.ndarray:
    """(B,) int64 edit distances of padded ``refs (B, N)`` and ``hyps (B,
    M)`` with their lengths, on the host: the native batch DP
    (``native.batch_edit_distance_native``), as the JAX
    ``padded_edit_distance`` runs it where it builds.  A failed build raises;
    nothing falls back to ``padded_edit_distance_plain``."""
    from ctc_pytorch_tpu_torch import native

    return native.batch_edit_distance_native(refs, ref_lens, hyps, hyp_lens)


def padded_edit_distance_plain(refs: np.ndarray, ref_lens: np.ndarray,
                               hyps: np.ndarray, hyp_lens: np.ndarray
                               ) -> np.ndarray:
    """The native DP's twin in numpy (copy of the JAX
    ``_padded_edit_distance_numpy``, ``editdistance.py:64-90``): the DP over
    the hyp axis row by row, vectorised across B, the insertion recurrence a
    prefix minimum."""
    b, n_max = refs.shape
    m_max = hyps.shape[1]
    prev = np.broadcast_to(np.arange(m_max + 1, dtype=np.int64),
                           (b, m_max + 1)).copy()
    # positions beyond hyp_lens are clamped later; run full DP then gather
    for i in range(1, n_max + 1):
        active = i <= ref_lens  # (B,)
        ref_tok = refs[:, i - 1][:, None]  # (B, 1)
        sub = prev[:, :-1] + (hyps != ref_tok)
        dele = prev[:, 1:] + 1
        cur = np.empty_like(prev)
        cur[:, 0] = i
        cur[:, 1:] = np.minimum(sub, dele)
        # prefix-min for insertions: cur[j] = min(cur[j], cur[k] + (j-k))
        base = cur - np.arange(m_max + 1)[None, :]
        np.minimum.accumulate(base, axis=1, out=base)
        cur = np.minimum(cur, base + np.arange(m_max + 1)[None, :])
        prev = np.where(active[:, None], cur, prev)
    return prev[np.arange(b), np.minimum(hyp_lens, m_max)]


def padded_edit_distance_device(refs: torch.Tensor, ref_lens: torch.Tensor,
                                hyps: torch.Tensor, hyp_lens: torch.Tensor
                                ) -> torch.Tensor:
    """(B,) int32 edit distances of padded ``refs (B, N)`` and ``hyps (B,
    M)`` with their lengths, on their device: the counterpart of the JAX
    ``padded_edit_distance_device`` (``editdistance.py:93-129``).

    Static shapes and no host read, so a CUDA graph can hold it.  The DP
    sweeps the ref axis, all rows of the batch at once.  A row is kept
    shifted, ``P[j] = D[i, j] - j``, where the insertion recurrence
    ``D[i, j] = min(D[i, j], D[i, j-1] + 1)`` is a running minimum
    (``cummin``): four ops a ref token.  Every row is kept, and each
    utterance reads its distance from row ``ref_len``, column
    ``min(hyp_len, M)``."""
    b, n_max = refs.shape
    m_max = hyps.shape[1]
    dev = refs.device
    i32 = torch.int32
    # neq[i, b, j] - 1: the substitution cost minus the column shift
    neq = (hyps.to(i32)[None] != refs.to(i32).T[:, :, None]).to(i32) - 1
    q = torch.empty(n_max + 1, b, m_max + 1, dtype=i32, device=dev)
    q[:, :, 0] = torch.arange(n_max + 1, dtype=i32, device=dev)[:, None]
    rows = torch.empty_like(q)
    rows[0] = 0  # D[0, j] = j
    idx = torch.empty(b, m_max + 1, dtype=torch.int64, device=dev)
    for i in range(1, n_max + 1):
        prev = rows[i - 1]
        # substitution from (i-1, j-1), deletion from (i-1, j)
        torch.minimum(prev[:, :-1] + neq[i - 1], prev[:, 1:] + 1,
                      out=q[i, :, 1:])
        torch.cummin(q[i], dim=1, out=(rows[i], idx))
    cols = torch.clamp(hyp_lens.to(torch.int64), max=m_max)
    last = rows[ref_lens.to(torch.int64), torch.arange(b, device=dev), cols]
    return last + cols.to(i32)
