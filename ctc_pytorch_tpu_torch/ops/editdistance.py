"""Levenshtein edit distance (copy of ``ctc_pytorch_tpu/ops/editdistance.py``
``edit_distance``), matching the pure-python DP in
``timit/utils/ctcDecoder.py:131-149`` (unit costs for ins/del/sub)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


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
