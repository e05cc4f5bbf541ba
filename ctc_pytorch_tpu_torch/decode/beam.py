"""CTC prefix beam search with bigram LM fusion (the ``Beam`` and
``BeamDevice`` decoders).

``ctc_beam_search`` is a copy of ``ctc_pytorch_tpu/decode/beam.py:55``
(numpy, the parity decoder); ``BeamDecoder`` is the port of ``:147``: its
``decode`` copies a batch's log-probs to the host once and runs the C++
search (``native/``) per utterance, its ``decode_on_device`` runs
``decode/beam_device.py:batched_beam_search`` on the log-probs' device.

Re-derivation of the reference's per-utterance dict-based search
(``timit/utils/BeamSearch.py``) with identical scoring rules:

- probability domain input (``BeamDecoder`` exps the log-probs,
  ``ctcDecoder.py:180-181``); internal scores in natural log;
- frames with ``1 - p(blank) < 0.1`` are skipped entirely
  (``BeamSearch.py:93-94``);
- per frame, the top ``beam_width`` prefixes by ``prTotal`` are expanded:
  each survives as itself (blank path ``prTotal + log p(blank)``, repeat path
  ``prNonBlank + log p(y[-1])``) and extends with every non-blank class;
- extending with ``k == y[-1]`` uses ``prBlank`` when the **previous
  frame's** blank probability was < 0.9, and ``prTotal`` otherwise
  (``BeamSearch.py:63-66`` — note ``mat[t-1]``, the raw frame index);
- the LM adds ``lm_alpha * ln p(c2 | c1)`` on every extension, with empty
  history mapping to <s> (``BeamSearch.py:56-60``, ``NgramLM.py:70-73``);
- after the last frame, ``lm_alpha * ln p(</s> | last)`` is added and scores
  are length-normalised (``BeamSearch.py:130-145``).

The inner loop is vectorised over classes with numpy (the reference loops in
pure python per class); the LM is a dense ``(V+1, V+1)`` table so lookup is
one row gather.  Prefixes stay in a hash map exactly like the reference —
this path is the *parity* decoder.  ``batched_beam_search`` in
``decode/beam_device.py`` is the fixed-width on-device version.

String format quirk, preserved deliberately: beam hypotheses are plain
``' '.join(units)`` with NO leading space (``BeamSearch.py:151``), while the
greedy path's ``_process_string`` prefixes every unit with a space
(``ctcDecoder.py:86-92``).  The reference therefore scores beam CER one
character apart from greedy CER on identical hypotheses; reproducing the
join exactly is what keeps our beam strings bit-equal to the reference's.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ctc_pytorch_tpu_torch import native
from ctc_pytorch_tpu_torch.decode.beam_device import (
    batched_beam_search,
    batched_beam_search_sharded,
)
from ctc_pytorch_tpu_torch.decode.metrics import Scorer
from ctc_pytorch_tpu_torch.decode.ngram_lm import LanguageModel

LOG_ZERO = -99999999.0


def _log_add(x: float, y: float) -> float:
    if x <= LOG_ZERO:
        return y
    if y <= LOG_ZERO:
        return x
    if y > x:
        x, y = y, x
    return x + math.log1p(math.exp(y - x))


def ctc_beam_search(
    mat: np.ndarray,
    beam_width: int,
    lm_table: Optional[np.ndarray] = None,
    lm_alpha: float = 0.0,
    blank_index: int = 0,
    length: Optional[int] = None,
) -> Tuple[Tuple[int, ...], float]:
    """Decode one utterance.

    Args:
      mat: (T, C) **probabilities** (not log).
      lm_table: (V+1, V+1) natural-log bigram table (row V = <s>, col V = </s>).
      length: valid frame count (defaults to T).

    Returns (best label sequence, normalised score).
    """
    t_len = mat.shape[0] if length is None else int(length)
    num_class = mat.shape[1]
    sentinel = lm_table.shape[0] - 1 if lm_table is not None else 0

    log_mat = np.log(np.maximum(mat, 1e-300))
    # beams: prefix tuple -> [prBlank, prNonBlank]
    beams: Dict[Tuple[int, ...], List[float]] = {(): [0.0, LOG_ZERO]}

    classes = np.arange(num_class)
    nonblank = classes[classes != blank_index]

    for t in range(t_len):
        if 1.0 - mat[t, blank_index] < 0.1:
            continue  # blank-skip pruning
        # top beam_width by prTotal
        scored = sorted(
            beams.items(),
            key=lambda kv: _log_add(kv[1][0], kv[1][1]),
            reverse=True,
        )
        best = scored[:beam_width]
        curr: Dict[Tuple[int, ...], List[float]] = {}

        lp_t = log_mat[t]
        lp_blank = lp_t[blank_index]
        prev_blank_ge = mat[t - 1, blank_index] >= 0.9 if t > 0 else True

        for y, (pr_b, pr_nb) in best:
            pr_total = _log_add(pr_b, pr_nb)
            # -- copy path -------------------------------------------------
            entry = curr.setdefault(y, [LOG_ZERO, LOG_ZERO])
            entry[0] = _log_add(entry[0], pr_total + lp_blank)
            if y:
                entry[1] = _log_add(entry[1], pr_nb + lp_t[y[-1]])
            # -- extensions (vectorised over classes) ----------------------
            if lm_table is not None:
                c1 = y[-1] if y else sentinel
                lm_row = lm_table[c1] * lm_alpha
            else:
                lm_row = np.zeros(num_class + 1)
            base = pr_total
            ext_scores = lp_t[nonblank] + lm_row[nonblank] + base
            if y:
                k_last = y[-1]
                # same-label extension must come through a blank unless the
                # previous frame was confidently blank
                alt = lp_t[k_last] + lm_row[k_last] + (
                    pr_b if not prev_blank_ge else pr_total
                )
                # find position of k_last among nonblank classes
                pos = k_last - 1 if blank_index == 0 else int(
                    np.searchsorted(nonblank, k_last)
                )
                ext_scores[pos] = alt
            for k, score in zip(nonblank, ext_scores):
                new_y = y + (int(k),)
                e = curr.setdefault(new_y, [LOG_ZERO, LOG_ZERO])
                e[1] = _log_add(e[1], float(score))
        beams = curr

    # final: </s> scoring + length normalisation (BeamSearch.py:130-145)
    scored = sorted(
        beams.items(), key=lambda kv: _log_add(kv[1][0], kv[1][1]), reverse=True
    )[:beam_width]
    finals: List[Tuple[Tuple[int, ...], float]] = []
    for y, (pr_b, pr_nb) in scored:
        total = _log_add(pr_b, pr_nb)
        if lm_table is not None and y:
            total += lm_table[y[-1], sentinel] * lm_alpha
        norm = total / (len(y) if len(y) else 1)
        finals.append((y, norm))
    finals.sort(key=lambda kv: kv[1], reverse=True)
    return finals[0] if finals else ((), LOG_ZERO)


def warn_capacity(n_hit: int, max_len: int) -> None:
    """The ``BeamDevice`` warning when ``n_hit`` hypotheses filled the
    ``max_len`` capacity (JAX ``beam.py:227-232``, ``cli/test.py:225-232``)."""
    if n_hit:
        logging.getLogger(__name__).warning(
            "BeamDevice: %d hypothesis(es) hit the max_len=%d capacity; "
            "longer extensions were dropped — raise beam_max_len",
            n_hit, max_len,
        )


class BeamDecoder:
    """Batch wrapper matching ``BeamDecoder`` (``ctcDecoder.py:168-192``)."""

    def __init__(
        self,
        int2char,
        beam_width: int = 200,
        blank_index: int = 0,
        space_idx: int = -1,
        lm_path: Optional[str] = None,
        lm_alpha: float = 0.01,
    ):
        self.scorer = Scorer(int2char, space_idx, blank_index)
        self.beam_width = beam_width
        self.blank_index = blank_index
        self.lm_alpha = lm_alpha
        self.int2char = int2char
        self.lm_table = None  # (V+1, V+1) float32 numpy
        self._lm_on: Dict[torch.device, torch.Tensor] = {}
        if lm_path:
            lm = LanguageModel(lm_path)
            num_class = len(int2char)
            self.lm_table = lm.dense_table(int2char, num_class)

    def lm_on(self, device: torch.device) -> Optional[torch.Tensor]:
        """The LM table as a float32 tensor on ``device``, copied there once
        (``beam.py:218-219``); None without an LM."""
        if self.lm_table is None:
            return None
        if device not in self._lm_on:
            self._lm_on[device] = torch.as_tensor(
                self.lm_table, dtype=torch.float32).to(device)
        return self._lm_on[device]

    def string(self, tokens, n: int) -> str:
        """The first ``n`` of ``tokens`` as units joined with no leading
        space (the reference's beam strings)."""
        return " ".join(self.int2char[int(l)] for l in tokens[: int(n)])

    def decode(self, log_probs, frame_seq_len=None, use_native: bool = True
               ) -> List[str]:
        """(T, B, C) log-probs (a tensor on any device, or numpy) ->
        decoded strings ('unit unit ...').  One host copy of the batch,
        ``exp`` in float32, then per utterance the C++ search (``native/``,
        built at first use; a failed build raises) or, with
        ``use_native=False``, the numpy ``ctc_beam_search``."""
        if isinstance(log_probs, torch.Tensor):
            log_probs = log_probs.detach().to(torch.float32).cpu().numpy()
        probs = np.exp(np.asarray(log_probs, np.float32))
        t_max, b, _ = probs.shape
        if frame_seq_len is None:
            frame_seq_len = [t_max] * b
        elif isinstance(frame_seq_len, torch.Tensor):
            frame_seq_len = frame_seq_len.cpu().numpy()
        search = native.ctc_beam_search_native if use_native else ctc_beam_search
        out = []
        for i in range(b):
            y, _ = search(
                probs[:, i], self.beam_width, self.lm_table, self.lm_alpha,
                self.blank_index, int(frame_seq_len[i]),
            )
            out.append(self.string(y, len(y)))
        return out

    def decode_on_device(self, log_probs: torch.Tensor,
                         frame_seq_len: torch.Tensor,
                         max_len: int = 96, mesh=None) -> List[str]:
        """Whole-batch decode on ``log_probs``' device
        (``decode/beam_device.py``), or split over the devices of ``mesh``
        (``batched_beam_search_sharded``).

        ``max_len`` is the fixed hypothesis capacity; when any decoded
        hypothesis fills it, longer candidates may have been truncated and
        a warning is emitted — raise ``beam_max_len`` in the config."""
        probs = torch.exp(log_probs).transpose(0, 1)
        kw = dict(beam_width=self.beam_width, max_len=max_len,
                  blank=self.blank_index, lm_table=self.lm_on(probs.device),
                  lm_alpha=self.lm_alpha)
        lengths = torch.as_tensor(frame_seq_len).to(probs.device)
        if mesh is None:
            seqs, lens, _ = batched_beam_search(probs, lengths, **kw)
        else:
            seqs, lens, _ = batched_beam_search_sharded(probs, lengths, mesh,
                                                        **kw)
        seqs, lens = seqs.cpu().numpy(), lens.cpu().numpy()
        warn_capacity(int((lens >= max_len).sum()), max_len)
        return [self.string(seqs[i], lens[i]) for i in range(len(lens))]
