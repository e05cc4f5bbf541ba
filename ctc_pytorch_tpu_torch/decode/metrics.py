"""Error-rate scoring with the reference's exact metric definitions (copy of
``ctc_pytorch_tpu/decode/metrics.py``: ``Scorer`` and ``phone_word_error``).

Reproduces ``Decoder`` (``timit/utils/ctcDecoder.py:9-149``):

- hypotheses/references become *strings*; with ``space_idx=-1`` units are
  joined by spaces, so the reported "WER" over spaces equals the phone error
  rate, and "CER" counts characters **including the separator spaces** —
  quirky, but preserved bit-for-bit so numbers are comparable;
- ``num_word``/``num_char`` running normalisers accumulate over calls;
- edit distance uses unit insert/delete/substitute costs
  (``ctcDecoder.py:131-149``), via the vectorised DP in ops/editdistance.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ctc_pytorch_tpu_torch.ops.editdistance import edit_distance


class Scorer:
    def __init__(self, int2char: Dict[int, str] | Sequence[str],
                 space_idx: int = -1, blank_index: int = 0):
        self.int_to_char = int2char
        self.space_idx = space_idx
        self.blank_index = blank_index
        self.num_word = 0
        self.num_char = 0

    # -- string construction (ctcDecoder.py:80-116) ----------------------
    def _process_string(self, seq: Sequence[str], remove_rep: bool = False) -> str:
        string = ""
        for i, char in enumerate(seq):
            if char != self.int_to_char[self.blank_index]:
                if remove_rep and i != 0 and char == seq[i - 1]:
                    pass
                elif self.space_idx == -1:
                    string = string + " " + char
                elif char == self.int_to_char[self.space_idx]:
                    string += " "
                else:
                    string = string + char
        return string

    def to_string(self, ids: Sequence[int], size: int | None = None,
                  remove_rep: bool = False) -> str:
        seq = [self.int_to_char[int(i)] for i in
               (ids[:size] if size is not None else ids)]
        return self._process_string(seq, remove_rep)

    # -- error rates (ctcDecoder.py:118-129) -----------------------------
    def wer(self, s1: str, s2: str) -> int:
        """Space-separated token edit distance (== PER for phone strings)."""
        vocab = set(s1.split() + s2.split())
        word2int = {w: i for i, w in enumerate(vocab)}
        w1 = [word2int[w] for w in s1.split()]
        w2 = [word2int[w] for w in s2.split()]
        return edit_distance(w1, w2)

    def cer(self, s1: str, s2: str) -> int:
        """Character edit distance over the joined strings (incl. spaces)."""
        return edit_distance(list(s1), list(s2))

    def score_batch(
        self,
        hyp_strings: List[str],
        target_ids: Sequence[Sequence[int]],
        target_sizes: Sequence[int],
    ) -> tuple:
        """Accumulate (cer, wer) over a batch (``phone_word_error`` semantics)."""
        cer = wer = 0
        for hyp, tgt, size in zip(hyp_strings, target_ids, target_sizes):
            ref = self.to_string(list(tgt), int(size))
            cer += self.cer(hyp, ref)
            wer += self.wer(hyp, ref)
            self.num_word += len(ref.split())
            self.num_char += len(ref)
        return cer, wer


def phone_word_error(decoder, log_probs, frame_seq_len, targets,
                     target_sizes) -> tuple:
    """Decode + score in one call, matching ``Decoder.phone_word_error``
    (``timit/utils/ctcDecoder.py:27-49``): returns accumulated (cer, wer);
    running normalisers live on ``decoder.scorer``.

    Targets may be padded (B, L) rows or a flat 1-D array with sizes
    (the 863/warp-ctc convention, unflattened like ``ctcDecoder.py:51-64``);
    a tensor is read on the host.
    """
    if hasattr(targets, "cpu"):
        targets = targets.cpu()
    targets = np.asarray(targets)
    sizes = [int(s) for s in target_sizes]
    if targets.ndim == 1:
        rows, off = [], 0
        for s in sizes:
            rows.append(targets[off: off + s])
            off += s
    else:
        rows = [targets[i][: sizes[i]] for i in range(len(sizes))]
    hyps = decoder.decode(log_probs, frame_seq_len)
    return decoder.scorer.score_batch(hyps, rows, sizes)
