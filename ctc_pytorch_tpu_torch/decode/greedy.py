"""Greedy (best-path) CTC decoding, batched on the tensor's device.

Counterpart of ``ctc_pytorch_tpu/decode/greedy.py:20-94``: per-frame
argmax, collapse repeats, drop blanks.  keep[t] = idx[t] != blank and
idx[t] != idx[t-1] and t < length, the rule of the reference's
``_process_string(remove_rep=True)``; only the string conversion runs on
the host.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ctc_pytorch_tpu_torch.decode.metrics import Scorer
from ctc_pytorch_tpu_torch.ops.editdistance import padded_edit_distance


def greedy_indices(log_probs: torch.Tensor) -> torch.Tensor:
    """(T, B, C) -> (B, T) argmax indices."""
    return torch.argmax(log_probs, dim=-1).T


def greedy_collapse(indices: torch.Tensor, lengths: torch.Tensor,
                    blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) indices -> (B, T) left-packed tokens (padded with ``blank``)
    and (B,) output lengths."""
    b, t = indices.shape
    prev = torch.cat([torch.full_like(indices[:, :1], -1), indices[:, :-1]], 1)
    valid = (torch.arange(t, device=indices.device)[None, :]
             < lengths.to(indices.device)[:, None])
    keep = (indices != blank) & (indices != prev) & valid
    # left-pack kept tokens: destination = running count of kept tokens - 1;
    # discarded tokens all go to the last slot, which is masked below
    # unless every token was kept
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t - 1)
    out_len = keep.sum(dim=1)
    out = torch.full_like(indices, blank)
    out.scatter_(1, dest, torch.where(keep, indices, blank))
    pos = torch.arange(t, device=indices.device)[None, :]
    return torch.where(pos < out_len[:, None], out, blank), out_len


class GreedyDecoder:
    """Greedy decoder producing reference-format strings."""

    def __init__(self, int2char, space_idx: int = -1, blank_index: int = 0):
        self.scorer = Scorer(int2char, space_idx, blank_index)
        self.blank_index = blank_index

    def decode(self, log_probs: torch.Tensor,
               frame_seq_len: torch.Tensor) -> List[str]:
        """(T, B, C) log-probs + (B,) lengths -> list of decoded strings."""
        tokens, lens = greedy_collapse(
            greedy_indices(log_probs), frame_seq_len, self.blank_index)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        return [
            self.scorer.to_string(tokens[i], int(lens[i]))
            for i in range(tokens.shape[0])
        ]

    def batch_errors(self, log_probs: torch.Tensor,
                     frame_seq_len: torch.Tensor, targets,
                     target_sizes) -> Tuple[int, int]:
        """Training-loop token error count (``compute_wer`` semantics):
        ``(edit-distance sum, target-token sum)`` of the greedy hypotheses
        against padded ``targets`` (B, L), the distances by the host's
        native edit distance.  Hypotheses of zero capacity (T' = 0) are all
        deletions."""
        tokens, lens = greedy_collapse(
            greedy_indices(log_probs), frame_seq_len, self.blank_index)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        targets = np.asarray(targets)
        tsizes = np.asarray(target_sizes, np.int64)
        if tokens.shape[1] == 0:  # zero-capacity hyps: all deletions
            dists = tsizes
        else:
            dists = padded_edit_distance(targets, tsizes, tokens, lens)
        return int(np.sum(dists)), int(np.sum(tsizes))
