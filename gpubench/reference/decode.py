"""The judge of greedy decodes: how far a hypothesis lies below the
reference's best path.

For an utterance of ``T`` valid frames with reference log-probabilities
``lp (T, C)``, the greedy best path scores ``sum_t max_c lp[t, c]``.  A
hypothesis (a collapsed token sequence) is scored by its best CTC alignment
under ``lp`` (Viterbi over the blank-interleaved labels).  The gap between the
two, in nats, is 0 when the hypothesis is the reference's own greedy decode,
a rounding's worth where a lower precision flipped near-tied frames, and
large where a token is wrong; a hypothesis with no alignment in ``T``
frames has an infinite gap.
"""

from __future__ import annotations

from typing import Sequence

import torch

NEG = -1e300


def alignment_gaps(log_probs: torch.Tensor, sizes: torch.Tensor,
                   hyps: Sequence[Sequence[int]], blank: int = 0
                   ) -> torch.Tensor:
    """``(B,)`` float64 gaps of the hypotheses ``hyps`` (one id sequence a
    row) under ``log_probs (T, B, C)``, each row over its first ``sizes[b]``
    frames."""
    t_len, b, _ = log_probs.shape
    lp = log_probs.detach().to(torch.float64).cpu()
    sizes = sizes.cpu()
    s_max = max(3, 2 * max((len(h) for h in hyps), default=0) + 1)
    ext = torch.full((b, s_max), blank, dtype=torch.int64)
    n_ext = torch.zeros(b, dtype=torch.int64)
    for r, h in enumerate(hyps):
        h = torch.as_tensor(list(h), dtype=torch.int64)
        ext[r, 1:2 * len(h):2] = h
        n_ext[r] = 2 * len(h) + 1
    pos = torch.arange(s_max)
    # a step of two is allowed into a label that differs from the label two
    # positions back
    skip = torch.zeros(b, s_max, dtype=torch.bool)
    skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    emit = lp.gather(2, ext[None].expand(t_len, b, s_max))  # (T, B, S)
    alpha = torch.full((b, s_max), NEG, dtype=torch.float64)
    alpha[:, 0] = emit[0, :, 0]
    alpha[:, 1] = torch.where(n_ext > 1, emit[0, :, 1],
                              torch.full_like(alpha[:, 1], NEG))
    final = torch.full((b,), NEG, dtype=torch.float64)
    for t in range(t_len):
        if t > 0:
            prev1 = torch.cat([torch.full((b, 1), NEG, dtype=torch.float64),
                               alpha[:, :-1]], 1)
            prev2 = torch.cat([torch.full((b, 2), NEG, dtype=torch.float64),
                               alpha[:, :-2]], 1)
            best = torch.maximum(alpha, prev1)
            best = torch.where(skip, torch.maximum(best, prev2), best)
            alpha = torch.where(pos[None] < n_ext[:, None], best + emit[t],
                                torch.full_like(best, NEG))
        ends = sizes == t + 1
        if ends.any():
            last = alpha.gather(1, (n_ext - 1)[:, None])[:, 0]
            before = alpha.gather(1, (n_ext - 2).clamp(min=0)[:, None])[:, 0]
            before = torch.where(n_ext > 1, before, torch.full_like(before, NEG))
            final = torch.where(ends, torch.maximum(last, before), final)
    valid = torch.arange(t_len)[:, None] < sizes[None, :]
    greedy = torch.where(valid, lp.max(dim=2).values,
                         torch.zeros(t_len, b, dtype=torch.float64)).sum(0)
    gap = greedy - final
    return torch.where(final <= NEG / 2, torch.full_like(gap, float("inf")),
                       gap)


def greedy_hypotheses(log_probs: torch.Tensor, sizes: torch.Tensor,
                      blank: int = 0) -> list:
    """The greedy decode of each row: argmax a frame over its valid frames,
    repeats collapsed, blanks dropped."""
    best = log_probs.argmax(dim=2).t().cpu()
    out = []
    for row, n in zip(best, sizes.cpu().tolist()):
        hyp, prev = [], None
        for k in row[:n].tolist():
            if k != blank and k != prev:
                hyp.append(k)
            prev = k
        out.append(hyp)
    return out
