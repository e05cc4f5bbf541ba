"""The numbers that decide ``correct``; each cell compares those that its
``limits/<cell>.json`` names, each with its limit.

Training (the first three steps of the run's one training object, against
the reference's three steps from the same weights on the same rows):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_norm_gap``: the first gradient as the optimizer takes it (clipped,
  with the decay term), by the worst leaf: the gap between the two norms of
  a leaf over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``step_norm_gap``: the worst leaf's gap of the weights' change over the
  three steps;
- ``grad_error``: the norm of the difference of the two first gradients
  over the reference's norm, all leaves together.  A gap of norms hides
  errors that are independent from entry to entry (they move a norm of N
  entries by about 1/sqrt(N) of their size), so rounding one precision
  lower hardly moves the norm gaps; the difference shows it.

Leaves whose raw gradient in the reference is under a thousandth of the
median leaf's are left out of the leaf numbers: a conv bias under BN has a
gradient of rounding alone, and Adam moves it by its sign.

Decoding: ``align_gap_nats``, the widest gap by which a decoded hypothesis
lies below the reference's best path (``reference/decode.py``), over the
utterances of one pass drawn from the seed; ``passes_differing``, the passes
of the window whose tokens differ from that pass's.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Sequence

import torch

EXCLUDE_BELOW = 1e-3


def worst(values: Iterable[float]) -> float:
    """The largest of ``values``; infinite if one is not a number."""
    values = list(values)
    return math.inf if any(math.isnan(v) for v in values) else max(values)


def kept_leaves(raw_ref: Dict[str, float]) -> list:
    med = statistics.median(raw_ref.values())
    return [n for n, v in raw_ref.items() if v >= EXCLUDE_BELOW * med]


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Sequence[str]) -> float:
    med = statistics.median(ref[n] for n in keep)
    return worst(abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep)


def diff_norms(prog: dict, ref: dict) -> Dict[str, float]:
    """The norm of the difference of the two first gradients, by leaf."""
    return {n: float(torch.linalg.vector_norm(
        prog["grads"][n].double() - ref["grads"][n].double()))
        for n in ref["grads"]}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (three floats), ``grad_norms`` and
    ``step_norms`` by leaf, and ``grads`` (the first gradient by leaf, on
    the host); ``ref`` also ``raw_grad_norms``."""
    keep = kept_leaves(ref["raw_grad_norms"])
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    diff = diff_norms(prog, ref)
    return {
        "loss_gap": worst(gaps),
        "grad_norm_gap": worst_leaf_gap(prog["grad_norms"], ref["grad_norms"],
                                        keep),
        "step_norm_gap": worst_leaf_gap(prog["step_norms"], ref["step_norms"],
                                        keep),
        "grad_error": math.sqrt(sum(diff[n] ** 2 for n in keep)
                                / sum(ref["grad_norms"][n] ** 2
                                      for n in keep)),
    }


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: (value, limit)}`` of the numbers ``limits`` names."""
    return {k: (float(numbers[k]), float(lim)) for k, lim in limits.items()}
