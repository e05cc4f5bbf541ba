"""The work of the benchmarked models, computed from shapes alone.

- ``utterance_flops``: model FLOPs of one utterance at its true length: the
  convolutions, the recurrent layers' input projections and recurrent
  products, and the output Linear, at 2 FLOPs a multiply-add; three times
  the forward for a training step (forward and backward), nothing for
  recomputation.
- ``recurrence_call``: the least work of one recurrence call (a layer's
  both directions) at a padded shape: its products and each plane it needs
  moved once; ``recurrence_least_seconds`` sums it over a window's calls.
- ``stream_dtype``: the dtype of a layer's gate and output planes, by the
  recipes' rule: bf16 where the compute dtype is bf16 and B % 16 == 0,
  else fp32.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from gpubench import peaks
from gpubench.reference.model import Arch


def stream_dtype(compute_dtype: str, batch: int) -> str:
    return ("bfloat16" if compute_dtype == "bfloat16" and batch % 16 == 0
            else "float32")


def utterance_flops(arch: Arch, frames: int, train: bool) -> float:
    """FLOPs of one utterance of ``frames`` input frames."""
    t, f = frames, arch.in_dim
    flops = 0.0
    for cin, cout, k, s, p in arch.convs:
        t = (t + 2 * p[0] - k[0]) // s[0] + 1
        f = (f + 2 * p[1] - k[1]) // s[1] + 1
        flops += 2.0 * cin * k[0] * k[1] * cout * t * f
    h, nh, nd = arch.hidden, arch.gates * arch.hidden, arch.ndir
    for i in range(arch.layers):
        fin = arch.rnn_in if i == 0 else nd * h
        flops += 2.0 * t * fin * nd * nh + 2.0 * nd * t * h * nh
    flops += 2.0 * t * nd * h * arch.n_class
    return flops * (3 if train else 1)


def recurrence_call(arch: Arch, t: int, b: int, dtype: str,
                    backward: bool) -> Tuple[float, float]:
    """``(flops, bytes)`` of one recurrence call over ``t`` padded frames
    and ``b`` rows with planes in ``dtype``.  Forward: the recurrent
    product of every step, ``gx`` and ``w_hh`` read and ``ys`` written.
    Backward: the product of the gradient chain of every step; ``dy``,
    ``ys``, ``gx`` and ``w_hh`` read and ``dgx`` written."""
    es = 2 if dtype == "bfloat16" else 4
    h, nh, nd = arch.hidden, arch.gates * arch.hidden, arch.ndir
    flops = 2.0 * nd * t * b * h * nh
    weights = nd * h * nh * es
    if backward:
        planes = t * b * nd * (2 * h + 2 * nh) * es
    else:
        planes = t * b * nd * (nh + h) * es
    return flops, float(planes + weights)


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time for ``flops`` products on ``dtype`` operands and
    ``nbytes`` moved: the larger of the two bounds."""
    return max(flops / peaks.product_peak(dtype),
               nbytes / peaks.HBM_BYTES_PER_S)


def recurrence_least_seconds(arch: Arch, compute_dtype: str,
                             groups: Iterable[Tuple[int, int, int]],
                             calls_fwd: int, calls_bwd: int) -> float:
    """The least time of a window's recurrence work: ``groups`` are its
    ``(padded input frames, B, batches)`` and ``calls_fwd`` / ``calls_bwd``
    the recurrence calls it launched (every batch the same number)."""
    groups = list(groups)
    n_batches = sum(n for _, _, n in groups)
    if n_batches == 0:
        return 0.0
    per_f, rem_f = divmod(calls_fwd, n_batches)
    per_b, rem_b = divmod(calls_bwd, n_batches)
    if rem_f or rem_b:
        raise ValueError(f"{calls_fwd} forward and {calls_bwd} backward "
                         f"recurrence calls over {n_batches} batches")
    total = 0.0
    for t_pad, b, n in groups:
        t = int(arch.out_time(t_pad))
        dtype = stream_dtype(compute_dtype, b)
        for per, backward in ((per_f, False), (per_b, True)):
            if per:
                total += n * per * least_seconds(
                    *recurrence_call(arch, t, b, dtype, backward), dtype)
    return total

