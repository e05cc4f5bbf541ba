"""The program's own spans in a traced window: the port's ``ctc.*`` ranges
(``ctc_pytorch_tpu_torch/spans.py``) reduced to what per-layer metrics of
the epoch runner and the device data layer would read.

It reads the events that ``trace.summarize`` reads and takes the card's
activity by ``trace.device_activity``, within the ``gpubench.window``
span: the host seconds of each ``ctc.*`` name; the self seconds of
``ctc.runner.step`` (its length less what its child ``ctc.*`` ranges
cover); the card's idle seconds under the innermost ``ctc.*`` range at each
idle instant, with the idle under none kept apart (``NONE``), so that the
parts add up to the window's idle time; and the count of each name's
ranges.  A program without the spans (no ``ctc.*`` range in the window)
gives None.  A window whose ``ctc.runner.step`` count differs from the
runner's steps, or that holds a ``ctc.graphs.capture``, fails by name.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from gpubench.trace import PREFIX as BENCH_PREFIX
from gpubench.trace import WINDOW, device_activity

PREFIX = "ctc."
STEP = "ctc.runner.step"
CAPTURE = "ctc.graphs.capture"
PLAN = ("ctc.loader.plan",)
RUNNER = ("ctc.runner.", "ctc.graphs.")
NONE = "none"  # idle under no program span


@dataclasses.dataclass
class ProgramSpans:
    window_s: float
    seconds: Dict[str, float]  # host seconds of each ctc.* name
    counts: Dict[str, int]  # ranges of each name
    step_self_s: float  # ctc.runner.step less its child ranges
    idle_s: Dict[str, float]  # idle under the innermost name, or NONE

    def idle_share(self, prefixes) -> float:
        """Percent of the window in which the card idles while the
        innermost ``ctc.*`` range's name starts with one of ``prefixes``."""
        return 100.0 * sum(s for n, s in self.idle_s.items()
                           if n.startswith(tuple(prefixes))) / self.window_s

    def per_step_ms(self, seconds: float) -> float:
        return 1e3 * seconds / self.counts[STEP]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(ranges, w0: float, w1: float):
    """``(start, end, name)`` pieces that tile the window, each named by
    the latest-starting (the innermost) range over it, or ``NONE``."""
    edges = sorted({w0, w1, *(s for _, s, _ in ranges),
                    *(e for _, _, e in ranges)})
    by_start = sorted(ranges, key=lambda r: (r[1], -r[2]))
    active, k, out = [], 0, []
    for a, b in zip(edges, edges[1:]):
        while k < len(by_start) and by_start[k][1] <= a:
            active.append(by_start[k])
            k += 1
        active = [r for r in active if r[2] > a]
        out.append((a, b, active[-1][0] if active else NONE))
    return out


def reduce(events, steps: int) -> Optional[ProgramSpans]:
    """The window's program spans, or None where the program has none."""
    from torch.autograd import DeviceType

    window = None
    ranges, acts = [], []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == DeviceType.CPU:
            if ev.name == BENCH_PREFIX + WINDOW:
                window = (tr.start, tr.end)
            elif ev.name.startswith(PREFIX):
                ranges.append((ev.name, tr.start, tr.end))
        elif device_activity(ev):
            acts.append((tr.start, tr.end))
    if window is None:
        raise RuntimeError("the trace has no gpubench.window span")
    w0, w1 = window
    ranges = [(n, max(s, w0), min(e, w1)) for n, s, e in ranges
              if w0 <= s < w1]
    if not ranges:
        return None
    counts: Dict[str, int] = {}
    seconds: Dict[str, float] = {}
    for n, s, e in ranges:
        counts[n] = counts.get(n, 0) + 1
        seconds[n] = seconds.get(n, 0.0) + (e - s) / 1e6
    if counts.get(STEP, 0) != steps:
        raise RuntimeError(f"{STEP}: {counts.get(STEP, 0)} ranges in the "
                           f"window against the runner's {steps} steps")
    if counts.get(CAPTURE, 0):
        raise RuntimeError(f"{CAPTURE}: {counts[CAPTURE]} captures in the "
                           "window")

    busy = _union([(max(s, w0), min(e, w1)) for s, e in acts
                   if min(e, w1) > max(s, w0)])
    edges = [w0] + [x for b in busy for x in b] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle: Dict[str, float] = {NONE: 0.0}
    pieces = _innermost(ranges, w0, w1)
    i = j = 0
    while i < len(gaps) and j < len(pieces):
        (ga, gb), (pa, pb, name) = gaps[i], pieces[j]
        if min(gb, pb) > max(ga, pa):
            idle[name] = idle.get(name, 0.0) + (min(gb, pb) - max(ga, pa))
        if gb <= pb:
            i += 1
        else:
            j += 1

    starts = sorted((s, e, k) for k, (_, s, e) in enumerate(ranges))
    first = [s for s, _, _ in starts]
    self_us = 0.0
    for k, (n, s, e) in enumerate(ranges):
        if n != STEP:
            continue
        lo, hi = bisect.bisect_left(first, s), bisect.bisect_right(first, e)
        kids = [(a, b) for a, b, j in starts[lo:hi] if b <= e and j != k]
        self_us += (e - s) - sum(b - a for a, b in _union(kids))
    return ProgramSpans((w1 - w0) / 1e6, seconds, counts, self_us / 1e6,
                        {k: v / 1e6 for k, v in idle.items()})
