"""Spans of the benchmark's own and the reduction of a ``torch.profiler``
trace to what the per-layer metrics read.

The window and the host's phases in it are ``record_function`` spans named
``gpubench.<name>``, so they lie on the profiler's clock beside the device's
kernels.  The device is busy where a kernel, a copy or a set runs
(``device_activity``): profiler annotations drawn on the device's timeline
are left out, since they span the kernels they enclose.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

PREFIX = "gpubench."
WINDOW = "window"


def device_activity(ev) -> bool:
    """Whether a ``torch.profiler`` event is work on the card (a kernel, a
    copy or a set): not a step marker, and not a user annotation that the
    profiler draws on the device's timeline (``Optimizer.step#Adam.step``,
    ``nccl:all_reduce``), which spans the kernels it encloses."""
    from torch.autograd import DeviceType

    return (ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith(("ProfilerStep", "Optimizer.",
                                        "nccl:", PREFIX)))


class Spans:
    """Host spans: seconds by name, and ``record_function`` marks while a
    profiler runs (``traced``)."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, float] = {}

    def begin(self, name: str):
        mark = None
        if self.traced:
            import torch

            mark = torch.profiler.record_function(PREFIX + name)
            mark.__enter__()
        return name, mark, time.perf_counter()

    def end(self, token) -> None:
        name, mark, t0 = token
        self.seconds[name] = self.seconds.get(name, 0.0) + (
            time.perf_counter() - t0)
        if mark is not None:
            mark.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        token = self.begin(name)
        try:
            yield
        finally:
            self.end(token)


@dataclasses.dataclass
class Trace:
    """A traced window: its length, the device's busy seconds in it (the
    union of its activity), device seconds by kernel name, and the idle
    gaps, each labelled with the host span that held its middle."""

    window_s: float
    busy_s: float
    by_name: Dict[str, float]
    gaps: List[Tuple[str, float]]


def summarize(events) -> Trace:
    """Reduce ``profile.events()`` to a ``Trace`` over the ``gpubench.
    window`` span; raises if the trace holds no such span or no device
    activity in it."""
    from torch.autograd import DeviceType

    window: Optional[Tuple[float, float]] = None
    spans: List[Tuple[str, float, float]] = []
    acts: List[Tuple[float, float, str]] = []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == DeviceType.CPU and ev.name.startswith(PREFIX):
            name = ev.name[len(PREFIX):]
            if name == WINDOW:
                window = (tr.start, tr.end)
            else:
                spans.append((name, tr.start, tr.end))
        elif device_activity(ev):
            acts.append((tr.start, tr.end, ev.name))
    if window is None:
        raise RuntimeError("the trace has no gpubench.window span")
    w0, w1 = window
    by_name: Dict[str, float] = {}
    clipped = []
    for s, e, name in acts:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    if not clipped:
        raise RuntimeError("the trace shows no device activity in the window")
    clipped.sort()
    busy, gaps, cur_s, cur_e = 0.0, [], None, w0
    for s, e in clipped:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))

    def label(a: float, b: float) -> str:
        mid = (a + b) / 2
        inside = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        return min(inside)[1] if inside else "other"

    return Trace((w1 - w0) / 1e6, busy / 1e6, by_name,
                 [(label(a, b), (b - a) / 1e6) for a, b in gaps])


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    with what the host was doing, ``top`` of each."""
    ops = sorted(trace.by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps, key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
