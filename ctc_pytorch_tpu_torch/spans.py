"""Named ranges of the runners' host phases, on the profiler's clock.

``span(name, args)`` opens a ``torch.profiler.record_function`` range named
``"ctc." + name`` while a ``torch.profiler`` runs: the range lies on the
profiler's clock beside the card's kernels, copies and sets, and the
profiler keeps it and writes it out with the rest of its trace (the
Chrome trace of ``profile: True``).  Otherwise it returns one shared null
context after a single check of the profiler's Python flag: no allocation
and no call into C++.  A span records no counter of its own: a window's
count of a span is its number of ranges.

The ranges, each opened and closed on the calling thread:

- ``ctc.loader.plan``: the host work that makes one group of
  ``DeviceCachedLoader.epoch_groups`` (the epoch's plan with the first);
- ``ctc.runner.upload``: a group's ``pos`` and ``mask`` copies to the card;
- ``ctc.runner.step``: one batch of a fused runner (the static-buffer
  copies, the replay, the output copy, the step count), outside the
  captured step, since a range inside a capture is not replayed;
- ``ctc.graphs.replay``: ``graph.replay()`` and its launch counts;
- ``ctc.graphs.capture``: a step shape's warm-up and capture;
- ``ctc.runner.fetch``: the fetch of an epoch's or a group's losses and
  counts.

``upload`` and ``step`` carry the group's ``(t_pad, B, n)`` as the range's
``args``.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler

PREFIX = "ctc."
_NULL = contextlib.nullcontext()


def span(name: str, args=None):
    """A ``record_function("ctc." + name)`` range while a profiler runs,
    with ``str(args)`` as its ``args``; else the shared null context."""
    if not profiler._is_profiler_enabled:
        return _NULL
    return profiler.record_function(PREFIX + name,
                                    None if args is None else str(args))
