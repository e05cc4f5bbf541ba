"""What the per-layer metric files (``metrics/<name>.py``) read from a traced
window, and the arithmetic they share.  A reader that finds nothing to read
returns None, and the harness leaves its metric out."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

from gpubench.trace import Trace


@dataclasses.dataclass
class LayerContext:
    """A traced window as the readers see it."""

    trace: Trace
    steps: int  # batches (optimizer steps or decoded batches) in the window
    model_flops: float  # FLOPs of the window's real utterances
    peak_flops: float  # the configuration's dtype's published peak
    recurrence_least_s: float  # least time of the window's recurrence work
    spans: Dict[str, float]  # host seconds by span name
    kernel_tables: Dict[str, List[str]]  # layer -> kernel names


def _pattern(names: List[str]):
    return re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")


def layer_seconds(ctx: LayerContext, layer: str) -> float:
    """Device seconds of the kernels that ``layer``'s tables name."""
    pat = _pattern(ctx.kernel_tables.get(layer, []) or ["(?!)"])
    return sum(s for n, s in ctx.trace.by_name.items() if pat.search(n))


def unnamed_seconds(ctx: LayerContext) -> float:
    """Device seconds of the kernels that no table names."""
    names = [n for table in ctx.kernel_tables.values() for n in table]
    pat = _pattern(names) if names else None
    return sum(s for n, s in ctx.trace.by_name.items()
               if pat is None or not pat.search(n))


def idle_share(ctx: LayerContext) -> Optional[float]:
    """Percent of the window in which nothing ran on the device."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx: LayerContext) -> Optional[float]:
    """The window's model FLOPs over its length at the dtype's peak, %."""
    if ctx.model_flops <= 0:
        return None
    return 100.0 * ctx.model_flops / (ctx.trace.window_s * ctx.peak_flops)


def roofline_share(ctx: LayerContext, layer: str, least_s: float,
                   metric: str) -> Optional[float]:
    """The least time of ``layer``'s work over its kernels' device time, %.
    Named kernels that took no time fail the run by name."""
    if least_s <= 0:
        return None
    spent = layer_seconds(ctx, layer)
    if spent <= 0:
        raise RuntimeError(f"{metric}: the kernels that gpubench/kernels/"
                           f"{layer}.*.json names took no device time")
    return 100.0 * least_s / spent


def per_step_ms(seconds: float, ctx: LayerContext) -> Optional[float]:
    return None if ctx.steps <= 0 else 1e3 * seconds / ctx.steps
