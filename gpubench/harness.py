"""One run of one cell: the kind's runner, then the per-layer readers, then
the result line.

A kind's runner (``kinds/<kind>.py``) has ``run(job) -> Outcome``: it sets
the program up, measures the window (or, with ``trace``, a traced window),
reads the memory peak, frees the program and has the reference judge what
the timed path produced.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

from gpubench import registry
from gpubench.readers import LayerContext
from gpubench.trace import breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "ctc_pytorch_tpu")


@dataclasses.dataclass
class Job:
    cell: str
    config: dict  # the configuration file's recipe (``config``)
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # perf_counter() at process start
    limits: Dict[str, float]
    kernel_tables: Dict[str, List[str]]


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]  # empty in a traced run
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]  # name -> (value, limit)
    memory_peak_bytes: int
    layers: Optional[LayerContext] = None  # a traced run's window
    # set-up phases, window and reference seconds, for standard error
    seconds: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def make_job(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float) -> Tuple[Job, dict]:
    cell = registry.cell(bench, cell_name)
    conf = registry.config(cell["config_entry"])
    mix = registry.traffic(cell["traffic"])
    job = Job(cell_name, conf["config"], mix, int(seed), float(seconds),
              bool(trace), device, t_start, registry.limits(cell_name),
              registry.kernel_tables())
    return job, cell


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result_line(bench: dict, cell_name: str, outcome: Outcome,
                device: dict) -> dict:
    """The run's result: the cell's end-to-end metrics (untraced) or its
    per-layer metrics (traced), with the numbers compared last."""
    metrics = {}
    if outcome.layers is None:
        for m in registry.metrics_for(bench, cell_name, "end_to_end"):
            if m["name"] not in outcome.end_to_end:
                raise RuntimeError(f"the cell's runner did not measure "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in registry.metrics_for(bench, cell_name, "per_layer"):
            value = registry.metric_reader(m["name"]).read(outcome.layers)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if outcome.layers is not None:
        line["device"] = {**device, "busy_s": outcome.layers.trace.busy_s,
                          "window_s": outcome.layers.trace.window_s}
        line["breakdown"] = breakdown(outcome.layers.trace)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return line
