"""Training metrics: JSONL + CSV writers (copy of ``MetricsLogger`` from
``ctc_pytorch_tpu/train/metrics_log.py``) and the optional profiler trace.

Replaces the visdom server dependency (``timit/steps/train_ctc.py:148-158,
232-238``) with durable local artifacts: every epoch appends one JSONL record
and one CSV row (train loss, dev loss, dev acc, lr, time), which any plotting
tool can consume.  ``profile_ctx`` wraps a block in a ``torch.profiler``
trace when enabled by config (the JAX package's wraps it in a
``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import csv
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, out_dir: str | Path, name: str = "train_metrics"):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = self.dir / f"{name}.jsonl"
        self.csv = self.dir / f"{name}.csv"
        self._csv_fields: Optional[list] = None
        self.start = time.time()

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("wall_minutes", (time.time() - self.start) / 60.0)
        with open(self.jsonl, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._csv_fields is None:
            write_header = True
            if self.csv.exists():
                # resuming into an existing CSV: rows must align under ITS
                # header.  Same schema -> append; different schema -> rotate
                # the old file aside and start fresh (appending rows in a
                # new column order under an old header silently corrupts
                # every downstream read).
                with open(self.csv, newline="") as f:
                    existing = next(csv.reader(f), None)
                if existing == list(record.keys()):
                    self._csv_fields = existing
                    write_header = False
                elif existing:
                    n = 1
                    while (rot := self.csv.with_suffix(f".{n}.csv")).exists():
                        n += 1
                    self.csv.rename(rot)
            if self._csv_fields is None:
                self._csv_fields = list(record.keys())
            with open(self.csv, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_fields,
                                   extrasaction="ignore")
                if write_header:
                    w.writeheader()
                w.writerow(record)
        else:
            with open(self.csv, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_fields,
                                   extrasaction="ignore")
                w.writerow(record)


@contextlib.contextmanager
def profile_ctx(enabled: bool, out_dir: str | Path, cuda: bool = False):
    """A ``torch.profiler`` trace of the with-block when ``enabled``: host
    ops, and with ``cuda`` the card's kernels (CUPTI), written at the end of
    the block into ``out_dir`` by ``tensorboard_trace_handler`` as a
    ``*.pt.trace.json`` (Chrome trace format, which TensorBoard's profiler
    plugin and Perfetto read)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(out_dir))):
        yield
