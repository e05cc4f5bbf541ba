"""The command's contract: no result without a card, and the result line's
form."""

import json
import subprocess
import sys
from pathlib import Path

from gpubench import harness, registry
from gpubench.tests.test_gpubench_trace import EVENTS
from gpubench.trace import summarize
from gpubench.readers import LayerContext

ROOT = Path(__file__).resolve().parents[2]
BENCH = registry.load_benchmark()


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "timit_lstm-train_b8", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def outcome(layers=None):
    return harness.Outcome(
        {"train_utt_per_s": 750.0, "setup_s": 24.0}, attempted=2310,
        failed=0, checks={"grad_error": (0.03, 0.09), "loss_gap": (0.2, 0.05)},
        memory_peak_bytes=123, layers=layers)


DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 123}


def test_untraced_line():
    line = harness.result_line(BENCH, "timit_lstm-train_b8", outcome(),
                               DEVICE)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is False  # loss_gap over its limit
    assert set(line["metrics"]) == {"train_utt_per_s", "setup_s"}
    assert line["metrics"]["train_utt_per_s"] == {"value": 750.0,
                                                  "unit": "utt/s"}
    assert line["checks"]["grad_error"] == {"value": 0.03, "limit": 0.09}
    json.dumps(line)


def test_traced_line():
    layers = LayerContext(
        trace=summarize(EVENTS), steps=2, model_flops=1e9, peak_flops=989e12,
        recurrence_least_s=1e-6, spans={"enqueue": 1e-3},
        kernel_tables=registry.kernel_tables())
    line = harness.result_line(BENCH, "timit_lstm-train_b8",
                               outcome(layers), DEVICE)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {
        m["name"] for m in registry.metrics_for(BENCH, "timit_lstm-train_b8",
                                                "per_layer")}
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
    assert len(line["breakdown"]["device_ops"]) <= 10
