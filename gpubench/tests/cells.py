"""The benchmark's cells at a size the CPU holds, for the tests."""

import copy
import time

from gpubench import harness, registry

BENCH = registry.load_benchmark()
TRAIN = [w["name"] for w in BENCH["workloads"]
         if registry.traffic(w["traffic"])["kind"] == "train"]
DECODE = [w["name"] for w in BENCH["workloads"]
          if registry.traffic(w["traffic"])["kind"] == "decode"]


def small_job(cell: str, seed: int = 20260101) -> harness.Job:
    """The cell with 2 layers of 16 units in float32, 24 utterances of 24-60
    frames in batches of 4, under the cell's own limits.  In float32 the
    program's CPU path and the reference differ by the order of sums alone,
    so a sound run is correct whatever the limits that bf16 needs."""
    job, _ = harness.make_job(BENCH, cell, seed, 0.2, False, "cpu",
                              time.perf_counter())
    job.config = {**job.config, "rnn_hidden_size": 16, "rnn_layers": 2,
                  "dtype": "float32"}
    job.mix = copy.deepcopy(job.mix)
    job.mix.update(utterances=24, batch_size=4)
    job.mix["frames"] = {"dist": "uniform", "min": 24, "max": 60}
    return job
