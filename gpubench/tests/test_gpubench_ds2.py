"""The DeepSpeech2 cell's kind (``kinds/train_ds2.py``) on the CPU at a
small size, its work arithmetic against ``work.py``'s and the reader of
``recurrence_step_us.train``."""

import copy
import dataclasses
import time

from gpubench import harness, registry, work
from gpubench.reference import ds2, model
from gpubench.trace import Trace

BENCH = registry.load_benchmark()
CELL = "ds2_librispeech-train_b64"


def small_job(seed: int = 2**31 + 25) -> harness.Job:
    """The cell with 2 layers of 16 units in float32, 24 utterances of
    24-60 frames in batches of 4 (the published 161 bins and kernels)."""
    job, _ = harness.make_job(BENCH, CELL, seed, 0.2, False, "cpu",
                              time.perf_counter())
    job.config = {**job.config, "rnn_hidden_size": 16, "rnn_layers": 2,
                  "dtype": "float32"}
    job.mix = copy.deepcopy(job.mix)
    job.mix.update(utterances=24, batch_size=4)
    job.mix["frames"] = {"dist": "uniform", "min": 24, "max": 60}
    return job


def test_a_small_run_is_correct_and_reports_its_metrics():
    job = small_job()
    out = registry.kind(job.mix["kind"]).run(job)
    assert out.correct and out.failed == 0 and out.attempted > 0
    assert set(out.end_to_end) == {"train_utt_per_s", "setup_s"}
    assert out.checks["grad_error"][0] < 1e-4


def test_the_flops_are_work_py_s_where_the_models_agree():
    kind = registry.kind("train_ds2")
    conf = registry.config(registry.cell(BENCH, CELL)["config_entry"])
    plain = {**conf["config"], "rnn_merge": "concat", "rnn_bias": False}
    arch = ds2.Arch.from_config(plain)
    base = model.Arch.from_config(plain)
    assert kind.utterance_flops(arch, 800, True) == work.utterance_flops(
        base, 800, True)
    ds = ds2.Arch.from_config(conf["config"])
    t, h = ds.out_time(800), ds.hidden
    # summed directions: layers 2-5 and the Linear take H, not 2H
    fewer = (ds.layers - 1) * 2.0 * t * h * 2 * 4 * h + 2.0 * t * h * 29
    adds = ds.layers * (t * 2 * 4 * h + t * h)
    assert kind.utterance_flops(ds, 800, False) == \
        work.utterance_flops(base, 800, False) - fewer + adds


def test_the_step_reader_reads_the_windows_steps():
    kind = registry.kind("train_ds2")
    reader = registry.metric_reader("recurrence_step_us.train")
    trace = Trace(1.0, 0.9, {"fwd_mma_kernel<x>": 0.3,
                             "lstm_bidir_bwd_kernel": 0.2, "other": 0.4}, [])
    ctx = kind.DS2LayerContext(trace, 2, 1.0, 1.0, 0.0, {},
                               registry.kernel_tables(), recurrence_steps=5000)
    assert abs(reader.read(ctx) - 100.0) < 1e-9
    plain = kind.LayerContext(**{f.name: getattr(ctx, f.name) for f in
                                 dataclasses.fields(kind.LayerContext)})
    assert reader.read(plain) is None
    before = {("a", "launches_steps"): {"fwd": 1, "bwd": 2},
              ("a", "launches"): 3}
    after = {("a", "launches_steps"): {"fwd": 11, "bwd": 22},
             ("a", "launches"): 4}
    assert kind.recurrence_steps(before, after) == 30
    assert kind.recurrence_steps({("a", "launches"): 3},
                                 {("a", "launches"): 4}) is None


def test_the_program_only_calibration_reads_what_the_whole_set_up_reads():
    """``calibrate_ds2.py --program-only`` sets the program up only as far as
    its check steps, and reads the same numbers of the program against the
    reference as the whole set-up, with no control and no fault."""
    from gpubench import calibrate_ds2

    lean = calibrate_ds2.readings(small_job(), program_only=True)
    whole = calibrate_ds2.readings(small_job())
    assert lean["program"] == whole["program"]
    assert lean["raw"]["program"]["losses"] == \
        whole["raw"]["program"]["losses"]
    assert "fp8" not in lean and whole["fp8"]["grad_error"] > 0
