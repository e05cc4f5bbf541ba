"""The control: the plain reference put in the program's place, its
products rounded to float8 (e4m3), one precision below the configurations'
bf16, has to come out not correct under each cell's limits.  On the card it
was read at the cells' own sizes (``gpubench/calibrate.py``); here at a size
the CPU holds, on three seeds."""

import pytest

from gpubench import judge, registry
from gpubench.calibrate import control_pass
from gpubench.tests.cells import DECODE, TRAIN, small_job

SEEDS = (31, 32, 33)


def failed(numbers: dict, limits: dict) -> list:
    return [k for k, (v, lim) in judge.checks(numbers, limits).items()
            if not v <= lim]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", TRAIN)
def test_fp8_training_is_not_correct(cell, seed):
    job = small_job(cell, seed)
    kind = registry.kind("train")
    prog = kind.Program(job)
    args = (prog.check, prog.corpus, prog.arch, prog.weights,
            prog.host.batcher.label_pad, "cpu")
    ref = kind.reference_readings(*args)
    control = kind.reference_readings(*args, quant="fp8")
    assert failed(judge.train_numbers(control, ref), job.limits)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", DECODE)
def test_fp8_decoding_is_not_correct(cell, seed):
    job = small_job(cell, seed)
    kind = registry.kind("decode")
    prog = kind.Program(job)
    args = (prog.groups, prog.corpus, prog.host.batcher.label_pad, prog.arch,
            prog.weights, "cpu")
    gap = kind.align_gap([control_pass(*args, quant="fp8")], 0, *args)
    assert failed({"align_gap_nats": gap, "passes_differing": 0},
                  job.limits)
