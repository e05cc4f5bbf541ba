"""Cells of kind ``train_ds2``: stage 2's fused training epochs of
DeepSpeech2 (``rnn_merge: sum``, ``rnn_bias``: biased LSTM cells, packed,
their directions summed).

``kinds/train.py`` as it is, loaded as a module of this kind's own: its
set-up, first three steps, captures, warm epoch, window and reference
readings, with DeepSpeech2's ``Arch`` (``reference/ds2.py``: its leaves are
the weights the run draws) and the reference's three steps of this model in
place of the plain ones.  What this file adds: the model FLOPs of summed
directions and biases (``utterance_flops``), and a traced window's context
that also carries its serial recurrence steps (``recurrence_steps``), which
``metrics/recurrence_step_us.train.py`` reads; the traced window's layer
calls by route (``ops/rnn_io.py``) go to standard error.  A program without the
summed merge and the biased cells fails at once, before any set-up.
"""

# no ``from __future__ import annotations``: the registry loads this file
# outside ``sys.modules``, where a dataclass cannot resolve string annotations
import dataclasses
import time
from typing import Optional

from gpubench import judge, peaks, program, registry, work
from gpubench.harness import Job, Outcome
from gpubench.readers import LayerContext
from gpubench.reference import ds2
from gpubench.trace import WINDOW, Spans, summarize

base = registry.kind("train")
base.Arch = ds2.Arch
base.train_steps = ds2.train_steps
reference_readings = base.reference_readings


def require_ds2_model() -> None:
    """Raise where the port's ``ModelSpec`` has no ``rnn_merge`` and
    ``rnn_bias`` (a program from before DeepSpeech2)."""
    from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec

    missing = {"rnn_merge", "rnn_bias"} - set(ModelSpec.__dataclass_fields__)
    if missing:
        raise RuntimeError(f"the program's ModelSpec has no {sorted(missing)}: "
                           "it cannot build DeepSpeech2")


class Program(base.Program):
    def __init__(self, job: Job):
        require_ds2_model()
        super().__init__(job)


@dataclasses.dataclass
class DS2LayerContext(LayerContext):
    """``LayerContext`` with the window's serial recurrence steps: T of
    every forward and backward recurrence launch, summed (None where the
    program counts none)."""

    recurrence_steps: Optional[int] = None


def utterance_flops(arch: ds2.Arch, frames: int, train: bool) -> float:
    """``work.utterance_flops`` of DeepSpeech2: every layer after the first
    and the output Linear take ``rnn_out`` (H) features; the biases (one add
    a gate lane and frame) and the directions' sum (one add a unit and
    frame) count one FLOP each; three times the forward for a training
    step."""
    t, f = frames, arch.in_dim
    flops = 0.0
    for cin, cout, k, s, p in arch.convs:
        t = (t + 2 * p[0] - k[0]) // s[0] + 1
        f = (f + 2 * p[1] - k[1]) // s[1] + 1
        flops += 2.0 * cin * k[0] * k[1] * cout * t * f
    h, nh, nd = arch.hidden, arch.gates * arch.hidden, arch.ndir
    for i in range(arch.layers):
        fin = arch.rnn_in if i == 0 else arch.rnn_out
        flops += 2.0 * t * fin * nd * nh + 2.0 * nd * t * h * nh
        flops += float(t * nd * nh) if arch.bias else 0.0
        flops += float(t * h) if arch.merge == "sum" else 0.0
    flops += 2.0 * t * arch.rnn_out * arch.n_class
    return flops * (3 if train else 1)


def recurrence_steps(before, after) -> Optional[int]:
    """Serial steps of the recurrence launches between two readings of the
    port's counters (``launches_steps``); None where it has no such
    counter."""
    keys = [k for k in after if k[1] == "launches_steps"]
    if not keys:
        return None
    return sum(v - before[k][p] for k in keys for p, v in after[k].items())


def run(job: Job) -> Outcome:
    """``kinds/train.py``'s ``run`` with this model's FLOPs and the
    window's serial steps in its traced context."""
    marks = {"start": time.perf_counter() - job.t_start}
    prog = Program(job)
    marks.update(prog.marks)
    spans = Spans(job.trace)
    layers = None
    end_to_end = {}
    if not job.trace:
        setup_s = time.perf_counter() - job.t_start
        t0 = time.perf_counter()
        epochs, steps, bad = prog.run_epochs(
            1, lambda n: n > 0 and time.perf_counter() - t0 >= job.seconds,
            spans)
        wall = marks["window"] = time.perf_counter() - t0
        end_to_end = {"train_utt_per_s": epochs * len(prog.corpus) / wall,
                      "setup_s": setup_s}
    else:
        per_epoch = len(prog.loader)
        want = max(1, -(-int(job.mix["trace_min_steps"]) // per_epoch))
        events: list = []
        before = program.read_launches()
        with program.profiled(events):
            with spans.span(WINDOW):
                epochs, steps, bad = prog.run_epochs(1, lambda n: n >= want,
                                                     spans)
        after = program.read_launches()
        calls = program.recurrence_calls(before, after)
        dtype = prog.cfg.dtype
        layers = DS2LayerContext(
            trace=summarize(events), steps=steps,
            model_flops=epochs * sum(utterance_flops(prog.arch, int(t), True)
                                     for t in prog.corpus.frames),
            peak_flops=peaks.product_peak(dtype),
            recurrence_least_s=work.recurrence_least_seconds(
                prog.arch, dtype, prog.groups_of(range(1, 1 + epochs)),
                *calls),
            spans=dict(spans.seconds), kernel_tables=job.kernel_tables,
            recurrence_steps=recurrence_steps(before, after))
        marks["recurrence_steps"] = layers.recurrence_steps
        # the layer calls by route in the window (ops/rnn_io.py): one each
        # a layer a step
        marks["rnn_io"] = {k[1]: {r: n - before[k][r] for r, n in v.items()
                                  if n != before[k][r]}
                           for k, v in after.items() if k[0] == "rnn_io"}
    t_window_end = time.perf_counter()
    clocks = peaks.card("clocks.sm,clocks.max.sm,temperature.gpu,power.draw")
    peak = program.memory_peak(job.device)
    check, corpus, weights = prog.check, prog.corpus, prog.weights
    epoch_seconds = prog.epoch_seconds
    l_pad, arch = prog.host.batcher.label_pad, prog.arch
    weights = {k: v.detach().cpu() for k, v in weights.items()}
    prog.close()
    del prog
    program.release(job.device)
    ref = reference_readings(check, corpus, arch, weights, l_pad, job.device)
    numbers = judge.train_numbers(check, ref)
    marks.update({f"epoch_{i + 1}": t for i, t in enumerate(epoch_seconds)})
    marks["reference"] = time.perf_counter() - t_window_end
    marks["card after the window"] = clocks
    return Outcome(end_to_end, attempted=steps, failed=bad,
                   checks=judge.checks(numbers, job.limits),
                   memory_peak_bytes=peak, layers=layers, seconds=marks)
