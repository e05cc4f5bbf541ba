"""Cells of kind ``train``: stage 2's fused training epochs.

Set-up builds the one training object as stage 2 does (``Trainer`` of the
recipe's config, its state loaded with the run's weights; the corpus in the
port's ``DeviceCachedLoader``), drives it through its first three steps by
the window's own call (``epoch_train`` of ``make_epoch_fns``) on three
batches of distinct rows at the longest padded length, reading the first gradient from Adam's first
moment after step 1, then captures the other batch shapes with one step
each.  The window runs whole epochs through ``run_epoch_single``, one fetch
an epoch, and ends with the first epoch that ends after ``--seconds``:
``train_utt_per_s`` is the real utterances of its epochs over its length.
Then the reference runs the same three steps from the same weights on the
same rows, and ``judge.train_numbers`` compares.
"""

from __future__ import annotations

import math
import tempfile
import time

import torch

from gpubench import judge, peaks, program, traffic, work
from gpubench.harness import Job, Outcome
from gpubench.readers import LayerContext
from gpubench.reference.model import Arch
from gpubench.reference.train import train_steps
from gpubench.trace import WINDOW, Spans, summarize
from gpubench.weights import make_weights

CHECK_STEPS = 3


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


class Program:
    """The set-up program: the trainer, its loaders, and what its first
    three steps gave."""

    def __init__(self, job: Job):
        from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec
        from ctc_pytorch_tpu_torch.train.loop import Trainer

        self.job = job
        marks = program.Marks()
        dev = torch.device(job.device)
        self.arch = Arch.from_config(job.config)
        self.cfg = program.program_config(job.config, job.mix)
        self.corpus = traffic.make_corpus(job.mix, job.config, job.seed, dev)
        self.weights = make_weights(self.arch, job.seed, dev)
        marks("inputs")
        spec = ModelSpec.from_config(self.cfg, num_class=self.arch.n_class)
        self._out = tempfile.TemporaryDirectory(prefix="gpubench-")
        self.trainer = Trainer(self.cfg, spec, device=dev,
                               out_dir=self._out.name)
        self.trainer.state.model.load_state_dict(self.weights)
        marks("trainer")
        self.host, self.loader = program.loaders(
            self.corpus, self.cfg, self.cfg.shuffle_train, dev)
        marks("loaders")
        self.check = self._first_steps()
        self.epoch_seconds: list = []
        marks("first_steps")
        self._capture_other_shapes()
        marks("other_shapes")
        # a whole epoch before the window: the first epoch after set-up runs
        # 2-3% slower than the next ones on the card
        self.run_epochs(0, lambda n: n >= 1, Spans(False))
        self.epoch_seconds.clear()
        marks("warm_epoch")
        self.marks = marks.seconds

    @property
    def state(self):
        return self.trainer.state

    def _named_params(self):
        names = {id(p): n for n, p in self.state.model.named_parameters()}
        return [(names[id(p)], p)
                for p in self.state.optimizer.param_groups[0]["params"]]

    def _first_steps(self) -> dict:
        epoch_train = self.trainer.epoch_fns[0]
        # the longest padded length: the serial chains are longest there,
        # and so is the rounding they build up
        groups = sorted(self.loader.epoch_groups(0, with_indices=True),
                        key=lambda g: g[3], reverse=True)
        arrs, pos, mask, t_pad, idx = next(
            g for g in groups if len(g[1]) >= CHECK_STEPS)
        params = self._named_params()
        before = {n: p.detach().clone() for n, p in params}
        out1, _, _ = epoch_train(self.state, [(arrs, pos[:1], mask[:1], t_pad)])
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        grads = {n: (self.state.optimizer.state[p]["exp_avg"] / (1 - beta1)
                     ).detach().cpu() for n, p in params}
        out2, _, _ = epoch_train(
            self.state, [(arrs, pos[1:CHECK_STEPS], mask[1:CHECK_STEPS],
                          t_pad)])
        step = {n: norm(p.detach() - before[n]) for n, p in params}
        losses = [float(x) for x in torch.cat([out1[0], out2[0]]).cpu()]
        self.captured = {t_pad}
        return {"losses": losses, "grads": grads,
                "grad_norms": {n: norm(g) for n, g in grads.items()},
                "step_norms": step,
                "batches": [(idx[k], t_pad, mask[k])
                            for k in range(CHECK_STEPS)]}

    def _capture_other_shapes(self) -> None:
        """One step on each batch shape the epochs can take that the first
        steps did not, so the window captures nothing."""
        epoch_train = self.trainer.epoch_fns[0]
        todo = set(self.host.batcher.boundaries) - self.captured
        epoch = 0
        while todo:
            for arrs, pos, mask, t_pad in self.loader.epoch_groups(epoch):
                if t_pad in todo:
                    epoch_train(self.state, [(arrs, pos[:1], mask[:1], t_pad)])
                    todo.discard(t_pad)
            epoch += 1
            if epoch > 1000:
                raise RuntimeError(f"no batch pads to {sorted(todo)}")
        self.captured = set(self.host.batcher.boundaries)
        if self.job.device == "cuda":
            torch.cuda.synchronize()

    def run_epochs(self, first: int, stop, spans: Spans):
        """Whole epochs from ``first`` on while ``stop(epochs run)`` is
        false; returns ``(epochs, steps, non-finite losses)``."""
        from ctc_pytorch_tpu_torch.train.loop import quiet, run_epoch_single

        epoch_train, epoch_eval = self.trainer.epoch_fns
        pending = {}

        def enqueue(state, groups, compute_wer=True):
            token = spans.begin("enqueue")
            try:
                return epoch_train(state, groups, compute_wer)
            finally:
                spans.end(token)
                pending["fetch"] = spans.begin("fetch")

        epochs = steps = bad = 0
        while not stop(epochs):
            t0 = time.perf_counter()
            record: dict = {}
            self.loader.set_epoch(first + epochs)
            with spans.span("epoch"):
                run_epoch_single(first + epochs, (enqueue, epoch_eval),
                                 self.state, self.loader, training=True,
                                 compute_wer=True, log=quiet, record=record)
                spans.end(pending.pop("fetch"))
            steps += len(record["losses"])
            bad += sum(not math.isfinite(x) for x in record["losses"])
            epochs += 1
            self.epoch_seconds.append(time.perf_counter() - t0)
        return epochs, steps, bad

    def groups_of(self, epochs) -> list:
        """``(t_pad, B, batches)`` of each group of ``epochs``."""
        return [(t_pad, pos.shape[1], pos.shape[0]) for e in epochs
                for _, pos, _, t_pad in self.loader.epoch_groups(e)]

    def close(self) -> None:
        self._out.cleanup()


def reference_readings(prog_check: dict, corpus, arch: Arch, weights: dict,
                       l_pad: int, device, quant: str = "fp32",
                       **fault) -> dict:
    """The reference's readings of the three check steps; with ``quant``
    the control's, with a ``fault`` (``reference.train.train_steps``) a
    fault's."""
    from gpubench.reference.model import QUANT

    batches = []
    for idx, t_pad, mask in prog_check["batches"]:
        feats, frames, labels, n_lab = traffic.batch_arrays(
            corpus, idx, t_pad, l_pad)
        frac = frames.to(torch.float32) / t_pad
        batches.append(tuple(x.to(device) for x in (
            feats, frac, labels, n_lab, torch.as_tensor(mask,
                                                         dtype=torch.float32))))
    w = {k: v.to(device) for k, v in weights.items()}
    out = train_steps(w, arch, batches, QUANT[quant], **fault)
    return {"losses": out["losses"],
            "grads": {n: g.cpu() for n, g in out["first_grad"].items()},
            "grad_norms": {n: norm(g) for n, g in out["first_grad"].items()},
            "raw_grad_norms": {n: norm(g) for n, g in out["raw_grad"].items()},
            "step_norms": {n: norm(out["params"][n] - w[n])
                           for n in out["params"]}}


def run(job: Job) -> Outcome:
    marks = {"start": time.perf_counter() - job.t_start}
    prog = Program(job)
    marks.update(prog.marks)
    spans = Spans(job.trace)
    layers = None
    end_to_end = {}
    utts_per_epoch = len(prog.corpus)
    if not job.trace:
        setup_s = time.perf_counter() - job.t_start
        t0 = time.perf_counter()
        epochs, steps, bad = prog.run_epochs(
            1, lambda n: n > 0 and time.perf_counter() - t0 >= job.seconds,
            spans)
        wall = marks["window"] = time.perf_counter() - t0
        end_to_end = {"train_utt_per_s": epochs * utts_per_epoch / wall,
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
        calls = program.recurrence_calls(before, program.read_launches())
        dtype = prog.cfg.dtype
        frames = prog.corpus.frames
        layers = LayerContext(
            trace=summarize(events), steps=steps,
            model_flops=epochs * sum(work.utterance_flops(prog.arch, int(t),
                                                          True)
                                     for t in frames),
            peak_flops=peaks.product_peak(dtype),
            recurrence_least_s=work.recurrence_least_seconds(
                prog.arch, dtype, prog.groups_of(range(1, 1 + epochs)),
                *calls),
            spans=dict(spans.seconds), kernel_tables=job.kernel_tables)
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
