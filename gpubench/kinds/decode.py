"""Cells of kind ``decode``: stage 4's fused greedy decode of a test set.

Set-up builds the model from the run's weights in eval mode, the test set
in the port's ``DeviceCachedLoader`` (unshuffled, as stage 4 builds it) and
``make_fused_decode_fn``, and decodes one pass, which captures every batch
shape.  The window runs whole passes as ``cli/test.py:_evaluate_fused``
does: a fused call, one fetch of the tokens and one of the lengths, and the
hypothesis strings on the host, a group at a time; it ends with the first
pass that ends after ``--seconds``.  ``decode_utt_per_s`` is the real
utterances of its passes over its length.  Then the reference decodes one
pass drawn from the seed and judges its hypotheses; every other pass must
give the same tokens.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import peaks, program, traffic, work
from gpubench.harness import Job, Outcome
from gpubench.judge import checks, worst
from gpubench.readers import LayerContext
from gpubench.reference.decode import alignment_gaps
from gpubench.reference.model import Arch, forward, full_fp32
from gpubench.trace import WINDOW, Spans, summarize
from gpubench.weights import calibrate_bn, make_weights

# utterances of the test set whose statistics become the BN running ones
CALIBRATION_UTTERANCES = 32


class Program:
    def __init__(self, job: Job):
        from ctc_pytorch_tpu_torch.decode.fused import make_fused_decode_fn
        from ctc_pytorch_tpu_torch.decode.metrics import Scorer
        from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec

        self.job = job
        marks = program.Marks()
        dev = torch.device(job.device)
        self.arch = Arch.from_config(job.config)
        self.cfg = program.program_config(job.config, job.mix)
        self.corpus = traffic.make_corpus(job.mix, job.config, job.seed, dev)
        self.weights = make_weights(self.arch, job.seed, dev)
        n_cal = min(len(self.corpus), CALIBRATION_UTTERANCES)
        t_cal = int(self.corpus.frames[:n_cal].max())
        feats, frames, _, _ = traffic.batch_arrays(self.corpus, range(n_cal),
                                                   t_cal)
        calibrate_bn(self.weights, self.arch, feats.to(dev),
                     (frames.to(torch.float32) / t_cal).to(dev))
        marks("inputs")
        self.spec = ModelSpec.from_config(self.cfg,
                                          num_class=self.arch.n_class)
        self.model = CTCModel(self.spec).to(dev)
        self.model.load_state_dict(self.weights)
        self.model.eval()
        self.host, self.loader = program.loaders(self.corpus, self.cfg, False,
                                                 dev)
        self.fused = make_fused_decode_fn(self.spec, self.model, blank=0)
        units = ["blank", "UNK"] + [f"u{i}" for i in range(2,
                                                           self.arch.n_class)]
        self.scorer = Scorer(units)
        self.groups = list(self.loader.epoch_groups(0, with_indices=True))
        marks("loaders")
        self.decode_pass(Spans(False))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        marks("first_pass")
        self.marks = marks.seconds

    def decode_pass(self, spans: Spans) -> list:
        """One pass over the test set; ``[(tokens, lens)]`` a group, on the
        host."""
        out = []
        with spans.span("pass"):
            groups = iter(self.loader.epoch_groups(0, with_indices=True))
            while True:
                with spans.span("plan"):
                    group = next(groups, None)
                if group is None:
                    break
                arrs, pos, mask, t_pad, _ = group
                with spans.span("enqueue"):
                    tokens, lens = self.fused(arrs, pos, t_pad)
                with spans.span("fetch"):
                    tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
                with spans.span("strings"):
                    for bi in range(pos.shape[0]):
                        for i in range(pos.shape[1]):
                            if mask[bi, i]:
                                self.scorer.to_string(tokens[bi, i],
                                                      int(lens[bi, i]))
                out.append((tokens, lens))
        return out

    def real_utterances(self) -> int:
        return int(sum(g[2].sum() for g in self.groups))


def align_gap(passes: list, pick: int, groups: list, corpus, l_pad: int,
              arch: Arch, weights: dict, device) -> float:
    """The widest alignment gap of pass ``pick``'s hypotheses under the
    reference, decoding the same batches."""
    full_fp32()
    w = {k: v.to(device) for k, v in weights.items()}
    gaps = []
    with torch.no_grad():
        for (tokens, lens), (_, pos, mask, t_pad, idx) in zip(passes[pick],
                                                              groups):
            for bi in range(pos.shape[0]):
                feats, frames, _, _ = traffic.batch_arrays(corpus, idx[bi],
                                                           t_pad, l_pad)
                frac = frames.to(torch.float32) / t_pad
                lp, sizes = forward(w, arch, feats.to(device),
                                    frac.to(device), None, False)
                keep = np.nonzero(mask[bi])[0]
                hyps = [tokens[bi, i, :lens[bi, i]].tolist() for i in keep]
                gaps += alignment_gaps(lp[:, keep], sizes[keep], hyps
                                       ).tolist()
    return worst(gaps)


def run(job: Job) -> Outcome:
    marks = {"start": time.perf_counter() - job.t_start}
    prog = Program(job)
    marks.update(prog.marks)
    spans = Spans(job.trace)
    layers, end_to_end, passes = None, {}, []
    per_pass = prog.real_utterances()
    if not job.trace:
        setup_s = time.perf_counter() - job.t_start
        t0 = time.perf_counter()
        while not passes or time.perf_counter() - t0 < job.seconds:
            passes.append(prog.decode_pass(spans))
            if len(passes) <= 3:
                marks[f"pass_{len(passes)}"] = time.perf_counter() - t0
        wall = marks["window"] = time.perf_counter() - t0
        end_to_end = {"decode_utt_per_s": len(passes) * per_pass / wall,
                      "setup_s": setup_s}
    else:
        batches = sum(len(g[1]) for g in prog.groups)
        want = max(1, -(-int(job.mix["trace_min_steps"]) // batches))
        events: list = []
        before = program.read_launches()
        with program.profiled(events):
            with spans.span(WINDOW):
                while len(passes) < want:
                    passes.append(prog.decode_pass(spans))
        calls = program.recurrence_calls(before, program.read_launches())
        groups = [(g[3], g[1].shape[1], g[1].shape[0]) for g in prog.groups]
        layers = LayerContext(
            trace=summarize(events), steps=want * batches,
            model_flops=want * sum(work.utterance_flops(prog.arch, int(t),
                                                        False)
                                   for t in prog.corpus.frames),
            peak_flops=peaks.product_peak(prog.cfg.dtype),
            recurrence_least_s=work.recurrence_least_seconds(
                prog.arch, prog.cfg.dtype, groups * want, *calls),
            spans=dict(spans.seconds), kernel_tables=job.kernel_tables)
    t_window_end = time.perf_counter()
    clocks = peaks.card("clocks.sm,clocks.max.sm,temperature.gpu,power.draw")
    peak = program.memory_peak(job.device)
    pick = int(np.random.default_rng(job.seed).integers(len(passes)))
    differing = sum(any(not (np.array_equal(t, u) and np.array_equal(l, m))
                        for (t, l), (u, m) in zip(p, passes[pick]))
                    for p in passes)
    groups, corpus, arch = prog.groups, prog.corpus, prog.arch
    l_pad = prog.host.batcher.label_pad
    weights = {k: v.detach().cpu() for k, v in prog.weights.items()}
    del prog
    program.release(job.device)
    numbers = {"align_gap_nats": align_gap(passes, pick, groups, corpus, l_pad,
                                           arch, weights, job.device),
               "passes_differing": differing}
    marks["reference"] = time.perf_counter() - t_window_end
    marks["card after the window"] = clocks
    return Outcome(end_to_end, attempted=len(passes) * per_pass, failed=0,
                   checks=checks(numbers, job.limits), memory_peak_bytes=peak,
                   layers=layers, seconds=marks)
