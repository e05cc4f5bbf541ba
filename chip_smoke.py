#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ctc_pytorch_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each a
printed line; any failure ends the run with a nonzero exit and no result:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the eight kernel sources under ``csrc/`` with nvcc, in
   parallel;
3. kernel vs plain: each of the eleven kernel wrappers (eval BiLSTM,
   trainable BiLSTM forward and backward, the CTC loss's forward and
   backward, eval BiGRU, trainable BiGRU forward, which launches the eval
   BiGRU's kernel under a count of its own, and backward, and the same three
   for the tanh RNN) against its plain PyTorch version on the card, at the
   main paths' shapes and at edge shapes, with stated tolerances (the CTC
   kernels at ``CTC_CASES``: the alpha table, the beta table through the
   backward's debug output, neg_ll, the gradient, two backward calls bit
   for bit, the branch taken); the LSTM's and GRU's forwards
   on every branch (``FWD_CASES``); the LSTM's and GRU's backward pre-pass,
   serial kernel and whole backward against their twins on both branches of
   the serial kernel (``HOIST_CASES``); the tanh cell's forward and backward
   on every branch (``RNN_CASES``), each with the branch the launcher
   reports; the three recurrences of each cell with one direction (ndir =
   1); then the
   ten stacked-layout (v1) entry points, each through the kernels against
   itself through the plain versions, with the launches counted; then every
   recurrence branch and the CTC kernels captured in a CUDA graph through
   the port's ``train/graphs.py`` and replayed (``GRAPH_CASES``,
   ``CTC_GRAPH_CASES``): the replay equal to the eager call bit for bit, its
   launches counted once; then the CNN's conv epilogue
   (``ops/conv_epilogue.py``) on the flagship's CNN stack at the benchmark
   cells' padded shapes (``EPILOGUE_CASES``), train and eval, forward and
   backward, against its plain twin (``EPILOGUE_TOL``), its launches
   counted.  Every model path below counts the epilogue's launches too
   (``epilogue_want``), and ``plain_twins`` sends it to its twin;
4. TIMIT decode slice: stage 4 of the flagship TIMIT recipe at full width
   (CNN + 4 x BiLSTM(384), bf16) on a synthetic TIMIT-layout test set,
   with random weights from a seed, through ``cli.test.evaluate``, which
   takes the fused stage 4 (one captured graph replay a batch over the
   device cache); checks that every BiLSTM layer went through the kernel
   and that, in fp32, the kernel path and the plain path decode identical
   strings and PER;
5. TIMIT training slice: stage 2 of the same recipe (batch 8, bf16) on a
   synthetic train and dev split through ``build_loaders`` (a device cache)
   and ``Trainer.fit`` for one epoch and ``save_best``: the recipe's fused
   epoch, every train, dev and ``dev_over_train`` batch one graph replay;
   checks the launch counts of the four training kernels (each replay
   counts what its capture launched), the replays, that the loss fell, that
   the BN counters moved and that the saved package decodes; then two fp32
   optimizer steps through the kernels and through the plain twins on the
   card, which must agree;
6. 863 slice: the 863 recipe with the GRU cell at full width (CNN 1->16
   (11, 5) stride (2, 2) + Hardtanh(0, 20), 4 x BiGRU(256), 67 classes, bf16,
   batch 16) on a synthetic 201-d corpus: ``Trainer.fit`` for one epoch with
   the accuracy-keyed scheduler and ``dev_over_train``, the saved package
   decoded by ``cli.test.evaluate``; the same checks as phases 4 and 5 on
   the three GRU kernels and the CTC kernels; then the seeded package
   beam-decoded at width 20 without an LM (BASELINE config 4) as phase 11
   decodes its package;
7. tanh slice: the TIMIT flagship recipe with ``rnn_type: nn.RNN`` at full
   width (CNN + 4 x BiRNN(384), bf16, batch 8): ``Trainer.fit`` for one
   epoch, the saved package decoded, a seeded model decoded through kernels
   and twins, two fp32 steps through kernels and twins, as phases 4 and 5;
   every tanh launch, forward and backward, on a cluster branch;
8. unidirectional slice: the flagship recipe with ``bidirectional: False``
   (4 x LSTM(384), forward only) the same way: every recurrence launch of
   this path is a one-direction launch of the LSTM kernels;
9. times at the bench shapes (TIMIT: B=128, T=160 -> T'=80, L=48; 863: B=128,
   T=200 -> T'=95, L=40) and at the recipes' batches (B=8; B=16): every
   kernel, its plain twin, its bound and the library call for the same
   function (the recurrences' forwards and backwards in rounds with cuDNN's
   in fp32 and bf16; the LSTM and GRU backwards as pre-pass, serial kernel
   and both, the LSTM's on fp32 streams also at mfcc_39's T'=400, H=256 and
   a data-parallel rank's B=4; the CTC kernels also at mfcc_39's T'=400, B=8
   with their latency bound, and the whole loss's wall and device time against
   ``F.ctc_loss``'s, with the device kernels of one call by name), with the
   branch each kernel took, the stacked entry points, then the flagship's,
   the 863 model's and the tanh model's decode forward and whole train step
   with their device time by kernel, and the CTC loss's share of the
   flagship's B=8 step on the device; the wide forward branch, the wide
   backward (pre-pass and serial chain apart and together, with cuDNN's
   backward), the tanh cell's fp32 forward and backward on the wide branch
   (with cuDNN's), the GRU's fp32 backward cluster and the LSTM training
   forward's bf16 wide form at DeepSpeech2's shape against the grid they
   replaced, and the flagship's B=128 decode forward with its eval
   forwards on either (``times_redesigned``); the flagship's CNN stack,
   forward and backward, through the conv epilogue's kernels and its twin
   at the bf16 ``EPILOGUE_CASES``, with the kernels' byte bound
   (``times_conv_epilogue``);
10. fused vs streaming: the flagship at B=8 (fp32 streams) and the 863 model
    at B=16 (bf16 streams), one epoch and its dev pass at ``drop_out: 0``
    from one seeded state through the eager ``run_epoch`` and the graphed
    ``run_epoch_single`` (same batches, same order, deterministic
    algorithms): per-batch losses, token counts, parameters, and the fused
    and streaming decodes' strings; then each path's epoch wall time,
    utterances a second, the card's busy share (``torch.profiler``), the
    graphs' capture time and pool bytes, and a prefetching train pass
    against the plain host loader;
11. mfcc_39 slice: ``recipes/timit/mfcc_39_config.yaml`` as shipped (39-d
    MFCC, no CNN, 4 x BiLSTM(256), 41 classes, bf16, batch 8) on a synthetic
    39-d corpus: stage 3 (``cli.train_lm``) on its transcripts, one fused
    epoch through ``Trainer.fit`` with phase 5's checks, then stage 4 of the
    saved package with the recipe's ``Beam`` (width 20, the bigram LM at
    0.1) on the host, ``BeamDevice`` from graphs and ``BeamDevice``
    streaming: the two ``BeamDevice`` runs must decode the same strings, and
    ``Beam`` (which sums in double) those of the batched search run in
    float64 on the card (``BeamDevice`` sums in float32, as in the JAX
    package: how many strings it shares with ``Beam`` is printed); an fp32
    package through kernels and twins with ``BeamDevice`` (the same
    strings); the batched search on the card against the same call on the
    CPU (the same tokens); and the beam decodes' times against the greedy
    one's;
12. waveform slice: ``recipes/timit/waveform_config.yaml`` as shipped (raw
    samples in, fbank 80 mel + energy computed in the step, spliced to 243,
    no CNN, 4 x BiLSTM(384), bf16, batch 128, device cache, fused epoch) on
    a synthetic corpus of SPHERE and WAV files (``WAVE_SPLITS``): stage 1
    (``cli.make_feat``) on the card, its fbank, mfcc + deltas and
    spectrogram held against the CPU (``FEAT_TOL``); stage 3; one epoch of
    stage 2 through ``cli.train.train``, every batch a graph replay with the
    frontend in the graph, the training forward on ``cluster32`` and the
    backward on a cluster branch; stage 4 with ``Greedy`` and
    ``BeamDevice`` (streaming, capacity T'); ``Recognizer`` on 16 test files
    (the fp32 package's strings equal to stage 4's) and
    ``StreamingRecognizer`` over a 20 s stream in 0.5 s hops (per-feed
    latency, the committed prefix only grows); the branch of every LSTM and
    CTC launch; then phase 10's comparison of the graphed and the streaming
    epoch, and the train step's device time with the frontend's share;
13. pipeline slice: stages 0-4 of the flagship recipe through the port's
    ``cli.run`` (one stage a call) on a synthetic TIMIT tree
    (``write_timit_corpus``), with a copy of the recipe that differs only in
    paths, ``num_epoches: 1`` and ``profile: True``: stage 0 on the host,
    stage 1 on the card, stage 2 at full width from graphs, stages 3 and 4;
    every stage-2 utterance read by the native ark reader, the branch of
    every LSTM and CTC launch, the profiler's trace naming the port's
    kernels; ``cli.visualize`` of an fp32 copy against the kernels' forward;
    ``cli.import_torch`` of a full-width reference-format flagship against
    the reference module's own forward; the stages' walls, the native and
    numpy readers' rates, stage 2 traced and untraced;
14. 863 LSTM slice: ``recipes/my_863/cnn_lstm_ctc.conf`` and
    ``lstm_ctc.conf`` as shipped (4 x BiLSTM(256), bf16, batch 16), each
    from a text-format Kaldi dump converted by ``data/convert.py``: one
    fused epoch through ``cli.train.train`` with the training forward on
    ``cluster16`` and the backward on 16-row ``bwd_cluster_kernel``, the loss
    falling, stage 4 of the saved package, a seeded model's fp32 strings
    through kernels and twins, the step's device time by kernel, and the
    graphed epoch against the streaming one;
15. data parallel (``phase_data_parallel``): the flagship's step at full
    width on two gloo ranks sharing the card (NCCL refuses two ranks on one
    device), spawned with a file store: two fp32 steps and an eval step at
    the recipe's B=8 and two bf16 steps at B=128, each against one process
    on the whole batch, with each rank's launches and step times; one NCCL
    rank in this process running a fused epoch from graphs, bit for bit
    the ungrouped epoch; ``cli.train --data-parallel`` as two gloo ranks for
    one epoch, its package decoded; stage 4's ``BeamDevice`` search and
    ``Recognizer`` on a mesh of two against the unsplit runs;
16. fp32 streams (``phase_fp32_streams``) where the wide branches and the
    GRU's fp32 backward cluster take them: the 863 GRU model's step at B=8
    (its recipe's 16 over two ranks) through the kernels and the twins, its
    fp32 decode forward at B=128, the wide forwards and backwards (the
    tanh cell's too) under a NaN-filled exchange buffer, the flagship's,
    the 863 GRU model's and the tanh model's fp32 steps at B=128 through
    the kernels and the twins (forwards and backwards on ``wide_fp32``) and
    timed against the grid, the tanh model's fp32 greedy decode at B=128
    (strings equal to the twins', its forward timed against the grid),
    each with the branch asserted;
17. remat (``phase_remat``): the waveform recipe (B=128, dropout 0.2) for
    one graphed fused epoch through ``cli.train.train`` and one eager step,
    the flagship (B=8, fp32 streams) for one graphed fused epoch and one
    eager step, and the 863 GRU model for one eager step at B=16, each with
    ``remat: true`` against ``remat: false`` from one seeded state: loss,
    gradients, every parameter and BN buffer bit for bit, the training
    forward kernel launched twice a layer a step under remat and once
    without (the recompute), every other kernel as often; the eager steps'
    peak memory and time both ways; then ``ctc_forward_score`` through
    ``ctc_fwd_kernel`` against its twin, an impossible alignment scoring
    exactly ``NEG_INF``;
18. DeepSpeech2 (``phase_ds2``): ``recipes/librispeech/ds2_config.yaml`` at
    its published widths (CNN 1->32->32, 5 x BiLSTM(1024) with biases,
    packed, directions summed, 29 classes, bf16) on a B=64 batch of unequal
    lengths cut to T=400 (T' = 200): an eval step and a train step from one
    seeded state through the kernels and through the plain twins, within
    ``DS2_REL_TOL``; the eval op and the serial backward on the grid, the
    training forward on the wide branch's bf16 form, the serial steps
    (``launches_steps``) and the packed, summed layer calls (``rnn_io``)
    counted.  Phase 3 holds the same kernels at the cell's longest bucket
    (T' = 1200, B = 64, H = 1024, bf16) against their twins.

Eleven model paths are driven: the flagship (phases 4 and 5), the 863 model
with the GRU cell (phase 6), the tanh model (phase 7), the unidirectional
flagship (phase 8), the mfcc_39 model (phase 11), the waveform model (phase
12), the flagship through ``cli.run`` (phase 13), the two 863 LSTM recipes
(phase 14), the flagship data parallel (phase 15) and DeepSpeech2 (phase
18); phase 17 drives the waveform recipe, the flagship and the 863 GRU
model again with remat.

Every profiled device time counts kernels, copies and sets only
(``device_activity``), not the user annotations that ``torch.profiler``
draws on the device's timeline, such as the span of
``Optimizer.step#Adam.step``.

It prints one JSON line of per-kernel results, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It imports nothing of
the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".chip_smoke"  # synthetic corpus + packages, removed at exit
RECIPE = ROOT / "recipes" / "timit" / "ctc_config.yaml"
RECIPE_863 = ROOT / "recipes" / "my_863" / "cnn_lstm_ctc.conf"  # rnn_type set here
RECIPE_MFCC = ROOT / "recipes" / "timit" / "mfcc_39_config.yaml"
RECIPE_WAVE = ROOT / "recipes" / "timit" / "waveform_config.yaml"
RECIPE_PIPELINE = RECIPE  # phase 13's recipe, driven through cli.run
RECIPE_DS2 = ROOT / "recipes" / "librispeech" / "ds2_config.yaml"  # phase 18
# phase 14: the 863 LSTM recipes as shipped -> (features, dimension)
RECIPES_863_LSTM = {
    ROOT / "recipes" / "my_863" / "cnn_lstm_ctc.conf": ("spectrum", 201),
    ROOT / "recipes" / "my_863" / "lstm_ctc.conf": ("fbank", 40)}

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores
BF16_FLOP_PER_S = 989e12  # tensor cores, dense, fp32 sums
TF32_FLOP_PER_S = 495e12  # tensor cores, dense

FP32_TOL = 1e-4  # same math, other summation order
BF16_TOL = 2e-2  # both round h to bf16 at the same point: a few bf16 ulps
# backward with bf16 streams: kernel and twin round the same values to bf16,
# so an entry differs by an ulp or two of its own size.  Each dgx entry is held
# to 2 bf16 ulps (2^-7 of the value each) of max(|want|, 1)
BF16_BWD_RTOL = 2.0 ** -6
# two fp32 optimizer steps, kernels against twins: Adam's g / (|g| + eps)
# turns rounding noise on small gradients into a fraction of lr = 1e-3
STEP_TOL = 2e-4
STEP_LOSS_RTOL = 1e-4
# ... on all but this share of the entries: where a gradient is within
# rounding noise of zero, Adam's first steps are +-lr whatever its size, so a
# few entries may differ by up to 2 steps x 2 lr
STEP_OFF_SHARE = 1e-4
CTC_LL_RTOL = 1e-5  # neg_ll of a few hundred nats in fp32
N_DECODE_UTTS = 16
# phase 12's audio corpus: (split, utterances of 1-4 s, seed)
WAVE_SPLITS = (("train", 512, 41), ("dev", 64, 42), ("test", 128, 43))
FEAT_TOL = dict(rtol=1e-5, atol=3e-4)  # log-scale features, card vs CPU
STREAM_SECONDS, HOP_SECONDS = 20.0, 0.5
N_TRAIN_UTTS, N_DEV_UTTS = 64, 16
N_TRAIN_UTTS_863, N_DEV_UTTS_863 = 128, 32  # 8 steps and 2 dev batches of 16
# phase 13's TIMIT tree: training, dev and core-test speakers, 8 utterances
# each (SA1 and SA2 are left out by stage 0)
PIPELINE_SPEAKERS = (6, 2, 2)
# phase 14's corpora: (split, utterances, seed), phase 6's lengths
SPLITS_863_LSTM = (("train", 64, 31), ("dev", 16, 32))
PHONES = ("aa ae ah ao aw ax ay b ch d dh dx eh el en er ey f g hh ih iy "
          "jh k l m n ng ow oy p r s sh t th uh uw v").split()
# 65 units + blank + UNK: the 863 recipe's num_class 66 + blank = 67 outputs
UNITS_863 = [f"u{i:02d}" for i in range(65)]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, n: int = 20) -> float:
    """Device milliseconds of one ``fn()``: ``n`` calls captured in one CUDA
    graph, its replay timed with CUDA events (median of 5), over ``n``; the
    host's launch cost is out of the measure."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, reps=5, warmup=1) / n


def device_activity(ev) -> bool:
    """Whether a ``torch.profiler`` event is work on the card (a kernel, a
    copy or a set): not a step marker, and not a user annotation that the
    profiler draws on the device's timeline (``Optimizer.step#Adam.step``,
    ``nccl:all_reduce``), which spans the kernels it encloses."""
    from torch.autograd import DeviceType

    return (ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith(("ProfilerStep", "Optimizer.",
                                        "nccl:")))


def device_breakdown(fn, expect=()):
    """Device time of one ``fn()`` by kernel name, from ``torch.profiler``:
    (total microseconds, [(name, microseconds)] largest first), kernels,
    copies and sets only (``device_activity``).  A first call runs in the
    profiler's warm-up cycle, which can miss the first kernels of its
    window; the second is the one recorded.  A session that records no
    kernel, or lacks a kernel whose name holds one of ``expect``, is run
    again, up to three in all (``torch.profiler`` now and then drops a
    call's first kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        by_name: dict = {}
        recorded: list = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: recorded.extend(p.events())) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        for ev in recorded:
            if device_activity(ev):
                by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                    + ev.time_range.elapsed_us())
        if by_name and all(any(e in n for n in by_name) for e in expect):
            break
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])
    return sum(us for _, us in rows), rows


def recurrence_inputs(t, b, h, dtype, seed, gates: int = 4, ndir: int = 2,
                      scale: float = 1.0):
    """``(gx, w_hh, dy)`` of a recurrence with ``gates`` gates (4: LSTM, 3:
    GRU, 1: tanh) and ``ndir`` directions on the card, from a seed; ``gx``
    scaled by ``scale``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    gx = scale * torch.randn(t, b, ndir * gates * h, generator=gen)
    gx = gx.to(dtype).cuda()
    bound = h ** -0.5
    w_hh = (torch.rand(ndir, h, gates * h, generator=gen) * 2 - 1) * bound
    dy = torch.randn(t, b, ndir * h, generator=gen).to(dtype).cuda()
    return gx, w_hh.cuda(), dy


def ctc_inputs(t, b, c, l, seed, full: bool = False, device: str = "cuda"):
    """``(log_probs, labels, input_lengths, label_lengths)`` on ``device``.
    Neighbouring labels differ, so ``l`` labels fit in ``l`` frames.  With
    ``full`` every utterance has all ``t`` frames and ``l`` labels; otherwise
    both lengths are drawn below the pad."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    log_probs = torch.log_softmax(torch.randn(t, b, c, generator=gen), -1)
    steps = torch.randint(1, c - 1, (b, max(l, 1)), generator=gen)
    labels = (steps.cumsum(1) % (c - 1) + 1)[:, :l].to(torch.int32)
    if full:
        in_len = torch.full((b,), t, dtype=torch.int32)
        lab_len = torch.full((b,), l, dtype=torch.int32)
    else:
        in_len = torch.randint(max(1, t // 2), t + 1, (b,), generator=gen,
                               dtype=torch.int32)
        lab_len = torch.randint(0, l + 1, (b,), generator=gen,
                                dtype=torch.int32)
    return tuple(x.to(device) for x in (log_probs, labels, in_len, lab_len))


def port_ops():
    from ctc_pytorch_tpu_torch.ops import ctc_loss as ctc_ops
    from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
    from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as train_ops

    return lstm_ops, train_ops, ctc_ops


def port_gru_ops():
    from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
    from ctc_pytorch_tpu_torch.ops import gru_bidir_train as gru_train_ops

    return gru_ops, gru_train_ops


def port_rnn_ops():
    from ctc_pytorch_tpu_torch.ops import rnn_bidir as rnn_ops
    from ctc_pytorch_tpu_torch.ops import rnn_bidir_train as rnn_train_ops

    return rnn_ops, rnn_train_ops


def port_epilogue_ops():
    from ctc_pytorch_tpu_torch.ops import conv_epilogue

    return conv_epilogue


NO_LAUNCHES = dict.fromkeys(
    ("lstm_bidir", "lstm_bidir_train_fwd", "lstm_bidir_train_bwd_prepass",
     "lstm_bidir_train_bwd", "ctc_alpha", "ctc_beta", "gru_bidir",
     "gru_bidir_train_fwd", "gru_bidir_train_bwd_prepass",
     "gru_bidir_train_bwd", "rnn_bidir", "rnn_bidir_train_fwd",
     "rnn_bidir_train_bwd", "lstm_bidir_train_bwd_prepass_tf32",
     "gru_bidir_train_bwd_prepass_tf32", "cnn_epilogue_fwd",
     "cnn_epilogue_bwd"), 0)


def launch_counts() -> dict:
    lstm_ops, train_ops, ctc_ops = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    rnn_ops, rnn_train_ops = port_rnn_ops()
    route = port_epilogue_ops().launches_route
    return {"lstm_bidir": lstm_ops.launches,
            "lstm_bidir_train_fwd": train_ops.launches_fwd,
            "lstm_bidir_train_bwd_prepass": train_ops.launches_bwd_prepass,
            "lstm_bidir_train_bwd": train_ops.launches_bwd,
            "ctc_alpha": ctc_ops.launches_alpha,
            "ctc_beta": ctc_ops.launches_beta,
            "gru_bidir": gru_ops.launches,
            "gru_bidir_train_fwd": gru_train_ops.launches_fwd,
            "gru_bidir_train_bwd_prepass": gru_train_ops.launches_bwd_prepass,
            "gru_bidir_train_bwd": gru_train_ops.launches_bwd,
            "rnn_bidir": rnn_ops.launches,
            "rnn_bidir_train_fwd": rnn_train_ops.launches_fwd,
            "rnn_bidir_train_bwd": rnn_train_ops.launches_bwd,
            # the pre-pass launches on fp32 streams: prepass_tf32_kernel
            "lstm_bidir_train_bwd_prepass_tf32":
                train_ops.launches_bwd_prepass_tf32,
            "gru_bidir_train_bwd_prepass_tf32":
                gru_train_ops.launches_bwd_prepass_tf32,
            # the CNN's conv epilogue: layer calls on its kernels, each way
            "cnn_epilogue_fwd": route["fused_fwd"],
            "cnn_epilogue_bwd": route["fused_bwd"]}


def zero_counts() -> None:
    from ctc_pytorch_tpu_torch.ops import stacked

    lstm_ops, train_ops, ctc_ops = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    rnn_ops, rnn_train_ops = port_rnn_ops()
    stacked.calls = 0
    lstm_ops.launches = gru_ops.launches = rnn_ops.launches = 0
    for mod in (train_ops, gru_train_ops):
        mod.launches_fwd = mod.launches_bwd_prepass = mod.launches_bwd = 0
        mod.launches_bwd_prepass_tf32 = 0
        mod.launches_bwd_branch.update(dict.fromkeys(mod.launches_bwd_branch, 0))
    for by in cluster_branch_counts().values():
        by.update(dict.fromkeys(by, 0))
    rnn_train_ops.launches_fwd = rnn_train_ops.launches_bwd = 0
    ctc_ops.launches_alpha = ctc_ops.launches_beta = 0
    route = port_epilogue_ops().launches_route
    for by in (ctc_ops.launches_fwd_branch, ctc_ops.launches_bwd_branch,
               route):
        by.update(dict.fromkeys(by, 0))


def stacked_calls() -> int:
    """Calls into the stacked-layout wrappers since ``zero_counts``."""
    from ctc_pytorch_tpu_torch.ops import stacked

    return stacked.calls


def epilogue_want(model_cfg, eval_calls: int, train_steps: int = 0) -> dict:
    """The conv epilogue's layer calls on its kernels (``launch_counts``'
    ``cnn_epilogue_*``) over ``train_steps`` training steps and
    ``eval_calls`` eval forwards of the model of ``model_cfg`` (a
    ``ModelSpec`` or a ``Config``: its ``cnn`` and ``pad_dynamics``): one a
    layer each way for each layer the route fuses on the card
    (``ops/conv_epilogue.fused_route``: a BN, ``relu`` or ``hardtanh``, no
    pool); a training step's only with the batch-max frame count that
    masks its statistics (``pad_dynamics: batchmax``)."""
    ce = port_epilogue_ops()
    cnn = model_cfg.cnn
    layers = sum(1 for i in range(cnn.layers) if cnn.add_cnn
                 and cnn.batch_norm and not cnn.pool_at(i)
                 and cnn.activation_function.lower() in ce.FUSED_ACTS)
    if model_cfg.pad_dynamics != "batchmax":
        train_steps = 0
    return {"cnn_epilogue_fwd": layers * (train_steps + eval_calls),
            "cnn_epilogue_bwd": layers * train_steps}


def check_counts(counts: dict, want: dict, what: str,
                 want_stacked_calls: int = 0) -> None:
    """``counts`` must be ``want`` and zero for every kernel not named there,
    and the run since ``zero_counts`` must have entered the stacked-layout
    wrappers ``want_stacked_calls`` times: a model's path never does.  The
    LSTM's and GRU's backward launch one pre-pass per serial launch, so
    ``want`` names only the serial count; of those pre-passes the ones on
    fp32 streams are ``prepass_tf32_kernel``'s, at most all of them here
    (``check_fp32_bwd_branch`` holds a path whose backwards all run fp32
    streams to exactly all)."""
    want = {**NO_LAUNCHES, **want}
    for cell in ("lstm", "gru"):
        pre = want[f"{cell}_bidir_train_bwd"]
        want[f"{cell}_bidir_train_bwd_prepass"] = pre
        tf32 = f"{cell}_bidir_train_bwd_prepass_tf32"
        if not want[tf32]:
            want[tf32] = min(counts.get(tf32, 0), pre)
    check(counts == want, f"{what}: launches {counts}, expected {want}")
    check(stacked_calls() == want_stacked_calls,
          f"{what}: {stacked_calls()} calls into ops/stacked.py, expected "
          f"{want_stacked_calls}")


@contextlib.contextmanager
def plain_twins():
    """Inside the block the ops run their plain twins on CUDA tensors too, so
    a kernel path can be held against them on the card.  The block must
    launch no kernel."""
    lstm_ops, train_ops, ctc_ops = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    rnn_ops, rnn_train_ops = port_rnn_ops()
    swaps = [(port_epilogue_ops(), "fused_route", lambda *a, **k: False),
             (lstm_ops, "lstm_bidir_cuda", lstm_ops.lstm_bidir_plain),
             (train_ops, "lstm_bidir_train_cuda", train_ops.lstm_bidir_train_plain),
             (train_ops, "lstm_bidir_train_backward_cuda",
              train_ops.lstm_bidir_train_backward_plain),
             (ctc_ops, "ctc_fwd_cuda", ctc_ops.ctc_fwd_plain),
             (ctc_ops, "ctc_bwd_cuda", ctc_ops.ctc_bwd_plain),
             (gru_ops, "gru_bidir_cuda", gru_ops.gru_bidir_plain),
             (gru_train_ops, "gru_bidir_train_cuda", gru_ops.gru_bidir_plain),
             (gru_train_ops, "gru_bidir_train_backward_cuda",
              gru_train_ops.gru_bidir_train_backward_plain),
             (rnn_ops, "rnn_bidir_cuda", rnn_ops.rnn_bidir_plain),
             (rnn_train_ops, "rnn_bidir_train_cuda", rnn_ops.rnn_bidir_plain),
             (rnn_train_ops, "rnn_bidir_train_backward_cuda",
              rnn_train_ops.rnn_bidir_train_backward_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    before = launch_counts()
    for mod, name, twin in swaps:
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    check(launch_counts() == before, "a plain-twin run launched a kernel")


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def scaled_err(got, want) -> float:
    """Largest error per entry in units of max(|want|, 1)."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()


def phase_lstm_eval_vs_plain() -> dict:
    """Eval kernel against its plain twin; the worst error per dtype."""
    import torch

    lstm_ops, _, _ = port_ops()
    cases = [  # (T', B, H, stream dtype)
        (80, 128, 384, torch.bfloat16),  # decode bench shape
        (80, 128, 384, torch.float32),
        (100, 8, 384, torch.float32),  # the recipe's batch of 8, longest bucket
        (40, 8, 384, torch.float32),
        (1, 8, 384, torch.float32),  # T = 1
        (33, 8, 384, torch.float32),  # odd T
        (9, 1, 384, torch.float32),  # B = 1
        (12, 16, 32, torch.float32),  # H = 32
        (7, 5, 36, torch.float32),  # H not a multiple of the units per CTA
        (6, 200, 64, torch.bfloat16),  # B over one 128-row tile
        (4, 4, 528, torch.float32),  # widest H with w_hh resident (132 SMs)
        (4, 4, 600, torch.float32),  # w_hh read from L2
        (5, 8, 1024, torch.float32),  # weights past shared memory: read from L2
        (3, 3, 2048, torch.float32),
        # the waveform path (phase 12): 4 s of audio is T' = 200 at B=128
        # (dev pass and stage 4; bf16, and fp32 for the fp32 package), B=16
        # (Recognizer), and B=1 stream windows of 2^17 and 2^18 samples
        (200, 128, 384, torch.bfloat16),
        (200, 128, 384, torch.float32),
        (200, 16, 384, torch.bfloat16),
        (200, 16, 384, torch.float32),
        (410, 1, 384, torch.float32),
        (818, 1, 384, torch.float32),
        # phase 15's ranks: the flagship's batch of 8 over two ranks (fp32
        # streams) and the bench batch of 128 over two (bf16 streams)
        (100, 4, 384, torch.float32),
        (80, 64, 384, torch.bfloat16),
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (t, b, h, dt) in enumerate(cases):
        gx, w_hh, _ = recurrence_inputs(t, b, h, dt, seed=100 + i)
        got = lstm_ops.lstm_bidir_cuda(gx, w_hh)
        want = lstm_ops.lstm_bidir_plain(gx, w_hh)
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        name = "bf16" if dt == torch.bfloat16 else "fp32"
        print(f"  lstm_bidir T={t} B={b} H={h} {name}: max_abs_err={err:.3g} "
              f"(tol {tol})")
        check(torch.isfinite(got.float()).all().item(), "non-finite kernel output")
        check(err <= tol, f"kernel disagrees with plain at T={t} B={b} H={h}")
        worst[dt] = max(worst[dt], err)
    return {"fp32": worst[torch.float32], "bf16": worst[torch.bfloat16]}


def phase_lstm_train_vs_plain() -> dict:
    """Training forward and backward kernels against their plain twins: ys
    and cs; dgx and the dW_hh formed from it.  The backward kernel is given
    the twin's planes, so each kernel is held on its own.  Returns the worst
    error per kernel and dtype."""
    import torch

    _, train_ops, _ = port_ops()
    cases = [  # (T', B, H, stream dtype)
        (80, 128, 384, torch.bfloat16),  # bench shape
        (80, 128, 384, torch.float32),
        (100, 8, 384, torch.float32),  # the recipe's batch, longest bucket
        (1, 8, 384, torch.float32),  # T = 1
        (1, 1, 32, torch.float32),  # T = 1, B = 1, H = 32
        (33, 5, 36, torch.float32),  # odd T, B % 16 != 0, H % 8 != 0
        (12, 16, 32, torch.bfloat16),  # H = 32, bf16 streams
        (6, 200, 64, torch.bfloat16),  # B over one 128-row tile
        (4, 4, 528, torch.float32),  # widest H with w_hh resident (132 SMs)
        (4, 4, 600, torch.float32),  # past the resident limit: w_hh from L2
        (3, 3, 1024, torch.float32),
        (200, 128, 384, torch.bfloat16),  # the waveform recipe's step, 4 s
        (100, 4, 384, torch.float32),  # phase 15: B=8 over two ranks
        (80, 64, 384, torch.bfloat16),  # phase 15: B=128 over two ranks
    ]
    worst = {"fwd": {"fp32": 0.0, "bf16": 0.0}, "bwd": {"fp32": 0.0, "bf16": 0.0}}
    for i, (t, b, h, dt) in enumerate(cases):
        bf16 = dt == torch.bfloat16
        name = "bf16" if bf16 else "fp32"
        gx, w_hh, dy = recurrence_inputs(t, b, h, dt, seed=200 + i)
        ys, cs = train_ops.lstm_bidir_train_cuda(gx, w_hh)
        want_ys, want_cs = train_ops.lstm_bidir_train_plain(gx, w_hh)
        dgx = train_ops.lstm_bidir_train_backward_cuda(gx, w_hh, want_ys,
                                                       want_cs, dy)
        want_dgx = train_ops.lstm_bidir_train_backward_plain(
            gx, w_hh, want_ys, want_cs, dy)
        torch.cuda.synchronize()
        dw = train_ops.dw_hh(want_ys, dgx)
        want_dw = train_ops.dw_hh(want_ys, want_dgx)
        e_fwd = max(max_err(ys, want_ys), max_err(cs, want_cs))
        e_dgx, e_dw = max_err(dgx, want_dgx), max_err(dw, want_dw)
        dw_scale = max(1.0, want_dw.abs().max().item())
        tol_f = BF16_TOL if bf16 else FP32_TOL
        # fp32: absolute; bf16: per entry, relative to max(|want|, 1)
        held_dgx = scaled_err(dgx, want_dgx) if bf16 else e_dgx
        tol_b = BF16_BWD_RTOL if bf16 else FP32_TOL
        print(f"  lstm_bidir_train T={t} B={b} H={h} {name}: fwd ys,cs "
              f"max_abs_err={e_fwd:.3g} (tol {tol_f}); bwd dgx {e_dgx:.3g}"
              + (f" ({held_dgx:.3g} of max(|want|, 1))" if bf16 else "")
              + f", dW_hh {e_dw:.3g} on a scale of {dw_scale:.3g} (tol {tol_b:.3g})")
        for plane in (ys, cs, dgx, dw):
            check(torch.isfinite(plane.float()).all().item(),
                  "non-finite kernel output")
        where = f"at T={t} B={b} H={h} {name}"
        check(e_fwd <= tol_f, f"forward kernel disagrees with plain {where}")
        check(held_dgx <= tol_b, f"backward kernel disagrees with plain {where}")
        check(e_dw <= tol_b * dw_scale, f"dW_hh disagrees with plain {where}")
        worst["fwd"][name] = max(worst["fwd"][name], e_fwd)
        worst["bwd"][name] = max(worst["bwd"][name], e_dgx)
    return worst


# Phase 3's CTC shapes: (T', B, classes, L, blank, what).  The main paths'
# shapes, edge shapes, a blank other than 0, and rows that make the ring of
# ``csrc/ctc_dp.cu`` hold one frame a slot or not even that (read from
# device memory).
CTC_CASES = [
    (80, 128, 41, 48, 0, "bench shape, lengths below the pad"),
    (100, 8, 41, 33, 0, "the recipe's batch"),
    (1, 1, 5, 0, 0, "T = 1, S = 1: an empty label"),
    (7, 3, 5, 2, 0, "odd T"),
    (30, 2, 50, 600, 0, "S = 1201: four positions a thread"),
    (25, 2, 50, 300, 0, "S = 601: two positions a thread"),
    (20, 4, 6, 4, 0, "one infeasible utterance, one empty label"),
    (95, 128, 67, 40, 0, "863 bench shape, lengths below the pad"),
    (95, 16, 67, 40, 0, "the 863 recipe's batch"),
    (195, 16, 67, 33, 0, "the 863 recipe's longest bucket"),
    (400, 8, 41, 33, 0, "the mfcc_39 recipe's longest batch"),
    (60, 8, 41, 20, 40, "blank = C - 1, repeated labels"),
    (300, 4, 5000, 20, 0, "one frame a ring slot"),
    (40, 3, 30000, 12, 0, "rows wider than the ring"),
    (20, 2, 30000, 600, 7, "S = 1201, rows wider than the ring, blank = 7"),
    (64, 2, 50, 1600, 0, "S = 3201, widest rows: no room for gradient warps"),
    (64, 2, 50, 14527, 0, "S = 29055, widest rows: the old kernels' widest"),
    (200, 128, 41, 40, 0, "the waveform recipe's batch: 4 s, 40 phones"),
    (400, 16, 67, 40, 0, "lstm_ctc.conf's longest batch: no CNN, no skip"),
]


def ctc_branch(width: int) -> str:
    """The branch ``csrc/ctc_dp.cu`` takes for ring rows of ``width`` floats
    (C forward, C + S backward): unstaged when not one frame a slot fits the
    ring's 96 KB in 4 slots."""
    return "staged" if 4 * 4 * width <= 96 * 1024 else "unstaged"


def ctc_case_inputs(t, b, c, l, blank, what, seed):
    """``(log_probs, labels, input_lengths, label_lengths)`` of one
    CTC_CASES entry on the card: ``ctc_inputs``, the labels moved off
    ``blank``, and the edits that ``what`` names."""
    import torch

    log_probs, labels, in_len, lab_len = ctc_inputs(t, b, c, l, seed)
    labels = labels - 1  # [1, C) -> [0, C) without blank; neighbours differ
    labels = labels + (labels >= blank).to(labels.dtype)
    if "infeasible" in what:
        labels[2] = 3  # four equal labels need seven frames, it has five
        in_len = torch.tensor([20, 17, 5, 20], dtype=torch.int32).cuda()
        lab_len = torch.tensor([4, 2, 4, 0], dtype=torch.int32).cuda()
    if "widest" in what:  # one utterance that fits its frames, one that not
        in_len[:] = t
        lab_len[:] = torch.tensor([t // 2, l], dtype=lab_len.dtype)
    if "repeated" in what:  # a run of three, and a class three times apart
        labels[1, 3:6] = labels[1, 2]
        labels[2, 9] = labels[2, 4] = labels[2, 0]
        lab_len[1:3] = l
    # padded label slots hold 0, as the recipes' batches do
    pad = torch.arange(l, device="cuda")[None, :] >= lab_len[:, None]
    labels = torch.where(pad, torch.zeros_like(labels), labels)
    return log_probs, labels.to(torch.int32), in_len, lab_len


def hold_table(key, got, want, what) -> float:
    """A kernel's DP table against the twin's, every cell: the same cells
    dead, pinned to NEG_INF, live cells within FP32_TOL; the largest live
    error."""
    import torch

    _, _, ctc_ops = port_ops()
    dead = want <= ctc_ops.NEG_INF / 2
    check(torch.equal(got <= ctc_ops.NEG_INF / 2, dead),
          f"ctc_{key}: other cells dead than in the plain table ({what})")
    check(torch.all(got[dead] == ctc_ops.NEG_INF).item(),
          f"ctc_{key}: a dead cell is not pinned to NEG_INF ({what})")
    live = ~dead
    err = max_err(got[live], want[live]) if live.any() else 0.0
    check(err <= FP32_TOL, f"ctc_{key} disagrees with plain ({what})")
    return err


def phase_ctc_vs_plain() -> dict:
    """``ctc_case`` at every CTC_CASES entry; the worst errors and the
    branches taken."""
    worst = {"alpha": 0.0, "beta": 0.0, "neg_ll_rel": 0.0, "grad": 0.0}
    branches = {"fwd": set(), "bwd": set()}
    for i, case in enumerate(CTC_CASES):
        errs, took = ctc_case(case, seed=300 + i)
        for k in worst:
            worst[k] = max(worst[k], errs[k])
        for k in branches:
            branches[k].add(took[k])
    worst["branches"] = {k: sorted(v) for k, v in branches.items()}
    return worst


def ctc_case(case, seed: int):
    """The forward and backward kernels against their plain twins at one
    CTC_CASES entry: the alpha table and, through the backward's debug
    output, the beta table (the same cells dead, pinned to NEG_INF, live
    cells within FP32_TOL), ``neg_ll`` within CTC_LL_RTOL, the gradient
    within FP32_TOL (each kernel given the twin's inputs, with an upstream
    gradient that is not all ones and zero on one utterance), two backward
    calls bit-equal with deterministic algorithms off, one launch each way
    on the expected branch; then neg_ll and the gradient through
    ``ctc_loss`` on the kernels against the same call on the twins.
    ``(errors, {"fwd": branch, "bwd": branch})``."""
    import torch

    _, _, ctc_ops = port_ops()
    check(not torch.are_deterministic_algorithms_enabled(),
          "the CTC cases run with deterministic algorithms off")
    t, b, c, l, blank, what = case
    log_probs, labels, in_len, lab_len = ctc_case_inputs(
        t, b, c, l, blank, what, seed=seed)
    args = (log_probs, labels, in_len, lab_len, blank)
    gen = torch.Generator().manual_seed(seed + 100)
    g = (torch.rand(b, generator=gen) + 0.5).cuda()
    g[b // 2] = 0.0  # a row the masked mean leaves out
    errs = {}
    before = ctc_ops.launches_fwd_branch.copy(), ctc_ops.launches_bwd_branch.copy()
    launches = ctc_ops.launches_alpha, ctc_ops.launches_beta
    neg_ll, alphas = ctc_ops.ctc_fwd_cuda(*args, with_alphas=True)
    check((ctc_ops.launches_alpha, ctc_ops.launches_beta)
          == (launches[0] + 1, launches[1]), "ctc_fwd_cuda: not one launch")
    neg_ll_only, none = ctc_ops.ctc_fwd_cuda(*args, with_alphas=False)
    want_ll, want_alphas = ctc_ops.ctc_fwd_plain(*args)
    grad, betas = ctc_ops.ctc_bwd_cuda(*args[:4], want_alphas, want_ll, g,
                                       blank, with_betas=True)
    grad2, _ = ctc_ops.ctc_bwd_cuda(*args[:4], want_alphas, want_ll, g,
                                    blank)
    check(ctc_ops.launches_beta == launches[1] + 2,
          "ctc_bwd_cuda: not one launch a call")
    want_grad, want_betas = ctc_ops.ctc_bwd_plain(
        *args[:4], want_alphas, want_ll, g, blank, with_betas=True)
    torch.cuda.synchronize()
    took = {k: [n for n, v in by.items() if v != before[j][n]]
            for j, (k, by) in enumerate((("fwd", ctc_ops.launches_fwd_branch),
                                         ("bwd", ctc_ops.launches_bwd_branch)))}
    s = 2 * l + 1
    want_branch = {"fwd": ctc_branch(c), "bwd": ctc_branch(c + s)}
    for k in ("fwd", "bwd"):
        check(took[k] == [want_branch[k]],
              f"ctc_{k} took {took[k]}, not {want_branch[k]} ({what})")
    check(none is None and torch.equal(neg_ll_only, neg_ll),
          f"ctc_fwd without the alpha table gives another neg_ll ({what})")
    check(torch.equal(grad, grad2),
          f"two ctc_bwd calls differ ({what}): not deterministic")
    errs["alpha"] = hold_table("alpha", alphas, want_alphas, what)
    errs["beta"] = hold_table("beta", betas, want_betas, what)
    errs["neg_ll_kernel_rel"] = ((neg_ll - want_ll).abs()
                                 / want_ll.abs().clamp(min=1.0)).max().item()
    errs["grad_kernel"] = max_err(grad, want_grad)
    check(errs["neg_ll_kernel_rel"] <= CTC_LL_RTOL,
          f"ctc_fwd's neg_ll disagrees with plain ({what})")
    check(torch.isfinite(grad).all().item() and errs["grad_kernel"] <= FP32_TOL,
          f"ctc_bwd's gradient disagrees with plain ({what})")

    def loss_and_grad():
        x = log_probs.clone().requires_grad_(True)
        out = ctc_ops.ctc_loss(x, labels, in_len, lab_len, blank=blank,
                               reduction="none")
        out.sum().backward()
        return out.detach(), x.grad

    got_ll, got_grad = loss_and_grad()
    with plain_twins():
        want_ll2, want_grad2 = loss_and_grad()
    torch.cuda.synchronize()
    errs["neg_ll_rel"] = max(errs["neg_ll_kernel_rel"], (
        (got_ll - want_ll2).abs() / want_ll2.abs().clamp(min=1.0)).max().item())
    errs["grad"] = max(errs["grad_kernel"], max_err(got_grad, want_grad2))
    print(f"  ctc T={t} B={b} C={c} S={s} blank={blank} ({what}): "
          f"{want_branch['fwd']}/{want_branch['bwd']}; alpha "
          f"{errs['alpha']:.3g}, beta {errs['beta']:.3g} (tol {FP32_TOL}); "
          f"neg_ll rel {errs['neg_ll_rel']:.3g} (tol {CTC_LL_RTOL}), "
          f"grad {errs['grad']:.3g} (tol {FP32_TOL}); two backward calls "
          f"bit-equal")
    check(torch.isfinite(got_ll).all().item()
          and torch.isfinite(got_grad).all().item(), f"non-finite CTC loss ({what})")
    check(errs["neg_ll_rel"] <= CTC_LL_RTOL,
          f"neg_ll disagrees with plain ({what})")
    check(errs["grad"] <= FP32_TOL, f"CTC gradient disagrees with plain ({what})")
    if "infeasible" in what:
        check(got_ll[2].item() >= -ctc_ops.NEG_INF / 2,
              "the infeasible utterance has no huge loss")
        check(not got_grad[:, 2].any().item(),
              "the infeasible utterance has a gradient")
    check(not grad[:, b // 2].any().item(),
          f"a zero upstream gradient left a gradient ({what})")
    return errs, want_branch


def phase_gru_vs_plain() -> dict:
    """The three GRU kernels against their plain twins: ys from the eval and
    the training forward; dgx, dhhn and the dW_hh formed from them.  The
    backward kernel is given the twin's ys, so each kernel is held on its own.
    Tolerances as the LSTM phases.  Returns the worst error per kernel and
    dtype."""
    import torch

    gru_ops, gru_train_ops = port_gru_ops()
    cases = [  # (T', B, H, stream dtype)
        (95, 128, 256, torch.bfloat16),  # 863 bench shape: odd T'
        (95, 128, 256, torch.float32),
        (95, 16, 256, torch.bfloat16),  # the 863 recipe's batch
        (195, 16, 256, torch.bfloat16),  # its longest bucket
        (1, 8, 256, torch.float32),  # T = 1
        (1, 1, 32, torch.float32),  # T = 1, B = 1, H = 32
        (9, 1, 32, torch.float32),  # B = 1
        (33, 5, 36, torch.float32),  # odd T, B % 4 != 0, H % 8 != 0
        (7, 3, 37, torch.float32),  # 3H not a multiple of 4
        (12, 16, 32, torch.bfloat16),  # H = 32, bf16 streams
        (6, 200, 64, torch.bfloat16),  # B over one 128-row tile
        (4, 4, 528, torch.float32),  # widest H with w_hh resident (132 SMs)
        (4, 4, 600, torch.float32),  # past the resident limit: w_hh from L2
        (3, 3, 1024, torch.float32),
    ]
    worst = {k: {"fp32": 0.0, "bf16": 0.0} for k in ("eval", "fwd", "bwd")}
    for i, (t, b, h, dt) in enumerate(cases):
        bf16 = dt == torch.bfloat16
        name = "bf16" if bf16 else "fp32"
        gx, w_hh, dy = recurrence_inputs(t, b, h, dt, seed=400 + i, gates=3)
        ys_eval = gru_ops.gru_bidir_cuda(gx, w_hh)
        ys_train = gru_train_ops.gru_bidir_train_cuda(gx, w_hh)
        want_ys = gru_ops.gru_bidir_plain(gx, w_hh)
        dgx, dhhn = gru_train_ops.gru_bidir_train_backward_cuda(
            gx, w_hh, want_ys, dy)
        want_dgx, want_dhhn = gru_train_ops.gru_bidir_train_backward_plain(
            gx, w_hh, want_ys, dy)
        torch.cuda.synchronize()
        dw = gru_train_ops.dw_hh(want_ys, dgx, dhhn)
        want_dw = gru_train_ops.dw_hh(want_ys, want_dgx, want_dhhn)
        e_eval, e_fwd = max_err(ys_eval, want_ys), max_err(ys_train, want_ys)
        e_bwd = max(max_err(dgx, want_dgx), max_err(dhhn, want_dhhn))
        e_dw = max_err(dw, want_dw)
        dw_scale = max(1.0, want_dw.abs().max().item())
        tol_f = BF16_TOL if bf16 else FP32_TOL
        # fp32: absolute; bf16: per entry, relative to max(|want|, 1)
        held = (max(scaled_err(dgx, want_dgx), scaled_err(dhhn, want_dhhn))
                if bf16 else e_bwd)
        tol_b = BF16_BWD_RTOL if bf16 else FP32_TOL
        print(f"  gru_bidir T={t} B={b} H={h} {name}: ys eval {e_eval:.3g}, "
              f"training forward {e_fwd:.3g} (tol {tol_f}); bwd dgx,dhhn "
              f"{e_bwd:.3g}"
              + (f" ({held:.3g} of max(|want|, 1))" if bf16 else "")
              + f", dW_hh {e_dw:.3g} on a scale of {dw_scale:.3g} (tol {tol_b:.3g})")
        for plane in (ys_eval, ys_train, dgx, dhhn, dw):
            check(torch.isfinite(plane.float()).all().item(),
                  "non-finite kernel output")
        where = f"at T={t} B={b} H={h} {name}"
        check(e_eval <= tol_f, f"GRU eval kernel disagrees with plain {where}")
        check(e_fwd <= tol_f, f"GRU training forward disagrees with plain {where}")
        check(held <= tol_b, f"GRU backward kernel disagrees with plain {where}")
        check(e_dw <= tol_b * dw_scale, f"GRU dW_hh disagrees with plain {where}")
        for key, err in (("eval", e_eval), ("fwd", e_fwd), ("bwd", e_bwd)):
            worst[key][name] = max(worst[key][name], err)
    return worst


# The LSTM's and GRU's hoisted backward: (cell, T', B, H, stream dtype,
# directions, the serial branch the launcher must report, by prefix).  The
# bf16 cluster branch (16 or 32 batch rows a cluster) takes bf16 streams up
# to H = 416 (LSTM) and 480 (GRU); the fp32 cluster branch (cluster16_fp32,
# 16 rows a cluster of 8 CTAs to H = 308, of 16 to H = 432 for the LSTM; to
# H = 344 and 500 for the GRU) takes fp32 streams where all its clusters fit
# at once; other fp32 streams (B >= 64 at H = 384, H past the cluster's
# bound) take the wide branch (csrc/bwd_wide.cuh) to its bound (two
# directions: LSTM H <= 872 at B <= 16, 528 at B = 128; GRU H <= 672 at B =
# 128), and wider H the grid branch.  The card's pytest cases
# (tests/test_torch_cuda.py) run the same list.
# DeepSpeech2's recurrence (recipes/librispeech/ds2_config.yaml, the
# ds2_librispeech-train_b64 cell): H = 1024 at B = 64 on bf16 streams and
# T' = 1200, its longest bucket, past every cluster bound: the grid
# backward here (past the wide backward's fp32-only branch); in
# DS2_FWD_CASES the training forward on the wide branch's bf16 form and the
# eval op (fp32 products, past the fp32 wide bound) on the grid
DS2_HOIST_CASES = [("lstm", 1200, 64, 1024, "bf16", 2, "grid")]
HOIST_CASES = [
    ("lstm", 80, 128, 384, "bf16", 2, "cluster"),  # TIMIT bench shape
    ("gru", 95, 128, 256, "bf16", 2, "cluster"),  # 863 bench shape
    ("lstm", 100, 8, 384, "fp32", 2, "cluster16_fp32"),  # TIMIT recipe batch
    ("gru", 95, 16, 256, "bf16", 2, "cluster"),  # 863 recipe batch
    ("gru", 195, 16, 256, "bf16", 2, "cluster"),  # its longest bucket
    ("lstm", 80, 128, 384, "fp32", 2, "wide_fp32"),  # 16 clusters of 16 CTAs
    ("lstm", 1, 16, 64, "bf16", 2, "cluster"),  # T = 1
    ("gru", 1, 1, 32, "fp32", 2, "cluster16_fp32"),  # T = 1, B = 1
    ("lstm", 9, 1, 64, "bf16", 2, "cluster"),  # B = 1
    ("gru", 9, 1, 64, "bf16", 2, "cluster"),
    ("lstm", 12, 17, 48, "fp32", 2, "cluster16_fp32"),  # B = 17
    ("gru", 12, 17, 48, "bf16", 2, "cluster"),
    ("lstm", 10, 20, 37, "bf16", 2, "cluster"),  # H % 8 != 0
    ("gru", 10, 20, 44, "bf16", 2, "cluster"),  # H % 8 == 4
    ("lstm", 10, 20, 37, "fp32", 1, "cluster16_fp32"),  # one direction
    ("gru", 12, 16, 64, "bf16", 1, "cluster"),
    ("lstm", 6, 200, 64, "bf16", 2, "cluster"),  # 13 row slices
    ("lstm", 6, 16, 416, "bf16", 2, "cluster"),  # widest cluster H
    ("lstm", 6, 16, 424, "bf16", 2, "grid"),
    ("gru", 6, 16, 480, "bf16", 2, "cluster"),
    ("gru", 6, 16, 488, "bf16", 2, "grid"),
    # the 863 LSTM recipes' batch of 16 on bf16 streams (phase 14):
    # cnn_lstm_ctc.conf's T' = 95 and its longest bucket, lstm_ctc.conf's
    ("lstm", 95, 16, 256, "bf16", 2, "cluster"),
    ("lstm", 195, 16, 256, "bf16", 2, "cluster"),
    ("lstm", 400, 16, 256, "bf16", 2, "cluster"),
    # phase 15's ranks: the flagship's B=8 and the bench B=128 over two
    ("lstm", 100, 4, 384, "fp32", 2, "cluster16_fp32"),
    ("lstm", 80, 64, 384, "bf16", 2, "cluster"),
    # the fp32 cluster: mfcc_39's longest batch (T' = 400, H = 256, 8 CTAs),
    # T = 1, B = 1 with one direction, each side of both resident bounds
    ("lstm", 400, 8, 256, "fp32", 2, "cluster16_fp32"),
    ("lstm", 1, 8, 384, "fp32", 2, "cluster16_fp32"),
    ("lstm", 9, 1, 384, "fp32", 1, "cluster16_fp32"),
    ("lstm", 6, 8, 308, "fp32", 2, "cluster16_fp32"),  # 8 CTAs
    ("lstm", 6, 8, 309, "fp32", 2, "cluster16_fp32"),  # 16 CTAs
    ("lstm", 6, 8, 432, "fp32", 2, "cluster16_fp32"),
    ("lstm", 6, 8, 433, "fp32", 2, "wide_fp32"),
    # the GRU's fp32 cluster: the 863 GRU model at B = 8 (B = 16 over two
    # data-parallel ranks) and its longest bucket, B = 128 on the wide
    # branch (16 clusters of 8 CTAs do not fit at once), B = 17, one
    # direction with H % 4 != 0, each side of both resident bounds
    ("gru", 95, 8, 256, "fp32", 2, "cluster16_fp32"),
    ("gru", 195, 8, 256, "fp32", 2, "cluster16_fp32"),
    ("gru", 95, 128, 256, "fp32", 2, "wide_fp32"),
    ("gru", 12, 17, 48, "fp32", 2, "cluster16_fp32"),
    ("gru", 10, 20, 37, "fp32", 1, "cluster16_fp32"),
    ("gru", 6, 8, 344, "fp32", 2, "cluster16_fp32"),  # 8 CTAs
    ("gru", 6, 8, 345, "fp32", 2, "cluster16_fp32"),  # 16 CTAs
    ("gru", 6, 8, 500, "fp32", 2, "cluster16_fp32"),
    ("gru", 6, 8, 501, "fp32", 2, "wide_fp32"),
    # the wide branch (bwd_wide.cuh): a data-parallel rank's B = 64, B not a
    # multiple of 16 (100, 130), T' = 1, the waveform dev pass's T' = 200,
    # one direction, and each side of its bounds
    ("lstm", 80, 64, 384, "fp32", 2, "wide_fp32"),
    ("lstm", 12, 100, 384, "fp32", 2, "wide_fp32"),
    ("lstm", 12, 130, 384, "fp32", 2, "wide_fp32"),
    ("gru", 12, 130, 256, "fp32", 2, "wide_fp32"),
    ("lstm", 1, 128, 384, "fp32", 2, "wide_fp32"),
    ("gru", 1, 128, 256, "fp32", 2, "wide_fp32"),
    ("lstm", 200, 128, 384, "fp32", 2, "wide_fp32"),
    ("lstm", 12, 144, 384, "fp32", 1, "wide_fp32"),
    ("gru", 12, 256, 256, "fp32", 1, "wide_fp32"),
    ("lstm", 6, 128, 528, "fp32", 2, "wide_fp32"),
    ("lstm", 6, 128, 529, "fp32", 2, "grid"),
    ("gru", 6, 128, 672, "fp32", 2, "wide_fp32"),
    ("gru", 6, 128, 673, "fp32", 2, "grid"),
    ("lstm", 4, 8, 872, "fp32", 2, "wide_fp32"),
    ("lstm", 4, 8, 873, "fp32", 2, "grid"),
    # the fp32 pre-pass (prepass_tf32_kernel): T' B off its tiles' rows
    # with H off their units, H % 4 != 0 in both cells with two directions
    # (its 4-byte copies, odd H: scalar pairs), one direction at B = 1 (the
    # LSTM's is above), the widest H of the wide branch at B = 16 and with
    # one direction, and gates driven to saturation (HOIST_SCALE)
    ("lstm", 7, 9, 200, "fp32", 2, "cluster16_fp32"),
    ("gru", 7, 9, 200, "fp32", 2, "cluster16_fp32"),
    ("lstm", 5, 24, 45, "fp32", 2, "cluster16_fp32"),
    ("gru", 5, 24, 45, "fp32", 2, "cluster16_fp32"),
    ("gru", 9, 1, 256, "fp32", 1, "cluster16_fp32"),
    ("gru", 3, 16, 1056, "fp32", 2, "wide_fp32"),
    ("lstm", 3, 16, 1056, "fp32", 1, "wide_fp32"),
    ("lstm", 20, 24, 384, "fp32", 2, "cluster16_fp32"),
    ("gru", 20, 24, 256, "fp32", 2, "cluster16_fp32"),
] + DS2_HOIST_CASES
# HOIST_CASES entries whose gx phase 3 scales (by their first six fields)
HOIST_SCALE = {("lstm", 20, 24, 384, "fp32", 2): 8.0,
               ("gru", 20, 24, 256, "fp32", 2): 8.0}


def phase_hoist_vs_plain(cases=HOIST_CASES) -> dict:
    """The LSTM's and GRU's backward in its two launches at ``cases`` (of
    ``HOIST_CASES``): the pre-pass kernel's planes against its twin's (fp32
    sums in another order: FP32_TOL in both stream dtypes), the serial
    kernel on the twin's planes against the serial twin, and the whole
    backward against the whole twin (the backward tolerances), with the
    branch the launcher reported.  Returns the worst error per cell, kernel
    and dtype, and each case's (``by_case``)."""
    import torch

    _, train_ops, _ = port_ops()
    _, gru_train_ops = port_gru_ops()
    worst = {f"{cell}_{k}": {"fp32": 0.0, "bf16": 0.0}
             for cell in ("lstm", "gru") for k in ("prepass", "serial", "bwd")}
    by_branch: dict = {}  # (cell, serial branch) -> worst serial and whole
    by_case: dict = {}
    for case in cases:
        cell, t, b, h, name, ndir, branch = case
        i = HOIST_CASES.index(case)
        bf16 = name == "bf16"
        gates, mod = (4, train_ops) if cell == "lstm" else (3, gru_train_ops)
        scale = HOIST_SCALE.get((cell, t, b, h, name, ndir), 1.0)
        gx, w_hh, dy = recurrence_inputs(
            t, b, h, torch.bfloat16 if bf16 else torch.float32, seed=520 + i,
            gates=gates, ndir=ndir, scale=scale)
        if cell == "lstm":
            saved = train_ops.lstm_bidir_train_plain(gx, w_hh)
        else:
            saved = (port_gru_ops()[0].gru_bidir_plain(gx, w_hh),)
        fn = {k: getattr(mod, f"{cell}_bidir_train_{k}") for k in (
            "bwd_prepass_cuda", "bwd_prepass_plain", "bwd_serial_cuda",
            "bwd_serial_plain", "backward_cuda", "backward_plain")}
        before = dict(mod.launches_bwd_branch)
        planes = fn["bwd_prepass_cuda"](gx, w_hh, *saved)
        want_planes = fn["bwd_prepass_plain"](gx, w_hh, *saved)
        serial = fn["bwd_serial_cuda"](want_planes, w_hh, dy)
        want_serial = fn["bwd_serial_plain"](want_planes, w_hh, dy)
        whole = fn["backward_cuda"](gx, w_hh, *saved, dy)
        want_whole = fn["backward_plain"](gx, w_hh, *saved, dy)
        torch.cuda.synchronize()
        took = [k for k, v in mod.launches_bwd_branch.items() if v != before[k]]
        errs = {"prepass": max_err(planes, want_planes)}
        held = {"prepass": errs["prepass"]}
        for key, got, want in (("serial", serial, want_serial),
                               ("bwd", whole, want_whole)):
            pairs = [(got, want)] if cell == "lstm" else list(zip(got, want))
            errs[key] = max(max_err(g, w) for g, w in pairs)
            held[key] = (max(scaled_err(g, w) for g, w in pairs) if bf16
                         else errs[key])
            check(all(torch.isfinite(g.float()).all().item() for g, _ in pairs),
                  "non-finite kernel output")
        tol_b = BF16_BWD_RTOL if bf16 else FP32_TOL
        print(f"  {cell} backward T={t} B={b} H={h} ndir={ndir} {name}"
              + (f" gx x {scale:g}" if scale != 1.0 else "") + ": branch "
              f"{'+'.join(took)} (want {branch}); pre-pass planes "
              f"{errs['prepass']:.3g} (tol {FP32_TOL}); serial kernel "
              f"{errs['serial']:.3g}, pre-pass + serial {errs['bwd']:.3g}"
              + (f" ({held['serial']:.3g}, {held['bwd']:.3g} of max(|want|, 1))"
                 if bf16 else "") + f" (tol {tol_b:.3g})")
        where = f"at T={t} B={b} H={h} ndir={ndir} {name}"
        check(len(took) == 1 and took[0].startswith(branch),
              f"{cell} backward took {took}, not {branch}, {where}")
        check(torch.isfinite(planes).all().item(), "non-finite pre-pass planes")
        check(held["prepass"] <= FP32_TOL,
              f"{cell} pre-pass kernel disagrees with plain {where}")
        check(held["serial"] <= tol_b,
              f"{cell} serial kernel disagrees with plain {where}")
        check(held["bwd"] <= tol_b, f"{cell} backward disagrees with plain {where}")
        for key, err in errs.items():
            worst[f"{cell}_{key}"][name] = max(worst[f"{cell}_{key}"][name], err)
        at = by_branch.setdefault(f"{cell}:{took[0]}", {})
        at[name] = max(at.get(name, 0.0), errs["serial"], errs["bwd"])
        by_case[case] = {"branch": took[0], **errs, "held": held}
    worst["by_branch"], worst["by_case"] = by_branch, by_case
    return worst


# The LSTM's and GRU's forwards on their branches: (kernel, T', B, H, stream
# dtype, directions, the branch the library must report, by prefix).
# "lstm_eval" is the eval op (fp32 products at every stream dtype),
# "lstm_train" the training forward, "gru" the GRU's eval op and training
# forward (one kernel).  Bounds (csrc/fwd_cluster.cuh): the fp32 cluster
# holds H <= 309 with 8 CTAs and H <= 416 with 16; the bf16 cluster LSTM H
# <= 432 (32 rows: 384), GRU H <= 496 (32 rows: 448); a branch is taken only
# where all its clusters fit at once (15 clusters of 8 one-CTA-per-SM
# blocks).  fp32 products that no cluster holds take the wide branch
# (csrc/fwd_wide.cuh) to its bound (two directions: LSTM H <= 776 at B <=
# 16, GRU H <= 1056 at B <= 64), then the grid; bf16 products of the gated
# cells take its bf16 form, wide_bf16, to its bound (two directions: LSTM H
# <= 1056 at B <= 16, 1208 at B = 64, 792 at B = 128; GRU H <= 1352 at B <=
# 16, 1584 at B = 64, 792 at B = 128), then the grid.  The card's pytest
# cases (tests/test_torch_cuda.py) run the same list.
DS2_FWD_CASES = [("lstm_train", 1200, 64, 1024, "bf16", 2, "wide_bf16"),
                 ("lstm_eval", 1200, 64, 1024, "bf16", 2, "grid")]
FWD_CASES = [
    ("lstm_eval", 100, 8, 384, "fp32", 2, "cluster16_fp32"),  # TIMIT recipe
    ("lstm_train", 100, 8, 384, "fp32", 2, "cluster16_fp32"),
    ("lstm_eval", 80, 128, 384, "bf16", 2, "wide_fp32"),  # TIMIT bench shape
    ("lstm_train", 80, 128, 384, "bf16", 2, "cluster32"),
    ("gru", 95, 16, 256, "bf16", 2, "cluster16"),  # 863 recipe batch
    ("gru", 195, 16, 256, "bf16", 2, "cluster16"),  # its longest bucket
    ("gru", 95, 128, 256, "bf16", 2, "cluster"),  # 863 bench shape
    ("lstm_train", 80, 128, 384, "fp32", 2, "wide_fp32"),
    ("gru", 95, 128, 256, "fp32", 2, "wide_fp32"),
    ("lstm_eval", 1, 8, 384, "fp32", 2, "cluster16_fp32"),  # T = 1
    ("lstm_train", 1, 16, 64, "bf16", 2, "cluster16"),
    ("lstm_eval", 9, 1, 384, "fp32", 1, "cluster16_fp32"),  # B = 1, one direction
    ("lstm_train", 9, 1, 64, "bf16", 2, "cluster16"),
    ("gru", 1, 1, 32, "fp32", 2, "cluster16_fp32"),
    ("lstm_train", 12, 17, 48, "fp32", 2, "cluster16_fp32"),  # B = 17
    ("gru", 12, 17, 48, "bf16", 2, "cluster16"),
    ("lstm_train", 10, 20, 37, "bf16", 2, "cluster16"),  # odd H
    ("lstm_train", 10, 20, 37, "fp32", 1, "cluster16_fp32"),
    ("gru", 33, 5, 36, "fp32", 2, "cluster16_fp32"),
    ("gru", 7, 3, 37, "bf16", 2, "cluster16"),
    ("lstm_eval", 6, 48, 64, "bf16", 2, "cluster16_fp32"),  # B >= 32
    ("lstm_train", 12, 48, 384, "bf16", 1, "cluster16"),
    ("gru", 12, 48, 256, "bf16", 1, "cluster16"),
    ("lstm_train", 6, 200, 64, "bf16", 2, "cluster"),  # 13 row slices
    ("lstm_eval", 12, 17, 309, "fp32", 2, "cluster16_fp32"),  # 8 CTAs
    ("lstm_eval", 12, 17, 310, "bf16", 2, "cluster16_fp32"),  # 16 CTAs
    ("lstm_eval", 6, 8, 416, "fp32", 2, "cluster16_fp32"),
    ("lstm_eval", 6, 8, 417, "fp32", 2, "wide_fp32"),
    ("lstm_train", 6, 16, 432, "bf16", 2, "cluster16"),
    ("lstm_train", 6, 16, 433, "bf16", 2, "wide_bf16"),
    ("lstm_train", 6, 128, 392, "bf16", 2, "wide_bf16"),  # 32 rows: H <= 384
    ("gru", 6, 16, 496, "bf16", 2, "cluster16"),
    ("gru", 6, 16, 497, "bf16", 1, "wide_bf16"),
    ("gru", 6, 128, 448, "bf16", 2, "cluster32"),
    ("gru", 6, 128, 449, "bf16", 2, "wide_bf16"),
    ("gru", 6, 8, 416, "fp32", 2, "cluster16_fp32"),
    ("gru", 4, 4, 528, "fp32", 2, "wide_fp32"),
    # the 863 LSTM recipes at B=16 on bf16 streams (phase 14): the training
    # forward on the tensor cores, the eval op's fp32 products on the fp32
    # cluster; T' of cnn_lstm_ctc.conf, its longest bucket, lstm_ctc.conf's
    ("lstm_train", 95, 16, 256, "bf16", 2, "cluster16"),
    ("lstm_train", 195, 16, 256, "bf16", 2, "cluster16"),
    ("lstm_train", 400, 16, 256, "bf16", 2, "cluster16"),
    ("lstm_eval", 95, 16, 256, "bf16", 2, "cluster16_fp32"),
    ("lstm_eval", 400, 16, 256, "bf16", 2, "cluster16_fp32"),
    # phase 15's ranks: the flagship's B=8 over two ranks on fp32 streams,
    # the bench batch of 128 over two on bf16 streams (the eval op's fp32
    # products need 8 clusters of 16 CTAs there, which do not fit: the wide
    # branch)
    ("lstm_eval", 100, 4, 384, "fp32", 2, "cluster16_fp32"),
    ("lstm_train", 100, 4, 384, "fp32", 2, "cluster16_fp32"),
    ("lstm_eval", 80, 64, 384, "bf16", 2, "wide_fp32"),
    ("lstm_train", 80, 64, 384, "bf16", 2, "cluster16"),
    # the wide branch: the bench shape on fp32 streams at B = 128 and 64,
    # the waveform recipe's dev pass (T' = 200), the training forward at B
    # = 64, T = 1, B not a multiple of 16, one direction, and each side of
    # its bound (LSTM H = 776 at B = 8, GRU H = 1056)
    ("lstm_eval", 80, 128, 384, "fp32", 2, "wide_fp32"),
    ("lstm_eval", 80, 64, 384, "fp32", 2, "wide_fp32"),
    ("lstm_eval", 200, 128, 384, "bf16", 2, "wide_fp32"),
    ("lstm_train", 80, 64, 384, "fp32", 2, "wide_fp32"),
    ("lstm_eval", 1, 128, 384, "fp32", 2, "wide_fp32"),
    ("lstm_eval", 12, 100, 384, "fp32", 2, "wide_fp32"),
    ("gru", 12, 130, 256, "fp32", 2, "wide_fp32"),
    ("lstm_train", 12, 144, 384, "fp32", 1, "wide_fp32"),
    ("lstm_eval", 6, 8, 776, "fp32", 2, "wide_fp32"),
    ("lstm_eval", 6, 8, 777, "fp32", 2, "grid"),
    ("gru", 4, 4, 1056, "fp32", 2, "wide_fp32"),
    ("gru", 4, 4, 1057, "fp32", 2, "grid"),
    # the wide branch's bf16 form: the GRU past its 32-row cluster's bound,
    # B not a multiple of 16 at DeepSpeech2's H, and each side of its
    # bounds, the grid past them: the LSTM at B = 64 (H / 8 odd: the last
    # k-step is half), B = 16 and B = 128, the GRU at B = 16, 64 and 128
    ("gru", 12, 128, 512, "bf16", 2, "wide_bf16"),
    ("lstm_train", 12, 60, 1024, "bf16", 2, "wide_bf16"),
    ("lstm_train", 4, 64, 1208, "bf16", 2, "wide_bf16"),
    ("lstm_train", 4, 64, 1209, "bf16", 2, "grid"),
    ("lstm_train", 4, 16, 1056, "bf16", 2, "wide_bf16"),
    ("lstm_train", 4, 16, 1057, "bf16", 2, "grid"),
    ("lstm_train", 4, 128, 792, "bf16", 2, "wide_bf16"),
    ("lstm_train", 4, 128, 793, "bf16", 2, "grid"),
    ("gru", 4, 16, 1352, "bf16", 2, "wide_bf16"),
    ("gru", 4, 16, 1353, "bf16", 2, "grid"),
    ("gru", 4, 64, 1584, "bf16", 2, "wide_bf16"),
    ("gru", 4, 64, 1585, "bf16", 2, "grid"),
    ("gru", 4, 128, 792, "bf16", 2, "wide_bf16"),
    ("gru", 4, 128, 793, "bf16", 2, "grid"),
] + DS2_FWD_CASES


def cluster_branch_counts() -> dict:
    """The launches by branch of each forward op and of the tanh backward,
    which takes the forward's branches (``FWD_BRANCHES``)."""
    lstm_ops, train_ops, _ = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    rnn_ops, rnn_train_ops = port_rnn_ops()
    return {"lstm_bidir": lstm_ops.launches_fwd_branch,
            "lstm_bidir_train_fwd": train_ops.launches_fwd_branch,
            "gru_bidir": gru_ops.launches_fwd_branch,
            "gru_bidir_train_fwd": gru_train_ops.launches_fwd_branch,
            "rnn_bidir": rnn_ops.launches_fwd_branch,
            "rnn_bidir_train_fwd": rnn_train_ops.launches_fwd_branch,
            "rnn_bidir_train_bwd": rnn_train_ops.launches_bwd_branch}


def check_cluster_branches(what: str) -> dict:
    """Every forward launch (LSTM, GRU, tanh) and every tanh backward launch
    since ``zero_counts`` took a cluster branch; the launches by op and
    branch."""
    took = {op: {k: v for k, v in by.items() if v}
            for op, by in cluster_branch_counts().items() if any(by.values())}
    check(all(k.startswith("cluster") for by in took.values() for k in by),
          f"{what}: a launch took the grid branch: {took}")
    return took


# the LSTM backward's serial kernel on each branch, and its source
LSTM_BWD_KERNELS = {
    "grid": "lstm_bidir_bwd_kernel (csrc/lstm_bidir_train.cu)",
    "cluster16": "bwd_cluster_kernel<LstmCell, 1> (csrc/bwd_hoist.cuh)",
    "cluster32": "bwd_cluster_kernel<LstmCell, 2> (csrc/bwd_hoist.cuh)",
    "cluster16_fp32": "bwd_fma_kernel (csrc/bwd_hoist.cuh)",
    "wide_fp32": "bwd_wide_kernel<LstmCell, RB / 16> (csrc/bwd_wide.cuh)"}


def check_fp32_bwd_branch(what: str, took: dict, launches: int,
                          cell: str = "LSTM", prepass_tf32: int = None) -> None:
    """Every serial launch of the LSTM's (or ``cell``'s) backward on a path
    with fp32 streams (the recipes' batch of 8, a data-parallel rank's 4,
    the 863 GRU model at B = 8) took the fp32 cluster branch, none the
    grid: ``took`` is the launches by branch; and, where ``prepass_tf32``
    (the module's ``launches_bwd_prepass_tf32``) is given, every pre-pass
    before them was ``prepass_tf32_kernel``."""
    took = {k: v for k, v in took.items() if v}
    check(launches > 0 and took == {"cluster16_fp32": launches},
          f"{what}: the {cell} backward's {launches} serial launches took "
          f"{took}, not all cluster16_fp32")
    if prepass_tf32 is not None:
        check(prepass_tf32 == launches,
              f"{what}: {prepass_tf32} of the {cell} backward's {launches} "
              f"pre-passes launched prepass_tf32_kernel")


def phase_fwd_vs_plain(cases=FWD_CASES) -> dict:
    """Each LSTM and GRU forward kernel against its plain twin at ``cases``
    (of FWD_CASES, every branch), with the branch the library reported: ys
    (and the LSTM training forward's cs, in units of max(|want|, 1): a cell
    state past 1 carries bf16's relative rounding) within FP32_TOL, or
    BF16_TOL with bf16 streams.  Returns the worst error per kernel and
    dtype, and each case's (``by_case``, with the largest |cs|)."""
    import torch

    lstm_ops, train_ops, _ = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    worst = {k: {"fp32": 0.0, "bf16": 0.0}
             for k in ("lstm_eval", "lstm_train", "gru_eval", "gru_train")}
    by_branch: dict = {}  # (kernel, branch) -> worst error, both dtypes
    by_case: dict = {}
    for case in cases:
        kernel, t, b, h, name, ndir, branch = case
        i = FWD_CASES.index(case)
        bf16 = name == "bf16"
        gates = 3 if kernel == "gru" else 4
        gx, w_hh, _ = recurrence_inputs(
            t, b, h, torch.bfloat16 if bf16 else torch.float32, seed=600 + i,
            gates=gates, ndir=ndir)
        for by in cluster_branch_counts().values():
            by.update(dict.fromkeys(by, 0))
        if kernel == "lstm_eval":
            runs = [("lstm_eval", lstm_ops, lstm_ops.lstm_bidir_cuda(gx, w_hh),
                     lstm_ops.lstm_bidir_plain(gx, w_hh))]
        elif kernel == "lstm_train":
            runs = [("lstm_train", train_ops,
                     train_ops.lstm_bidir_train_cuda(gx, w_hh),
                     train_ops.lstm_bidir_train_plain(gx, w_hh))]
        else:
            want = gru_ops.gru_bidir_plain(gx, w_hh)
            runs = [("gru_eval", gru_ops, gru_ops.gru_bidir_cuda(gx, w_hh), want),
                    ("gru_train", gru_train_ops,
                     gru_train_ops.gru_bidir_train_cuda(gx, w_hh), want)]
        torch.cuda.synchronize()
        tol = BF16_TOL if bf16 else FP32_TOL
        where = f"at T={t} B={b} H={h} ndir={ndir} {name}"
        for key, mod, got, want in runs:
            took = [k for k, v in mod.launches_fwd_branch.items() if v]
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max_err(got[0], want[0])
            cs_max = None
            if len(got) == 2:  # cs
                err = max(err, scaled_err(got[1], want[1]))
                cs_max = want[1].float().abs().max().item()
            print(f"  {key} forward T={t} B={b} H={h} ndir={ndir} {name}: "
                  f"branch {'+'.join(took)} (want {branch}); "
                  f"{'ys, cs' if len(got) == 2 else 'ys'} max_abs_err "
                  f"{err:.3g} (tol {tol})"
                  + (f"; largest |cs| {cs_max:.4g}" if cs_max is not None
                     else ""))
            check(all(torch.isfinite(g.float()).all().item() for g in got),
                  f"non-finite {key} forward output {where}")
            check(len(took) == 1 and took[0].startswith(branch),
                  f"{key} forward took {took}, not {branch}, {where}")
            check(err <= tol, f"{key} forward disagrees with plain {where}")
            worst[key][name] = max(worst[key][name], err)
            at = by_branch.setdefault(f"{key}:{took[0]}", {})
            at[name] = max(at.get(name, 0.0), err)
            by_case.setdefault(case, {})[key] = {"branch": took[0],
                                                 "max_abs_err": err}
            if cs_max is not None:
                by_case[case][key]["cs_max_abs"] = cs_max
    worst["by_branch"], worst["by_case"] = by_branch, by_case
    return worst


# The tanh cell's kernels on their branches: (kernel, T', B, H, stream
# dtype, directions, the branch the library must report, by prefix, scale of
# gx).  "fwd" is the eval op and the training forward (one kernel), "bwd"
# the backward.  Bounds (csrc/fwd_cluster.cuh): the bf16 cluster holds H <=
# 512 with 16 and with 32 rows, the fp32 cluster H <= 558 with 8 CTAs and H
# <= 726 with 16; a branch is taken only where all its clusters fit at once
# (15 clusters of 8 at H = 384: B <= 112 with two directions).  fp32
# streams past that take the wide branch (csrc/fwd_wide.cuh) to its bound,
# H <= 792 at B = 128, 1752 at B <= 16 with two directions, 2288 at B <= 16
# with one.  Past the bounds the grid, whose w_hh is resident up to H =
# 1056 with two directions and 1568 with one, in L2 beyond.  The card's
# pytest cases (tests/test_torch_cuda.py) run the same list.
RNN_CASES = [
    ("fwd", 80, 128, 384, "bf16", 2, "cluster16", 1.0),  # TIMIT bench shape
    ("bwd", 80, 128, 384, "bf16", 2, "cluster16", 1.0),
    ("fwd", 100, 8, 384, "fp32", 2, "cluster16_fp32", 1.0),  # recipe batch
    ("bwd", 100, 8, 384, "fp32", 2, "cluster16_fp32", 1.0),
    # 16 clusters of 8 one-CTA-per-SM blocks do not fit: the wide branch
    ("fwd", 80, 128, 384, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 80, 128, 384, "fp32", 2, "wide_fp32", 1.0),
    # saturated: 1 - y^2 from y near 1
    ("fwd", 80, 128, 384, "bf16", 2, "cluster16", 8.0),
    ("bwd", 80, 128, 384, "bf16", 2, "cluster16", 8.0),
    ("fwd", 1, 8, 384, "fp32", 2, "cluster16_fp32", 1.0),  # T = 1
    ("bwd", 1, 8, 384, "fp32", 2, "cluster16_fp32", 1.0),
    ("fwd", 1, 1, 37, "fp32", 2, "cluster16_fp32", 1.0),  # T = 1, B = 1
    ("bwd", 1, 1, 37, "fp32", 2, "cluster16_fp32", 1.0),
    # odd T, B % 4 != 0, H % 8 != 0
    ("fwd", 33, 5, 37, "fp32", 2, "cluster16_fp32", 1.0),
    ("bwd", 33, 5, 37, "fp32", 2, "cluster16_fp32", 1.0),
    ("fwd", 7, 3, 37, "bf16", 2, "cluster16", 1.0),
    ("bwd", 7, 3, 37, "bf16", 2, "cluster16", 1.0),
    ("fwd", 12, 16, 32, "bf16", 1, "cluster16", 1.0),  # one direction
    ("bwd", 12, 16, 32, "bf16", 1, "cluster16", 1.0),
    ("fwd", 9, 17, 64, "fp32", 1, "cluster16_fp32", 1.0),  # B = 17
    ("bwd", 9, 17, 64, "fp32", 1, "cluster16_fp32", 1.0),
    ("fwd", 6, 200, 64, "bf16", 2, "cluster16", 1.0),  # 13 row slices
    ("bwd", 6, 200, 64, "bf16", 2, "cluster16", 1.0),
    ("fwd", 5, 48, 96, "fp32", 2, "cluster16_fp32", 1.0),  # B >= 32
    ("bwd", 5, 48, 96, "fp32", 2, "cluster16_fp32", 1.0),
    # the bounds: bf16 H <= 512 (16 and 32 rows), fp32 H <= 558 (8 CTAs)
    # and H <= 726 (16 CTAs)
    ("fwd", 6, 16, 512, "bf16", 2, "cluster16", 1.0),
    ("bwd", 6, 16, 512, "bf16", 2, "cluster16", 1.0),
    ("fwd", 6, 16, 513, "bf16", 2, "grid", 1.0),
    ("bwd", 6, 16, 513, "bf16", 1, "grid", 1.0),
    ("fwd", 6, 224, 512, "bf16", 2, "cluster16", 1.0),  # 28 clusters
    ("bwd", 6, 224, 512, "bf16", 2, "cluster16", 1.0),
    ("fwd", 6, 224, 513, "bf16", 2, "grid", 1.0),
    # 60 clusters of 16 rows do not fit at once, 30 of 32 rows do
    ("fwd", 6, 480, 384, "bf16", 2, "cluster32", 1.0),
    ("bwd", 6, 480, 384, "bf16", 2, "cluster32", 1.0),
    ("fwd", 6, 8, 558, "fp32", 2, "cluster16_fp32", 1.0),
    ("bwd", 6, 8, 558, "fp32", 2, "cluster16_fp32", 1.0),
    ("fwd", 6, 8, 559, "fp32", 2, "cluster16_fp32", 1.0),
    ("bwd", 6, 8, 559, "fp32", 1, "cluster16_fp32", 1.0),
    ("fwd", 4, 8, 726, "fp32", 2, "cluster16_fp32", 1.0),
    ("bwd", 4, 8, 726, "fp32", 2, "cluster16_fp32", 1.0),
    ("fwd", 4, 8, 727, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 4, 8, 727, "fp32", 2, "wide_fp32", 1.0),
    # fp32 past the clusters' bound at B = 4: the wide branch, at the grid's
    # bounds of w_hh resident (two directions, one)
    ("fwd", 4, 4, 1056, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 4, 4, 1056, "fp32", 2, "wide_fp32", 1.0),
    ("fwd", 4, 4, 1064, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 4, 4, 1064, "fp32", 2, "wide_fp32", 1.0),
    ("fwd", 4, 4, 1568, "fp32", 1, "wide_fp32", 1.0),
    ("bwd", 4, 4, 1568, "fp32", 1, "wide_fp32", 1.0),
    ("fwd", 4, 4, 1576, "fp32", 1, "wide_fp32", 1.0),
    ("bwd", 4, 4, 1576, "fp32", 1, "wide_fp32", 1.0),
    # B = 64 and 100 at the bench width: 8 and 14 clusters of 8, which fit
    ("fwd", 80, 64, 384, "fp32", 2, "cluster16_fp32", 1.0),
    ("bwd", 80, 64, 384, "fp32", 2, "cluster16_fp32", 1.0),
    ("fwd", 80, 100, 384, "fp32", 2, "cluster16_fp32", 1.0),
    ("bwd", 80, 100, 384, "fp32", 2, "cluster16_fp32", 1.0),
    # the wide branch: B not a multiple of 16, T' = 200, saturated, T = 1,
    # one direction
    ("fwd", 12, 130, 384, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 12, 130, 384, "fp32", 2, "wide_fp32", 1.0),
    ("fwd", 12, 200, 384, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 12, 200, 384, "fp32", 2, "wide_fp32", 1.0),
    ("fwd", 200, 128, 384, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 200, 128, 384, "fp32", 2, "wide_fp32", 1.0),
    ("fwd", 80, 128, 384, "fp32", 2, "wide_fp32", 8.0),
    ("bwd", 80, 128, 384, "fp32", 2, "wide_fp32", 8.0),
    ("fwd", 1, 128, 384, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 1, 128, 384, "fp32", 2, "wide_fp32", 1.0),
    ("fwd", 12, 256, 384, "fp32", 1, "wide_fp32", 1.0),
    ("bwd", 12, 256, 384, "fp32", 1, "wide_fp32", 1.0),
    # each side of the wide bound; past it the grid, w_hh resident (H = 793
    # at B = 128) or in L2
    ("fwd", 4, 128, 792, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 4, 128, 792, "fp32", 2, "wide_fp32", 1.0),
    ("fwd", 4, 128, 793, "fp32", 2, "grid", 1.0),
    ("bwd", 4, 128, 793, "fp32", 2, "grid", 1.0),
    ("fwd", 4, 4, 1752, "fp32", 2, "wide_fp32", 1.0),
    ("bwd", 4, 4, 1752, "fp32", 2, "wide_fp32", 1.0),
    ("fwd", 4, 4, 1753, "fp32", 2, "grid", 1.0),
    ("bwd", 4, 4, 1753, "fp32", 2, "grid", 1.0),
    ("fwd", 4, 4, 2288, "fp32", 1, "wide_fp32", 1.0),
    ("bwd", 4, 4, 2288, "fp32", 1, "wide_fp32", 1.0),
    ("fwd", 4, 4, 2289, "fp32", 1, "grid", 1.0),
    ("bwd", 4, 4, 2289, "fp32", 1, "grid", 1.0),
    # the grid: w_hh resident, then in L2, with two directions and one
    # (bf16 streams, which no wide branch takes)
    ("fwd", 4, 4, 1056, "bf16", 2, "grid", 1.0),
    ("bwd", 4, 4, 1056, "bf16", 2, "grid", 1.0),
    ("fwd", 4, 4, 1064, "bf16", 2, "grid", 1.0),
    ("bwd", 4, 4, 1064, "bf16", 2, "grid", 1.0),
    ("fwd", 4, 4, 1568, "bf16", 1, "grid", 1.0),
    ("bwd", 4, 4, 1568, "bf16", 1, "grid", 1.0),
    ("fwd", 4, 4, 1576, "bf16", 1, "grid", 1.0),
    ("bwd", 4, 4, 1576, "bf16", 1, "grid", 1.0),
]


def phase_rnn_vs_plain() -> dict:
    """The tanh-RNN kernels against their plain twins on every branch of
    RNN_CASES, with the branch the library reported: ys from the eval and
    the training forward; dgx and the dW_hh formed from it.  The backward
    kernel is given the twin's ys, so each kernel is held on its own.
    Tolerances as the LSTM phases.  Returns the worst error per kernel and
    dtype, and under ``by_branch`` per (kernel, branch) and dtype."""
    import torch

    rnn_ops, rnn_train_ops = port_rnn_ops()
    _, train_ops, _ = port_ops()
    worst = {k: {"fp32": 0.0, "bf16": 0.0} for k in ("eval", "fwd", "bwd")}
    by_branch: dict = {}  # "kernel:branch" -> worst error, both dtypes
    for i, (kernel, t, b, h, name, ndir, branch, scale) in enumerate(RNN_CASES):
        bf16 = name == "bf16"
        gx, w_hh, dy = recurrence_inputs(
            t, b, h, torch.bfloat16 if bf16 else torch.float32, seed=450 + i,
            gates=1, ndir=ndir, scale=scale)
        for by in cluster_branch_counts().values():
            by.update(dict.fromkeys(by, 0))
        want_ys = rnn_ops.rnn_bidir_plain(gx, w_hh)
        where = f"at T={t} B={b} H={h} ndir={ndir} {name}" + (
            f" gx x{scale:g}" if scale != 1.0 else "")
        if kernel == "fwd":
            runs = [("eval", rnn_ops.launches_fwd_branch,
                     rnn_ops.rnn_bidir_cuda(gx, w_hh), want_ys),
                    ("fwd", rnn_train_ops.launches_fwd_branch,
                     rnn_train_ops.rnn_bidir_train_cuda(gx, w_hh), want_ys)]
        else:
            runs = [("bwd", rnn_train_ops.launches_bwd_branch,
                     rnn_train_ops.rnn_bidir_train_backward_cuda(w_hh, want_ys, dy),
                     rnn_train_ops.rnn_bidir_train_backward_plain(
                         w_hh, want_ys, dy))]
        torch.cuda.synchronize()
        for key, counts, got, want in runs:
            took = [k for k, v in counts.items() if v]
            err = max_err(got, want)
            check(torch.isfinite(got.float()).all().item(),
                  f"non-finite tanh {key} kernel output {where}")
            check(len(took) == 1 and took[0].startswith(branch),
                  f"tanh {key} kernel took {took}, not {branch}, {where}")
            if key != "bwd":
                tol = BF16_TOL if bf16 else FP32_TOL
                print(f"  rnn_bidir {key} T={t} B={b} H={h} ndir={ndir} {name}"
                      + (f" gx x{scale:g}" if scale != 1.0 else "")
                      + f": branch {took[0]} (want {branch}); ys max_abs_err "
                      f"{err:.3g} (tol {tol})")
                check(err <= tol, f"tanh {key} kernel disagrees with plain {where}")
            else:
                dw = train_ops.dw_hh(want_ys, got, ndir)
                want_dw = train_ops.dw_hh(want_ys, want, ndir)
                e_dw = max_err(dw, want_dw)
                dw_scale = max(1.0, want_dw.abs().max().item())
                held = scaled_err(got, want) if bf16 else err
                tol = BF16_BWD_RTOL if bf16 else FP32_TOL
                print(f"  rnn_bidir bwd T={t} B={b} H={h} ndir={ndir} {name}"
                      + (f" gx x{scale:g}" if scale != 1.0 else "")
                      + f": branch {took[0]} (want {branch}); dgx {err:.3g}"
                      + (f" ({held:.3g} of max(|want|, 1))" if bf16 else "")
                      + f", dW_hh {e_dw:.3g} on a scale of {dw_scale:.3g} "
                      f"(tol {tol:.3g})")
                check(torch.isfinite(dw).all().item(), "non-finite dW_hh")
                check(held <= tol, f"tanh backward kernel disagrees with plain {where}")
                check(e_dw <= tol * dw_scale,
                      f"tanh dW_hh disagrees with plain {where}")
            worst[key][name] = max(worst[key][name], err)
            at = by_branch.setdefault(f"{key}:{took[0]}", {})
            at[name] = max(at.get(name, 0.0), err)
    worst["by_branch"] = by_branch
    return worst


# Each recurrence kernel on each of its branches, and the CTC DPs, captured
# in a CUDA graph through the port's ``train/graphs.py`` and replayed: (op,
# T', B, H, stream dtype, directions, the branch the launcher must report,
# by prefix).  The shapes are the main paths' (the recipes' batches with
# fp32 and bf16 streams, the bench shape) and edge cases of FWD_CASES,
# HOIST_CASES and RNN_CASES, so that every branch is captured at least once.
# The card's pytest cases (tests/test_torch_cuda.py) run the same list.
GRAPH_CASES = [
    ("lstm_eval", 100, 8, 384, "fp32", 2, "cluster16_fp32"),  # TIMIT recipe
    ("lstm_eval", 80, 128, 384, "bf16", 2, "wide_fp32"),  # TIMIT bench shape
    ("lstm_train", 100, 8, 384, "fp32", 2, "cluster16_fp32"),
    ("lstm_train", 80, 128, 384, "bf16", 2, "cluster32"),
    ("lstm_train", 12, 48, 384, "bf16", 1, "cluster16"),
    ("lstm_train", 80, 128, 384, "fp32", 2, "wide_fp32"),
    ("lstm_bwd", 100, 8, 384, "fp32", 2, "cluster16_fp32"),  # TIMIT recipe
    ("lstm_bwd", 400, 8, 256, "fp32", 2, "cluster16_fp32"),  # mfcc_39
    ("lstm_bwd", 80, 128, 384, "fp32", 2, "wide_fp32"),
    ("lstm_bwd", 80, 128, 384, "bf16", 2, "cluster32"),
    ("lstm_bwd", 6, 16, 416, "bf16", 2, "cluster16"),
    ("gru_eval", 95, 16, 256, "bf16", 2, "cluster16"),  # 863 recipe batch
    ("gru_train", 95, 16, 256, "bf16", 2, "cluster16"),
    ("gru_train", 6, 128, 448, "bf16", 2, "cluster32"),
    ("gru_train", 33, 5, 36, "fp32", 2, "cluster16_fp32"),
    ("gru_train", 95, 128, 256, "fp32", 2, "wide_fp32"),
    ("gru_bwd", 95, 16, 256, "bf16", 2, "cluster16"),
    ("gru_bwd", 95, 128, 256, "bf16", 2, "cluster"),
    ("gru_bwd", 95, 128, 256, "fp32", 2, "wide_fp32"),
    ("rnn_eval", 100, 8, 384, "fp32", 2, "cluster16_fp32"),  # tanh recipe
    ("rnn_train", 80, 128, 384, "bf16", 2, "cluster16"),
    ("rnn_train", 80, 128, 384, "fp32", 2, "wide_fp32"),
    ("rnn_bwd", 100, 8, 384, "fp32", 2, "cluster16_fp32"),
    ("rnn_bwd", 80, 128, 384, "bf16", 2, "cluster16"),
    ("rnn_bwd", 80, 128, 384, "fp32", 2, "wide_fp32"),
    # the wide branch at B = 64, the GRU's fp32 cluster backward, the
    # forward's bf16 wide form (bf16 products past the 32-row cluster's
    # bound; DeepSpeech2's shape) and its grid past that form's bound
    ("lstm_eval", 80, 64, 384, "fp32", 2, "wide_fp32"),
    ("gru_bwd", 95, 8, 256, "fp32", 2, "cluster16_fp32"),
    ("lstm_train", 6, 128, 392, "bf16", 2, "wide_bf16"),
    ("lstm_train", 100, 64, 1024, "bf16", 2, "wide_bf16"),
    ("gru_train", 12, 128, 512, "bf16", 2, "wide_bf16"),
    ("lstm_train", 4, 128, 793, "bf16", 2, "grid"),
    ("gru_train", 4, 16, 1353, "bf16", 2, "grid"),
    # the wide backward at B = 64, and the backwards' grid past its bound
    ("lstm_bwd", 80, 64, 384, "fp32", 2, "wide_fp32"),
    ("lstm_bwd", 6, 128, 529, "fp32", 2, "grid"),
    ("gru_bwd", 6, 128, 673, "fp32", 2, "grid"),
    # the tanh cell's grid, fp32 past the wide bound
    ("rnn_train", 4, 128, 793, "fp32", 2, "grid"),
    ("rnn_bwd", 4, 128, 793, "fp32", 2, "grid"),
]
# op -> (kernel rows of the result line, op module, branch counter)
GRAPH_OPS = {
    "lstm_eval": (("lstm_bidir",), "lstm_bidir", "launches_fwd_branch"),
    "lstm_train": (("lstm_bidir_train_fwd",), "lstm_bidir_train",
                   "launches_fwd_branch"),
    "lstm_bwd": (("lstm_bidir_train_bwd_prepass", "lstm_bidir_train_bwd"),
                 "lstm_bidir_train", "launches_bwd_branch"),
    "gru_eval": (("gru_bidir",), "gru_bidir", "launches_fwd_branch"),
    "gru_train": (("gru_bidir_train_fwd",), "gru_bidir_train",
                  "launches_fwd_branch"),
    "gru_bwd": (("gru_bidir_train_bwd_prepass", "gru_bidir_train_bwd"),
                "gru_bidir_train", "launches_bwd_branch"),
    "rnn_eval": (("rnn_bidir",), "rnn_bidir", "launches_fwd_branch"),
    "rnn_train": (("rnn_bidir_train_fwd",), "rnn_bidir_train",
                  "launches_fwd_branch"),
    "rnn_bwd": (("rnn_bidir_train_bwd",), "rnn_bidir_train",
                "launches_bwd_branch"),
}


def graph_case_call(op: str, t, b, h, name: str, ndir: int, seed: int):
    """The kernel call of one GRAPH_CASES entry on fixed inputs on the card,
    returning a tuple of tensors."""
    import torch

    lstm_ops, train_ops, _ = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    rnn_ops, rnn_train_ops = port_rnn_ops()
    cell = op.split("_")[0]
    gates = {"lstm": 4, "gru": 3, "rnn": 1}[cell]
    gx, w, dy = recurrence_inputs(
        t, b, h, torch.bfloat16 if name == "bf16" else torch.float32, seed,
        gates=gates, ndir=ndir)
    calls = {
        "lstm_eval": lambda: lstm_ops.lstm_bidir_cuda(gx, w),
        "lstm_train": lambda: train_ops.lstm_bidir_train_cuda(gx, w),
        "gru_eval": lambda: gru_ops.gru_bidir_cuda(gx, w),
        "gru_train": lambda: gru_train_ops.gru_bidir_train_cuda(gx, w),
        "rnn_eval": lambda: rnn_ops.rnn_bidir_cuda(gx, w),
        "rnn_train": lambda: rnn_train_ops.rnn_bidir_train_cuda(gx, w),
    }
    if op == "lstm_bwd":
        ys, cs = train_ops.lstm_bidir_train_plain(gx, w)
        calls[op] = lambda: train_ops.lstm_bidir_train_backward_cuda(
            gx, w, ys, cs, dy)
    elif op == "gru_bwd":
        ys = gru_ops.gru_bidir_plain(gx, w)
        calls[op] = lambda: gru_train_ops.gru_bidir_train_backward_cuda(
            gx, w, ys, dy)
    elif op == "rnn_bwd":
        ys = rnn_ops.rnn_bidir_plain(gx, w)
        calls[op] = lambda: rnn_train_ops.rnn_bidir_train_backward_cuda(
            w, ys, dy)

    def call():
        out = calls[op]()
        return out if isinstance(out, tuple) else (out,)

    return call


def captured_vs_eager(call):
    """``call()`` eagerly, then captured through the port's ``StepGraphs``
    and replayed once: ``(largest difference of the replay's outputs from
    the eager call's, launches of the eager call, launches the capture
    left, launches of the replay)``, the launches as
    ``ops/launch_counts.diff`` gives them."""
    import torch

    from ctc_pytorch_tpu_torch.ops import launch_counts
    from ctc_pytorch_tpu_torch.train.graphs import StepGraphs

    before = launch_counts.read()
    eager = call()
    torch.cuda.synchronize()
    eager_counts = launch_counts.diff(launch_counts.read(), before)
    before = launch_counts.read()
    cap = StepGraphs().capture("case", call, {})
    left = launch_counts.diff(launch_counts.read(), before)
    replayed = cap.replay()
    torch.cuda.synchronize()
    replay_counts = launch_counts.diff(launch_counts.read(), before)
    err = max(max_err(a, b) for a, b in zip(eager, replayed))
    check(all(torch.isfinite(x.float()).all().item() for x in replayed),
          "non-finite replay output")
    return err, eager_counts, left, replay_counts


def graph_case(case, seed: int) -> tuple:
    """One GRAPH_CASES entry: the replay must equal the eager call bit for
    bit (the same kernel on the same inputs), count the eager call's
    launches, and take the expected branch; ``(kernel rows, branch)``."""
    op, t, b, h, name, ndir, branch = case
    rows, mod, counter = GRAPH_OPS[op]
    err, eager, left, replay = captured_vs_eager(
        graph_case_call(op, t, b, h, name, ndir, seed))
    took = sorted(eager.get((mod, counter), {}))
    where = f"{op} T={t} B={b} H={h} ndir={ndir} {name}"
    print(f"  graph {where}: branch {'+'.join(took)} (want {branch}); "
          f"replay vs eager max_abs_err {err:.3g} (tol 0); launches of the "
          f"replay {replay == eager} equal to the eager call's")
    check(len(took) == 1 and took[0].startswith(branch),
          f"{where} took {took}, not {branch}")
    check(err == 0.0, f"{where}: the replay differs from the eager call")
    check(not left, f"{where}: the capture left launch counts {left}")
    check(replay == eager, f"{where}: replay counted {replay}, eager {eager}")
    return rows, took[0]


# The CTC kernels' shapes in phase 3's graph replays: (T', B, L), the
# recipes' batches (TIMIT, 863, mfcc_39's longest) and the bench shape.
CTC_GRAPH_CASES = [(100, 8, 33), (95, 16, 40), (400, 8, 33), (80, 128, 48)]


def ctc_graph_calls(t, b, l, seed):
    """The forward (with its alpha table) and backward kernel calls at one
    CTC_GRAPH_CASES shape, on fixed inputs on the card: ``[(kernel row,
    call)]``, each call returning a tuple of tensors."""
    import torch

    _, _, ctc_ops = port_ops()
    lp, lab, il, ll = ctc_inputs(t, b, 62, l, seed=seed)
    g = torch.rand(b, generator=torch.Generator().manual_seed(seed)).cuda()
    neg_ll, alphas = ctc_ops.ctc_fwd_plain(lp, lab, il, ll)
    return [("ctc_alpha", lambda: ctc_ops.ctc_fwd_cuda(lp, lab, il, ll)),
            ("ctc_beta", lambda: ctc_ops.ctc_bwd_cuda(lp, lab, il, ll, alphas,
                                                      neg_ll, g)[:1])]


def phase_graphs_vs_eager() -> dict:
    """Every recurrence branch (GRAPH_CASES) and the CTC forward and
    backward kernels (CTC_GRAPH_CASES) captured in a CUDA graph, replayed
    and held against the eager call; ``{kernel row: sorted branches
    replayed}``."""
    out: dict = {}
    for i, case in enumerate(GRAPH_CASES):
        rows, branch = graph_case(case, seed=700 + i)
        for row in rows:
            out.setdefault(row, set()).add(branch)
    for t, b, l in CTC_GRAPH_CASES:
        for row, call in ctc_graph_calls(t, b, l, seed=790 + t):
            err, eager, left, replay = captured_vs_eager(call)
            took = sorted(eager.get(("ctc_loss", "launches_fwd_branch"
                                     if row == "ctc_alpha" else
                                     "launches_bwd_branch"), {}))
            print(f"  graph {row} T={t} B={b} L={l}: branch {'+'.join(took)}; "
                  f"replay vs eager max_abs_err {err:.3g} (tol 0)")
            check(err == 0.0 and not left and replay == eager and eager,
                  f"{row} at T={t} B={b}: replay {err}, counts {replay} vs "
                  f"{eager}, capture left {left}")
            out.setdefault(row, set()).update(took)
    return {k: sorted(v) for k, v in out.items()}


def phase_unidir_vs_plain() -> dict:
    """Each cell's ops with one direction (ndir = 1), as a unidirectional
    layer calls them: the eval op, and the trainable op forward and backward
    (``dgx`` and ``dW_hh`` by autograd), through the kernels (one launch of
    each) against the same calls through the plain twins, held as the
    stacked entry points are.  The unidirectional slice's shape (the recipe's
    batch) first.  Returns the worst error per cell."""
    import torch

    from ctc_pytorch_tpu_torch.models.rnn import CELLS

    cases = [  # (T', B, H, stream dtype)
        (100, 8, 384, torch.float32),  # the recipe's batch, longest bucket
        (80, 128, 384, torch.bfloat16),  # TIMIT bench shape
        (7, 5, 37, torch.float32),  # odd T, B % 4 != 0, H % 8 != 0
        (4, 4, 1064, torch.float32),  # past the LSTM's one-direction residency
    ]
    worst = {}
    for cell, (gates, eval_op, train_op) in CELLS.items():
        worst[cell] = 0.0
        for i, (t, b, h, dt) in enumerate(cases):
            gx, w_hh, dy = recurrence_inputs(t, b, h, dt, seed=480 + i,
                                             gates=gates, ndir=1)

            def run():
                ys_eval = eval_op(gx, w_hh)
                g, w = (a.detach().clone().requires_grad_(True)
                        for a in (gx, w_hh))
                ys = train_op(g, w)
                (ys.float() * dy.float()).sum().backward()
                return [ys_eval, ys.detach(), g.grad, w.grad]

            zero_counts()
            got = run()
            torch.cuda.synchronize()
            check_counts(launch_counts(), dict.fromkeys(
                (f"{cell}_bidir", f"{cell}_bidir_train_fwd",
                 f"{cell}_bidir_train_bwd"), 1), f"{cell} ndir=1 at T={t}")
            with plain_twins():
                want = run()
            tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
            # relative to the plane's largest entry: dW_hh is a sum over T x B
            err = max(max_err(g, w) / max(1.0, w.float().abs().max().item())
                      for g, w in zip(got, want))
            print(f"  {cell} ndir=1 T={t} B={b} H={h} "
                  f"{'bf16' if dt == torch.bfloat16 else 'fp32'}: eval ys, "
                  f"training ys, dgx, dW_hh through the kernels against the "
                  f"twins, worst {err:.3g} of the plane's largest entry or 1 "
                  f"(tol {tol})")
            check(all(torch.isfinite(x.float()).all().item() for x in got)
                  and got[0].shape == (t, b, h),
                  f"{cell} ndir=1: bad or non-finite kernel output")
            check(err <= tol, f"{cell} one-direction kernels disagree with "
                  f"plain at T={t} B={b} H={h}")
            worst[cell] = max(worst[cell], err)
    return worst


def stacked_entry_points():
    """``{name: (function, gates, trainable, kernels it must launch)}`` of
    ``ops/stacked.py``: the scan-level entry points take ``(gx, w_hh)``, the
    layer-level ones ``(x, w_ih, w_hh, compute_dtype)``.  The tanh cell's two
    serve eval and training alike and run its trainable op."""
    from ctc_pytorch_tpu_torch.ops import stacked

    eps = {}
    for cell, gates in (("lstm", 4), ("gru", 3)):
        for level in ("scan", "bidir"):
            eps[f"{cell}_{level}_stacked"] = (
                getattr(stacked, f"{cell}_{level}_stacked"), gates, False,
                {f"{cell}_bidir": 1})
            eps[f"{cell}_{level}_train_stacked"] = (
                getattr(stacked, f"{cell}_{level}_train_stacked"), gates, True,
                {f"{cell}_bidir_train_fwd": 1, f"{cell}_bidir_train_bwd": 1})
    for name in ("rnn_scan_train_stacked", "rnn_bidir_stacked"):
        eps[name] = (getattr(stacked, name), 1, True,
                     {"rnn_bidir_train_fwd": 1, "rnn_bidir_train_bwd": 1})
    return eps


# each scan-level entry point beside the layer-level one that runs it
LAYER_OF_SCAN = {"lstm_scan_stacked": "lstm_bidir_stacked",
                 "lstm_scan_train_stacked": "lstm_bidir_train_stacked",
                 "gru_scan_stacked": "gru_bidir_stacked",
                 "gru_scan_train_stacked": "gru_bidir_train_stacked",
                 "rnn_scan_train_stacked": "rnn_bidir_stacked"}


def phase_stacked_vs_plain() -> dict:
    """Each of the ten stacked-layout entry points on the card, through the
    Hopper kernels, against the same entry point through the plain twins:
    outputs and, for the trainable ones, every gradient.  The launch counts
    must show the kernel of its cell and pass, once, and no other.  Returns
    the worst error per entry point."""
    import torch

    cases = [  # (T, B, F, H, compute dtype)
        (95, 8, 64, 256, torch.bfloat16),  # 2B = 16: bf16 streams by the v1 rule
        (20, 5, 24, 64, torch.float32),
        (1, 1, 8, 32, torch.float32),
    ]
    worst = {}
    for name, (fn, gates, trainable, kernels) in stacked_entry_points().items():
        worst[name] = 0.0
        for i, (t, b, f, h, cd) in enumerate(cases):
            bf16 = cd == torch.bfloat16
            gen = torch.Generator().manual_seed(500 + i)
            if "_scan_" in name:
                sd = torch.bfloat16 if bf16 else torch.float32
                gx, w_hh, _ = recurrence_inputs(t, 2 * b, h, sd, seed=500 + i,
                                          gates=gates)
                args, tail = [gx[..., :gates * h].contiguous(), w_hh], ()
            else:
                w_ih = (torch.rand(2, f, gates * h, generator=gen) * 2 - 1) * h ** -0.5
                _, w_hh, _ = recurrence_inputs(1, 1, h, torch.float32, seed=500 + i,
                                         gates=gates)
                args = [torch.randn(t, b, f, generator=gen).cuda(), w_ih.cuda(), w_hh]
                tail = (cd,)

            def run():
                ins = [a.detach().clone().requires_grad_(
                    trainable and a.is_floating_point()) for a in args]
                ys = fn(*ins, *tail)
                if not trainable:
                    return [ys]
                gen_dy = torch.Generator().manual_seed(7)
                dy = torch.randn(ys.shape, generator=gen_dy).to(ys.dtype).cuda()
                (ys.float() * dy.float()).sum().backward()
                return [ys.detach()] + [a.grad for a in ins]

            zero_counts()
            got = run()
            torch.cuda.synchronize()
            check_counts(launch_counts(), kernels,
                         f"{name} at T={t} B={b} H={h}", want_stacked_calls=1)
            with plain_twins():
                want = run()
            for g, w in zip(got, want):
                check(torch.isfinite(g.float()).all().item(),
                      f"{name}: non-finite output")
                # relative to the plane's largest entry: a weight gradient
                # is a sum over T x B products
                err = max_err(g, w) / max(1.0, w.float().abs().max().item())
                tol = BF16_TOL if bf16 else FP32_TOL
                check(err <= tol, f"{name} through the kernels disagrees with "
                      f"itself through the twins at T={t} B={b} H={h}: {err:.3g}")
                worst[name] = max(worst[name], err)
        print(f"  {name}: launches {kernels} per call at {len(cases)} shapes; "
              f"worst error against the plain twins {worst[name]:.3g} "
              f"(tol {FP32_TOL} fp32, {BF16_TOL} bf16, of the plane's largest "
              f"entry or 1)")
    return worst


# The CNN's conv epilogue (``ops/conv_epilogue.py``): the flagship's stack
# (its recipe's two conv layers) at the benchmark cells' padded shapes, (B,
# T, dtype): B = 8 at T = 200 and 392, B = 128 at T = 288 and 392, bf16 as
# the cells run, and the recipe's B = 8 in fp32
EPILOGUE_CASES = ((8, 200, "bfloat16"), (8, 392, "bfloat16"),
                  (128, 288, "bfloat16"), (128, 392, "bfloat16"),
                  (8, 200, "float32"))
# kernels against the twin, both on the card: (output, gradient) tolerances.
# The statistics' sums run in another order, which moves an output across a
# rounding edge of the plane's dtype now and then, and the second layer
# carries that on: outputs within this error in units of max(|want|, 1);
# every leaf's gradient within this share of its largest entry (the conv
# biases under BN, rounding alone, against their layer's weight gradient);
# the running buffers within EPILOGUE_BUF_TOL of theirs
EPILOGUE_TOL = {"bfloat16": (2.0 ** -5, 1e-2), "float32": (1e-5, 1e-4)}
EPILOGUE_BUF_TOL = 1e-5


def epilogue_stack(cfg, device: str = "cuda"):
    """The flagship's CNN stack on ``device``, with its weights and BN state
    (scale, shift, running mean and variance) drawn from a seed."""
    import torch

    from ctc_pytorch_tpu_torch.models.cnn import CNNStack

    gen = torch.Generator().manual_seed(11)
    stack = CNNStack(cfg.cnn)
    for layer in stack:
        layer.reset_parameters(gen)
        with torch.no_grad():
            layer.bn.scale.uniform_(0.5, 1.5, generator=gen)
            layer.bn.bias.uniform_(-0.3, 0.3, generator=gen)
            layer.bn.mean.uniform_(-0.2, 0.2, generator=gen)
            layer.bn.var.uniform_(0.5, 2.0, generator=gen)
    return stack.to(device)


def epilogue_inputs(cfg, stack, b: int, t: int, dtype, device: str = "cuda"):
    """One batch of the stack's input (B, 1, T, F), its frame count 7 below
    T, its example mask with the last row repeat-padded, and the output's
    gradient in the plane's dtype."""
    import torch

    gen = torch.Generator(device=device).manual_seed(b * t)
    x = torch.randn(b, 1, t, cfg.rnn_input_size, generator=gen,
                    device=device)
    tv = torch.tensor(t - 7, dtype=torch.int32, device=device)
    em = torch.ones(b, device=device)
    em[-1] = 0.0
    with torch.no_grad():
        shape = stack.eval()(x, dtype, t_valid=tv).shape
    dy = torch.randn(shape, generator=gen, device=device).to(dtype)
    return x, tv, em, dy


def phase_conv_epilogue_vs_plain(cfg, device: str = "cuda",
                                 cases=EPILOGUE_CASES) -> dict:
    """The conv epilogue's kernels against their plain twin, both on the
    card, at ``EPILOGUE_CASES``: the flagship's CNN stack (``cfg``'s) in
    train mode (the statistics of the frames below the count and of the
    real rows, the running buffers updated) and in eval mode (the running
    statistics), each a forward and a backward from a gradient of the
    output, from one state: outputs, every leaf's gradient and the running
    buffers within ``EPILOGUE_TOL``.  The kernels' call must launch them
    once a layer each way (``cnn_epilogue_*``) and nothing else; the
    twins' none.  Returns the worst errors by dtype.  (``device`` and
    ``cases`` let a CPU run rehearse it at small shapes: the CPU takes the
    twin on both sides and launches nothing.)"""
    import torch

    stack = epilogue_stack(cfg, device)
    start = {k: v.clone() for k, v in stack.state_dict().items()}
    layers = len(stack)

    def step(x, dtype, tv, em, dy, train):
        stack.load_state_dict(start)
        stack.train(train)
        stack.zero_grad(set_to_none=True)
        y = stack(x, dtype, t_valid=tv, example_mask=em)
        y.backward(dy)
        sync()
        return (y.float(),
                {n: p.grad.float().clone() for n, p in stack.named_parameters()},
                {n: v.clone() for n, v in stack.named_buffers()})

    on_card = device == "cuda"
    errs = {}
    for b, t, dname in cases:
        dtype = getattr(torch, dname)
        x, tv, em, dy = epilogue_inputs(cfg, stack, b, t, dtype, device)
        out_tol, grad_tol = EPILOGUE_TOL[dname]
        for train in (True, False):
            what = (f"conv epilogue B={b} T={t} {dname} "
                    f"{'train' if train else 'eval'}")
            zero_counts()
            got = step(x, dtype, tv, em, dy, train)
            check_counts(launch_counts(), {"cnn_epilogue_fwd": layers * on_card,
                                           "cnn_epilogue_bwd": layers * on_card},
                         what)
            with plain_twins():
                want = step(x, dtype, tv, em, dy, train)
            out_err = scaled_err(got[0], want[0])
            grad_err = 0.0
            for name, value in want[1].items():
                ref = want[1][name[:-1] + "w"] if name.endswith(".b") else value
                grad_err = max(grad_err, ((got[1][name] - value).abs().max()
                                          / ref.abs().max()).item())
            buf_err = max(((got[2][n] - v).abs().max()
                           / v.abs().max().clamp(min=1.0)).item()
                          for n, v in want[2].items())
            print(f"  {what}: output {out_err:.3g} (tol {out_tol:.3g}), "
                  f"gradients {grad_err:.3g} of their largest entry (tol "
                  f"{grad_tol:.3g}), running buffers {buf_err:.3g} (tol "
                  f"{EPILOGUE_BUF_TOL:.3g})")
            check(out_err <= out_tol, f"{what}: the output is off the twin's")
            check(grad_err <= grad_tol,
                  f"{what}: a gradient is off the twin's")
            check(buf_err <= EPILOGUE_BUF_TOL,
                  f"{what}: the running buffers are off the twin's")
            worst = errs.setdefault(dname, {"output": 0.0, "gradients": 0.0,
                                            "buffers": 0.0})
            for key, err in (("output", out_err), ("gradients", grad_err),
                             ("buffers", buf_err)):
                worst[key] = max(worst[key], err)
    return errs


def write_corpus(root: Path, split: str = "test", n_utts: int = 64,
                 seed: int = 0, dim: int = 81, units=PHONES,
                 feats: str = "fbank", labels: str = "phn_text") -> None:
    """One split of a synthetic Kaldi-layout corpus: ``dim``-d random features
    of 150-400 frames in ``<feats>.ark/.scp``, a label file and a units file.
    The defaults are the TIMIT layout (81-d fbank, 39 phones)."""
    import numpy as np

    from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter

    rng = np.random.RandomState(seed)
    test = root / split
    test.mkdir(parents=True, exist_ok=True)
    (root / "units").write_text("".join(p + "\n" for p in units))
    lines = []
    with ArkWriter(test / f"{feats}.ark", test / f"{feats}.scp") as w:
        for i in range(n_utts):
            utt = f"{split}{i % 8}_si{i:03d}"
            frames = int(rng.randint(150, 401))
            feat = rng.randn(frames, dim).astype(np.float32)
            w.write(utt, feat)
            n_ph = max(1, frames // 12)
            lines.append(utt + " " + " ".join(rng.choice(units, n_ph)))
    (test / labels).write_text("\n".join(lines) + "\n")


def write_text_corpus(root: Path, split: str, n_utts: int, seed: int,
                      dim: int, units, feats: str, labels: str = "text",
                      frames=(150, 401)) -> Path:
    """One split of a synthetic corpus as the 863 recipe ingests it: a
    text-format Kaldi feature dump (Kaldi's ``copy-feats ark,t:``,
    ``utt  [`` then one row of ``dim`` values a line, `` ]`` closing the
    last) in ``<split>/<feats>.txt`` of ``n_utts`` utterances of ``frames``
    (a range) frames, the label file and the units file.  The features and
    labels are ``write_corpus``'s for the same arguments.  Returns the
    dump's path."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d = root / split
    d.mkdir(parents=True, exist_ok=True)
    (root / "units").write_text("".join(p + "\n" for p in units))
    lines = []
    path = d / f"{feats}.txt"
    with open(path, "w") as f:
        for i in range(n_utts):
            utt = f"{split}{i % 8}_si{i:03d}"
            n = int(rng.randint(*frames))
            mat = rng.randn(n, dim).astype(np.float32)
            rows = ["  " + " ".join(f"{v:.7g}" for v in row) for row in mat]
            f.write(f"{utt}  [\n" + " \n".join(rows) + " ]\n")
            lines.append(utt + " " + " ".join(rng.choice(units,
                                                         max(1, n // 12))))
    (d / labels).write_text("\n".join(lines) + "\n")
    return path


def write_sphere(path: Path, samples, rate: int = 16000) -> None:
    """A NIST SPHERE file of 16-bit linear PCM, the TIMIT encoding: a
    1024-byte ASCII header, then the samples little-endian."""
    import numpy as np

    fields = (f"sample_count -i {len(samples)}", f"sample_rate -i {rate}",
              "channel_count -i 1", "sample_n_bytes -i 2",
              "sample_byte_format -s2 01", "sample_coding -s3 pcm",
              "end_head")
    header = ("NIST_1A\n   1024\n" + "\n".join(fields) + "\n").encode()
    path.write_bytes(header.ljust(1024, b" ")
                     + np.asarray(samples, "<i2").tobytes())


def write_audio_corpus(root: Path, split: str, n_utts: int, seed: int,
                       seconds=(1.0, 4.0), units=PHONES) -> int:
    """One split of a synthetic TIMIT-layout audio corpus: ``n_utts``
    utterances of ``seconds`` (a range) at 16 kHz, the even ones NIST
    SPHERE, the odd ones WAV, listed in ``<split>/wav.scp`` with their
    ``phn_text``, and the ``units`` file.  Each phone is 0.1 s of a tone of
    its own pitch (150 + 60 k Hz for the k-th unit) with its second
    harmonic, under noise, the tone and the noise each at a loudness of
    their own (as in speech, every band's log energy varies by a few
    units).  Returns the samples written."""
    import numpy as np

    from ctc_pytorch_tpu_torch.data.prep.sphere import write_wav

    rng = np.random.RandomState(seed)
    d = root / split
    d.mkdir(parents=True, exist_ok=True)
    (root / "units").write_text("".join(p + "\n" for p in units))
    scp, lines, total = [], [], 0
    for i in range(n_utts):
        utt = f"{split}{i % 8}_si{i:03d}"
        n = int(rng.uniform(*seconds) * 16000)
        labels = rng.randint(len(units), size=max(1, n // 1600))
        wav = phone_tones(rng, labels, n)
        path = d / f"{utt}.{'sph' if i % 2 == 0 else 'wav'}"
        (write_sphere if i % 2 == 0 else write_wav)(path, wav.astype(np.int16))
        scp.append(f"{utt} {path}")
        lines.append(utt + " " + " ".join(units[k] for k in labels))
        total += n
    (d / "wav.scp").write_text("\n".join(scp) + "\n")
    (d / "phn_text").write_text("\n".join(lines) + "\n")
    return total


def phone_tones(rng, labels, n: int):
    """``n`` samples in which the k-th 0.1 s segment is a tone of pitch
    150 + 60 ``labels[k]`` Hz with its second harmonic, under noise, the
    tone and the noise each at a loudness of their own (the last label holds
    to the end)."""
    import numpy as np

    seg = np.minimum(np.arange(n) // 1600, len(labels) - 1)
    gain = rng.uniform(0.1, 1.0, (2, len(labels)))[:, seg]
    phase = 2 * np.pi * np.cumsum(150.0 + 60.0 * labels[seg]) / 16000.0
    return (gain[0] * (4000 * np.sin(phase) + 1500 * np.sin(2 * phase))
            + gain[1] * 300 * rng.randn(n))


def write_timit_corpus(root: Path, n_train: int, n_dev: int, n_test: int,
                       seed: int = 0, phones_per_utt=(8, 16)) -> dict:
    """A synthetic corpus in the TIMIT layout, the input of stage 0:
    ``TRAIN/DR1/<SPEAKER>/`` for ``n_train`` made-up training speakers and
    ``TEST/DR1/<SPEAKER>/`` for the first ``n_dev`` speakers of the dev list
    and the first ``n_test`` of the core-test list.  Each speaker reads SA1
    and SA2 (which stage 0 leaves out), SI1-SI3 and SX1-SX5: a NIST SPHERE
    ``.WAV``, its ``.PHN`` (sample spans of phones of the 60-phone set,
    ``h#`` at both ends, ``q`` and the closures among them, which the
    39-phone folding drops or maps to ``sil``) and ``.WRD``.  Every other
    speaker has lower-case file names, as some copies of the corpus do.
    The audio is ``phone_tones`` of each phone's 39-phone class, 0.1 s a
    phone.  Returns the utterances stage 0 should list per split."""
    import numpy as np

    from ctc_pytorch_tpu_torch.data.prep.phones import phone_map
    from ctc_pytorch_tpu_torch.data.prep.timit import DEV_SPEAKERS, TEST_SPEAKERS

    rng = np.random.RandomState(seed)
    fold = phone_map("60-39")
    inner = sorted(p for p in fold if p != "h#")
    classes = sorted(set(fold.values()) - {""})
    speakers = ([("TRAIN", f"{'mf'[i % 2]}trn{i}") for i in range(n_train)]
                + [("TEST", s) for s in DEV_SPEAKERS[:n_dev]]
                + [("TEST", s) for s in TEST_SPEAKERS[:n_test]])
    sentences = ["sa1", "sa2", "si1", "si2", "si3"] + [f"sx{k}" for k in
                                                       range(1, 6)]
    for i, (split, spk) in enumerate(speakers):
        lower = i % 2 == 1
        d = root / split / "DR1" / (spk if lower else spk.upper())
        d.mkdir(parents=True, exist_ok=True)
        for sent in sentences:
            phones = ["h#"] + list(rng.choice(inner, rng.randint(
                *phones_per_utt))) + ["h#"]
            labels = np.array([classes.index(fold[p]) if fold[p] else 0
                               for p in phones])
            n = 1600 * len(phones)
            stem = d / (sent if lower else sent.upper())
            ext = (lambda e: e) if lower else str.upper
            write_sphere(stem.with_suffix(ext(".wav")),
                         phone_tones(rng, labels, n).astype(np.int16))
            stem.with_suffix(ext(".phn")).write_text("".join(
                f"{1600 * k} {1600 * (k + 1)} {p}\n"
                for k, p in enumerate(phones)))
            stem.with_suffix(ext(".wrd")).write_text("".join(
                f"{1600 * k} {1600 * (k + 2)} w{rng.randint(100)}\n"
                for k in range(1, len(phones) - 2, 2)))
    n_sent = len(sentences) - 2
    return {"train": n_train * n_sent, "dev": n_dev * n_sent,
            "test": n_test * n_sent}


def recipe_config(recipe: Path = RECIPE, data: str = "data",
                  feats: str = "fbank", labels: str = "phn_text",
                  test_split: str = "test"):
    """A shipped recipe with its data paths pointed at the synthetic corpus
    under ``WORK / data``."""
    from ctc_pytorch_tpu_torch.config import load_config

    cfg = load_config(recipe)
    root = WORK / data
    cfg.vocab_file = str(root / "units")
    for split, name in (("train", "train"), ("valid", "dev"),
                        ("test", test_split)):
        setattr(cfg, f"{split}_scp_path", str(root / name / f"{feats}.scp"))
        setattr(cfg, f"{split}_lab_path", str(root / name / labels))
    cfg.checkpoint_dir = str(WORK / "checkpoint")
    return cfg


def recipe_config_863():
    """The 863 recipe with the GRU cell (the configuration the JAX package's
    ``bench.py`` measures) on the synthetic 201-d corpus; the recipe's test
    set is its dev split here."""
    cfg = recipe_config(RECIPE_863, "data863", "spectrum", "text", "dev")
    cfg.rnn_type = "nn.GRU"
    cfg.log_dir = ""
    return cfg


def decode_slice(cfg, spec, model, eval_kernel: str, n_utts: int, tag: str,
                 branches_out: dict = None):
    """Stage 4 through ``cli.test.evaluate`` from packages of ``model``: the
    compute-dtype package through the kernels (every recurrent layer must
    launch ``eval_kernel``, nothing else may launch), then an fp32 package
    through the kernels and through the plain twins, which must decode the
    same strings.  Returns the launches of the first run; its launches by
    op and branch go to ``branches_out["decode"]``."""
    import torch

    from ctc_pytorch_tpu_torch.cli.test import evaluate
    from ctc_pytorch_tpu_torch.train.checkpoint import save_package

    pkg = WORK / "checkpoint" / f"{tag}_{spec.compute_dtype}.npz"
    pkg_fp32 = WORK / "checkpoint" / f"{tag}_fp32.npz"
    save_package(pkg, spec, model, config=cfg)
    spec32 = dataclasses.replace(spec, compute_dtype="float32")
    save_package(pkg_fp32, spec32, model, config=cfg)

    def run(path):
        lines = []
        t0 = time.perf_counter()
        res = evaluate(cfg, str(path), device="cuda", log=lines.append)
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        decoded = [ln for ln in lines if ln.startswith("decoded: ")]
        return res, decoded, lines

    zero_counts()
    res, decoded, lines = run(pkg)
    counts = launch_counts()
    branches = check_cluster_branches(f"{tag} decode")
    if branches_out is not None:
        branches_out["decode"] = branches
    print(f"  {spec.compute_dtype} {tag} decode: {res['batches']} batches, "
          f"{len(decoded)} utts, CER {res['cer']:.4f} WER {res['wer']:.4f}, "
          f"wall {res['wall_s']:.3f} s (first call, includes data load and "
          f"capture); launches {counts[eval_kernel]}, forward branches "
          f"{branches}, calls into ops/stacked.py {stacked_calls()}")
    print(f"  fused stage 4: {res.get('graphs')} captured graphs in "
          f"{res.get('capture_seconds', 0):.3f} s, graph pool "
          f"{res.get('pool_bytes')} bytes")
    print("  " + lines[-1])
    check(res.get("fused") and res["graphs"] >= 1,
          f"{tag} decode did not take the fused stage 4")
    check(len(decoded) == n_utts, f"decoded {len(decoded)} of {n_utts} utterances")
    check_counts(counts, {eval_kernel: spec.rnn_layers * res["batches"],
                          **epilogue_want(spec, res["batches"])},
                 f"{tag} decode")

    zero_counts()
    res32, dec32, _ = run(pkg_fp32)
    check_counts(launch_counts(),
                 {eval_kernel: spec.rnn_layers * res32["batches"],
                  **epilogue_want(spec, res32["batches"])},
                 f"{tag} fp32 decode")
    check_cluster_branches(f"{tag} fp32 decode")
    with plain_twins():
        res_pl, dec_pl, _ = run(pkg_fp32)
    same = sum(a == b for a, b in zip(dec32, dec_pl))
    print(f"  fp32 kernel vs plain on the card: {same}/{len(dec32)} strings "
          f"equal, PER {res32['wer']:.4f} vs {res_pl['wer']:.4f}, "
          f"CER {res32['cer']:.4f} vs {res_pl['cer']:.4f}")
    check(dec32 == dec_pl, "fp32 kernel and plain paths decode differently")
    check(res32["wer"] == res_pl["wer"] and res32["cer"] == res_pl["cer"],
          "fp32 kernel and plain paths score differently")
    n_tok = sum(len(d.split()) - 1 for d in dec32)
    check(n_tok > 0, "every decoded string is empty")
    return counts[eval_kernel]


def seeded_model(spec):
    """``spec``'s model with random weights from a seed."""
    import torch

    from ctc_pytorch_tpu_torch.models import CTCModel

    model = CTCModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        # random weights give near-flat posteriors where a 1e-6 difference
        # flips an argmax; a sharper output layer makes the strings stable
        model.fc.w.mul_(10.0)
    return model


def reference_package(feat: int, cnn_layers, hidden: int, layers: int,
                      num_class: int, cell: str = "LSTM",
                      activation: str = "relu", batch_norm: bool = True,
                      bidirectional: bool = True, seed: int = 0) -> dict:
    """A checkpoint package as the reference's ``CTC_Model.save_package``
    writes it (``timit/models/model_ctc.py:209-229``): its hyperparameters
    (``rnn_param`` with the cell's class, ``cnn_param`` with one
    ``(channels, kernel, stride, padding, pooling)`` entry a layer,
    ``add_cnn``, ``num_class``, ``_drop_out``), the training histories and
    the ``state_dict`` of an ``nn.Module`` with the reference's tree
    (``LayerCNN`` as ``conv.{i}`` with ``.conv`` and ``.batch_norm``,
    ``BatchRNN`` as ``rnns.{i}`` with ``.batch_norm`` (none on the first)
    and a bias-free ``.rnn``; ``fc`` a ``Sequential`` of BN and a bias-free
    ``Linear``, or the ``Linear`` alone), random weights and BN statistics
    from ``seed``.  The module itself is under ``"module"``, in eval mode:
    its ``forward`` is the reference's (``model_ctc.py:144-172``); the rest
    is what ``torch.save`` writes as the reference's ``.pkl``."""
    from collections import OrderedDict

    import torch
    from torch import nn

    act_cls = {"relu": nn.ReLU, "hardtanh": nn.Hardtanh}[activation]
    rnn_cls = getattr(nn, cell)

    def act():
        return nn.Hardtanh(0, 20) if activation == "hardtanh" else nn.ReLU()

    class LayerCNN(nn.Module):
        def __init__(self, cin, cout, k, s, pad):
            super().__init__()
            self.conv = nn.Conv2d(cin, cout, k, stride=s, padding=pad)
            self.batch_norm = nn.BatchNorm2d(cout)
            self.activation = act()

        def forward(self, x):
            return self.activation(self.batch_norm(self.conv(x)))

    class BatchRNN(nn.Module):
        def __init__(self, fin, bn):
            super().__init__()
            self.batch_norm = nn.BatchNorm1d(fin) if bn else None
            self.rnn = rnn_cls(fin, hidden, bidirectional=bidirectional,
                               bias=False)

        def forward(self, x):  # (T, B, F)
            if self.batch_norm is not None:
                x = self.batch_norm(x.transpose(-1, -2)).transpose(-1, -2)
            return self.rnn(x)[0]

    class CTCReference(nn.Module):
        def __init__(self):
            super().__init__()
            convs, f = [], feat
            for i, (ch, k, st, pad) in enumerate(cnn_layers):
                convs.append((str(i), LayerCNN(ch[0], ch[1], k, st, pad)))
                f = (f + 2 * pad[1] - k[1]) // st[1] + 1
            self.conv = nn.Sequential(OrderedDict(convs)) if convs else None
            fin = f * cnn_layers[-1][0][1] if convs else feat
            dirs = 2 if bidirectional else 1
            self.rnns = nn.Sequential(OrderedDict(
                (str(i), BatchRNN(fin if i == 0 else dirs * hidden,
                                  batch_norm and i > 0))
                for i in range(layers)))
            linear = nn.Linear(dirs * hidden, num_class, bias=False)
            self.fc = (nn.Sequential(nn.BatchNorm1d(dirs * hidden), linear)
                       if batch_norm else linear)

        def forward(self, x):  # (B, T, F) -> (T', B, C) log-probs
            if self.conv is not None:
                x = self.conv(x.unsqueeze(1)).transpose(1, 2).contiguous()
                b, t, c, f = x.shape
                x = x.view(b, t, c * f)
            x = self.rnns(x.transpose(0, 1).contiguous())
            t, b, h = x.shape
            x = self.fc(x.reshape(t * b, h)).view(t, b, -1)
            return torch.log_softmax(x, dim=-1)

    torch.manual_seed(seed)
    model = CTCReference()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                n = mod.num_features
                mod.weight.copy_(0.5 + torch.rand(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                mod.num_batches_tracked.fill_(7)
    model.eval()
    return {
        "rnn_param": {"rnn_input_size": feat, "rnn_hidden_size": hidden,
                      "rnn_layers": layers, "rnn_type": rnn_cls,
                      "bidirectional": bidirectional, "batch_norm": batch_norm},
        "add_cnn": bool(cnn_layers),
        "cnn_param": {"layer": [[ch, k, st, pad, None]
                                for ch, k, st, pad in cnn_layers],
                      "batch_norm": True, "activativate_function": act_cls},
        "num_class": num_class, "_drop_out": 0.0,
        "epoch": 3, "loss_results": [3.5, 2.5, 2.0],
        "dev_loss_results": [3.0, 2.4, 2.2],
        "dev_cer_results": [80.0, 60.0, 55.0],
        "state_dict": model.state_dict(), "module": model,
    }


def phase_decode_slice():
    """Stage 4 of the flagship recipe through the port's entry points."""
    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.vocab import Vocab

    write_corpus(WORK / "data", "test", N_DECODE_UTTS, seed=0)
    cfg = recipe_config()
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    check(spec.compute_dtype == "bfloat16" and spec.rnn_layers == 4
          and spec.rnn_hidden_size == 384 and spec.add_cnn
          and spec.rnn_cell == "lstm", f"recipe is not the flagship: {spec}")
    model = seeded_model(spec)
    launches = decode_slice(cfg, spec, model, "lstm_bidir", N_DECODE_UTTS,
                            "flagship")
    return launches, spec, model


def batch_tensors(batch):
    """A ``Batch`` (host arrays, or tensors from the device loaders) as the
    train step's tensors on the card."""
    import torch

    return tuple(torch.as_tensor(a).cuda() for a in (
        batch.feats, batch.input_frac, batch.labels, batch.label_lengths,
        batch.example_mask))


def train_slice(cfg, spec, cell: str, n_test_utts: int,
                branches_out: dict = None) -> dict:
    """Stage 2 through ``Trainer.fit`` for one epoch, the saved package
    through ``cli.test.evaluate``, then two fp32 optimizer steps through the
    kernels and through the plain twins.  ``cell`` names the recurrence
    kernels the model must launch.  Returns the launch counts over the fit;
    its launches by op and branch go to ``branches_out["fit"]``."""
    import torch

    from ctc_pytorch_tpu_torch.cli.test import evaluate
    from ctc_pytorch_tpu_torch.cli.train import build_loaders
    from ctc_pytorch_tpu_torch.train.loop import Trainer, forward_loss, train_step
    from ctc_pytorch_tpu_torch.train.state import (
        create_train_state,
        restore,
        snapshot,
    )
    from ctc_pytorch_tpu_torch.vocab import Vocab

    from ctc_pytorch_tpu_torch.data import DeviceCachedLoader

    train_loader, dev_loader = build_loaders(cfg, Vocab(cfg.vocab_file),
                                             device="cuda")
    check(isinstance(train_loader, DeviceCachedLoader)
          and isinstance(dev_loader, DeviceCachedLoader),
          "stage 2 built no device cache for a corpus within its budget")
    trainer = Trainer(cfg, spec, device="cuda")
    model = trainer.state.model
    train_loader.set_epoch(1)
    probe = batch_tensors(next(iter(train_loader)))

    def probe_loss() -> float:
        # train-mode loss (batch statistics, dropout set to 0) with no update:
        # the BN buffers the forward moves are put back
        snap = snapshot(trainer.state)
        model.spec = dataclasses.replace(spec, drop_out=0.0)
        try:
            with torch.no_grad():
                loss, _, _ = forward_loss(trainer.state, spec, *probe, True, None)
        finally:
            model.spec = spec
        restore(trainer.state, snap)
        return loss.item()

    loss_before = probe_loss()
    lines = []
    zero_counts()
    t0 = time.perf_counter()
    best = trainer.fit(train_loader, dev_loader, num_epoches=1, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    branches = check_cluster_branches("Trainer.fit")
    if branches_out is not None:
        branches_out["fit"] = branches
    steps, dev_batches = trainer.state.step, len(dev_loader)
    loss_after = probe_loss()
    for ln in lines:
        print("  " + ln)
    graphs = trainer.graphs()
    print(f"  Trainer.fit, 1 epoch: {steps} optimizer steps, {dev_batches} dev "
          f"batches, wall {wall:.3f} s (with the captures); launches {counts}, "
          f"forward branches {branches}, calls into ops/stacked.py "
          f"{stacked_calls()}")
    print(f"  fused epoch (fused_dispatch {cfg.fused_dispatch!r}): "
          f"{graphs.replays()} graph replays, {len(graphs)} captured graphs in "
          f"{graphs.capture_seconds:.3f} s, graph pool {graphs.pool_bytes()} "
          f"bytes")
    print(f"  loss on one train batch (train mode, no dropout): "
          f"{loss_before:.4f} before the epoch, {loss_after:.4f} after")
    check(steps >= 8, f"only {steps} optimizer steps")
    # eval passes compute their loss: the dev pass and, with dev_over_train,
    # one more pass over the training set
    eval_batches = dev_batches + (steps if cfg.dev_over_train else 0)
    # every pass ran from graphs: one replay a batch, no eager step
    check(any(ln.startswith("fused_epoch: the epochs run over the device "
                            "cache") and "one captured CUDA graph replay per "
              "batch" in ln for ln in lines),
          "Trainer.fit did not take the fused path")
    check(graphs.replays() == steps + eval_batches,
          f"{graphs.replays()} graph replays for {steps} steps and "
          f"{eval_batches} eval batches")
    n = spec.rnn_layers
    check_counts(counts, {f"{cell}_bidir_train_fwd": n * steps,
                          f"{cell}_bidir_train_bwd": n * steps,
                          "ctc_alpha": steps + eval_batches, "ctc_beta": steps,
                          f"{cell}_bidir": n * eval_batches,
                          **epilogue_want(spec, eval_batches, steps)},
                 "Trainer.fit")
    if cell == "lstm" and cfg.batch_size % 16 != 0:  # fp32 streams
        train_ops = port_ops()[1]
        check_fp32_bwd_branch("Trainer.fit", train_ops.launches_bwd_branch,
                              n * steps, "LSTM",
                              train_ops.launches_bwd_prepass_tf32)
    if cfg.dev_over_train:
        check(any(ln.startswith("cer on training set is ") for ln in lines)
              and len(trainer.histories["training_cer_results"]) == 1,
              "dev_over_train ran no pass over the training set")
    check(trainer.scheduler.mode == cfg.scheduler_mode, "wrong scheduler mode")
    check(math.isfinite(loss_before) and math.isfinite(loss_after),
          "non-finite loss")
    check(loss_after < loss_before, "the loss did not fall over the epoch")
    check(int(model.fc_bn.count) == steps and int(model.rnns[1].bn.count) == steps,
          f"BN count {int(model.fc_bn.count)} after {steps} steps")
    check(all(torch.isfinite(p).all().item() for p in model.state_dict().values()),
          "non-finite parameter or BN buffer after training")
    check(best.exists() and best.name == "ctc_best_model.npz",
          f"no best package at {best}")
    res = evaluate(cfg, str(best), device="cuda", log=lines.append)
    decoded = [ln for ln in lines if ln.startswith("decoded: ")]
    print(f"  the saved package decodes: {len(decoded)} utts in "
          f"{res['batches']} batches, PER {res['wer']:.4f}")
    check(len(decoded) == n_test_utts and math.isfinite(res["wer"]),
          "the trained package does not decode")

    # two fp32 optimizer steps from one init: kernels against plain twins
    spec32 = dataclasses.replace(spec, compute_dtype="float32", drop_out=0.0)

    def two_steps():
        state = create_train_state(spec32, cfg.init_lr, cfg.weight_decay,
                                   cfg.grad_clip, seed=cfg.seed, device="cuda")
        losses = [train_step(state, spec32, *probe)[0].item() for _ in range(2)]
        return losses, {k: v.detach().clone()
                        for k, v in state.model.state_dict().items()}

    zero_counts()
    k_losses, k_sd = two_steps()
    check_counts(launch_counts(), {f"{cell}_bidir_train_fwd": 2 * n,
                                   f"{cell}_bidir_train_bwd": 2 * n,
                                   "ctc_alpha": 2, "ctc_beta": 2,
                                   **epilogue_want(spec32, 0, 2)},
                 "two fp32 steps")
    check_cluster_branches("two fp32 steps")  # the tanh backward's too
    if cell in ("lstm", "gru"):
        mod = port_ops()[1] if cell == "lstm" else port_gru_ops()[1]
        check_fp32_bwd_branch("two fp32 steps", mod.launches_bwd_branch, 2 * n,
                              cell.upper(), mod.launches_bwd_prepass_tf32)
    with plain_twins():
        p_losses, p_sd = two_steps()
    worst, worst_key, n_off, n_all = 0.0, "", 0, 0
    for k, v in p_sd.items():
        diff = (k_sd[k].float() - v.float()).abs()
        n_off += int((diff > STEP_TOL).sum())
        n_all += diff.numel()
        if diff.max().item() > worst:
            worst, worst_key = diff.max().item(), k
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    print(f"  two fp32 steps, kernels vs plain twins on the card: losses "
          f"{k_losses} vs {p_losses} (rel {rel:.3g}, tol {STEP_LOSS_RTOL}); "
          f"{n_off} of {n_all} parameter and BN entries differ by more than "
          f"{STEP_TOL}; largest difference {worst:.3g} at {worst_key}")
    check(rel <= STEP_LOSS_RTOL, "fp32 losses differ between kernels and twins")
    check(n_off <= STEP_OFF_SHARE * n_all and worst <= 2.01 * 2 * cfg.init_lr,
          "fp32 parameters differ between kernels and twins")
    return counts


def phase_train_slice(spec) -> dict:
    """Stage 2 of the flagship recipe; the kernels' launch counts over the
    fit."""
    write_corpus(WORK / "data", "train", N_TRAIN_UTTS, seed=1)
    write_corpus(WORK / "data", "dev", N_DEV_UTTS, seed=2)
    cfg = recipe_config()
    cfg.exp_name = "smoke_train"
    check(cfg.batch_size == 8 and cfg.dtype == "bfloat16" and cfg.drop_out > 0
          and cfg.scheduler_mode == "loss" and not cfg.dev_over_train,
          "the recipe is not the flagship's batch-8 bf16 training")
    return train_slice(cfg, spec, "lstm", N_DECODE_UTTS)


def phase_863_slice(smi: str):
    """The 863 recipe with the GRU cell at full width: one epoch of stage 2
    with the accuracy-keyed scheduler and ``dev_over_train``, the saved
    package decoded, and a seeded model decoded through kernels and twins;
    then the seeded package decoded with the beam decoders at width 20
    without an LM (``beam_decodes_agree``) and the fused ``BeamDevice``
    replay timed.  Returns
    ``(launch counts over the fit, decode launches, spec, model, the beam
    decodes' times)``."""
    from ctc_pytorch_tpu_torch.models import ModelSpec

    for split, n, seed in (("train", N_TRAIN_UTTS_863, 11),
                           ("dev", N_DEV_UTTS_863, 12)):
        write_corpus(WORK / "data863", split, n, seed=seed, dim=201,
                     units=UNITS_863, feats="spectrum", labels="text")
    cfg = recipe_config_863()
    cfg.exp_name = "smoke_863"
    # the class count as stage 2 takes it from an 863 config: num_class + blank
    spec = ModelSpec.from_config(cfg, num_class=cfg.num_class + 1)
    check(spec.rnn_cell == "gru" and spec.rnn_hidden_size == 256
          and spec.rnn_layers == 4 and spec.num_class == 67
          and spec.compute_dtype == "bfloat16" and spec.drop_out == 0
          and spec.cnn.channel == [(1, 16)] and spec.cnn.kernel_size == [(11, 5)]
          and spec.cnn.stride == [(2, 2)] and spec.cnn.padding == [(0, 0)]
          and spec.cnn.activation_function == "hardtanh"
          and spec.rnn_in_after_cnn == 99 * 16,
          f"recipe is not the 863 CNN+BiGRU(256): {spec}")
    check(cfg.batch_size == 16 and cfg.scheduler_mode == "acc"
          and cfg.dev_over_train and cfg.grad_clip == 400
          and cfg.weight_decay == 0.005, "not the 863 recipe's training setup")
    counts = train_slice(cfg, spec, "gru", N_DEV_UTTS_863)
    model = seeded_model(spec)
    decode_launches = decode_slice(cfg, spec, model, "gru_bidir",
                                   N_DEV_UTTS_863, "863_gru")
    # the batched beam decode of BASELINE config 4: width 20, no LM; a
    # capacity of the longest T' (200 at most) keeps BeamDevice exact
    cfg_beam = dataclasses.replace(cfg, beam_width=20, lm_path="",
                                   beam_max_len=200)
    pkg = WORK / "checkpoint" / f"863_gru_{spec.compute_dtype}.npz"
    beam = beam_decodes_agree(cfg_beam, pkg, N_DEV_UTTS_863, "gru_bidir",
                              spec.rnn_layers, "863", smi)
    beam.update(beam_device_times(cfg_beam, pkg, smi), device=smi)
    return counts, decode_launches + beam["launches"], spec, model, beam


def recipe_variant(rnn_type: str, bidirectional: bool, exp_name: str):
    """The flagship recipe with its ``rnn_type`` and ``bidirectional`` keys
    set as a user's ``--conf`` file would set them, on the synthetic TIMIT
    corpus of phases 4 and 5; ``(cfg, spec)``."""
    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.vocab import Vocab

    cfg = recipe_config()
    cfg.rnn_type, cfg.bidirectional, cfg.exp_name = (rnn_type, bidirectional,
                                                     exp_name)
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    check(spec.compute_dtype == "bfloat16" and spec.rnn_layers == 4
          and spec.rnn_hidden_size == 384 and spec.add_cnn
          and spec.rnn_input_size == 243
          and spec.cnn.channel == [(1, 32), (32, 32)]
          and spec.bidirectional == bidirectional and spec.batch_norm
          and cfg.batch_size == 8 and cfg.drop_out > 0,
          f"not the flagship recipe at full width: {spec}")
    return cfg, spec


def phase_tanh_slice():
    """The flagship recipe with ``rnn_type: nn.RNN`` (4 x BiRNN(384), tanh,
    bias-free) at full width: one epoch of stage 2, the saved package
    decoded, and a seeded model decoded through kernels and twins; every
    tanh launch of the fit and the decode (forward and backward) must take a
    cluster branch.  Returns ``(launch counts over the fit, decode launches,
    cfg, spec, model, launches by op and branch of the fit and the
    decode)``."""
    cfg, spec = recipe_variant("nn.RNN", True, "smoke_tanh")
    check(spec.rnn_cell == "rnn", f"rnn_type nn.RNN gave {spec.rnn_cell}")
    branches = {}
    counts = train_slice(cfg, spec, "rnn", N_DECODE_UTTS, branches)
    model = seeded_model(spec)
    decode_launches = decode_slice(cfg, spec, model, "rnn_bidir",
                                   N_DECODE_UTTS, "tanh", branches)
    took = merged_branches(branches)
    print(f"  tanh path, the fit and the decode: launches by branch {took}")
    check(set(took) == {"rnn_bidir", "rnn_bidir_train_fwd", "rnn_bidir_train_bwd"}
          and sum(took["rnn_bidir"].values()) == counts["rnn_bidir"] + decode_launches
          and sum(took["rnn_bidir_train_fwd"].values()) == counts["rnn_bidir_train_fwd"]
          and sum(took["rnn_bidir_train_bwd"].values()) == counts["rnn_bidir_train_bwd"],
          f"tanh path: launches by branch {took} against counts {counts}")
    return counts, decode_launches, cfg, spec, model, took


def merged_branches(runs: dict) -> dict:
    """``{op: {branch: launches}}`` summed over the runs of ``runs`` (each
    as ``check_cluster_branches`` returns it)."""
    out: dict = {}
    for by_op in runs.values():
        for op, by in by_op.items():
            for k, v in by.items():
                out.setdefault(op, {})[k] = out.get(op, {}).get(k, 0) + v
    return out


def phase_unidir_slice():
    """The flagship recipe with ``bidirectional: False`` (4 x LSTM(384),
    forward only) at full width, as the tanh slice: every recurrence launch
    here is a one-direction launch of the LSTM kernels, since the model has
    no backward direction.  Returns ``(launch counts over the fit, decode
    launches, cfg, spec, model)``."""
    cfg, spec = recipe_variant("nn.LSTM", False, "smoke_unidir")
    model = seeded_model(spec)
    check(spec.rnn_cell == "lstm"
          and all(layer.bwd is None for layer in model.rnns)
          and model.fc.w.shape[0] == 384, "the model is not unidirectional")
    counts = train_slice(cfg, spec, "lstm", N_DECODE_UTTS)
    decode_launches = decode_slice(cfg, spec, model, "lstm_bidir",
                                   N_DECODE_UTTS, "unidir")
    return counts, decode_launches, cfg, spec, model


def stage4_run(cfg, package, decode_type: str, fused: bool = True,
               device: str = "cuda", **keys):
    """Stage 4 of ``package`` through ``cli.test.evaluate`` on ``device``
    with ``decode_type`` (and any other config ``keys``): ``(result with its wall
    seconds, {utterance: decoded line}, the launches since the call
    began)``."""
    from ctc_pytorch_tpu_torch.cli.test import evaluate

    run_cfg = dataclasses.replace(cfg, decode_type=decode_type,
                                  fused_decode=fused, **keys)
    lines = []
    zero_counts()
    t0 = time.perf_counter()
    res = evaluate(run_cfg, str(package), device=device, log=lines.append)
    sync()
    res["wall_s"] = time.perf_counter() - t0
    counts = launch_counts()
    decoded = {u: d for u, d in zip(lines[0::3], lines[2::3])
               if d.startswith("decoded: ")}
    return res, decoded, counts


def beam_decodes_agree(cfg, package, n_utts: int, eval_kernel: str, layers: int,
                       what: str, smi: str) -> dict:
    """Stage 4 of ``package`` with the greedy decoder (fused) and with the
    three beam decoders: ``Beam`` on the host, ``BeamDevice`` from graphs
    over the device cache and ``BeamDevice`` streaming.  The two
    ``BeamDevice`` runs must give the same strings, CER and WER.  ``Beam``
    sums its scores in double and ``BeamDevice`` in float32, as in the JAX
    package, so where float32 rounding ties two prefixes they may keep
    different ones: ``Beam``'s strings must be those of the batched search
    run in float64 on the card, and how many of them the float32 search
    gives is printed.  Every run launches ``eval_kernel`` ``layers`` times a
    batch and no other kernel.  ``BeamDevice`` keeps ``beam_max_len`` tokens
    a hypothesis and drops the longer ones (with a warning), where ``Beam``
    has no bound: ``cfg``'s capacity must exceed every hypothesis, which is
    checked.  Returns each run's wall time and the launches of all four."""
    from ctc_pytorch_tpu_torch import native

    t0 = time.perf_counter()
    native.load()  # the host search's library, built before the timed runs
    print(f"  native beam search built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    runs, launched = {}, 0
    for name, decode_type, fused in (("greedy fused", "Greedy", True),
                                     ("Beam", "Beam", True),
                                     ("BeamDevice fused", "BeamDevice", True),
                                     ("BeamDevice streaming", "BeamDevice",
                                      False)):
        res, decoded, counts = stage4_run(cfg, package, decode_type, fused)
        check(len(decoded) == n_utts,
              f"{what} {name}: decoded {len(decoded)} of {n_utts} utterances")
        check(bool(res.get("fused")) == (fused and decode_type != "Beam"),
              f"{what} {name}: took the wrong stage-4 path")
        check_counts(counts, {eval_kernel: layers * res["batches"],
                              **epilogue_want(cfg, res["batches"])},
                     f"{what} {name}")
        launched += counts[eval_kernel]
        runs[name] = (res, decoded)
        extra = (f", {res['graphs']} graphs captured in "
                 f"{res['capture_seconds']:.3f} s, pool {res['pool_bytes']} "
                 f"bytes" if res.get("fused") else "")
        print(f"  {what} stage 4 {name}: {n_utts} utts in {res['batches']} "
              f"batches, wall {res['wall_s']:.4f} s "
              f"({n_utts / res['wall_s']:.1f} utts/s){extra}; CER "
              f"{res['cer']:.4f} WER {res['wer']:.4f} ({smi})")
    beam = runs["Beam"]
    tokens = [len(d.split()) - 1 for d in beam[1].values()]
    print(f"  {what} Beam hypotheses: {sum(tokens)} tokens, the longest "
          f"{max(tokens)} (BeamDevice capacity {cfg.beam_max_len})")
    check(max(tokens) < cfg.beam_max_len,
          f"{what}: a hypothesis of {max(tokens)} tokens does not fit "
          f"beam_max_len {cfg.beam_max_len}")
    check(sum(tokens) > 0, f"{what}: every beam hypothesis is empty")
    fused, streamed = runs["BeamDevice fused"], runs["BeamDevice streaming"]
    same = sum(fused[1][u] == d for u, d in streamed[1].items())
    print(f"  {what} BeamDevice fused vs streaming: {same}/{n_utts} strings "
          f"equal, CER {fused[0]['cer']:.4f} vs {streamed[0]['cer']:.4f}")
    check(fused[1] == streamed[1] and fused[0]["cer"] == streamed[0]["cer"]
          and fused[0]["wer"] == streamed[0]["wer"],
          f"{what}: fused and streaming BeamDevice decode differently")
    # Beam sums in double on the host, BeamDevice in float32 (as in the JAX
    # package): the batched search in float64 must give Beam's strings, and
    # the float32 search may part from them only where float32 rounding
    # ties two prefixes
    decoded64 = float64_search_strings(cfg, package)
    same64 = sum(decoded64.get(u) == d for u, d in beam[1].items())
    same32 = sum(fused[1][u] == d for u, d in beam[1].items())
    print(f"  {what} Beam (host, double) vs the batched search in float64 on "
          f"the card: {same64}/{n_utts} strings equal; vs BeamDevice (float32): "
          f"{same32}/{n_utts}, CER {beam[0]['cer']:.4f} vs "
          f"{fused[0]['cer']:.4f}, WER {beam[0]['wer']:.4f} vs "
          f"{fused[0]['wer']:.4f}")
    check(decoded64 == beam[1],
          f"{what}: Beam and the float64 batched search decode differently")
    check(not any(d.startswith("decoded:  ") for d in beam[1].values()),
          f"{what}: a beam string has a leading space")
    return {"launches": launched,
            "wall_s": {k: r["wall_s"] for k, (r, _) in runs.items()},
            "utts": n_utts, "beamdevice_equal_beam": same32,
            "float64_equal_beam": same64,
            "capture_s": {k: r["capture_seconds"] for k, (r, _) in runs.items()
                          if r.get("fused")},
            "pool_bytes": {k: r["pool_bytes"] for k, (r, _) in runs.items()
                           if r.get("fused")}}


def float64_search_strings(cfg, package) -> dict:
    """``{utterance: decoded line}`` of ``package``'s test set: the
    streaming stage 4's forward on the card, the probabilities made on the
    host as ``Beam`` makes them, then the batched search in float64 on the
    card."""
    import numpy as np
    import torch

    from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset
    from ctc_pytorch_tpu_torch.decode import BeamDecoder
    from ctc_pytorch_tpu_torch.decode.beam_device import batched_beam_search
    from ctc_pytorch_tpu_torch.models import CTCModel
    from ctc_pytorch_tpu_torch.train.checkpoint import model_from_package
    from ctc_pytorch_tpu_torch.vocab import Vocab

    vocab = Vocab(cfg.vocab_file)
    spec, model, _ = model_from_package(package, "cuda")
    decoder = BeamDecoder(vocab.index2word, beam_width=cfg.beam_width,
                          lm_path=cfg.lm_path or None, lm_alpha=cfg.lm_alpha)
    lm = decoder.lm_on(torch.device("cuda"))
    ds = SpeechDataset(vocab, cfg.test_scp_path, cfg.test_lab_path, cfg)
    out = {}
    with torch.inference_mode():
        for batch in SpeechDataLoader(ds, cfg.batch_size, shuffle=False,
                                      num_buckets=cfg.num_buckets,
                                      mode=cfg.batch_mode):
            feats = torch.from_numpy(batch.feats).cuda()
            frac = torch.from_numpy(batch.input_frac).cuda()
            log_probs = model(feats, frac=frac)
            sizes = CTCModel.input_sizes(spec, frac, feats.shape[1],
                                         log_probs.shape[0])
            probs = np.exp(log_probs.float().cpu().numpy()).transpose(1, 0, 2)
            seqs, lens, _ = batched_beam_search(
                torch.from_numpy(probs).double().cuda(), sizes,
                beam_width=decoder.beam_width, max_len=cfg.beam_max_len,
                lm_table=lm, lm_alpha=decoder.lm_alpha)
            seqs, lens = seqs.cpu().numpy(), lens.cpu().numpy()
            for i, utt in enumerate(batch.utts):
                if batch.example_mask[i]:
                    out[utt] = f"decoded: {decoder.string(seqs[i], lens[i])}"
    return out


def beam_device_times(cfg, package, smi: str) -> dict:
    """The fused ``BeamDevice`` decode of one test batch, timed: the
    replay of its captured graph (forward and search) against the greedy
    graph's (forward, argmax and collapse), the kernels a replay holds (one
    eager search under ``torch.profiler``, per frame), the capture's time and
    pool bytes; and the host ``Beam`` search of the same batch, ms an
    utterance (with the log-probs' copy to the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctc_pytorch_tpu_torch.data import (
        DeviceCachedLoader,
        SpeechDataLoader,
        SpeechDataset,
    )
    from ctc_pytorch_tpu_torch.decode import BeamDecoder
    from ctc_pytorch_tpu_torch.decode.beam_device import batched_beam_search
    from ctc_pytorch_tpu_torch.decode.fused import make_fused_decode_fn
    from ctc_pytorch_tpu_torch.models import CTCModel
    from ctc_pytorch_tpu_torch.train.checkpoint import model_from_package
    from ctc_pytorch_tpu_torch.vocab import Vocab

    vocab = Vocab(cfg.vocab_file)
    spec, model, _ = model_from_package(package, "cuda")
    ds = SpeechDataset(vocab, cfg.test_scp_path, cfg.test_lab_path, cfg)
    ds.preload(cfg.num_workers)
    cached = DeviceCachedLoader(SpeechDataLoader(
        ds, cfg.batch_size, shuffle=False, num_buckets=cfg.num_buckets,
        mode=cfg.batch_mode), "cuda")
    decoder = BeamDecoder(vocab.index2word, beam_width=cfg.beam_width,
                          lm_path=cfg.lm_path or None, lm_alpha=cfg.lm_alpha)
    lm = decoder.lm_on(torch.device("cuda"))
    # the longest group: its first batch
    arrs, pos, _, t_pad = max(cached.epoch_groups(0), key=lambda g: g[3])
    pos = pos[:1]
    out = {"t_pad": int(t_pad)}
    graphs = {}
    for mode in ("greedy", "beam"):
        fused = make_fused_decode_fn(
            spec, model, mode=mode, beam_width=decoder.beam_width,
            beam_max_len=cfg.beam_max_len, lm_table=lm,
            lm_alpha=decoder.lm_alpha)
        fused(arrs, pos, t_pad)  # captures
        cap = next(iter(fused.graphs.graphs.values()))
        graphs[mode] = fused.graphs
        out[f"{mode}_replay_ms"] = cuda_ms(cap.graph.replay, reps=5)
    out["capture_s"] = graphs["beam"].capture_seconds
    out["pool_bytes"] = graphs["beam"].pool_bytes()

    feats, frac = (t.cuda() for t in gather_batch(arrs, pos[0], t_pad))
    with torch.no_grad():
        log_probs = model(feats, frac=frac, train=False)
        sizes = CTCModel.input_sizes(spec, frac, t_pad, log_probs.shape[0])
    probs = torch.exp(log_probs).transpose(0, 1)

    def search():
        return batched_beam_search(
            probs, sizes, beam_width=decoder.beam_width,
            max_len=cfg.beam_max_len, lm_table=lm, lm_alpha=decoder.lm_alpha)

    search()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        search()
        torch.cuda.synchronize()
    kernels = sum(1 for ev in prof.events() if device_activity(ev))
    t_out = log_probs.shape[0]
    out.update(kernels_per_replay=kernels, frames=t_out,
               kernels_per_frame=kernels / t_out,
               eager_search_ms=cuda_ms(search, reps=3))
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        decoder.decode(log_probs, sizes)
        host.append(time.perf_counter() - t0)
    n_valid = int(sizes.shape[0])
    out["beam_host_ms_per_utt"] = statistics.median(host) * 1e3 / n_valid
    out["frames_per_utt"] = float(sizes.float().mean())
    print(f"  BeamDevice at T'={t_out}, B={n_valid}, width "
          f"{decoder.beam_width}, beam_max_len {cfg.beam_max_len}: graph "
          f"replay {out['beam_replay_ms']:.3f} ms (forward, search) against "
          f"{out['greedy_replay_ms']:.3f} ms greedy (forward, collapse); "
          f"{kernels} kernels a search ({kernels / t_out:.1f} a frame x "
          f"{t_out} frames); eager search {out['eager_search_ms']:.3f} ms; "
          f"capture {out['capture_s']:.3f} s, pool {out['pool_bytes']} bytes "
          f"({smi})")
    print(f"  Beam on the host, the same batch: "
          f"{out['beam_host_ms_per_utt']:.3f} ms an utterance of "
          f"{out['frames_per_utt']:.1f} frames on average, with the copy of "
          f"the log-probs ({smi})")
    return out


def gather_batch(arrs, pos, t_pad: int):
    """``(feats, frac)`` of the cached rows ``pos``."""
    from ctc_pytorch_tpu_torch.data.batching import gather_rows

    import torch

    return gather_rows(arrs, torch.as_tensor(pos).cuda(), t_pad)[:2]


def phase_mfcc39_slice(smi: str) -> dict:
    """The ``mfcc_39`` recipe as shipped (39-d MFCC, no CNN, 4 x
    BiLSTM(256), 41 classes, bf16, batch 8, fused epoch dispatched once an
    epoch, ``Beam`` width 20 with the bigram LM at 0.1) on a synthetic
    39-d corpus: stage 3 on the training transcripts; one epoch of stage 2
    through ``build_loaders`` and ``Trainer.fit`` (train_slice's checks:
    the LSTM and CTC kernels' launches, graph replays, the loss falling, two
    fp32 steps through kernels and twins); stage 4 of the saved package
    with ``Beam``, fused ``BeamDevice`` and streaming ``BeamDevice``
    (``beam_decodes_agree``), an fp32 package through kernels and twins
    with ``BeamDevice`` (equal strings), the batched search on the card
    against the CPU on the same probabilities, and the times.  Returns the fit's launch counts,
    the stage-4 launches of the eval kernel and the times."""
    import torch

    from ctc_pytorch_tpu_torch.cli import train_lm
    from ctc_pytorch_tpu_torch.decode import BeamDecoder
    from ctc_pytorch_tpu_torch.decode.beam_device import batched_beam_search
    from ctc_pytorch_tpu_torch.models import CTCModel, ModelSpec
    from ctc_pytorch_tpu_torch.train.checkpoint import (
        model_from_package,
        save_package,
    )
    from ctc_pytorch_tpu_torch.vocab import Vocab

    root = WORK / "data_mfcc"
    for split, n, seed in (("train", N_TRAIN_UTTS, 21), ("dev", N_DEV_UTTS, 22),
                           ("test", N_DECODE_UTTS, 23)):
        write_corpus(root, split, n, seed=seed, dim=39, feats="mfcc")
    cfg = recipe_config(RECIPE_MFCC, "data_mfcc", "mfcc")
    cfg.exp_name = "smoke_mfcc39"
    cfg.lm_path = str(root / "lm_phone_bg.arpa")
    # a model after one epoch on random features emits a label at most
    # frames: a capacity of T' (at most 400 frames, no downsampling) keeps
    # BeamDevice exact where the default 96 would truncate
    cfg.beam_max_len = 400
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    check(not spec.add_cnn and spec.rnn_cell == "lstm" and spec.bidirectional
          and spec.rnn_hidden_size == 256 and spec.rnn_layers == 4
          and spec.rnn_input_size == 39 and spec.num_class == 41
          and spec.compute_dtype == "bfloat16" and spec.drop_out == 0.2,
          f"recipe is not the mfcc_39 4 x BiLSTM(256): {spec}")
    check(cfg.batch_size == 8 and cfg.n_downsample == 1 and cfg.n_skip_frame == 1
          and cfg.fused_epoch and cfg.fused_dispatch == "epoch"
          and cfg.decode_type == "Beam" and cfg.beam_width == 20
          and cfg.lm_alpha == 0.1, "not the mfcc_39 recipe's stages 2 and 4")

    t0 = time.perf_counter()
    arpa = train_lm.main([str(root)])
    check(arpa == Path(cfg.lm_path) and arpa.stat().st_size > 0,
          f"stage 3 wrote {arpa}, not {cfg.lm_path}")
    print(f"  stage 3: {arpa.name}, {arpa.stat().st_size} bytes in "
          f"{time.perf_counter() - t0:.3f} s")

    counts = train_slice(cfg, spec, "lstm", N_DECODE_UTTS)
    best = WORK / "checkpoint" / cfg.exp_name / "ctc_best_model.npz"
    check(best.exists(), f"no package at {best}")
    agree = beam_decodes_agree(cfg, best, N_DECODE_UTTS, "lstm_bidir",
                               spec.rnn_layers, "mfcc_39", smi)
    times = beam_device_times(cfg, best, smi)

    # fp32: BeamDevice through the kernels and through the twins
    spec_b, model, _ = model_from_package(best, "cuda")
    spec32 = dataclasses.replace(spec_b, compute_dtype="float32")
    pkg32 = WORK / "checkpoint" / "mfcc39_fp32.npz"
    save_package(pkg32, spec32, model, config=cfg)
    res_k, dec_k, counts_k = stage4_run(cfg, pkg32, "BeamDevice")
    check_counts(counts_k, {"lstm_bidir": spec.rnn_layers * res_k["batches"]},
                 "mfcc_39 fp32 BeamDevice")
    check_cluster_branches("mfcc_39 fp32 BeamDevice")
    zero_counts()  # stage4_run zeroes them, and the twins must launch none
    with plain_twins():
        res_p, dec_p, _ = stage4_run(cfg, pkg32, "BeamDevice")
    same = sum(dec_k[u] == d for u, d in dec_p.items())
    print(f"  fp32 BeamDevice, kernels vs plain twins on the card: "
          f"{same}/{len(dec_k)} strings equal, WER {res_k['wer']:.4f} vs "
          f"{res_p['wer']:.4f}")
    check(dec_k == dec_p and len(dec_k) == N_DECODE_UTTS,
          "fp32 kernel and plain paths beam-decode differently")

    # the batched search on the card and on the CPU, same inputs
    vocab = Vocab(cfg.vocab_file)
    decoder = BeamDecoder(vocab.index2word, beam_width=cfg.beam_width,
                          lm_path=cfg.lm_path, lm_alpha=cfg.lm_alpha)
    spec32, model32, _ = model_from_package(pkg32, "cuda")
    from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset

    ds = SpeechDataset(vocab, cfg.test_scp_path, cfg.test_lab_path, cfg)
    batch = next(iter(SpeechDataLoader(ds, cfg.batch_size, shuffle=False,
                                       num_buckets=cfg.num_buckets,
                                       mode=cfg.batch_mode)))
    feats = torch.from_numpy(batch.feats).cuda()
    frac = torch.from_numpy(batch.input_frac).cuda()
    with torch.no_grad():
        log_probs = model32(feats, frac=frac, train=False)
    sizes = CTCModel.input_sizes(spec32, frac, feats.shape[1],
                                 log_probs.shape[0])
    probs = torch.exp(log_probs).transpose(0, 1).contiguous()
    kw = dict(beam_width=cfg.beam_width, max_len=cfg.beam_max_len,
              lm_alpha=cfg.lm_alpha)
    on_card = batched_beam_search(probs, sizes,
                                  lm_table=decoder.lm_on(probs.device), **kw)
    on_cpu = batched_beam_search(probs.cpu(), sizes.cpu(),
                                 lm_table=decoder.lm_on(torch.device("cpu")),
                                 **kw)
    rel = ((on_card[2].cpu() - on_cpu[2]).abs() / on_cpu[2].abs()).max().item()
    n_tok = int(on_cpu[1].sum())
    print(f"  batched_beam_search on the card vs the CPU (B={probs.shape[0]}, "
          f"T'={probs.shape[1]}, C={probs.shape[2]}, width {cfg.beam_width}, "
          f"LM): tokens equal {torch.equal(on_card[0].cpu(), on_cpu[0])}, "
          f"lengths equal {torch.equal(on_card[1].cpu(), on_cpu[1])} "
          f"({n_tok} tokens), scores rel {rel:.3g} (tol 1e-5)")
    check(torch.equal(on_card[0].cpu(), on_cpu[0])
          and torch.equal(on_card[1].cpu(), on_cpu[1]) and rel <= 1e-5,
          "batched_beam_search differs between the card and the CPU")
    # the model's forward and train step at the recipe's batch, the corpus's
    # longest utterance (400 frames, T' = 400) and 33 labels
    step = times_model(cfg, spec, seeded_model(spec), 8, 400, 33,
                       "mfcc_39 4 x BiLSTM(256)", "recipe batch")
    return {"counts": counts, "decode_launches": agree["launches"],
            "spec": spec, "beam": {**agree, **times, "device": smi},
            "model": {**step, "device": smi}}


def feature_err(card, cpu, what: str) -> float:
    """Largest difference of features on the card and on the CPU, held to
    ``FEAT_TOL`` (the failure names the worst entry)."""
    import numpy as np

    card, cpu = card.cpu().numpy(), cpu.cpu().numpy()
    diff = np.abs(card - cpu)
    worst = np.unravel_index(diff.argmax(), diff.shape) if diff.size else ()
    check(np.allclose(card, cpu, **FEAT_TOL),
          f"{what}: the frontend differs between the card and the CPU, by "
          f"{diff.max():.3g} at {worst} ({card[worst]} vs {cpu[worst]})")
    return float(diff.max()) if diff.size else 0.0


def path_branches() -> dict:
    """The launches by branch of the waveform path's kernels since
    ``zero_counts``: ``{op: {branch: launches}}``, branches launched only."""
    lstm_ops, train_ops, ctc_ops = port_ops()
    return {op: {k: v for k, v in by.items() if v} for op, by in (
        ("lstm_bidir", lstm_ops.launches_fwd_branch),
        ("lstm_bidir_train_fwd", train_ops.launches_fwd_branch),
        ("lstm_bidir_train_bwd", train_ops.launches_bwd_branch),
        ("ctc_alpha", ctc_ops.launches_fwd_branch),
        ("ctc_beta", ctc_ops.launches_bwd_branch)) if any(by.values())}


def added(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}


def phase_waveform_slice(smi: str, device: str = "cuda") -> dict:
    """``recipes/timit/waveform_config.yaml`` as shipped (fbank 80 mel +
    energy computed in the step, spliced to 243, no CNN, 4 x BiLSTM(384),
    bf16, batch 128, device cache, one graphed epoch dispatched once) on a
    synthetic corpus of SPHERE and WAV files (``WAVE_SPLITS``), through the
    port's entry points: stage 1 (``cli.make_feat`` on the card; 16
    utterances' fbank, mfcc + deltas and spectrogram held against the CPU),
    stage 3, stage 2 (``cli.train.train``, one fused epoch), stage 4 of the
    test split with ``Greedy`` and ``BeamDevice`` (streaming, as the JAX
    stage 4 for a waveform package), ``Recognizer`` on 16 test files and
    ``StreamingRecognizer`` over one stream.  The launches of every LSTM and
    CTC kernel over these runs, with the branch each took.  Then the epoch
    graphed against streaming (``phase_fused_vs_streaming``) and the train
    step's device time with the frontend's share.  ``device="cpu"``
    rehearses the phase on a cut recipe (``RECIPE_WAVE`` pointed elsewhere):
    the runners run eagerly, and what only the card has (the recipe's
    width, kernel launches and branches, times) is not checked."""
    import numpy as np
    import torch

    from ctc_pytorch_tpu_torch.api import Recognizer, StreamingRecognizer
    from ctc_pytorch_tpu_torch.cli import make_feat, train_lm
    from ctc_pytorch_tpu_torch.cli import train as cli_train
    from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset
    from ctc_pytorch_tpu_torch.data.kaldi_io import iter_ark, read_scp
    from ctc_pytorch_tpu_torch.data.prep.sphere import read_audio
    from ctc_pytorch_tpu_torch.frontend import (
        FrontendConfig,
        features,
        num_frames,
    )
    from ctc_pytorch_tpu_torch.frontend.e2e import (
        cmvn_from_config,
        frontend_fn_from_config,
        spec_from_config,
    )
    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.train.checkpoint import (
        model_from_package,
        save_package,
    )
    from ctc_pytorch_tpu_torch.train.loop import train_step
    from ctc_pytorch_tpu_torch.train.state import create_train_state
    from ctc_pytorch_tpu_torch.vocab import Vocab

    root = WORK / "data_wave"
    audio = {split: write_audio_corpus(root, split, n, seed)
             for split, n, seed in WAVE_SPLITS}
    n_utts = sum(n for _, n, _ in WAVE_SPLITS)
    print(f"  corpus: {n_utts} utterances of 1-4 s, "
          f"{sum(audio.values()) / 16000 / 60:.1f} minutes of audio, SPHERE "
          f"and WAV ({', '.join(f'{s} {n}' for s, n, _ in WAVE_SPLITS)})")
    cfg = recipe_config(RECIPE_WAVE, "data_wave", "wav")
    cfg.data_dir, cfg.exp_name = str(root), "smoke_waveform"
    cfg.lm_path = str(root / "lm_phone_bg.arpa")
    vocab = Vocab(cfg.vocab_file)
    spec = ModelSpec.from_config(cfg, num_class=vocab.n_words)
    on_card = device == "cuda"
    check(cfg.feature_type == "waveform" and not spec.add_cnn
          and spec.rnn_cell == "lstm" and spec.bidirectional
          and cfg.device_cache and cfg.fused_epoch
          and cfg.fused_dispatch == "epoch" and cfg.host_prefetch
          and cfg.decode_type == "BeamDevice" and cfg.beam_width == 20
          and cfg.lm_alpha == 0.1, "not the waveform recipe's stages 2 and 4")
    check(not on_card or (
        spec.rnn_hidden_size == 384 and spec.rnn_layers == 4
        and spec.rnn_input_size == 243 and spec.num_class == 41
        and spec.compute_dtype == "bfloat16" and spec.drop_out == 0.2
        and cfg.batch_size == 128),
          f"recipe is not the waveform 4 x BiLSTM(384) at B=128: {spec}")

    # stage 1 on the card, then the same function on the CPU
    t0 = time.perf_counter()
    make_feat.main(["fbank", str(root), "--device", device])
    stage1_s = time.perf_counter() - t0
    cmvn = cmvn_from_config(cfg)
    check(cmvn is not None and cmvn[0].shape == (81,)
          and all(len(dict(iter_ark(root / s / "fbank.ark"))) == n
                  for s, n, _ in WAVE_SPLITS), "stage 1 wrote no features")
    print(f"  stage 1 (fbank 80 mel + energy, CMVN on train) on {device}: "
          f"{stage1_s:.3f} s for {n_utts} utterances "
          f"({n_utts / stage1_s:.1f} utts/s, "
          f"{sum(audio.values()) / 16000 / stage1_s:.1f} s of audio a "
          f"second), {smi}")
    fcfg = FrontendConfig()
    test_files = [path for _, path in read_scp(cfg.test_scp_path)]
    stage1_err = {}
    for feat_type, deltas in (("fbank", False), ("mfcc", True),
                              ("spectrogram", False)):
        worst = 0.0
        for path in test_files[:N_DECODE_UTTS]:
            padded, t = make_feat.padded_audio(read_audio(path), feat_type,
                                               fcfg)
            card, cpu = (make_feat.extract_features(
                padded, feat_type, fcfg, deltas, dev)[:t] for dev in
                (device, "cpu"))
            worst = max(worst, feature_err(card, cpu, feat_type))
        stage1_err[feat_type + ("+deltas" if deltas else "")] = worst
    print(f"  stage 1, card vs CPU on {N_DECODE_UTTS} utterances, largest "
          f"difference (tol atol {FEAT_TOL['atol']}, rtol "
          f"{FEAT_TOL['rtol']}): {stage1_err}")

    arpa = train_lm.main([str(root)])
    check(arpa == Path(cfg.lm_path) and arpa.stat().st_size > 0,
          f"stage 3 wrote {arpa}, not {cfg.lm_path}")

    # stage 2: one epoch of the recipe through the port's entry point
    lines = []
    zero_counts()
    t0 = time.perf_counter()
    trainer, best = cli_train.train(cfg, device=device, num_epoches=1,
                                    log=lines.append)
    sync()
    fit_s = time.perf_counter() - t0
    counts, branches = launch_counts(), {"fit": path_branches()}
    graphs = trainer.graphs()
    steps = trainer.state.step
    dev_batches = -(-WAVE_SPLITS[1][1] // cfg.batch_size)
    pool = graphs.pool_bytes() if on_card else 0
    for ln in lines:
        print("  " + ln)
    print(f"  stage 2 (cli.train.train, 1 epoch): {steps} steps of B="
          f"{cfg.batch_size} and {dev_batches} dev batch, {fit_s:.3f} s with "
          f"the loaders and captures; {graphs.replays()} replays of "
          f"{len(graphs)} graphs captured in {graphs.capture_seconds:.3f} s, "
          f"pool {pool} bytes; launches by branch "
          f"{branches['fit']}")
    check(any(ln.startswith("fused_epoch: the epochs run over the device "
                            "cache") for ln in lines),
          "the waveform fit did not take the fused path")
    n = spec.rnn_layers
    check(steps == -(-WAVE_SPLITS[0][1] // cfg.batch_size),
          f"{steps} steps for {WAVE_SPLITS[0][1]} utterances")
    if on_card:
        check(graphs.replays() == steps + dev_batches,
              f"{graphs.replays()} replays for {steps} steps")
        check_counts(counts, {"lstm_bidir_train_fwd": n * steps,
                              "lstm_bidir_train_bwd": n * steps,
                              "ctc_alpha": steps + dev_batches,
                              "ctc_beta": steps,
                              "lstm_bidir": n * dev_batches}, "waveform fit")
        took = branches["fit"]
        check(took["lstm_bidir_train_fwd"] == {"cluster32": n * steps},
              f"the training forward at B=128 did not take cluster32: {took}")
        check("grid" not in took["lstm_bidir_train_bwd"],
              f"the backward at B=128 took the grid: {took}")
        # the dev pass's eval forward, fp32 products at B = 64-128: no
        # cluster of 16 CTAs holds it, the wide branch does
        check(took["lstm_bidir"] == {"wide_fp32": n * dev_batches},
              f"the dev pass's eval forward did not take wide_fp32: {took}")
    check(all(math.isfinite(v) for v in trainer.histories["loss_results"]
              + trainer.histories["dev_loss_results"])
          and all(torch.isfinite(v).all().item()
                  for v in trainer.state.model.state_dict().values()),
          "non-finite loss or parameter after the waveform epoch")

    # stage 4, streaming (no fused waveform decode), capacity T'
    test_loader = SpeechDataLoader(
        SpeechDataset(vocab, cfg.test_scp_path, cfg.test_lab_path, cfg),
        cfg.batch_size, shuffle=False, num_buckets=cfg.num_buckets)
    batches = list(test_loader)
    t_prime = -(-num_frames(max(b.feats.shape[1] for b in batches),
                            fcfg.frame_length, fcfg.frame_shift)
                // cfg.n_skip_frame)
    t_prime += -t_prime % cfg.n_downsample
    stage4 = {}
    decoded = {}
    for decode_type in ("Greedy", "BeamDevice"):
        res, decoded[decode_type], c = stage4_run(
            cfg, best, decode_type, fused=True, device=device,
            beam_max_len=t_prime)
        branches[decode_type] = path_branches()
        counts = added(counts, c)
        check("fused" not in res and len(decoded[decode_type]) == len(
            test_files) and math.isfinite(res["wer"]),
              f"stage 4 {decode_type} did not stream every test utterance")
        if on_card:
            check_counts(c, {"lstm_bidir": n * res["batches"]},
                         f"stage 4 {decode_type}")
        stage4[decode_type] = {"wall_s": res["wall_s"], "wer": res["wer"],
                               "utts_per_s": len(test_files) / res["wall_s"]}
        print(f"  stage 4 {decode_type} (streaming, T' capacity {t_prime}): "
              f"{res['wall_s']:.3f} s for {len(test_files)} utterances "
              f"({stage4[decode_type]['utts_per_s']:.1f} utts/s), PER "
              f"{res['wer']:.4f}; eval forward branches "
              f"{branches[decode_type].get('lstm_bidir')}")

    # serving: Recognizer against stage 4's greedy strings
    def strings(lines_by_utt, utts):
        return [lines_by_utt[u][len("decoded:"):].strip() for u in utts]

    # the served files are the first stage-4 batch's, padded as it is
    utts = batches[0].utts[:N_DECODE_UTTS]
    t_pad = batches[0].feats.shape[1]
    check(utts == [u for u, _ in read_scp(cfg.test_scp_path)][:len(utts)],
          "the first stage-4 batch is not the first test files")
    spec_b, model_b, _ = model_from_package(best, device)
    pkg32 = WORK / "checkpoint" / "waveform_fp32.npz"
    save_package(pkg32, dataclasses.replace(spec_b, compute_dtype="float32"),
                 model_b, config=cfg)
    _, decoded32, c = stage4_run(cfg, pkg32, "Greedy", fused=True,
                                 device=device)
    counts = added(counts, c)
    branches["Greedy_fp32"] = path_branches()
    serving = {}
    for tag, pkg, want in (("fp32", pkg32, decoded32),
                           ("bf16", best, decoded["Greedy"])):
        zero_counts()
        rec = Recognizer(pkg, vocab, frontend=spec_from_config(cfg),
                         cmvn=cmvn, device=device)
        t0 = time.perf_counter()
        got = rec.recognize(test_files[:len(utts)], pad_multiple=t_pad)
        wall = time.perf_counter() - t0
        counts = added(counts, launch_counts())
        branches[f"recognizer_{tag}"] = path_branches()
        same = sum(a == b for a, b in zip(got, strings(want, utts)))
        serving[f"recognizer_{tag}"] = {"wall_s": wall, "equal": same}
        print(f"  Recognizer ({tag} package, greedy, B={len(got)}, padded "
              f"as stage 4): {wall:.3f} s; {same}/{len(got)} strings equal to "
              f"stage 4's greedy strings")
    # the fp32 package holds the strings: B=16 and stage 4's B=128 run the
    # eval forward on other branches, whose bf16 roundings differ
    check(serving["recognizer_fp32"]["equal"] == len(utts),
          "Recognizer and stage 4 decode the fp32 package differently")

    stream = np.concatenate([read_audio(p) for p in test_files])[
        :int(STREAM_SECONDS * 16000)]
    check(len(stream) == int(STREAM_SECONDS * 16000), "stream too short")
    zero_counts()
    sr = StreamingRecognizer(rec, hop_seconds=HOP_SECONDS)
    hop = int(HOP_SECONDS * 16000)
    lat, trace = [], []
    for start in range(0, len(stream), hop):
        t0 = time.perf_counter()
        sr.feed(stream[start:start + hop])
        lat.append(1e3 * (time.perf_counter() - t0))
        trace.append(list(sr._committed))
    t0 = time.perf_counter()
    final = sr.finish()
    finish_ms = 1e3 * (time.perf_counter() - t0)
    counts = added(counts, launch_counts())
    branches["streaming"] = path_branches()
    check(all(b[:len(a)] == a for a, b in zip(trace, trace[1:]))
          and final.split()[:len(trace[-1])] == trace[-1],
          "the streaming commits retracted a token")
    serving["streaming"] = {
        "feeds": len(lat), "feed_ms_median": statistics.median(lat),
        "feed_ms_max": max(lat), "finish_ms": finish_ms,
        "committed": len(trace[-1]), "final_tokens": len(final.split())}
    print(f"  StreamingRecognizer, {STREAM_SECONDS:.0f} s fed in "
          f"{HOP_SECONDS} s hops (bf16 package, window 10 s): {len(lat)} "
          f"feeds, latency median {serving['streaming']['feed_ms_median']:.2f}"
          f" ms, max {max(lat):.2f} ms, finish {finish_ms:.2f} ms; "
          f"{len(trace[-1])} tokens committed before finish, "
          f"{len(final.split())} after; the committed prefix only grew")
    took = merged_branches(branches)
    print(f"  waveform path launches {counts}; by branch {took}")
    check(not on_card or all(sum(took.get(op, {}).values()) == counts[op]
                             for op in ("lstm_bidir", "lstm_bidir_train_fwd",
                                        "lstm_bidir_train_bwd", "ctc_alpha",
                                        "ctc_beta")),
          "a launch of the waveform path has no branch recorded")

    # the epoch graphed against streaming, as phase 10
    frontend_fn = frontend_fn_from_config(cfg)
    versus = phase_fused_vs_streaming(cfg, spec, "waveform 4 x BiLSTM(384)",
                                      smi, device, frontend_fn)
    out = {"counts": counts, "branches": took, "device": smi,
           "corpus_utts": n_utts, "stage1_s": stage1_s,
           "stage1_utts_per_s": n_utts / stage1_s,
           "stage1_card_vs_cpu_err": stage1_err, "fit_s": fit_s,
           "steps": steps, "capture_s": graphs.capture_seconds,
           "pool_bytes": pool, "stage4": stage4, "serving": serving,
           "fused_vs_streaming": versus}
    if not on_card:
        return out

    # the train step's device time and the frontend's share of it, on the
    # longest bucket's batch
    host = SpeechDataLoader(
        SpeechDataset(vocab, cfg.train_scp_path, cfg.train_lab_path, cfg),
        cfg.batch_size, shuffle=False, num_buckets=cfg.num_buckets)
    batch = max(host, key=lambda b: b.feats.shape[1])
    feats, _, labels, lab_len, mask = batch_tensors(batch)
    frac = torch.as_tensor(batch.input_lengths).cuda().float()
    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, seed=cfg.seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        train_step(state, spec, feats, frac, labels, lab_len, mask, gen,
                   frontend_fn)

    step_ms = cuda_ms(step, reps=10)
    # a profile that drops the frontend's or the loss's kernels would
    # understate the step and overstate the frontend's share: it fails
    want = ("fft", "fwd_mma_kernel", "bwd_cluster_kernel", "ctc_fwd_kernel",
            "ctc_bwd_kernel")
    step_us, rows = device_breakdown(step, expect=want)
    check(all(any(e in name for name, _ in rows) for e in want),
          f"the step's profile lacks one of {want}: {[n for n, _ in rows]}")
    # the frontend with its two sums in float64, as shipped, and in float32,
    # the JAX package's precision
    fe = {}
    for name, dt in (("fp64", torch.float64), ("fp32", torch.float32)):
        features.SUM_DTYPE = dt
        try:
            fe_us, fe_rows = device_breakdown(lambda: frontend_fn(feats, frac),
                                              expect=("fft",))
        finally:
            features.SUM_DTYPE = torch.float64
        check(any("fft" in n for n, _ in fe_rows),
              f"the {name} frontend's profile has no FFT kernel")
        fe[name] = (fe_us, fe_rows)
    fe_us, fe_rows = fe["fp64"]
    fft_us = sum(us for name, us in rows if "fft" in name.lower())
    share = fe_us / step_us if step_us else float("nan")
    print(f"  waveform train step, B={cfg.batch_size}, S={feats.shape[1]} "
          f"samples (T'={t_prime}), bf16, dropout {spec.drop_out}: "
          f"{step_ms:.4f} ms, {step_us / 1e3:.4f} ms of kernels; the frontend "
          f"alone {fe_us / 1e3:.4f} ms of kernels ({100 * share:.2f}% of the "
          f"step's), FFT kernels by name {fft_us / 1e3:.4f} ms in the step; "
          f"the frontend with its DC mean and FFT in float32 "
          f"{fe['fp32'][0] / 1e3:.4f} ms of kernels ({smi})")
    print_breakdown("waveform train step", step_ms, step_us, rows, top=12)
    print_breakdown("frontend, float64 sums", step_ms, fe_us, fe_rows, top=6)
    print_breakdown("frontend, float32 sums", step_ms, fe["fp32"][0],
                    fe["fp32"][1], top=6)
    return {**out, "step_ms": step_ms, "step_device_ms": step_us / 1e3,
            "frontend_device_ms": fe_us / 1e3, "frontend_share": share,
            "frontend_fp32_sums_device_ms": fe["fp32"][0] / 1e3,
            "fft_device_ms_in_step": fft_us / 1e3}


def pipeline_conf(path: Path, profile: bool = True) -> Path:
    """A copy of ``RECIPE_PIPELINE`` that differs only in the checkpoint
    path, ``num_epoches: 1`` and ``profile``: its data paths stay the
    recipe's ``data/...``, which ``cli.run`` remaps onto ``--data``."""
    text = RECIPE_PIPELINE.read_text()
    for a, b in (("num_epoches: 500", "num_epoches: 1"),
                 ("checkpoint_dir: 'checkpoint/'",
                  f"checkpoint_dir: '{WORK / 'checkpoint'}'")):
        check(a in text, f"{RECIPE_PIPELINE.name} has no {a!r}")
        text = text.replace(a, b)
    path.write_text(text + f"\nprofile: {profile}\n")
    return path


def run_stage(argv, out: list) -> float:
    """``cli.run.main(argv)`` with its printed lines added to ``out``;
    returns its wall seconds."""
    import io

    from ctc_pytorch_tpu_torch.cli import run

    buf = io.StringIO()
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run.main(argv)
    sync()
    out.extend(buf.getvalue().splitlines())
    return time.perf_counter() - t0


def reader_rates(cfg, scp: str, lab: str, workers=(1, 4),
                 reps: int = 5) -> dict:
    """Utterances a second of ``SpeechDataset.preload`` over one scp through
    the native reader and through the numpy reader, with each count of
    worker threads (median of ``reps`` turns, the readers alternating); the
    two readers must give the same items."""
    import numpy as np

    from ctc_pytorch_tpu_torch.data import SpeechDataset
    from ctc_pytorch_tpu_torch.vocab import Vocab

    class NumpyDataset(SpeechDataset):
        def _native_processed(self, rx):
            return None

    vocab = Vocab(cfg.vocab_file)
    out = {}
    for w in workers:
        times = {"native": [], "numpy": []}
        items = {}
        for _ in range(reps):
            for name, cls in (("native", SpeechDataset),
                              ("numpy", NumpyDataset)):
                ds = cls(vocab, scp, lab, cfg)
                t0 = time.perf_counter()
                ds.preload(w)
                times[name].append(time.perf_counter() - t0)
                items[name] = [ds[i][0] for i in range(len(ds))]
        check(all(np.array_equal(a, b) for a, b in zip(items["native"],
                                                       items["numpy"])),
              "the native and the numpy reader give different items")
        n = len(items["native"])
        rate = {k: n / statistics.median(v) for k, v in times.items()}
        out[f"workers_{w}"] = {**rate, "speedup": rate["native"]
                               / rate["numpy"]}
    out["utts"] = n
    return out


def trace_kernels(profile_dir: Path, names) -> dict:
    """The trace ``profile: True`` wrote under ``profile_dir``: its file
    name, size and, of ``names``, how many device events each names."""
    import json

    traces = sorted(profile_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"{len(traces)} traces under {profile_dir}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"file": traces[0].name, "bytes": traces[0].stat().st_size,
            "kernel_events": len(kernels),
            "by_name": {n: sum(n in k for k in kernels) for n in names}}


def phase_pipeline_slice(smi: str, device: str = "cuda") -> dict:
    """Stages 0-4 of the flagship recipe through the port's ``cli.run``, one
    stage a call, on a synthetic TIMIT tree (``write_timit_corpus``,
    ``PIPELINE_SPEAKERS``), with a copy of the recipe that differs only in
    paths, ``num_epoches: 1`` and ``profile: True``: stage 0 on the host,
    stage 1 on the card, stage 2 at full width (CNN + 4 x BiLSTM(384),
    bf16, batch 8, the fused epoch from graphs), stage 3, stage 4 (greedy,
    fused).  Checks: every stage's output; every stage-2 utterance read by
    the native reader; the launches of each LSTM and CTC kernel over the
    five stages and the branch each took (fp32 streams at B=8: the forwards
    and the backward on ``cluster16_fp32``); the profiler's trace
    of the first epoch names the port's kernels.  Then ``cli.visualize`` on
    an fp32 copy of the package (its log-probs the kernels' eval forward of
    that utterance, rows summing to 1), and ``cli.import_torch`` on a
    full-width reference-format flagship whose own eval forward (cuDNN, fp32)
    the imported package's kernel forward must match (atol 1e-4, rtol 1e-3,
    as ``tests/test_import_torch.py``).  Prints the stages' walls, the native
    and numpy readers' rates over one scp, and stage 2 with the profiler
    against stage 2 without.  ``device="cpu"`` rehearses the phase on a cut
    recipe (``RECIPE_PIPELINE`` pointed elsewhere)."""
    import numpy as np
    import torch

    from ctc_pytorch_tpu_torch.cli import import_torch
    from ctc_pytorch_tpu_torch.cli import visualize as cli_visualize
    from ctc_pytorch_tpu_torch.cli.test import evaluate
    from ctc_pytorch_tpu_torch.config import load_config
    from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset
    from ctc_pytorch_tpu_torch.data import dataset as dataset_mod
    from ctc_pytorch_tpu_torch.train.checkpoint import (
        model_from_package,
        save_package,
    )
    from ctc_pytorch_tpu_torch.vocab import Vocab

    on_card = device == "cuda"
    corpus, data = WORK / "timit", WORK / "data_pipeline"
    want = write_timit_corpus(corpus, *PIPELINE_SPEAKERS, seed=21)
    conf = pipeline_conf(WORK / "pipeline.yaml")
    base = ["--data", str(data), "--conf", str(conf), "--device", device]
    walls, out = {}, {}
    printed: dict = {}
    zero_counts()
    for stage in range(5):
        if stage == 2:
            dataset_mod.reset_reads()
        printed[stage] = []
        walls[stage] = run_stage(
            ["--timit", str(corpus), *base, "--stage", str(stage),
             "--stop-stage", str(stage)], printed[stage])
        if stage == 2:
            reads = dict(dataset_mod.READS)
    counts, took = launch_counts(), path_branches()
    check(printed[0] == [f"Data preparation succeeded: {want}"],
          f"stage 0 printed {printed[0]}, wanted the counts {want}")
    cfg = load_config(data / "conf_resolved.yaml")
    shipped = load_config(RECIPE_PIPELINE)
    check(cfg.profile and cfg.num_epoches == 1 and all(
        getattr(cfg, k) == getattr(shipped, k) for k in (
            "rnn_hidden_size", "rnn_layers", "batch_size", "dtype", "cnn",
            "fused_epoch", "fused_dispatch", "decode_type")),
          "the pipeline's conf is not the recipe's")
    for split in ("train", "dev", "test"):
        check((data / split / "fbank.scp").exists()
              and len((data / split / "fbank.scp").read_text().splitlines())
              == want[split], f"stage 1 wrote no {split} features")
    check(reads == {"native": want["train"] + want["dev"], "numpy": 0},
          f"stage 2 read {reads}, not every utterance natively")
    best = Path(cfg.checkpoint_dir) / cfg.exp_name / "ctc_best_model.npz"
    spec, model, _ = model_from_package(best, device)
    n = spec.rnn_layers
    check(not on_card or (spec.rnn_hidden_size == 384 and n == 4
                          and spec.add_cnn and spec.compute_dtype == "bfloat16"
                          and cfg.batch_size == 8),
          f"stage 2 did not train the flagship at full width: {spec}")
    check((data / "lm_phone_bg.arpa").exists(), "stage 3 wrote no LM")
    decoded = [ln for ln in printed[4] if ln.startswith("decoded: ")]
    check(len(decoded) == want["test"]
          and printed[4][-3].startswith("character error rate"),
          f"stage 4 decoded {len(decoded)} of {want['test']} utterances")
    vocab = Vocab(cfg.vocab_file)

    def batches(scp, lab):
        return len(SpeechDataLoader(SpeechDataset(vocab, scp, lab, cfg),
                                    cfg.batch_size, shuffle=False,
                                    num_buckets=cfg.num_buckets))

    steps = batches(cfg.train_scp_path, cfg.train_lab_path)
    dev_b = batches(cfg.valid_scp_path, cfg.valid_lab_path)
    test_b = batches(cfg.test_scp_path, cfg.test_lab_path)
    epochs = (Path(cfg.checkpoint_dir) / cfg.exp_name
              / "train_metrics.jsonl").read_text().splitlines()
    check(len(epochs) == 1 and '"train_loss": NaN' not in epochs[0],
          f"stage 2 logged {epochs}")
    fit_lines = [ln for ln in printed[2] if "fused_epoch" in ln
                 or ln.startswith("Epoch") or "loss" in ln][:6]
    for ln in fit_lines:
        print("  " + ln)
    print(f"  stages 0-4 through cli.run on {device}: {want} utterances; "
          f"walls (s) {walls}; stage 2 read {reads}; {steps} steps, "
          f"{dev_b} dev and {test_b} test batches; launches {counts}; by "
          f"branch {took}")
    print("  " + printed[4][-3] + " | " + printed[4][-2])
    if on_card:
        check_counts(counts, {"lstm_bidir_train_fwd": n * steps,
                              "lstm_bidir_train_bwd": n * steps,
                              "ctc_alpha": steps + dev_b, "ctc_beta": steps,
                              "lstm_bidir": n * (dev_b + test_b),
                              **epilogue_want(spec, dev_b + test_b, steps)},
                     "the pipeline's stages 2 and 4")
        check(took["lstm_bidir_train_fwd"] == {"cluster16_fp32": n * steps}
              and took["lstm_bidir"] == {"cluster16_fp32": n * (dev_b + test_b)}
              and took["lstm_bidir_train_bwd"] == {"cluster16_fp32": n * steps}
              and took["ctc_alpha"] == {"staged": steps + dev_b}
              and took["ctc_beta"] == {"staged": steps},
              f"a pipeline launch took another branch: {took}")
    names = (("fwd_fma_kernel", "bwd_fma_kernel", "ctc_fwd_kernel",
              "ctc_bwd_kernel") if on_card else ())
    trace = trace_kernels(Path(cfg.checkpoint_dir) / cfg.exp_name / "profile",
                          names)
    print(f"  profile: True traced the first epoch into {trace['file']} "
          f"({trace['bytes']} bytes, {trace['kernel_events']} kernel events; "
          f"the port's kernels by name {trace['by_name']})")
    check(all(trace["by_name"].values()),
          f"the profile names none of some port kernels: {trace['by_name']}")

    # the first epoch without the profiler (a conf that differs only there)
    quiet_conf = pipeline_conf(WORK / "pipeline_noprofile.yaml", profile=False)
    walls["2_without_profile"] = run_stage(
        ["--data", str(data), "--conf", str(quiet_conf), "--device", device,
         "--stage", "2", "--stop-stage", "2"], [])
    rates = reader_rates(cfg, cfg.train_scp_path, cfg.train_lab_path)
    print(f"  stage 2 with profile: True {walls[2]:.3f} s, without "
          f"{walls['2_without_profile']:.3f} s; preload of {rates['utts']} "
          f"utterances, utts/s by worker threads, native against numpy "
          f"(items bit-equal): " + ", ".join(
              f"{k} {v['native']:.1f} vs {v['numpy']:.1f} "
              f"({v['speedup']:.2f}x)" for k, v in rates.items()
              if k != "utts") + f" ({smi})")

    # cli.visualize on an fp32 copy of the package, against the kernels
    pkg32 = WORK / "checkpoint" / "pipeline_fp32.npz"
    spec32 = dataclasses.replace(spec, compute_dtype="float32")
    save_package(pkg32, spec32, model, config=cfg)
    zero_counts()
    viz = cli_visualize.main(["--conf", str(data / "conf_resolved.yaml"),
                              "--package", str(pkg32), "--out",
                              str(WORK / "viz" / "act.npz"), "--device",
                              device])
    viz_launches = launch_counts()["lstm_bidir"]
    z = np.load(viz)
    _, model32, _ = model_from_package(pkg32, device)
    with torch.inference_mode():
        lp = model32(torch.from_numpy(z["input"][None]).to(device))
    viz_err = float(np.abs(lp[:, 0].cpu().numpy() - z["log_probs"]).max())
    row_err = float(np.abs(np.exp(z["log_probs"]).sum(-1) - 1).max())
    print(f"  cli.visualize (fp32 package, {z['utt']}): keys {sorted(z.files)}, "
          f"input {z['input'].shape}, post_cnn {z['post_cnn'].shape}, pre_rnn "
          f"{z['pre_rnn'].shape}, log_probs {z['log_probs'].shape}; against "
          f"the kernels' eval forward {viz_err:.3g} (tol 1e-4), rows sum to 1 "
          f"within {row_err:.3g} (rtol 1e-4); eval launches {viz_launches}")
    check(viz_err <= 1e-4 and row_err <= 1e-4,
          "cli.visualize's log-probs are not the kernels' forward")
    check(not on_card or viz_launches == n, "cli.visualize ran no kernel")

    # cli.import_torch on a full-width reference-format flagship
    ref = reference_package(cfg.rnn_input_size, [
        (ch, k, st, pad) for ch, k, st, pad in zip(
            cfg.cnn.channel, cfg.cnn.kernel_size, cfg.cnn.stride,
            cfg.cnn.padding)], cfg.rnn_hidden_size, cfg.rnn_layers,
        vocab.n_words, seed=5)
    module = ref.pop("module").to(device)
    pkl, imported = WORK / "reference.pkl", WORK / "imported.npz"
    torch.save(ref, pkl)
    t0 = time.perf_counter()
    import_torch.main([str(pkl), str(imported)])
    import_s = time.perf_counter() - t0
    batch = next(iter(SpeechDataLoader(
        SpeechDataset(vocab, cfg.test_scp_path, cfg.test_lab_path, cfg),
        cfg.batch_size, shuffle=False, num_buckets=cfg.num_buckets)))
    x = torch.from_numpy(batch.feats).to(device)
    spec_i, model_i, _ = model_from_package(imported, device)
    zero_counts()
    with torch.inference_mode():
        got = model_i(x)
        sync()
        import_launches = launch_counts()["lstm_bidir"]
        want_lp = module(x)
    import_err = float((got - want_lp).abs().max())
    check(got.shape == want_lp.shape and torch.allclose(
        got, want_lp, rtol=1e-3, atol=1e-4),
          f"the imported package's forward parts from the reference's by "
          f"{import_err:.3g}")
    check(not on_card or import_launches == n,
          "the imported package's forward ran no kernel")
    res = evaluate(cfg, str(imported), device=device, log=lambda *_: None)
    print(f"  cli.import_torch: {spec_i.rnn_layers} x BiLSTM("
          f"{spec_i.rnn_hidden_size}), {spec_i.num_class} classes, in "
          f"{import_s:.3f} s; its kernel forward (B={x.shape[0]}, T="
          f"{x.shape[1]}, fp32) against the reference module's own on "
          f"{device}: max |diff| {import_err:.3g} (atol 1e-4, rtol 1e-3); "
          f"eval launches {import_launches}; stage 4 of it: WER "
          f"{res['wer']:.4f} over {res['batches']} batches")
    return {"counts": counts, "branches": took, "device": smi,
            "utterances": want, "stage_walls_s": walls, "reads_stage2": reads,
            "steps": steps, "readers": rates, "trace": trace,
            "visualize_err": viz_err, "import_err": import_err,
            "import_s": import_s}


def phase_863_lstm_slice(smi: str, device: str = "cuda") -> dict:
    """Both 863 LSTM recipes as shipped (``RECIPES_863_LSTM``:
    ``cnn_lstm_ctc.conf``, log spectrum 201 + CNN 1->16 (11, 5) stride
    (2, 2) + Hardtanh(0, 20), and ``lstm_ctc.conf``, fbank 40 without a CNN;
    both 4 x BiLSTM(256), 67 outputs, bf16, batch 16, the accuracy-keyed
    scheduler, ``dev_over_train``, the fused epoch dispatched once), ingested
    the reference's 863 way: a text-format Kaldi dump
    (``write_text_corpus``, ``SPLITS_863_LSTM``) converted by
    ``data/convert.py``.  For each: one epoch through ``cli.train.train``
    (every batch a graph replay; at B=16 the streams are bf16, so the
    training forward runs ``fwd_mma_kernel`` on ``cluster16`` and the
    backward the pre-pass and ``bwd_cluster_kernel`` with 16-row clusters,
    each launch's branch checked), the loss on the longest batch before and
    after (it must fall), stage 4 of the saved package through
    ``cli.test.evaluate``, and a seeded model decoded through the kernels
    and, in fp32, through kernels and twins (the same strings,
    ``decode_slice``).  Then the step's device time by kernel on the longest
    batch, and the epoch graphed against streaming with the card's busy
    share (``phase_fused_vs_streaming``).  ``device="cpu"`` rehearses the
    phase on cut recipes (``RECIPES_863_LSTM`` pointed elsewhere)."""
    import torch

    from ctc_pytorch_tpu_torch.cli import train as cli_train
    from ctc_pytorch_tpu_torch.cli.test import evaluate
    from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset
    from ctc_pytorch_tpu_torch.data.convert import text_ark_to_binary
    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.train.loop import forward_loss, train_step
    from ctc_pytorch_tpu_torch.train.state import (
        create_train_state,
        restore,
        snapshot,
    )
    from ctc_pytorch_tpu_torch.vocab import Vocab

    on_card = device == "cuda"
    results = {}
    for recipe, (feats, dim) in RECIPES_863_LSTM.items():
        tag = recipe.stem
        root = WORK / f"data_{tag}"
        t0 = time.perf_counter()
        for split, n_utts, seed in SPLITS_863_LSTM:
            text = write_text_corpus(root, split, n_utts, seed, dim,
                                     UNITS_863, feats)
            check(text_ark_to_binary(text, root / split / f"{feats}.ark",
                                     root / split / f"{feats}.scp") == n_utts,
                  f"{tag}: the text dump of {split} did not convert")
        convert_s = time.perf_counter() - t0
        cfg = recipe_config(recipe, f"data_{tag}", feats, "text", "dev")
        cfg.exp_name, cfg.log_dir = f"smoke_{tag}", str(WORK / "log")
        spec = ModelSpec.from_config(cfg, num_class=cfg.num_class + 1)
        cnn = tag == "cnn_lstm_ctc"
        check(spec.rnn_cell == "lstm" and spec.bidirectional
              and spec.num_class == 67 and spec.add_cnn == cnn
              and spec.rnn_input_size == dim and cfg.batch_size == 16
              and cfg.scheduler_mode == "acc" and cfg.dev_over_train
              and cfg.fused_epoch and cfg.fused_dispatch == "epoch"
              and cfg.n_downsample == (2 if cnn else 1),
              f"{tag} is not the 863 LSTM recipe as shipped: {spec}")
        check(not on_card or (spec.rnn_hidden_size == 256
                              and spec.rnn_layers == 4
                              and spec.compute_dtype == "bfloat16"),
              f"{tag} is not at full width: {spec}")
        vocab = Vocab(cfg.vocab_file)

        def host(scp, lab):
            return SpeechDataLoader(SpeechDataset(vocab, scp, lab, cfg),
                                    cfg.batch_size, shuffle=False,
                                    num_buckets=cfg.num_buckets)

        longest = max(host(cfg.train_scp_path, cfg.train_lab_path),
                      key=lambda b: b.feats.shape[1])
        probe = tuple(torch.as_tensor(a).to(device) for a in (
            longest.feats, longest.input_frac, longest.labels,
            longest.label_lengths, longest.example_mask))

        def probe_loss(state) -> float:
            # train mode (batch statistics) with no update: the BN buffers
            # the forward moves are put back
            snap = snapshot(state)
            with torch.no_grad():
                loss, _, _ = forward_loss(state, spec, *probe, True, None)
            restore(state, snap)
            return loss.item()

        def fresh():
            return create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                                      cfg.grad_clip, seed=cfg.seed,
                                      device=device)

        loss_before = probe_loss(fresh())  # the trainer's init: same seed
        lines = []
        zero_counts()
        t0 = time.perf_counter()
        trainer, best = cli_train.train(cfg, device=device, num_epoches=1,
                                        log=lines.append)
        sync()
        fit_s = time.perf_counter() - t0
        counts, took = launch_counts(), path_branches()
        steps, n = trainer.state.step, spec.rnn_layers
        dev_b = len(host(cfg.valid_scp_path, cfg.valid_lab_path))
        eval_b = dev_b + steps  # the dev pass and the pass over train
        loss_after = probe_loss(trainer.state)
        graphs = trainer.graphs()
        print(f"  {tag} ({feats} {dim}, T' of the longest batch "
              f"{spec.output_time_len(longest.feats.shape[1])}): text dump "
              f"converted in {convert_s:.3f} s; cli.train.train, 1 epoch: "
              f"{steps} steps of B={cfg.batch_size}, {eval_b} eval batches, "
              f"{fit_s:.3f} s with the captures, {graphs.replays()} replays; "
              f"launches {counts}; by branch {took}; loss on the longest "
              f"batch {loss_before:.4f} -> {loss_after:.4f}")
        check(any(ln.startswith("fused_epoch: the epochs run over the device "
                                "cache") for ln in lines),
              f"{tag}: the fit did not take the fused path")
        check(any(ln.startswith("cer on training set is ") for ln in lines),
              f"{tag}: dev_over_train ran no pass over the training set")
        check(steps == -(-SPLITS_863_LSTM[0][1] // cfg.batch_size),
              f"{tag}: {steps} steps")
        check(loss_after < loss_before, f"{tag}: the loss did not fall")
        if on_card:
            check(graphs.replays() == steps + eval_b,
                  f"{tag}: {graphs.replays()} replays")
            check_counts(counts, {"lstm_bidir_train_fwd": n * steps,
                                  "lstm_bidir_train_bwd": n * steps,
                                  "ctc_alpha": steps + eval_b,
                                  "ctc_beta": steps,
                                  "lstm_bidir": n * eval_b,
                                  **epilogue_want(spec, eval_b, steps)},
                         f"{tag} fit")
            check(took["lstm_bidir_train_fwd"] == {"cluster16": n * steps}
                  and took["lstm_bidir_train_bwd"] == {"cluster16": n * steps},
                  f"{tag}: the training forward or backward left the "
                  f"16-row clusters: {took}")
            check(all(k.startswith("cluster") for k in took["lstm_bidir"]),
                  f"{tag}: an eval forward took the grid: {took}")
        res = evaluate(cfg, str(best), device=device, log=lines.append)
        decoded = [ln for ln in lines if ln.startswith("decoded: ")]
        check(len(decoded) == SPLITS_863_LSTM[1][1]
              and math.isfinite(res["wer"]),
              f"{tag}: the saved package does not decode")
        print(f"  {tag} stage 4 of the saved package: {len(decoded)} utts, "
              f"CER {res['cer']:.4f}")
        out = {"counts": counts, "branches": took, "steps": steps,
               "fit_s": fit_s, "convert_s": convert_s,
               "loss_before": loss_before, "loss_after": loss_after,
               "decode_launches": 0}
        if on_card:
            # one epoch leaves blank everywhere: a seeded model with a
            # sharp output layer decodes strings to compare
            out["decode_launches"] = decode_slice(
                cfg, spec, seeded_model(spec), "lstm_bidir",
                SPLITS_863_LSTM[1][1], f"863_{tag}")
            state = fresh()

            def step():
                train_step(state, spec, *probe)

            step_ms = cuda_ms(step, reps=10)
            want = ("fwd_mma_kernel", "prepass_mma_kernel",
                    "bwd_cluster_kernel", "ctc_fwd_kernel", "ctc_bwd_kernel")
            step_us, rows = device_breakdown(step, expect=want)
            check(all(any(e in name for name, _ in rows) for e in want),
                  f"{tag}: the step's profile lacks one of {want}")
            bwd_us = sum(us for name, us in rows if "bwd_cluster_kernel" in name
                         or "prepass_mma_kernel" in name)
            fwd_us = sum(us for name, us in rows if "fwd_mma_kernel" in name)
            print(f"  {tag} train step, B={cfg.batch_size}, T="
                  f"{probe[0].shape[1]}: {step_ms:.4f} ms, "
                  f"{step_us / 1e3:.4f} ms of kernels; LSTM backward (pre-pass "
                  f"+ bwd_cluster_kernel) {bwd_us / 1e3:.4f} ms "
                  f"({100 * bwd_us / step_us:.1f}%), training forward "
                  f"{fwd_us / 1e3:.4f} ms ({100 * fwd_us / step_us:.1f}%) "
                  f"({smi})")
            print_breakdown(f"{tag} train step", step_ms, step_us, rows, top=10)
            out.update(step_ms=step_ms, step_device_ms=step_us / 1e3,
                       lstm_bwd_device_ms=bwd_us / 1e3,
                       lstm_train_fwd_device_ms=fwd_us / 1e3)
        out["fused_vs_streaming"] = phase_fused_vs_streaming(
            cfg, spec, f"863 {tag} 4 x BiLSTM(256)", smi, device)
        results[tag] = out
    return results


def busy_us(prof) -> float:
    """Microseconds in which the card ran anything (kernels, copies, sets)
    in a ``torch.profiler`` trace: the union of its device intervals."""
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events() if device_activity(ev))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn) -> float:
    """Host seconds of ``fn()``, synchronised at both ends."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def busy_share(fn, wall_s: float) -> float:
    """The card's busy share of one run of ``fn`` (``torch.profiler``'s
    device intervals over ``wall_s``, the run's time without the
    profiler)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return busy_us(prof) / 1e6 / wall_s


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms inside the block (deterministic
    cuDNN convolutions: their weight gradient otherwise adds in a varying
    order), ops that have none warning instead of raising; prints the
    warnings once."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)
    for msg in sorted({str(w.message).splitlines()[0][:160] for w in caught}):
        print(f"    deterministic mode: {msg}")


def phase_fused_vs_streaming(cfg, spec, what: str, smi: str,
                             device: str = "cuda", frontend_fn=None) -> dict:
    """One training epoch with its dev pass of ``cfg``'s model at full width
    and ``drop_out: 0``, from one seeded state, through the eager streaming
    ``run_epoch`` over a ``GroupedLoader`` and through the graphed
    ``run_epoch_single`` over a ``DeviceCachedLoader``: the same batches in
    the same order (the recipe's ``fused_dispatch: "epoch"`` order).  Both
    run under PyTorch's deterministic algorithms, so that what differs is
    the graphs alone (cuDNN's weight gradient otherwise adds in a varying
    order, which bf16 weights then round apart; the CTC gradient sums in a
    fixed order either way).  Per-batch losses within STEP_LOSS_RTOL, token errors
    and tokens exactly, the parameters within phase 5's rule per step; the
    fused greedy decode of the graphed run's model gives the streaming
    decode's strings.  Then the times, in the default modes, on new graphs:
    an epoch on both paths (the fused one with its captures), a second
    (wall, utterances a second), the second again under ``torch.profiler``
    for the card's busy share, and a train pass through a
    ``PrefetchLoader`` against the plain host loader, in the turns plain,
    prefetch, prefetch, plain.  ``device="cpu"`` rehearses the phase at a
    small size (the runners then run eagerly).  With ``frontend_fn`` (a
    waveform recipe) every step starts with the frontend, in the graphs too,
    and stage 4 has no fused path to compare (as in the JAX package)."""
    import numpy as np

    from ctc_pytorch_tpu_torch.cli.test import evaluate
    from ctc_pytorch_tpu_torch.cli.train import build_loaders
    from ctc_pytorch_tpu_torch.data import GroupedLoader, PrefetchLoader
    from ctc_pytorch_tpu_torch.train.checkpoint import save_package
    from ctc_pytorch_tpu_torch.train.loop import (
        make_epoch_fns,
        make_fused_fns,
        run_epoch,
        run_epoch_single,
    )
    from ctc_pytorch_tpu_torch.train.state import create_train_state
    from ctc_pytorch_tpu_torch.vocab import Vocab

    cfg = dataclasses.replace(cfg, drop_out=0.0)
    spec = dataclasses.replace(spec, drop_out=0.0)
    check(cfg.fused_epoch and cfg.fused_dispatch == "epoch",
          f"{what}: the recipe does not run fused epochs in t_pad order")
    cache_tr, cache_dv = build_loaders(cfg, Vocab(cfg.vocab_file),
                                       log=lambda *_: None, device=device)
    host_tr, host_dv = cache_tr.loader, cache_dv.loader
    n_utts = len(host_tr.dataset) + len(host_dv.dataset)
    quiet = lambda *_: None  # noqa: E731

    def fresh():
        return create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                                  cfg.grad_clip, seed=cfg.seed, device=device)

    stream_state, fused_state = fresh(), fresh()

    def streaming(epoch, rec_tr=None, rec_dv=None, loader=None):
        host_tr.set_epoch(epoch)
        run_epoch(epoch, stream_state, spec,
                  loader or GroupedLoader(host_tr).grouped("epoch"),
                  training=True, print_every=1 << 30, log=quiet, record=rec_tr,
                  frontend_fn=frontend_fn)
        if loader is None:
            run_epoch(epoch, stream_state, spec,
                      GroupedLoader(host_dv).grouped("epoch"), training=False,
                      log=quiet, record=rec_dv, frontend_fn=frontend_fn)

    def fused(epoch_fns, epoch, rec_tr=None, rec_dv=None):
        cache_tr.set_epoch(epoch)
        run_epoch_single(epoch, epoch_fns, fused_state, cache_tr,
                         training=True, log=quiet, record=rec_tr)
        run_epoch_single(epoch, epoch_fns, fused_state, cache_dv,
                         training=False, log=quiet, record=rec_dv)

    recs = {k: {} for k in ("s_tr", "s_dv", "f_tr", "f_dv")}
    checked_fns = make_epoch_fns(make_fused_fns(spec, None, frontend_fn))
    with deterministic():
        streaming(1, recs["s_tr"], recs["s_dv"])
        fused(checked_fns, 1, recs["f_tr"], recs["f_dv"])
        sync()
    steps = len(recs["s_tr"]["losses"])
    for split in ("tr", "dv"):
        got, want = recs[f"f_{split}"], recs[f"s_{split}"]
        rel = np.abs(np.subtract(got["losses"], want["losses"])) / np.abs(
            want["losses"])
        print(f"  {what} {'train' if split == 'tr' else 'dev'} pass: "
              f"{len(got['losses'])} batches, per-batch losses graphed vs "
              f"eager rel {rel.max():.3g} (tol {STEP_LOSS_RTOL}; "
              f"{int((rel == 0).sum())} equal bit for bit); token errors "
              f"{got['errs']} vs {want['errs']}, tokens {got['toks']} vs "
              f"{want['toks']}")
        check(len(got["losses"]) == len(want["losses"]) > 0
              and rel.max() <= STEP_LOSS_RTOL,
              f"{what}: graphed and eager per-batch losses differ")
        check(got["errs"] == want["errs"] and got["toks"] == want["toks"],
              f"{what}: graphed and eager token counts differ")
    check(device == "cpu" or checked_fns[0].graphs.replays()
          == steps + len(recs["s_dv"]["losses"]),
          f"{what}: {checked_fns[0].graphs.replays()} replays for {steps} "
          f"steps and {len(recs['s_dv']['losses'])} dev batches")
    worst, n_off, n_all = 0.0, 0, 0
    f_sd = fused_state.model.state_dict()
    for k, v in stream_state.model.state_dict().items():
        diff = (f_sd[k].float() - v.float()).abs()
        n_off += int((diff > STEP_TOL).sum())
        n_all += diff.numel()
        worst = max(worst, diff.max().item())
    print(f"  {what} after the epoch ({steps} steps): {n_off} of {n_all} "
          f"parameter and BN entries differ by more than {STEP_TOL}, largest "
          f"difference {worst:.3g} (tol {2.01 * steps * cfg.init_lr:.3g})")
    check(fused_state.step == stream_state.step == steps,
          f"{what}: step counts {fused_state.step}, {stream_state.step}")
    check(n_off <= STEP_OFF_SHARE * n_all
          and worst <= 2.01 * steps * cfg.init_lr,
          f"{what}: graphed and eager parameters differ")

    # the fused and the streaming stage 4 of the graphed run's model
    if frontend_fn is None:
        pkg = WORK / "checkpoint" / f"phase10_{spec.rnn_cell}.npz"
        save_package(pkg, spec, fused_state.model, config=cfg)
        decoded = {}
        for fused_decode in (True, False):
            lines = []
            res = evaluate(dataclasses.replace(cfg, fused_decode=fused_decode),
                           str(pkg), device=device, log=lines.append)
            check(bool(res.get("fused")) == fused_decode, "wrong stage-4 path")
            decoded[fused_decode] = dict(zip(lines[0:-3:3], lines[2:-3:3]))
        same = sum(decoded[True].get(u) == d
                   for u, d in decoded[False].items())
        print(f"  {what} stage 4, fused vs streaming: "
              f"{same}/{len(decoded[False])} strings equal")
        check(decoded[True] == decoded[False] and same > 0,
              f"{what}: the fused and the streaming decode differ")

    # the times, in the default modes, on graphs captured in them
    epoch_fns = make_epoch_fns(make_fused_fns(spec, None, frontend_fn))
    graphs = epoch_fns[0].graphs
    first = {"streaming": timed(lambda: streaming(2)),
             "fused": timed(lambda: fused(epoch_fns, 2))}
    graphs_first = len(graphs)
    wall = {"streaming": timed(lambda: streaming(3)),
            "fused": timed(lambda: fused(epoch_fns, 3))}
    graphs_next = len(graphs)
    # a device metric: not measured on the CPU
    busy = ({"streaming": busy_share(lambda: streaming(3), wall["streaming"]),
             "fused": busy_share(lambda: fused(epoch_fns, 3), wall["fused"])}
            if device == "cuda" else {"streaming": None, "fused": None})
    # the host loaders' train pass, plain and prefetched, in turns
    pre = PrefetchLoader(host_tr, device)
    turns = [("plain", host_tr), ("prefetch", pre), ("prefetch", pre),
             ("plain", host_tr)]
    pass_s = {"plain": [], "prefetch": []}
    for name, loader in turns:
        pass_s[name].append(timed(lambda: streaming(4, loader=loader)))
    out = {
        "what": what, "batch": cfg.batch_size, "train_steps": steps,
        "dev_batches": len(recs["s_dv"]["losses"]), "utterances": n_utts,
        "first_epoch_wall_s": first, "epoch_wall_s": wall,
        "utts_per_s": {k: n_utts / v for k, v in wall.items()},
        "busy_share": busy, "graphs": len(graphs),
        "graphs_after_first_epoch": graphs_first,
        "graphs_after_next_epoch": graphs_next,
        "capture_s": graphs.capture_seconds,
        "pool_bytes": graphs.pool_bytes() if device == "cuda" else 0,
        "train_pass_s": pass_s, "card": smi,
    }
    print(f"  {what} B={cfg.batch_size}, one epoch = {steps} steps + "
          f"{out['dev_batches']} dev batches ({n_utts} utterances) ({smi}):")
    for k in ("streaming", "fused"):
        print(f"    {k}: first epoch {first[k]:.4f} s, next {wall[k]:.4f} s "
              f"({out['utts_per_s'][k]:.1f} utts/s), card busy "
              + (f"{100 * busy[k]:.1f}% of it (torch.profiler)"
                 if busy[k] is not None else "not measured"))
    print(f"    graphs: {len(graphs)} captured in {graphs.capture_seconds:.3f}"
          f" s ({graphs_first} in the first epoch, {graphs_next - graphs_first}"
          f" more in the next), pool {out['pool_bytes']} bytes")
    print(f"    train pass, streaming from the host: plain "
          f"{pass_s['plain']} s, prefetched {pass_s['prefetch']} s")
    return out


def recurrence_bound(gx, w_hh, n_planes: int, n_products: int,
                     n_gate_planes: int = 1, bf16_products: bool = False):
    """Least time the card could take for one recurrence call of any cell
    (n gates, read off ``w_hh (2, H, nH)``): the larger of its bytes
    (``n_gate_planes`` (T, B, 2nH) and ``n_planes`` (T, B, 2H) planes in the
    stream dtype and w_hh, 2 bytes a weight where the products take it as
    bf16, each moved once) over the memory rate and its
    (B, H) x (H, nH)-sized products (``n_products`` per step and direction)
    over the card's peak for their operands.  ``bf16_products``: both
    operands are bf16 values summed in fp32 (with bf16 streams: the LSTM's
    training kernels and all three GRU and tanh kernels), which the tensor
    cores multiply; otherwise an operand is fp32 (the LSTM eval kernel's h
    and w_hh, and everything with fp32 streams) and the peak is the fp32
    one."""
    t, b, _ = gx.shape
    h, nh = w_hh.shape[1], w_hh.shape[2]
    es = gx.element_size()
    bytes_moved = (n_gate_planes * gx.numel() * es
                   + w_hh.numel() * (2 if bf16_products else 4)
                   + n_planes * t * b * 2 * h * es)
    flops = n_products * 2 * t * b * h * nh * 2
    peak = BF16_FLOP_PER_S if bf16_products else FP32_FLOP_PER_S
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes > by_ops else "operations",
            "bytes_ms": by_bytes * 1e3, "ops_ms": by_ops * 1e3,
            "peak": ("bf16 tensor-core peak, 989 TFLOP/s" if bf16_products
                     else "fp32 peak, 67 TFLOP/s"),
            "gflop": flops / 1e9, "mbytes": bytes_moved / 1e6}


# The dependent chain of one CTC frame in ``csrc/ctc_dp.cu``, counted from
# its code (one position a thread): the exchange (a
# shared store, a barrier, two shared loads) ~60 cycles; lse3: three fmax, a
# subtract, expf (6 dependent instructions around one MUFU.EX2), two adds, a
# clamp, logf (19 dependent FMA-pipe instructions), two adds, two selects,
# ~45 instructions at ~4 cycles and the MUFU's ~20: ~190 cycles.  The
# backward's gradient work runs on warps of its own, off this chain.
CTC_FRAME_CHAIN_CYCLES = 250
SM_CLOCK_HZ = 1.98e9  # H100 SXM boost clock


def ctc_bound(t, b, c, s, backward: bool) -> dict:
    """Least time for one forward or backward CTC call with every utterance
    at its full length: log_probs (and in the backward the alpha table) read
    and the outputs (the alpha table and neg_ll; the gradient) written,
    fp32, over the memory rate, against about 30 fp32 operations a cell
    (three exp, one log, the sums; 40 in the backward with gamma) over the
    fp32 peak; and the latency bound, T times one frame's dependent chain
    (CTC_FRAME_CHAIN_CYCLES at SM_CLOCK_HZ)."""
    table, lp = t * b * s * 4, t * b * c * 4
    small = b * (2 * s + 4) * 4  # labels and lengths, neg_ll (and g)
    bytes_moved = (2 * lp + table if backward else lp + table) + small
    flops = (40 if backward else 30) * t * b * s
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes > by_ops else "operations",
            "latency_bound_ms": t * CTC_FRAME_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3,
            "gflop": flops / 1e9, "mbytes": bytes_moved / 1e6}


def prepass_bound(gx, w_hh, n_saved: int, n_planes: int, bf16: bool) -> dict:
    """Least time for one backward pre-pass: gx and ``n_saved`` saved (T, B,
    ndir H) planes read in the stream dtype, w_hh, and ``n_planes`` fp32
    (ndir, T, B, H) factor planes written, over the memory rate; its one
    (T B, H) x (H, nH) product per direction over the peak for the
    operations the kernel does: bf16 on the tensor cores with bf16 streams,
    three TF32 passes on the tensor cores with fp32 streams
    (``prepass_tf32_kernel``), whose bound is ``bound_ms``; beside it the
    product in fp32 FMA on the CUDA cores (``fp32_ops_ms``, ``fp32_bound_ms``)
    and in 3xTF32 (``tf32x3_ops_ms``)."""
    t, b, _ = gx.shape
    ndir, h, nh = w_hh.shape
    es = gx.element_size()
    bytes_moved = (gx.numel() * es + n_saved * t * b * ndir * h * es
                   + w_hh.numel() * es + n_planes * ndir * t * b * h * 4)
    flops = 2 * ndir * t * b * h * nh
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    fp32_ops, tf32x3_ops = flops / FP32_FLOP_PER_S, 3 * flops / TF32_FLOP_PER_S
    by_ops = flops / BF16_FLOP_PER_S if bf16 else tf32x3_ops
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes > by_ops else "operations",
            "bytes_ms": by_bytes * 1e3, "ops_ms": by_ops * 1e3,
            "fp32_ops_ms": fp32_ops * 1e3, "tf32x3_ops_ms": tf32x3_ops * 1e3,
            "fp32_bound_ms": max(by_bytes, fp32_ops) * 1e3,
            "peak": ("bf16 tensor-core peak, 989 TFLOP/s" if bf16
                     else "three TF32 passes at the tensor cores' 495 TFLOP/s"),
            "gflop": flops / 1e9, "mbytes": bytes_moved / 1e6}


ROUNDS = 3  # turns of kernel and library backward timings in one run


def backward_vs_library(cell_cls, t, b, h, kernel_fn, tag,
                        what: str = "pre-pass + serial kernels") -> dict:
    """The kernels' whole backward (``kernel_fn``, printed as ``what``) and
    cuDNN's backward of ``cell_cls`` (bias-free, bidirectional, input 2H, so
    it also forms the input projection's gradients, which the kernels leave
    to the caller) in fp32 and in bf16, timed in turns ``ROUNDS`` times: the
    medians, and each round's time."""
    import torch

    lib = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        mod = cell_cls(2 * h, h, bias=False, bidirectional=True).cuda().to(dt)
        x = torch.randn(t, b, 2 * h, device="cuda", dtype=dt, requires_grad=True)
        y, _ = mod(x)
        dy = torch.randn_like(y)
        wrt = (x, *mod.parameters())
        lib[name] = (lambda y=y, wrt=wrt, dy=dy:
                     torch.autograd.grad(y, wrt, dy, retain_graph=True))
    rounds = {"kernel": [], "fp32": [], "bf16": []}
    for _ in range(ROUNDS):
        rounds["kernel"].append(cuda_ms(kernel_fn, reps=20))
        for name, fn in lib.items():
            rounds[name].append(cuda_ms(fn, reps=20))
    med = {k: statistics.median(v) for k, v in rounds.items()}
    print(f"  {tag}: backward in {ROUNDS} turns, median [min, max] ms: "
          + "; ".join(f"{label} {med[k]:.4f} [{min(rounds[k]):.4f}, "
                      f"{max(rounds[k]):.4f}]" for k, label in (
                          ("kernel", what),
                          ("fp32", f"cuDNN {cell_cls.__name__} fp32"),
                          ("bf16", f"cuDNN {cell_cls.__name__} bf16")))
          + f"; cuDNN fp32 / kernels {med['fp32'] / med['kernel']:.2f}x, "
          f"bf16 / kernels {med['bf16'] / med['kernel']:.2f}x")
    return {"ms": med["kernel"], "ms_rounds": rounds["kernel"],
            "library_ms": med["fp32"], "library_ms_rounds": rounds["fp32"],
            "library_ms_bf16": med["bf16"],
            "library_ms_bf16_rounds": rounds["bf16"]}


def forward_vs_library(cell_cls, t, b, h, kernel_fn, counts: dict, tag,
                       train: bool) -> dict:
    """One forward kernel (``kernel_fn``) and cuDNN's forward of
    ``cell_cls`` (bias-free, bidirectional, input 2H, so it also forms the
    input projection, which the kernels are given) in fp32 and in bf16,
    timed in turns ``ROUNDS`` times; cuDNN in training mode (keeping what its
    backward needs) for a training forward, under ``no_grad`` otherwise.
    ``counts`` is the op's launches by branch: the branch the timed launches
    took."""
    import torch

    lib = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        mod = cell_cls(2 * h, h, bias=False, bidirectional=True).cuda().to(dt)
        x = torch.randn(t, b, 2 * h, device="cuda", dtype=dt, requires_grad=train)
        lib[name] = lambda mod=mod, x=x: mod(x)
    before = dict(counts)
    rounds = {"kernel": [], "fp32": [], "bf16": []}
    with torch.set_grad_enabled(train):
        for _ in range(ROUNDS):
            rounds["kernel"].append(cuda_ms(kernel_fn, reps=20))
            for name, fn in lib.items():
                rounds[name].append(cuda_ms(fn, reps=20))
    took = [k for k, v in counts.items() if v != before[k]]
    med = {k: statistics.median(v) for k, v in rounds.items()}
    print(f"  {tag}: forward in {ROUNDS} turns, median [min, max] ms: "
          + "; ".join(f"{label} {med[k]:.4f} [{min(rounds[k]):.4f}, "
                      f"{max(rounds[k]):.4f}]" for k, label in (
                          ("kernel", f"kernel ({'+'.join(took)} branch)"),
                          ("fp32", f"cuDNN {cell_cls.__name__} fp32"),
                          ("bf16", f"cuDNN {cell_cls.__name__} bf16")))
          + f"; cuDNN fp32 / kernel {med['fp32'] / med['kernel']:.2f}x, "
          f"bf16 / kernel {med['bf16'] / med['kernel']:.2f}x")
    return {"ms": med["kernel"], "ms_rounds": rounds["kernel"],
            "branch": "+".join(took),
            "library_ms": med["fp32"], "library_ms_rounds": rounds["fp32"],
            "library_ms_bf16": med["bf16"],
            "library_ms_bf16_rounds": rounds["bf16"]}


def print_hoist_times(out: dict, cell: str, tag, t, b, h, dtype,
                      branch: str) -> None:
    import torch

    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    pre, bwd = out[f"{cell}_bidir_train_bwd_prepass"], out[f"{cell}_bidir_train_bwd"]
    print(f"  {cell} backward, {tag} T'={t} B={b} H={h} {name} streams, serial "
          f"branch {branch}: pre-pass {pre['ms']:.4f} ms (plain "
          f"{pre['plain_ms']:.4f} ms; bound {pre['bound_ms']:.4f} ms by "
          f"{pre['bound_by']}: {pre['mbytes']:.1f} MB, {pre['gflop']:.2f} GFLOP); "
          f"serial kernel {bwd['serial_ms']:.4f} ms ({1e3 * bwd['serial_ms'] / t:.2f} "
          f"us a step); pre-pass + serial {bwd['ms']:.4f} ms")


def times_lstm(t, b, h, dtype, tag) -> dict:
    """Per-call times of the three recurrence kernels at one shape, their
    plain twins, bounds and the cuDNN yardstick."""
    import torch

    lstm_ops, train_ops, _ = port_ops()
    gx, w_hh, dy = recurrence_inputs(t, b, h, dtype, seed=7)
    ys, cs = train_ops.lstm_bidir_train_cuda(gx, w_hh)
    # the training kernels round w_hh, h and dpre to the stream dtype
    bf16 = dtype == torch.bfloat16
    out = {
        "lstm_bidir": {
            **forward_vs_library(
                torch.nn.LSTM, t, b, h,
                lambda: lstm_ops.lstm_bidir_cuda(gx, w_hh),
                lstm_ops.launches_fwd_branch, f"lstm_bidir, {tag}", False),
            "plain_ms": cuda_ms(lambda: lstm_ops.lstm_bidir_plain(gx, w_hh),
                                reps=5),
            **recurrence_bound(gx, w_hh, n_planes=1, n_products=1)},
        "lstm_bidir_train_fwd": {
            **forward_vs_library(
                torch.nn.LSTM, t, b, h,
                lambda: train_ops.lstm_bidir_train_cuda(gx, w_hh),
                train_ops.launches_fwd_branch, f"lstm_bidir_train_fwd, {tag}",
                True),
            "plain_ms": cuda_ms(
                lambda: train_ops.lstm_bidir_train_plain(gx, w_hh), reps=5),
            **recurrence_bound(gx, w_hh, n_planes=2, n_products=1,
                               bf16_products=bf16)},
        "lstm_bidir_train_bwd_prepass": {
            "ms": cuda_ms(lambda: train_ops.lstm_bidir_train_bwd_prepass_cuda(
                gx, w_hh, ys, cs), reps=20),
            "plain_ms": cuda_ms(
                lambda: train_ops.lstm_bidir_train_bwd_prepass_plain(
                    gx, w_hh, ys, cs), reps=5),
            "library_ms": None,  # no one library call forms these planes
            **prepass_bound(gx, w_hh, n_saved=2, n_planes=6, bf16=bf16)},
        "lstm_bidir_train_bwd": {
            "plain_ms": cuda_ms(
                lambda: train_ops.lstm_bidir_train_backward_plain(
                    gx, w_hh, ys, cs, dy), reps=5),
            # gx, ys, cs, dy in, dgx out; gate recompute and dpre @ w_hh^T
            **recurrence_bound(gx, w_hh, n_planes=3, n_products=2,
                               n_gate_planes=2, bf16_products=bf16)},
    }
    planes = train_ops.lstm_bidir_train_bwd_prepass_cuda(gx, w_hh, ys, cs)
    before = dict(train_ops.launches_bwd_branch)
    out["lstm_bidir_train_bwd"]["serial_ms"] = cuda_ms(
        lambda: train_ops.lstm_bidir_train_bwd_serial_cuda(planes, w_hh, dy),
        reps=20)
    branch = [k for k, v in train_ops.launches_bwd_branch.items() if v != before[k]]
    out["lstm_bidir_train_bwd"]["branch"] = "+".join(branch)
    # library yardstick of the backward: cuDNN BiLSTM, bias-free; it also
    # computes the input projection's gradients, which the kernels leave to
    # the caller
    out["lstm_bidir_train_bwd"].update(backward_vs_library(
        torch.nn.LSTM, t, b, h,
        lambda: train_ops.lstm_bidir_train_backward_cuda(gx, w_hh, ys, cs, dy),
        f"lstm, {tag}"))
    print_recurrence_times({k: v for k, v in out.items() if "prepass" not in k},
                           tag, t, b, h, dtype, "cuDNN nn.LSTM")
    print_hoist_times(out, "lstm", tag, t, b, h, dtype,
                      out["lstm_bidir_train_bwd"]["branch"])
    return out


def times_lstm_backward(t, b, h, tag) -> dict:
    """The LSTM backward on fp32 streams at one more shape of the main
    paths: its pre-pass, its serial kernel with the branch it took and both,
    the plain twin, the bound and cuDNN's backward (``backward_vs_library``)."""
    import torch

    _, train_ops, _ = port_ops()
    gx, w_hh, dy = recurrence_inputs(t, b, h, torch.float32, seed=7)
    ys, cs = train_ops.lstm_bidir_train_cuda(gx, w_hh)
    planes = train_ops.lstm_bidir_train_bwd_prepass_cuda(gx, w_hh, ys, cs)
    before = dict(train_ops.launches_bwd_branch)
    out = {"serial_ms": cuda_ms(
        lambda: train_ops.lstm_bidir_train_bwd_serial_cuda(planes, w_hh, dy),
        reps=20)}
    out["branch"] = "+".join(k for k, v in train_ops.launches_bwd_branch.items()
                             if v != before[k])
    out["prepass_ms"] = cuda_ms(
        lambda: train_ops.lstm_bidir_train_bwd_prepass_cuda(gx, w_hh, ys, cs),
        reps=20)
    out["plain_ms"] = cuda_ms(
        lambda: train_ops.lstm_bidir_train_backward_plain(gx, w_hh, ys, cs, dy),
        reps=3)
    out.update(recurrence_bound(gx, w_hh, n_planes=3, n_products=2,
                                n_gate_planes=2))
    out.update(backward_vs_library(
        torch.nn.LSTM, t, b, h,
        lambda: train_ops.lstm_bidir_train_backward_cuda(gx, w_hh, ys, cs, dy),
        f"lstm, {tag}"))
    print(f"  lstm backward, {tag} T'={t} B={b} H={h} fp32 streams, serial "
          f"branch {out['branch']}: pre-pass {out['prepass_ms']:.4f} ms; serial "
          f"kernel {out['serial_ms']:.4f} ms ({1e3 * out['serial_ms'] / t:.2f} "
          f"us a step); pre-pass + serial {out['ms']:.4f} ms; plain "
          f"{out['plain_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']}, {out['ms'] / out['bound_ms']:.1f}x its bound")
    return out


def print_recurrence_times(out: dict, tag, t, b, h, dtype, library: str) -> None:
    import torch

    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    for k, v in out.items():
        print(f"  {k}, {tag} T'={t} B={b} H={h} {name} streams: {v['ms']:.4f} ms; "
              f"plain {v['plain_ms']:.4f} ms; {library} fp32 "
              f"{v['library_ms']:.4f} ms; bound {v['bound_ms']:.4f} ms by "
              f"{v['bound_by']} ({v['mbytes']:.1f} MB: {v['bytes_ms']:.4f} ms; "
              f"{v['gflop']:.2f} GFLOP at the {v['peak']}: {v['ops_ms']:.4f} ms), "
              f"{v['ms'] / v['bound_ms']:.1f}x its bound"
              + (f"; branch {v['branch']}" if "branch" in v else ""))


def times_gru(t, b, h, dtype, tag) -> dict:
    """Per-call times of the three GRU kernels at one shape, their plain
    twins, bounds and the cuDNN yardstick."""
    import torch

    gru_ops, gru_train_ops = port_gru_ops()
    gx, w_hh, dy = recurrence_inputs(t, b, h, dtype, seed=7, gates=3)
    ys = gru_train_ops.gru_bidir_train_cuda(gx, w_hh)
    # all three kernels round w_hh, h and the exchange operand to the stream
    # dtype before their products
    bf16 = dtype == torch.bfloat16
    out = {
        "gru_bidir": {
            **forward_vs_library(
                torch.nn.GRU, t, b, h, lambda: gru_ops.gru_bidir_cuda(gx, w_hh),
                gru_ops.launches_fwd_branch, f"gru_bidir, {tag}", False),
            "plain_ms": cuda_ms(lambda: gru_ops.gru_bidir_plain(gx, w_hh), reps=5),
            **recurrence_bound(gx, w_hh, n_planes=1, n_products=1,
                               bf16_products=bf16)},
        "gru_bidir_train_fwd": {
            **forward_vs_library(
                torch.nn.GRU, t, b, h,
                lambda: gru_train_ops.gru_bidir_train_cuda(gx, w_hh),
                gru_train_ops.launches_fwd_branch,
                f"gru_bidir_train_fwd, {tag}", True),
            "plain_ms": cuda_ms(lambda: gru_ops.gru_bidir_plain(gx, w_hh), reps=5),
            **recurrence_bound(gx, w_hh, n_planes=1, n_products=1,
                               bf16_products=bf16)},
        "gru_bidir_train_bwd_prepass": {
            "ms": cuda_ms(lambda: gru_train_ops.gru_bidir_train_bwd_prepass_cuda(
                gx, w_hh, ys), reps=20),
            "plain_ms": cuda_ms(
                lambda: gru_train_ops.gru_bidir_train_bwd_prepass_plain(
                    gx, w_hh, ys), reps=5),
            "library_ms": None,  # no one library call forms these planes
            **prepass_bound(gx, w_hh, n_saved=1, n_planes=5, bf16=bf16)},
        "gru_bidir_train_bwd": {
            "plain_ms": cuda_ms(
                lambda: gru_train_ops.gru_bidir_train_backward_plain(
                    gx, w_hh, ys, dy), reps=5),
            # gx, ys, dy in, dgx and dhhn out; gate recompute and the
            # exchange product
            **recurrence_bound(gx, w_hh, n_planes=3, n_products=2,
                               n_gate_planes=2, bf16_products=bf16)},
    }
    planes = gru_train_ops.gru_bidir_train_bwd_prepass_cuda(gx, w_hh, ys)
    before = dict(gru_train_ops.launches_bwd_branch)
    out["gru_bidir_train_bwd"]["serial_ms"] = cuda_ms(
        lambda: gru_train_ops.gru_bidir_train_bwd_serial_cuda(planes, w_hh, dy),
        reps=20)
    branch = [k for k, v in gru_train_ops.launches_bwd_branch.items()
              if v != before[k]]
    out["gru_bidir_train_bwd"]["branch"] = "+".join(branch)
    # library yardstick of the backward: cuDNN BiGRU, bias-free; it also
    # computes the input projection's gradients, which the kernels leave to
    # the caller
    out["gru_bidir_train_bwd"].update(backward_vs_library(
        torch.nn.GRU, t, b, h,
        lambda: gru_train_ops.gru_bidir_train_backward_cuda(gx, w_hh, ys, dy),
        f"gru, {tag}"))
    print_recurrence_times({k: v for k, v in out.items() if "prepass" not in k},
                           tag, t, b, h, dtype, "cuDNN nn.GRU")
    print_hoist_times(out, "gru", tag, t, b, h, dtype,
                      out["gru_bidir_train_bwd"]["branch"])
    return out


def times_rnn(t, b, h, dtype, tag) -> dict:
    """Per-call times of the three tanh-RNN kernels at one shape, their plain
    twins, bounds and the cuDNN yardstick (``nn.RNN``, tanh, in fp32 and
    bf16, in turns), with the branch each kernel took."""
    import torch

    rnn_ops, rnn_train_ops = port_rnn_ops()
    gx, w_hh, dy = recurrence_inputs(t, b, h, dtype, seed=7, gates=1)
    ys = rnn_train_ops.rnn_bidir_train_cuda(gx, w_hh)
    # all three kernels round w_hh, h and dpre to the stream dtype before
    # their products
    bf16 = dtype == torch.bfloat16
    out = {
        "rnn_bidir": {
            **forward_vs_library(
                torch.nn.RNN, t, b, h, lambda: rnn_ops.rnn_bidir_cuda(gx, w_hh),
                rnn_ops.launches_fwd_branch, f"rnn_bidir, {tag}", False),
            "plain_ms": cuda_ms(lambda: rnn_ops.rnn_bidir_plain(gx, w_hh), reps=5),
            **recurrence_bound(gx, w_hh, n_planes=1, n_products=1,
                               bf16_products=bf16)},
        "rnn_bidir_train_fwd": {
            **forward_vs_library(
                torch.nn.RNN, t, b, h,
                lambda: rnn_train_ops.rnn_bidir_train_cuda(gx, w_hh),
                rnn_train_ops.launches_fwd_branch,
                f"rnn_bidir_train_fwd, {tag}", True),
            "plain_ms": cuda_ms(lambda: rnn_ops.rnn_bidir_plain(gx, w_hh), reps=5),
            **recurrence_bound(gx, w_hh, n_planes=1, n_products=1,
                               bf16_products=bf16)},
        "rnn_bidir_train_bwd": {
            "plain_ms": cuda_ms(
                lambda: rnn_train_ops.rnn_bidir_train_backward_plain(
                    w_hh, ys, dy), reps=5),
            # ys, dy in, dgx (gx-sized) out; one product, dpre @ w_hh^T
            **recurrence_bound(gx, w_hh, n_planes=2, n_products=1,
                               bf16_products=bf16)},
    }
    before = dict(rnn_train_ops.launches_bwd_branch)
    # library yardstick of the backward: cuDNN's tanh BiRNN, bias-free; it
    # also computes the input projection's gradients, which the kernel
    # leaves to the caller
    out["rnn_bidir_train_bwd"].update(backward_vs_library(
        torch.nn.RNN, t, b, h,
        lambda: rnn_train_ops.rnn_bidir_train_backward_cuda(w_hh, ys, dy),
        f"rnn, {tag}", "backward kernel"))
    out["rnn_bidir_train_bwd"]["branch"] = "+".join(
        k for k, v in rnn_train_ops.launches_bwd_branch.items() if v != before[k])
    print_recurrence_times(out, tag, t, b, h, dtype, "cuDNN nn.RNN")
    return out


def times_stacked(cell: str, t, b, h, dtype, tag) -> dict:
    """The scan-level stacked entry points of one cell at one shape (``b`` is
    the batch, so ``gx`` is ``(T, 2b, nH)``): the eval call, and the
    trainable call forward and backward, through the kernels and through
    the plain twins.  The re-layout copies around the kernel are in the time."""
    import torch

    eps = stacked_entry_points()
    names = [n for n in (f"{cell}_scan_stacked", f"{cell}_scan_train_stacked")
             if n in eps]
    gates = eps[names[0]][1]
    gx, w_hh, dy = recurrence_inputs(t, 2 * b, h, dtype, seed=8, gates=gates)
    gx, dy = gx[..., :gates * h].contiguous(), dy[..., :h].contiguous()
    out = {}
    for name in names:
        fn, _, trainable, _ = eps[name]

        def call():
            if not trainable:
                return fn(gx, w_hh)
            g, w = gx.detach().requires_grad_(True), w_hh.detach().requires_grad_(True)
            return torch.autograd.grad(fn(g, w), (g, w), dy)

        ms = cuda_ms(call, reps=10)
        with plain_twins():
            plain_ms = cuda_ms(call, reps=2, warmup=1)
        out[name] = {"ms": ms, "plain_ms": plain_ms}
        print(f"  {name}{' forward + backward' if trainable else ''}, {tag} "
              f"T'={t} 2B={2 * b} H={h}: {ms:.4f} ms through the kernels, "
              f"{plain_ms:.4f} ms through the plain twins")
    return out


def times_ctc(t, b, c, l, tag) -> dict:
    """Per-call times of the forward and backward kernels at one shape
    (CUDA events around one call, as the other kernels are timed, and their
    device time, ``graph_ms``), their plain twins, bounds and the ``F.ctc_loss``
    yardstick; the whole loss, forward and backward through
    ``log_softmax``, beside the library's, its wall time and its device
    time with the device kernels of one port call by name (no gather or
    scatter may be left: the loss is the two kernels), and the device time
    of the loss alone (on a log_probs leaf)."""
    import torch
    import torch.nn.functional as F

    _, _, ctc_ops = port_ops()
    log_probs, labels, in_len, lab_len = ctc_inputs(t, b, c, l, seed=9, full=True)
    args = (log_probs, labels, in_len, lab_len)
    g = torch.ones(b, device="cuda")
    neg_ll, alphas = ctc_ops.ctc_fwd_cuda(*args)
    s = 2 * l + 1
    calls = {
        "ctc_alpha": (lambda: ctc_ops.ctc_fwd_cuda(*args),
                      lambda: ctc_ops.ctc_fwd_plain(*args),
                      ctc_ops.launches_fwd_branch, False),
        "ctc_beta": (lambda: ctc_ops.ctc_bwd_cuda(*args, alphas, neg_ll, g),
                     lambda: ctc_ops.ctc_bwd_plain(*args, alphas, neg_ll, g),
                     ctc_ops.launches_bwd_branch, True)}
    out = {}
    for key, (kernel, plain, branches, backward) in calls.items():
        before = dict(branches)
        kernel()
        took = [k for k, v in branches.items() if v != before[k]]
        out[key] = {"ms": cuda_ms(kernel, reps=20),
                    "device_ms": graph_ms(kernel),
                    "plain_ms": cuda_ms(plain, reps=3),
                    "branch": took[0], **ctc_bound(t, b, c, s, backward)}
    # library yardstick: F.ctc_loss's forward computes the alpha table and
    # the loss, its backward the beta table and the logits-space gradient
    lab64, in64, ll64 = (x.long() for x in (labels, in_len, lab_len))
    lp_lib = log_probs.clone().requires_grad_(True)

    def lib_loss(lp):
        return F.ctc_loss(lp, lab64, in64, ll64, reduction="sum")

    with torch.no_grad():
        out["ctc_alpha"]["library_ms"] = cuda_ms(lambda: lib_loss(lp_lib), reps=20)
    loss_lib = lib_loss(lp_lib)
    out["ctc_beta"]["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(loss_lib, lp_lib, retain_graph=True), reps=20)

    logits = torch.randn(t, b, c, device="cuda", requires_grad=True)

    def whole(loss_fn):
        logits.grad = None
        loss_fn(torch.log_softmax(logits, -1)).backward()

    def ours(lp):
        return ctc_ops.ctc_loss(lp, labels, in_len, lab_len, reduction="sum")

    lp_leaf = log_probs.clone().requires_grad_(True)

    def loss_alone():
        lp_leaf.grad = None
        ours(lp_leaf).backward()

    ours_ms = cuda_ms(lambda: whole(ours), reps=10)
    lib_ms = cuda_ms(lambda: whole(lib_loss), reps=10)
    before = (ctc_ops.launches_alpha, ctc_ops.launches_beta)
    whole(ours)
    launched = (ctc_ops.launches_alpha - before[0], ctc_ops.launches_beta - before[1])
    ours_dev, ours_rows = device_breakdown(
        lambda: whole(ours), expect=("ctc_fwd_kernel", "ctc_bwd_kernel"))
    lib_dev, _ = device_breakdown(lambda: whole(lib_loss))
    alone_dev, _ = device_breakdown(loss_alone)
    for k, v in out.items():
        print(f"  {k}, {tag} T'={t} B={b} S={s}: {v['ms']:.4f} ms per call "
              f"({v['device_ms']:.4f} ms on the device, branch {v['branch']}); "
              f"plain {v['plain_ms']:.4f} ms; F.ctc_loss "
              f"{'forward' if k == 'ctc_alpha' else 'backward'} "
              f"{v['library_ms']:.4f} ms; bound {v['bound_ms']:.5f} ms "
              f"({v['bound_by']}: {v['mbytes']:.2f} MB), latency bound "
              f"{v['latency_bound_ms']:.4f} ms")
    print(f"  whole CTC loss, forward and backward through log_softmax, {tag}: "
          f"port {ours_ms:.4f} ms wall, {ours_dev / 1e3:.4f} ms device; "
          f"F.ctc_loss {lib_ms:.4f} ms wall, {lib_dev / 1e3:.4f} ms device; "
          f"the loss alone (no log_softmax) {alone_dev / 1e3:.4f} ms device; "
          f"device kernels of one port call:")
    for n, us in ours_rows:
        print(f"    {us:9.2f} us  {n[:100]}")
    names = [n for n, _ in ours_rows]
    check(not any("scatter" in n or "gather" in n for n in names),
          f"a port loss call still launches a gather or scatter ({tag})")
    check(launched == (1, 1) and any("ctc_fwd_kernel" in n for n in names)
          and any("ctc_bwd_kernel" in n for n in names),
          f"one loss call launched {launched} forward and backward kernels, "
          f"not one each, or the profile lacks one ({tag}: {names})")
    out["ctc_alpha"].update(loss_fwd_bwd_ms=ours_ms,
                            library_loss_fwd_bwd_ms=lib_ms,
                            loss_fwd_bwd_device_ms=ours_dev / 1e3,
                            library_loss_fwd_bwd_device_ms=lib_dev / 1e3,
                            loss_alone_device_ms=alone_dev / 1e3)
    return out


def ctc_step_share(step: dict, ctc: dict) -> dict:
    """The CTC loss's share of the flagship's B=8 train step on the device:
    its two kernels' time in the step's breakdown, and the loss alone (from
    ``times_ctc`` at the same shape, T'=100, B=8, L=33) over the step."""
    in_step = sum(us for n, us in step["train_step_rows"]
                  if "ctc_fwd_kernel" in n or "ctc_bwd_kernel" in n) / 1e3
    alone = ctc["ctc_alpha"]["loss_alone_device_ms"]
    dev = step["train_step_device_ms"]
    print(f"  CTC loss in the flagship's B=8 train step: its kernels "
          f"{in_step:.4f} ms of {dev:.4f} ms on the device "
          f"({100 * in_step / dev:.2f}%); the loss alone {alone:.4f} ms "
          f"({100 * alone / dev:.2f}%)")
    return {"kernels_in_step_ms": in_step, "loss_alone_device_ms": alone,
            "step_device_ms": dev, "share_kernels": in_step / dev,
            "share_loss_alone": alone / dev}


def print_breakdown(what: str, ms: float, busy_us: float, by_kernel, top: int):
    if not by_kernel:
        print("  torch.profiler saw no device time: breakdown not measured")
        return
    print(f"  {what} by device kernel (torch.profiler, one call, "
          f"{busy_us / 1e3:.4f} ms of kernels in all, "
          f"{100 * busy_us / 1e3 / ms:.1f}% of the timed span):")
    for name, us in by_kernel[:top]:
        print(f"    {us / 1e3:9.4f} ms {100 * us / busy_us:5.1f}%  {name[:90]}")


def times_conv_epilogue(cfg, smi: str) -> dict:
    """Device time of the flagship's CNN stack (``cfg``'s), forward in
    train mode and backward, through the conv epilogue's kernels and
    through the twin, at the bf16 ``EPILOGUE_CASES`` (``device_breakdown``,
    in turns twin, kernels, kernels, twin, the smaller of each), with the
    epilogue kernels' own time and their byte bound: each pass over a
    layer's plane once (the statistics' read, the apply's read and write,
    the backward sums' two reads, its apply's two reads and a write) at
    ``HBM_BYTES_PER_S``."""
    import torch

    from tools.probe_cnn_bn import plane_bytes

    stack = epilogue_stack(cfg).train()
    params = list(stack.parameters())
    out = {}
    for b, t, dname in EPILOGUE_CASES:
        if dname != "bfloat16":
            continue
        dtype = torch.bfloat16
        x, tv, em, dy = epilogue_inputs(cfg, stack, b, t, dtype)
        stack.train()

        def call():
            y = stack(x, dtype, t_valid=tv, example_mask=em)
            torch.autograd.grad(y, params, dy)

        ms = {"plain": [], "fused": []}
        kernels_ms = []
        for route in ("plain", "fused", "fused", "plain"):
            if route == "fused":
                us, rows = device_breakdown(call, expect=("cnn_bn_",))
                kernels_ms.append(sum(v for n, v in rows if "cnn_bn_" in n)
                                  / 1e3)
            else:
                with plain_twins():
                    us, rows = device_breakdown(call)
            ms[route].append(us / 1e3)
        bound = (plane_bytes(cfg.cnn, b, t, cfg.rnn_input_size, 2, True)
                 / HBM_BYTES_PER_S * 1e3)
        key = f"b{b}_t{t}"
        out[key] = {"ms": min(ms["fused"]), "plain_ms": min(ms["plain"]),
                    "kernels_ms": min(kernels_ms), "bound_ms": bound,
                    "ms_turns": ms["fused"], "plain_ms_turns": ms["plain"]}
        r = out[key]
        print(f"  CNN stack forward and backward, B={b} T={t} bf16 ({smi}): "
              f"{r['ms']:.4f} ms on the device through the conv epilogue's "
              f"kernels ({r['kernels_ms']:.4f} ms of them, byte bound "
              f"{bound:.4f} ms), {r['plain_ms']:.4f} ms through the twin")
    return out


def times_model(cfg, spec, model, b, t, l, what, tag) -> dict:
    """The decode forward and the whole train step of one model (``what``
    names it, ``cfg`` is its recipe) at one batch shape, CUDA events, with
    the device time by kernel."""
    import torch

    from ctc_pytorch_tpu_torch.train.loop import train_step
    from ctc_pytorch_tpu_torch.train.state import create_train_state

    x = torch.randn(b, t, spec.rnn_input_size, device="cuda")
    frac = torch.ones(b, device="cuda")
    model = model.cuda().eval()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x, frac=frac), reps=10)
        fwd_busy, fwd_rows = device_breakdown(lambda: model(x, frac=frac))
    print(f"  {what} decode forward, {tag} B={b} T={t} bf16: {fwd_ms:.4f} ms")
    print_breakdown("forward", fwd_ms, fwd_busy, fwd_rows, top=8)

    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, seed=cfg.seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, labels, _, lab_len = ctc_inputs(2, b, spec.num_class, l, seed=11, full=True)
    mask = torch.ones(b, device="cuda")

    def step():
        train_step(state, spec, x, frac, labels, lab_len, mask, gen)

    step_ms = cuda_ms(step, reps=10)
    step_busy, step_rows = device_breakdown(step)
    print(f"  {what} train step, {tag} B={b} T={t} L={l} bf16, dropout "
          f"{spec.drop_out}: {step_ms:.4f} ms ({1e3 * b / step_ms:.1f} utts/s)")
    print_breakdown("train step", step_ms, step_busy, step_rows, top=12)
    return {"forward_ms": fwd_ms, "train_step_ms": step_ms,
            "train_step_device_ms": step_busy / 1e3,
            "train_step_rows": step_rows}



# The wide-batch forward branch, timed against the grid it replaced (its
# parent form, tools/parent_forms.py) and cuDNN in turns in one call (phase
# 9): (op, T', B, H, stream dtype).  The wide branch at the
# bench shape on both stream dtypes of the eval forward and at B = 64 (a
# data-parallel rank), the waveform recipe's dev pass (T' = 200), the
# training forward and the GRU on fp32 streams; the tanh cell's forward
# (eval and training: one kernel) and backward (``rnn_bwd``, against cuDNN's
# backward) at the bench shape on fp32 streams.
WIDE_TIMES = [
    ("lstm_eval", 80, 128, 384, "fp32"), ("lstm_eval", 80, 128, 384, "bf16"),
    ("lstm_eval", 80, 64, 384, "fp32"), ("lstm_eval", 80, 64, 384, "bf16"),
    ("lstm_eval", 200, 128, 384, "bf16"), ("lstm_train", 80, 128, 384, "fp32"),
    ("lstm_train", 80, 64, 384, "fp32"), ("gru", 95, 128, 256, "fp32"),
    ("rnn", 80, 128, 384, "fp32"), ("rnn_bwd", 80, 128, 384, "fp32"),
]


# The wide backward's serial chain (csrc/bwd_wide.cuh), timed against the
# grid it replaced (tools/parent_forms.py) and cuDNN's backward in turns in
# one call (phase 9): (cell, T', B, H), fp32 streams.  The LSTM at the
# bench shape and at B = 64 (a data-parallel rank), the GRU at the 863
# model's bench shape.
WIDE_BWD_TIMES = [("lstm", 80, 128, 384), ("lstm", 80, 64, 384),
                  ("gru", 95, 128, 256)]


def serial_bound(gx, w_hh, n_planes: int, n_outs: int) -> dict:
    """Least time for one backward serial chain on fp32 streams: its
    ``n_planes`` fp32 pre-pass planes and dy read, dgx (and ``n_outs`` - 1
    more (T, B, ndir H) planes) written and w_hh read, each once, over the
    memory rate; its one (B, nH) x (nH, H) product a step and direction over
    the fp32 peak (``bound_ms``) and, for its three TF32 passes, over the
    tensor cores' TF32 peak (``tf32x3_bound_ms``)."""
    t, b, _ = gx.shape
    ndir, h, nh = w_hh.shape
    plane = t * b * ndir * h * 4
    bytes_moved = ((n_planes + 1 + (n_outs - 1)) * plane + gx.numel() * 4
                   + w_hh.numel() * 4)
    flops = 2 * ndir * t * b * h * nh
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"serial_bound_ms": max(by_bytes, by_ops) * 1e3,
            "serial_bound_by": "bytes" if by_bytes > by_ops else "operations",
            "tf32x3_bound_ms": max(by_bytes,
                                   3 * flops / TF32_FLOP_PER_S) * 1e3,
            "serial_gflop": flops / 1e9, "serial_mbytes": bytes_moved / 1e6}


def turns(fns: dict, reps: int = 10) -> dict:
    """Each of ``fns`` timed ``ROUNDS`` times in turns (``cuda_ms``):
    ``{name: (median, [rounds])}``."""
    rounds = {k: [] for k in fns}
    for _ in range(ROUNDS):
        for k, fn in fns.items():
            rounds[k].append(cuda_ms(fn, reps=reps))
    return {k: (statistics.median(v), v) for k, v in rounds.items()}


def on_parent(fn):
    """``fn`` run through the parent forms (``tools/parent_forms.py``): the
    grid where the redesigned branches took it over."""
    def run():
        from tools.parent_forms import parent_forms

        with parent_forms():
            return fn()
    return run


# The wide branch's bf16 form against its parent form, the grid (phase 9):
# (op, T', B, H) on bf16 streams: the LSTM training forward at
# DeepSpeech2's longest bucket, the GRU's training forward past its 32-row
# cluster's bound
WIDE_BF16_TIMES = [("lstm_train", 1200, 64, 1024), ("gru", 95, 128, 512)]


def times_wide_bf16(smi: str) -> dict:
    """The LSTM's and GRU's training forwards on ``wide_bf16`` at
    ``WIDE_BF16_TIMES`` against the grid (``tools/parent_forms.py``) and
    cuDNN's bf16 forward in turns, with the bound and the twin; both forms'
    outputs held against each other (the sums differ in order and
    rounding).  Each entry carries ``branch`` = ``wide_bf16``."""
    import torch

    _, train_ops, _ = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    out = {}
    for op, t, b, h in WIDE_BF16_TIMES:
        gru = op == "gru"
        gx, w, _ = recurrence_inputs(t, b, h, torch.bfloat16, seed=7,
                                     gates=3 if gru else 4)
        kern, plain, counts = (
            (gru_train_ops.gru_bidir_train_cuda, gru_ops.gru_bidir_plain,
             gru_train_ops.launches_fwd_branch) if gru else
            (train_ops.lstm_bidir_train_cuda, train_ops.lstm_bidir_train_plain,
             train_ops.launches_fwd_branch))
        net = (torch.nn.GRU if gru else torch.nn.LSTM)(
            2 * h, h, bias=False, bidirectional=True).cuda().to(torch.bfloat16)
        x = torch.randn(t, b, 2 * h, device="cuda", dtype=torch.bfloat16)
        before = dict(counts)
        with torch.no_grad():
            res = turns({"new": lambda: kern(gx, w),
                         "grid": on_parent(lambda: kern(gx, w)),
                         "library": lambda: net(x)}, reps=3)
            new, grid = kern(gx, w), on_parent(lambda: kern(gx, w))()
            plain_ms = cuda_ms(lambda: plain(gx, w), reps=2)
        new = new if isinstance(new, tuple) else (new,)
        grid = grid if isinstance(grid, tuple) else (grid,)
        took = sorted(k for k, v in counts.items() if v != before[k])
        check(took == ["grid", "wide_bf16"],
              f"{op} at B={b} H={h} bf16: the timed launches took {took}")
        bound = recurrence_bound(gx, w, n_planes=1 if gru else 2,
                                 n_products=1, bf16_products=True)
        key = f"{op}_{t}_{b}_{h}_bf16"
        out[key] = {
            "branch": "wide_bf16",
            "ms": res["new"][0], "ms_rounds": res["new"][1],
            "grid_ms": res["grid"][0], "grid_ms_rounds": res["grid"][1],
            "library_ms": res["library"][0],
            "library_ms_rounds": res["library"][1], "plain_ms": plain_ms,
            "us_a_step": 1e3 * res["new"][0] / t,
            "grid_us_a_step": 1e3 * res["grid"][0] / t,
            "max_abs_vs_grid": max(max_err(n, g) for n, g in zip(new, grid)),
            **bound}
        r = out[key]
        print(f"  {key} ({smi}): wide_bf16 {r['ms']:.4f} ms "
              f"{[round(v, 4) for v in r['ms_rounds']]} ({r['us_a_step']:.2f} "
              f"us a step); grid {r['grid_ms']:.4f} "
              f"{[round(v, 4) for v in r['grid_ms_rounds']]} "
              f"({r['grid_us_a_step']:.2f} us a step); cuDNN bf16 "
              f"{r['library_ms']:.4f}; twin {r['plain_ms']:.4f}; bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}; grid / wide "
              f"{r['grid_ms'] / r['ms']:.2f}x; "
              f"{'ys' if gru else 'ys, cs'} against the grid's "
              f"{r['max_abs_vs_grid']:.3g}")
    return out


def times_wide_backward(smi: str) -> dict:
    """The wide backward (``csrc/bwd_wide.cuh``) at ``WIDE_BWD_TIMES``
    against the grid and cuDNN in turns: the pre-pass, the serial chain on
    either branch and both together, with the twin and the bounds."""
    import torch

    _, train_ops, _ = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    out = {}
    for cell, t, b, h in WIDE_BWD_TIMES:
        lstm = cell == "lstm"
        gates, mod = (4, train_ops) if lstm else (3, gru_train_ops)
        gx, w, dy = recurrence_inputs(t, b, h, torch.float32, seed=7,
                                      gates=gates)
        saved = (train_ops.lstm_bidir_train_cuda(gx, w) if lstm
                 else (gru_ops.gru_bidir_cuda(gx, w),))
        fn = {k: getattr(mod, f"{cell}_bidir_train_{k}") for k in (
            "bwd_prepass_cuda", "bwd_serial_cuda", "backward_cuda",
            "backward_plain", "bwd_serial_plain")}
        planes = fn["bwd_prepass_cuda"](gx, w, *saved)
        cudnn = {}
        for name, dt in (("library", torch.float32),
                         ("library_bf16", torch.bfloat16)):
            net = (torch.nn.LSTM if lstm else torch.nn.GRU)(
                2 * h, h, bias=False, bidirectional=True).cuda().to(dt)
            x = torch.randn(t, b, 2 * h, device="cuda", dtype=dt,
                            requires_grad=True)
            y, _ = net(x)
            g = torch.randn_like(y)
            cudnn[name] = (lambda y=y, wrt=(x, *net.parameters()), g=g:
                           torch.autograd.grad(y, wrt, g, retain_graph=True))
        before = dict(mod.launches_bwd_branch)
        res = turns({
            "prepass": lambda: fn["bwd_prepass_cuda"](gx, w, *saved),
            "serial": lambda: fn["bwd_serial_cuda"](planes, w, dy),
            "serial_grid": on_parent(
                lambda: fn["bwd_serial_cuda"](planes, w, dy)),
            "whole": lambda: fn["backward_cuda"](gx, w, *saved, dy),
            "whole_grid": on_parent(
                lambda: fn["backward_cuda"](gx, w, *saved, dy)),
            **cudnn}, reps=10)
        took = sorted(k for k, v in mod.launches_bwd_branch.items()
                      if v != before[k])
        check(took == ["grid", "wide_fp32"],
              f"the {cell} fp32 serial chain at B={b}: the timed launches "
              f"took {took}")
        key = f"{cell}_bwd_{t}_{b}_{h}_fp32"
        out[key] = {
            "ms": res["whole"][0], "ms_rounds": res["whole"][1],
            "serial_ms": res["serial"][0], "serial_ms_rounds": res["serial"][1],
            "prepass_ms": res["prepass"][0],
            "prepass_ms_rounds": res["prepass"][1],
            "grid_ms": res["whole_grid"][0],
            "grid_ms_rounds": res["whole_grid"][1],
            "grid_serial_ms": res["serial_grid"][0],
            "grid_serial_ms_rounds": res["serial_grid"][1],
            "library_ms": res["library"][0],
            "library_ms_rounds": res["library"][1],
            "library_ms_bf16": res["library_bf16"][0],
            "library_ms_bf16_rounds": res["library_bf16"][1],
            "plain_ms": cuda_ms(lambda: fn["backward_plain"](
                gx, w, *saved, dy), reps=2),
            "serial_plain_ms": cuda_ms(lambda: fn["bwd_serial_plain"](
                planes, w, dy), reps=2),
            **recurrence_bound(gx, w, n_planes=3, n_products=2,
                               n_gate_planes=2),
            **serial_bound(gx, w, n_planes=mod.PLANES, n_outs=1 if lstm else 2)}
        r = out[key]
        print(f"  {cell} fp32 backward T={t} B={b} H={h} ({smi}): serial chain "
              f"wide_fp32 {r['serial_ms']:.4f} ms "
              f"{[round(v, 4) for v in r['serial_ms_rounds']]} "
              f"({1e3 * r['serial_ms'] / t:.2f} us a step), grid "
              f"{r['grid_serial_ms']:.4f} "
              f"{[round(v, 4) for v in r['grid_serial_ms_rounds']]} "
              f"({1e3 * r['grid_serial_ms'] / t:.2f} us a step); pre-pass "
              f"{r['prepass_ms']:.4f} "
              f"{[round(v, 4) for v in r['prepass_ms_rounds']]}; pre-pass + "
              f"serial {r['ms']:.4f} {[round(v, 4) for v in r['ms_rounds']]}, "
              f"on the grid {r['grid_ms']:.4f} "
              f"{[round(v, 4) for v in r['grid_ms_rounds']]}; cuDNN backward "
              f"fp32 {r['library_ms']:.4f}, bf16 {r['library_ms_bf16']:.4f}; "
              f"twin {r['plain_ms']:.4f} (serial {r['serial_plain_ms']:.4f}); "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']}, serial chain "
              f"{r['serial_bound_ms']:.4f} by {r['serial_bound_by']}, its "
              f"3xTF32 on the tensor cores {r['tf32x3_bound_ms']:.4f}; grid / "
              f"wide serial {r['grid_serial_ms'] / r['serial_ms']:.2f}x")

    return out


# The fp32 backward pre-pass (prepass_tf32_kernel, csrc/bwd_hoist.cuh)
# timed in phase 9: (cell, T', B, H), fp32 streams, two directions.  The
# main paths' shapes (the flagship's batch of 8, mfcc_39's longest batch, a
# data-parallel rank's 4, the 863 GRU model's 8) and the bench batches
# (the LSTM's 128 and a data-parallel rank's 64, the GRU's 128).
PREPASS_TIMES = [("lstm", 100, 8, 384), ("lstm", 400, 8, 256),
                 ("lstm", 100, 4, 384), ("lstm", 80, 128, 384),
                 ("lstm", 80, 64, 384), ("gru", 95, 128, 256),
                 ("gru", 95, 8, 256)]


def times_prepass_tf32(smi: str) -> dict:
    """The fp32 pre-pass at ``PREPASS_TIMES``, timed in turns with its
    cuBLAS yardstick: ``torch.matmul`` of h_prev (ndir, T B, H) by w_hh
    (ndir, H, G H) in full fp32 (``allow_tf32`` off), the product alone,
    which the port never calls; each also on the device alone
    (``graph_ms``: the host's launch cost, a large part of a call at B <=
    8, out of the measure); with the twin's time and the bounds
    (``prepass_bound``: bytes, 3xTF32 and fp32 FMA)."""
    import torch

    from ctc_pytorch_tpu_torch.ops._build import shifted

    _, train_ops, _ = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the pre-pass yardstick must multiply in fp32")
    out = {}
    for cell, t, b, h in PREPASS_TIMES:
        lstm = cell == "lstm"
        gates, mod = (4, train_ops) if lstm else (3, gru_train_ops)
        gx, w, _ = recurrence_inputs(t, b, h, torch.float32, seed=7,
                                     gates=gates)
        saved = (train_ops.lstm_bidir_train_cuda(gx, w) if lstm
                 else (gru_ops.gru_bidir_cuda(gx, w),))
        kernel = getattr(mod, f"{cell}_bidir_train_bwd_prepass_cuda")
        plain = getattr(mod, f"{cell}_bidir_train_bwd_prepass_plain")
        h_prev = shifted(saved[0], 2, torch.float32).reshape(2, t * b, h)
        before = mod.launches_bwd_prepass_tf32
        res = turns({"kernel": lambda: kernel(gx, w, *saved),
                     "library": lambda: torch.matmul(h_prev, w)}, reps=20)
        check(mod.launches_bwd_prepass_tf32 > before,
              f"the {cell} fp32 pre-pass launched no prepass_tf32_kernel")
        key = f"{cell}_prepass_{t}_{b}_{h}_fp32"
        r = out[key] = {
            "ms": res["kernel"][0], "ms_rounds": res["kernel"][1],
            "library_ms": res["library"][0],
            "library_ms_rounds": res["library"][1],
            "device_ms": graph_ms(lambda: kernel(gx, w, *saved)),
            "library_device_ms": graph_ms(lambda: torch.matmul(h_prev, w)),
            "plain_ms": cuda_ms(lambda: plain(gx, w, *saved), reps=3),
            **prepass_bound(gx, w, n_saved=2 if lstm else 1,
                            n_planes=mod.PLANES, bf16=False)}
        print(f"  {cell} fp32 pre-pass T'={t} B={b} H={h} ({smi}): "
              f"prepass_tf32_kernel {r['ms']:.4f} ms "
              f"{[round(v, 4) for v in r['ms_rounds']]}, on the device "
              f"{r['device_ms']:.4f}; cuBLAS fp32 product alone "
              f"{r['library_ms']:.4f} "
              f"{[round(v, 4) for v in r['library_ms_rounds']]}, on the device "
              f"{r['library_device_ms']:.4f}; twin "
              f"{r['plain_ms']:.4f}; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['mbytes']:.1f} MB: {r['bytes_ms']:.4f}; "
              f"{r['gflop']:.2f} GFLOP: 3xTF32 {r['tf32x3_ops_ms']:.4f}, fp32 "
              f"FMA {r['fp32_ops_ms']:.4f}), on the device "
              f"{r['device_ms'] / r['bound_ms']:.1f}x its bound, "
              f"{r['gflop'] / r['device_ms']:.1f} TFLOP/s")
    return out


def times_redesigned(spec, model, smi: str) -> dict:
    """The redesigned branches against their parent form, the grid, and
    cuDNN, in turns: the fp32-product forwards on ``wide_fp32`` at
    ``WIDE_TIMES`` (with the twin, the fp32 bound and the 3xTF32
    tensor-core bound), the LSTM's and GRU's fp32 backward on
    ``wide_fp32`` (``times_wide_backward``), the GRU backward's fp32 serial
    chain on ``cluster16_fp32`` at (95, 8, 256) alone and with its pre-pass
    (cuDNN's fp32 backward beside it), the LSTM training forward's bf16
    form ``wide_bf16`` at DeepSpeech2's shape (``times_wide_bf16``), and
    the flagship's B=128 decode forward with its eval forwards on the wide
    branch and on the grid."""
    import torch

    lstm_ops, train_ops, _ = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    rnn_ops, rnn_train_ops = port_rnn_ops()
    out = {}
    for op, t, b, h, name in WIDE_TIMES:
        dt = torch.bfloat16 if name == "bf16" else torch.float32
        cell = op.split("_")[0]
        gates = {"gru": 3, "rnn": 1}.get(cell, 4)
        gx, w, dy = recurrence_inputs(t, b, h, dt, seed=7, gates=gates)
        if op == "rnn_bwd":  # the backward of the twin's ys
            ys = rnn_ops.rnn_bidir_plain(gx, w)
            kern, plain, counts = (
                lambda gx, w: rnn_train_ops.rnn_bidir_train_backward_cuda(
                    w, ys, dy),
                lambda gx, w: rnn_train_ops.rnn_bidir_train_backward_plain(
                    w, ys, dy),
                rnn_train_ops.launches_bwd_branch)
        else:
            kern, plain, counts = {
                "lstm_eval": (lstm_ops.lstm_bidir_cuda,
                              lstm_ops.lstm_bidir_plain,
                              lstm_ops.launches_fwd_branch),
                "lstm_train": (train_ops.lstm_bidir_train_cuda,
                               train_ops.lstm_bidir_train_plain,
                               train_ops.launches_fwd_branch),
                "gru": (gru_ops.gru_bidir_cuda, gru_ops.gru_bidir_plain,
                        gru_ops.launches_fwd_branch),
                "rnn": (rnn_ops.rnn_bidir_cuda, rnn_ops.rnn_bidir_plain,
                        rnn_ops.launches_fwd_branch)}[op]
        train = op in ("lstm_train", "rnn_bwd")
        net = {"gru": torch.nn.GRU, "rnn": torch.nn.RNN}.get(
            cell, torch.nn.LSTM)(2 * h, h, bias=False, bidirectional=True).cuda()
        x = torch.randn(t, b, 2 * h, device="cuda", requires_grad=train)
        if op == "rnn_bwd":  # cuDNN's backward, input gradients included
            y_lib, _ = net(x)
            g_lib = torch.randn_like(y_lib)

            def library():
                torch.autograd.grad(y_lib, (x, *net.parameters()), g_lib,
                                    retain_graph=True)
        else:
            def library():
                net(x)
        before = dict(counts)
        with torch.set_grad_enabled(train):
            res = turns({"new": lambda: kern(gx, w),
                         "grid": on_parent(lambda: kern(gx, w)),
                         "library": library})
        took = sorted(k for k, v in counts.items() if v != before[k])
        check(took == ["grid", "wide_fp32"],
              f"{op} at B={b}: the timed launches took {took}")
        # the tanh backward reads ys and dy and writes dgx (gx-sized)
        bound = recurrence_bound(gx, w, n_planes=2 if train else 1,
                                 n_products=1)
        key = f"{op}_{t}_{b}_{h}_{name}"
        out[key] = {
            "ms": res["new"][0], "ms_rounds": res["new"][1],
            "grid_ms": res["grid"][0], "grid_ms_rounds": res["grid"][1],
            "library_ms": res["library"][0],
            "library_ms_rounds": res["library"][1],
            "plain_ms": cuda_ms(lambda: plain(gx, w), reps=2),
            "tf32x3_bound_ms": 3 * bound["gflop"] * 1e9 / TF32_FLOP_PER_S * 1e3,
            **bound}
        r = out[key]
        print(f"  {key} ({smi}): wide_fp32 {r['ms']:.4f} ms "
              f"{[round(v, 4) for v in r['ms_rounds']]} ({1e3 * r['ms'] / t:.2f}"
              f" us a step); grid {r['grid_ms']:.4f} "
              f"{[round(v, 4) for v in r['grid_ms_rounds']]}; cuDNN fp32 "
              f"{r['library_ms']:.4f}; twin {r['plain_ms']:.4f}; bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}, 3xTF32 on the tensor "
              f"cores {r['tf32x3_bound_ms']:.4f}; grid / wide "
              f"{r['grid_ms'] / r['ms']:.2f}x")

    out.update(times_wide_backward(smi))
    out.update(times_wide_bf16(smi))

    # the GRU backward on fp32 streams at B = 8 (the 863 model over two
    # data-parallel ranks): the serial chain's cluster against the grid
    t, b, h = 95, 8, 256
    gx, w, dy = recurrence_inputs(t, b, h, torch.float32, seed=7, gates=3)
    ys = gru_ops.gru_bidir_plain(gx, w)
    planes = gru_train_ops.gru_bidir_train_bwd_prepass_cuda(gx, w, ys)
    before = dict(gru_train_ops.launches_bwd_branch)
    res = turns({
        "serial": lambda: gru_train_ops.gru_bidir_train_bwd_serial_cuda(
            planes, w, dy),
        "serial_grid": on_parent(
            lambda: gru_train_ops.gru_bidir_train_bwd_serial_cuda(
                planes, w, dy))}, reps=20)
    took = sorted(k for k, v in gru_train_ops.launches_bwd_branch.items()
                  if v != before[k])
    check(took == ["cluster16_fp32", "grid"],
          f"the GRU fp32 serial chain's timed launches took {took}")
    whole = backward_vs_library(
        torch.nn.GRU, t, b, h,
        lambda: gru_train_ops.gru_bidir_train_backward_cuda(gx, w, ys, dy),
        f"gru fp32 backward T={t} B={b} H={h}")
    bound = recurrence_bound(gx, w, n_planes=3, n_products=2, n_gate_planes=2)
    out["gru_bwd_95_8_256_fp32"] = {
        "serial_ms": res["serial"][0], "serial_ms_rounds": res["serial"][1],
        "grid_serial_ms": res["serial_grid"][0],
        "grid_serial_ms_rounds": res["serial_grid"][1],
        "ms": whole["ms"], "ms_rounds": whole["ms_rounds"],
        "library_ms": whole["library_ms"],
        "library_ms_bf16": whole["library_ms_bf16"],
        "plain_ms": cuda_ms(
            lambda: gru_train_ops.gru_bidir_train_backward_plain(gx, w, ys, dy),
            reps=2),
        **bound}
    r = out["gru_bwd_95_8_256_fp32"]
    print(f"  gru fp32 backward T={t} B={b} H={h} ({smi}): serial chain "
          f"cluster16_fp32 {r['serial_ms']:.4f} ms "
          f"{[round(v, 4) for v in r['serial_ms_rounds']]} "
          f"({1e3 * r['serial_ms'] / t:.2f} us a step), grid "
          f"{r['grid_serial_ms']:.4f} {[round(v, 4) for v in r['grid_serial_ms_rounds']]}"
          f"; pre-pass + serial {r['ms']:.4f}; cuDNN fp32 {r['library_ms']:.4f}"
          f"; twin {r['plain_ms']:.4f}; bound {r['bound_ms']:.4f} by "
          f"{r['bound_by']}")

    # the flagship's B=128 decode forward: its eval forwards on the wide
    # branch, and (the parent form) on the grid
    x = torch.randn(128, 160, spec.rnn_input_size, device="cuda")
    frac = torch.ones(128, device="cuda")
    model = model.cuda().eval()
    before = dict(lstm_ops.launches_fwd_branch)
    with torch.inference_mode():
        res = turns({"new": lambda: model(x, frac=frac),
                     "grid": on_parent(lambda: model(x, frac=frac))})
    took = sorted(k for k, v in lstm_ops.launches_fwd_branch.items()
                  if v != before[k])
    check(took == ["grid", "wide_fp32"],
          f"the decode forward's eval launches took {took}")
    out["flagship_decode_forward_b128"] = {
        "ms": res["new"][0], "ms_rounds": res["new"][1],
        "grid_ms": res["grid"][0], "grid_ms_rounds": res["grid"][1]}
    r = out["flagship_decode_forward_b128"]
    print(f"  flagship decode forward B=128 T=160 bf16 ({smi}): eval forwards "
          f"on wide_fp32 {r['ms']:.4f} ms {[round(v, 4) for v in r['ms_rounds']]}"
          f", on the grid {r['grid_ms']:.4f} "
          f"{[round(v, 4) for v in r['grid_ms_rounds']]}: "
          f"{r['grid_ms'] - r['ms']:.4f} ms saved")
    return out


# Phase 16's fp32 decode forwards at B = 128 run from features at these
# scales and seeds: at 0.05 random weights leave the gates unsaturated, at
# unit scale they are the features the recipes' front ends give; one more
# at unit scale from the global generator, wherever the run has left it
# (one such input once gave a NaN here that no seeded input or NaN-fill
# run has reproduced, PERF.md).  The NaN-fill runs take the first two seeds.
DECODE_SCALES = (0.05, 1.0)
DECODE_SEEDS = (0, 1, 2)
# (op, T', B, H, stream dtype) of the NaN-fill runs: the LSTM eval and
# training forwards and the GRU forward at B = 128, a B that is not a
# multiple of 16; the LSTM's and GRU's backward serial chains (the wide
# backward, csrc/bwd_wide.cuh) at B = 128 and at a B that is not a multiple
# of 16; the tanh cell's forward and backward (csrc/fwd_wide.cuh) at B = 128
# and B = 130; the bf16 form (wide_bf16) of the LSTM training forward at
# DeepSpeech2's width and of the GRU at B = 130; launches a run
WIDE_NAN_CASES = [("lstm_eval", 95, 128, 384, "fp32"),
                  ("lstm_eval", 95, 128, 384, "bf16"),
                  ("lstm_train", 80, 128, 384, "fp32"),
                  ("gru", 95, 128, 256, "fp32"), ("gru", 95, 130, 256, "fp32"),
                  ("lstm_bwd", 80, 128, 384, "fp32"),
                  ("lstm_bwd", 80, 100, 384, "fp32"),
                  ("gru_bwd", 95, 128, 256, "fp32"),
                  ("gru_bwd", 95, 130, 256, "fp32"),
                  ("rnn", 80, 128, 384, "fp32"), ("rnn", 80, 130, 384, "fp32"),
                  ("rnn_bwd", 80, 128, 384, "fp32"),
                  ("rnn_bwd", 80, 130, 384, "fp32"),
                  ("lstm_train", 80, 64, 1024, "bf16"),
                  ("gru", 40, 130, 512, "bf16")]
WIDE_NAN_LAUNCHES = 25


def decode_b128(spec, scale: float, seed, device: str) -> dict:
    """``spec``'s model (random weights from a seed) decoding B = 128
    utterances of 200 frames through the kernels and through the plain
    twins, from features drawn at ``scale`` from ``seed`` (None: from the
    global generator, wherever the run has left it): the features' largest
    magnitude, whether each side's log-probs are finite, and their largest
    difference."""
    import torch

    model = seeded_model(spec).to(device).eval()
    gen = None if seed is None else torch.Generator(device=device).manual_seed(seed)
    x = scale * torch.randn(128, 200, spec.rnn_input_size, generator=gen,
                            device=device)
    frac = torch.ones(128, device=device)
    with torch.inference_mode():
        got = model(x, frac=frac)
        with plain_twins():
            want = model(x, frac=frac)
    sync()
    finite = [bool(torch.isfinite(y).all()) for y in (got, want)]
    return {"scale": scale, "seed": seed, "x_max_abs": x.abs().max().item(),
            "max_abs_err": max_err(got, want), "finite_kernels": finite[0],
            "finite_twins": finite[1], "finite": all(finite)}


def greedy_b128(cfg, spec, seed: int, device: str) -> dict:
    """``spec``'s model (random weights from a seed) decoding B = 128
    utterances of up to 200 frames (features and lengths from ``seed``, the
    first row full length) through stage 4's calls, ``CTCModel.forward``,
    ``CTCModel.input_sizes`` and ``GreedyDecoder.decode``, through the
    kernels and through the plain twins: both sides' strings, the log-probs'
    largest difference and whether both are finite; ``forward`` runs the
    kernels' forward alone, for the timings."""
    import torch

    from ctc_pytorch_tpu_torch.decode import GreedyDecoder
    from ctc_pytorch_tpu_torch.models import CTCModel
    from ctc_pytorch_tpu_torch.vocab import Vocab

    model = seeded_model(spec).to(device).eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(128, 200, spec.rnn_input_size, generator=gen,
                    device=device)
    lens = torch.randint(100, 201, (128,), generator=gen, device=device)
    lens[0] = 200
    frac = lens.float() / 200.0
    decoder = GreedyDecoder(Vocab(cfg.vocab_file).index2word)

    def run():
        with torch.inference_mode():
            lp = model(x, frac=frac)
            sizes = CTCModel.input_sizes(spec, frac, x.shape[1], lp.shape[0])
            return lp, decoder.decode(lp, sizes)

    got, strings = run()
    with plain_twins():
        want, strings_twins = run()
    sync()

    def forward():
        with torch.inference_mode():
            model(x, frac=frac)

    return {"seed": seed, "strings": strings, "strings_twins": strings_twins,
            "max_abs_err": max_err(got, want),
            "finite": bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all()), "forward": forward}


def wide_nan_launches(op: str, t: int, b: int, h: int, name: str,
                      scale: float, seed: int, n: int) -> dict:
    """``n`` launches of a wide branch's entry (``op``: the LSTM eval or
    training forward, the GRU forward or the tanh forward, ``rnn``; the
    LSTM's or GRU's backward serial chain, ``lstm_bwd`` and ``gru_bwd``, or
    the tanh backward, ``rnn_bwd``) at (t, b, h) on ``name`` streams with
    gates drawn at ``scale`` from ``seed``, each after filling the exchange
    buffer with NaN and the step flags with a large count (the library
    zeroes them): a read of a block of h (of a partial dh; of the tanh
    backward's dpre) before its writers published it reads NaN at the first
    step and a stale value after, and the kernel is deterministic.  Counts
    the launches whose output holds a non-finite value or differs in any bit
    from the first; the first is held against the twin.  Needs the card."""
    import ctypes

    import torch

    from ctc_pytorch_tpu_torch.ops import _build

    if op in ("lstm_bwd", "gru_bwd"):
        return wide_bwd_nan_launches(op, t, b, h, scale, seed, n)
    lstm_ops, train_ops, _ = port_ops()
    gru_ops, _ = port_gru_ops()
    rnn_ops, rnn_train_ops = port_rnn_ops()
    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    gx, w_hh, dy = recurrence_inputs(
        t, b, h, dtype, seed=seed, scale=scale,
        gates={"gru": 3, "rnn": 1, "rnn_bwd": 1}.get(op, 4))
    ops, prefix, plain = {
        "lstm_eval": (lstm_ops, "lstm_bidir", lstm_ops.lstm_bidir_plain),
        "lstm_train": (train_ops, "lstm_bidir_train",
                       train_ops.lstm_bidir_train_plain),
        "gru": (gru_ops, "gru_bidir", gru_ops.gru_bidir_plain),
        "rnn": (rnn_ops, "rnn_bidir", rnn_ops.rnn_bidir_plain),
        "rnn_bwd": (rnn_train_ops, "rnn_bidir_train",
                    rnn_train_ops.rnn_bidir_train_backward_plain)}[op]
    lib = ops.LIBRARY.load()
    # the weights as the op's wrapper passes them
    w = (w_hh.contiguous() if op == "lstm_eval"
         else w_hh.to(dtype).float().contiguous())
    bf16 = int(dtype == torch.bfloat16)
    ys = torch.empty(t, b, 2 * h, dtype=dtype, device="cuda")
    outs = [ys] + ([torch.empty_like(ys)] if op == "lstm_train" else [])
    # the gated cells' bf16 products take the bf16 form, its buffer bf16
    wide = ("wide_bf16" if name == "bf16" and op in ("lstm_train", "gru")
            else "wide_fp32")
    n_hx, n_flags = _build.wide_scratch_sizes(b, h, 2, wide == "wide_bf16")
    hx = torch.empty(n_hx, device="cuda", dtype=torch.bfloat16
                     if wide == "wide_bf16" else torch.float32)
    flags = torch.empty(n_flags, dtype=torch.int32, device="cuda")
    branch = ctypes.c_int(-1)
    if op == "rnn_bwd":  # the backward of the twin's ys; dgx into ys
        saved = rnn_ops.rnn_bidir_plain(gx, w_hh)
        args = (w.data_ptr(), saved.data_ptr(), dy.data_ptr())
        entry = getattr(lib, f"{prefix}_backward")
    else:
        args = (gx.data_ptr(), w.data_ptr())
        entry = getattr(lib, f"{prefix}_forward")

    def launch():
        hx.fill_(float("nan"))
        flags.fill_(1 << 20)
        err = entry(
            *args, *[o.data_ptr() for o in outs],
            hx.data_ptr(), flags.data_ptr(), t, b, h, -(-b // 4) * 4, 2, bf16,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(branch))
        check(err == 0 and _build.FWD_BRANCHES[branch.value] == wide,
              f"{op} at ({t}, {b}, {h}) {name}: launch {err}, branch "
              f"{branch.value}")

    launch()
    first = [o.clone() for o in outs]
    want = (plain(w_hh, saved, dy) if op == "rnn_bwd" else plain(gx, w_hh))
    want = list(want) if isinstance(want, tuple) else [want]
    bad = torch.zeros(2, dtype=torch.int32, device="cuda")
    for o in first:
        bad[0] += (~torch.isfinite(o)).any().int()
    for _ in range(n - 1):
        launch()
        for o, f in zip(outs, first):
            bad[0] += (~torch.isfinite(o)).any().int()
            bad[1] += (o != f).any().int()
    nonfinite, differing = bad.tolist()
    return {"op": op, "t": t, "b": b, "h": h, "dtype": name, "scale": scale,
            "seed": seed, "launches": n, "nonfinite_launches": nonfinite,
            "differing_launches": differing,
            "twin_max_abs_err": max(max_err(g, x) for g, x in zip(first, want))}


def wide_bwd_nan_launches(op: str, t: int, b: int, h: int, scale: float,
                          seed: int, n: int) -> dict:
    """``wide_nan_launches`` for the wide backward's serial chain (``op``
    ``lstm_bwd`` or ``gru_bwd``, fp32 streams) over the twin's pre-pass
    planes: its exchange buffer of partial dh filled with NaN and its step
    flags with a large count before each launch; the outputs are dgx (and
    the GRU's dhhn), the first held against the serial twin."""
    import ctypes

    import torch

    from ctc_pytorch_tpu_torch.ops import _build

    _, train_ops, _ = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    lstm = op == "lstm_bwd"
    gates, mod = (4, train_ops) if lstm else (3, gru_train_ops)
    prefix = "lstm_bidir_train" if lstm else "gru_bidir_train"
    gx, w_hh, dy = recurrence_inputs(t, b, h, torch.float32, seed=seed,
                                     gates=gates, scale=scale)
    if lstm:
        planes = train_ops.lstm_bidir_train_bwd_prepass_plain(
            gx, w_hh, *train_ops.lstm_bidir_train_plain(gx, w_hh))
    else:
        planes = gru_train_ops.gru_bidir_train_bwd_prepass_plain(
            gx, w_hh, gru_ops.gru_bidir_plain(gx, w_hh))
    buf, hp = _build.padded_planes(planes)
    lib = mod.LIBRARY.load()
    dgx = torch.empty(t, b, 2 * gates * h, device="cuda")
    outs = [dgx] + ([] if lstm else [torch.empty_like(dy)])
    xbuf, flags = _build.serial_scratch(lib, prefix, "wide_fp32", b, h, 2, 0,
                                        "cuda")
    branch = ctypes.c_int(-1)

    def launch():
        xbuf.fill_(float("nan"))
        flags.fill_(1 << 20)
        err = getattr(lib, f"{prefix}_backward")(
            buf.data_ptr(), w_hh.data_ptr(), dy.data_ptr(),
            *[o.data_ptr() for o in outs], xbuf.data_ptr(), flags.data_ptr(),
            *([None] if lstm else []), t, b, h, hp, -(-b // 4) * 4, 2, 0,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(branch))
        check(err == 0 and _build.BRANCHES[branch.value] == "wide_fp32",
              f"{op} at ({t}, {b}, {h}): launch {err}, branch {branch.value}")

    launch()
    first = [o.clone() for o in outs]
    want = getattr(mod, f"{prefix}_bwd_serial_plain")(planes, w_hh, dy)
    want = list(want) if isinstance(want, tuple) else [want]
    bad = torch.zeros(2, dtype=torch.int32, device="cuda")
    for o in first:
        bad[0] += (~torch.isfinite(o)).any().int()
    for _ in range(n - 1):
        launch()
        for o, f in zip(outs, first):
            bad[0] += (~torch.isfinite(o)).any().int()
            bad[1] += (o != f).any().int()
    nonfinite, differing = bad.tolist()
    return {"op": op, "t": t, "b": b, "h": h, "dtype": "fp32", "scale": scale,
            "seed": seed, "launches": n, "nonfinite_launches": nonfinite,
            "differing_launches": differing,
            "twin_max_abs_err": max(max_err(g, x) for g, x in zip(first, want))}


def phase_fp32_streams(cfg_863, spec_863, cfg, spec, cfg_tanh, spec_tanh,
                       smi: str, device: str = "cuda") -> dict:
    """Phase 16, fp32 streams where the redesigned branches run them: the
    863 GRU model's train step at B = 8 (the recipe's 16 over two
    data-parallel ranks), two steps through the kernels and through the
    twins, the GRU forwards and backward on ``cluster16_fp32``; its fp32
    decode forward at B = 128 and the flagship's, the eval forwards on
    ``wide_fp32``, against the twins from unit-scale features of the global
    generator and at ``DECODE_SCALES`` over ``DECODE_SEEDS``; the wide
    branches, forward and backward, under a NaN-filled exchange buffer
    (``wide_nan_launches`` at ``WIDE_NAN_CASES``); the flagship's, the 863
    GRU model's and the tanh model's fp32 train steps at B = 128, the
    training forwards and the backwards' serial chains (the tanh backward
    whole) on ``wide_fp32``, held against the twins and timed against the
    parent forms (the grid); and the tanh model's fp32 greedy decode at B =
    128 (``greedy_b128``), the eval forwards on ``wide_fp32``, its strings
    those of the twins, its forward timed against the grid.  Returns the
    launches by op and branch.  With ``device="cpu"`` (a rehearsal: every op
    its twin) the branches are not checked, and neither the NaN fill nor
    the timings run."""
    import torch

    on_card = device != "cpu"
    gru_ops, gru_train_ops = port_gru_ops()
    rnn_ops, rnn_train_ops = port_rnn_ops()
    out = {}
    spec32 = dataclasses.replace(spec_863, compute_dtype="float32", drop_out=0.0)
    n = spec32.rnn_layers
    batch = dp_batch(spec32, 8, 200, 40, seed=16)
    zero_counts()
    got = dp_steps(spec32, cfg_863, batch, None, device)
    got["prepass_tf32"] = gru_train_ops.launches_bwd_prepass_tf32
    took = path_branches() | {
        "gru_bidir_train_fwd": {k: v for k, v in
                                gru_train_ops.launches_fwd_branch.items() if v},
        "gru_bidir_train_bwd": {k: v for k, v in
                                gru_train_ops.launches_bwd_branch.items() if v},
        "gru_bidir": {k: v for k, v in gru_ops.launches_fwd_branch.items() if v}}
    if on_card:
        check(took["gru_bidir_train_fwd"] == {"cluster16_fp32": 2 * n},
              f"the 863 GRU step at B=8 fp32: the training forward took {took}")
        check_fp32_bwd_branch("the 863 GRU step at B=8 fp32",
                              gru_train_ops.launches_bwd_branch, 2 * n, "GRU",
                              gru_train_ops.launches_bwd_prepass_tf32)
    with plain_twins():
        want = dp_steps(spec32, cfg_863, batch, None, device)
    rel = max(abs(x - y) / abs(y) for x, y in zip(
        got["losses"] + [got["eval_loss"]], want["losses"] + [want["eval_loss"]]))
    n_off, n_all, worst, key = states_apart(got["state"], want["state"])
    print(f"  863 GRU model, two fp32 steps and an eval step at B=8 ({smi}): "
          f"losses {got['losses']}, eval {got['eval_loss']:.6g} through the "
          f"kernels vs {want['losses']}, {want['eval_loss']:.6g} through the "
          f"twins (rel {rel:.3g}, tol {STEP_LOSS_RTOL}); {n_off} of {n_all} "
          f"entries past {STEP_TOL}, largest {worst:.3g} at {key}; branches "
          f"{took}")
    check(rel <= STEP_LOSS_RTOL, "the 863 GRU fp32 B=8 losses differ from the twins")
    check(n_off <= STEP_OFF_SHARE * n_all and worst <= 2.01 * 2 * cfg_863.init_lr,
          "the 863 GRU fp32 B=8 parameters differ from the twins")
    # the backward's pre-passes, all on prepass_tf32_kernel (above)
    took["gru_bidir_train_bwd_prepass"] = {
        "prepass_tf32_kernel": got["prepass_tf32"]}
    out["gru_b8"] = {"losses": got["losses"], "eval_loss": got["eval_loss"],
                     "rel_vs_twins": rel, "branches": took}

    # the fp32 decode forwards at B = 128 of the 863 GRU model and the
    # flagship: their eval forwards on the wide branch, from features at
    # 0.05 (the gates unsaturated) and at unit scale, over seeds
    for key, spec_d, op, counts in (
            ("gru_b128_forward", spec32, "gru_bidir", gru_ops.launches_fwd_branch),
            ("flagship_b128_forward",
             dataclasses.replace(spec, compute_dtype="float32", drop_out=0.0),
             "lstm_bidir", port_ops()[0].launches_fwd_branch)):
        zero_counts()
        runs = [decode_b128(spec_d, 1.0, None, device)]
        for scale in DECODE_SCALES:
            for seed in DECODE_SEEDS:
                runs.append(decode_b128(spec_d, scale, seed, device))
        took = {k: v for k, v in counts.items() if v}
        err = max(r["max_abs_err"] for r in runs)
        finite = all(r["finite"] for r in runs)
        by_run = [f"{r['max_abs_err']:.3g}" for r in runs]
        print(f"  {key} fp32 B=128 T=200, features at unit scale from the "
              f"global generator (max |x| {runs[0]['x_max_abs']:.3g}), then at "
              f"scales {DECODE_SCALES} x seeds {DECODE_SEEDS}: the kernels' "
              f"log-probs against the twins' max_abs_err by run {by_run} (tol "
              f"{FP32_TOL}), all finite {finite}; eval forwards {took}")
        n_runs = len(runs) * spec_d.rnn_layers
        check(not on_card or took == {"wide_fp32": n_runs},
              f"the {key} fp32 B=128 eval forwards took {took}")
        check(finite and err <= FP32_TOL,
              f"the {key} fp32 B=128 decode differs from the twins")
        out[key] = {"runs": runs, "max_abs_err": err, "branches": {op: took}}
    if on_card:
        # the wide branch's exchange buffer filled with NaN before every
        # launch: a read of h before its writers published it shows
        runs = [wide_nan_launches(*case, scale, seed, WIDE_NAN_LAUNCHES)
                for case in WIDE_NAN_CASES for scale in DECODE_SCALES
                for seed in DECODE_SEEDS[:2]]
        bad = sum(r["nonfinite_launches"] + r["differing_launches"]
                  for r in runs)
        worst = max(r["twin_max_abs_err"] for r in runs
                    if r["dtype"] == "fp32")
        print(f"  wide_fp32 forwards and backwards under a NaN-filled "
              f"exchange buffer ({smi}): "
              f"{sum(r['launches'] for r in runs)} launches over "
              f"{WIDE_NAN_CASES} at scales {DECODE_SCALES}, {bad} non-finite "
              f"or differing from their first; first vs twin {worst:.3g}")
        check(bad == 0 and worst <= FP32_TOL,
              "a wide branch read its exchange buffer before it was published")
        out["wide_nan_fill"] = {"runs": runs, "branches": {}}

    # the fp32 train steps at B = 128 of the flagship, the 863 GRU model and
    # the tanh model: the training forwards and the backwards' serial chains
    # (the tanh backward whole) on the wide branches, held against the
    # twins, then timed against the parent forms
    spec_f = dataclasses.replace(spec, compute_dtype="float32", drop_out=0.0)
    spec_t = dataclasses.replace(spec_tanh, compute_dtype="float32",
                                 drop_out=0.0)
    lstm_ops, train_ops, _ = port_ops()
    for key, spec_s, cfg_s, batch, prefix, eval_counts in (
            ("flagship_b128_fp32_step", spec_f, cfg,
             dp_batch(spec_f, 128, 160, 48, seed=17), "lstm_bidir",
             lstm_ops.launches_fwd_branch),
            ("gru_b128_fp32_step", spec32, cfg_863,
             dp_batch(spec32, 128, 200, 40, seed=18), "gru_bidir",
             gru_ops.launches_fwd_branch),
            ("tanh_b128_fp32_step", spec_t, cfg_tanh,
             dp_batch(spec_t, 128, 160, 48, seed=19), "rnn_bidir",
             rnn_ops.launches_fwd_branch)):
        layers = spec_s.rnn_layers
        mod = {"lstm_bidir": train_ops, "gru_bidir": gru_train_ops,
               "rnn_bidir": rnn_train_ops}[prefix]
        zero_counts()
        got = dp_steps(spec_s, cfg_s, batch, None, device, steps=1)
        prepass_tf32 = getattr(mod, "launches_bwd_prepass_tf32", 0)
        took = {"fwd": {k: v for k, v in mod.launches_fwd_branch.items() if v},
                "bwd": {k: v for k, v in mod.launches_bwd_branch.items() if v},
                "eval": {k: v for k, v in eval_counts.items() if v}}
        with plain_twins():
            want = dp_steps(spec_s, cfg_s, batch, None, device, steps=1)
        rel = max(abs(x - y) / abs(y) for x, y in zip(
            got["losses"] + [got["eval_loss"]],
            want["losses"] + [want["eval_loss"]]))
        n_off, n_all, worst, wkey = states_apart(got["state"], want["state"])
        print(f"  {key}: one fp32 step and an eval step at B=128 ({smi}): loss "
              f"{got['losses']}, eval {got['eval_loss']:.6g} through the "
              f"kernels vs {want['losses']}, {want['eval_loss']:.6g} through "
              f"the twins (rel {rel:.3g}, tol {STEP_LOSS_RTOL}); {n_off} of "
              f"{n_all} entries past {STEP_TOL}, largest {worst:.3g} at "
              f"{wkey}; training forwards {took['fwd']}, backwards' serial "
              f"chains {took['bwd']}, eval forwards {took['eval']}")
        check(not on_card or all(v == {"wide_fp32": layers}
                                 for v in took.values()),
              f"{key}: the recurrences took {took}")
        check(all(math.isfinite(v) for v in got["losses"] + [got["eval_loss"]]),
              f"non-finite {key} loss")
        check(rel <= STEP_LOSS_RTOL, f"the {key} losses differ from the twins")
        check(n_off <= STEP_OFF_SHARE * n_all
              and worst <= 2.01 * cfg_s.init_lr,
              f"the {key} parameters differ from the twins")
        entry = {"losses": got["losses"], "eval_loss": got["eval_loss"],
                 "rel_vs_twins": rel, "entries_past_tol": n_off,
                 "branches": {f"{prefix}_train_fwd": took["fwd"],
                              f"{prefix}_train_bwd": took["bwd"],
                              prefix: took["eval"]}}
        if prefix != "rnn_bidir":  # the backward's pre-passes
            check(not on_card or prepass_tf32 == layers,
                  f"{key}: {prepass_tf32} of {layers} pre-passes launched "
                  f"prepass_tf32_kernel")
            entry["branches"][f"{prefix}_train_bwd_prepass"] = {
                "prepass_tf32_kernel": prepass_tf32}
        if on_card:
            # the step's wall and device time on the wide branches and,
            # through the parent libraries, on the grid, in turns
            from tools.parent_forms import parent_forms

            runs = {"new": [], "grid": []}
            for _ in range(2):
                for form in ("new", "grid"):
                    ctx = (parent_forms() if form == "grid"
                           else contextlib.nullcontext())
                    with ctx:
                        r = dp_steps(spec_s, cfg_s, batch, None, device,
                                     steps=1, times=True)
                    runs[form].append((r["step_wall_ms"], r["step_device_ms"]))
            entry["step_ms"] = {k: [w for w, _ in v] for k, v in runs.items()}
            entry["step_device_ms"] = {k: [d for _, d in v]
                                       for k, v in runs.items()}
            print(f"  {key} ({smi}): step wall ms {entry['step_ms']}, device "
                  f"ms {entry['step_device_ms']} (new: forwards and backwards "
                  f"on wide_fp32; grid: the parent forms)")
        out[key] = entry

    # the tanh model's fp32 greedy decode at B = 128: its eval forwards on
    # the wide branch, its strings those of the twins, its forward timed
    # against the grid
    zero_counts()
    runs = [greedy_b128(cfg_tanh, spec_t, seed, device) for seed in (0, 1)]
    took = {k: v for k, v in rnn_ops.launches_fwd_branch.items() if v}
    err = max(r["max_abs_err"] for r in runs)
    same = [sum(a == b for a, b in zip(r["strings"], r["strings_twins"]))
            for r in runs]
    n_tok = sum(len(x.split()) for r in runs for x in r["strings"])
    print(f"  tanh model fp32 greedy decode at B=128, T=200 ({smi}): strings "
          f"equal to the twins' {same} of 128 by seed, {n_tok} tokens; "
          f"log-probs max_abs_err {err:.3g} (tol {FP32_TOL}), all finite "
          f"{all(r['finite'] for r in runs)}; eval forwards {took}")
    check(not on_card or took == {"wide_fp32": len(runs) * spec_t.rnn_layers},
          f"the tanh fp32 B=128 decode's eval forwards took {took}")
    check(all(r["finite"] for r in runs) and err <= FP32_TOL,
          "the tanh fp32 B=128 decode's log-probs differ from the twins")
    check(all(r["strings"] == r["strings_twins"] for r in runs) and n_tok > 0,
          "the tanh fp32 B=128 decode's strings differ from the twins'")
    entry = {"max_abs_err": err, "strings_equal": same, "tokens": n_tok,
             "branches": {"rnn_bidir": took}}
    if on_card:
        fwd = runs[0]["forward"]
        res = turns({"new": fwd, "grid": on_parent(fwd)}, reps=5)
        entry.update(forward_ms=res["new"][0], forward_ms_rounds=res["new"][1],
                     grid_forward_ms=res["grid"][0],
                     grid_forward_ms_rounds=res["grid"][1])
        print(f"  tanh model fp32 decode forward B=128 T=200 ({smi}): eval "
              f"forwards on wide_fp32 {entry['forward_ms']:.4f} ms "
              f"{[round(v, 4) for v in entry['forward_ms_rounds']]}, on the "
              f"grid {entry['grid_forward_ms']:.4f} "
              f"{[round(v, 4) for v in entry['grid_forward_ms_rounds']]}")
    out["tanh_b128_fp32_decode"] = entry
    return out


# ---------------------------------------------------------------------------
# phase 15: data parallelism
# ---------------------------------------------------------------------------

# the phase's ranks: two processes share one card over gloo (NCCL refuses
# two ranks on one device); a rank's nonzero exit fails the phase
DP_WORLD = 2
DP_TIMEOUT_S = 600.0
# two bf16 steps on other batch shapes (B=64 a rank, B=128 in one process)
# part by bf16 roundings, at other points of other GEMM and convolution
# shapes: the loss is held to a bf16 ulp of its own size, and every
# parameter to Adam's bound on two runs' drift, 2.01 lr a step (a gradient
# within bf16 noise of zero, such as a conv bias in front of a BN, moves by
# +-lr on the sign of that noise, so the share past STEP_TOL is printed,
# not held)
BF16_LOSS_RTOL = 2.0 ** -8


def dp_batch(spec, b: int, t: int, l: int, seed: int) -> dict:
    """A global batch of ``b`` rows of ``t`` frames (numpy, from a seed) for
    the flagship's step: the two halves' longest rows differ (``t`` frames
    in the first, about 3/4 of it in the second), and the second half ends
    in repeat-padded rows (mask 0) longer than any of its real ones."""
    import numpy as np

    rng = np.random.RandomState(seed)
    half = b // 2
    lens = np.concatenate([
        rng.randint(t // 2, t + 1, half), rng.randint(t // 2, 3 * t // 4, half)])
    lens[0] = t
    mask = np.ones(b, np.float32)
    n_pad = max(1, b // 16)
    mask[-n_pad:] = 0.0
    lens[-n_pad:] = t - 1  # longer than the second half's real rows
    lab_len = np.minimum(rng.randint(1, l + 1, b), lens // 4).astype(np.int32)
    return {"feats": rng.randn(b, t, spec.rnn_input_size).astype(np.float32),
            "frac": (lens / t).astype(np.float32),
            "labels": rng.randint(1, spec.num_class, (b, l)).astype(np.int32),
            "label_lens": lab_len, "mask": mask}


DP_FIELDS = ("feats", "frac", "labels", "label_lens", "mask")


def dp_steps(spec, cfg, batch: dict, group, device: str, steps: int = 2,
             times: bool = False) -> dict:
    """``steps`` optimizer steps of ``spec``'s model from ``cfg.seed`` on
    ``batch`` (this rank's rows of it with a ``group``), then an eval step:
    the summed losses, the eval loss, the state, and with ``times`` one more
    step's wall time (median of 5, host clock around a synchronised step)
    and device time (``device_breakdown``)."""
    import torch

    from ctc_pytorch_tpu_torch.parallel import local_rows, replicate
    from ctc_pytorch_tpu_torch.train.loop import eval_step, train_step
    from ctc_pytorch_tpu_torch.train.state import create_train_state

    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, seed=cfg.seed, device=device)
    rows = (lambda a: a) if group is None else (
        lambda a: local_rows(a, group.rank, group.world))
    if group is not None:
        replicate(state.model, group)
    args = [torch.from_numpy(rows(batch[k])).to(device) for k in DP_FIELDS]
    losses = [float(train_step(state, spec, *args, group=group)[0])
              for _ in range(steps)]
    eval_loss = float(eval_step(state, spec, *args, group=group)[0])
    out = {"losses": losses, "eval_loss": eval_loss, "rows": len(args[0]),
           "state": {k: v.detach().float().cpu().clone()
                     for k, v in state.model.state_dict().items()}}
    if times:
        def step():
            train_step(state, spec, *args, group=group)

        walls = [timed(step) for _ in range(5)]
        out["step_wall_ms"] = 1e3 * statistics.median(walls)
        if str(device).startswith("cuda"):
            busy, rows_by = device_breakdown(step)
            out["step_device_ms"] = busy / 1e3
            out["step_top_kernels"] = rows_by[:6]
        else:
            out["step_device_ms"] = None  # a device metric: not measured
    return out


def dp_step_rank(rank, world, init_method, device, cases) -> dict:
    """One rank of phase 15 (a) and (b): ``dp_steps`` on each case, over a
    gloo group whose ranks share ``device``; the launch counts and branches
    of the (a) and (b) runs."""
    import torch

    from ctc_pytorch_tpu_torch.parallel import initialize

    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group = initialize("gloo", init_method, world, rank, device=device)
    out = {}
    for name, spec, cfg, batch, times in cases:
        zero_counts()
        out[name] = dp_steps(spec, cfg, batch, group, device, times=times)
        out[name]["counts"] = launch_counts()
        out[name]["branches"] = path_branches()
    return out


def dp_cli_rank(rank, world, init_method, conf: str, device: str) -> dict:
    """One rank of phase 15 (d): ``cli.train --data-parallel`` over gloo, as
    ``torchrun`` would start it; its printed log, launch counts, branches."""
    import contextlib
    import io
    import os

    from ctc_pytorch_tpu_torch.cli import train as cli_train

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    zero_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        best = cli_train.main(["--conf", conf, "--data-parallel", "--device",
                               device, "--dist-backend", "gloo",
                               "--dist-init-method", init_method])
    return {"best": str(best), "printed": printed.getvalue(),
            "counts": launch_counts(), "branches": path_branches()}


def states_apart(got: dict, want: dict) -> tuple:
    """``(entries past STEP_TOL, entries, largest difference, its key)``."""
    n_off = n_all = 0
    worst, worst_key = 0.0, ""
    for k, v in want.items():
        diff = (got[k].float() - v.float()).abs()
        n_off += int((diff > STEP_TOL).sum())
        n_all += diff.numel()
        if diff.max().item() > worst:
            worst, worst_key = diff.max().item(), k
    return n_off, n_all, worst, worst_key


def phase_data_parallel(smi: str, spec, device: str = "cuda",
                        big_batch: int = 128, t_frames: int = 200,
                        label_len: int = 33) -> dict:
    """Phase 15: the flagship's data parallelism on the one card.

    (a) Two gloo ranks on ``device`` (the recipe at full width, fp32,
    ``drop_out: 0``): two steps and an eval step on a global batch of 8
    (``dp_batch``: the halves' maxima differ, mask-0 rows in one half),
    against one process on the whole batch: the losses within
    STEP_LOSS_RTOL, the parameters by phase 5's rule; each rank's launches
    of rows 1, 3a, 3b, 5a and 5b.  (b) The same at B=``big_batch`` on the
    recipe's bf16 (loss within BF16_LOSS_RTOL, every parameter within
    Adam's bound).  For both, each rank's step wall and device time beside
    one process's.  (c) One NCCL rank: a fused epoch of the recipe from graphs
    under deterministic algorithms equals the same epoch without a group
    bit for bit; the replayed step's kernels and an eager step's
    collectives.  (d) ``cli.train --data-parallel`` as shipped (bf16,
    ``fused_epoch: false``) as two gloo ranks for one epoch: only rank 0
    logs and writes, the package loads and stage 4 decodes it.  (e) Stage
    4 with ``BeamDevice`` and ``Recognizer``, each on ``mesh=[device,
    device]``: the strings of the unsplit runs, on odd batches.

    ``device="cpu"`` rehearses (a), (b), (d) and (e) at the size of
    ``spec``; (c) needs NCCL, which needs the card."""
    import numpy as np
    import torch

    from ctc_pytorch_tpu_torch.api import Recognizer
    from ctc_pytorch_tpu_torch.cli.test import evaluate
    from ctc_pytorch_tpu_torch.frontend.e2e import spec_from_config
    from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec
    from ctc_pytorch_tpu_torch.parallel import spawn_ranks
    from ctc_pytorch_tpu_torch.train.checkpoint import save_package
    from ctc_pytorch_tpu_torch.vocab import Vocab

    on_card = device == "cuda"
    dev = "cuda:0" if on_card else "cpu"
    cfg = recipe_config(RECIPE)
    cfg.exp_name = "smoke_dp"
    check(cfg.batch_size == 8 and cfg.dtype == "bfloat16",
          "the recipe is not the flagship's batch-8 bf16 training")
    spec32 = dataclasses.replace(spec, compute_dtype="float32", drop_out=0.0)
    spec16 = dataclasses.replace(spec, drop_out=0.0)
    small = dp_batch(spec, cfg.batch_size, t_frames, label_len, seed=15)
    big = dp_batch(spec, big_batch, t_frames // 2 + 40, label_len, seed=16)
    cases = [("a", spec32, cfg, small, True), ("b", spec16, cfg, big, True)]
    out = {"card": smi, "world": DP_WORLD}

    # (a), (b): the ranks, then one process on the whole batches
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_step_rank, DP_WORLD, (dev, cases),
                        timeout=DP_TIMEOUT_S, threads=0 if on_card else 1)
    spawn_s = time.perf_counter() - t0
    zero_counts()
    single = {name: dp_steps(s, c, b, None, dev, times=times)
              for name, s, c, b, times in cases}
    counts = {}
    for name, rtol, what in (("a", STEP_LOSS_RTOL, "fp32, B=8"),
                             ("b", BF16_LOSS_RTOL, f"bf16, B={big_batch}")):
        want = single[name]
        for r, got in enumerate(ranks):
            g = got[name]
            rel = max(abs(x - y) / abs(y) for x, y in
                      zip(g["losses"] + [g["eval_loss"]],
                          want["losses"] + [want["eval_loss"]]))
            n_off, n_all, worst, key = states_apart(g["state"], want["state"])
            print(f"  ({name}) rank {r} of {DP_WORLD}, {what} ({g['rows']} "
                  f"rows a rank): losses {g['losses']}, eval {g['eval_loss']:.6g}"
                  f" vs one process {want['losses']}, {want['eval_loss']:.6g} "
                  f"(rel {rel:.3g}, tol {rtol:.3g}); {n_off} of {n_all} "
                  f"entries past {STEP_TOL}, largest {worst:.3g} at {key}; "
                  f"launches {g['counts']}, branches {g['branches']}")
            check(rel <= rtol, f"({name}) rank {r}: losses differ from one "
                  "process")
            check((name == "b" or n_off <= STEP_OFF_SHARE * n_all)
                  and worst <= 2.01 * 2 * cfg.init_lr,
                  f"({name}) rank {r}: parameters differ from one process")
            for row in ("lstm_bidir", "lstm_bidir_train_fwd",
                        "lstm_bidir_train_bwd_prepass",
                        "lstm_bidir_train_bwd", "ctc_alpha", "ctc_beta"):
                check(not on_card or g["counts"][row] > 0,
                      f"({name}) rank {r} never launched {row}")
            if on_card and name == "a":  # 4 rows a rank: fp32 streams
                check_fp32_bwd_branch(
                    f"(a) rank {r}",
                    g["branches"].get("lstm_bidir_train_bwd", {}),
                    g["counts"]["lstm_bidir_train_bwd"], "LSTM",
                    g["counts"]["lstm_bidir_train_bwd_prepass_tf32"])
            if on_card and name == "b":  # 64 rows a rank: the eval forward
                check(g["branches"].get("lstm_bidir") == {
                          "wide_fp32": g["counts"]["lstm_bidir"]},
                      f"(b) rank {r}: the eval forward at B={g['rows']} took "
                      f"{g['branches'].get('lstm_bidir')}, not wide_fp32")
            counts = added(counts, g["counts"])
        for k in ranks[0][name]["state"]:
            check(torch.equal(ranks[0][name]["state"][k],
                              ranks[1][name]["state"][k]),
                  f"({name}) the ranks' {k} differ")
    out["steps"] = {
        name: {"single": {k: single[name][k] for k in (
                   "losses", "eval_loss", "step_wall_ms", "step_device_ms")
                   if k in single[name]},
               "ranks": [{k: r[name][k] for k in (
                   "losses", "eval_loss", "step_wall_ms", "step_device_ms",
                   "counts", "branches") if k in r[name]} for r in ranks]}
        for name in ("a", "b")}
    for name, b_size in (("a", cfg.batch_size), ("b", big_batch)):
        st = out["steps"][name]
        print(f"  ({name}) step at B={b_size} ({smi}): one process wall "
              f"{st['single']['step_wall_ms']:.3f} ms, device "
              f"{st['single']['step_device_ms']} ms; gloo ranks (two on one "
              f"card) " + "; ".join(
                  f"rank {i} wall {r['step_wall_ms']:.3f} ms, device "
                  f"{r['step_device_ms']} ms" for i, r in enumerate(st["ranks"])))
        print("    one process's top kernels: " + ", ".join(
            f"{n[:40]} {us / 1e3:.3f} ms"
            for n, us in single[name].get("step_top_kernels") or []))
    print(f"  (a)+(b) spawn and run of the ranks: {spawn_s:.1f} s")

    # (c) one NCCL rank: the collectives inside the captured steps
    if on_card:
        out["nccl_one_rank"] = dp_nccl_one_rank(cfg, spec)

    # (d) cli.train --data-parallel as shipped, fused_epoch off (gloo)
    conf = WORK / "dp_recipe.yaml"
    cfg_d = dataclasses.replace(cfg, fused_epoch=False, num_epoches=1,
                                checkpoint_dir=str(WORK / "dp_checkpoint"),
                                exp_name="smoke_dp_cli", log_dir="")
    cfg_d.to_yaml(conf)
    t0 = time.perf_counter()
    cli = spawn_ranks(dp_cli_rank, DP_WORLD, (str(conf), dev),
                      timeout=DP_TIMEOUT_S, threads=0 if on_card else 1)
    cli_s = time.perf_counter() - t0
    best = Path(cli[0]["best"])
    written = sorted(p.name for p in best.parent.iterdir())
    print(f"  (d) cli.train --data-parallel, {DP_WORLD} gloo ranks on {dev}, "
          f"one epoch: {cli_s:.1f} s with the start-up; rank 0 printed "
          f"{len(cli[0]['printed'].splitlines())} lines, rank 1 "
          f"{len(cli[1]['printed'].splitlines())}; {best.parent} holds "
          f"{written}; launches {[c['counts'] for c in cli]}")
    check(cli[1]["printed"] == "" and "End training" in cli[0]["printed"],
          "(d) a rank other than 0 logged, or rank 0 did not")
    check(written.count("ctc_best_model.npz") == 1
          and "train_metrics.jsonl" in written
          and cli[0]["best"] == cli[1]["best"],
          f"(d) the run wrote {written}")
    for r, c in enumerate(cli):
        counts = added(counts, c["counts"])
        if on_card:  # 4 rows a rank: fp32 streams
            check_fp32_bwd_branch(
                f"(d) rank {r}", c["branches"].get("lstm_bidir_train_bwd", {}),
                c["counts"]["lstm_bidir_train_bwd"], "LSTM",
                c["counts"]["lstm_bidir_train_bwd_prepass_tf32"])
    res = evaluate(cfg_d, str(best), device=dev, log=lambda *_: None)
    print(f"  (d) stage 4 of its package: {res['batches']} batches, PER "
          f"{res['wer']:.4f}")
    check(math.isfinite(res["wer"]) and res["batches"] > 0,
          "(d) the data-parallel package does not decode")
    out["cli"] = {"wall_s": cli_s, "files": written, "per": res["wer"]}

    # (e) the sharded stage-4 search and the mesh Recognizer, odd batches
    mesh = [dev, dev]
    pkg = WORK / "checkpoint" / "dp_seeded.npz"
    save_package(pkg, spec, seeded_model(spec), config=cfg)
    cfg_e = dataclasses.replace(cfg, decode_type="BeamDevice", batch_size=5,
                                fused_decode=False, beam_width=8,
                                beam_max_len=t_frames, lm_path="")
    decoded = {}
    for tag, m in (("unsplit", None), ("mesh", mesh)):
        lines = []
        evaluate(cfg_e, str(pkg), device=dev, log=lines.append, mesh=m)
        decoded[tag] = lines[2:-3:3]
    same = sum(a == b for a, b in zip(decoded["mesh"], decoded["unsplit"]))
    print(f"  (e) stage 4, BeamDevice, batches of 5 on a mesh of two: "
          f"{same}/{len(decoded['unsplit'])} strings equal to the unsplit "
          f"search's")
    check(decoded["mesh"] == decoded["unsplit"] and same > 0,
          "(e) the sharded search decodes differently")
    cfg_w = recipe_config(RECIPE_WAVE)
    vocab = Vocab(cfg.vocab_file)
    spec_w = dataclasses.replace(
        ModelSpec.from_config(cfg_w, num_class=vocab.n_words),
        compute_dtype="float32")
    if not on_card:  # the rehearsal's width
        spec_w = dataclasses.replace(spec_w, rnn_hidden_size=spec.rnn_hidden_size,
                                     rnn_layers=spec.rnn_layers)
    pkg_w = WORK / "checkpoint" / "dp_wave_fp32.npz"
    save_package(pkg_w, spec_w, seeded_model(spec_w), config=cfg_w)
    rng = np.random.RandomState(17)
    wavs = [(rng.randn(n) * 500).astype(np.float32)
            for n in (16000, 40000, 23000, 31000, 9000)]
    got = {}
    for tag, m in (("unsplit", None), ("mesh", mesh)):
        rec = Recognizer(pkg_w, vocab, frontend=spec_from_config(cfg_w),
                         device=dev, mesh=m)
        got[tag] = rec.recognize(wavs)
    print(f"  (e) Recognizer (fp32 package), 5 utterances on a mesh of two: "
          f"{sum(a == b for a, b in zip(got['mesh'], got['unsplit']))}/5 "
          f"strings equal to one device's")
    check(got["mesh"] == got["unsplit"] and any(got["unsplit"]),
          "(e) the mesh Recognizer decodes differently")
    out["counts"] = counts
    return out


def dp_nccl_one_rank(cfg, spec) -> dict:
    """Phase 15 (c): one NCCL rank in this process.  A fused epoch of the
    recipe (bf16, its dropout) from graphs, under deterministic algorithms,
    with the group and without, from one seed: per-batch losses and
    parameters bit for bit.  Then the kernels of a replayed training step
    and the collectives of an eager one (``torch.profiler``)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ctc_pytorch_tpu_torch.cli.train import build_loaders
    from ctc_pytorch_tpu_torch.data.batching import gather_rows
    from ctc_pytorch_tpu_torch.parallel import DataGroup
    from ctc_pytorch_tpu_torch.train.loop import (
        make_epoch_fns,
        make_fused_fns,
        run_epoch_single,
        train_step,
    )
    from ctc_pytorch_tpu_torch.train.state import create_train_state
    from ctc_pytorch_tpu_torch.vocab import Vocab

    quiet = lambda *_: None  # noqa: E731
    cache_tr, cache_dv = build_loaders(cfg, Vocab(cfg.vocab_file), log=quiet,
                                       device="cuda")
    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", init_method=f"file://{store}/nccl",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda:0"))
        try:
            group = DataGroup(None, 0, 1, torch.device("cuda:0"), "nccl")
            runs = {}
            with deterministic():
                for tag, g in (("none", None), ("nccl", group)):
                    state = create_train_state(
                        spec, cfg.init_lr, cfg.weight_decay, cfg.grad_clip,
                        seed=cfg.seed, device="cuda")
                    gen = torch.Generator(device="cuda").manual_seed(
                        cfg.seed + 1)
                    fns = make_epoch_fns(make_fused_fns(spec, gen, None, g))
                    rec_tr, rec_dv = {}, {}
                    cache_tr.set_epoch(1)
                    run_epoch_single(1, fns, state, cache_tr, training=True,
                                     log=quiet, record=rec_tr)
                    run_epoch_single(1, fns, state, cache_dv, training=False,
                                     log=quiet, record=rec_dv)
                    sync()
                    runs[tag] = (rec_tr, rec_dv, state, fns[0].graphs)
            a, b = runs["none"], runs["nccl"]
            same = all(torch.equal(v, b[2].model.state_dict()[k])
                       for k, v in a[2].model.state_dict().items())
            steps = len(a[0]["losses"])
            print(f"  (c) one NCCL rank: a fused epoch ({steps} steps, "
                  f"{len(a[1]['losses'])} dev batches, {b[3].replays()} "
                  f"replays of {len(b[3])} graphs) with the group vs "
                  f"without: losses equal {a[0]['losses'] == b[0]['losses']}"
                  f" and {a[1]['losses'] == b[1]['losses']}, token counts "
                  f"{(b[0]['errs'], b[0]['toks'])} vs "
                  f"{(a[0]['errs'], a[0]['toks'])}, parameters and BN "
                  f"state bit for bit {same}")
            check(a[0] == b[0] and a[1] == b[1] and same,
                  "(c) the NCCL group's fused epoch differs from the "
                  "ungrouped one")
            check(b[3].replays() == steps + len(b[1]["losses"]),
                  "(c) the grouped epoch did not run from graphs")
            # the kernels of one replayed training step (it moves the
            # throwaway state on), and the collectives of an eager step
            cap = next(c for k, c in b[3].graphs.items() if k[0])
            busy, rows = device_breakdown(cap.graph.replay)
            nccl_kernels = [(n, us) for n, us in rows if "nccl" in n.lower()]
            arrs = next(iter(cache_tr.epoch_groups(1)))
            pos = torch.from_numpy(arrs[1][0].astype("int64")).cuda()
            feats, frac, _, labels, lab_len = gather_rows(arrs[0], pos, arrs[3])
            mask = torch.from_numpy(arrs[2][0]).cuda()
            state = b[2]
            gen = torch.Generator(device="cuda").manual_seed(0)
            train_step(state, spec, feats, frac, labels, lab_len, mask, gen,
                       None, group)
            sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                train_step(state, spec, feats, frac, labels, lab_len, mask,
                           gen, None, group)
                sync()
            by_name: dict = {}
            for ev in prof.events():
                if (ev.device_type == DeviceType.CPU
                        and ev.name in ("c10d::allreduce_", "nccl:all_reduce")):
                    by_name[ev.name] = by_name.get(ev.name, 0) + 1
            collectives = max(by_name.values(), default=0)
            print(f"  (c) a replayed step: {busy / 1e3:.3f} ms of kernels, "
                  f"NCCL kernels {nccl_kernels or 'none'} (a one-rank "
                  f"all-reduce in place enqueues no work); an eager step "
                  f"issues {collectives} all-reduces ({by_name})")
            check(collectives > 0, "(c) the eager step issued no collective")
        finally:
            dist.destroy_process_group()
    return {"steps": steps, "bit_equal": True, "replays": b[3].replays(),
            "replayed_step_device_ms": busy / 1e3,
            "nccl_kernels_in_replay": nccl_kernels,
            "all_reduces_per_step": collectives}



# ---------------------------------------------------------------------------
# phase 17: remat
# ---------------------------------------------------------------------------

# the kernel whose launches double under remat, by cell: the training forward
TRAIN_FWD = {"lstm": "lstm_bidir_train_fwd", "gru": "gru_bidir_train_fwd",
             "rnn": "rnn_bidir_train_fwd"}
REMAT_STEP_REPS = 10


def remat_data(device: str) -> None:
    """The corpora the remat phase trains on, written if an earlier phase
    has not (so that the phase also runs alone): the flagship's and the 863
    model's train and dev splits, and the waveform recipe's audio with
    stage 1's CMVN statistics."""
    from ctc_pytorch_tpu_torch.cli import make_feat

    write_corpus(WORK / "data", "train", N_TRAIN_UTTS, seed=1)
    write_corpus(WORK / "data", "dev", N_DEV_UTTS, seed=2)
    for split, n, seed in (("train", N_TRAIN_UTTS_863, 11),
                           ("dev", N_DEV_UTTS_863, 12)):
        write_corpus(WORK / "data863", split, n, seed=seed, dim=201,
                     units=UNITS_863, feats="spectrum", labels="text")
    root = WORK / "data_wave"
    if not (root / "global_fbank_cmvn.npz").exists():
        for split, n, seed in WAVE_SPLITS:
            write_audio_corpus(root, split, n, seed)
        make_feat.main(["fbank", str(root), "--device", device])


def waveform_config():
    """``recipes/timit/waveform_config.yaml`` on phase 12's corpus."""
    cfg = recipe_config(RECIPE_WAVE, "data_wave", "wav")
    cfg.data_dir = str(WORK / "data_wave")
    return cfg


def remat_branches() -> dict:
    """Every op's launches by branch since ``zero_counts``: the forwards'
    and the tanh backward's (``cluster_branch_counts``), the LSTM's and
    CTC's (``path_branches``) and the GRU backward's."""
    _, gru_train_ops = port_gru_ops()
    took = {op: {k: v for k, v in by.items() if v}
            for op, by in cluster_branch_counts().items() if any(by.values())}
    took.update(path_branches())
    if any(gru_train_ops.launches_bwd_branch.values()):
        took["gru_bidir_train_bwd"] = {
            k: v for k, v in gru_train_ops.launches_bwd_branch.items() if v}
    return took


def states_equal(a: dict, b: dict) -> list:
    """The keys of two state dicts (or gradient dicts) whose tensors are not
    equal bit for bit."""
    import torch

    return [k for k in a if not torch.equal(a[k], b[k])]


def remat_fit(cfg, device: str) -> dict:
    """One epoch of ``cfg`` through ``cli.train.train`` (the recipe's fused
    epoch from captured graphs) under deterministic algorithms: the
    launches, the replays, the loss histories and the state after it (on
    the host)."""
    from ctc_pytorch_tpu_torch.cli import train as cli_train

    zero_counts()
    lines = []
    with deterministic():
        t0 = time.perf_counter()
        trainer, _ = cli_train.train(cfg, device=device, num_epoches=1,
                                     log=lines.append)
        sync()
        fit_s = time.perf_counter() - t0
    check(any(ln.startswith("fused_epoch: the epochs run over the device "
                            "cache") for ln in lines),
          f"{cfg.exp_name}: the fit did not take the fused path")
    graphs = trainer.graphs()
    return {"counts": launch_counts(), "branches": remat_branches(),
            "steps": trainer.state.step, "fit_s": fit_s,
            "replays": graphs.replays() if device == "cuda" else 0,
            "histories": {k: list(trainer.histories[k]) for k in (
                "loss_results", "dev_loss_results")},
            "state": {k: v.detach().to("cpu", copy=True) for k, v in
                      trainer.state.model.state_dict().items()}}


def remat_step(cfg, spec, args, frontend_fn, device: str, times: bool
               ) -> dict:
    """One eager train step of ``spec``'s model from ``cfg``'s seeded state
    on ``args`` (feats, frac, labels, label lengths, mask), the recipe's
    dropout drawn from a seeded generator, under deterministic algorithms:
    loss, gradients, the state after the step (on the host), the
    launches.  With
    ``times``, then the step's peak memory (``max_memory_allocated`` over
    one more step, after ``reset_peak_memory_stats``, beside what was
    allocated before it), its device time (``device_breakdown``) and its
    median time over ``REMAT_STEP_REPS``."""
    import torch

    from ctc_pytorch_tpu_torch.train.loop import train_step
    from ctc_pytorch_tpu_torch.train.state import create_train_state

    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, seed=cfg.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def step():
        return train_step(state, spec, *args, gen, frontend_fn)

    zero_counts()
    with deterministic():
        loss = step()[0]
        sync()
    # held on the host, so that the card holds as much before each run's
    # memory is measured
    out = {"counts": launch_counts(), "branches": remat_branches(),
           "loss": loss.to("cpu", copy=True),
           "grads": {k: p.grad.to("cpu", copy=True) for k, p in
                     state.model.named_parameters()},
           "state": {k: v.detach().to("cpu", copy=True) for k, v in
                     state.model.state_dict().items()}}
    if times and device == "cuda":
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        sync()
        peak = torch.cuda.max_memory_allocated()
        step_us, _ = device_breakdown(step)
        out.update(peak_bytes=peak, base_bytes=base,
                   step_bytes=peak - base,
                   step_ms=cuda_ms(step, reps=REMAT_STEP_REPS),
                   step_device_ms=step_us / 1e3)
    return out


def host_batch(cfg, vocab, waveform: bool, device: str):
    """The longest batch of ``cfg``'s train split from the host loader, as
    the step's tensors on ``device`` (a waveform batch carries its sample
    counts in the ``frac`` slot, as the fused gather passes them)."""
    import numpy as np
    import torch

    from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset

    host = SpeechDataLoader(
        SpeechDataset(vocab, cfg.train_scp_path, cfg.train_lab_path, cfg),
        cfg.batch_size, shuffle=False, num_buckets=cfg.num_buckets)
    batch = max(host, key=lambda b: b.feats.shape[1])
    frac = batch.input_lengths if waveform else batch.input_frac
    return tuple(torch.as_tensor(a).to(device) for a in (
        batch.feats, np.asarray(frac, np.float32), batch.labels,
        batch.label_lengths, batch.example_mask))


def hold_remat(what: str, cell: str, layers: int, plain: dict, remat: dict,
               steps: int, device: str) -> dict:
    """``remat`` against ``plain`` (two ``remat_fit`` or ``remat_step``
    results): every tensor bit for bit, and the training forward launched
    twice a layer a step under remat and once without, every other kernel
    as often.  Returns the launches of both runs."""
    import torch

    off = states_equal(plain["state"], remat["state"])
    if "grads" in plain:  # an eager step's
        off += [f"grad {k}" for k in states_equal(plain["grads"],
                                                  remat["grads"])]
        if not torch.equal(plain["loss"], remat["loss"]):
            off.append("loss")
    if "histories" in plain and plain["histories"] != remat["histories"]:
        off.append("loss histories")
    print(f"  {what}: remat against plain, {len(plain['state'])} state "
          f"tensors" + (f" and {len(plain['grads'])} gradients"
                        if "grads" in plain else "")
          + f": {len(off)} differ bit for bit {off[:8]}")
    check(not off, f"{what}: the remat run differs from the plain one: {off}")
    fwd = TRAIN_FWD[cell]
    if device == "cuda":
        want = dict(plain["counts"])
        want[fwd] = 2 * plain["counts"][fwd]
        check(plain["counts"][fwd] == layers * steps,
              f"{what}: {plain['counts'][fwd]} training forwards for "
              f"{layers} layers x {steps} steps")
        check(remat["counts"] == want,
              f"{what}: remat launches {remat['counts']}, expected {want}")
        check(remat["branches"].get(fwd) == {
            k: 2 * v for k, v in plain["branches"][fwd].items()},
              f"{what}: the recompute took other branches: "
              f"{remat['branches'].get(fwd)} against "
              f"{plain['branches'][fwd]}")
    print(f"  {what}: {fwd} launches {plain['counts'][fwd]} plain, "
          f"{remat['counts'][fwd]} remat ({layers} layers x {steps} steps); "
          f"branches {remat['branches'].get(fwd)}")
    return {"plain": plain["counts"], "remat": remat["counts"]}


def ctc_forward_score_vs_plain(device: str) -> dict:
    """``ctc_forward_score`` through ``ctc_fwd_kernel`` against
    ``-ctc_fwd_plain`` on the same inputs (fp32, ``FP32_TOL`` relative to
    max(|score|, 1)) at the flagship's recipe and bench shapes, and an
    impossible alignment (a repeated label in too few frames), which must
    score exactly ``NEG_INF`` on both; one launch a call."""
    import torch

    from ctc_pytorch_tpu_torch.ops.ctc_loss import (
        NEG_INF,
        ctc_forward_score,
        ctc_fwd_plain,
    )

    _, _, ctc_ops = port_ops()
    worst, calls = 0.0, 0
    for t, b, c, l, seed in ((100, 8, 62, 33, 0), (80, 128, 62, 48, 1)):
        args = ctc_inputs(t, b, c, l, seed, device=device)
        before = ctc_ops.launches_alpha
        got = ctc_forward_score(*args)
        calls += 1
        want = -ctc_fwd_plain(*args, with_alphas=False)[0]
        check(device == "cpu" or ctc_ops.launches_alpha == before + 1,
              "ctc_forward_score did not launch ctc_fwd_kernel once")
        err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
        worst = max(worst, err)
        check(got.shape == (b,) and bool(torch.isfinite(got).all())
              and err <= FP32_TOL,
              f"ctc_forward_score at ({t}, {b}, {c}, {l}): rel err {err}")
    lp = ctc_inputs(6, 3, 10, 3, 2, device=device)[0]
    labels = torch.tensor([[1, 2, 3], [4, 4, 4], [5, 5, 0]],
                          dtype=torch.int32, device=lp.device)
    in_len = torch.tensor([6, 4, 2], dtype=torch.int32, device=lp.device)
    lab_len = torch.tensor([3, 3, 2], dtype=torch.int32, device=lp.device)
    args = (lp, labels, in_len, lab_len)
    got = ctc_forward_score(*args).cpu()
    calls += 1
    want = (-ctc_fwd_plain(*args, with_alphas=False)[0]).cpu()
    neg = torch.tensor(NEG_INF, dtype=torch.float32)
    print(f"  ctc_forward_score vs ctc_fwd_plain: worst rel err {worst:.3g} "
          f"(tol {FP32_TOL}); impossible rows {got[1:].tolist()} (plain "
          f"{want[1:].tolist()}, NEG_INF {NEG_INF}); {calls} calls")
    check(torch.equal(got[1:], torch.stack([neg, neg]))
          and torch.equal(want[1:], got[1:])
          and abs(got[0] - want[0]) <= FP32_TOL * max(abs(want[0]), 1.0),
          f"ctc_forward_score's impossible rows {got.tolist()}, plain "
          f"{want.tolist()}")
    return {"max_rel_err": worst, "impossible": got[1:].tolist(),
            "calls": calls}


def print_memory(what: str, out: dict, runs, smi: str) -> None:
    """Add the plain and remat eager steps' peak memory and times (two
    ``remat_step`` results, plain first) to ``out`` and print them; nothing
    where they were not measured (the CPU)."""
    if "peak_bytes" not in runs[0]:
        return
    mem = {k: [r[k] for r in runs] for k in (
        "peak_bytes", "base_bytes", "step_bytes", "step_ms",
        "step_device_ms")}
    out.update(mem)
    print(f"  {what} eager step ({smi}): peak memory {mem['peak_bytes'][0]} "
          f"bytes plain, {mem['peak_bytes'][1]} remat "
          f"({mem['peak_bytes'][0] - mem['peak_bytes'][1]} less); above the "
          f"{mem['base_bytes'][0]} bytes held before the step "
          f"{mem['step_bytes'][0]} and {mem['step_bytes'][1]}; step "
          f"{mem['step_ms'][0]:.4f} ms plain, {mem['step_ms'][1]:.4f} ms "
          f"remat ({mem['step_ms'][1] - mem['step_ms'][0]:+.4f}), median of "
          f"{REMAT_STEP_REPS}; kernels {mem['step_device_ms'][0]:.4f} and "
          f"{mem['step_device_ms'][1]:.4f} ms")


def phase_remat(smi: str, device: str = "cuda") -> dict:
    """``remat: true`` on the shipped recipes against ``remat: false``, each
    pair from one seeded state under deterministic algorithms: the waveform
    recipe (4 x BiLSTM(384), bf16, B=128, dropout 0.2) and the flagship
    (CNN + 4 x BiLSTM(384), fp32 streams at B=8) each for one graphed fused
    epoch through ``cli.train.train`` and one eager step on its longest
    batch; the 863 GRU model for one eager step at B=16.  Each remat run must equal its plain run bit for bit (loss,
    gradients, every parameter and BN buffer after it) and launch the
    training forward kernel twice a layer a step, where the plain run
    launches it once; every other kernel as often.  The eager steps' peak
    memory and median time, with and without remat, are printed.  Then
    ``ctc_forward_score`` on the card against its twin.  ``device="cpu"``
    rehearses the phase on cut recipes (no launches, no times)."""
    from ctc_pytorch_tpu_torch.frontend.e2e import frontend_fn_from_config
    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.vocab import Vocab

    remat_data(device)
    total, out = None, {"device": smi}

    def both(what, run):
        nonlocal total
        runs = {}
        for remat in (False, True):
            runs[remat] = run(remat)
            total = (runs[remat]["counts"] if total is None
                     else added(total, runs[remat]["counts"]))
        return runs[False], runs[True]

    # the waveform recipe: a graphed epoch, then an eager step
    cfg = waveform_config()
    vocab = Vocab(cfg.vocab_file)
    spec = ModelSpec.from_config(cfg, num_class=vocab.n_words)
    check(device == "cpu" or (
        spec.rnn_layers == 4 and spec.rnn_hidden_size == 384
        and cfg.batch_size == 128 and spec.compute_dtype == "bfloat16"
        and spec.drop_out > 0 and cfg.fused_epoch and not cfg.remat),
          f"not the waveform recipe as shipped: {spec}")
    fits = both("waveform fit", lambda remat: remat_fit(dataclasses.replace(
        cfg, remat=remat, exp_name=f"smoke_remat_wave_{int(remat)}"), device))
    steps = fits[0]["steps"]
    out["waveform_fit"] = hold_remat(
        f"waveform fit, B={cfg.batch_size}, {steps} steps", "lstm",
        spec.rnn_layers, *fits, steps, device)
    out["waveform_fit"].update(
        steps=steps, fit_s=[f["fit_s"] for f in fits],
        replays=[f["replays"] for f in fits])
    frontend_fn = frontend_fn_from_config(cfg)
    args = host_batch(cfg, vocab, True, device)
    wave = both("waveform step", lambda remat: remat_step(
        cfg, dataclasses.replace(spec, remat=remat), args, frontend_fn,
        device, times=True))
    out["waveform_step"] = hold_remat(
        f"waveform eager step, B={args[0].shape[0]}, S={args[0].shape[1]} "
        f"samples", "lstm", spec.rnn_layers, *wave, 1, device)
    print_memory("waveform", out["waveform_step"], wave, smi)

    # the flagship: a graphed epoch at B=8, fp32 streams
    cfg = recipe_config(RECIPE)
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    fits = both("flagship fit", lambda remat: remat_fit(dataclasses.replace(
        cfg, remat=remat, exp_name=f"smoke_remat_flagship_{int(remat)}"),
        device))
    steps = fits[0]["steps"]
    out["flagship_fit"] = hold_remat(
        f"flagship fit, B={cfg.batch_size}, {steps} steps", "lstm",
        spec.rnn_layers, *fits, steps, device)
    out["flagship_fit"].update(steps=steps,
                               fit_s=[f["fit_s"] for f in fits],
                               replays=[f["replays"] for f in fits])
    args = host_batch(cfg, Vocab(cfg.vocab_file), False, device)
    flag = both("flagship step", lambda remat: remat_step(
        cfg, dataclasses.replace(spec, remat=remat), args, None, device,
        times=True))
    out["flagship_step"] = hold_remat(
        f"flagship eager step, B={args[0].shape[0]}", "lstm",
        spec.rnn_layers, *flag, 1, device)
    print_memory("flagship", out["flagship_step"], flag, smi)

    # the 863 GRU model: an eager step at B=16, bf16 streams
    cfg = recipe_config_863()
    spec = ModelSpec.from_config(cfg, num_class=cfg.num_class + 1)
    args = host_batch(cfg, Vocab(cfg.vocab_file), False, device)
    gru = both("863 GRU step", lambda remat: remat_step(
        cfg, dataclasses.replace(spec, remat=remat), args, None, device,
        times=True))
    out["863_gru_step"] = hold_remat(
        f"863 GRU eager step, B={args[0].shape[0]}", "gru",
        spec.rnn_layers, *gru, 1, device)
    print_memory("863 GRU", out["863_gru_step"], gru, smi)

    zero_counts()
    out["ctc_forward_score"] = ctc_forward_score_vs_plain(device)
    total = added(total, launch_counts())
    out["counts"] = total
    return out

# phase 18's DeepSpeech2 batch: the cell's B = 64 rows of unequal lengths
# cut to DS2_T input frames (T' = DS2_T / 2)
DS2_B, DS2_T = 64, 400
# phase 18, kernels against twins on bf16 streams: the norm of the
# difference over the twins' norm, of the eval log-probs on the valid
# frames, of the first gradient over every leaf, and the loss's relative
# gap; a kernel that computes another function reads ~1
DS2_REL_TOL = 0.03


def ds2_batch(spec, seed: int, device: str = "cuda") -> tuple:
    """Phase 18's batch on the card, ``(feats, frac, labels, label_lens,
    mask)``: ``DS2_B`` rows of features from a seed, lengths spread evenly
    from ``DS2_T / 2`` to ``DS2_T`` (even), 0.14 labels a frame, the
    shortest row repeat-padded (mask 0)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    b, t = DS2_B, DS2_T
    frames = torch.linspace(t // 2, t, b).round().long() // 2 * 2
    feats = torch.randn(b, t, spec.rnn_input_size, generator=gen)
    feats *= (torch.arange(t)[None, :, None] < frames[:, None, None])
    lab_len = (0.14 * frames).round().long()
    labels = torch.randint(2, spec.num_class, (b, int(lab_len.max())),
                           generator=gen)
    mask = torch.ones(b)
    mask[0] = 0.0
    return tuple(x.to(device) for x in (feats, frames / t, labels, lab_len,
                                        mask))


def phase_ds2(smi: str, device: str = "cuda") -> dict:
    """Phase 18: DeepSpeech2 (``RECIPE_DS2``) at its published widths on
    ``ds2_batch``: from one seeded state, an eval step (``eval_step``, the
    dev pass's call) and a train step (``train_step``) through the kernels
    and through the plain twins.  The eval log-probs on the valid frames,
    the loss and the first gradient (Adam's first moment) agree within
    ``DS2_REL_TOL``; the kernels' run launches the eval op and the
    training backward on the grid and the training forward on the wide
    branch's bf16 form (``wide_bf16``), one a layer each, counts ``T'`` a
    launch in ``launches_steps`` and a packed, summed layer call a layer
    each way in ``rnn_io``'s counters, every counter zeroed just before."""
    import torch

    from ctc_pytorch_tpu_torch.config import load_config
    from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec
    from ctc_pytorch_tpu_torch.ops import launch_counts as counters
    from ctc_pytorch_tpu_torch.train.loop import eval_step, train_step
    from ctc_pytorch_tpu_torch.train.state import create_train_state

    cfg = load_config(RECIPE_DS2)
    spec = ModelSpec.from_config(cfg, num_class=cfg.output_class_dim)
    layers, t_out = spec.rnn_layers, DS2_T // 2
    print(f"[18/18] DeepSpeech2: {RECIPE_DS2.relative_to(ROOT)} at its "
          f"published widths ({layers} x BiLSTM({spec.rnn_hidden_size}), "
          f"biased, packed, summed; {spec.compute_dtype}), B={DS2_B}, "
          f"T={DS2_T}: an eval step and a train step through the kernels and "
          f"the plain twins ({smi})")
    batch = ds2_batch(spec, 18, device)

    def run():
        state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                                   cfg.grad_clip, seed=cfg.seed, device=device)
        _, _, sizes, log_probs = eval_step(state, spec, *batch)
        loss, _, _ = train_step(state, spec, *batch)
        beta1 = state.optimizer.param_groups[0]["betas"][0]
        grad = torch.cat([state.optimizer.state[p]["exp_avg"].flatten()
                          for p in state.optimizer.param_groups[0]["params"]])
        sync()
        return log_probs.float(), float(loss), grad / (1 - beta1), sizes

    zero_counts()
    before = counters.read()
    lp, loss, grad, sizes = run()
    moved = counters.diff(counters.read(), before)
    check_counts(launch_counts(), {"lstm_bidir": layers,
                                   "lstm_bidir_train_fwd": layers,
                                   "lstm_bidir_train_bwd": layers,
                                   "ctc_alpha": 2, "ctc_beta": 1,
                                   **epilogue_want(spec, 1, 1)},
                 "DeepSpeech2 eval and train step")
    want = {("lstm_bidir", "launches_fwd_branch"): {"grid": layers},
            ("lstm_bidir", "launches_steps"): {"fwd": layers * t_out},
            ("lstm_bidir_train", "launches_fwd_branch"): {"wide_bf16": layers},
            ("lstm_bidir_train", "launches_bwd_branch"): {"grid": layers},
            ("lstm_bidir_train", "launches_steps"): {"fwd": layers * t_out,
                                                     "bwd": layers * t_out},
            ("rnn_io", "launches_mask"): {"gate": 2 * layers},
            ("rnn_io", "launches_merge"): {"sum": 2 * layers}}
    for key, n in want.items():
        check(moved.get(key) == n,
              f"DeepSpeech2: {key} moved {moved.get(key)}, expected {n}")
    with plain_twins():
        lp_p, loss_p, grad_p, _ = run()
    valid = ((torch.arange(lp.shape[0], device=device)[:, None] < sizes)
             & (batch[4] > 0))[..., None]

    def rel(got, want) -> float:
        return float((got - want).double().norm() / want.double().norm())

    errs = {"log_probs": rel(lp * valid, lp_p * valid),
            "loss": abs(loss - loss_p) / abs(loss_p),
            "first_grad": rel(grad, grad_p)}
    check(all(torch.isfinite(x).all().item() for x in (lp, grad))
          and math.isfinite(loss), "DeepSpeech2: a non-finite kernel output")
    launches = {f"{k[0]}.{k[1]}": v for k, v in moved.items()}
    print(f"  kernels against twins: eval log-probs {errs['log_probs']:.3g}, "
          f"loss {loss:.6g} against {loss_p:.6g} ({errs['loss']:.3g}), first "
          f"gradient {errs['first_grad']:.3g} of the twins' norms (tol "
          f"{DS2_REL_TOL}); T' {int(sizes.max())}; launches {launches}")
    check(int(sizes.max()) == t_out, f"DeepSpeech2: T' {int(sizes.max())}")
    for key, err in errs.items():
        check(err <= DS2_REL_TOL,
              f"DeepSpeech2: the kernels' {key} disagrees with the twins'")
    return {"shape": {"B": DS2_B, "T": DS2_T, "T_out": t_out,
                      "H": spec.rnn_hidden_size, "layers": layers},
            "rel_err_vs_plain": errs, "launches": launches}


def ds2_table_errors(errs_fwd: dict, errs_hoist: dict) -> dict:
    """Phase 3's errors at DeepSpeech2's recurrence shape, by kernel."""
    (train_fwd, eval_fwd), (bwd,) = DS2_FWD_CASES, DS2_HOIST_CASES
    _, t, b, h, name, ndir, _ = bwd
    shape = f"T'={t} B={b} H={h} {name} ndir={ndir}"
    return {"lstm_bidir": {"shape": shape,
                           **errs_fwd["by_case"][eval_fwd]["lstm_eval"]},
            "lstm_bidir_train_fwd": {
                "shape": shape, **errs_fwd["by_case"][train_fwd]["lstm_train"]},
            "lstm_bidir_train_bwd": {
                "shape": shape, **{k: v for k, v in errs_hoist["by_case"][
                    bwd].items() if k != "held"},
                "held_of_max_abs_want_1": errs_hoist["by_case"][bwd]["held"]}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    from ctc_pytorch_tpu_torch.ops._build import build_all
    from tools.parent_forms import DEFINE as PARENT_DEFINE
    from tools.parent_forms import libraries as parent_libraries

    lstm_ops, train_ops, ctc_ops = port_ops()
    gru_ops, gru_train_ops = port_gru_ops()
    rnn_ops, rnn_train_ops = port_rnn_ops()
    epilogue_ops = port_epilogue_ops()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1/18] device: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    libraries = [lstm_ops.LIBRARY, train_ops.LIBRARY, ctc_ops.LIBRARY,
                 gru_ops.LIBRARY, gru_train_ops.LIBRARY, rnn_ops.LIBRARY,
                 rnn_train_ops.LIBRARY, epilogue_ops.LIBRARY]
    # and the parent forms of the redesigned branches, which phase 9 times
    parents = parent_libraries()
    build_all(libraries + parents)
    print(f"[2/18] build: {', '.join(lib.source.name for lib in libraries)} and "
          f"the parent forms ({PARENT_DEFINE}) of "
          f"{', '.join(lib.source.name for lib in parents)} for sm_90a, one "
          f"nvcc each, in {time.perf_counter() - t0:.2f} s")
    for lib in libraries:
        lib.load()
        if not lib.build_log:
            print(f"  ptxas {lib.source.name}: cached build, no ptxas output")
        for ln in lib.build_log.splitlines():
            if "registers" in ln or "smem" in ln or "spill" in ln:
                print(f"  ptxas {lib.source.name}:", ln.strip())

    print("[3/18] kernel vs plain on the card")
    errs_eval = phase_lstm_eval_vs_plain()
    errs_train = phase_lstm_train_vs_plain()
    errs_ctc = phase_ctc_vs_plain()
    errs_gru = phase_gru_vs_plain()
    errs_fwd = phase_fwd_vs_plain()
    errs_hoist = phase_hoist_vs_plain()
    errs_rnn = phase_rnn_vs_plain()
    errs_unidir = phase_unidir_vs_plain()
    errs_stacked = phase_stacked_vs_plain()
    graph_branches = phase_graphs_vs_eager()
    errs_epilogue = phase_conv_epilogue_vs_plain(recipe_config())

    print("[4/18] TIMIT decode slice: flagship stage-4 greedy decode")
    decode_launches, spec, model = phase_decode_slice()

    print("[5/18] TIMIT training slice: flagship stage-2 trainer, one epoch")
    train_counts = phase_train_slice(spec)

    print("[6/18] 863 slice: CNN + 4 x BiGRU(256), one epoch in acc mode with "
          "dev_over_train, then stage-4 greedy and beam decodes")
    counts_863, decode_launches_863, spec_863, model_863, beam_863 = (
        phase_863_slice(smi))

    print("[7/18] tanh slice: flagship recipe with rnn_type nn.RNN, CNN + 4 x "
          "BiRNN(384), one epoch, then stage-4 greedy decode")
    (counts_tanh, decode_launches_tanh, cfg_tanh, spec_tanh, model_tanh,
     branches_tanh) = phase_tanh_slice()

    print("[8/18] unidirectional slice: flagship recipe with bidirectional "
          "False, CNN + 4 x LSTM(384), one epoch, then stage-4 greedy decode")
    counts_uni, decode_launches_uni, cfg_uni, spec_uni, model_uni = (
        phase_unidir_slice())

    print(f"[9/18] times ({smi})")
    cfg, cfg_863 = recipe_config(), recipe_config_863()
    bench = {**times_lstm(80, 128, 384, torch.bfloat16, "TIMIT bench shape"),
             **times_ctc(80, 128, spec.num_class, 48, "TIMIT bench shape"),
             **times_gru(95, 128, 256, torch.bfloat16, "863 bench shape"),
             **times_rnn(80, 128, 384, torch.bfloat16, "TIMIT bench shape")}
    recipe = {**times_lstm(100, 8, 384, torch.float32, "TIMIT recipe batch"),
              **times_ctc(100, 8, spec.num_class, 33, "TIMIT recipe batch"),
              **times_gru(95, 16, 256, torch.bfloat16, "863 recipe batch"),
              **times_rnn(100, 8, 384, torch.float32, "TIMIT recipe batch")}
    # the LSTM backward's fp32 cluster at mfcc_39's longest batch and a
    # data-parallel rank's 4 rows (the recipe's batch of 8 is in `recipe`)
    lstm_fp32_bwd = {
        "mfcc39": times_lstm_backward(400, 8, 256, "mfcc_39 longest batch"),
        "dp_rank": times_lstm_backward(100, 4, 384, "data-parallel rank")}
    ctc_863 = {"bench": times_ctc(95, 128, spec_863.num_class, 40,
                                  "863 bench shape"),
               "recipe_batch": times_ctc(95, 16, spec_863.num_class, 40,
                                         "863 recipe batch"),
               # keys of the mfcc_39 shape keep their own suffix
               "mfcc39": times_ctc(400, 8, spec.num_class, 33,
                                   "mfcc_39 longest batch")}
    entry_points = []
    for cell, (t, b, h), (t_r, b_r, dt_r) in (
            ("lstm", (80, 128, 384), (100, 8, torch.float32)),
            ("gru", (95, 128, 256), (95, 16, torch.bfloat16)),
            ("rnn", (80, 128, 384), (100, 8, torch.float32))):
        at_bench = times_stacked(cell, t, b, h, torch.bfloat16, "bench shape")
        at_recipe = times_stacked(cell, t_r, b_r, h, dt_r, "recipe batch")
        for name in at_bench:
            entry_points.append({
                "name": name, "source": "ctc_pytorch_tpu_torch/ops/stacked.py",
                "max_err_vs_plain": max(errs_stacked[name],
                                        errs_stacked[LAYER_OF_SCAN[name]]),
                **at_bench[name],
                "ms_recipe_batch": at_recipe[name]["ms"],
                "plain_ms_recipe_batch": at_recipe[name]["plain_ms"]})
    model_bench = times_model(cfg, spec, model, 128, 160, 48, "flagship",
                              "bench shape")
    model_recipe = times_model(cfg, spec, model, 8, 200, 33, "flagship",
                               "recipe batch")
    bench_863 = times_model(cfg_863, spec_863, model_863, 128, 200, 40,
                            "863 CNN+BiGRU(256)", "bench shape")
    recipe_863 = times_model(cfg_863, spec_863, model_863, 16, 200, 40,
                             "863 CNN+BiGRU(256)", "recipe batch")
    bench_tanh = times_model(cfg_tanh, spec_tanh, model_tanh, 128, 160, 48,
                             "tanh CNN+BiRNN(384)", "bench shape")
    recipe_tanh = times_model(cfg_tanh, spec_tanh, model_tanh, 8, 200, 33,
                              "tanh CNN+BiRNN(384)", "recipe batch")
    times_model(cfg_uni, spec_uni, model_uni, 128, 160, 48,
                "unidirectional CNN+LSTM(384)", "bench shape")
    ctc_share = ctc_step_share(model_recipe, recipe)
    # the wide forward and the GRU's fp32 backward cluster against the grid
    # they replaced
    redesigned = times_redesigned(spec, model, smi)
    prepass_tf32 = times_prepass_tf32(smi)
    epilogue_times = times_conv_epilogue(cfg, smi)

    print(f"[10/18] fused vs streaming: one epoch at drop_out 0 through the "
          f"eager run_epoch and the graphed run_epoch_single ({smi})")
    fused_vs_streaming = [
        phase_fused_vs_streaming(cfg, spec, "flagship CNN+BiLSTM(384)", smi),
        phase_fused_vs_streaming(cfg_863, spec_863, "863 CNN+BiGRU(256)", smi)]

    print(f"[11/18] mfcc_39 slice: 39-d MFCC, 4 x BiLSTM(256), stage 3, one "
          f"fused epoch, stage 4 with Beam and BeamDevice ({smi})")
    mfcc = phase_mfcc39_slice(smi)

    print(f"[12/18] waveform slice: recipes/timit/waveform_config.yaml, stage 1 "
          f"on the card, stage 3, one fused epoch with the frontend in the "
          f"step, stage 4 with Greedy and BeamDevice, Recognizer and "
          f"StreamingRecognizer ({smi})")
    wave = phase_waveform_slice(smi)

    print(f"[13/18] pipeline: stages 0-4 of the flagship recipe through "
          f"cli.run on a synthetic TIMIT tree, profile: True, then "
          f"cli.visualize and cli.import_torch ({smi})")
    pipeline = phase_pipeline_slice(smi)

    print(f"[14/18] 863 LSTM recipes as shipped: cnn_lstm_ctc.conf and "
          f"lstm_ctc.conf from text dumps, one fused epoch each through "
          f"cli.train.train, stage 4, fp32 kernels vs twins ({smi})")
    lstm_863 = phase_863_lstm_slice(smi)

    print(f"[15/18] data parallel: the flagship's step on {DP_WORLD} gloo ranks "
          f"on the card, one NCCL rank from graphs, cli.train --data-parallel, "
          f"the sharded stage-4 search and the mesh Recognizer ({smi})")
    dp = phase_data_parallel(smi, spec)

    print(f"[16/18] fp32 streams on the redesigned branches: the 863 GRU "
          f"model's step at B=8 (cluster16_fp32) and its decode forward at "
          f"B=128, the flagship's, the 863 GRU model's and the tanh model's "
          f"fp32 steps at B=128 (wide_fp32 forwards and backwards), the tanh "
          f"model's fp32 greedy decode at B=128 ({smi})")
    fp32_streams = phase_fp32_streams(cfg_863, spec_863, cfg, spec, cfg_tanh,
                                      spec_tanh, smi)

    print(f"[17/18] remat: the waveform recipe (graphed epoch and an eager "
          f"step at B=128), the flagship (graphed epoch and an eager step at "
          f"B=8) and the 863 GRU model (eager step at B=16) with remat: true "
          f"against remat: false, then ctc_forward_score ({smi})")
    remat = phase_remat(smi)

    ds2 = phase_ds2(smi)

    # launches of every kernel on each model path: its fit and its decode
    def path(counts, eval_kernel, decode):
        return {**counts, eval_kernel: counts[eval_kernel] + decode}

    by_path = {"timit": path(train_counts, "lstm_bidir", decode_launches),
               "863": path(counts_863, "gru_bidir", decode_launches_863),
               "tanh": path(counts_tanh, "rnn_bidir", decode_launches_tanh),
               "unidir": path(counts_uni, "lstm_bidir", decode_launches_uni),
               "mfcc39": path(mfcc["counts"], "lstm_bidir",
                              mfcc["decode_launches"]),
               "waveform": path(wave["counts"], "lstm_bidir", 0),
               # phase 13's counts span stages 2 and 4
               "pipeline": path(pipeline["counts"], "lstm_bidir", 0),
               **{f"863_{tag}": path(r["counts"], "lstm_bidir",
                                     r["decode_launches"])
                  for tag, r in lstm_863.items()},
               # phase 15: every rank's launches, (a), (b) and (d)
               "data_parallel": dp["counts"],
               # phase 17: the remat and plain runs, ctc_forward_score
               "remat": remat["counts"]}
    csrc = "ctc_pytorch_tpu_torch/csrc/"
    tpu = "ctc_pytorch_tpu/ops/"
    lstm_paths = ("timit", "unidir", "mfcc39", "waveform", "pipeline",
                  "863_cnn_lstm_ctc", "863_lstm_ctc", "data_parallel")
    ctc_paths = tuple(by_path)
    # (name, source, TPU kernel, paths that must launch it, worst error fp32,
    # bf16, one direction)
    fwd = csrc + "fwd_cluster.cuh"  # the main paths' forward branches
    rows = [
        ("lstm_bidir", fwd,
         tpu + "lstm_pallas_v2.py:142 lstm_bidir_pallas_v2", lstm_paths,
         max(errs_eval["fp32"], errs_fwd["lstm_eval"]["fp32"]),
         max(errs_eval["bf16"], errs_fwd["lstm_eval"]["bf16"]),
         errs_unidir["lstm"]),
        ("lstm_bidir_train_fwd", fwd,
         tpu + "lstm_pallas_train_v2.py:438 _fwd_pallas (lstm_scan_train_v2)",
         lstm_paths, max(errs_train["fwd"]["fp32"],
                              errs_fwd["lstm_train"]["fp32"]),
         max(errs_train["fwd"]["bf16"], errs_fwd["lstm_train"]["bf16"]),
         errs_unidir["lstm"]),
        ("lstm_bidir_train_bwd_prepass", csrc + "bwd_hoist.cuh",
         tpu + "lstm_pallas_train_v2.py:203 _lstm_prepass (in _bwd_pallas, "
         "call :478)", lstm_paths, errs_hoist["lstm_prepass"]["fp32"],
         errs_hoist["lstm_prepass"]["bf16"], errs_unidir["lstm"]),
        ("lstm_bidir_train_bwd", csrc + "lstm_bidir_train.cu",
         tpu + "lstm_pallas_train_v2.py:478 _bwd_pallas (lstm_scan_train_v2)",
         lstm_paths, max(errs_train["bwd"]["fp32"], errs_hoist["lstm_bwd"]["fp32"]),
         max(errs_train["bwd"]["bf16"], errs_hoist["lstm_bwd"]["bf16"]),
         errs_unidir["lstm"]),
        ("ctc_alpha", csrc + "ctc_dp.cu",
         tpu + "ctc_pallas.py:122 ctc_alpha_pallas (call :132), with "
         "_prepare (:168) and _ll_from_alphas (:180): ctc_fwd_kernel",
         ctc_paths, max(errs_ctc["alpha"], errs_ctc["neg_ll_rel"]), None,
         None),
        ("ctc_beta", csrc + "ctc_dp.cu",
         tpu + "ctc_pallas.py:142 ctc_beta_pallas (call :154), with the VJP "
         "body _neg_ll_pallas_bwd (:214-233): ctc_bwd_kernel", ctc_paths,
         max(errs_ctc["beta"], errs_ctc["grad"]), None, None),
        ("gru_bidir", fwd,
         tpu + "gru_pallas_v2.py:352 _fwd_pallas (gru_bidir_v2 train=False)",
         ("863",), max(errs_gru["eval"]["fp32"], errs_fwd["gru_eval"]["fp32"]),
         max(errs_gru["eval"]["bf16"], errs_fwd["gru_eval"]["bf16"]),
         errs_unidir["gru"]),
        ("gru_bidir_train_fwd", fwd,
         tpu + "gru_pallas_v2.py:352 _fwd_pallas (gru_scan_train_v2)",
         ("863",), max(errs_gru["fwd"]["fp32"], errs_fwd["gru_train"]["fp32"]),
         max(errs_gru["fwd"]["bf16"], errs_fwd["gru_train"]["bf16"]),
         errs_unidir["gru"]),
        ("gru_bidir_train_bwd_prepass", csrc + "bwd_hoist.cuh",
         tpu + "gru_pallas_v2.py:239 pre-pass of _make_bwd_kernel (in "
         "_bwd_pallas, call :382)", ("863",), errs_hoist["gru_prepass"]["fp32"],
         errs_hoist["gru_prepass"]["bf16"], errs_unidir["gru"]),
        ("gru_bidir_train_bwd", csrc + "gru_bidir_train.cu",
         tpu + "gru_pallas_v2.py:382 _bwd_pallas (gru_scan_train_v2)",
         ("863",), max(errs_gru["bwd"]["fp32"], errs_hoist["gru_bwd"]["fp32"]),
         max(errs_gru["bwd"]["bf16"], errs_hoist["gru_bwd"]["bf16"]),
         errs_unidir["gru"]),
        ("rnn_bidir", fwd,
         tpu + "rnn_pallas_v2.py:228 _fwd_pallas (rnn_bidir_v2 train=False)",
         ("tanh",), errs_rnn["eval"]["fp32"], errs_rnn["eval"]["bf16"],
         errs_unidir["rnn"]),
        ("rnn_bidir_train_fwd", fwd,
         tpu + "rnn_pallas_v2.py:228 _fwd_pallas (rnn_scan_v2)",
         ("tanh",), errs_rnn["fwd"]["fp32"], errs_rnn["fwd"]["bf16"],
         errs_unidir["rnn"]),
        ("rnn_bidir_train_bwd", fwd,
         tpu + "rnn_pallas_v2.py:258 _bwd_pallas (rnn_scan_v2)",
         ("tanh",), errs_rnn["bwd"]["fp32"], errs_rnn["bwd"]["bf16"],
         errs_unidir["rnn"]),
    ]
    kernels = []
    for name, source, replaces, paths, err, err_bf16, err_ndir1 in rows:
        launched = {p: c[name] for p, c in by_path.items() if c[name]}
        for p in paths:
            check(p in launched, f"the {p} path never launched {name}")
        at_bench, at_recipe = bench[name], recipe[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(launched.values()),
                 "launches_by_path": launched, "max_abs_err": err,
                 **{k: at_bench[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
                 "ms_recipe_batch": at_recipe["ms"],
                 "plain_ms_recipe_batch": at_recipe["plain_ms"],
                 "bound_ms_recipe_batch": at_recipe["bound_ms"],
                 "library_ms_recipe_batch": at_recipe["library_ms"]}
        # the backwards: the serial kernel alone, its branch, cuDNN in bf16,
        # every turn of the timings
        for key in ("serial_ms", "branch", "ms_rounds", "library_ms_rounds",
                    "library_ms_bf16", "library_ms_bf16_rounds"):
            if key in at_bench:
                entry[key] = at_bench[key]
                entry[f"{key}_recipe_batch"] = at_recipe[key]
        if err_bf16 is not None:
            entry["max_abs_err_bf16"] = err_bf16
        if err_ndir1 is not None:
            entry["max_err_one_direction"] = err_ndir1
        if remat["counts"][name]:  # phase 17's, remat and plain runs
            entry["launches_remat_phase"] = remat["counts"][name]
        if name in branches_tanh:  # the tanh path's launches by branch
            entry["launches_by_branch"] = branches_tanh[name]
        if name in wave["branches"]:  # the waveform path's, at B=128
            entry["launches_by_branch_waveform"] = wave["branches"][name]
        if name in pipeline["branches"]:  # cli.run's stages 2 and 4, B=8
            entry["launches_by_branch_pipeline"] = pipeline["branches"][name]
        for tag, r in lstm_863.items():  # the 863 LSTM fits, B=16
            if name in r["branches"]:
                entry[f"launches_by_branch_863_{tag}"] = r["branches"][name]
        # the branches phase 3 captured and replayed against the eager call
        entry["graph_replayed_branches"] = graph_branches[name]
        if name == "lstm_bidir_train_bwd":
            entry["kernel_by_branch"] = LSTM_BWD_KERNELS
            entry["fp32_cluster_shapes"] = lstm_fp32_bwd
        if name.startswith("ctc"):
            for shape, at in ctc_863.items():
                suffix = shape if shape == "mfcc39" else f"863_{shape}"
                entry.update({f"{k}_{suffix}": at[name][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms",
                    "latency_bound_ms", "library_ms")})
            for k in ("device_ms", "latency_bound_ms", "branch"):
                entry[k] = at_bench[k]
                entry[f"{k}_recipe_batch"] = at_recipe[k]
            entry["branches_phase3"] = errs_ctc["branches"][
                "fwd" if name == "ctc_alpha" else "bwd"]
            if name == "ctc_alpha":
                entry["whole_loss"] = {
                    shape: {k: at["ctc_alpha"][k] for k in (
                        "loss_fwd_bwd_ms", "library_loss_fwd_bwd_ms",
                        "loss_fwd_bwd_device_ms",
                        "library_loss_fwd_bwd_device_ms",
                        "loss_alone_device_ms")}
                    for shape, at in (("timit_bench", bench),
                                      ("timit_recipe", recipe), *ctc_863.items())}
                entry["share_of_flagship_b8_step"] = ctc_share
        kernels.append(entry)
    # the redesigned branches, one entry each: their launches on the main
    # paths (the phases that record launches by branch), their worst error
    # against the twins in phase 3, their times against the grid and cuDNN
    branch_runs = [wave["branches"], pipeline["branches"],
                   *(r["branches"] for r in lstm_863.values()),
                   *(r["branches"] for st in dp["steps"].values()
                     for r in st["ranks"]),
                   *(v["branches"] for v in fp32_streams.values())]

    def branch_launches(ops, branch):
        return sum(run.get(op, {}).get(branch, 0)
                   for run in branch_runs for op in ops)

    wide = csrc + "fwd_wide.cuh"
    for (name, ops, branch, source, replaces, key, err_keys) in (
            ("lstm_bidir_wide_fp32", ("lstm_bidir",), "wide_fp32", wide,
             tpu + "lstm_pallas_v2.py:142 lstm_bidir_pallas_v2 (call :177), "
             "fp32 products at B >= 64", "lstm_eval_80_128_384_fp32",
             [("fwd", "lstm_eval:wide_fp32")]),
            ("lstm_bidir_train_fwd_wide_fp32", ("lstm_bidir_train_fwd",),
             "wide_fp32", wide, tpu + "lstm_pallas_train_v2.py:438 "
             "_fwd_pallas (lstm_scan_train_v2), fp32 streams at B >= 64",
             "lstm_train_80_128_384_fp32", [("fwd", "lstm_train:wide_fp32")]),
            ("gru_bidir_wide_fp32", ("gru_bidir", "gru_bidir_train_fwd"),
             "wide_fp32", wide, tpu + "gru_pallas_v2.py:352 _fwd_pallas, fp32 "
             "streams at B >= 64", "gru_95_128_256_fp32",
             [("fwd", "gru_eval:wide_fp32"), ("fwd", "gru_train:wide_fp32")]),
            ("gru_bidir_train_bwd_cluster16_fp32", ("gru_bidir_train_bwd",),
             "cluster16_fp32", csrc + "bwd_hoist.cuh",
             tpu + "gru_pallas_v2.py:382 _bwd_pallas (gru_scan_train_v2), fp32 "
             "streams", "gru_bwd_95_8_256_fp32",
             [("hoist", "gru:cluster16_fp32")]),
            ("lstm_bidir_train_bwd_wide_fp32", ("lstm_bidir_train_bwd",),
             "wide_fp32", csrc + "bwd_wide.cuh",
             tpu + "lstm_pallas_train_v2.py:478 _bwd_pallas "
             "(lstm_scan_train_v2), fp32 streams at B >= 64",
             "lstm_bwd_80_128_384_fp32", [("hoist", "lstm:wide_fp32")]),
            ("gru_bidir_train_bwd_wide_fp32", ("gru_bidir_train_bwd",),
             "wide_fp32", csrc + "bwd_wide.cuh",
             tpu + "gru_pallas_v2.py:382 _bwd_pallas (gru_scan_train_v2), fp32 "
             "streams at B >= 64", "gru_bwd_95_128_256_fp32",
             [("hoist", "gru:wide_fp32")]),
            ("rnn_bidir_wide_fp32", ("rnn_bidir", "rnn_bidir_train_fwd"),
             "wide_fp32", wide, tpu + "rnn_pallas_v2.py:228 _fwd_pallas "
             "(rnn_bidir_v2, rnn_scan_v2), fp32 streams where no fp32 cluster "
             "fits (B >= 113 at H = 384)", "rnn_80_128_384_fp32",
             [("rnn", "eval:wide_fp32"), ("rnn", "fwd:wide_fp32")]),
            ("rnn_bidir_train_bwd_wide_fp32", ("rnn_bidir_train_bwd",),
             "wide_fp32", wide, tpu + "rnn_pallas_v2.py:258 _bwd_pallas "
             "(rnn_scan_v2), fp32 streams where no fp32 cluster fits (B >= "
             "113 at H = 384)", "rnn_bwd_80_128_384_fp32",
             [("rnn", "bwd:wide_fp32")])):
        at = redesigned[key]
        errs = {"fwd": errs_fwd["by_branch"], "hoist": errs_hoist["by_branch"],
                "rnn": errs_rnn["by_branch"]}
        err = max(errs[kind][k].get("fp32", 0.0) for kind, k in err_keys)
        launches = branch_launches(ops, branch)
        check(launches > 0, f"no main path launched {name}")
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches,
                 "max_abs_err": err,
                 **{k: at[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                 "shape": key}
        # every timed shape of the same op on this branch: its name up to
        # the first number (the bf16 form's timings have rows of their own)
        op_key = re.match(r"\D+", key).group(0)
        entry["times"] = {k: v for k, v in redesigned.items()
                          if re.match(r"\D+", k).group(0) == op_key
                          and v.get("branch") != "wide_bf16"}
        if branch == "wide_fp32":
            # its product runs in 3xTF32 on the tensor cores: beside the
            # fp32 bound, the bound of that work at the tensor cores' rate
            # (the backwards': of the serial chain, beside its serial_ms)
            entry["tf32x3_bound_ms"] = at["tf32x3_bound_ms"]
        if err_keys[0][0] == "fwd" and branch == "wide_fp32":
            entry["max_abs_err_bf16_streams"] = max(
                errs["fwd"][k].get("bf16", 0.0) for kind, k in err_keys)
        if err_keys[0][0] == "hoist" and branch == "wide_fp32":
            for k in ("serial_ms", "grid_serial_ms", "prepass_ms", "grid_ms",
                      "serial_bound_ms", "library_ms_bf16"):
                entry[k] = at[k]
        kernels.append(entry)
    # the wide branch's bf16 form, one entry a cell: its launches on the
    # main paths (phase 18's DeepSpeech2 step; no recipe's GRU is that wide,
    # so the GRU's are phase 3's cases), its worst error against the twins
    # in phase 3 (bf16 streams), its times against the grid and cuDNN
    ds2_fwd = ds2["launches"].get("lstm_bidir_train.launches_fwd_branch", {})
    for (name, ops, source_ops, replaces, key, err_keys) in (
            ("lstm_bidir_train_fwd_wide_bf16", ("lstm_bidir_train_fwd",),
             ("lstm_train",), tpu + "lstm_pallas_train_v2.py:438 _fwd_pallas "
             "(lstm_scan_train_v2), bf16 streams where no bf16 cluster holds "
             "the shape (DeepSpeech2's H = 1024 at B = 64)",
             "lstm_train_1200_64_1024_bf16", ["lstm_train:wide_bf16"]),
            ("gru_bidir_wide_bf16", ("gru_bidir", "gru_bidir_train_fwd"),
             ("gru_eval", "gru_train"), tpu + "gru_pallas_v2.py:352 "
             "_fwd_pallas, bf16 streams where no bf16 cluster holds the shape",
             "gru_95_128_512_bf16", ["gru_eval:wide_bf16",
                                     "gru_train:wide_bf16"])):
        at = redesigned[key]
        launches = branch_launches(ops, "wide_bf16")
        if name.startswith("lstm"):
            launches_ds2 = ds2_fwd.get("wide_bf16", 0)
            check(launches_ds2 > 0, f"phase 18 never launched {name}")
            launches += launches_ds2
        cases = sum(1 for v in errs_fwd["by_case"].values()
                    for k in source_ops if v.get(k, {}).get("branch")
                    == "wide_bf16")
        check(cases > 0, f"no card case launched {name}")
        entry = {"name": name, "route": "cuda", "source": wide,
                 "kernel": "fwd_wide_kernel<Cell, __nv_bfloat16, true>",
                 "replaces": replaces, "launches": launches,
                 "launches_card_cases": cases,
                 "max_abs_err": max(errs_fwd["by_branch"].get(k, {}).get(
                     "bf16", 0.0) for k in err_keys),
                 **{k: at[k] for k in ("ms", "grid_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "us_a_step",
                                       "grid_us_a_step", "max_abs_vs_grid")},
                 "shape": key,
                 "times": {k: v for k, v in redesigned.items()
                           if v.get("branch") == "wide_bf16"
                           and k.startswith(key.split("_")[0])}}
        if name.startswith("lstm"):
            entry["launches_ds2_phase"] = launches_ds2
        kernels.append(entry)
    # the fp32 pre-pass, one entry a cell: its launches on the main paths
    # (the phases' counts, and phase 16's fp32 steps), its worst error
    # against the twin in phase 3, its times at PREPASS_TIMES beside cuBLAS
    for cell, paths, key, replaces in (
            ("lstm", ("timit", "unidir", "mfcc39", "pipeline", "data_parallel"),
             "lstm_prepass_80_128_384_fp32",
             tpu + "lstm_pallas_train_v2.py:203 _lstm_prepass (in _bwd_pallas, "
             "call :478), fp32 streams"),
            ("gru", (), "gru_prepass_95_128_256_fp32",
             tpu + "gru_pallas_v2.py:239 pre-pass of _make_bwd_kernel (in "
             "_bwd_pallas, call :382), fp32 streams")):
        name = f"{cell}_bidir_train_bwd_prepass_tf32"
        launched = {p: c[name] for p, c in by_path.items() if c.get(name)}
        for p in paths:
            check(p in launched, f"the {p} path never launched {name}")
        launched["fp32_streams"] = branch_launches(
            (f"{cell}_bidir_train_bwd_prepass",), "prepass_tf32_kernel")
        check(launched["fp32_streams"] > 0,
              f"phase 16's fp32 steps never launched {name}")
        at = prepass_tf32[key]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "bwd_hoist.cuh",
            "replaces": replaces, "launches": sum(launched.values()),
            "launches_by_path": launched,
            "max_abs_err": errs_hoist[f"{cell}_prepass"]["fp32"],
            **{k: at[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "device_ms",
                                  "library_device_ms")},
            "library": "torch.matmul of the product alone, fp32",
            "shape": key, "kernel": f"prepass_tf32_kernel<{cell.capitalize()}"
                                    f"Cell, WM, WU>",
            "times": {k: v for k, v in prepass_tf32.items()
                      if k.startswith(cell)}})
    # the CNN's conv epilogue: no TPU kernel (XLA fuses the JAX package's
    # chain); its launches on the main paths, its worst errors against the
    # twin in phase 3, the stack's device time both ways at the cells'
    # shapes in phase 9 (ms: B=128 T=392; _recipe_batch: B=8 T=200)
    name = "cnn_epilogue_fwd"
    launched = {p: c[name] for p, c in by_path.items() if c.get(name)}
    for p in ("timit", "863", "tanh", "unidir", "pipeline",
              "863_cnn_lstm_ctc"):
        check(p in launched, f"the {p} path never launched {name}")
    at, at_recipe = epilogue_times["b128_t392"], epilogue_times["b8_t200"]
    kernels.append({
        "name": "cnn_conv_epilogue", "route": "cuda",
        "source": csrc + "conv_epilogue.cu",
        "replaces": "no TPU kernel: XLA fuses the conv bias, BatchNorm2d, "
                    "activation and tail mask of ctc_pytorch_tpu/models/"
                    "cnn.py:cnn_stack_apply",
        "kernels": ["cnn_bn_stats_kernel", "cnn_bn_apply_kernel",
                    "cnn_bn_grad_sums_kernel", "cnn_bn_grad_apply_kernel",
                    "cnn_bn_sum_kernel"],
        "launches": sum(launched.values()), "launches_by_path": launched,
        "launches_bwd": sum(c.get("cnn_epilogue_bwd", 0)
                            for c in by_path.values()),
        "max_err_vs_plain": errs_epilogue,
        "ms": at["ms"], "plain_ms": at["plain_ms"],
        "kernels_ms": at["kernels_ms"], "bound_ms": at["bound_ms"],
        "bound_by": "bytes", "ms_recipe_batch": at_recipe["ms"],
        "plain_ms_recipe_batch": at_recipe["plain_ms"],
        "kernels_ms_recipe_batch": at_recipe["kernels_ms"],
        "bound_ms_recipe_batch": at_recipe["bound_ms"],
        "times": epilogue_times})
    by_name = {k["name"]: k for k in kernels}
    for name, at in ds2_table_errors(errs_fwd, errs_hoist).items():
        by_name[name]["ds2_shape"] = at
        by_name[name]["launches_ds2_phase"] = ds2["launches"]
    by_name["lstm_bidir"]["flagship_decode_forward_b128"] = redesigned[
        "flagship_decode_forward_b128"]
    for fwd, train_fwd, at_bench, at_recipe in (
            ("lstm_bidir", "lstm_bidir_train_fwd", model_bench, model_recipe),
            ("gru_bidir", "gru_bidir_train_fwd", bench_863, recipe_863),
            ("rnn_bidir", "rnn_bidir_train_fwd", bench_tanh, recipe_tanh)):
        by_name[fwd].update(forward_ms=at_bench["forward_ms"],
                            forward_ms_recipe_batch=at_recipe["forward_ms"])
        by_name[train_fwd].update(
            train_step_ms=at_bench["train_step_ms"],
            train_step_device_ms=at_bench["train_step_device_ms"],
            train_step_ms_recipe_batch=at_recipe["train_step_ms"])
    print(json.dumps({"kernels": kernels, "entry_points": entry_points,
                      "fused_vs_streaming": fused_vs_streaming,
                      "beam_decode": {"mfcc39": mfcc["beam"],
                                      "863": beam_863},
                      "mfcc39_model": mfcc["model"],
                      "waveform": {k: v for k, v in wave.items()
                                   if k not in ("counts", "branches")},
                      "pipeline": {k: v for k, v in pipeline.items()
                                   if k not in ("counts", "branches")},
                      "863_lstm": {tag: {k: v for k, v in r.items()
                                         if k not in ("counts", "branches")}
                                   for tag, r in lstm_863.items()},
                      "data_parallel": {k: v for k, v in dp.items()
                                        if k != "counts"},
                      "fp32_streams": fp32_streams,
                      "remat": {k: v for k, v in remat.items()
                                if k != "counts"},
                      "ds2": ds2}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    sys.exit(code)
