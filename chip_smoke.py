#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ctc_pytorch_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each a
printed line; any failure ends the run with a nonzero exit and no result:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel source under ``csrc/`` with nvcc, in parallel;
3. kernel vs plain: each of the five kernels (eval BiLSTM, trainable BiLSTM
   forward and backward, CTC alpha and beta) against its plain PyTorch
   version on the card, at the main paths' shapes and at edge shapes, with
   stated tolerances;
4. decode slice: stage 4 of the flagship TIMIT recipe at full width
   (CNN + 4 x BiLSTM(384), bf16) on a synthetic TIMIT-layout test set,
   with random weights from a seed, through ``cli.test.evaluate``; checks
   that every BiLSTM layer went through the kernel and that, in fp32, the
   kernel path and the plain path decode identical strings and PER;
5. training slice: stage 2 of the same recipe (batch 8, bf16) on a synthetic
   train and dev split through ``Trainer.fit`` for one epoch and
   ``save_best``; checks the launch counts of the four training kernels, that
   the loss fell, that the BN counters moved and that the saved package
   decodes; then two fp32 optimizer steps through the kernels and through
   the plain twins on the card, which must agree;
6. times at the bench shape (B=128, T=160 -> T'=80, L=48) and at the
   recipe's batch (B=8, T=200): every kernel, its plain twin, its bound and
   the library call for the same function, then the decode forward and the
   whole train step with their device time by kernel.

It prints one JSON line of per-kernel results, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It imports nothing of
the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".chip_smoke"  # synthetic corpus + packages, removed at exit
RECIPE = ROOT / "recipes" / "timit" / "ctc_config.yaml"

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores
BF16_FLOP_PER_S = 989e12  # tensor cores, dense, fp32 sums

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
N_TRAIN_UTTS, N_DEV_UTTS = 64, 16
PHONES = ("aa ae ah ao aw ax ay b ch d dh dx eh el en er ey f g hh ih iy "
          "jh k l m n ng ow oy p r s sh t th uh uw v").split()


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


def device_breakdown(fn):
    """Device time of one ``fn()`` by kernel name, from ``torch.profiler``:
    (total microseconds, [(name, microseconds)] largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])
    return sum(us for _, us in rows), rows


def lstm_inputs(t, b, h, dtype, seed):
    """``(gx, w_hh, dy)`` on the card, from a seed."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    gx = torch.randn(t, b, 8 * h, generator=gen).to(dtype).cuda()
    bound = h ** -0.5
    w_hh = (torch.rand(2, h, 4 * h, generator=gen) * 2 - 1) * bound
    dy = torch.randn(t, b, 2 * h, generator=gen).to(dtype).cuda()
    return gx, w_hh.cuda(), dy


def ctc_inputs(t, b, c, l, seed, full: bool = False):
    """``(log_probs, labels, input_lengths, label_lengths)`` on the card.
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
    return tuple(x.cuda() for x in (log_probs, labels, in_len, lab_len))


def port_ops():
    from ctc_pytorch_tpu_torch.ops import ctc_loss as ctc_ops
    from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
    from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as train_ops

    return lstm_ops, train_ops, ctc_ops


def launch_counts() -> dict:
    lstm_ops, train_ops, ctc_ops = port_ops()
    return {"lstm_bidir": lstm_ops.launches,
            "lstm_bidir_train_fwd": train_ops.launches_fwd,
            "lstm_bidir_train_bwd": train_ops.launches_bwd,
            "ctc_alpha": ctc_ops.launches_alpha,
            "ctc_beta": ctc_ops.launches_beta}


def zero_counts() -> None:
    lstm_ops, train_ops, ctc_ops = port_ops()
    lstm_ops.launches = 0
    train_ops.launches_fwd = train_ops.launches_bwd = 0
    ctc_ops.launches_alpha = ctc_ops.launches_beta = 0


@contextlib.contextmanager
def plain_twins():
    """Inside the block the ops run their plain twins on CUDA tensors too, so a kernel path can be held against them on the card.  The
    block must launch no kernel."""
    lstm_ops, train_ops, ctc_ops = port_ops()
    swaps = [(lstm_ops, "lstm_bidir_cuda", lstm_ops.lstm_bidir_plain),
             (train_ops, "lstm_bidir_train_cuda", train_ops.lstm_bidir_train_plain),
             (train_ops, "lstm_bidir_train_backward_cuda",
              train_ops.lstm_bidir_train_backward_plain),
             (ctc_ops, "ctc_alpha_cuda", ctc_ops.ctc_alpha_plain),
             (ctc_ops, "ctc_beta_cuda", ctc_ops.ctc_beta_plain)]
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
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (t, b, h, dt) in enumerate(cases):
        gx, w_hh, _ = lstm_inputs(t, b, h, dt, seed=100 + i)
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
    ]
    worst = {"fwd": {"fp32": 0.0, "bf16": 0.0}, "bwd": {"fp32": 0.0, "bf16": 0.0}}
    for i, (t, b, h, dt) in enumerate(cases):
        bf16 = dt == torch.bfloat16
        name = "bf16" if bf16 else "fp32"
        gx, w_hh, dy = lstm_inputs(t, b, h, dt, seed=200 + i)
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


def phase_ctc_vs_plain() -> dict:
    """Alpha and beta kernels against their plain twins (tables: the same
    cells dead, pinned to NEG_INF, live cells within FP32_TOL), then neg_ll
    and the gradient through ``ctc_loss`` on the kernels against the same
    call on the twins."""
    import torch

    _, _, ctc_ops = port_ops()
    cases = [  # (T', B, classes, L, what)
        (80, 128, 41, 48, "bench shape, lengths below the pad"),
        (100, 8, 41, 33, "the recipe's batch"),
        (1, 1, 5, 0, "T = 1, S = 1: an empty label"),
        (7, 3, 5, 2, "odd T"),
        (30, 2, 50, 600, "S = 1201: more positions than threads in a CTA"),
        (20, 4, 6, 4, "one infeasible utterance, one empty label"),
    ]
    worst = {"alpha": 0.0, "beta": 0.0, "neg_ll_rel": 0.0, "grad": 0.0}
    for i, (t, b, c, l, what) in enumerate(cases):
        log_probs, labels, in_len, lab_len = ctc_inputs(t, b, c, l, seed=300 + i)
        infeasible = None
        if "infeasible" in what:
            labels[2] = 3  # four equal labels need seven frames, it has five
            in_len = torch.tensor([20, 17, 5, 20], dtype=torch.int32).cuda()
            lab_len = torch.tensor([4, 2, 4, 0], dtype=torch.int32).cuda()
            infeasible = 2
        _, emit, skip_in, skip_out, mask, s_len = ctc_ops.prepare(
            log_probs, labels, lab_len)
        alphas = ctc_ops.ctc_alpha_cuda(emit, skip_in, mask, in_len)
        betas = ctc_ops.ctc_beta_cuda(emit, skip_out, mask, in_len, s_len)
        torch.cuda.synchronize()
        errs = {}
        # beta rows past an utterance's last frame are don't-care
        valid = (torch.arange(t, device="cuda")[:, None] < in_len[None, :])[..., None]
        for key, got, want, care in (
                ("alpha", alphas,
                 ctc_ops.ctc_alpha_plain(emit, skip_in, mask, in_len), None),
                ("beta", betas,
                 ctc_ops.ctc_beta_plain(emit, skip_out, mask, in_len, s_len),
                 valid)):
            dead = want <= ctc_ops.NEG_INF / 2
            care = torch.ones_like(dead) if care is None else care.expand_as(dead)
            check(torch.equal((got <= ctc_ops.NEG_INF / 2) & care, dead & care),
                  f"ctc_{key}: other cells dead than in the plain table ({what})")
            check(torch.all(got[dead & care] == ctc_ops.NEG_INF).item(),
                  f"ctc_{key}: a dead cell is not pinned to NEG_INF ({what})")
            live = ~dead & care
            errs[key] = max_err(got[live], want[live]) if live.any() else 0.0
            check(errs[key] <= FP32_TOL, f"ctc_{key} disagrees with plain ({what})")

        def loss_and_grad():
            x = log_probs.clone().requires_grad_(True)
            neg_ll = ctc_ops.ctc_loss(x, labels, in_len, lab_len,
                                      reduction="none")
            neg_ll.sum().backward()
            return neg_ll.detach(), x.grad

        neg_ll, grad = loss_and_grad()
        with plain_twins():
            want_ll, want_grad = loss_and_grad()
        torch.cuda.synchronize()
        errs["neg_ll_rel"] = ((neg_ll - want_ll).abs()
                              / want_ll.abs().clamp(min=1.0)).max().item()
        errs["grad"] = max_err(grad, want_grad)
        print(f"  ctc T={t} B={b} S={2 * l + 1} ({what}): alpha "
              f"{errs['alpha']:.3g}, beta {errs['beta']:.3g} (tol {FP32_TOL}); "
              f"neg_ll rel {errs['neg_ll_rel']:.3g} (tol {CTC_LL_RTOL}), "
              f"grad {errs['grad']:.3g} (tol {FP32_TOL})")
        check(torch.isfinite(neg_ll).all().item()
              and torch.isfinite(grad).all().item(), f"non-finite CTC loss ({what})")
        check(errs["neg_ll_rel"] <= CTC_LL_RTOL,
              f"neg_ll disagrees with plain ({what})")
        check(errs["grad"] <= FP32_TOL, f"CTC gradient disagrees with plain ({what})")
        if infeasible is not None:
            check(neg_ll[infeasible].item() >= -ctc_ops.NEG_INF / 2,
                  "the infeasible utterance has no huge loss")
            check(not grad[:, infeasible].any().item(),
                  "the infeasible utterance has a gradient")
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    return worst


def write_corpus(root: Path, split: str = "test", n_utts: int = 64,
                 seed: int = 0) -> None:
    """One split of a synthetic TIMIT-layout corpus: 81-d fbank-like
    ark/scp, phn_text and a 39-phone units file."""
    import numpy as np

    from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter

    rng = np.random.RandomState(seed)
    test = root / split
    test.mkdir(parents=True, exist_ok=True)
    (root / "units").write_text("".join(p + "\n" for p in PHONES))
    lines = []
    with ArkWriter(test / "fbank.ark", test / "fbank.scp") as w:
        for i in range(n_utts):
            utt = f"{split}{i % 8}_si{i:03d}"
            frames = int(rng.randint(150, 401))
            feat = rng.randn(frames, 81).astype(np.float32)
            w.write(utt, feat)
            n_ph = max(1, frames // 12)
            lines.append(utt + " " + " ".join(rng.choice(PHONES, n_ph)))
    (test / "phn_text").write_text("\n".join(lines) + "\n")


def recipe_config():
    """The flagship recipe with its data paths pointed at the synthetic
    corpus under ``WORK``."""
    from ctc_pytorch_tpu_torch.config import load_config

    cfg = load_config(RECIPE)
    data = WORK / "data"
    cfg.vocab_file = str(data / "units")
    for split, name in (("train", "train"), ("valid", "dev"), ("test", "test")):
        setattr(cfg, f"{split}_scp_path", str(data / name / "fbank.scp"))
        setattr(cfg, f"{split}_lab_path", str(data / name / "phn_text"))
    cfg.checkpoint_dir = str(WORK / "checkpoint")
    return cfg


def phase_decode_slice():
    """Stage 4 of the flagship recipe through the port's entry points."""
    import torch

    from ctc_pytorch_tpu_torch.cli.test import evaluate
    from ctc_pytorch_tpu_torch.models import CTCModel, ModelSpec
    from ctc_pytorch_tpu_torch.train.checkpoint import save_package
    from ctc_pytorch_tpu_torch.vocab import Vocab

    lstm_ops, _, _ = port_ops()
    write_corpus(WORK / "data", "test", N_DECODE_UTTS, seed=0)
    cfg = recipe_config()
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    check(spec.compute_dtype == "bfloat16" and spec.rnn_layers == 4
          and spec.rnn_hidden_size == 384 and spec.add_cnn,
          f"recipe is not the flagship: {spec}")
    model = CTCModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        # random weights give near-flat posteriors where a 1e-6 difference
        # flips an argmax; a sharper output layer makes the strings stable
        model.fc.w.mul_(10.0)
    pkg_bf16 = WORK / "checkpoint" / "flagship_bf16.npz"
    pkg_fp32 = WORK / "checkpoint" / "flagship_fp32.npz"
    save_package(pkg_bf16, spec, model, config=cfg)
    spec32 = dataclasses.replace(spec, compute_dtype="float32")
    save_package(pkg_fp32, spec32, model, config=cfg)

    def run(pkg):
        lines = []
        t0 = time.perf_counter()
        res = evaluate(cfg, str(pkg), device="cuda", log=lines.append)
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        decoded = [ln for ln in lines if ln.startswith("decoded: ")]
        return res, decoded, lines

    zero_counts()
    res, decoded, lines = run(pkg_bf16)
    launches = launch_counts()["lstm_bidir"]
    print(f"  bf16 flagship decode: {res['batches']} batches, "
          f"{len(decoded)} utts, CER {res['cer']:.4f} WER {res['wer']:.4f}, "
          f"wall {res['wall_s']:.3f} s (first call, includes data load)")
    print("  " + lines[-1])
    check(len(decoded) == N_DECODE_UTTS,
          f"decoded {len(decoded)} of {N_DECODE_UTTS} utterances")
    check(launches == 4 * res["batches"],
          f"kernel launches {launches} != 4 x {res['batches']} batches")

    lstm_ops.launches = 0
    res32, dec32, _ = run(pkg_fp32)
    check(lstm_ops.launches == 4 * res32["batches"],
          f"fp32 run: launches {lstm_ops.launches} != 4 x batches")
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
    return launches, spec, model


def batch_tensors(batch):
    """A host ``Batch`` as the train step's tensors on the card."""
    import torch

    return tuple(torch.from_numpy(a).cuda() for a in (
        batch.feats, batch.input_frac, batch.labels, batch.label_lengths,
        batch.example_mask))


def phase_train_slice(spec) -> dict:
    """Stage 2 of the flagship recipe through ``Trainer.fit``; returns the
    kernels' launch counts over the fit."""
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

    write_corpus(WORK / "data", "train", N_TRAIN_UTTS, seed=1)
    write_corpus(WORK / "data", "dev", N_DEV_UTTS, seed=2)
    cfg = recipe_config()
    cfg.exp_name = "smoke_train"
    check(cfg.batch_size == 8 and cfg.dtype == "bfloat16" and cfg.drop_out > 0,
          "the recipe is not the flagship's batch-8 bf16 training")
    train_loader, dev_loader = build_loaders(cfg, Vocab(cfg.vocab_file))
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
    steps, dev_batches = trainer.state.step, len(dev_loader)
    loss_after = probe_loss()
    for ln in lines:
        print("  " + ln)
    print(f"  Trainer.fit, 1 epoch: {steps} optimizer steps, {dev_batches} dev "
          f"batches, wall {wall:.3f} s; launches {counts}")
    print(f"  loss on one train batch (train mode, no dropout): "
          f"{loss_before:.4f} before the epoch, {loss_after:.4f} after")
    check(steps >= 8, f"only {steps} optimizer steps")
    want = {"lstm_bidir_train_fwd": 4 * steps, "lstm_bidir_train_bwd": 4 * steps,
            "ctc_alpha": steps + dev_batches,  # the dev pass computes its loss
            "ctc_beta": steps, "lstm_bidir": 4 * dev_batches}
    check(counts == want, f"launches {counts}, expected {want}")
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
    check(len(decoded) == N_DECODE_UTTS and math.isfinite(res["wer"]),
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
    check(launch_counts() == {"lstm_bidir_train_fwd": 8, "lstm_bidir_train_bwd": 8,
                              "ctc_alpha": 2, "ctc_beta": 2, "lstm_bidir": 0},
          f"two fp32 steps launched {launch_counts()}")
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


def lstm_bound(gx, w_hh, n_planes: int, n_products: int, n_gate_planes: int = 1,
               bf16_products: bool = False):
    """Least time the card could take for one recurrence call: the larger of
    its bytes (``n_gate_planes`` (T, B, 8H) and ``n_planes`` (T, B, 2H)
    planes in the stream dtype and w_hh, each moved once) over the memory
    rate and its (B, H) x (H, 4H)-sized products (``n_products`` per step and
    direction) over the card's peak for their operands.  ``bf16_products``:
    both operands are bf16 values summed in fp32 (the training kernels with
    bf16 streams), which the tensor cores multiply; otherwise an operand is
    fp32 (the eval kernel's h and w_hh, and everything with fp32 streams) and
    the peak is the fp32 one."""
    t, b, _ = gx.shape
    h = w_hh.shape[1]
    es = gx.element_size()
    bytes_moved = (n_gate_planes * gx.numel() * es + w_hh.numel() * 4
                   + n_planes * t * b * 2 * h * es)
    flops = n_products * 2 * t * b * h * 4 * h * 2
    peak = BF16_FLOP_PER_S if bf16_products else FP32_FLOP_PER_S
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes > by_ops else "operations",
            "bytes_ms": by_bytes * 1e3, "ops_ms": by_ops * 1e3,
            "peak": ("bf16 tensor-core peak, 989 TFLOP/s" if bf16_products
                     else "fp32 peak, 67 TFLOP/s"),
            "gflop": flops / 1e9, "mbytes": bytes_moved / 1e6}


def ctc_bound(emit):
    """Least time for one alpha or beta call: emit read and the table
    written, fp32, over the memory rate; against about 30 fp32 operations a
    cell (three exp, one log, the sums) over the fp32 peak."""
    t, b, s = emit.shape
    bytes_moved = 2 * emit.numel() * 4 + 2 * b * s * 4 + 2 * b * 4
    flops = 30 * t * b * s
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes > by_ops else "operations",
            "gflop": flops / 1e9, "mbytes": bytes_moved / 1e6}


def times_lstm(t, b, h, dtype, tag) -> dict:
    """Per-call times of the three recurrence kernels at one shape, their
    plain twins, bounds and the cuDNN yardstick."""
    import torch

    lstm_ops, train_ops, _ = port_ops()
    gx, w_hh, dy = lstm_inputs(t, b, h, dtype, seed=7)
    ys, cs = train_ops.lstm_bidir_train_cuda(gx, w_hh)
    # the training kernels round w_hh, h and dpre to the stream dtype
    bf16 = dtype == torch.bfloat16
    out = {
        "lstm_bidir": {
            "ms": cuda_ms(lambda: lstm_ops.lstm_bidir_cuda(gx, w_hh), reps=20),
            "plain_ms": cuda_ms(lambda: lstm_ops.lstm_bidir_plain(gx, w_hh),
                                reps=5),
            **lstm_bound(gx, w_hh, n_planes=1, n_products=1)},
        "lstm_bidir_train_fwd": {
            "ms": cuda_ms(lambda: train_ops.lstm_bidir_train_cuda(gx, w_hh),
                          reps=20),
            "plain_ms": cuda_ms(
                lambda: train_ops.lstm_bidir_train_plain(gx, w_hh), reps=5),
            **lstm_bound(gx, w_hh, n_planes=2, n_products=1, bf16_products=bf16)},
        "lstm_bidir_train_bwd": {
            "ms": cuda_ms(lambda: train_ops.lstm_bidir_train_backward_cuda(
                gx, w_hh, ys, cs, dy), reps=20),
            "plain_ms": cuda_ms(
                lambda: train_ops.lstm_bidir_train_backward_plain(
                    gx, w_hh, ys, cs, dy), reps=5),
            # gx, ys, cs, dy in, dgx out; gate recompute and dpre @ w_hh^T
            **lstm_bound(gx, w_hh, n_planes=3, n_products=2, n_gate_planes=2,
                         bf16_products=bf16)},
    }
    # library yardstick: cuDNN BiLSTM, bias-free, fp32, forward and backward;
    # it also computes the input projection (T*B, 2H) @ (2H, 8H) and its
    # gradients, which the kernels are given and leave to the caller
    lstm = torch.nn.LSTM(2 * h, h, bias=False, bidirectional=True).cuda()
    x_lib = torch.randn(t, b, 2 * h, device="cuda", requires_grad=True)
    dy_lib = torch.randn(t, b, 2 * h, device="cuda")
    with torch.no_grad():
        out["lstm_bidir"]["library_ms"] = cuda_ms(lambda: lstm(x_lib), reps=20)
    out["lstm_bidir_train_fwd"]["library_ms"] = cuda_ms(
        lambda: lstm(x_lib), reps=20)
    y_lib, _ = lstm(x_lib)
    wrt = (x_lib, *lstm.parameters())
    out["lstm_bidir_train_bwd"]["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(y_lib, wrt, dy_lib, retain_graph=True),
        reps=20)
    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    for k, v in out.items():
        print(f"  {k}, {tag} T'={t} B={b} H={h} {name} streams: {v['ms']:.4f} ms; "
              f"plain {v['plain_ms']:.4f} ms; cuDNN nn.LSTM fp32 "
              f"{v['library_ms']:.4f} ms; bound {v['bound_ms']:.4f} ms by "
              f"{v['bound_by']} ({v['mbytes']:.1f} MB: {v['bytes_ms']:.4f} ms; "
              f"{v['gflop']:.2f} GFLOP at the {v['peak']}: {v['ops_ms']:.4f} ms), "
              f"{v['ms'] / v['bound_ms']:.1f}x its bound")
    return out


def times_ctc(t, b, c, l, tag) -> dict:
    """Per-call times of the alpha and beta kernels at one shape, their plain
    twins, bounds and the ``F.ctc_loss`` yardstick; and the whole loss,
    forward and backward through ``log_softmax``, beside the library's."""
    import torch
    import torch.nn.functional as F

    _, _, ctc_ops = port_ops()
    log_probs, labels, in_len, lab_len = ctc_inputs(t, b, c, l, seed=9, full=True)
    _, emit, skip_in, skip_out, mask, s_len = ctc_ops.prepare(
        log_probs, labels, lab_len)
    out = {
        "ctc_alpha": {
            "ms": cuda_ms(lambda: ctc_ops.ctc_alpha_cuda(
                emit, skip_in, mask, in_len), reps=20),
            "plain_ms": cuda_ms(lambda: ctc_ops.ctc_alpha_plain(
                emit, skip_in, mask, in_len), reps=5),
            **ctc_bound(emit)},
        "ctc_beta": {
            "ms": cuda_ms(lambda: ctc_ops.ctc_beta_cuda(
                emit, skip_out, mask, in_len, s_len), reps=20),
            "plain_ms": cuda_ms(lambda: ctc_ops.ctc_beta_plain(
                emit, skip_out, mask, in_len, s_len), reps=5),
            **ctc_bound(emit)},
    }
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

    ours_ms = cuda_ms(lambda: whole(lambda lp: ctc_ops.ctc_loss(
        lp, labels, in_len, lab_len, reduction="sum")), reps=10)
    lib_ms = cuda_ms(lambda: whole(lib_loss), reps=10)
    for k, v in out.items():
        print(f"  {k}, {tag} T'={t} B={b} S={2 * l + 1}: {v['ms']:.4f} ms; plain "
              f"{v['plain_ms']:.4f} ms; F.ctc_loss "
              f"{'forward' if k == 'ctc_alpha' else 'backward'} "
              f"{v['library_ms']:.4f} ms; bound {v['bound_ms']:.5f} ms "
              f"({v['bound_by']}: {v['mbytes']:.2f} MB)")
    print(f"  whole CTC loss, forward and backward through log_softmax, {tag}: "
          f"port {ours_ms:.4f} ms, F.ctc_loss {lib_ms:.4f} ms")
    out["ctc_alpha"]["loss_fwd_bwd_ms"] = ours_ms
    out["ctc_alpha"]["library_loss_fwd_bwd_ms"] = lib_ms
    return out


def print_breakdown(what: str, ms: float, busy_us: float, by_kernel, top: int):
    if not by_kernel:
        print("  torch.profiler saw no device time: breakdown not measured")
        return
    print(f"  {what} by device kernel (torch.profiler, one call, "
          f"{busy_us / 1e3:.4f} ms of kernels in all, "
          f"{100 * busy_us / 1e3 / ms:.1f}% of the timed span):")
    for name, us in by_kernel[:top]:
        print(f"    {us / 1e3:9.4f} ms {100 * us / busy_us:5.1f}%  {name[:90]}")


def times_model(spec, model, b, t, l, tag) -> dict:
    """The decode forward and the whole train step at one batch shape, CUDA
    events, with the device time by kernel."""
    import torch

    from ctc_pytorch_tpu_torch.config import load_config
    from ctc_pytorch_tpu_torch.train.loop import train_step
    from ctc_pytorch_tpu_torch.train.state import create_train_state

    x = torch.randn(b, t, spec.rnn_input_size, device="cuda")
    frac = torch.ones(b, device="cuda")
    model = model.cuda().eval()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x, frac=frac), reps=10)
        fwd_busy, fwd_rows = device_breakdown(lambda: model(x, frac=frac))
    print(f"  flagship decode forward, {tag} B={b} T={t} bf16: {fwd_ms:.4f} ms")
    print_breakdown("forward", fwd_ms, fwd_busy, fwd_rows, top=8)

    cfg = load_config(RECIPE)
    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, seed=cfg.seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, labels, _, lab_len = ctc_inputs(2, b, spec.num_class, l, seed=11, full=True)
    mask = torch.ones(b, device="cuda")

    def step():
        train_step(state, spec, x, frac, labels, lab_len, mask, gen)

    step_ms = cuda_ms(step, reps=10)
    step_busy, step_rows = device_breakdown(step)
    print(f"  flagship train step, {tag} B={b} T={t} L={l} bf16, dropout "
          f"{spec.drop_out}: {step_ms:.4f} ms ({1e3 * b / step_ms:.1f} utts/s)")
    print_breakdown("train step", step_ms, step_busy, step_rows, top=12)
    return {"forward_ms": fwd_ms, "train_step_ms": step_ms,
            "train_step_device_ms": step_busy / 1e3}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    from ctc_pytorch_tpu_torch.ops._build import build_all

    lstm_ops, train_ops, ctc_ops = port_ops()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1/6] device: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    libraries = [lstm_ops.LIBRARY, train_ops.LIBRARY, ctc_ops.LIBRARY]
    build_all(libraries)
    print(f"[2/6] build: {', '.join(lib.source.name for lib in libraries)} for "
          f"sm_90a, one nvcc each, in {time.perf_counter() - t0:.2f} s")
    for lib in libraries:
        lib.load()
        if not lib.build_log:
            print(f"  ptxas {lib.source.name}: cached build, no ptxas output")
        for ln in lib.build_log.splitlines():
            if "registers" in ln or "smem" in ln or "spill" in ln:
                print(f"  ptxas {lib.source.name}:", ln.strip())

    print("[3/6] kernel vs plain on the card")
    errs_eval = phase_lstm_eval_vs_plain()
    errs_train = phase_lstm_train_vs_plain()
    errs_ctc = phase_ctc_vs_plain()

    print("[4/6] decode slice: flagship stage-4 greedy decode")
    decode_launches, spec, model = phase_decode_slice()

    print("[5/6] training slice: flagship stage-2 trainer, one epoch")
    train_counts = phase_train_slice(spec)

    print(f"[6/6] times ({smi})")
    bench = {**times_lstm(80, 128, 384, torch.bfloat16, "bench shape"),
             **times_ctc(80, 128, spec.num_class, 48, "bench shape")}
    recipe = {**times_lstm(100, 8, 384, torch.float32, "recipe batch"),
              **times_ctc(100, 8, spec.num_class, 33, "recipe batch")}
    model_bench = times_model(spec, model, 128, 160, 48, "bench shape")
    model_recipe = times_model(spec, model, 8, 200, 33, "recipe batch")

    csrc = "ctc_pytorch_tpu_torch/csrc/"
    tpu = "ctc_pytorch_tpu/ops/"
    rows = [
        ("lstm_bidir", csrc + "lstm_bidir.cu",
         tpu + "lstm_pallas_v2.py:142 lstm_bidir_pallas_v2",
         decode_launches, errs_eval["fp32"], errs_eval["bf16"]),
        ("lstm_bidir_train_fwd", csrc + "lstm_bidir_train.cu",
         tpu + "lstm_pallas_train_v2.py:438 _fwd_pallas (lstm_scan_train_v2)",
         train_counts["lstm_bidir_train_fwd"], errs_train["fwd"]["fp32"],
         errs_train["fwd"]["bf16"]),
        ("lstm_bidir_train_bwd", csrc + "lstm_bidir_train.cu",
         tpu + "lstm_pallas_train_v2.py:478 _bwd_pallas (lstm_scan_train_v2)",
         train_counts["lstm_bidir_train_bwd"], errs_train["bwd"]["fp32"],
         errs_train["bwd"]["bf16"]),
        ("ctc_alpha", csrc + "ctc_dp.cu",
         tpu + "ctc_pallas.py:132 ctc_alpha_pallas",
         train_counts["ctc_alpha"], errs_ctc["alpha"], None),
        ("ctc_beta", csrc + "ctc_dp.cu",
         tpu + "ctc_pallas.py:154 ctc_beta_pallas",
         train_counts["ctc_beta"], errs_ctc["beta"], None),
    ]
    kernels = []
    for name, source, replaces, launches, err, err_bf16 in rows:
        check(launches > 0, f"the main path never launched {name}")
        at_bench, at_recipe = bench[name], recipe[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches,
                 "max_abs_err": err,
                 **{k: at_bench[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
                 "ms_recipe_batch": at_recipe["ms"],
                 "plain_ms_recipe_batch": at_recipe["plain_ms"],
                 "bound_ms_recipe_batch": at_recipe["bound_ms"],
                 "library_ms_recipe_batch": at_recipe["library_ms"]}
        if err_bf16 is not None:
            entry["max_abs_err_bf16"] = err_bf16
        kernels.append(entry)
    kernels[0].update(forward_ms=model_bench["forward_ms"],
                      forward_ms_recipe_batch=model_recipe["forward_ms"])
    kernels[1].update(train_step_ms=model_bench["train_step_ms"],
                      train_step_ms_recipe_batch=model_recipe["train_step_ms"])
    print(json.dumps({"kernels": kernels}))
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
