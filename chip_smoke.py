#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ctc_pytorch_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each a
printed line; any failure ends the run with a nonzero exit and no result:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel of the path from ``csrc/`` with nvcc;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the decode shapes and at edge shapes, with stated tolerances;
4. slice: stage 4 of the flagship TIMIT recipe at full width
   (CNN + 4 x BiLSTM(384), bf16) on a synthetic TIMIT-layout test set,
   with random weights from a seed, through ``cli.test.evaluate``; checks
   that every BiLSTM layer went through the kernel and that, in fp32, the
   kernel path and the plain path decode identical strings and PER;
5. times at the decode bench shape (B=128, T=160 -> T'=80) and the
   forward at the recipe's batch (B=8, T=200), CUDA events, median of
   repeated runs, with the forward's device time by kernel.

It prints one JSON line of per-kernel results, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
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
FP32_FLOP_PER_S = 67e12

FP32_TOL = 1e-4  # same math, other summation order
BF16_TOL = 2e-2  # both round h to bf16 at the same point: a few bf16 ulps
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
    import torch

    gen = torch.Generator().manual_seed(seed)
    gx = torch.randn(t, b, 8 * h, generator=gen).to(dtype).cuda()
    bound = h ** -0.5
    w_hh = (torch.rand(2, h, 4 * h, generator=gen) * 2 - 1) * bound
    return gx, w_hh.cuda()


def phase_kernel_vs_plain(lstm_ops) -> dict:
    """Kernel against its plain twin; returns the worst error per dtype."""
    import torch

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
        gx, w_hh = lstm_inputs(t, b, h, dt, seed=100 + i)
        got = lstm_ops.lstm_bidir_cuda(gx, w_hh)
        want = lstm_ops.lstm_bidir_plain(gx, w_hh)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        name = "bf16" if dt == torch.bfloat16 else "fp32"
        print(f"  lstm_bidir T={t} B={b} H={h} {name}: max_abs_err={err:.3g} "
              f"(tol {tol})")
        check(torch.isfinite(got.float()).all().item(), "non-finite kernel output")
        check(err <= tol, f"kernel disagrees with plain at T={t} B={b} H={h}")
        worst[dt] = max(worst[dt], err)
    return {"fp32": worst[torch.float32], "bf16": worst[torch.bfloat16]}


def write_corpus(root: Path, n_utts: int = 64, seed: int = 0) -> None:
    """Synthetic TIMIT-layout test set: 81-d fbank-like ark/scp, phn_text
    and a 39-phone units file."""
    import numpy as np

    from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter

    rng = np.random.RandomState(seed)
    test = root / "test"
    test.mkdir(parents=True, exist_ok=True)
    (root / "units").write_text("".join(p + "\n" for p in PHONES))
    lines = []
    with ArkWriter(test / "fbank.ark", test / "fbank.scp") as w:
        for i in range(n_utts):
            utt = f"spk{i % 8}_si{i:03d}"
            frames = int(rng.randint(150, 401))
            feat = rng.randn(frames, 81).astype(np.float32)
            w.write(utt, feat)
            n_ph = max(1, frames // 12)
            lines.append(utt + " " + " ".join(rng.choice(PHONES, n_ph)))
    (test / "phn_text").write_text("\n".join(lines) + "\n")


def phase_slice(lstm_ops):
    """Stage 4 of the flagship recipe through the port's entry points."""
    import torch

    from ctc_pytorch_tpu_torch.cli.test import evaluate
    from ctc_pytorch_tpu_torch.config import load_config
    from ctc_pytorch_tpu_torch.models import CTCModel, ModelSpec
    from ctc_pytorch_tpu_torch.train.checkpoint import save_package
    from ctc_pytorch_tpu_torch.vocab import Vocab

    write_corpus(WORK / "data")
    cfg = load_config(RECIPE)
    cfg.vocab_file = str(WORK / "data" / "units")
    cfg.test_scp_path = str(WORK / "data" / "test" / "fbank.scp")
    cfg.test_lab_path = str(WORK / "data" / "test" / "phn_text")
    cfg.checkpoint_dir = str(WORK / "checkpoint")
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

    lstm_ops.launches = 0
    res, decoded, lines = run(pkg_bf16)
    launches = lstm_ops.launches
    print(f"  bf16 flagship decode: {res['batches']} batches, "
          f"{len(decoded)} utts, CER {res['cer']:.4f} WER {res['wer']:.4f}, "
          f"wall {res['wall_s']:.3f} s (first call, includes data load)")
    print("  " + lines[-1])
    check(len(decoded) == 64, f"decoded {len(decoded)} of 64 utterances")
    check(launches == 4 * res["batches"],
          f"kernel launches {launches} != 4 x {res['batches']} batches")

    lstm_ops.launches = 0
    res32, dec32, _ = run(pkg_fp32)
    check(lstm_ops.launches == 4 * res32["batches"],
          f"fp32 run: launches {lstm_ops.launches} != 4 x batches")
    kernel_fn = lstm_ops.lstm_bidir
    lstm_ops.lstm_bidir = lambda gx, w: lstm_ops.lstm_bidir_plain(gx, w).float()
    lstm_ops.launches = 0
    try:
        res_pl, dec_pl, _ = run(pkg_fp32)
    finally:
        lstm_ops.lstm_bidir = kernel_fn
    check(lstm_ops.launches == 0, "the plain run launched the kernel")
    same = sum(a == b for a, b in zip(dec32, dec_pl))
    print(f"  fp32 kernel vs plain on the card: {same}/{len(dec32)} strings "
          f"equal, PER {res32['wer']:.4f} vs {res_pl['wer']:.4f}, "
          f"CER {res32['cer']:.4f} vs {res_pl['cer']:.4f}")
    check(dec32 == dec_pl, "fp32 kernel and plain paths decode differently")
    check(res32["wer"] == res_pl["wer"] and res32["cer"] == res_pl["cer"],
          "fp32 kernel and plain paths score differently")
    n_tok = sum(len(d.split()) - 1 for d in dec32)
    check(n_tok > 0, "every decoded string is empty")
    return launches, spec, model, res


def lstm_bound(gx, w_hh):
    """Least time the card could take for one ``lstm_bidir`` call: the larger
    of its bytes (gx and w_hh read once, ys written once) over the memory
    rate and its fp32 recurrent products over the fp32 peak."""
    t, b, _ = gx.shape
    h = w_hh.shape[1]
    es = gx.element_size()
    bytes_moved = gx.numel() * es + w_hh.numel() * 4 + t * b * 2 * h * es
    flops = 2 * t * b * h * 4 * h * 2  # (B,H)@(H,4H) per step and direction
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes > by_ops else "operations", flops, bytes_moved)


def phase_times(lstm_ops, spec, model) -> dict:
    import torch

    t, b, h = 80, 128, 384
    gx, w_hh = lstm_inputs(t, b, h, torch.bfloat16, seed=7)
    k_ms = cuda_ms(lambda: lstm_ops.lstm_bidir_cuda(gx, w_hh), reps=20)
    gx32 = gx.float()
    k32_ms = cuda_ms(lambda: lstm_ops.lstm_bidir_cuda(gx32, w_hh), reps=20)
    p_ms = cuda_ms(lambda: lstm_ops.lstm_bidir_plain(gx, w_hh), reps=5)
    gx8, w8 = lstm_inputs(100, 8, h, torch.float32, seed=8)
    k8_ms = cuda_ms(lambda: lstm_ops.lstm_bidir_cuda(gx8, w8), reps=20)

    # library yardstick: cuDNN BiLSTM, bias-free, fp32; it also computes
    # the input projection (T*B, 2H) @ (2H, 8H) that the kernel is given
    lstm = torch.nn.LSTM(2 * h, h, bias=False, bidirectional=True).cuda()
    x_lib = torch.randn(t, b, 2 * h, device="cuda")
    with torch.no_grad():
        lib_ms = cuda_ms(lambda: lstm(x_lib), reps=20)

    bound_ms, bound_by, flops, bytes_moved = lstm_bound(gx, w_hh)
    bound8_ms, bound8_by, _, _ = lstm_bound(gx8, w8)

    model = model.cuda().eval()
    fwd = {}
    for fb, ft in ((b, 2 * t), (8, 200)):  # bench shape; the recipe's batch
        x = torch.randn(fb, ft, spec.rnn_input_size, device="cuda")
        frac = torch.ones(fb, device="cuda")
        with torch.inference_mode():
            fwd[fb] = (cuda_ms(lambda: model(x, frac=frac), reps=10),
                       *device_breakdown(lambda: model(x, frac=frac)))
    print(f"  lstm_bidir kernel, T'={t} B={b} H={h} bf16 streams: "
          f"{k_ms:.4f} ms/layer (fp32 streams {k32_ms:.4f} ms; "
          f"recipe batch T'=100 B=8 fp32 {k8_ms:.4f} ms, bound "
          f"{bound8_ms:.4f} ms by {bound8_by})")
    print(f"  plain version {p_ms:.4f} ms, cuDNN nn.LSTM fp32 {lib_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{bytes_moved / 1e6:.1f} MB)")
    for fb, ft in ((b, 2 * t), (8, 200)):
        fwd_ms, busy_us, by_kernel = fwd[fb]
        print(f"  flagship decode forward, B={fb} T={ft} bf16: {fwd_ms:.4f} ms")
        if not by_kernel:
            print("  torch.profiler saw no device time: breakdown not measured")
            continue
        print(f"  forward by device kernel (torch.profiler, one forward, "
              f"{busy_us / 1e3:.4f} ms of kernels in all, "
              f"{100 * busy_us / 1e3 / fwd_ms:.1f}% of the timed forward):")
        for name, us in by_kernel[:8]:
            print(f"    {us / 1e3:9.4f} ms {100 * us / busy_us:5.1f}%  {name[:90]}")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ms_fp32_streams": k32_ms, "ms_recipe_batch": k8_ms,
            "bound_ms_recipe_batch": bound8_ms,
            "forward_ms": fwd[b][0], "forward_ms_recipe_batch": fwd[8][0]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1/5] device: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    lstm_ops.build()
    print(f"[2/5] build: lstm_bidir.cu for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s")
    for ln in lstm_ops.build_log.splitlines():
        if "registers" in ln or "smem" in ln or "spill" in ln:
            print("  ptxas:", ln.strip())

    print("[3/5] kernel vs plain on the card")
    errs = phase_kernel_vs_plain(lstm_ops)

    print("[4/5] slice: flagship stage-4 greedy decode")
    launches, spec, model, _ = phase_slice(lstm_ops)

    print(f"[5/5] times ({smi})")
    times = phase_times(lstm_ops, spec, model)

    kernels = [{
        "name": "lstm_bidir",
        "route": "cuda",
        "source": "ctc_pytorch_tpu_torch/csrc/lstm_bidir.cu",
        "replaces": "ctc_pytorch_tpu/ops/lstm_pallas_v2.py:142 "
                    "lstm_bidir_pallas_v2",
        "launches": launches,
        "max_abs_err": errs["fp32"],
        "max_abs_err_bf16": errs["bf16"],
        **times,
    }]
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
