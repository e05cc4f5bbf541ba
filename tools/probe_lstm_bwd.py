#!/usr/bin/env python3
"""Time the LSTM training kernels of one source tree of the port on the
card, with ``chip_smoke.py``'s timers, so that a change and its parent can
be compared in one run:

    python3 tools/probe_lstm_bwd.py --root <tree> --label <name>

imports ``ctc_pytorch_tpu_torch`` from ``<tree>`` (its kernels build into its
own ``csrc/build/``) and the timers, inputs and recipes from the
``chip_smoke.py`` beside this tool.  At the fp32 shapes of the main paths
(the flagship's batch of 8, ``mfcc_39``'s longest batch, a data-parallel
rank's 4) and at the bench shape in fp32 and bf16 it times the training
forward, the backward's pre-pass, its serial kernel (on the pre-pass's
planes) and the whole backward, each with the branch it took; then the
flagship's B=8 train step and ``mfcc_39``'s (T'=400) with their device time
by kernel.  Every tree is driven through the ops' ``*_cuda`` entry points,
which they share.  Prints one JSON line last and writes it to
``chiprun_out/probe_lstm_bwd_<label>.json``.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from probe_ctc_loss import load_chip_smoke  # this tool's chip_smoke.py

SHAPES = [  # (T', B, H, stream dtype, tag)
    (100, 8, 384, "fp32", "recipe"),
    (400, 8, 256, "fp32", "mfcc39"),
    (100, 4, 384, "fp32", "dp_rank"),
    (80, 128, 384, "fp32", "bench_fp32"),
    (80, 128, 384, "bf16", "bench"),
]


def timed_branch(cs, fn, counts: dict, reps: int) -> tuple:
    """``(ms a call, the branch the calls took)``."""
    before = dict(counts)
    ms = cs.cuda_ms(fn, reps=reps)
    return ms, "+".join(k for k, v in counts.items() if v != before[k])


def times_at(cs, ops, t, b, h, name) -> dict:
    import torch

    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    gx, w_hh, dy = cs.recurrence_inputs(t, b, h, dtype, seed=7)
    ys, c_s = ops.lstm_bidir_train_cuda(gx, w_hh)
    planes = ops.lstm_bidir_train_bwd_prepass_cuda(gx, w_hh, ys, c_s)
    out = {}
    out["fwd_ms"], out["fwd_branch"] = timed_branch(
        cs, lambda: ops.lstm_bidir_train_cuda(gx, w_hh),
        ops.launches_fwd_branch, 20)
    out["prepass_ms"] = cs.cuda_ms(
        lambda: ops.lstm_bidir_train_bwd_prepass_cuda(gx, w_hh, ys, c_s),
        reps=20)
    out["serial_ms"], out["bwd_branch"] = timed_branch(
        cs, lambda: ops.lstm_bidir_train_bwd_serial_cuda(planes, w_hh, dy),
        ops.launches_bwd_branch, 20)
    out["bwd_ms"] = cs.cuda_ms(
        lambda: ops.lstm_bidir_train_backward_cuda(gx, w_hh, ys, c_s, dy),
        reps=20)
    out["serial_us_a_step"] = 1e3 * out["serial_ms"] / t
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, type=Path)
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("probe_lstm_bwd: needs a GPU", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from ctc_pytorch_tpu_torch.config import load_config
    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as ops

    assert Path(ops.__file__).resolve().is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_line()
    result = {"label": args.label, "card": smi, "shapes": {}}
    for t, b, h, name, tag in SHAPES:
        at = times_at(cs, ops, t, b, h, name)
        result["shapes"][tag] = at
        print(f"{args.label} {tag} T'={t} B={b} H={h} {name}: forward "
              f"{at['fwd_ms']:.4f} ms ({at['fwd_branch']}); backward "
              f"{at['bwd_ms']:.4f} ms = pre-pass {at['prepass_ms']:.4f} + "
              f"serial {at['serial_ms']:.4f} ({at['bwd_branch']}, "
              f"{at['serial_us_a_step']:.2f} us a step)", flush=True)
    for key, recipe, t in (("flagship_b8_step", cs.RECIPE, 200),
                           ("mfcc39_step", cs.RECIPE_MFCC, 400)):
        cfg = load_config(recipe)
        spec = ModelSpec.from_config(cfg, num_class=41)
        step = cs.times_model(cfg, spec, cs.seeded_model(spec), 8, t, 33,
                              key, "probe")
        result[key] = {"train_step_ms": step["train_step_ms"],
                       "train_step_device_ms": step["train_step_device_ms"],
                       "top_kernels": [[n[:80], us] for n, us
                                       in step["train_step_rows"][:6]]}
        print(f"{args.label} {key}: {step['train_step_ms']:.4f} ms wall, "
              f"{step['train_step_device_ms']:.4f} ms of kernels ({smi})",
              flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    line = json.dumps(result)
    (out / f"probe_lstm_bwd_{args.label}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
