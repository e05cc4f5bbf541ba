#!/usr/bin/env python3
"""Time the fp32 recurrence backwards and train steps at the bench batch of
one source tree of the port on the card, with ``chip_smoke.py``'s timers,
so that a change and its parent can be compared in one run:

    python3 tools/probe_fp32_step.py --root <tree> --label <name>

imports ``ctc_pytorch_tpu_torch`` from ``<tree>`` (its kernels build into its
own ``csrc/build/``) and the timers, inputs and recipes from the
``chip_smoke.py`` beside this tool.  At the LSTM's (80, 128, 384) and (80,
64, 384) and the GRU's (95, 128, 256) and (95, 8, 256), fp32 streams, it
times the backward's pre-pass, its serial kernel (on the pre-pass's
planes, with the branch it took) and both; at the tanh cell's (80, 128,
384) its forward and its backward (one kernel each, with their
branches); then one fp32 train step at B=128 of the flagship (T=160,
L=48), of the 863 GRU model (T=200, L=40) and of the tanh model (the
flagship with ``rnn_type: nn.RNN``, T=160, L=48) from a seed
(``chip_smoke.dp_steps``: wall, median of 5, and device time), with the
backward kernels' branches.  Prints one JSON line last and writes it to
``chiprun_out/probe_fp32_step_<label>.json``.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

from probe_ctc_loss import load_chip_smoke  # this tool's chip_smoke.py

SHAPES = [("lstm", 80, 128, 384), ("lstm", 80, 64, 384), ("gru", 95, 128, 256),
          ("gru", 95, 8, 256), ("rnn", 80, 128, 384)]


def tanh_times(cs, t, b, h) -> dict:
    """The tanh cell's forward and backward kernels on fp32 streams, each
    with the branch it took."""
    import torch

    _, ops = cs.port_rnn_ops()
    gx, w, dy = cs.recurrence_inputs(t, b, h, torch.float32, seed=7, gates=1)
    ys = ops.rnn_bidir_train_cuda(gx, w)
    out = {}
    for key, fn, counts in (
            ("fwd", lambda: ops.rnn_bidir_train_cuda(gx, w),
             ops.launches_fwd_branch),
            ("bwd", lambda: ops.rnn_bidir_train_backward_cuda(w, ys, dy),
             ops.launches_bwd_branch)):
        before = dict(counts)
        out[f"{key}_ms"] = cs.cuda_ms(fn, reps=20)
        out[f"{key}_branch"] = "+".join(k for k, v in counts.items()
                                        if v != before[k])
        out[f"{key}_us_a_step"] = 1e3 * out[f"{key}_ms"] / t
    return out


def backward_times(cs, cell, t, b, h) -> dict:
    import torch

    if cell == "rnn":
        return tanh_times(cs, t, b, h)
    _, train_ops, _ = cs.port_ops()
    gru_ops, gru_train_ops = cs.port_gru_ops()
    lstm = cell == "lstm"
    gates, ops = (4, train_ops) if lstm else (3, gru_train_ops)
    gx, w, dy = cs.recurrence_inputs(t, b, h, torch.float32, seed=7,
                                     gates=gates)
    saved = (train_ops.lstm_bidir_train_cuda(gx, w) if lstm
             else (gru_ops.gru_bidir_cuda(gx, w),))
    fn = {k: getattr(ops, f"{cell}_bidir_train_{k}") for k in (
        "bwd_prepass_cuda", "bwd_serial_cuda", "backward_cuda")}
    planes = fn["bwd_prepass_cuda"](gx, w, *saved)
    before = dict(ops.launches_bwd_branch)
    out = {"serial_ms": cs.cuda_ms(
        lambda: fn["bwd_serial_cuda"](planes, w, dy), reps=20)}
    out["branch"] = "+".join(k for k, v in ops.launches_bwd_branch.items()
                             if v != before[k])
    out["prepass_ms"] = cs.cuda_ms(
        lambda: fn["bwd_prepass_cuda"](gx, w, *saved), reps=20)
    out["bwd_ms"] = cs.cuda_ms(
        lambda: fn["backward_cuda"](gx, w, *saved, dy), reps=20)
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
        print("probe_fp32_step: needs a GPU", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.ops import (gru_bidir_train, lstm_bidir_train,
                                           rnn_bidir_train)

    assert Path(lstm_bidir_train.__file__).resolve().is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_line()
    result = {"label": args.label, "card": smi, "backward": {}}
    for cell, t, b, h in SHAPES:
        at = backward_times(cs, cell, t, b, h)
        result["backward"][f"{cell}_{t}_{b}_{h}"] = at
        if cell == "rnn":
            print(f"{args.label} tanh fp32 T'={t} B={b} H={h}: forward "
                  f"{at['fwd_ms']:.4f} ms ({at['fwd_branch']}, "
                  f"{at['fwd_us_a_step']:.2f} us a step), backward "
                  f"{at['bwd_ms']:.4f} ms ({at['bwd_branch']}, "
                  f"{at['bwd_us_a_step']:.2f} us a step) ({smi})", flush=True)
            continue
        print(f"{args.label} {cell} fp32 backward T'={t} B={b} H={h}: "
              f"{at['bwd_ms']:.4f} ms = pre-pass {at['prepass_ms']:.4f} + "
              f"serial {at['serial_ms']:.4f} ({at['branch']}, "
              f"{at['serial_us_a_step']:.2f} us a step) ({smi})", flush=True)
    cfg, cfg_863 = cs.recipe_config(), cs.recipe_config_863()
    cfg_tanh = cs.recipe_config()
    cfg_tanh.rnn_type = "nn.RNN"
    for key, cfg_s, num_class, t, l, seed, ops in (
            ("flagship_b128_fp32_step", cfg, 62, 160, 48, 17,
             lstm_bidir_train),
            ("gru_b128_fp32_step", cfg_863, cfg_863.num_class + 1, 200, 40, 18,
             gru_bidir_train),
            ("tanh_b128_fp32_step", cfg_tanh, 62, 160, 48, 19,
             rnn_bidir_train)):
        spec = dataclasses.replace(
            ModelSpec.from_config(cfg_s, num_class=num_class),
            compute_dtype="float32", drop_out=0.0)
        batch = cs.dp_batch(spec, 128, t, l, seed=seed)
        before = dict(ops.launches_bwd_branch)
        run = cs.dp_steps(spec, cfg_s, batch, None, "cuda", steps=1,
                          times=True)
        result[key] = {
            "step_wall_ms": run["step_wall_ms"],
            "step_device_ms": run["step_device_ms"],
            "bwd_branches": {k: v - before[k] for k, v
                             in ops.launches_bwd_branch.items() if v != before[k]},
            "top_kernels": [[n[:80], us] for n, us in run["step_top_kernels"]]}
        print(f"{args.label} {key}: {run['step_wall_ms']:.4f} ms wall, "
              f"{run['step_device_ms']:.4f} ms of kernels; backwards "
              f"{result[key]['bwd_branches']} ({smi})", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    line = json.dumps(result)
    (out / f"probe_fp32_step_{args.label}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
