#!/usr/bin/env python3
"""Time the CTC loss of one source tree of the port on the card, with
``chip_smoke.py``'s timers, so that a change and its parent can be compared
in one run:

    python3 tools/probe_ctc_loss.py --root <tree> --label <name>

imports ``ctc_pytorch_tpu_torch`` from ``<tree>`` (its kernels build into its
own ``csrc/build/``) and the timers, inputs and flagship model from the
``chip_smoke.py`` beside this tool.  At phase 9's CTC shapes it times the
whole loss, forward and backward through ``log_softmax`` (wall time by CUDA
events, device time by ``torch.profiler`` with the kernels of one call by
name, the loss's own kernels among them), the loss alone on a log_probs
leaf, and ``F.ctc_loss`` the same ways; then the flagship's B=8 train step
and the loss's share of its device time.  Every tree is driven through
``ctc_loss``, the entry point they share.  Prints one JSON line last and
writes it to ``chiprun_out/probe_ctc_<label>.json``.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import sys
from pathlib import Path

SHAPES = [  # (T', B, classes, L, tag): chip_smoke.py's times_ctc calls
    (80, 128, 41, 48, "timit_bench"),
    (100, 8, 41, 33, "timit_recipe"),
    (95, 128, 67, 40, "863_bench"),
    (95, 16, 67, 40, "863_recipe"),
    (400, 8, 41, 33, "mfcc39"),
]


def load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def times_at(cs, ctc_ops, t, b, c, l) -> dict:
    import torch
    import torch.nn.functional as F

    lp, lab, il, ll = cs.ctc_inputs(t, b, c, l, seed=9, full=True)
    lab64, il64, ll64 = (x.long() for x in (lab, il, ll))
    logits = torch.randn(t, b, c, device="cuda", requires_grad=True)
    leaf = lp.clone().requires_grad_(True)
    losses = {
        "port": lambda x: ctc_ops.ctc_loss(x, lab, il, ll, reduction="sum"),
        "F.ctc_loss": lambda x: F.ctc_loss(x, lab64, il64, ll64,
                                           reduction="sum")}
    out = {}
    for who, loss in losses.items():
        def whole():
            logits.grad = None
            loss(torch.log_softmax(logits, -1)).backward()

        def alone():
            leaf.grad = None
            loss(leaf).backward()

        dev_us, rows = cs.device_breakdown(whole)
        alone_us, _ = cs.device_breakdown(alone)
        out[who] = {"loss_fwd_bwd_ms": cs.cuda_ms(whole, reps=10),
                    "loss_fwd_bwd_device_ms": dev_us / 1e3,
                    "loss_alone_device_ms": alone_us / 1e3,
                    "kernels_of_one_call": [[n[:100], us] for n, us in rows]}
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
        print("probe_ctc_loss: needs a GPU", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from ctc_pytorch_tpu_torch.config import load_config
    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.ops import ctc_loss as ctc_ops

    assert Path(ctc_ops.__file__).resolve().is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_line()
    result = {"label": args.label, "card": smi, "shapes": {}}
    for t, b, c, l, tag in SHAPES:
        at = times_at(cs, ctc_ops, t, b, c, l)
        result["shapes"][tag] = at
        own = [f"{re.search(r'ctc_\w+', n).group()} {us:.2f} us"
               for n, us in at["port"]["kernels_of_one_call"] if "ctc_" in n]
        print(f"{args.label} {tag} T'={t} B={b} C={c} S={2 * l + 1}: whole "
              f"loss port {at['port']['loss_fwd_bwd_ms']:.4f} ms wall "
              f"{at['port']['loss_fwd_bwd_device_ms']:.4f} device in "
              f"{len(at['port']['kernels_of_one_call'])} kernel names "
              f"({'; '.join(own)}), F.ctc_loss "
              f"{at['F.ctc_loss']['loss_fwd_bwd_ms']:.4f} wall "
              f"{at['F.ctc_loss']['loss_fwd_bwd_device_ms']:.4f} device; loss "
              f"alone {at['port']['loss_alone_device_ms']:.4f} device",
              flush=True)
    cfg = load_config(cs.RECIPE)
    spec = ModelSpec.from_config(cfg, num_class=41)
    step = cs.times_model(cfg, spec, cs.seeded_model(spec), 8, 200, 33,
                          "flagship", "probe")
    alone = result["shapes"]["timit_recipe"]["port"]["loss_alone_device_ms"]
    result["flagship_b8_step"] = {
        "train_step_ms": step["train_step_ms"],
        "train_step_device_ms": step["train_step_device_ms"],
        "loss_share": alone / step["train_step_device_ms"]}
    print(f"{args.label} flagship B=8 train step: {step['train_step_ms']:.4f} "
          f"ms wall, {step['train_step_device_ms']:.4f} ms device; the CTC "
          f"loss alone {alone:.4f} ms = "
          f"{100 * alone / step['train_step_device_ms']:.2f}% of the device "
          f"step ({smi})", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    line = json.dumps(result)
    (out / f"probe_ctc_{args.label}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
