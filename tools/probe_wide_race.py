#!/usr/bin/env python3
"""Look for reads before writes in the wide-batch forward
(``csrc/fwd_wide.cuh``, branch ``wide_fp32``) of one source tree of the port
on the card:

    python3 tools/probe_wide_race.py --root <tree> --label <name> [--launches N]

imports ``ctc_pytorch_tpu_torch`` from ``<tree>`` (its kernels build into its
own ``csrc/build/``) and the inputs, twins and recipes from the
``chip_smoke.py`` beside this tool.

1. The SASS of the wide kernels (``cuobjdump``) into
   ``chiprun_out/wide_sass_<label>.txt``, where the order of the exchange
   loads and the flag loads can be read.
2. The 863 GRU model's fp32 decode forward at B = 128, T = 200 (phase 16 of
   ``chip_smoke.py``, ``decode_b128``) from features at 0.05 and at unit
   scale over seeds, through the kernels and through the twins: each
   side's finiteness, the log-probs' error, and for every GRU layer the
   largest |gx| and the kernel's error against the twin on the same gx.
3. At each shape of ``SHAPES`` (the LSTM eval forward on both stream
   dtypes, the LSTM training forward and the GRU forward, B = 64 to 130),
   for each gate-input scale of ``SCALES`` (0.05, unit, and one that
   saturates every gate) and seed, ``N`` launches of the library's forward
   entry under a NaN-filled exchange buffer (``chip_smoke.py``'s
   ``wide_nan_launches``): the launches whose output holds a non-finite
   value or differs in any bit from the first are counted.

Prints one JSON line last and writes it to
``chiprun_out/probe_wide_race_<label>.json``.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

from probe_ctc_loss import load_chip_smoke  # this tool's chip_smoke.py

SHAPES = [  # (op, T', B, H, stream dtype)
    ("lstm_eval", 200, 128, 384, "fp32"), ("lstm_eval", 200, 128, 384, "bf16"),
    ("lstm_eval", 80, 64, 384, "fp32"), ("lstm_eval", 95, 100, 384, "fp32"),
    ("lstm_train", 80, 128, 384, "fp32"), ("gru", 95, 128, 256, "fp32"),
    ("gru", 95, 130, 256, "fp32"),
]
SCALES = (0.05, 1.0, 30.0)
SEEDS = (0, 1, 2)


def decode_863(cs, scale: float, seed: int) -> dict:
    """Phase 16's 863 GRU fp32 decode forward at B = 128 (``decode_b128``)
    with each GRU layer's kernel output held against the twin on the same
    gx, and that gx's largest magnitude."""
    import torch

    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops

    cfg = cs.recipe_config_863()
    spec = dataclasses.replace(
        ModelSpec.from_config(cfg, num_class=cfg.num_class + 1),
        compute_dtype="float32", drop_out=0.0)
    layers = []
    kernel = gru_ops.gru_bidir_cuda

    def recorded(gx, w_hh):
        ys = kernel(gx, w_hh)
        twin = gru_ops.gru_bidir_plain(gx, w_hh)
        layers.append({
            "gx_max_abs": float(gx.float().abs().max()),
            "nonfinite_kernel": int((~torch.isfinite(ys)).sum()),
            "nonfinite_twin": int((~torch.isfinite(twin)).sum()),
            "max_abs_err": cs.max_err(ys, twin)})
        return ys

    gru_ops.gru_bidir_cuda = recorded
    try:
        out = cs.decode_b128(spec, scale, seed, "cuda")
    finally:
        gru_ops.gru_bidir_cuda = kernel
    out["layers"] = layers
    return out


def dump_sass(label: str, libs, out: Path) -> str:
    """The SASS of every function named fwd_wide_kernel in ``libs``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    parts = []
    for lib in libs:
        text = subprocess.run([tool, "-sass", str(lib.build())], check=True,
                              capture_output=True, text=True).stdout
        keep = False
        for line in text.splitlines():
            if "Function :" in line:
                keep = "fwd_wide_kernel" in line
            if keep:
                parts.append(line)
    path = out / f"wide_sass_{label}.txt"
    path.write_text("\n".join(parts) + "\n")
    return str(path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, type=Path)
    ap.add_argument("--label", required=True)
    ap.add_argument("--launches", type=int, default=200)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("probe_wide_race: needs a GPU", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from ctc_pytorch_tpu_torch.ops import _build
    from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
    from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
    from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as train_ops

    assert Path(lstm_ops.__file__).resolve().is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = [lstm_ops.LIBRARY, train_ops.LIBRARY, gru_ops.LIBRARY]
    _build.build_all(libs)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    result = {"label": args.label, "card": cs.smi_line(), "stress": [],
              "decode_863": []}
    try:
        result["sass"] = dump_sass(args.label, libs, out)
    except (OSError, subprocess.CalledProcessError) as e:
        result["sass"] = f"not dumped: {e}"
    for scale in (0.05, 1.0):
        for seed in range(8 if scale == 1.0 else 4):
            r = decode_863(cs, scale, seed)
            result["decode_863"].append(r)
            print(f"{args.label} 863 decode B=128 scale {scale} seed {seed}: "
                  f"finite {r['finite_kernels']} (kernels) "
                  f"{r['finite_twins']} (twins); max_abs_err "
                  f"{r['max_abs_err']:.3g}; layers "
                  + "; ".join(f"|gx| {x['gx_max_abs']:.3g} err "
                              f"{x['max_abs_err']:.3g} nonfinite "
                              f"{x['nonfinite_kernel']}/{x['nonfinite_twin']}"
                              for x in r["layers"]), flush=True)
    for op, t, b, h, name in SHAPES:
        for scale in SCALES:
            for seed in SEEDS:
                r = cs.wide_nan_launches(op, t, b, h, name, scale, seed,
                                         args.launches)
                result["stress"].append(r)
                print(f"{args.label} {op} ({t}, {b}, {h}) {name} scale {scale}"
                      f" seed {seed}: {r['nonfinite_launches']} non-finite and "
                      f"{r['differing_launches']} differing of {r['launches']}"
                      f" launches; first vs twin {r['twin_max_abs_err']:.3g}",
                      flush=True)
    result["total_nonfinite"] = sum(r["nonfinite_launches"]
                                    for r in result["stress"])
    result["total_differing"] = sum(r["differing_launches"]
                                    for r in result["stress"])
    line = json.dumps(result)
    (out / f"probe_wide_race_{args.label}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
