#!/usr/bin/env python3
"""Time the fp32 backward pre-pass (``prepass_tf32_kernel``,
``csrc/bwd_hoist.cuh``) of one source tree of the port at other CTA shapes
than the one it ships, on the card:

    python3 tools/probe_prepass_tiles.py --root <tree> --label <name> \\
        [--warps 4x2 2x2 2x1 4x1 4x2s4]

copies ``<tree>/ctc_pytorch_tpu_torch`` once a shape into the git-ignored
``.chip_tree/prepass_tiles/<shape>/`` beside this tool, with ``kTfWarpsM``
and ``kTfWarpsU`` of its ``csrc/bwd_hoist.cuh`` set to the shape (a warp
keeps 32 rows and 16 units: 4x2 is the shipped 128 x 32 tile, 2x2 64 x 32,
2x1 64 x 16, 4x1 128 x 16) and, after an ``s``, ``kTfStages`` to the ring
slots that follow it (4x2s4: the shipped tile with four slots), builds
the copies' LSTM and GRU training libraries in parallel, then, one
process a shape, in the order given and back again, times the pre-pass at ``chip_smoke.PREPASS_TIMES`` per call
(``cuda_ms``) and on the device alone (``graph_ms``), and holds its planes
against the twin at 1e-4.  The timers, inputs and shapes come from the
``chip_smoke.py`` beside this tool.  Prints one JSON line last and writes
it to ``chiprun_out/probe_prepass_tiles_<label>.json``.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from probe_ctc_loss import load_chip_smoke  # this tool's chip_smoke.py

HERE = Path(__file__).resolve()
TILES = HERE.parents[1] / ".chip_tree" / "prepass_tiles"


def tiled_copy(root: Path, spec: str) -> Path:
    """``root``'s package with the pre-pass CTA of ``spec`` ("MxU" warps,
    "MxUsS" with S ring slots)."""
    shape, _, slots = spec.partition("s")
    wm, wu = (int(x) for x in shape.split("x"))
    dest = TILES / spec
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(root / "ctc_pytorch_tpu_torch",
                    dest / "ctc_pytorch_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    header = dest / "ctc_pytorch_tpu_torch" / "csrc" / "bwd_hoist.cuh"
    text = header.read_text()
    for name, value in (("kTfWarpsM", wm), ("kTfWarpsU", wu),
                        *((("kTfStages", int(slots)),) if slots else ())):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{header}: no single {name}")
    header.write_text(text)
    return dest


def child(dest: Path, build: bool) -> int:
    """Build or time the copy at ``dest`` (one process a copy: each imports
    its own ``ctc_pytorch_tpu_torch``)."""
    sys.path.insert(0, str(dest))
    import torch

    cs = load_chip_smoke()
    from ctc_pytorch_tpu_torch.ops import gru_bidir, gru_bidir_train
    from ctc_pytorch_tpu_torch.ops import lstm_bidir_train
    from ctc_pytorch_tpu_torch.ops._build import build_all

    assert Path(lstm_bidir_train.__file__).resolve().is_relative_to(dest)
    if build:
        build_all([lstm_bidir_train.LIBRARY, gru_bidir_train.LIBRARY])
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for cell, t, b, h in cs.PREPASS_TIMES:
        lstm = cell == "lstm"
        mod = lstm_bidir_train if lstm else gru_bidir_train
        gx, w, _ = cs.recurrence_inputs(t, b, h, torch.float32, seed=7,
                                        gates=4 if lstm else 3)
        saved = (lstm_bidir_train.lstm_bidir_train_cuda(gx, w) if lstm
                 else (gru_bidir.gru_bidir_cuda(gx, w),))
        kernel = getattr(mod, f"{cell}_bidir_train_bwd_prepass_cuda")
        plain = getattr(mod, f"{cell}_bidir_train_bwd_prepass_plain")
        err = cs.max_err(kernel(gx, w, *saved), plain(gx, w, *saved))
        cs.check(err <= cs.FP32_TOL, f"{dest.name}: the planes differ by {err}")
        out[f"{cell}_{t}_{b}_{h}"] = {
            "ms": cs.turns({"k": lambda: kernel(gx, w, *saved)}, reps=20)["k"][0],
            "device_ms": [cs.graph_ms(lambda: kernel(gx, w, *saved))
                          for _ in range(2)],
            "max_abs_err": err}
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path)
    ap.add_argument("--label")
    ap.add_argument("--warps", nargs="+",
                    default=["4x2", "2x2", "2x1", "4x1", "4x2s4"])
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.build)
    if args.root is None or args.label is None:
        ap.error("--root and --label are required")
    cs = load_chip_smoke()
    smi = cs.smi_line()
    dests = {spec: tiled_copy(args.root.resolve(), spec) for spec in args.warps}
    builds = [subprocess.Popen([sys.executable, str(HERE), "--child", str(d),
                                "--build"]) for d in dests.values()]
    if any([p.wait() != 0 for p in builds]):  # every build reaped
        raise RuntimeError("a tiled copy did not build")
    result = {"label": args.label, "card": smi, "runs": []}
    for spec in args.warps + args.warps[::-1]:
        line = subprocess.run(
            [sys.executable, str(HERE), "--child", str(dests[spec])],
            check=True, capture_output=True, text=True).stdout.splitlines()[-1]
        times = json.loads(line)
        result["runs"].append({"warps": spec, "times": times})
        print(f"{args.label} pre-pass CTA of {spec} warps ({smi}): " + "; ".join(
            f"{k} {v['ms']:.4f} ms, device {min(v['device_ms']):.4f}"
            for k, v in times.items()), flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    line = json.dumps(result)
    (out / f"probe_prepass_tiles_{args.label}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
