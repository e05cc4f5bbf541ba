"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 gpubench/calibrate.py --workload <cell> --seeds <n> [<n> ...]

For each seed, at the cell's own size: the program set up as a run sets it
up, and its numbers against the reference (the sound readings); the
reference computed in float8 (e4m3) products in the program's place (the
control, one precision below the configuration's bf16); and the faults a
cell of its kind can have, planted in what the program produced or in the
reference in its place: half of each batch left out of the loss (training)
and one token of every hypothesis altered (decoding).  A state left
unchanged is read too, though it reads 1 by the leaf numbers.  One JSON line
a seed on standard output; the benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def altered(one_pass: list, n_class: int) -> list:
    """A pass with each hypothesis's first token moved to the next unit (0
    and 1 are the blank and the unknown unit)."""
    out = []
    for tokens, lens in one_pass:
        tokens = tokens.copy()
        first = tokens[..., 0]
        tokens[..., 0] = (first - 2 + 1) % (n_class - 2) + 2
        tokens[..., 0][lens == 0] = first[lens == 0]
        out.append((tokens, lens))
    return out


def control_pass(groups, corpus, l_pad, arch, weights, device,
                 quant: str) -> list:
    """The greedy decode of every batch by the reference in ``quant``."""
    import numpy as np
    import torch

    from gpubench import traffic
    from gpubench.reference.decode import greedy_hypotheses
    from gpubench.reference.model import QUANT, forward

    w = {k: v.to(device) for k, v in weights.items()}
    out = []
    with torch.no_grad():
        for _, pos, _, t_pad, idx in groups:
            n, b = pos.shape
            tokens = lens = None
            for bi in range(n):
                feats, frames, _, _ = traffic.batch_arrays(corpus, idx[bi],
                                                           t_pad, l_pad)
                lp, sizes = forward(w, arch, feats.to(device),
                                    (frames.to(torch.float32) / t_pad
                                     ).to(device), None, False, QUANT[quant])
                if tokens is None:
                    tokens = np.zeros((n, b, lp.shape[0]), np.int32)
                    lens = np.zeros((n, b), np.int32)
                for i, hyp in enumerate(greedy_hypotheses(lp, sizes)):
                    tokens[bi, i, :len(hyp)] = hyp
                    lens[bi, i] = len(hyp)
            out.append((tokens, lens))
    return out


def look(prog: dict, ref: dict) -> dict:
    """Where the training numbers come from: each step's loss gap, and the
    leaf that sets each leaf number with its reference norm."""
    from gpubench import judge

    keep = judge.kept_leaves(ref["raw_grad_norms"])
    out = {"loss_gaps": [abs(p - r) / abs(r) for p, r in
                         zip(prog["losses"], ref["losses"])],
           "left_out": sorted(set(ref["raw_grad_norms"]) - set(keep))}
    for key in ("grad_norms", "step_norms"):
        gaps = {n: abs(prog[key][n] - ref[key][n]) for n in keep}
        worst = max(gaps, key=gaps.get)
        out[key] = [worst, gaps[worst], ref[key][worst]]
    return out


def readings(job) -> dict:
    from gpubench import judge, program, registry

    kind = registry.kind(job.mix["kind"])
    t0 = time.perf_counter()
    prog = kind.Program(job)
    setup_s = time.perf_counter() - t0
    weights = {k: v.detach().cpu() for k, v in prog.weights.items()}
    out = {"seed": job.seed, "setup_s": setup_s}
    if job.mix["kind"] == "train":
        args = (prog.check, prog.corpus, prog.arch, weights,
                prog.host.batcher.label_pad, job.device)
        check = prog.check
        del prog
        program.release(job.device)
        ref = kind.reference_readings(*args)
        out["program"] = judge.train_numbers(check, ref)
        out["look"] = look(check, ref)
        fp8 = kind.reference_readings(*args, quant="fp8")
        out["fp8"] = judge.train_numbers(fp8, ref)
        out["look_fp8"] = look(fp8, ref)
        half = kind.reference_readings(*args, drop_half=True)
        out["half_batch"] = judge.train_numbers(half, ref)
        out["raw"] = {side: {k: r[k] for k in (
            "losses", "grad_norms", "step_norms")} for side, r in (
            ("program", check), ("reference", ref), ("fp8", fp8),
            ("half_batch", half))}
        out["raw"]["reference"]["raw_grad_norms"] = ref["raw_grad_norms"]
        for side, r in (("program", check), ("fp8", fp8),
                        ("half_batch", half)):
            out["raw"][side]["diff_norms"] = judge.diff_norms(r, ref)
        out["state_unchanged"] = judge.train_numbers(
            kind.reference_readings(*args, frozen=True), ref)
    else:
        from gpubench.trace import Spans

        passes = [prog.decode_pass(Spans(False))]
        args = (prog.groups, prog.corpus, prog.host.batcher.label_pad,
                prog.arch, weights, job.device)
        n_class = prog.arch.n_class
        del prog
        program.release(job.device)
        out["program"] = {"align_gap_nats": kind.align_gap(passes, 0, *args)}
        out["fp8"] = {"align_gap_nats": kind.align_gap(
            [control_pass(*args, quant="fp8")], 0, *args)}
        out["token_altered"] = {"align_gap_nats": kind.align_gap(
            [altered(passes[0], n_class)], 0, *args)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from gpubench import harness, registry

    bench = registry.load_benchmark()
    for seed in args.seeds:
        job, _ = harness.make_job(bench, args.workload, seed, 0.0, False,
                                  args.device, time.perf_counter())
        print(json.dumps(readings(job)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
