"""Readings that the limits of a ``train_ds2`` cell are set from.

    python3 gpubench/calibrate_ds2.py --workload <cell> --seeds <n> [<n> ...]
        [--program-only]

``calibrate.py``'s training readings (the program's numbers against the
reference, the float8 control, half of each batch left out of the loss, a
state left unchanged, and where each number comes from) for a cell of kind
``train_ds2`` (``kinds/train_ds2.py``), whose name ``calibrate.py`` does not
take for training.  ``--program-only`` reads the lower side alone: the
program's numbers against the reference, from a program set up only as far
as its check steps (no capture of the other batch shapes, no warm epoch).
One JSON line a seed on standard output; the benchmark's runs do not run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def check_steps_only(base):
    """``base`` (a kind's ``Program``) set up as far as its check steps."""

    class CheckSteps(base):
        def _capture_other_shapes(self) -> None:
            pass

        def run_epochs(self, first, stop, spans):  # the warm epoch
            return 0, 0, 0

    return CheckSteps


def readings(job, program_only: bool = False) -> dict:
    from gpubench import judge, program, registry
    from gpubench.calibrate import look

    kind = registry.kind(job.mix["kind"])
    t0 = time.perf_counter()
    prog = (check_steps_only(kind.Program) if program_only
            else kind.Program)(job)
    out = {"seed": job.seed, "setup_s": time.perf_counter() - t0}
    weights = {k: v.detach().cpu() for k, v in prog.weights.items()}
    args = (prog.check, prog.corpus, prog.arch, weights,
            prog.host.batcher.label_pad, job.device)
    check = prog.check
    del prog
    program.release(job.device)
    ref = kind.reference_readings(*args)
    sides = {"program": check}
    faults = () if program_only else (("fp8", {"quant": "fp8"}),
                                      ("half_batch", {"drop_half": True}),
                                      ("state_unchanged", {"frozen": True}))
    for side, fault in faults:
        sides[side] = kind.reference_readings(*args, **fault)
    for side, r in sides.items():
        out[side] = judge.train_numbers(r, ref)
    out["look"] = look(check, ref)
    if program_only:
        out["raw"] = {"program": {"losses": check["losses"]},
                      "reference": {"losses": ref["losses"]}}
        return out
    out["look_fp8"] = look(sides["fp8"], ref)
    out["raw"] = {side: {k: sides[side][k] for k in (
        "losses", "grad_norms", "step_norms")} for side in (
        "program", "fp8", "half_batch")}
    out["raw"]["reference"] = {k: ref[k] for k in (
        "losses", "grad_norms", "step_norms", "raw_grad_norms")}
    for side in ("program", "fp8", "half_batch"):
        out["raw"][side]["diff_norms"] = judge.diff_norms(sides[side], ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program-only", action="store_true",
                   help="the program's readings alone (the lower side)")
    args = p.parse_args(argv)

    from gpubench import harness, registry

    bench = registry.load_benchmark()
    for seed in args.seeds:
        job, _ = harness.make_job(bench, args.workload, seed, 0.0, False,
                                  args.device, time.perf_counter())
        print(json.dumps(readings(job, args.program_only)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
