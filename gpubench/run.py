"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the port.  ``--trace 0``
measures the cell's end-to-end metrics; ``--trace 1`` a traced window and
its per-layer metrics.  Both decide ``correct`` by the reference.  The last
line of standard output is one JSON object; the numbers compared, each with
its limit, are the last lines of standard error and the result's last key.
Exits with a code other than 0, printing no result, where torch sees no
card or fewer than the cell asks for, where the run fails, or where JAX or
the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gpubench import harness, peaks, registry

    bench = registry.load_benchmark()
    job, cell = harness.make_job(bench, args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T_START)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"gpubench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    outcome = registry.kind(job.mix["kind"]).run(job)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"gpubench: JAX or the JAX package is loaded: {loaded}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": outcome.memory_peak_bytes,
              "card": peaks.card()}
    line = harness.result_line(bench, args.workload, outcome, device)
    print("gpubench seconds: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in outcome.seconds.items()), file=sys.stderr)
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
