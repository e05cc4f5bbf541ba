#!/usr/bin/env python3
"""One traced run of a benchmark cell, with the port's own spans reduced.

Runs the cell's traced window exactly as ``gpubench/run.py --trace 1``
does (its kind's ``run``; the events that ``trace.summarize`` reduces are
kept), prints the result line, and reduces the same events by
``gpubench/program_spans.py``: the card's idle time split by the innermost
``ctc.*`` span, each span's host seconds and count, the self time of
``ctc.runner.step``, and how ``trace.device_activity`` treats the ``ctc.*``
ranges that the profiler draws on the device's timeline.  A tree without
the spans (``--root``) gives the result line and no reduction;
``--no-spans`` turns the tree's spans off (each then returns its null
context, as without a profiler), to time what they cost under one.  The
report also gives the recurrence launches of the window by the branch
each took (``launches_fwd_branch``, ``launches_bwd_branch``).

    python3 tools/probe_spans.py --workload timit_lstm-train_b8 \\
        --seed 2230000001 [--root <tree>] [--label <name>] [--no-spans]

Needs one CUDA device.  Prints the report as one JSON line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=50.0)
    p.add_argument("--root", default=str(HERE))
    p.add_argument("--label", default="change")
    p.add_argument("--no-spans", action="store_true")
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if args.no_spans:
        import types

        from ctc_pytorch_tpu_torch import spans

        spans.profiler = types.SimpleNamespace(_is_profiler_enabled=False)

    from gpubench import harness, peaks, registry

    spec = importlib.util.spec_from_file_location(
        "probe_program_spans", HERE / "gpubench" / "program_spans.py")
    program_spans = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = program_spans  # for its dataclass
    spec.loader.exec_module(program_spans)

    bench = registry.load_benchmark(root)
    job, cell = harness.make_job(bench, args.workload, args.seed,
                                 args.seconds, True, "cuda", T_START)
    kind = registry.kind(job.mix["kind"])
    kept = []
    summarize = kind.summarize

    def keep(events):
        kept.append(events)
        return summarize(events)

    kind.summarize = keep
    # the port's launch counters as the kind reads them, the last two
    # around the traced window
    from gpubench import program

    readings = []
    read_launches = program.read_launches

    def reading():
        readings.append(read_launches())
        return readings[-1]

    program.read_launches = reading
    outcome = kind.run(job)
    (events,) = kept
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": outcome.memory_peak_bytes,
              "card": peaks.card()}
    line = harness.result_line(bench, args.workload, outcome, device)

    from gpubench.trace import device_activity

    drawn = [ev for ev in events if ev.name.startswith(program_spans.PREFIX)
             and ev.device_type != torch.autograd.DeviceType.CPU]
    report = {
        "tree": str(root), "label": args.label, "cell": args.workload,
        "seed": args.seed, "torch": torch.__version__,
        "line": line, "seconds": outcome.seconds,
        "bench_spans": outcome.layers.spans, "steps": outcome.layers.steps,
        "device_drawn_ctc": len(drawn),
        "device_drawn_ctc_kept": sum(map(device_activity, drawn)),
        "device_drawn_ctc_user_annotation": sum(
            bool(getattr(ev, "is_user_annotation", False)) for ev in drawn),
        "program_spans": None,
        "window_launches_by_branch": None}
    if len(readings) >= 2:
        from ctc_pytorch_tpu_torch.ops import launch_counts

        moved = launch_counts.diff(readings[-1], readings[-2])
        report["window_launches_by_branch"] = {
            f"{mod}.{name}": v for (mod, name), v in moved.items()
            if name.endswith("_branch")}
    got = program_spans.reduce(events, outcome.layers.steps)
    if got is not None:
        per_step = {n: got.per_step_ms(s) for n, s in got.seconds.items()}
        report["program_spans"] = {
            "window_s": got.window_s, "counts": got.counts,
            "seconds": got.seconds, "ms_per_step": per_step,
            "step_self_ms_per_step": got.per_step_ms(got.step_self_s),
            "idle_s": got.idle_s,
            "idle_share": {n: 100 * s / got.window_s
                           for n, s in got.idle_s.items()},
            "idle_in_runner_share": got.idle_share(program_spans.RUNNER),
            "idle_in_plan_share": got.idle_share(program_spans.PLAN),
            "idle_in_none_share": 100 * got.idle_s[program_spans.NONE]
            / got.window_s}
    print(json.dumps(report, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
