#!/usr/bin/env python3
"""Device time of the flagship's CNN stack, forward and backward, with its
conv epilogue fused (``ops/conv_epilogue.py``'s kernels) and as the plain
twin, at the padded shapes of the benchmark's three cells.

For each cell (``gpubench/traffic/<mix>.json`` through the port's own
``BucketBatcher``, epoch 0) and each padded length T it runs the CNN stack
of ``gpubench/configs/timit_lstm.json`` (bf16, two conv layers) on a random
batch: the train cells a forward in train mode and a backward from the
reshaped output (as the recurrent layers hand it back), the decode cell an
eval forward.  Each route is profiled over ``--iters`` calls, in turns
(plain, fused, fused, plain by default); the device time is the sum of the
kernels, copies and sets (``gpubench/trace.py:device_activity``) over the
calls.  Per cell the times are weighted by how many of the epoch's steps
pad to each T.  The fused kernels' time stands beside their byte bound:
each pass over a layer's plane counted once (train: the statistics read,
the apply's read and write, the backward sums' two reads, its apply's two
reads and a write; eval: the apply's read and write) at 3.35 TB/s.

    python3 tools/probe_cnn_bn.py [--iters 10] [--turns 2]

Needs one CUDA device.  Prints one JSON line and writes it to
``chiprun_out/probe_cnn_bn.json``.
"""

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

CELLS = (("timit_lstm-train_b8", "timit_train_b8", True),
         ("timit_lstm-train_b128", "timit_train_b128", True),
         ("timit_lstm-decode_b8", "timit_coretest_b8", False))
HBM_BYTES_PER_S = 3.35e12


def padded_shapes(cfg, mix, train: bool):
    """``{T: steps}`` of epoch 0 of the mix, as the port's loader pads it."""
    from ctc_pytorch_tpu_torch.data.batching import BucketBatcher
    from gpubench.traffic import frame_counts, label_counts

    frames = frame_counts(mix, int(cfg.n_downsample or 1))
    batcher = BucketBatcher(frames, label_counts(mix, frames),
                            int(mix["batch_size"]), int(mix["num_buckets"]),
                            seed=cfg.seed, shuffle=train, mode=cfg.batch_mode)
    return dict(sorted(collections.Counter(
        t for _, t, _ in batcher.epoch_batches(0)).items()))


def plane_bytes(cnn, b: int, t: int, f: int, elem: int, train: bool) -> int:
    """Bytes the fused kernels move over the stack's planes (one count a
    pass)."""
    passes = 8 if train else 2
    total = 0
    for i in range(cnn.layers):
        t, f = cnn.conv_out(i, t, f)
        total += passes * b * cnn.channel[i][1] * t * f * elem
    return total


def device_ms(fn, iters: int):
    """Device milliseconds a call of ``fn`` (profiled over ``iters``
    calls after two warm ones) and milliseconds a call by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpubench.trace import device_activity

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(float)
    for ev in prof.events():
        if device_activity(ev):
            by_name[ev.name] += ev.time_range.elapsed_us() / 1e3 / iters
    return sum(by_name.values()), dict(by_name)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args()

    import torch

    from ctc_pytorch_tpu_torch.config import Config
    from ctc_pytorch_tpu_torch.models.cnn import CNNStack
    from ctc_pytorch_tpu_torch.ops import conv_epilogue as ce

    if not torch.cuda.is_available():
        raise SystemExit("probe_cnn_bn needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda")
    config = json.loads((HERE / "gpubench/configs/timit_lstm.json"
                         ).read_text())["config"]
    cfg = Config.from_dict(config)
    cd = torch.bfloat16
    feat = int(config["rnn_input_size"])
    gen = torch.Generator().manual_seed(0)
    stack = CNNStack(cfg.cnn)
    for layer in stack:
        layer.reset_parameters(gen)
    stack.to(card)
    fused_route = ce.fused_route
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report = {"device": torch.cuda.get_device_name(0), "smi": smi,
              "torch": torch.__version__, "iters": args.iters, "cells": {}}
    for cell, mix_name, train in CELLS:
        mix = json.loads((HERE / f"gpubench/traffic/{mix_name}.json"
                          ).read_text())
        b = int(mix["batch_size"])
        shapes = padded_shapes(cfg, mix, train)
        rows = {}
        for t, steps in shapes.items():
            g = torch.Generator(device=card).manual_seed(t)
            x = torch.randn(b, 1, t, feat, generator=g, device=card)
            tv = torch.tensor(t, dtype=torch.int32, device=card)
            em = torch.ones(b, device=card)
            em[-1] = 0.0  # a repeat-padded row, as the epoch's last batch
            stack.train(train)
            with torch.no_grad():
                shape = stack(x, cd, t_valid=tv).shape
            dout = torch.randn(shape[2], b, shape[1] * shape[3], generator=g,
                               device=card, dtype=cd)

            def call():
                if not train:
                    with torch.no_grad():
                        return stack(x, cd, t_valid=tv)
                y = stack(x, cd, t_valid=tv, example_mask=em)
                out = y.permute(2, 0, 1, 3).reshape(dout.shape)
                out.backward(dout)
                return y

            times = {"plain": [], "fused": []}
            kernels, epi = {}, []
            order = ["plain", "fused", "fused", "plain"] * args.turns
            for route in order[:2 * args.turns]:
                ce.fused_route = (fused_route if route == "fused"
                                  else (lambda *a, **k: False))
                before = dict(ce.launches_route)
                ms, by_name = device_ms(call, args.iters)
                moved = {k: v - before[k] for k, v in ce.launches_route.items()
                         if v != before[k]}
                times[route].append(ms)
                if route == "fused":
                    epi.append(sum(v for k, v in by_name.items()
                                   if "cnn_bn_" in k))
                kernels[route] = {"launches_route": moved, "top": sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:12]}
            ce.fused_route = fused_route
            bound = plane_bytes(cfg.cnn, b, t, feat, 2, train) \
                / HBM_BYTES_PER_S * 1e3
            rows[t] = {"steps": steps, "plain_ms": times["plain"],
                       "fused_ms": times["fused"],
                       "fused_epilogue_kernels_ms": min(epi),
                       "epilogue_byte_bound_ms": bound, "kernels": kernels}
        n = sum(r["steps"] for r in rows.values())

        def mean(key):
            return sum(r["steps"] * min(r[key]) for r in rows.values()) / n

        report["cells"][cell] = {
            "batch": b, "train": train, "shapes": shapes, "by_t": rows,
            "plain_ms_per_step": mean("plain_ms"),
            "fused_ms_per_step": mean("fused_ms"),
            "fused_epilogue_kernels_ms_per_step": sum(
                r["steps"] * r["fused_epilogue_kernels_ms"]
                for r in rows.values()) / n,
            "epilogue_byte_bound_ms_per_step": sum(
                r["steps"] * r["epilogue_byte_bound_ms"]
                for r in rows.values()) / n}
        c = report["cells"][cell]
        print(f"{cell}: plain {c['plain_ms_per_step']:.3f} ms, fused "
              f"{c['fused_ms_per_step']:.3f} ms a step (epilogue kernels "
              f"{c['fused_epilogue_kernels_ms_per_step']:.3f}, bound "
              f"{c['epilogue_byte_bound_ms_per_step']:.3f})", flush=True)
    line = json.dumps(report)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_cnn_bn.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
