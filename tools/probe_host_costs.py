#!/usr/bin/env python3
"""Host costs around the graphed path, on one GPU, at the recipes' batches
(the TIMIT flagship at B=8, the 863 model with the GRU cell at B=16, full
width, random weights from a seed, synthetic inputs):

- the eager train step (``train.loop.train_step``) and the optimizer step
  alone with the port's Adam (``capturable``, the learning rate a device
  tensor, ``train/state.py``: what CUDA graphs need) against PyTorch's
  default Adam (the step count and the learning rate on the host);
- one pass of the prefetching loader (``data.PrefetchLoader``) against the
  plain host loader, each batch moved to the card and nothing computed.

Each pair runs in the turns A, B, B, A; times are host seconds around work
that ends in ``torch.cuda.synchronize()``.

    python3 tools/probe_host_costs.py

It writes its synthetic corpus under ``chip_smoke.py``'s work directory and
removes it at exit.
"""

import dataclasses
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def host_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn()`` over ``reps`` calls, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def in_turns(runs: dict, reps: int) -> dict:
    """``{name: [ms, ms]}`` of the two callables of ``runs`` in the turns
    A, B, B, A, after a warm-up each."""
    a, b = runs
    for fn in runs.values():
        for _ in range(3):
            fn()
    out = {a: [], b: []}
    for name in (a, b, b, a):
        out[name].append(host_ms(runs[name], reps))
    return out


def main() -> int:
    import torch

    from ctc_pytorch_tpu_torch.cli.train import build_loaders
    from ctc_pytorch_tpu_torch.data import PrefetchLoader
    from ctc_pytorch_tpu_torch.models import ModelSpec
    from ctc_pytorch_tpu_torch.train.loop import _on, train_step
    from ctc_pytorch_tpu_torch.train.state import (
        create_train_state,
        ordered_params,
    )
    from ctc_pytorch_tpu_torch.vocab import Vocab

    if not torch.cuda.is_available():
        print("probe_host_costs: needs one GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line())
    for split, n, seed in (("train", 64, 1), ("dev", 16, 2)):
        cs.write_corpus(cs.WORK / "data", split, n, seed=seed)
    for split, n, seed in (("train", 128, 11), ("dev", 32, 12)):
        cs.write_corpus(cs.WORK / "data863", split, n, seed=seed, dim=201,
                        units=cs.UNITS_863, feats="spectrum", labels="text")
    dev = torch.device("cuda")
    for what, cfg, b, t, l in (
            ("flagship B=8", cs.recipe_config(), 8, 200, 33),
            ("863 B=16", cs.recipe_config_863(), 16, 200, 40)):
        n_class = (cfg.num_class + 1 if cfg.num_class > 0
                   else Vocab(cfg.vocab_file).n_words)
        spec = ModelSpec.from_config(cfg, num_class=n_class)
        x = torch.randn(b, t, spec.rnn_input_size, device=dev)
        frac = torch.ones(b, device=dev)
        _, labels, _, lab_len = cs.ctc_inputs(2, b, n_class, l, seed=11,
                                              full=True)
        mask = torch.ones(b, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        states = {}
        for name in ("capturable Adam", "default Adam"):
            states[name] = create_train_state(
                spec, cfg.init_lr, cfg.weight_decay, cfg.grad_clip,
                seed=cfg.seed, device=dev)
        plain = states["default Adam"]
        plain.optimizer = torch.optim.Adam(ordered_params(plain.model, spec),
                                           lr=cfg.init_lr,
                                           weight_decay=cfg.weight_decay or 0.0)
        steps = in_turns({k: (lambda st=st: train_step(
            st, spec, x, frac, labels, lab_len, mask, gen))
            for k, st in states.items()}, reps=20)
        adam = in_turns({k: st.optimizer.step for k, st in states.items()},
                        reps=50)
        print(f"{what}: eager train step {steps} ms; optimizer step alone "
              f"{adam} ms")

        host, _ = build_loaders(dataclasses.replace(cfg, device_cache=False,
                                                    host_prefetch=False),
                                Vocab(cfg.vocab_file), log=lambda *_: None,
                                device=dev)

        def one_pass(loader):
            host.set_epoch(1)
            for batch in loader:
                for v in (batch.feats, batch.input_frac, batch.labels,
                          batch.label_lengths, batch.example_mask):
                    _on(v, dev)

        n = len(host)
        passes = in_turns({"plain": lambda: one_pass(host),
                           "prefetch": lambda: one_pass(
                               PrefetchLoader(host, dev))}, reps=3)
        print(f"{what}: a loader pass alone, ms a batch over {n} batches: "
              f"{ {k: [v / n for v in vs] for k, vs in passes.items()} }")
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
    sys.exit(code)
