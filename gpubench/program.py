"""What the kinds share on the program's side: the recipe as the port reads
it, the port's loaders over a generated corpus, its launch counters, the
profiler, and the memory peak."""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, Tuple

import torch

from gpubench.traffic import Corpus, CorpusDataset

EVAL_RECURRENCES = ("lstm_bidir", "gru_bidir", "rnn_bidir")


class Marks:
    """Seconds of each phase of a set-up, each call closing one."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._last = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self._last
        self._last = now


def program_config(config: dict, mix: dict):
    """The port's ``Config`` of the recipe, at the mix's batch and bucket
    count; TF32 off, as stages 2 and 4 set it."""
    from ctc_pytorch_tpu_torch.config import Config

    cfg = Config.from_dict(config)
    cfg.batch_size = int(mix["batch_size"])
    cfg.num_buckets = int(mix["num_buckets"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cfg


def loaders(corpus: Corpus, cfg, shuffle: bool, device):
    """``(host loader, device cache)``: the port's ``SpeechDataLoader`` and
    ``DeviceCachedLoader`` over the corpus, as stage 2 (``shuffle``) and
    stage 4 build them."""
    from ctc_pytorch_tpu_torch.data.batching import (
        DeviceCachedLoader,
        SpeechDataLoader,
    )

    host = SpeechDataLoader(CorpusDataset(corpus), cfg.batch_size,
                            shuffle=shuffle, num_buckets=cfg.num_buckets,
                            seed=cfg.seed, mode=cfg.batch_mode)
    return host, DeviceCachedLoader(host, device)


def read_launches():
    from ctc_pytorch_tpu_torch.ops import launch_counts

    return launch_counts.read()


def recurrence_calls(before, after) -> Tuple[int, int]:
    """``(forward, backward)`` recurrence launches between two readings of
    the port's counters (graph replays included)."""
    fwd = bwd = 0
    for (mod, name), value in after.items():
        if isinstance(value, dict):
            continue
        moved = value - before[(mod, name)]
        if name == "launches_fwd" or (name == "launches"
                                      and mod in EVAL_RECURRENCES):
            fwd += moved
        elif name == "launches_bwd":
            bwd += moved
    return fwd, bwd


@contextlib.contextmanager
def profiled(out: list):
    """``torch.profiler`` over the block; its events are appended to
    ``out``.  A small synchronised op first, so that the profiler has
    started taking the device's activity when the block starts."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        yield
        torch.cuda.synchronize()
    out.extend(prof.events())


def memory_peak(device) -> int:
    dev = torch.device(device)
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def release(device) -> None:
    """Return the freed program's memory to the card before the reference
    runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
