"""The kernel launch counts of the op modules as one record.

Each op module counts its kernel launches in Python, where its launcher runs:
``launches``, ``launches_fwd``, ``launches_bwd_prepass``, ``launches_bwd``,
``launches_alpha``, ``launches_beta`` (ints) and ``launches_fwd_branch``,
``launches_bwd_branch`` (dicts by branch), ``launches_route`` (the conv
epilogue's layer calls, a dict by route), ``launches_steps`` (the serial
time steps of the recurrence launches, a dict by pass) and ``rnn_io``'s
``launches_mask`` and ``launches_merge`` (a recurrent layer's calls, dicts
by route).  Under a captured CUDA graph a
launcher runs once, at capture, and every replay launches the same kernels
without Python.  So a captured graph keeps the counts that its capture added
(``diff``), the capture's own additions are taken back (``restore``), and
each replay adds them again (``add``, in ``train/graphs.py``): a count then
says how many times a kernel ran, eager or replayed.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

MODULES = ("conv_epilogue", "ctc_loss", "gru_bidir", "gru_bidir_train",
           "lstm_bidir", "lstm_bidir_train", "rnn_bidir", "rnn_bidir_train",
           "rnn_io")

Counts = Dict[Tuple[str, str], object]


def _modules():
    return [importlib.import_module(f"ctc_pytorch_tpu_torch.ops.{m}")
            for m in MODULES]


def read() -> Counts:
    """Every launch counter, ``(module, name) -> int or {branch: int}``
    (dicts copied)."""
    out: Counts = {}
    for mod in _modules():
        for name, value in vars(mod).items():
            if name.startswith("launches"):
                key = (mod.__name__.rsplit(".", 1)[1], name)
                out[key] = dict(value) if isinstance(value, dict) else value
    return out


def restore(counts: Counts) -> None:
    """Set every counter to its value in ``counts`` (a ``read``)."""
    mods = {m.__name__.rsplit(".", 1)[1]: m for m in _modules()}
    for (mod, name), value in counts.items():
        cur = getattr(mods[mod], name)
        if isinstance(cur, dict):
            cur.update(value)  # the dict object stays: callers hold it
        else:
            setattr(mods[mod], name, value)


def diff(after: Counts, before: Counts) -> Counts:
    """``after - before``, counter by counter; counters that did not move
    are left out."""
    out: Counts = {}
    for key, value in after.items():
        if isinstance(value, dict):
            moved = {k: v - before[key][k] for k, v in value.items()
                     if v != before[key][k]}
            if moved:
                out[key] = moved
        elif value != before[key]:
            out[key] = value - before[key]
    return out


def add(delta: Counts) -> None:
    """Add ``delta`` (a ``diff``) to the counters."""
    mods = {m.__name__.rsplit(".", 1)[1]: m for m in _modules()}
    for (mod, name), value in delta.items():
        cur = getattr(mods[mod], name)
        if isinstance(cur, dict):
            for k, v in value.items():
                cur[k] += v
        else:
            setattr(mods[mod], name, cur + value)
