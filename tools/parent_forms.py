"""The parent forms of the branches that the wide-batch kernels
(``csrc/fwd_wide.cuh``, ``csrc/bwd_wide.cuh``; the tanh cell's forward and
backward on the first) and the GRU backward's fp32 cluster took over: the
port's recurrence libraries built again with ``-DPARENT_BRANCHES``
(``csrc/bwd_hoist.cuh``), whose launchers keep the cooperative grid at those
shapes, and a block that routes the ops through them.  So one run on the
card times both forms of a shape through the same entry points
(``chip_smoke.py`` phase 9)::

    from tools.parent_forms import parent_forms

    with parent_forms():
        lstm_bidir.lstm_bidir_cuda(gx, w_hh)  # the grid at B = 128

The shipped libraries and entry points keep a single branch a shape; nothing
of the package imports this module.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

DEFINE = "-DPARENT_BRANCHES"


def _modules():
    """The op modules whose libraries have a parent form."""
    from ctc_pytorch_tpu_torch.ops import (gru_bidir, gru_bidir_train,
                                           lstm_bidir, lstm_bidir_train,
                                           rnn_bidir, rnn_bidir_train)

    return [lstm_bidir, lstm_bidir_train, gru_bidir, gru_bidir_train,
            rnn_bidir, rnn_bidir_train]


_PARENTS: dict = {}


def parent_library(module):
    """The parent form of ``module.LIBRARY`` (built once, at first use)."""
    from ctc_pytorch_tpu_torch.ops._build import KernelLibrary

    class ParentLibrary(KernelLibrary):
        def output_path(self) -> Path:
            path = super().output_path()
            return path.with_name("libparent_" + path.name[len("lib"):])

        def build_command(self, out: Path) -> list:
            cmd = super().build_command(out)
            return [cmd[0], DEFINE, *cmd[1:]]

    if module.__name__ not in _PARENTS:
        lib = module.LIBRARY
        _PARENTS[module.__name__] = ParentLibrary(
            lib.source.name, lib.functions, [h.name for h in lib.headers])
    return _PARENTS[module.__name__]


def libraries() -> list:
    """Every parent library, for one parallel build beside the package's."""
    return [parent_library(m) for m in _modules()]


@contextlib.contextmanager
def parent_forms():
    """Inside the block the LSTM, GRU and tanh ops launch through the
    parent libraries; their launch counts go on as usual (the grid's)."""
    modules = _modules()
    saved = [m.LIBRARY for m in modules]
    for m in modules:
        m.LIBRARY = parent_library(m)
    try:
        yield
    finally:
        for m, lib in zip(modules, saved):
            m.LIBRARY = lib
