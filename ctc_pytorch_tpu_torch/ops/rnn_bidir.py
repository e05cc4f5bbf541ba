"""Tanh-RNN recurrence (eval): the Hopper kernel and its plain twin.

Replaces ``ctc_pytorch_tpu/ops/rnn_pallas_v2.py:rnn_bidir_v2(train=False)``
(``_fwd_pallas``, cell ``_rnn_cell2``).  Given the hoisted input projection
``gx (T, B, ndir * H)`` in the stream dtype S (lanes ``[0, H)`` the forward
direction, ``[H, 2H)`` the backward one) and ``w_hh (ndir, H, H)``, it returns
``ys (T, B, ndir * H)`` fp32, the backward direction's outputs in
forward-time order.  h0 = 0; ``ndir`` is 2 for a bidirectional layer and 1
for a unidirectional one.

Rounding points, the JAX kernel's: ``w_hh`` is rounded to S (in eval too, as
the GRU's and unlike the LSTM eval kernel's), each h is rounded to S for the
recurrent product, the product is summed in fp32 and ``h = tanh(gx + hh)`` in
fp32, and ``ys`` is stored rounded to S.  h enters the cell only through the
product, so the rounded h is all the recurrence carries.

On this card the work is bound by its bytes with bf16 streams and by fp32
operations with fp32 streams; ``csrc/rnn_bidir.cu`` counts both.  The kernel
has three branches, which the library chooses by shape and reports
(``launches_fwd_branch``): a thread-block cluster per direction and 16 or 32
batch rows with ``w_hh`` resident across it and h exchanged in distributed
shared memory (``csrc/fwd_cluster.cuh``: the step product on the tensor
cores with bf16 streams, fp32 FMA with fp32 streams); with fp32 streams
where those clusters do not all fit (B >= 113 at H = 384 with two
directions) or H is past them, the wide branch (``wide_fp32``,
``csrc/fwd_wide.cuh``: one CTA an SM, 3xTF32 on the tensor cores, h
exchanged through L2 under step flags, H <= 792 at B = 128); or one
cooperative grid with a grid barrier per time step where neither holds the
shape.  Any T >= 1, B >= 1 and H run, with no padding.

``rnn_bidir`` takes the plain version for CPU tensors only.  A CUDA tensor
goes through the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ctc_pytorch_tpu_torch.ops._build import (
    FWD_BRANCHES,
    KernelLibrary,
    acc_dtype,
    check_recurrence,
    device_kind,
    launch_forward as _launch,
    step_times,
)

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# every csrc/ header the tanh sources include
HEADERS = ["lstm_fwd.cuh", "rnn_fwd.cuh", "gru_fwd.cuh", "bwd_hoist.cuh",
           "bwd_wide.cuh", "fwd_wide.cuh", "fwd_cluster.cuh"]
LIBRARY = KernelLibrary(
    "rnn_bidir.cu",
    {"rnn_bidir_fwd_branch": ([_CI] * 4 + [ctypes.POINTER(_CI)], _CI),
     "rnn_bidir_forward": (
         [_VP] * 5 + [_CI] * 6 + [_VP, ctypes.POINTER(_CI)], _CI),
     "rnn_bidir_error_string": ([_CI], ctypes.c_char_p)},
    headers=HEADERS)

# kernel launches made through ``rnn_bidir``; the plain path adds nothing
launches = 0
# the same launches by the branch the library reported
launches_fwd_branch = dict.fromkeys(FWD_BRANCHES, 0)
# serial time steps of those launches (T a launch)
launches_steps = {"fwd": 0}


def rnn_bidir_plain(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over time.

    ``gx (T, B, ndir * H)`` in the stream dtype, ``w_hh (ndir, H, H)`` ->
    ``ys (T, B, ndir * H)`` in the stream dtype."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    sd, acc = gx.dtype, acc_dtype(gx.dtype)
    w = w_hh.to(sd).to(acc)
    hs = torch.zeros(ndir, b, h, dtype=acc, device=gx.device)
    ys = torch.empty(t_len, b, ndir * h, dtype=sd, device=gx.device)
    for s in range(t_len):
        times = step_times(t_len, ndir, s)
        pre = torch.stack([gx[t, :, d * h:(d + 1) * h]
                           for d, t in enumerate(times)]).to(acc)
        hn = torch.tanh(pre + torch.bmm(hs, w)).to(sd)
        hs = hn.to(acc)  # the next product reads h as ys holds it
        for d, t in enumerate(times):
            ys[t, :, d * h:(d + 1) * h] = hn[d]
    return ys


def check_inputs(gx: torch.Tensor, w_hh: torch.Tensor
                 ) -> Tuple[int, int, int, int]:
    """``(T, B, H, ndir)`` of a kernel call's inputs, or raise."""
    return check_recurrence(gx, w_hh, 1)


def launch_forward(gx: torch.Tensor, w_hh: torch.Tensor
                   ) -> Tuple[torch.Tensor, str]:
    """Launch the forward kernel on the current stream, counting nothing:
    ``(ys in the stream dtype, the branch launched)``.  The trainable op's
    forward is this kernel too (the cell saves nothing but ``ys``) and keeps
    its own counts.  Does not synchronise."""
    t_len, b, h, ndir = check_inputs(gx, w_hh)
    lib = LIBRARY.load()
    gx = gx.contiguous()
    w = w_hh.to(gx.dtype).float().contiguous()  # rounded to the stream dtype
    with torch.cuda.device(gx.device):
        ys = torch.empty(t_len, b, ndir * h, dtype=gx.dtype, device=gx.device)
        # the grid branch needs only its h double buffer; the wide branch
        # its exchange buffer and step flags
        branch = _launch(lib, "rnn_bidir", gx, w, [ys], t_len, b, h, ndir, [])
    return ys, branch


def rnn_bidir_cuda(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; ``ys`` in the stream dtype.
    Does not synchronise."""
    global launches
    ys, branch = launch_forward(gx, w_hh)
    launches += 1
    launches_fwd_branch[branch] += 1
    launches_steps["fwd"] += ys.shape[0]
    return ys


def rnn_bidir(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, B, ndir * H) stream-dtype inputs + (ndir, H, H) weights ->
    (T, B, ndir * H) fp32.

    CUDA tensors launch the kernel; CPU tensors run ``rnn_bidir_plain``."""
    if device_kind(gx, "rnn_bidir") == "cuda":
        return rnn_bidir_cuda(gx, w_hh).float()
    return rnn_bidir_plain(gx, w_hh).float()
