"""Bidirectional LSTM recurrence (eval): the Hopper kernel and its plain twin.

Replaces ``ctc_pytorch_tpu/ops/lstm_pallas_v2.py:lstm_bidir_pallas_v2``.
Given the hoisted input projection ``gx (T, B, 8H)`` in the stream dtype
(lanes ``[0, 4H)`` forward, ``[4H, 8H)`` backward) and ``w_hh (2, H, 4H)``,
it returns ``ys (T, B, 2H)`` fp32, the backward direction's outputs in
forward-time order at lanes ``[H, 2H)``.  h0 = c0 = 0; the recurrent
product, gates, h and c are fp32; ``ys`` is rounded to the stream dtype and
back, as the Pallas kernel stores it.  A unidirectional layer passes one
direction, ``gx (T, B, 4H)`` and ``w_hh (1, H, 4H)``, and gets ``(T, B, H)``
from the same kernel.

On this card the work is bound by operations, not bytes: at the decode
bench shape (T=80, B=128, H=384) the fp32 recurrent product is 24.2 GFLOP
per layer, ~0.36 ms at 67 TFLOP/s, against ~25 us for the ~83 MB of gx, ys
and w_hh.  The kernel has two branches, which the library chooses by shape
and reports (``launches_fwd_branch``): a thread-block cluster per direction
and 16 batch rows with ``w_hh`` resident across it and h exchanged in
distributed shared memory (``cluster16_fp32``, ``csrc/fwd_cluster.cuh``, H
<= 416, while every cluster fits on the card at once); where they do not (B
>= 64 at H = 384) the wide branch (``wide_fp32``, ``csrc/fwd_wide.cuh``: one
CTA an SM with its weights resident, the product in 3xTF32 on the tensor
cores, h exchanged through L2 under per-block step flags, H <= 600 at B =
128 with two directions); and for every other shape one cooperative grid with a grid
barrier per time step (``csrc/lstm_bidir.cu``).  Any T >= 1, B >= 1 and H
run, with no padding.

``lstm_bidir`` takes the plain version for CPU tensors only.  A CUDA tensor
goes through the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from ctc_pytorch_tpu_torch.ops._build import (
    FWD_BRANCHES,
    KernelLibrary,
    check_recurrence,
    device_kind,
    launch_forward,
    step_times,
)

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "lstm_bidir.cu",
    {"lstm_bidir_fwd_branch": ([_CI] * 4 + [ctypes.POINTER(_CI)], _CI),
     "lstm_bidir_forward": (
         [_VP] * 5 + [_CI] * 6 + [_VP, ctypes.POINTER(_CI)], _CI),
     "lstm_bidir_error_string": ([_CI], ctypes.c_char_p)},
    headers=["lstm_fwd.cuh", "bwd_hoist.cuh", "bwd_wide.cuh", "gru_fwd.cuh",
             "fwd_wide.cuh", "fwd_cluster.cuh"])

# kernel launches made through ``lstm_bidir``; the plain path adds nothing
launches = 0
# the same launches by the branch the library reported
launches_fwd_branch = dict.fromkeys(FWD_BRANCHES, 0)
# serial time steps of those launches (T a launch)
launches_steps = {"fwd": 0}


def lstm_bidir_plain(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over time.

    ``gx (T, B, ndir * 4H)`` in the stream dtype, ``w_hh (ndir, H, 4H)`` ->
    ``ys (T, B, ndir * H)`` in the stream dtype (each h rounded once, as
    stored)."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    w = w_hh.float()
    hs = torch.zeros(ndir, b, h, dtype=torch.float32, device=gx.device)
    cs = torch.zeros_like(hs)
    ys = torch.empty(t_len, b, ndir * h, dtype=gx.dtype, device=gx.device)
    for s in range(t_len):
        times = step_times(t_len, ndir, s)
        g2 = torch.stack([gx[t, :, 4 * d * h:4 * (d + 1) * h]
                          for d, t in enumerate(times)]).float()
        gates = g2 + torch.bmm(hs, w)
        i, f, g, o = gates.chunk(4, dim=-1)
        cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
        hs = torch.sigmoid(o) * torch.tanh(cs)
        for d, t in enumerate(times):
            ys[t, :, d * h:(d + 1) * h] = hs[d].to(gx.dtype)
    return ys


def lstm_bidir_cuda(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; ``ys`` in the stream dtype.
    Does not synchronise."""
    global launches
    t_len, b, h, ndir = check_recurrence(gx, w_hh, 4)
    gx = gx.contiguous()
    w_hh = w_hh.contiguous()
    lib = LIBRARY.load()
    with torch.cuda.device(gx.device):
        ys = torch.empty(t_len, b, ndir * h, dtype=gx.dtype, device=gx.device)
        # the grid branch's c scratch, (direction, B, H)
        branch = launch_forward(lib, "lstm_bidir", gx, w_hh, [ys], t_len, b,
                                h, ndir, [(ndir, b, h)])
    launches += 1
    launches_fwd_branch[branch] += 1
    launches_steps["fwd"] += t_len
    return ys


def lstm_bidir(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, B, ndir * 4H) stream-dtype gates + (ndir, H, 4H) weights ->
    (T, B, ndir * H) fp32.

    CUDA tensors launch the kernel; CPU tensors run ``lstm_bidir_plain``."""
    if device_kind(gx, "lstm_bidir") == "cuda":
        return lstm_bidir_cuda(gx, w_hh).float()
    return lstm_bidir_plain(gx, w_hh).float()
