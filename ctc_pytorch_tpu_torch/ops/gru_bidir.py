"""Bidirectional GRU recurrence (eval): the Hopper kernel and its plain twin.

Replaces ``ctc_pytorch_tpu/ops/gru_pallas_v2.py:gru_bidir_v2(train=False)``
(``_fwd_pallas``, cell ``_gru_cell2``).  Given the hoisted input projection
``gx (T, B, 6H)`` in the stream dtype S (lanes ``[0, 3H)`` forward, ``[3H,
6H)`` backward, gate order r, z, n) and ``w_hh (2, H, 3H)``, it returns ``ys
(T, B, 2H)`` fp32, the backward direction's outputs in forward-time order at
lanes ``[H, 2H)``.  h0 = 0.  A unidirectional layer passes one direction,
``gx (T, B, 3H)`` and ``w_hh (1, H, 3H)``, and gets ``(T, B, H)`` from the
same kernel.

Rounding points, the JAX kernel's: ``w_hh`` is rounded to S (unlike the LSTM
eval kernel, whose weights stay fp32), each h is rounded to S for the
recurrent product, the product is summed in fp32 and its r, z and n parts
stay apart (``n = tanh(gx_n + r * hh_n)``), ``z * h`` uses the fp32 carry, and
``ys`` is stored rounded to S.

On this card the work is bound by its bytes with bf16 streams (both operands
of the product are bf16 values, which the tensor cores multiply) and by fp32
operations with fp32 streams; ``csrc/gru_bidir.cu`` counts both.  The kernel
has three kinds of branch, which the library chooses by shape and reports
(``launches_fwd_branch``): a thread-block cluster per direction and 16 or 32
batch rows with ``w_hh`` resident across it, h exchanged in distributed
shared memory and the step product on the tensor cores with bf16 streams
(``csrc/fwd_cluster.cuh``); with fp32 streams where those clusters do not
all fit (B = 128), the wide branch (``wide_fp32``, ``csrc/fwd_wide.cuh``:
one CTA an SM, 3xTF32 on the tensor cores, h exchanged through L2 under
step flags, H <= 1056), and with bf16 streams past the clusters' bound
(H > 496, or B = 128 past H = 448) its bf16 form (``wide_bf16``: ``w_hh``
resident as bf16, bf16 ``mma.sync`` m16n8k16, h exchanged as bf16, H <=
1352 at B <= 16); or one cooperative grid with a grid barrier per
time step where neither holds the shape.  Any T >= 1, B >= 1 and H run,
with no padding.

``gru_bidir`` takes the plain version for CPU tensors only.  A CUDA tensor
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
LIBRARY = KernelLibrary(
    "gru_bidir.cu",
    {"gru_bidir_fwd_branch": ([_CI] * 4 + [ctypes.POINTER(_CI)], _CI),
     "gru_bidir_forward": (
         [_VP] * 5 + [_CI] * 6 + [_VP, ctypes.POINTER(_CI)], _CI),
     "gru_bidir_error_string": ([_CI], ctypes.c_char_p)},
    headers=["lstm_fwd.cuh", "gru_fwd.cuh", "bwd_hoist.cuh", "bwd_wide.cuh",
             "fwd_wide.cuh", "fwd_cluster.cuh"])

# kernel launches made through ``gru_bidir``; the plain path adds nothing
launches = 0
# the same launches by the branch the library reported
launches_fwd_branch = dict.fromkeys(FWD_BRANCHES, 0)
# serial time steps of those launches (T a launch)
launches_steps = {"fwd": 0}


def gru_gates(pre: torch.Tensor, hh: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(r, z, n)`` from the input part ``pre`` and the recurrent part ``hh``
    of the pre-activations, both ``(..., 3H)``."""
    p_r, p_z, p_n = pre.chunk(3, dim=-1)
    h_r, h_z, h_n = hh.chunk(3, dim=-1)
    r = torch.sigmoid(p_r + h_r)
    return r, torch.sigmoid(p_z + h_z), torch.tanh(p_n + r * h_n)


def gru_bidir_plain(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over time.

    ``gx (T, B, ndir * 3H)`` in the stream dtype, ``w_hh (ndir, H, 3H)`` ->
    ``ys (T, B, ndir * H)`` in the stream dtype (each h rounded once, as
    stored)."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    sd, acc = gx.dtype, acc_dtype(gx.dtype)
    w = w_hh.to(sd).to(acc)
    hs = torch.zeros(ndir, b, h, dtype=acc, device=gx.device)
    ys = torch.empty(t_len, b, ndir * h, dtype=sd, device=gx.device)
    for s in range(t_len):
        times = step_times(t_len, ndir, s)
        pre = torch.stack([gx[t, :, 3 * d * h:3 * (d + 1) * h]
                           for d, t in enumerate(times)]).to(acc)
        r, z, n = gru_gates(pre, torch.bmm(hs.to(sd).to(acc), w))
        hs = (1.0 - z) * n + z * hs
        for d, t in enumerate(times):
            ys[t, :, d * h:(d + 1) * h] = hs[d].to(sd)
    return ys


def check_inputs(gx: torch.Tensor, w_hh: torch.Tensor
                 ) -> Tuple[int, int, int, int]:
    """``(T, B, H, ndir)`` of a kernel call's inputs, or raise."""
    return check_recurrence(gx, w_hh, 3)


def launch_forward(gx: torch.Tensor, w_hh: torch.Tensor
                   ) -> Tuple[torch.Tensor, str]:
    """Launch the forward kernel on the current stream, counting nothing:
    ``(ys in the stream dtype, the branch launched)``.  The trainable op's
    forward is this kernel too (a GRU saves nothing but ``ys``) and keeps its
    own counts.  Does not synchronise."""
    t_len, b, h, ndir = check_inputs(gx, w_hh)
    lib = LIBRARY.load()
    gx = gx.contiguous()
    w = w_hh.to(gx.dtype).float().contiguous()  # rounded to the stream dtype
    with torch.cuda.device(gx.device):
        ys = torch.empty(t_len, b, ndir * h, dtype=gx.dtype, device=gx.device)
        # the grid branch's fp32 carry scratch, (direction, B, H)
        branch = _launch(lib, "gru_bidir", gx, w, [ys], t_len, b, h, ndir,
                         [(ndir, b, h)])
    return ys, branch


def gru_bidir_cuda(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; ``ys`` in the stream dtype.
    Does not synchronise."""
    global launches
    ys, branch = launch_forward(gx, w_hh)
    launches += 1
    launches_fwd_branch[branch] += 1
    launches_steps["fwd"] += ys.shape[0]
    return ys


def gru_bidir(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, B, ndir * 3H) stream-dtype gates + (ndir, H, 3H) weights ->
    (T, B, ndir * H) fp32.

    CUDA tensors launch the kernel; CPU tensors run ``gru_bidir_plain``."""
    if device_kind(gx, "gru_bidir") == "cuda":
        return gru_bidir_cuda(gx, w_hh).float()
    return gru_bidir_plain(gx, w_hh).float()
