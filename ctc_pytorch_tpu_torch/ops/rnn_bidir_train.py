"""Trainable tanh-RNN recurrence: the Hopper forward and backward kernels and
their plain twins, joined in one ``torch.autograd.Function``.

Replaces ``ctc_pytorch_tpu/ops/rnn_pallas_v2.py:rnn_scan_v2`` (forward
``_fwd_pallas``, backward ``_bwd_pallas``, VJP ``:284-315``).
``rnn_bidir_train(gx, w_hh)`` takes the hoisted input projection ``gx (T, B,
ndir * H)`` in the stream dtype S and ``w_hh (ndir, H, H)`` fp32 and returns
``ys (T, B, ndir * H)`` in S; h0 = 0; ``ndir`` 2 (lanes ``[0, H)`` forward,
``[H, 2H)`` backward direction) or 1.

The forward is the eval op's function and kernel (``ops/rnn_bidir.py``,
``csrc/rnn_bidir.cu``: the cell saves nothing but ``ys``, and in the JAX
package too one ``_fwd_pallas`` serves both), with a launch count of its own.
The backward needs no gate recompute:

    dpre     = (dy_t + dh) * (1 - y_t^2)      (= dgx[t], stored in S)
    dh_{t-1} = round_S(dpre) @ w_hh^T          (w_hh rounded to S, fp32 sums)

where ``y_t`` is the saved ``ys`` row, in S, read back in fp32 (the JAX
kernel's ``1 - h^2`` from ``ys_store``, ``:183-186``), and ``dh`` is carried
in fp32 and starts at 0.  Direction 0 walks time backward, direction 1
forward.  ``dW_hh`` pairs ``ys[t-1]`` (direction 0) or ``ys[t+1]``
(direction 1, zero past the ends) with ``dgx[t]`` (``:308-311``); it is
formed here, outside the kernel, as plain GEMMs (the LSTM op's ``dw_hh`` with
one gate); the input projection and its gradients belong to the caller's
``torch.matmul``.

The backward kernel has the forward's shape (a value exchanged every step
feeds a (B, H) x (H, H) product) and the forward's branches, which the
library chooses by shape and reports (``launches_bwd_branch``, as the
forward's ``launches_fwd_branch``): the forward's cluster kernels
(``csrc/fwd_cluster.cuh``) run backward in time on the rows of ``w_hh``,
with the tensor cores on bf16 streams and fp32 FMA on fp32 streams; with
fp32 streams where those clusters do not all fit, the forward's wide kernel
run backward in time the same way (``wide_fp32``, ``csrc/fwd_wide.cuh``:
one CTA an SM, 3xTF32 on the tensor cores, dpre exchanged through L2 under
step flags); or one cooperative grid with a grid barrier per time step
where neither holds the shape.  The serial chain, not the card's limits, sets their time
(``csrc/rnn_bidir_train.cu`` counts the limits).  Any T >= 1, B >= 1 and H
run, with no padding.

CPU tensors take the plain twins; a CUDA tensor launches the kernels or the
call raises.
"""

from __future__ import annotations

import ctypes

import torch

from ctc_pytorch_tpu_torch.ops import rnn_bidir as rnn_ops
from ctc_pytorch_tpu_torch.ops._build import (
    FWD_BRANCHES,
    KernelLibrary,
    acc_dtype,
    check_plane,
    device_kind,
    step_times,
    wide_scratch_sizes,
)
from ctc_pytorch_tpu_torch.ops.lstm_bidir_train import dw_hh

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "rnn_bidir_train.cu",
    {"rnn_bidir_train_bwd_branch": ([_CI] * 4 + [ctypes.POINTER(_CI)], _CI),
     "rnn_bidir_train_backward": (
         [_VP] * 6 + [_CI] * 6 + [_VP, ctypes.POINTER(_CI)], _CI),
     "rnn_bidir_train_error_string": ([_CI], ctypes.c_char_p)},
    headers=rnn_ops.HEADERS)

# kernel launches made through ``rnn_bidir_train`` and its backward; the
# plain path adds nothing
launches_fwd = 0
launches_bwd = 0
# the same launches by the branch the library reported
launches_fwd_branch = dict.fromkeys(FWD_BRANCHES, 0)
launches_bwd_branch = dict.fromkeys(FWD_BRANCHES, 0)
# serial time steps of those launches, forward and backward apart (T a
# launch)
launches_steps = {"fwd": 0, "bwd": 0}


def rnn_bidir_train_backward_plain(w_hh: torch.Tensor, ys: torch.Tensor,
                                   dy: torch.Tensor) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch, written out by hand
    in the kernel's arithmetic (not autograd of the forward): ``dgx (T, B,
    ndir * H)`` in the stream dtype of ``ys``."""
    t_len, b, _ = ys.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    sd, acc = ys.dtype, acc_dtype(ys.dtype)
    wt = w_hh.to(sd).to(acc).transpose(1, 2)
    dh = torch.zeros(ndir, b, h, dtype=acc, device=ys.device)
    dgx = torch.empty_like(ys)
    for s in range(t_len):
        # direction 0 walks back, direction 1 forth
        times = step_times(t_len, ndir, t_len - 1 - s)

        def at(plane):
            return torch.stack([plane[t, :, d * h:(d + 1) * h]
                                for d, t in enumerate(times)]).to(acc)

        y = at(ys)
        dpre = ((at(dy) + dh) * (1.0 - y * y)).to(sd)
        for d, t in enumerate(times):
            dgx[t, :, d * h:(d + 1) * h] = dpre[d]
        dh = torch.bmm(dpre.to(acc), wt)
    return dgx


def rnn_bidir_train_cuda(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel (the eval op's) on the current stream:
    ``ys`` in the stream dtype.  Does not synchronise."""
    global launches_fwd
    ys, branch = rnn_ops.launch_forward(gx, w_hh)
    launches_fwd += 1
    launches_fwd_branch[branch] += 1
    launches_steps["fwd"] += ys.shape[0]
    return ys


def rnn_bidir_train_backward_cuda(w_hh: torch.Tensor, ys: torch.Tensor,
                                  dy: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel on the current stream: ``dgx`` in the
    stream dtype of ``ys``.  Does not synchronise."""
    global launches_bwd
    t_len, b, h, ndir = rnn_ops.check_inputs(ys, w_hh)
    check_plane("dy", dy, ys, ndir * h)
    ys, dy = ys.contiguous(), dy.contiguous()
    w = w_hh.to(ys.dtype).float().contiguous()  # rounded to the stream dtype
    bf16 = int(ys.dtype == torch.bfloat16)
    lib = LIBRARY.load()
    branch = ctypes.c_int(-1)
    with torch.cuda.device(ys.device):
        err = lib.rnn_bidir_train_bwd_branch(b, h, ndir, bf16,
                                             ctypes.byref(branch))
        dgx = torch.empty_like(ys)
        ldh = -(-b // 4) * 4
        scratch = []
        if err == 0 and FWD_BRANCHES[branch.value] == "grid":
            # the grid branch's dpre exchange double buffer, (direction,
            # parity, H, ldh): rows padded to a multiple of 4 floats
            # (16-byte copies)
            scratch = [torch.zeros(ndir, 2, h, ldh, dtype=torch.float32,
                                   device=ys.device)]
        elif err == 0 and FWD_BRANCHES[branch.value] == "wide_fp32":
            # the wide branch's exchange buffer and step flags (the library
            # zeroes the flags on the stream)
            n_x, n_flags = wide_scratch_sizes(b, h, ndir)
            scratch = [torch.empty(n_x, dtype=torch.float32, device=ys.device),
                       torch.empty(n_flags, dtype=torch.int32,
                                   device=ys.device)]
        ptrs = [x.data_ptr() for x in scratch] + [None] * (2 - len(scratch))
        if err == 0:
            stream = torch.cuda.current_stream(ys.device).cuda_stream
            err = lib.rnn_bidir_train_backward(
                w.data_ptr(), ys.data_ptr(), dy.data_ptr(), dgx.data_ptr(),
                *ptrs, t_len, b, h, ldh, ndir, bf16, stream,
                ctypes.byref(branch))
    if err != 0:
        msg = lib.rnn_bidir_train_error_string(err).decode()
        raise RuntimeError(f"rnn_bidir_train backward kernel launch failed "
                           f"({err}: {msg}) at T={t_len} B={b} H={h} "
                           f"ndir={ndir}")
    launches_bwd += 1
    launches_bwd_branch[FWD_BRANCHES[branch.value]] += 1
    launches_steps["bwd"] += t_len
    return dgx


class _RnnBidirTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gx, w_hh):
        if device_kind(gx, "rnn_bidir_train") == "cuda":
            ys = rnn_bidir_train_cuda(gx, w_hh)
        else:
            ys = rnn_ops.rnn_bidir_plain(gx, w_hh)
        ctx.save_for_backward(w_hh, ys)
        return ys

    @staticmethod
    def backward(ctx, dy):
        w_hh, ys = ctx.saved_tensors
        dy = dy.to(ys.dtype)
        if device_kind(ys, "rnn_bidir_train") == "cuda":
            dgx = rnn_bidir_train_backward_cuda(w_hh, ys, dy)
        else:
            dgx = rnn_bidir_train_backward_plain(w_hh, ys, dy)
        return dgx, dw_hh(ys, dgx, w_hh.shape[0]).to(w_hh.dtype)


def rnn_bidir_train(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, B, ndir * H) stream-dtype inputs + (ndir, H, H) weights -> ``ys``
    (T, B, ndir * H) in the stream dtype, differentiable in both arguments.

    CUDA tensors launch the kernels (forward here, backward under
    ``.backward()``); CPU tensors run the plain twins."""
    return _RnnBidirTrain.apply(gx, w_hh)
