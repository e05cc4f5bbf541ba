"""The stacked-layout (v1) entry points of the LSTM, GRU and tanh-RNN
recurrences, as layout wrappers over the Hopper kernels.

The JAX package has two generations of recurrence kernels.  Its v2 kernels
take ``gx (T, B, 2nH)`` with the directions split over lanes and reverse time
inside; they are what ``ops/lstm_bidir*.py`` and ``ops/gru_bidir*.py`` port.
Its v1 kernels stack the directions on the batch axis instead: ``gx (T, 2B,
nH)``, rows ``[0, B)`` the forward direction and rows ``[B, 2B)`` the backward
direction **already time-flipped**, and return ``(T, 2B, H)`` in the same
arrangement.  Each function here is the counterpart of one v1 entry point: it
re-lays its input out, runs the recurrence op of the same cell and pass (the
Hopper kernel for CUDA tensors, or the call raises; the plain twin for CPU
tensors) and lays the result back.  The tanh cell has one v1 entry point per
level for eval and training alike, as in JAX (the forward kernel is shared
and the VJP only changes what autodiff records), so its wrappers run the
trainable op.

| here | JAX (``ctc_pytorch_tpu/ops/``) |
|---|---|
| ``lstm_scan_stacked`` / ``lstm_bidir_stacked`` | ``lstm_pallas.py:169 lstm_scan_pallas`` / ``:218 lstm_bidir_pallas`` |
| ``lstm_scan_train_stacked`` / ``lstm_bidir_train_stacked`` | ``lstm_pallas_train.py:325 lstm_scan_train`` / ``:457 lstm_bidir_train`` |
| ``gru_scan_stacked`` / ``gru_bidir_stacked`` | ``gru_pallas.py:94 gru_scan_pallas`` / ``:138 gru_bidir_pallas`` |
| ``gru_scan_train_stacked`` / ``gru_bidir_train_stacked`` | ``gru_pallas_train.py:277 gru_scan_train`` / ``:350 gru_bidir_train`` |
| ``rnn_scan_train_stacked`` / ``rnn_bidir_stacked`` | ``rnn_pallas.py:224 rnn_scan_train`` / ``:268 rnn_bidir_pallas`` |

The model never dispatches to them.  The JAX layer falls from its v2 kernels
to these and then to the scan path by what fits the TPU's VMEM
(``models/rnn.py:349-372, 383-432``); that gate has no counterpart on this
card, where one kernel per cell and pass takes every shape.  They exist so
that every entry point of the JAX package has its counterpart, held against
its own JAX function.

Rounding: in fp32 the functions are the same.  With bf16 streams the v1
kernels round at other points than the v2 kernels that the Hopper kernels
follow: v1 picks the stream dtype by ``2B % 16`` (kept here), keeps ``w_hh``
fp32 in the forward (the Hopper GRU and tanh kernels and the trainable LSTM
kernel round it to bf16) and, for the LSTM and GRU, rounds it only in the
backward.  The tanh v1 kernels keep ``w_hh`` fp32 in both passes and round
neither h nor ``dpre`` before their products (``rnn_pallas.py:43-46,
144-152``), where the Hopper tanh kernels round all three.  The results then
agree with JAX's v1 to a few bf16 ulps, not bit for bit; no second kernel
chases v1's roundings.
"""

from __future__ import annotations

from typing import Callable

import torch

from ctc_pytorch_tpu_torch.models.layers import matmul_stream
from ctc_pytorch_tpu_torch.models.rnn import stream_dtype_for
from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
from ctc_pytorch_tpu_torch.ops import gru_bidir_train as gru_train_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as lstm_train_ops
from ctc_pytorch_tpu_torch.ops import rnn_bidir_train as rnn_train_ops


# calls that reached ``_scan``, on any device (the kernels' own launch counts
# are the ops'): a run that must not come through here reads it before and after
calls = 0


def lanes_from_stacked(gx: torch.Tensor) -> torch.Tensor:
    """``(T, 2B, n)`` stacked, second half time-flipped -> ``(T, B, 2n)`` with
    both directions in forward-time order."""
    b = gx.shape[1] // 2
    return torch.cat([gx[:, :b], gx[:, b:].flip(0)], dim=-1)


def stacked_from_lanes(ys: torch.Tensor) -> torch.Tensor:
    """``(T, B, 2n)`` -> ``(T, 2B, n)`` stacked, second half time-flipped."""
    n = ys.shape[-1] // 2
    return torch.cat([ys[..., :n], ys[..., n:].flip(0)], dim=1)


def _scan(op: Callable, gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Run a lane-layout recurrence op on stacked ``gx (T, 2B, nH)``; ``ys (T,
    2B, H)`` in ``gx``'s dtype (the ops' outputs are already rounded to it)."""
    global calls
    calls += 1
    if gx.shape[1] % 2:
        raise ValueError(f"stacked gx needs an even batch axis (2B), got "
                         f"{tuple(gx.shape)}")
    ys = op(lanes_from_stacked(gx), w_hh.float())
    return stacked_from_lanes(ys).to(gx.dtype)


def lstm_scan_stacked(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """``gx (T, 2B, 4H)``, ``w_hh (2, H, 4H)`` -> ``(T, 2B, H)``: the eval
    BiLSTM recurrence (``lstm_scan_pallas``) through ``ops.lstm_bidir``."""
    return _scan(lstm_ops.lstm_bidir, gx, w_hh)


def lstm_scan_train_stacked(gx: torch.Tensor, w_hh: torch.Tensor
                            ) -> torch.Tensor:
    """The trainable BiLSTM recurrence (``lstm_scan_train``), differentiable
    in both arguments, through ``ops.lstm_bidir_train``."""
    return _scan(lstm_train_ops.lstm_bidir_train, gx, w_hh)


def gru_scan_stacked(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """``gx (T, 2B, 3H)``, ``w_hh (2, H, 3H)`` -> ``(T, 2B, H)``: the eval
    BiGRU recurrence (``gru_scan_pallas``) through ``ops.gru_bidir``."""
    return _scan(gru_ops.gru_bidir, gx, w_hh)


def gru_scan_train_stacked(gx: torch.Tensor, w_hh: torch.Tensor
                           ) -> torch.Tensor:
    """The trainable BiGRU recurrence (``gru_scan_train``), differentiable in
    both arguments, through ``ops.gru_bidir_train``."""
    return _scan(gru_train_ops.gru_bidir_train, gx, w_hh)


def rnn_scan_train_stacked(gx: torch.Tensor, w_hh: torch.Tensor
                           ) -> torch.Tensor:
    """``gx (T, 2B, H)``, ``w_hh (2, H, H)`` -> ``(T, 2B, H)``: the tanh
    recurrence (``rnn_scan_train``), for eval and training, differentiable in
    both arguments, through ``ops.rnn_bidir_train``."""
    return _scan(rnn_train_ops.rnn_bidir_train, gx, w_hh)


def _bidir(scan: Callable, x: torch.Tensor, w_ih: torch.Tensor,
           w_hh: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """A whole layer the v1 way: project ``x`` and its time-flip, stack them
    on the batch axis, scan, and lay the halves side by side again."""
    t_len, b, f = x.shape
    sd = stream_dtype_for(compute_dtype, 2 * b)
    gx = [matmul_stream(xd.reshape(t_len * b, f), w, compute_dtype, sd)
          .reshape(t_len, b, -1) for xd, w in ((x, w_ih[0]), (x.flip(0), w_ih[1]))]
    ys = scan(torch.cat(gx, dim=1), w_hh)
    return torch.cat([ys[:, :b], ys[:, b:].flip(0)], dim=-1).float()


def lstm_bidir_stacked(x, w_ih, w_hh, compute_dtype=torch.float32):
    """``x (T, B, F)``, ``w_ih (2, F, 4H)``, ``w_hh (2, H, 4H)`` -> ``(T, B,
    2H)`` fp32 (``lstm_bidir_pallas``)."""
    return _bidir(lstm_scan_stacked, x, w_ih, w_hh, compute_dtype)


def lstm_bidir_train_stacked(x, w_ih, w_hh, compute_dtype=torch.float32):
    """The trainable layer (``lstm_bidir_train``)."""
    return _bidir(lstm_scan_train_stacked, x, w_ih, w_hh, compute_dtype)


def gru_bidir_stacked(x, w_ih, w_hh, compute_dtype=torch.float32):
    """``x (T, B, F)``, ``w_ih (2, F, 3H)``, ``w_hh (2, H, 3H)`` -> ``(T, B,
    2H)`` fp32 (``gru_bidir_pallas``)."""
    return _bidir(gru_scan_stacked, x, w_ih, w_hh, compute_dtype)


def gru_bidir_train_stacked(x, w_ih, w_hh, compute_dtype=torch.float32):
    """The trainable layer (``gru_bidir_train``)."""
    return _bidir(gru_scan_train_stacked, x, w_ih, w_hh, compute_dtype)


def rnn_bidir_stacked(x, w_ih, w_hh, compute_dtype=torch.float32, train=False):
    """``x (T, B, F)``, ``w_ih (2, F, H)``, ``w_hh (2, H, H)`` -> ``(T, B,
    2H)`` fp32, differentiable (``rnn_bidir_pallas``).  ``train`` is the JAX
    signature's: that function, and this one, compute the same in both
    modes."""
    del train
    return _bidir(rnn_scan_train_stacked, x, w_ih, w_hh, compute_dtype)
