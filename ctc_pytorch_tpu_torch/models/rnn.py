"""Recurrent stack: bias-free bidirectional LSTM layers with BN between.

Counterpart of ``ctc_pytorch_tpu/models/rnn.py:254-511`` on the path the
JAX package takes with ``use_pallas_rnn`` (the eval LSTM kernel in stage 4,
the trainable one in stage 2):

- time-major ``(T, B, F)``; weights stored ``w_ih (F, 4H)``, ``w_hh (H, 4H)``
  per direction, gate order i, f, g, o (torch's, transposed);
- the input projection for all steps and both directions is one matmul,
  ``gx = x @ [W_f | W_b]``, in ``compute_dtype`` with fp32 accumulation and
  the result in the stream dtype (``lstm_pallas_v2.py:169-175``);
- the recurrence is ``ops.lstm_bidir`` in eval and ``ops.lstm_bidir_train``
  (forward and backward kernels under autograd) in train mode: the Hopper
  kernels for CUDA tensors, their plain twins for CPU tensors.  The
  backward direction reverses the full padded length, like the reference's
  unpacked ``nn.LSTM``;
- in train mode each layer's output goes through dropout (``rnn.py:447``).

GRU and tanh-RNN cells, unidirectional layers and the packed ``lengths``
mode are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ctc_pytorch_tpu_torch.models.layers import BatchNorm, dropout, matmul_f32
from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as lstm_train_ops


def stream_dtype_for(compute_dtype: torch.dtype, b: int) -> torch.dtype:
    """dtype of the gx/ys planes: bf16 when the compute dtype is bf16 and
    B % 16 == 0, else fp32 -- the JAX package's rule
    (``ops/lstm_pallas.py:80-90``), kept so both round at the same points."""
    if compute_dtype == torch.bfloat16 and b % 16 == 0:
        return torch.bfloat16
    return torch.float32


class Direction(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(input_size, 4 * hidden_size))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """torch nn.LSTM default: U(-1/sqrt(H), 1/sqrt(H))."""
        bound = 1.0 / math.sqrt(self.w_hh.shape[0])
        with torch.no_grad():
            self.w_ih.uniform_(-bound, bound, generator=gen)
            self.w_hh.uniform_(-bound, bound, generator=gen)


class RNNLayer(nn.Module):
    """BatchRNN: optional feature BN -> bidirectional LSTM."""

    def __init__(self, input_size: int, hidden_size: int, batch_norm: bool):
        super().__init__()
        self.hidden_size = hidden_size
        self.fwd = Direction(input_size, hidden_size)
        self.bwd = Direction(input_size, hidden_size)
        self.bn = BatchNorm(input_size) if batch_norm else None

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                bn_mask: Optional[torch.Tensor] = None,
                drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(T, B, F) -> (T, B, 2H) fp32."""
        if self.bn is not None:
            x = self.bn(x, bn_mask)
        t_len, b, f = x.shape
        sd = stream_dtype_for(compute_dtype, b)
        w_cat = torch.cat([self.fwd.w_ih, self.bwd.w_ih], dim=1).to(compute_dtype)
        x2 = x.reshape(t_len * b, f).to(compute_dtype)
        # products in compute_dtype, summed in fp32, result in the stream dtype
        gx = (torch.matmul(x2, w_cat) if sd == compute_dtype
              else matmul_f32(x2, w_cat, compute_dtype))
        w_hh = torch.stack([self.fwd.w_hh, self.bwd.w_hh]).float()
        gx = gx.reshape(t_len, b, -1)
        if not self.training:
            return lstm_ops.lstm_bidir(gx, w_hh)
        out = lstm_train_ops.lstm_bidir_train(gx, w_hh).float()
        return dropout(out, drop_rate, generator, True)


class RNNStack(nn.ModuleList):
    """Stacked BatchRNNs; the first layer has no BN (``model_ctc.py:126-133``).
    A list, so checkpoint paths read ``rnns.{i}.fwd.w_ih``."""

    def __init__(self, *, cell: str, input_size: int, hidden_size: int,
                 num_layers: int, bidirectional: bool, batch_norm: bool):
        if cell != "lstm" or not bidirectional:
            raise NotImplementedError(
                f"only bidirectional LSTM layers are ported (got cell={cell!r}, "
                f"bidirectional={bidirectional})"
            )
        super().__init__(
            RNNLayer(input_size if i == 0 else 2 * hidden_size, hidden_size,
                     batch_norm and i > 0)
            for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                bn_mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if lengths is not None:
            raise NotImplementedError(
                "the packed-sequence `lengths` mode is not ported yet")
        for layer in self:
            x = layer(x, compute_dtype, bn_mask, drop_rate, generator)
        return x
