"""Recurrent stack: bias-free bidirectional LSTM or GRU layers with BN
between.

Counterpart of ``ctc_pytorch_tpu/models/rnn.py:254-511`` on the path the
JAX package takes with ``use_pallas_rnn`` (the eval kernels in stage 4, the
trainable ones in stage 2):

- time-major ``(T, B, F)``; weights stored ``w_ih (F, nH)``, ``w_hh (H, nH)``
  per direction, n = 4 gates in order i, f, g, o for the LSTM and n = 3 in
  order r, z, n for the GRU (torch's, transposed);
- the input projection for all steps and both directions is one matmul,
  ``gx = x @ [W_f | W_b]``, in ``compute_dtype`` with fp32 accumulation and
  the result in the stream dtype (``lstm_pallas_v2.py:169-175``,
  ``gru_pallas_v2.py:512-517``);
- the recurrence is ``ops.lstm_bidir`` / ``ops.gru_bidir`` in eval and
  ``ops.lstm_bidir_train`` / ``ops.gru_bidir_train`` (forward and backward
  kernels under autograd) in train mode: the Hopper kernels for CUDA
  tensors, their plain twins for CPU tensors.  The backward direction
  reverses the full padded length, like the reference's unpacked
  ``nn.LSTM``;
- with ``lengths`` the layer has packed-sequence semantics, as the JAX layer
  gives its kernels (``rnn.py:280-294, 314-317, 441-446``): the cells are
  bias-free, so zeroed input rows with zero incoming state keep the state
  exactly zero, and the backward direction arrives at each utterance's last
  frame with zero state.  The padded rows of ``x`` are zeroed before the
  projection and the padded rows of the output after the recurrence; the
  kernels do not change;
- in train mode each layer's output goes through dropout (``rnn.py:447``).

The JAX layer picks between its v2 kernels, its v1 (stacked-layout) kernels
and the scan path by what fits the TPU's VMEM (``rnn.py:349-372, 383-432``);
this card has no such gate, so every shape takes the one kernel of its cell
and pass.  The tanh-RNN cell and unidirectional layers are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ctc_pytorch_tpu_torch.models.layers import BatchNorm, dropout, matmul_stream
from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
from ctc_pytorch_tpu_torch.ops import gru_bidir_train as gru_train_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as lstm_train_ops

# per cell: (gates, eval recurrence, trainable recurrence)
CELLS = {
    "lstm": (4, lstm_ops.lstm_bidir, lstm_train_ops.lstm_bidir_train),
    "gru": (3, gru_ops.gru_bidir, gru_train_ops.gru_bidir_train),
}


def stream_dtype_for(compute_dtype: torch.dtype, b: int) -> torch.dtype:
    """dtype of the gx/ys planes: bf16 when the compute dtype is bf16 and
    B % 16 == 0, else fp32 -- the JAX package's rule
    (``ops/lstm_pallas.py:80-90``), kept so both round at the same points."""
    if compute_dtype == torch.bfloat16 and b % 16 == 0:
        return torch.bfloat16
    return torch.float32


class Direction(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, gates: int = 4):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(input_size, gates * hidden_size))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, gates * hidden_size))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """torch nn.LSTM / nn.GRU default: U(-1/sqrt(H), 1/sqrt(H))."""
        bound = 1.0 / math.sqrt(self.w_hh.shape[0])
        with torch.no_grad():
            self.w_ih.uniform_(-bound, bound, generator=gen)
            self.w_hh.uniform_(-bound, bound, generator=gen)


class RNNLayer(nn.Module):
    """BatchRNN: optional feature BN -> bidirectional LSTM or GRU."""

    def __init__(self, input_size: int, hidden_size: int, batch_norm: bool,
                 cell: str = "lstm"):
        super().__init__()
        self.hidden_size = hidden_size
        gates, self.eval_op, self.train_op = CELLS[cell]
        self.fwd = Direction(input_size, hidden_size, gates)
        self.bwd = Direction(input_size, hidden_size, gates)
        self.bn = BatchNorm(input_size) if batch_norm else None

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                bn_mask: Optional[torch.Tensor] = None,
                drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(T, B, F) -> (T, B, 2H) fp32.  ``lengths`` (B,): valid frames per
        utterance, for packed-sequence semantics."""
        if self.bn is not None:
            x = self.bn(x, bn_mask)
        t_len, b, f = x.shape
        valid = None
        if lengths is not None:
            valid = (torch.arange(t_len, device=x.device)[:, None]
                     < lengths.to(x.device)[None, :]).to(x.dtype)[..., None]
            x = x * valid
        sd = stream_dtype_for(compute_dtype, b)
        w_cat = torch.cat([self.fwd.w_ih, self.bwd.w_ih], dim=1)
        gx = matmul_stream(x.reshape(t_len * b, f), w_cat, compute_dtype, sd)
        w_hh = torch.stack([self.fwd.w_hh, self.bwd.w_hh]).float()
        gx = gx.reshape(t_len, b, -1)
        out = (self.train_op(gx, w_hh).float() if self.training
               else self.eval_op(gx, w_hh))
        if valid is not None:
            out = out * valid
        return dropout(out, drop_rate, generator, self.training)


class RNNStack(nn.ModuleList):
    """Stacked BatchRNNs; the first layer has no BN (``model_ctc.py:126-133``).
    A list, so checkpoint paths read ``rnns.{i}.fwd.w_ih``."""

    def __init__(self, *, cell: str, input_size: int, hidden_size: int,
                 num_layers: int, bidirectional: bool, batch_norm: bool):
        if cell not in CELLS or not bidirectional:
            raise NotImplementedError(
                f"only bidirectional LSTM and GRU layers are ported (got "
                f"cell={cell!r}, bidirectional={bidirectional})"
            )
        super().__init__(
            RNNLayer(input_size if i == 0 else 2 * hidden_size, hidden_size,
                     batch_norm and i > 0, cell)
            for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                bn_mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self:
            x = layer(x, compute_dtype, bn_mask, drop_rate, generator, lengths)
        return x
