"""Recurrent stack: bias-free LSTM, GRU or tanh-RNN layers, bidirectional
or not, with BN between; or DeepSpeech2's layers: biased LSTM cells, packed,
their two directions summed.

Counterpart of ``ctc_pytorch_tpu/models/rnn.py:254-511`` on the path the
JAX package takes with ``use_pallas_rnn`` (the eval kernels in stage 4, the
trainable ones in stage 2):

- time-major ``(T, B, F)``; weights stored ``w_ih (F, nH)``, ``w_hh (H, nH)``
  per direction, n = 4 gates in order i, f, g, o for the LSTM, n = 3 in
  order r, z, n for the GRU and n = 1 for the tanh cell (torch's,
  transposed);
- the input projection for all steps and directions is one matmul, ``gx = x
  @ [W_f | W_b]`` (``x @ W_f`` with one direction), in ``compute_dtype`` with
  fp32 accumulation and the result in the stream dtype
  (``lstm_pallas_v2.py:169-175``, ``gru_pallas_v2.py:512-517``,
  ``rnn_pallas_v2.py:353-358``);
- the recurrence is the cell's eval op (``ops.lstm_bidir``,
  ``ops.gru_bidir``, ``ops.rnn_bidir``) in eval and its trainable op
  (``ops.*_bidir_train``: forward and backward kernels under autograd) in
  train mode: the Hopper kernels for CUDA tensors, their plain twins for CPU
  tensors.  The backward direction reverses the full padded length, like the
  reference's unpacked ``nn.LSTM``;
- a unidirectional layer (``bidirectional: False``) runs the same kernels
  with one direction.  The JAX package runs it on its scan path
  (``_scan_direction``, ``rnn.py:167-202, 437-440``), which keeps ``gx`` and
  the carries fp32 and rounds only the product operands (h and ``w_hh``) to
  ``compute_dtype``.  The port keeps the bidirectional layers' rule instead:
  with bf16 streams (``compute_dtype`` bf16 and B % 16 == 0) ``gx`` and
  ``ys`` are stored in bf16 too, and with fp32 streams no operand is
  rounded.  In fp32 the two compute the same function; in bf16 they differ
  by those roundings (``tests/test_torch_unidir.py`` holds the difference);
- with ``lengths`` the layer has packed-sequence semantics, as the JAX layer
  gives its kernels (``rnn.py:280-294, 314-317, 441-446``): the cells are
  bias-free, so zeroed input rows with zero incoming state keep the state
  exactly zero (``tanh(0) = 0``), and the backward direction arrives at each
  utterance's last frame with zero state.  The padded rows of ``x`` are
  zeroed before the projection and the padded rows of the output after the
  recurrence; the kernels do not change.  With one direction this is the
  JAX package's ``_scan_direction`` followed by its mask;
- DeepSpeech2's ``BatchRNN`` (deepspeech.pytorch ``model.py``), with no
  JAX counterpart: ``bias`` gives each direction one bias ``b (4H)``, the
  sum of ``nn.LSTM``'s ``b_ih`` and ``b_hh``, folded into the input
  projection (cuBLAS's bias epilogue with bf16 streams, one add with fp32
  ones); the kernels stay bias-free.  With ``lengths`` the biased layer is
  packed by its gates, not by zeroed rows (``ops/rnn_io.py``, route
  ``gate``): the input gate is shut on every padded frame, so the state
  stays exactly zero there.  ``merge="sum"`` adds the two directions'
  outputs (``ops/rnn_io.py``), so the layer gives H features and the next
  layer's BN and projection take H.  Both are fixed when the layer is built;
  at their defaults (``concat``, no bias) the layer runs the ops it ran
  before them;
- in train mode each layer's output goes through dropout (``rnn.py:447``);
- with ``remat`` (the config's ``remat``) each layer in train mode runs
  under ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
  JAX ``jax.checkpoint(rnn_layer_apply)`` (``rnn.py:504-507``): the
  forward keeps the layer's input and nothing from inside the region (BN,
  input projection, recurrence, output mask), so neither the projection's
  operands nor the recurrence's saved planes (the LSTM's ``gx``, ``ys``,
  ``cs``; the GRU's ``gx``, ``ys``; the tanh cell's ``ys``) outlive the
  forward; the backward recomputes the region, launching the projection
  GEMM and the training forward kernel a second time, then runs the
  backward kernels as without remat.  The recompute takes the BN's batch
  statistics again but leaves its running buffers alone (the forward moved
  them once; JAX discards the recomputed state), decided per call, so a
  captured step holds one update.  Dropout, the layer's only random draw,
  stays outside the region: a recompute draws nothing, and the region
  neither saves nor restores an RNG state (``preserve_rng_state=False``),
  so nothing reads a generator's state inside a graph capture.  Results
  are bit for bit those without remat;
- with a data-parallel ``group`` each layer's BN takes the global batch's
  statistics (``layers.py:BatchNorm``); under remat its recompute sums
  them over the group again, as every rank does.  The stream dtype is
  chosen from the rank's own (local) B, as JAX chooses it inside
  ``shard_map``: the 863 recipes' B=16 on two ranks is B=8 a rank and runs
  fp32 streams, where one process at B=16 runs bf16 ones.

The JAX layer picks between its v2 kernels, its v1 (stacked-layout) kernels
and the scan path by what fits the TPU's VMEM (``rnn.py:320-372, 383-432``);
this card has no such gate, so every shape takes the one kernel of its cell
and pass.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ctc_pytorch_tpu_torch.models.layers import BatchNorm, dropout, matmul_stream
from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
from ctc_pytorch_tpu_torch.ops import gru_bidir_train as gru_train_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as lstm_train_ops
from ctc_pytorch_tpu_torch.ops import rnn_bidir as rnn_ops
from ctc_pytorch_tpu_torch.ops import rnn_bidir_train as rnn_train_ops
from ctc_pytorch_tpu_torch.ops import rnn_io
from ctc_pytorch_tpu_torch.parallel.mesh import DataGroup

# per cell: (gates, eval recurrence, trainable recurrence)
CELLS = {
    "lstm": (4, lstm_ops.lstm_bidir, lstm_train_ops.lstm_bidir_train),
    "gru": (3, gru_ops.gru_bidir, gru_train_ops.gru_bidir_train),
    "rnn": (1, rnn_ops.rnn_bidir, rnn_train_ops.rnn_bidir_train),
}


def stream_dtype_for(compute_dtype: torch.dtype, b: int) -> torch.dtype:
    """dtype of the gx/ys planes: bf16 when the compute dtype is bf16 and
    B % 16 == 0, else fp32 -- the JAX package's rule
    (``ops/lstm_pallas.py:80-90``), kept so both round at the same points."""
    if compute_dtype == torch.bfloat16 and b % 16 == 0:
        return torch.bfloat16
    return torch.float32


class Direction(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, gates: int = 4,
                 bias: bool = False):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(input_size, gates * hidden_size))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, gates * hidden_size))
        # b_ih + b_hh of nn.LSTM, gates in its order
        self.b = (nn.Parameter(torch.empty(gates * hidden_size)) if bias
                  else None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """torch nn.LSTM / nn.GRU / nn.RNN default: U(-1/sqrt(H), 1/sqrt(H));
        the bias is the sum of two such draws, as b_ih + b_hh."""
        bound = 1.0 / math.sqrt(self.w_hh.shape[0])
        with torch.no_grad():
            self.w_ih.uniform_(-bound, bound, generator=gen)
            self.w_hh.uniform_(-bound, bound, generator=gen)
            if self.b is not None:
                self.b.uniform_(-bound, bound, generator=gen)
                self.b.add_(torch.empty_like(self.b).uniform_(
                    -bound, bound, generator=gen))


class RNNLayer(nn.Module):
    """BatchRNN: optional feature BN -> LSTM, GRU or tanh RNN, over both
    directions (``fwd`` and ``bwd``) or the forward one alone, joined side
    by side or (``merge="sum"``) added; ``bias``: biased LSTM cells."""

    def __init__(self, input_size: int, hidden_size: int, batch_norm: bool,
                 cell: str = "lstm", bidirectional: bool = True,
                 merge: str = "concat", bias: bool = False):
        super().__init__()
        if cell not in CELLS:
            raise ValueError(f"unknown cell {cell!r}: one of {sorted(CELLS)}")
        if bias and cell != "lstm":
            raise ValueError("biased cells are the LSTM's: a padded frame "
                             "is shut by its input gate")
        if merge not in ("concat", "sum") or (merge == "sum"
                                              and not bidirectional):
            raise ValueError(f"merge {merge!r}: 'concat', or 'sum' of two "
                             "directions")
        self.hidden_size = hidden_size
        self.merge = merge
        self.biased = bias
        gates, self.eval_op, self.train_op = CELLS[cell]
        self.fwd = Direction(input_size, hidden_size, gates, bias)
        self.bwd = (Direction(input_size, hidden_size, gates, bias)
                    if bidirectional else None)
        self.bn = BatchNorm(input_size) if batch_norm else None

    @property
    def directions(self) -> list:
        return [self.fwd] if self.bwd is None else [self.fwd, self.bwd]

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                bn_mask: Optional[torch.Tensor] = None,
                drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                lengths: Optional[torch.Tensor] = None,
                group: Optional[DataGroup] = None,
                remat: bool = False) -> torch.Tensor:
        """(T, B, F) -> (T, B, dirs * H) fp32.  ``lengths`` (B,): valid frames
        per utterance, for packed-sequence semantics.  ``remat``: recompute
        the layer in the backward pass (train mode with grad enabled;
        otherwise there is nothing to keep and it changes nothing)."""
        if remat and self.training and torch.is_grad_enabled():
            runs = []

            def region(x_in):
                # the forward's run moves the BN buffers, the recompute not
                runs.append(None)
                return self._region(x_in, compute_dtype, bn_mask, lengths,
                                    group, update_bn=len(runs) == 1)

            out = checkpoint(region, x, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = self._region(x, compute_dtype, bn_mask, lengths, group)
        return dropout(out, drop_rate, generator, self.training)

    def _region(self, x, compute_dtype, bn_mask, lengths, group,
                update_bn: bool = True) -> torch.Tensor:
        """The layer up to its dropout: BN, input projection, recurrence and
        the output mask (the region a remat layer recomputes)."""
        if self.bn is not None:
            x = self.bn(x, bn_mask, group, update=update_bn)
        t_len, b, f = x.shape
        valid = None
        mask = "none"  # the packed mask (ops/rnn_io.py), counted a call
        if lengths is not None:
            valid = (torch.arange(t_len, device=x.device)[:, None]
                     < lengths.to(x.device)[None, :])
            mask = "gate" if self.biased else "rows"
        rnn_io.launches_mask[mask] += 1
        vm = None if valid is None else valid.to(x.dtype)[..., None]
        if mask == "rows":
            x = x * vm
        sd = stream_dtype_for(compute_dtype, b)
        dirs = self.directions
        w_cat = torch.cat([d.w_ih for d in dirs], dim=1)
        bias = torch.cat([d.b for d in dirs]) if self.biased else None
        gx = matmul_stream(x.reshape(t_len * b, f), w_cat, compute_dtype, sd,
                           bias)
        w_hh = torch.stack([d.w_hh for d in dirs]).float()
        gx = gx.reshape(t_len, b, -1)
        if mask == "gate":
            gx = rnn_io.shut_input_gate(gx, valid, len(dirs))
        op = self.train_op if self.training else self.eval_op
        out = rnn_io.merge(op(gx, w_hh), self.merge, len(dirs), self.training)
        if vm is not None:
            out = out * vm
        return out


class RNNStack(nn.ModuleList):
    """Stacked BatchRNNs; the first layer has no BN (``model_ctc.py:126-133``).
    A list, so checkpoint paths read ``rnns.{i}.fwd.w_ih``."""

    def __init__(self, *, cell: str, input_size: int, hidden_size: int,
                 num_layers: int, bidirectional: bool, batch_norm: bool,
                 merge: str = "concat", bias: bool = False):
        out = hidden_size if merge == "sum" or not bidirectional else \
            2 * hidden_size
        super().__init__(
            RNNLayer(input_size if i == 0 else out, hidden_size,
                     batch_norm and i > 0, cell, bidirectional, merge, bias)
            for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                bn_mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                group: Optional[DataGroup] = None,
                remat: bool = False) -> torch.Tensor:
        for layer in self:
            x = layer(x, compute_dtype, bn_mask, drop_rate, generator, lengths,
                      group, remat)
        return x
