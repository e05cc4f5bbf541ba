"""The planes around a recurrent layer's kernels (``models/rnn.py``): a biased
layer's packed mask and the merge of the two directions, each counted by
route once a layer call.  PyTorch ops, no kernel of their own.

- ``shut_input_gate(gx, valid, ndir)``, the packed mask of a biased LSTM
  layer given its batch's lengths (``valid (T, B)``, True below each
  utterance's length): ``gx`` is the bias on a padded row, not 0, so the
  input gate's pre-activation of every padded (frame, row) is set to
  ``GATE_OFF``.  Then i = sigmoid(GATE_OFF) = 0 exactly in fp32, in the
  kernels and in the twins alike, so c = f c_prev + i g and h = o tanh(c)
  stay exactly 0 from a zero state: the backward direction reaches each
  utterance's last frame with zero state, as a packed ``nn.LSTM`` does.
  The derivative i (1 - i) is 0 there too, so no gradient reaches ``gx``,
  the weights or the bias from a padded frame.  The forward direction runs
  on past the utterance's end; the caller zeroes those outputs.  A
  bias-free layer zeroes the padded rows of its input instead (in
  ``models/rnn.py``): with zero state and zero gates its state stays
  exactly zero there;
- ``merge(ys, how, ndir, train)``: ``concat`` keeps the directions side by
  side (the training op's ``ys`` cast to fp32, the eval op's as it is);
  ``sum`` adds them in fp32 (deepspeech.pytorch's ``x.view(T, N, 2,
  -1).sum(2)``), so the layer gives H features and the backward hands the
  same gradient to both halves.

Counts (``ops/launch_counts.py``: a captured graph's replays add what its
capture counted): ``launches_mask``, by the layer's packed mask (``gate``,
``rows`` or ``none``, counted where ``models/rnn.py`` picks it), and
``launches_merge``, dicts by route.
"""

from __future__ import annotations

import torch

# the input gate's pre-activation on a padded frame of a biased layer; exact
# in bf16 (-9984 after rounding) and far past where sigmoid reaches 0
GATE_OFF = -1e4

launches_mask = {"gate": 0, "rows": 0, "none": 0}
launches_merge = {"concat": 0, "sum": 0}


def shut_input_gate(gx: torch.Tensor, valid: torch.Tensor, ndir: int
                    ) -> torch.Tensor:
    """``gx (T, B, ndir * 4H)`` with the input gate's pre-activation set to
    ``GATE_OFF`` where the bool ``valid (T, B)`` is False."""
    t_len, b, lanes = gx.shape
    # lanes (direction, gate i f g o, unit): the i gates of padded frames
    i_gate = (torch.arange(4, device=gx.device) == 0)[:, None]
    off = (~valid)[:, :, None, None, None] & i_gate
    return torch.where(off, GATE_OFF, gx.view(
        t_len, b, ndir, 4, lanes // (4 * ndir))).view(t_len, b, lanes)


def merge(ys: torch.Tensor, how: str, ndir: int, train: bool
          ) -> torch.Tensor:
    """The layer's output from the recurrence's ``ys (T, B, ndir * H)``: the
    directions side by side (``concat``; fp32 in train mode) or added in
    fp32 (``sum``)."""
    launches_merge[how] += 1
    if how == "sum":
        return ys.unflatten(-1, (ndir, -1)).sum(2, dtype=torch.float32)
    return ys.float() if train else ys
