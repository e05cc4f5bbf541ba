"""Kernels and host-side numeric helpers.

``lstm_bidir``: the Hopper LSTM recurrence for eval (``csrc/lstm_bidir.cu``).
``lstm_bidir_train``: the trainable recurrence, forward and backward kernels
(``csrc/lstm_bidir_train.cu``).  ``gru_bidir`` and ``gru_bidir_train``: the
same for the GRU (``csrc/gru_bidir.cu``: the forward of both;
``csrc/gru_bidir_train.cu``: the backward); ``rnn_bidir`` and
``rnn_bidir_train``: for the tanh cell (``csrc/rnn_bidir.cu``,
``csrc/rnn_bidir_train.cu``).  Every recurrence kernel takes one direction or
two.  ``ctc_loss``: the CTC loss as one forward and one backward kernel
(``csrc/ctc_dp.cu``).  Each stands beside its plain PyTorch twin; ``_build``
compiles and loads the sources at first use.  ``stacked``: the JAX package's
stacked-layout (v1) recurrence entry points as layout wrappers over those
kernels.  ``editdistance``: a numpy copy of the JAX package's Levenshtein DP,
its batched form on the host (native C++, with a numpy twin) and on the
device.  ``launch_counts``: the kernels' launch counters as one record,
which captured CUDA graphs add to at each replay.
"""

# the JAX package's ``ops`` exports that are functions (its ``ctc_loss`` is
# this package's module of that name; the function is ``ctc_loss.ctc_loss``)
from ctc_pytorch_tpu_torch.ops.ctc_loss import ctc_forward_score  # noqa: E402,F401
from ctc_pytorch_tpu_torch.ops.editdistance import (  # noqa: E402,F401
    batch_edit_distance,
    edit_distance,
)
