"""Kernels and host-side numeric helpers.

``lstm_bidir``: the Hopper BiLSTM recurrence for eval (``csrc/lstm_bidir.cu``).
``lstm_bidir_train``: the trainable recurrence, forward and backward kernels
(``csrc/lstm_bidir_train.cu``).  ``gru_bidir`` and ``gru_bidir_train``: the
same for the BiGRU (``csrc/gru_bidir.cu``: the forward of both;
``csrc/gru_bidir_train.cu``: the backward).
``ctc_loss``: the CTC loss over the alpha and beta DP kernels
(``csrc/ctc_dp.cu``).  Each stands beside its plain PyTorch twin; ``_build``
compiles and loads the sources at first use.  ``stacked``: the JAX package's
stacked-layout (v1) recurrence entry points as layout wrappers over those
kernels.  ``editdistance``: a numpy copy of the JAX package's Levenshtein DP.
"""
