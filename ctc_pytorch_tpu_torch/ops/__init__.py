"""Kernels and host-side numeric helpers.

``lstm_bidir``: the Hopper BiLSTM recurrence (``csrc/lstm_bidir.cu``) with
its plain PyTorch twin.  ``editdistance``: a numpy copy of the JAX
package's Levenshtein DP.
"""
