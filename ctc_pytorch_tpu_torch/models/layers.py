"""Shared layers: feature-axis batch-norm and the bias-free linear.

Counterpart of ``ctc_pytorch_tpu/models/layers.py:37-152``.  Parameters and
BN running statistics keep the JAX package's names and layouts (``scale``,
``bias``, ``mean``, ``var``, ``count``; linear weight stored ``(in, out)``),
so a checkpoint leaf maps onto a ``state_dict`` key by its tree path alone
(``train/checkpoint.py``).  Only the eval path exists here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with operands rounded to ``compute_dtype`` and an fp32
    result: ``jnp.dot(..., preferred_element_type=float32)``.

    On the card a 16-bit ``compute_dtype`` runs one cuBLAS GEMM on the
    tensor cores with fp32 accumulation and an fp32 result (``out_dtype``).
    PyTorch has that GEMM only for CUDA, so on the CPU the rounded operands
    are multiplied in fp32: products of bf16 values are exact in fp32, so
    that is the same fp32 accumulation."""
    a, b = a.to(compute_dtype), b.to(compute_dtype)
    if compute_dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of ``x`` (any leading shape), eval mode.

    ``mask``: optional 0/1 validity over the leading positions; invalid
    positions are zeroed after normalisation (``layers.py:109-110``), so a
    bias-free recurrence downstream sees exact zeros through padding.
    The ``count`` buffer is the number of train-time updates (checkpoint
    contract; train mode comes with the training slice).
    """

    def __init__(self, dim: int, with_count: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        if with_count:
            self.register_buffer("count", torch.zeros((), dtype=torch.int32))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.eps)
        out = (x.float() - self.mean) * (inv * self.scale) + self.bias
        if mask is not None:
            out = out * mask.reshape(x.shape[:-1] + (1,)).to(out.dtype)
        return out.to(x.dtype)


class Linear(nn.Module):
    """Bias-free linear with the weight stored ``(in, out)`` as in JAX;
    operands in ``compute_dtype``, fp32 result (``layers.py:144-152``)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim))

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return matmul_f32(x, self.w, compute_dtype)
