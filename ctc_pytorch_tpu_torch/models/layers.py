"""Shared layers: feature-axis batch-norm, dropout and the bias-free linear.

Counterpart of ``ctc_pytorch_tpu/models/layers.py:37-152``.  Parameters and
BN running statistics keep the JAX package's names and layouts (``scale``,
``bias``, ``mean``, ``var``, ``count``; linear weight stored ``(in, out)``),
so a checkpoint leaf maps onto a ``state_dict`` key by its tree path alone
(``train/checkpoint.py``).  Train mode is the module's ``training`` flag; it
updates the running statistics in place.  With a data-parallel ``group``
(``parallel/mesh.py``) the train-mode statistics are the whole global
batch's: the count and the sums of x and x * x are summed over the ranks in
one differentiable collective before they become the mean and variance
(the JAX ``psum`` over ``axis_name``, ``layers.py:80-91``), so the input
gradient on each rank holds every rank's term, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ctc_pytorch_tpu_torch.parallel.mesh import DataGroup, all_sum


class _Matmul16F32(torch.autograd.Function):
    """``a @ b`` for 16-bit operands with fp32 sums and an fp32 result.

    The gradients follow ``jnp.dot(..., preferred_element_type=float32)``:
    the fp32 cotangent meets the other operand in fp32 and the product is
    rounded to the operand's 16-bit dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            # one tensor-core GEMM with fp32 accumulation and result
            return torch.mm(a, b, out_dtype=torch.float32)
        # products of 16-bit values are exact in fp32: the same sums
        return torch.mm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        return ((g @ b.float().t()).to(a.dtype),
                (a.float().t() @ g).to(b.dtype))


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with operands rounded to ``compute_dtype`` and an fp32
    result: ``jnp.dot(..., preferred_element_type=float32)``.

    On the card a 16-bit ``compute_dtype`` runs one cuBLAS GEMM on the
    tensor cores with fp32 accumulation and an fp32 result (``out_dtype``).
    PyTorch has that GEMM only for CUDA, so on the CPU the rounded operands
    are multiplied in fp32: products of bf16 values are exact in fp32, so
    that is the same fp32 accumulation.  Differentiable in both operands."""
    a, b = a.to(compute_dtype), b.to(compute_dtype)
    if compute_dtype == torch.float32:
        return torch.matmul(a, b)
    out = _Matmul16F32.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def matmul_stream(a: torch.Tensor, b: torch.Tensor, compute_dtype: torch.dtype,
                  stream_dtype: torch.dtype,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a @ b`` with operands rounded to ``compute_dtype``, fp32 sums and the
    result in ``stream_dtype``: ``dot_general(..., preferred_element_type=
    stream_dtype)``, the recurrent layers' input projection.  The stream dtype
    is ``compute_dtype`` or fp32 (``models/rnn.py:stream_dtype_for``).
    ``bias`` (fp32, ``b``'s columns), for a 2-D ``a``: added before the one
    rounding to the stream dtype (the GEMM's epilogue, the bias rounded to
    ``compute_dtype`` as an operand) where that is ``compute_dtype``, else
    added to the fp32 result."""
    a, b = a.to(compute_dtype), b.to(compute_dtype)
    if stream_dtype == compute_dtype:
        if bias is not None:
            return torch.addmm(bias.to(compute_dtype), a, b)
        return torch.matmul(a, b)
    out = matmul_f32(a, b, compute_dtype)
    return out if bias is None else out + bias


def stats_from_sums(s1: torch.Tensor, s2: torch.Tensor, n: torch.Tensor):
    """Mean, biased and unbiased variance per channel from the masked sums
    of x and x * x over ``n`` positions (0-d), ``n = max(n, 1)``
    (``layers.py:75-98``)."""
    n = torch.clamp(n, min=1.0)
    mean = s1 / n
    var = s2 / n - mean * mean
    return mean, var, var * (n / torch.clamp(n - 1.0, min=1.0))


def synced_sums(group: Optional[DataGroup], *parts: torch.Tensor) -> list:
    """``parts`` summed over ``group`` in one differentiable collective
    (unchanged without a group)."""
    if group is None:
        return list(parts)
    flat = all_sum(torch.cat([p.reshape(-1) for p in parts]), group)
    return [t.view_as(p) for t, p in
            zip(flat.split([p.numel() for p in parts]), parts)]


def global_stats(s1: torch.Tensor, s2: torch.Tensor, n: int):
    """``stats_from_sums`` over a fixed count ``n`` (the unmasked statistics
    of a global batch: each rank's positions times the world)."""
    mean = s1 / n
    var = s2 / n - mean * mean
    return mean, var, var * (n / max(n - 1, 1))


def update_running(buf_mean: torch.Tensor, buf_var: torch.Tensor,
                   mean: torch.Tensor, unbiased: torch.Tensor,
                   momentum: float) -> None:
    """In-place running-statistics update (torch's BN convention: the
    running variance takes the unbiased estimate)."""
    with torch.no_grad():
        buf_mean.mul_(1 - momentum).add_(momentum * mean.detach())
        buf_var.mul_(1 - momentum).add_(momentum * unbiased.detach())


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout with the keep probability quantised to n/256, as the
    JAX package's byte-threshold mask (``layers.py:125-133``): rate 0.2
    keeps 205/256 and scales by 256/205, so the expectation is exact.  The
    mask is drawn from ``generator`` (which must live on ``x``'s device);
    train mode with a positive rate and no generator raises."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError(
            f"dropout at rate {rate} in train mode needs a torch.Generator; "
            "set drop_out to 0 to train without dropout")
    thresh = min(max(int(round((1.0 - rate) * 256.0)), 1), 255)
    bits = torch.randint(0, 256, x.shape, generator=generator, device=x.device,
                         dtype=torch.uint8)
    keep_q = thresh / 256.0
    return torch.where(bits < thresh, x / keep_q, torch.zeros_like(x))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of ``x`` (any leading shape).

    ``mask``: optional 0/1 validity over the leading positions.  In train
    mode the batch statistics cover valid positions only; invalid positions
    are zeroed after normalisation in train and eval (``layers.py:109-110``),
    so a bias-free recurrence downstream sees exact zeros through padding.
    Train mode normalises with the batch's biased variance and moves the
    running ``mean``/``var`` (unbiased) with ``momentum``; ``count`` is the
    number of such updates (``layers.py:74-103``).  ``update=False`` takes
    the batch statistics and leaves the buffers as they are: a remat
    layer's recompute (``models/rnn.py``), whose update its forward made.
    """

    def __init__(self, dim: int, with_count: bool = True, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        if with_count:
            self.register_buffer("count", torch.zeros((), dtype=torch.int32))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group: Optional[DataGroup] = None,
                update: bool = True) -> torch.Tensor:
        mean, var = self.mean, self.var
        if self.training:
            flat = x.float().reshape(-1, x.shape[-1])
            if mask is not None:
                m = mask.reshape(-1, 1).to(flat.dtype)
                s1, s2, n = synced_sums(group, (flat * m).sum(0),
                                        (flat * flat * m).sum(0), m.sum())
                mean, var, unbiased = stats_from_sums(s1, s2, n)
            elif group is not None:
                s1, s2 = synced_sums(group, flat.sum(0), (flat * flat).sum(0))
                mean, var, unbiased = global_stats(
                    s1, s2, flat.shape[0] * group.world)
            else:
                n = flat.shape[0]
                mean = flat.mean(0)
                var = flat.var(0, unbiased=False)
                unbiased = var * (n / max(n - 1, 1))
            if update:
                update_running(self.mean, self.var, mean, unbiased,
                               self.momentum)
                if hasattr(self, "count"):
                    self.count += 1
        inv = torch.rsqrt(var + self.eps)
        out = (x.float() - mean) * (inv * self.scale) + self.bias
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
