"""Convolutional front-end: Conv2d -> BatchNorm2d -> activation -> optional
max-pool -> dropout per layer, over NCHW ``(B, C, T, F)`` planes.

Counterpart of ``ctc_pytorch_tpu/models/cnn.py:162-268``.  The JAX stack
runs channels-last and swaps some strided convs for a space-to-depth
formulation (a TPU matrix-unit trick with identical outputs); here every
layer is a plain ``F.conv2d``.  Planes stay in ``compute_dtype`` as in JAX,
with the conv output rounded before the bias add and BN computed in fp32
and cast back, so bf16 rounding happens at the same points.  Everything
between the conv and the dropout (bias, BN, activation, pool, the time
tail's mask) is ``ops/conv_epilogue.py``: hand-written kernels for the
recipes' layers on the card, its plain twin elsewhere.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ctc_pytorch_tpu_torch.config import CNNConfig
from ctc_pytorch_tpu_torch.models.layers import (
    dropout,
    global_stats,
    stats_from_sums,
    synced_sums,
    update_running,
)
from ctc_pytorch_tpu_torch.ops.conv_epilogue import ACTIVATIONS, conv_epilogue
from ctc_pytorch_tpu_torch.parallel.mesh import DataGroup


class BatchNorm2d(nn.Module):
    """BatchNorm over the channel axis of NCHW planes (no ``count``,
    ``cnn.py:45-95``); statistics in fp32, output in the plane's dtype.

    ``mask``: optional ``(B, 1, T, 1)`` 0/1 validity.  Train-mode statistics
    then cover valid (row, frame) slots only, each slot counting its F
    positions (the batchmax pad dynamics); the caller zeroes the planes.
    ``group``: the statistics of the global batch, summed over the ranks
    (``layers.py:BatchNorm``; JAX ``cnn.py:65-80``)."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group: Optional[DataGroup] = None) -> torch.Tensor:
        mean, var = self.mean, self.var
        xf = x.float()
        if self.training:
            if mask is not None:
                b, c, t, f = x.shape
                m = mask.to(xf.dtype).expand(b, 1, t, 1)
                # sum over F first, then the masked (B, T) slots
                s1, s2, n = synced_sums(
                    group, (xf.sum(3) * m[..., 0]).sum((0, 2)),
                    ((xf * xf).sum(3) * m[..., 0]).sum((0, 2)), m.sum() * f)
                mean, var, unbiased = stats_from_sums(s1, s2, n)
            elif group is not None:
                s1, s2 = synced_sums(group, xf.sum((0, 2, 3)),
                                     (xf * xf).sum((0, 2, 3)))
                mean, var, unbiased = global_stats(
                    s1, s2, x.shape[0] * x.shape[2] * x.shape[3] * group.world)
            else:
                n = x.shape[0] * x.shape[2] * x.shape[3]
                mean = xf.mean((0, 2, 3))
                var = xf.var((0, 2, 3), unbiased=False)
                unbiased = var * (n / max(n - 1, 1))
            update_running(self.mean, self.var, mean, unbiased, self.momentum)
        inv = torch.rsqrt(var + self.eps)

        def col(v):
            return v.view(1, -1, 1, 1)

        out = (xf - col(mean)) * col(inv * self.scale) + col(self.bias)
        return out.to(x.dtype)


class ConvLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel, batch_norm: bool):
        super().__init__()
        # OIHW, the torch Conv2d layout the JAX package also stores
        self.w = nn.Parameter(torch.empty(out_ch, in_ch, kernel[0], kernel[1]))
        self.b = nn.Parameter(torch.empty(out_ch))
        self.bn = BatchNorm2d(out_ch) if batch_norm else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        """torch Conv2d default init (kaiming uniform + bias)."""
        bound = 1.0 / math.sqrt(self.w[0].numel())
        with torch.no_grad():
            self.w.uniform_(-bound, bound, generator=gen)
            self.b.uniform_(-bound, bound, generator=gen)


class CNNStack(nn.ModuleList):
    """The conv layers as a list, so checkpoint paths read ``cnn.{i}.w``."""

    def __init__(self, cnn: CNNConfig):
        super().__init__(
            ConvLayer(cnn.channel[i][0], cnn.channel[i][1], cnn.kernel_size[i],
                      cnn.batch_norm)
            for i in range(cnn.layers)
        )
        self.cfg = cnn
        self.act_name = cnn.activation_function.lower()
        if self.act_name not in ACTIVATIONS:
            raise KeyError(self.act_name)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                t_valid: Optional[torch.Tensor] = None,
                example_mask: Optional[torch.Tensor] = None,
                drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                group: Optional[DataGroup] = None) -> torch.Tensor:
        """(B, 1, T, F) -> (B, C_out, T', F') in ``compute_dtype``.

        ``t_valid``: optional 0-d int tensor, the batch's true max input
        frames (batchmax pad dynamics).  Each layer carries it through its
        own conv (+pool) floor arithmetic and zeroes the time tail beyond
        it, so the next conv sees the implicit zero padding the reference
        sees at the edge of a batch padded to its own max
        (``cnn.py:236-264``).  This applies in eval too.  In train mode
        each BN takes its statistics over the frames below the cutoff, with
        the repeat-padded rows of ``example_mask`` dropped, and every layer
        ends in dropout (``cnn.py:265``).  ``group``: the BNs' train-mode
        statistics cover the global batch (``t_valid`` is then the global
        max)."""
        cfg = self.cfg
        x = x.to(compute_dtype)
        tv = t_valid
        rows = None
        if t_valid is not None and example_mask is not None:
            rows = example_mask > 0
        for i, layer in enumerate(self):
            out = F.conv2d(x, layer.w.to(compute_dtype), stride=cfg.stride[i],
                           padding=cfg.padding[i])
            if tv is not None:
                tv = torch.clamp(cfg.conv_out(i, tv, 0)[0], min=1)
            out, tv = conv_epilogue(out, layer, self.act_name, tv, rows,
                                    cfg.pool_at(i), group, self.training)
            x = dropout(out, drop_rate, generator, self.training)
        return x
