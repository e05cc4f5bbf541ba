"""The CNN front-end's conv epilogue: the conv bias, BatchNorm2d, the
activation and the time tail's mask of one conv layer, in hand-written
kernels forward and backward, and their plain twin.

It replaces no TPU kernel: the JAX package leaves this chain to XLA.  In
eager PyTorch it is ~80 memory-bound passes a step over fp32 copies of the
conv's plane (``csrc/conv_epilogue.cu`` says what each kernel computes and
what bounds it).  ``conv_epilogue`` routes each layer by what it holds:

- **fused**: a CUDA plane in bf16 or fp32, a BatchNorm2d, ``relu`` or
  ``hardtanh`` (the 863 recipe's ``clamp(0, 20)``), no pooling (a pool sits
  between the activation and the tail mask), and in train mode the
  batch-max frame count ``tv`` that masks the statistics.  Forward: a
  statistics launch (the masked sums of ``xb = conv + bias`` and ``xb *
  xb``, and their count), then the existing torch ops on ``(C,)`` vectors
  (the data-parallel sum, mean, variance, running buffers, ``rsqrt``), then
  one apply launch that writes the layer's output.  Eval mode is the apply
  launch alone, on the running statistics.  Backward: a sums launch (the
  gradients of the BN's shift, scale and mean), autograd's ``(C,)`` chain
  back to the statistics, and one apply launch that writes ``d(conv)`` and
  the conv bias's gradient.  The plane saved for the backward is the raw
  conv output alone.
- **plain**: every other layer, and every CPU tensor: ``conv_epilogue_plain``,
  the chain of PyTorch ops ``models/cnn.py`` ran before the kernels.

``launches_route`` counts the layer calls by route: ``fused_fwd`` and
``fused_bwd`` one a layer each way (two or three kernel launches each),
added where the apply kernels launch, so the CPU arithmetic below counts
nothing; ``plain`` one a layer forward.  It is a dict, listed in
``ops/launch_counts.MODULES``, so graph replays count too.

The fused path's autograd runs in two ``Function``s around the ``(C,)``
chain: ``_Stats`` (statistics) and ``_Apply`` (output).  The plane's
gradient needs the gradients of the statistics, which autograd forms only
after ``_Apply``'s backward; so in train mode ``_Apply``'s backward leaves
``dy`` on a ``_Link`` shared with ``_Stats``, whose backward then writes the
whole ``d(conv)`` in one pass.  On CPU tensors these ``Function``s run the
kernels' arithmetic in torch ops (``_*_cpu``), which the tests use to hold
the plumbing against the plain twin; the route never takes them there.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ctc_pytorch_tpu_torch.ops._build import KernelLibrary

ACTIVATIONS = {
    "relu": torch.relu,
    "hardtanh": lambda x: torch.clamp(x, 0.0, 20.0),  # 863's Hardtanh(0, 20)
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}
# the fused route's activations, as ``csrc/conv_epilogue.cu`` numbers them
FUSED_ACTS = ("relu", "hardtanh")

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_DIMS = [_CI] * 4
LIBRARY = KernelLibrary(
    "conv_epilogue.cu",
    {"cnn_epi_parts": ([_CI] * 3, _CI),
     "cnn_epi_stats": ([_VP] * 7 + _DIMS + [_CI, _VP], _CI),
     "cnn_epi_apply": ([_VP] * 7 + _DIMS + [_CI, _CI, _VP], _CI),
     "cnn_epi_grad_sums": ([_VP] * 9 + _DIMS + [_CI, _CI, _VP], _CI),
     "cnn_epi_grad_apply": ([_VP] * 13 + _DIMS + [_CI, _CI, _VP], _CI),
     "cnn_epi_error_string": ([_CI], ctypes.c_char_p)})

launches_route = {"fused_fwd": 0, "fused_bwd": 0, "plain": 0}


def conv_epilogue_plain(out, layer, act_name: str, tv, rows, pool, group):
    """The layer's epilogue in PyTorch ops: ``(y, tv)`` from the raw conv
    plane ``out``, with ``tv`` (0-d, the frames below the tail, or None)
    carried through the pool."""
    out = out + layer.b.to(out.dtype).view(1, -1, 1, 1)
    mask = None
    if tv is not None:
        t_idx = torch.arange(out.shape[2], device=out.device)
        mask = (t_idx < tv).view(1, 1, -1, 1)
        if rows is not None:
            mask = mask & rows.view(-1, 1, 1, 1)
    if layer.bn is not None:
        out = layer.bn(out, mask, group)
    out = ACTIVATIONS[act_name](out)
    if pool:
        out = F.max_pool2d(out, kernel_size=pool, stride=pool)
        if tv is not None:
            tv = torch.clamp((tv - pool[0]) // pool[0] + 1, min=1)
    if tv is not None:
        t_idx = torch.arange(out.shape[2], device=out.device)
        out = out * (t_idx < tv).to(out.dtype).view(1, 1, -1, 1)
    return out, tv


def fused_route(out, layer, act_name: str, tv, pool, training: bool) -> bool:
    """Whether the layer's epilogue takes the kernels."""
    return (out.is_cuda and layer.bn is not None and act_name in FUSED_ACTS
            and not pool and out.dtype in (torch.float32, torch.bfloat16)
            and (tv is not None or not training))


def conv_epilogue(out, layer, act_name: str, tv, rows, pool, group,
                  training: bool):
    """``(y, tv)`` of one conv layer (``models/cnn.py:CNNStack``): the raw
    conv plane ``out (B, C, T, F)``, the layer (``b``, ``bn``), the
    activation's name, ``tv`` (0-d int, or None), ``rows`` (``(B,)`` bool:
    the real rows, for the statistics, or None), the pool window, the
    data-parallel group and the mode."""
    if fused_route(out, layer, act_name, tv, pool, training):
        return conv_epilogue_fused(out, layer, act_name, tv, rows, group,
                                   training), tv
    launches_route["plain"] += 1
    return conv_epilogue_plain(out, layer, act_name, tv, rows, pool, group)


def conv_epilogue_fused(out, layer, act_name: str, tv, rows, group,
                        training: bool):
    """The fused epilogue (``fused_route``'s layers; also CPU tensors, in
    torch ops, for the tests)."""
    # models/ imports this module: take its helpers at the call
    from ctc_pytorch_tpu_torch.models.layers import (
        stats_from_sums,
        synced_sums,
        update_running,
    )

    bn = layer.bn
    conv = _aligned(out)
    tv = None if tv is None else tv.to(torch.int32)
    if training:
        link = _Link(act_name)
        s1, s2, n = _Stats.apply(conv, layer.b, tv, rows, link)
        s1, s2, n = synced_sums(group, s1, s2, n)
        mean, var, unbiased = stats_from_sums(s1, s2, n)
        update_running(bn.mean, bn.var, mean, unbiased, bn.momentum)
    else:
        link, mean, var = None, bn.mean, bn.var
    inv = torch.rsqrt(var + bn.eps)
    return _Apply.apply(conv, layer.b, mean, inv * bn.scale, bn.bias, tv,
                        act_name, link)


class _Link:
    """What ``_Apply``'s backward hands ``_Stats``'s in train mode."""

    __slots__ = ("act", "dy", "mean", "k", "beta")

    def __init__(self, act: str):
        self.act = act
        self.dy = self.mean = self.k = self.beta = None


class _Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, conv, bias, tv, rows, link):
        s1, s2, n = stats(conv, bias, tv, rows)
        ctx.save_for_backward(conv, bias, tv, rows)
        ctx.link = link
        ctx.mark_non_differentiable(n)
        return s1, s2, n

    @staticmethod
    @once_differentiable
    def backward(ctx, ds1, ds2, _):
        conv, bias, tv, rows = ctx.saved_tensors
        link = ctx.link
        dconv, dbias = grad_apply(conv, link.dy, bias, link.mean, link.k,
                                  link.beta, ds1, ds2, tv, rows, link.act)
        link.dy = link.mean = link.k = link.beta = None
        return dconv, dbias, None, None, None


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, conv, bias, mean, k, beta, tv, act, link):
        ctx.save_for_backward(conv, bias, mean, k, beta, tv)
        ctx.act, ctx.link = act, link
        return apply(conv, bias, mean, k, beta, tv, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        conv, bias, mean, k, beta, tv = ctx.saved_tensors
        dy = _aligned(dy)
        dbeta, dk, dmean = grad_sums(conv, dy, bias, mean, k, beta, tv,
                                     ctx.act)
        link = ctx.link
        if link is not None:  # train mode: _Stats's backward writes d(conv)
            link.dy, link.mean, link.k, link.beta = dy, mean, k, beta
            dconv = dbias = None
        else:
            dconv, dbias = grad_apply(conv, dy, bias, mean, k, beta, None,
                                      None, tv, None, ctx.act)
        return dconv, dbias, dmean, dk, dbeta, None, None, None


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and, on the card, 16-byte aligned (a copy if not)."""
    x = x.contiguous()
    if x.is_cuda and x.data_ptr() % 16:
        x = x.clone()
    return x


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _call(fn: str, *args) -> None:
    lib = LIBRARY.load()
    err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.cnn_epi_error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed ({err}: {msg})")


def _partials(conv, nk: int) -> torch.Tensor:
    b, c, t, f = conv.shape
    p = LIBRARY.load().cnn_epi_parts(b, t, f)
    return torch.empty(nk, c, p, dtype=torch.float32, device=conv.device)


def _bf16(conv) -> int:
    return int(conv.dtype == torch.bfloat16)


def stats(conv, bias, tv, rows):
    """``(s1, s2, n)``: the masked sums of ``xb`` and ``xb * xb`` a channel
    (fp32 ``(C,)``) and their count (fp32, 0-d), over the frames below
    ``tv`` of the real ``rows``."""
    if not conv.is_cuda:
        return _stats_cpu(conv, bias, tv, rows)
    vecs = _checked(conv, (), (bias,), tv, rows)
    sums = torch.empty(2, conv.shape[1], dtype=torch.float32,
                       device=conv.device)
    n = torch.empty((), dtype=torch.float32, device=conv.device)
    _call("cnn_epi_stats", conv.data_ptr(), *vecs, _ptr(tv), _ptr(rows),
          _partials(conv, 2).data_ptr(), sums.data_ptr(), n.data_ptr(),
          *conv.shape, _bf16(conv))
    return sums[0], sums[1], n


def apply(conv, bias, mean, k, beta, tv, act: str):
    """``y = act(T((xb - mean) * k + beta)) * [t < tv]`` in the plane's
    dtype ``T``."""
    if not conv.is_cuda:
        return _apply_cpu(conv, bias, mean, k, beta, tv, act)
    vecs = _checked(conv, (), (bias, mean, k, beta), tv)
    y = torch.empty_like(conv)
    _call("cnn_epi_apply", conv.data_ptr(), *vecs, _ptr(tv), y.data_ptr(),
          *conv.shape, _bf16(conv), FUSED_ACTS.index(act))
    launches_route["fused_fwd"] += 1
    return y


def grad_sums(conv, dy, bias, mean, k, beta, tv, act: str):
    """``(dbeta, dk, dmean)`` fp32 ``(C,)`` from the output's gradient."""
    if not conv.is_cuda:
        return _grad_sums_cpu(conv, dy, bias, mean, k, beta, tv, act)
    vecs = _checked(conv, (dy,), (bias, mean, k, beta), tv)
    sums = torch.empty(3, conv.shape[1], dtype=torch.float32,
                       device=conv.device)
    _call("cnn_epi_grad_sums", conv.data_ptr(), dy.data_ptr(), *vecs,
          _ptr(tv), _partials(conv, 3).data_ptr(), sums.data_ptr(),
          *conv.shape, _bf16(conv), FUSED_ACTS.index(act))
    return sums[0], sums[1], sums[2]


def grad_apply(conv, dy, bias, mean, k, beta, ds1, ds2, tv, rows, act: str):
    """``(d(conv), dbias)``: the plane's gradient in its dtype and the
    conv bias's (fp32 ``(C,)``, the sum of ``d(conv)`` rounded to the
    plane's dtype); ``ds1``, ``ds2`` the statistics' gradients (None in
    eval)."""
    if not conv.is_cuda:
        return _grad_apply_cpu(conv, dy, bias, mean, k, beta, ds1, ds2, tv,
                               rows, act)
    if ds1 is not None:
        ds1, ds2 = ds1.float().contiguous(), ds2.float().contiguous()
    vecs = _checked(conv, (dy,), (bias, mean, k, beta, ds1, ds2), tv, rows)
    dconv = torch.empty_like(conv)
    dbias = torch.empty(conv.shape[1], dtype=torch.float32,
                        device=conv.device)
    _call("cnn_epi_grad_apply", conv.data_ptr(), dy.data_ptr(), *vecs,
          _ptr(tv), _ptr(rows), dconv.data_ptr(),
          _partials(conv, 1).data_ptr(), dbias.data_ptr(), *conv.shape,
          _bf16(conv), FUSED_ACTS.index(act))
    launches_route["fused_bwd"] += 1
    return dconv, dbias


def _checked(conv, planes, vectors, tv=None, rows=None) -> list:
    """Raise unless the kernels take these operands: ``conv`` and the other
    planes ``(B, C, T, F)`` of one dtype, bf16 or fp32, contiguous and
    16-byte aligned; the ``(C,)`` vectors fp32 and contiguous (None allowed:
    a null pointer); ``tv`` a 0-d int32; ``rows`` ``(B,)`` bool; all on
    ``conv``'s device.  The vectors' pointers."""
    dev = conv.device
    if conv.dim() != 4 or conv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"want a bf16 or fp32 (B, C, T, F) plane, got "
                         f"{conv.dtype} {tuple(conv.shape)}")
    for p in (conv, *planes):
        if (p.shape != conv.shape or p.dtype != conv.dtype or p.device != dev
                or not p.is_contiguous() or p.data_ptr() % 16):
            raise ValueError(f"want contiguous 16-byte aligned {conv.dtype} "
                             f"{tuple(conv.shape)} planes on {dev}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")
    want = (conv.shape[1],)
    for v in vectors:
        if v is not None and (v.dtype != torch.float32 or v.shape != want
                              or v.device != dev or not v.is_contiguous()):
            raise ValueError(f"want fp32 contiguous {want} operands on {dev}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    if tv is not None and (tv.dtype != torch.int32 or tv.dim() != 0
                           or tv.device != dev):
        raise ValueError(f"tv must be a 0-d int32 on {dev}, got {tv.dtype} "
                         f"{tuple(tv.shape)} on {tv.device}")
    if rows is not None and (rows.dtype != torch.bool or rows.device != dev
                             or rows.shape != conv.shape[:1]
                             or not rows.is_contiguous()):
        raise ValueError(f"rows must be ({conv.shape[0]},) bool on {dev}, "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    return [_ptr(v) for v in vectors]


# The kernels' arithmetic in torch ops, for CPU tensors: the same roundings
# and operations, sums in torch's order.

def _col(v):
    return v.view(1, -1, 1, 1)


def _xb(conv, bias):
    return (conv + bias.to(conv.dtype).view(1, -1, 1, 1)).float()


def _frames(conv, tv):
    t_idx = torch.arange(conv.shape[2], device=conv.device).view(1, 1, -1, 1)
    return t_idx < (conv.shape[2] if tv is None else tv)


def _stats_mask(conv, tv, rows):
    m = _frames(conv, tv)
    if rows is not None:
        m = m & rows.view(-1, 1, 1, 1)
    return m.expand(conv.shape[0], 1, conv.shape[2], 1).float()


def _stats_cpu(conv, bias, tv, rows):
    xb, m = _xb(conv, bias), _stats_mask(conv, tv, rows)
    n = m.sum() * conv.shape[3]
    return (xb * m).sum((0, 2, 3)), (xb * xb * m).sum((0, 2, 3)), n


def _norm_cpu(conv, bias, mean, k, beta):
    xb = _xb(conv, bias)
    u = xb - _col(mean)
    return xb, u, (u * _col(k) + _col(beta)).to(conv.dtype)


def _apply_cpu(conv, bias, mean, k, beta, tv, act):
    zb = _norm_cpu(conv, bias, mean, k, beta)[2]
    return ACTIVATIONS[act](zb) * _frames(conv, tv).to(conv.dtype)


def _dz_cpu(conv, dy, bias, mean, k, beta, tv, act):
    xb, u, zb = _norm_cpu(conv, bias, mean, k, beta)
    if act == "relu":
        passes = ~(torch.relu(zb) <= 0)
    else:
        passes = (zb >= 0) & (zb <= 20)
    g = (dy * _frames(conv, tv).to(dy.dtype)).float()
    return xb, u, torch.where(passes, g, torch.zeros_like(g))


def _grad_sums_cpu(conv, dy, bias, mean, k, beta, tv, act):
    _, u, dz = _dz_cpu(conv, dy, bias, mean, k, beta, tv, act)
    return (dz.sum((0, 2, 3)), (dz * u).sum((0, 2, 3)),
            -(dz * _col(k)).sum((0, 2, 3)))


def _grad_apply_cpu(conv, dy, bias, mean, k, beta, ds1, ds2, tv, rows, act):
    xb, _, dz = _dz_cpu(conv, dy, bias, mean, k, beta, tv, act)
    d = dz * _col(k)
    if ds1 is not None:
        m = _stats_mask(conv, tv, rows)
        gx = (m * _col(ds2)) * xb
        d = d + gx + gx + m * _col(ds1)
    dconv = d.to(conv.dtype)
    return dconv, dconv.float().sum((0, 2, 3)).to(conv.dtype).float()
