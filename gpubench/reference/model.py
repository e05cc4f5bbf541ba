"""The CTC acoustic model in plain float32 PyTorch.

CNN (Conv2d -> BatchNorm2d -> activation, the time tail past the batch's
longest utterance zeroed after each layer) -> stacked bias-free LSTM, GRU or
tanh layers over the whole padded length, both directions, feature BN
before every layer but the first -> BN + bias-free Linear -> log-softmax.
BN statistics cover the frames below the batch's longest utterance in the
rows that count, and BN zeroes the frames past it; the CTC input lengths
follow the recipes' fractional contract (``len / T_pad``, rescaled by the
model's output length at the batch's longest utterance).  Train mode
normalises with the batch's statistics; eval with the running ones.

``quant`` rounds the operands of every product (convolutions, input,
recurrent and output projections): the identity in float32, or the
lower-precision control of ``fp8``.  Weights are a dict of float32 tensors
under the checkpoint's names (``cnn.0.w``, ``rnns.1.fwd.w_hh``, ``fc.w``).
"""

from __future__ import annotations

import ast
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5


def full_fp32() -> None:
    """Products in full float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pairs(value) -> List[Tuple[int, int]]:
    if value is None or value in ("None", "none", ""):
        return []
    if isinstance(value, str):
        value = ast.literal_eval(value)
    return [(int(a), int(b)) for a, b in value]


@dataclasses.dataclass(frozen=True)
class Arch:
    in_dim: int
    convs: Tuple[Tuple[int, int, Tuple[int, int], Tuple[int, int],
                       Tuple[int, int]], ...]  # (cin, cout, k, stride, pad)
    act: str
    cell: str
    hidden: int
    layers: int
    ndir: int
    batch_norm: bool
    n_class: int
    lr: float
    weight_decay: float
    grad_clip: float

    @classmethod
    def from_config(cls, c: dict) -> "Arch":
        if _pairs(c.get("pooling")):
            raise ValueError("the reference has no pooling layers")
        convs = ()
        if c.get("add_cnn"):
            convs = tuple(zip(*(_pairs(c[k]) for k in (
                "channel", "kernel_size", "stride", "padding"))))
            convs = tuple((ch[0], ch[1], k, s, p) for ch, k, s, p in convs)
        cell = c["rnn_type"].lower()
        cell = next(n for n in ("lstm", "gru", "rnn") if n in cell)
        n_class = (int(c["num_class"]) + 1 if c.get("num_class")
                   else int(c["output_class_dim"]))
        return cls(int(c["rnn_input_size"]), convs,
                   c.get("activation_function", "relu").lower(), cell,
                   int(c["rnn_hidden_size"]), int(c["rnn_layers"]),
                   2 if c.get("bidirectional", True) else 1,
                   bool(c.get("batch_norm", True)), n_class,
                   float(c.get("init_lr", 1e-3)),
                   float(c.get("weight_decay", 0.0)),
                   float(c.get("grad_clip", 0.0)))

    @property
    def gates(self) -> int:
        return {"lstm": 4, "gru": 3, "rnn": 1}[self.cell]

    def out_time(self, t):
        """Frames out of the CNN for ``t`` in (int or int tensor)."""
        for _, _, k, s, p in self.convs:
            t = (t + 2 * p[0] - k[0]) // s[0] + 1
        return t

    def out_freq(self) -> int:
        f = self.in_dim
        for _, _, k, s, p in self.convs:
            f = (f + 2 * p[1] - k[1]) // s[1] + 1
        return f

    @property
    def rnn_in(self) -> int:
        return self.out_freq() * self.convs[-1][1] if self.convs else self.in_dim

    def leaves(self) -> List[Tuple[str, Tuple[int, ...], str, float]]:
        """``(name, shape, kind, bound)`` of every weight and BN buffer, in
        the checkpoint's names.  ``kind``: ``param`` or ``buffer``, drawn
        from ``U(-bound, bound)``; ``param1`` and ``buffer1`` (BN scales and
        running variances) about 1 instead of 0; ``count`` (BN update
        counts) zero."""
        out = []

        def bn(prefix, dim, count):
            out.extend([(f"{prefix}.scale", (dim,), "param1", 0.2),
                        (f"{prefix}.bias", (dim,), "param", 0.1),
                        (f"{prefix}.mean", (dim,), "buffer", 0.1),
                        (f"{prefix}.var", (dim,), "buffer1", 0.2)])
            if count:
                out.append((f"{prefix}.count", (), "count", 0.0))

        for i, (cin, cout, k, _, _) in enumerate(self.convs):
            bound = 1.0 / math.sqrt(cin * k[0] * k[1])
            out += [(f"cnn.{i}.w", (cout, cin, k[0], k[1]), "param", bound),
                    (f"cnn.{i}.b", (cout,), "param", bound)]
            if self.batch_norm:
                bn(f"cnn.{i}.bn", cout, False)
        h, nh = self.hidden, self.gates * self.hidden
        for i in range(self.layers):
            f = self.rnn_in if i == 0 else self.ndir * h
            for d in ("fwd", "bwd")[:self.ndir]:
                out += [(f"rnns.{i}.{d}.w_ih", (f, nh), "param", h ** -0.5),
                        (f"rnns.{i}.{d}.w_hh", (h, nh), "param", h ** -0.5)]
            if self.batch_norm and i > 0:
                bn(f"rnns.{i}.bn", f, True)
        if self.batch_norm:
            bn("fc_bn", self.ndir * h, True)
        out.append(("fc.w", (self.ndir * h, self.n_class), "param",
                    (self.ndir * h) ** -0.5))
        return out

    def param_names(self) -> List[str]:
        return [n for n, _, kind, _ in self.leaves() if kind.startswith("param")]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float):
    """``x`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to ``top``."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """A product operand in float8, as float8 training computes: e4m3 in
    the forward, and the gradient that flows back through it in e5m2, each
    under a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


QUANT = {"fp32": identity, "fp8": fp8}

ACT = {"relu": torch.relu, "hardtanh": lambda x: torch.clamp(x, 0.0, 20.0),
       "tanh": torch.tanh, "sigmoid": torch.sigmoid}


def _bn(x, w, prefix, mask, train: bool, dims, stats: Optional[dict]):
    """BN over the channel axis of ``x``; ``mask`` broadcasts against ``x``
    and marks the positions the statistics count (train mode), whose mean
    and variance go to ``stats[prefix]`` where ``stats`` is given."""
    shape = [1] * x.dim()
    ch = 1 if len(dims) == 3 else x.dim() - 1
    shape[ch] = -1
    if train:
        m = mask.to(x.dtype).expand_as(x)
        n = m.sum(dims).clamp(min=1.0)
        mean = (x * m).sum(dims) / n
        var = (((x - mean.view(shape)) ** 2) * m).sum(dims) / n
        if stats is not None:
            stats[prefix] = (mean.detach(), var.detach())
    else:
        mean, var = w[f"{prefix}.mean"], w[f"{prefix}.var"]
    inv = torch.rsqrt(var + EPS) * w[f"{prefix}.scale"]
    return (x - mean.view(shape)) * inv.view(shape) + w[f"{prefix}.bias"].view(
        shape)


def recurrence(gx: torch.Tensor, w_hh: List[torch.Tensor], cell: str,
               quant: Callable) -> torch.Tensor:
    """``ys (T, B, ndir * H)`` of a bias-free layer from ``gx (T, B, ndir *
    nH)``: direction 0 forward in time, direction 1 backward from the last
    padded frame, zero initial state; gates in torch's order (LSTM i, f, g,
    o; GRU r, z, n with ``n = tanh(x_n + r * (h W_hn))``)."""
    t_len, b, _ = gx.shape
    ndir, h = len(w_hh), w_hh[0].shape[0]
    nh = w_hh[0].shape[1]
    w = quant(torch.stack(w_hh))
    hs = gx.new_zeros(ndir, b, h)
    cs = gx.new_zeros(ndir, b, h)
    outs = [[None] * t_len for _ in range(ndir)]
    for s in range(t_len):
        times = (s, t_len - 1 - s)[:ndir]
        g = torch.stack([gx[t, :, d * nh:(d + 1) * nh]
                         for d, t in enumerate(times)])
        hh = torch.bmm(quant(hs), w)
        if cell == "lstm":
            i, f, gg, o = (g + hh).chunk(4, dim=-1)
            cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(gg)
            hs = torch.sigmoid(o) * torch.tanh(cs)
        elif cell == "gru":
            gr, gz, gn = g.chunk(3, dim=-1)
            hr, hz, hn = hh.chunk(3, dim=-1)
            r, z = torch.sigmoid(gr + hr), torch.sigmoid(gz + hz)
            hs = (1.0 - z) * torch.tanh(gn + r * hn) + z * hs
        else:
            hs = torch.tanh(g + hh)
        for d, t in enumerate(times):
            outs[d][t] = hs[d]
    return torch.cat([torch.stack(o) for o in outs], dim=-1)


def forward(w: Dict[str, torch.Tensor], arch: Arch, feats: torch.Tensor,
            frac: torch.Tensor, mask: Optional[torch.Tensor], train: bool,
            quant: Callable = identity, stats: Optional[dict] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log_probs (T', B, C), input_sizes (B,) int64)`` of ``feats (B, T,
    F)`` with ``frac = frames / T`` (float32).  ``mask`` (train mode): the
    rows that count (0 for a repeat-padded row).  ``stats`` (train mode):
    receives each BN's batch statistics."""
    b, t_in, _ = feats.shape
    dev = feats.device
    true_in = torch.round(frac * t_in).to(torch.int64)
    rows = None if mask is None else mask > 0
    bmax = (true_in if rows is None
            else torch.where(rows, true_in, torch.zeros_like(true_in))).max()
    bmax = bmax.clamp(min=1)
    x = feats[:, None]
    tv = bmax
    for i, (_, _, _, stride, pad) in enumerate(arch.convs):
        x = F.conv2d(quant(x), quant(w[f"cnn.{i}.w"]), stride=stride,
                     padding=pad) + w[f"cnn.{i}.b"].view(1, -1, 1, 1)
        kt = arch.convs[i][2][0]
        tv = torch.clamp((tv + 2 * pad[0] - kt) // stride[0] + 1, min=1)
        keep = (torch.arange(x.shape[2], device=dev) < tv).view(1, 1, -1, 1)
        if arch.batch_norm:
            m = keep if rows is None else keep & rows.view(-1, 1, 1, 1)
            x = _bn(x, w, f"cnn.{i}.bn", m, train, (0, 2, 3), stats)
        x = ACT[arch.act](x) * keep.to(x.dtype)
    if arch.convs:
        bb, c, t, f = x.shape
        x = x.permute(2, 0, 1, 3).reshape(t, bb, c * f)
    else:
        x = x[:, 0].transpose(0, 1)
    t_rnn = x.shape[0]
    t_cut = arch.out_time(bmax)
    valid = (torch.arange(t_rnn, device=dev)[:, None] < t_cut).expand(t_rnn, b)
    if rows is not None:
        valid = valid & rows[None, :]
    vm = valid.to(x.dtype)[..., None]
    for i in range(arch.layers):
        if arch.batch_norm and i > 0:
            x = _bn(x, w, f"rnns.{i}.bn", vm, train, (0, 1), stats) * vm
        dirs = ("fwd", "bwd")[:arch.ndir]
        w_ih = torch.cat([w[f"rnns.{i}.{d}.w_ih"] for d in dirs], dim=1)
        gx = quant(x) @ quant(w_ih)
        x = recurrence(gx, [w[f"rnns.{i}.{d}.w_hh"] for d in dirs], arch.cell,
                       quant)
    if arch.batch_norm:
        x = _bn(x, w, "fc_bn", vm, train, (0, 1), stats) * vm
    logits = quant(x) @ quant(w["fc.w"])
    log_probs = torch.log_softmax(logits, dim=-1)
    t_out_b = arch.out_time(bmax)
    sizes = ((true_in.to(torch.float32) / bmax.to(torch.float32))
             * t_out_b.to(torch.float32)).to(torch.int64)
    return log_probs, sizes


def ctc_mean_loss(log_probs, sizes, labels, label_lens, mask) -> torch.Tensor:
    """The recipes' loss: the CTC negative log-likelihood summed over the
    rows that count, over their number."""
    neg_ll = F.ctc_loss(log_probs, labels, sizes, label_lens, blank=0,
                        reduction="none")
    return (neg_ll * mask).sum() / mask.sum().clamp(min=1.0)
