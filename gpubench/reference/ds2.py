"""DeepSpeech2 in plain float32 PyTorch with TF32 off: deepspeech.pytorch's
``DeepSpeech`` (``deepspeech_pytorch/model.py``) as the port runs it, for
the ``ds2_*`` cells.

``model.py``'s network where it holds (imported, not copied): the CNN of
Conv2d -> BN2d -> activation with the time tail past the batch's longest
utterance zeroed, BN over the frames below that tail in the rows that count,
the fractional CTC lengths, the bias-free Linear, log-softmax and the loss.
DeepSpeech2's recurrent layers in its place: ``nn.LSTM`` with biases (one
``b`` a direction, the sum of ``b_ih`` and ``b_hh``), both directions,
packed (``pack_padded_sequence``): each utterance's recurrence runs over
its own frames alone, forward from frame 0 and backward from its last
frame, with zero state, and gives zeros past its length.  Here the state is
reset to zero on every frame past an utterance's length, the whole batch at
once (the port shuts the input gate there instead).  The directions'
outputs are summed (``x.view(T, N, 2, -1).sum(2)``), so every layer after
the first takes H features, as do the output BN and Linear.  Three training
steps as ``train.py`` takes them: the loss, the global-norm clip, Adam with
coupled L2.

Departures from deepspeech.pytorch, each the port's too (the two compute
one function; ``configs/ds2_librispeech.json`` lists them under
``changed``):

- masking in the CNN: ``MaskConv`` zeroes every utterance's frames past its
  own length after each module; here, as in the port's recipes, only the
  tail past the batch's longest utterance is zeroed (a batch padded to its
  own longest, as deepspeech.pytorch pads it, then sees the same zeros at
  its edge);
- BN statistics: deepspeech.pytorch's ``SequenceWise`` BN1d and its BN2d
  take every padded frame of a batch padded to its longest utterance; here
  they stop at that longest utterance's frames too (a bucket's extra padding
  is left out) and leave out the repeat-padded rows of a ragged batch;
- the CTC lengths: each utterance's conv arithmetic there, the recipes'
  fractional contract here (``len / T_pad`` rescaled by the model's output
  length at the batch's longest utterance; equal for even lengths);
- the optimizer: AdamW (decoupled weight decay) there, Adam with coupled L2
  (``torch.optim.Adam(weight_decay=...)``) here, with its global-norm clip;
- precision: fp16 autocast there, bf16 products here (this reference in
  fp32; its control rounds the products to fp8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference import model
from gpubench.reference.model import ACT, _bn, ctc_mean_loss, full_fp32, \
    identity
from gpubench.reference.train import ADAM_EPS, BETAS


@dataclasses.dataclass(frozen=True)
class Arch(model.Arch):
    merge: str = "concat"  # 'concat' | 'sum': how a layer's directions join
    bias: bool = False  # biased, packed LSTM cells

    @classmethod
    def from_config(cls, c: dict) -> "Arch":
        base = model.Arch.from_config(c)
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(model.Arch)}
        return cls(**fields, merge=c.get("rnn_merge", "concat"),
                   bias=bool(c.get("rnn_bias", False)))

    @property
    def rnn_out(self) -> int:
        """Features out of a recurrent layer."""
        return self.hidden if self.merge == "sum" else self.ndir * self.hidden

    def leaves(self) -> List[Tuple[str, Tuple[int, ...], str, float]]:
        """``model.Arch.leaves`` with each layer after the first, the output
        BN and the Linear ``rnn_out`` wide, and a bias ``b (4H)`` after each
        direction's weights."""
        h, nh = self.hidden, self.gates * self.hidden
        out = []
        for name, shape, kind, bound in super().leaves():
            parts = name.split(".")
            if name.startswith("rnns.") and parts[-1] == "w_ih" and \
                    int(parts[1]) > 0:
                shape = (self.rnn_out, nh)
            elif (name.startswith("rnns.") and parts[2] == "bn") or \
                    name.startswith("fc_bn."):
                shape = shape if not shape else (self.rnn_out,)
            elif name == "fc.w":
                shape, bound = (self.rnn_out, self.n_class), \
                    self.rnn_out ** -0.5
            out.append((name, shape, kind, bound))
            if self.bias and parts[-1] == "w_hh":
                out.append((name[:-len("w_hh")] + "b", (nh,), "param",
                            h ** -0.5))
        return out


def packed_lstm(gx: torch.Tensor, w_hh: List[torch.Tensor],
                lengths: torch.Tensor, quant: Callable) -> torch.Tensor:
    """``ys (T, B, ndir, H)`` of one LSTM layer from ``gx (T, B, ndir * 4H)``
    (the input projection with its bias): each utterance over its first
    ``lengths[b]`` frames alone, zero state, zeros past them; gates in
    torch's order i, f, g, o.  Each direction's planes are laid out in the
    order of its own walk (direction 1 from the last padded frame back), so
    a step reads one row of each; the cell state is zeroed on a frame past
    an utterance's length, and with it h."""
    t_len, b, _ = gx.shape
    ndir, h = len(w_hh), w_hh[0].shape[0]
    w = quant(torch.stack(w_hh))
    g = gx.unflatten(-1, (ndir, 4 * h)).transpose(1, 2)  # (T, ndir, B, 4H)
    live = (torch.arange(t_len, device=gx.device)[:, None]
            < lengths[None, :])[:, None, :, None].to(gx.dtype)
    if ndir == 2:
        g = torch.stack([g[:, 0], g[:, 1].flip(0)], dim=1)
        live = torch.cat([live, live.flip(0)], dim=1)
    hs = cs = gx.new_zeros(ndir, b, h)
    outs = []
    for s in range(t_len):
        i, f, gg, o = (g[s] + torch.bmm(quant(hs), w)).chunk(4, dim=-1)
        cs = (torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(gg)
              ) * live[s]
        hs = torch.sigmoid(o) * torch.tanh(cs)
        outs.append(hs)
    ys = torch.stack(outs)  # (T, ndir, B, H), each direction's walk order
    if ndir == 2:
        ys = torch.stack([ys[:, 0], ys[:, 1].flip(0)], dim=1)
    return ys.transpose(1, 2)


def forward(w: Dict[str, torch.Tensor], arch: Arch, feats: torch.Tensor,
            frac: torch.Tensor, mask: Optional[torch.Tensor], train: bool,
            quant: Callable = identity, stats: Optional[dict] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``model.forward``'s contract: ``(log_probs (T', B, C), input_sizes
    (B,) int64)`` of ``feats (B, T, F)``; the recurrent layers are packed
    over ``input_sizes``."""
    if arch.cell != "lstm" or not arch.bias:
        raise ValueError("the DeepSpeech2 reference runs biased LSTM cells")
    b, t_in, _ = feats.shape
    dev = feats.device
    true_in = torch.round(frac * t_in).to(torch.int64)
    rows = None if mask is None else mask > 0
    bmax = (true_in if rows is None
            else torch.where(rows, true_in, torch.zeros_like(true_in))).max()
    bmax = bmax.clamp(min=1)
    x = feats[:, None]
    tv = bmax
    for i, (_, _, k, stride, pad) in enumerate(arch.convs):
        x = F.conv2d(quant(x), quant(w[f"cnn.{i}.w"]), stride=stride,
                     padding=pad) + w[f"cnn.{i}.b"].view(1, -1, 1, 1)
        tv = torch.clamp((tv + 2 * pad[0] - k[0]) // stride[0] + 1, min=1)
        keep = (torch.arange(x.shape[2], device=dev) < tv).view(1, 1, -1, 1)
        if arch.batch_norm:
            m = keep if rows is None else keep & rows.view(-1, 1, 1, 1)
            x = _bn(x, w, f"cnn.{i}.bn", m, train, (0, 2, 3), stats)
        x = ACT[arch.act](x) * keep.to(x.dtype)
    bb, c, t_rnn, f = x.shape
    x = x.permute(2, 0, 1, 3).reshape(t_rnn, bb, c * f)
    t_out_b = arch.out_time(bmax)
    sizes = ((true_in.to(torch.float32) / bmax.to(torch.float32))
             * t_out_b.to(torch.float32)).to(torch.int64)
    valid = (torch.arange(t_rnn, device=dev)[:, None] < t_out_b).expand(
        t_rnn, b)
    if rows is not None:
        valid = valid & rows[None, :]
    vm = valid.to(x.dtype)[..., None]
    dirs = ("fwd", "bwd")[:arch.ndir]
    for i in range(arch.layers):
        if arch.batch_norm and i > 0:
            x = _bn(x, w, f"rnns.{i}.bn", vm, train, (0, 1), stats) * vm
        w_ih = torch.cat([w[f"rnns.{i}.{d}.w_ih"] for d in dirs], dim=1)
        bias = torch.cat([w[f"rnns.{i}.{d}.b"] for d in dirs])
        ys = packed_lstm(quant(x) @ quant(w_ih) + bias,
                         [w[f"rnns.{i}.{d}.w_hh"] for d in dirs], sizes, quant)
        x = ys.sum(2) if arch.merge == "sum" else ys.flatten(2)
    if arch.batch_norm:
        x = _bn(x, w, "fc_bn", vm, train, (0, 1), stats) * vm
    logits = quant(x) @ quant(w["fc.w"])
    return torch.log_softmax(logits, dim=-1), sizes


def train_steps(weights: Dict[str, torch.Tensor], arch: Arch,
                batches: Sequence[tuple], quant: Callable = identity,
                drop_half: bool = False, frozen: bool = False) -> dict:
    """``train.train_steps`` of this model: one optimizer step a batch
    ``(feats, frac, labels, label_lens, mask)`` from ``weights`` (not
    changed); the losses, the first step's gradient as Adam takes it and its
    raw gradient, the weights after the last step; the faults
    ``drop_half`` and ``frozen`` as there."""
    full_fp32()
    names = arch.param_names()
    params = {n: weights[n].detach().clone().requires_grad_(True)
              for n in names}
    state = {n: (torch.zeros_like(p), torch.zeros_like(p))
             for n, p in params.items()}
    buffers = {n: v for n, v in weights.items() if n not in params}
    losses: List[float] = []
    first, raw = {}, {}
    for k, (feats, frac, labels, lab_len, mask) in enumerate(batches):
        if drop_half:
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0
        log_probs, sizes = forward({**buffers, **params}, arch, feats, frac,
                                   mask, True, quant)
        loss = ctc_mean_loss(log_probs, sizes, labels, lab_len, mask)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        del log_probs
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if k == 0:
                raw = {n: g.clone() for n, g in grads.items()}
            if arch.grad_clip > 0:
                norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
                scale = torch.clamp(arch.grad_clip / norm, max=1.0)
                grads = {n: g * scale for n, g in grads.items()}
            t = k + 1
            for n, p in params.items():
                g = grads[n] + arch.weight_decay * p
                if k == 0:
                    first[n] = torch.zeros_like(g) if frozen else g.clone()
                if frozen:
                    continue
                m, v = state[n]
                m.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v.sqrt() / (1 - BETAS[1] ** t) ** 0.5).add_(ADAM_EPS)
                p.addcdiv_(m, denom, value=-arch.lr / (1 - BETAS[0] ** t))
    return {"losses": losses, "first_grad": first, "raw_grad": raw,
            "params": {n: p.detach() for n, p in params.items()}}
