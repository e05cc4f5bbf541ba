"""Training steps of the plain reference: the recipes' loss, the global-norm
clip (where the recipe clips), and Adam with coupled L2 (the decay joins the
gradient before the moments, as ``torch.optim.Adam(weight_decay=...)``)."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from gpubench.reference.model import (
    Arch,
    ctc_mean_loss,
    forward,
    full_fp32,
    identity,
)

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def train_steps(weights: Dict[str, torch.Tensor], arch: Arch,
                batches: Sequence[tuple], quant: Callable = identity,
                drop_half: bool = False, frozen: bool = False) -> dict:
    """Run one optimizer step a batch from ``weights`` (not changed).
    Each batch is ``(feats, frac, labels, label_lens, mask)`` on one device.
    Returns the losses, the first step's gradient as Adam takes it (clipped,
    plus the decay term) and its raw gradient, and the weights after the
    last step.  Two faults, for the check's readings: ``drop_half`` leaves
    the second half of every batch out of the loss; ``frozen`` is a step
    that returns its state unchanged (Adam's moments stay zero, so the
    gradient read from them is zero, and the weights do not move)."""
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
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        grads = dict(zip(names, grads))
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
