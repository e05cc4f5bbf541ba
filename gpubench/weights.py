"""The weights of a run, made from its seed on its device.

One uniform draw of every value in one call, then each leaf scaled to its
range (``reference.model.Arch.leaves``): the torch default ranges of the
projections and convolutions, BN scales and running variances in [0.8,
1.2], BN biases and running means in [-0.1, 0.1].  The program and the
reference are both handed these tensors.

A model that decodes (eval mode) needs running statistics that fit its
activations, as a trained model's do: ``calibrate_bn`` sets them to the
batch statistics of one train-mode pass of the plain reference over
utterances of the run's own traffic.  Random running statistics leave the
eval activations unnormalised, and the random model's output then takes one
class on nearly every frame.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from gpubench.reference.model import Arch, forward, full_fp32

SALT = 0x5EED3E16


def make_weights(arch: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    leaves = arch.leaves()
    sizes = [math.prod(shape) for _, shape, kind, _ in leaves
             if kind != "count"]
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) ^ SALT) % (1 << 63))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, shape, kind, bound in leaves:
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int32, device=device)
            continue
        n = math.prod(shape)
        centre = 1.0 if kind.endswith("1") else 0.0
        out[name] = flat[off:off + n].view(shape) * bound + centre
        off += n
    return out


def calibrate_bn(weights: Dict[str, torch.Tensor], arch: Arch, feats,
                 frac) -> None:
    """Set every BN's running mean and variance, in place, to its batch
    statistics in the reference's train-mode pass over ``feats (B, T, F)``
    (``frac = frames / T``)."""
    full_fp32()
    stats: dict = {}
    with torch.no_grad():
        forward(weights, arch, feats, frac, torch.ones_like(frac), True,
                stats=stats)
    for prefix, (mean, var) in stats.items():
        weights[f"{prefix}.mean"].copy_(mean)
        weights[f"{prefix}.var"].copy_(var)
