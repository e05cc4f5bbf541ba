"""Train state: the model, its optimizer and the step count.

Counterpart of ``ctc_pytorch_tpu/train/state.py``.  The optimizer is the
reference recipe's ``torch.optim.Adam(lr, weight_decay)``: **coupled** L2 (the
decay joins the gradient before the Adam moments, not AdamW), which is what
the JAX package builds from ``add_decayed_weights`` + ``adam``.  With
``grad_clip > 0`` the gradients are first scaled to that global norm (the 863
recipe clips at 400).  The learning rate lives in the optimizer's param group,
so it rides along in snapshots and checkpoints and the plateau scheduler
rescales it without rebuilding the optimizer.

Unlike the JAX pytree, the state is mutable: a step updates the parameters,
the BN buffers and the Adam moments in place.  ``snapshot`` is therefore a
deep copy on the device, and ``restore`` copies it back.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List

import torch

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.parallel.mesh import DataGroup


@dataclasses.dataclass
class TrainState:
    model: CTCModel
    optimizer: torch.optim.Adam
    grad_clip: float = 0.0
    step: int = 0


def ordered_params(model: CTCModel, spec: ModelSpec) -> List[torch.nn.Parameter]:
    """The model's parameters in checkpoint leaf order, so that entry i of
    the optimizer state belongs to leaf ``params.{i}``."""
    from ctc_pytorch_tpu_torch.train.checkpoint import leaf_paths

    named = dict(model.named_parameters())
    return [named[p] for p in leaf_paths(spec)[0]]


def make_optimizer(model: CTCModel, spec: ModelSpec, init_lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam over the model's parameters (on one device), with the learning
    rate a 0-d fp32 tensor beside them and its state made up front;
    ``capturable`` on the card."""
    params = ordered_params(model, spec)
    dev = params[0].device
    opt = torch.optim.Adam(
        params, lr=torch.tensor(float(init_lr), dtype=torch.float32, device=dev),
        weight_decay=weight_decay or 0.0, capturable=dev.type == "cuda",
        foreach=False if dev.type == "cpu" else None)
    init_optimizer_state(opt)
    return opt


def init_optimizer_state(optimizer: torch.optim.Adam) -> None:
    """Zero moments and a zero step for every parameter that has no Adam
    state yet (what Adam would make lazily at its first step), so that the
    tensors a graph captures exist before it and stay the same ones."""
    group = optimizer.param_groups[0]
    for p in group["params"]:
        if optimizer.state.get(p):
            continue
        step_dev = p.device if group["capturable"] else torch.device("cpu")
        optimizer.state[p] = {
            "step": torch.zeros((), dtype=torch.float32, device=step_dev),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p,
                                           memory_format=torch.preserve_format),
        }


def set_lr(optimizer: torch.optim.Adam, lr) -> None:
    """Write the learning rate into every param group, in place."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def create_train_state(spec: ModelSpec, init_lr: float,
                       weight_decay: float = 0.0, grad_clip: float = 0.0,
                       seed: int = 0,
                       device: str | torch.device = "cuda") -> TrainState:
    """A freshly initialised model (torch's default inits drawn from
    ``seed``) on ``device`` with its optimizer."""
    dev = resolve_device(device)
    model = CTCModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    return TrainState(model, make_optimizer(model, spec, init_lr, weight_decay),
                      grad_clip=grad_clip or 0.0)


def get_lr(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def scale_lr(state: TrainState, factor: float) -> None:
    """Multiply the learning rate by ``factor``, in place."""
    for group in state.optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].mul_(factor)
        else:
            group["lr"] = group["lr"] * factor


def clip_by_global_norm(params, max_norm: float) -> None:
    """Scale the gradients so their global L2 norm is at most ``max_norm``
    (``optax.clip_by_global_norm``: untouched below it, ``g * max / norm``
    above), without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)


@torch.no_grad()
def sum_gradients(state: TrainState, group: DataGroup,
                  loss: torch.Tensor) -> torch.Tensor:
    """Sum every parameter's gradient and ``loss`` over ``group``, in one
    collective over a flat fp32 buffer, and return the summed loss (the JAX
    step's ``psum`` of grads and loss, ``loop.py:112-115``).  The loss of
    each rank is its share of the global mean, so the sums are the global
    batch's gradient and loss; the clip and Adam then see the same
    gradients on every rank."""
    import torch.distributed as dist

    params = state.optimizer.param_groups[0]["params"]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1).float() for p in params]
                     + [loss.detach().reshape(1).float()])
    dist.all_reduce(flat, group=group.group)
    parts = flat.split([p.numel() for p in params] + [1])
    for p, g in zip(params, parts):
        p.grad.copy_(g.view_as(p.grad))
    return parts[-1][0]


def apply_gradients(state: TrainState) -> None:
    """One optimizer update from the gradients now on the parameters."""
    if state.grad_clip > 0:
        clip_by_global_norm(state.optimizer.param_groups[0]["params"],
                            state.grad_clip)
    state.optimizer.step()
    state.step += 1


def snapshot(state: TrainState) -> Dict[str, Any]:
    """Deep copy of the model and optimizer state on the device (the
    reference's ``copy.deepcopy`` of both state dicts,
    ``train_ctc.py:198-199``)."""
    return {
        "model": {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()},
        "optimizer": copy.deepcopy(state.optimizer.state_dict()),
        "step": state.step,
    }


def restore(state: TrainState, snap: Dict[str, Any]) -> None:
    """Copy a snapshot back into the live state, into the tensors that hold
    it now (``load_state_dict`` copies the model's in place; the optimizer's
    would replace its tensors, so they are copied here); the snapshot stays
    intact."""
    with torch.no_grad():
        state.model.load_state_dict(snap["model"])
        opt = state.optimizer
        saved = snap["optimizer"]
        set_lr(opt, saved["param_groups"][0]["lr"])
        for i, p in enumerate(opt.param_groups[0]["params"]):
            live = opt.state[p]
            for key in ("step", "exp_avg", "exp_avg_sq"):
                live[key].copy_(saved["state"][i][key])
    state.step = snap["step"]
