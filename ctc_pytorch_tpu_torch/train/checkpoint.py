"""Package checkpoints, shared with the JAX package: one ``.npz`` holding a
JSON manifest and the leaves ``params.{i}``, ``model_state.{i}`` and
``opt_state.{i}`` (counterpart of ``ctc_pytorch_tpu/train/checkpoint.py``).

Leaves are numbered in JAX's ``tree_flatten`` order, which sorts dict keys
and keeps list order (``checkpoint.py:53-61``).  The port enumerates that
order from the ``ModelSpec`` alone (``leaf_paths``); a leaf's path joined
with dots is its ``state_dict`` key in ``CTCModel``.  For the flagship:

- params: ``cnn[i].{b, bn.{bias,scale}, w}``, ``fc.w``,
  ``fc_bn.{bias,scale}``, ``rnns[i].{bn.{bias,scale}, bwd.{w_hh,w_ih},
  fwd.{w_hh,w_ih}}``;
- model_state: ``cnn[i].bn.{mean,var}``, ``fc_bn.{count,mean,var}``,
  ``rnns[i].bn.{count,mean,var}`` (``rnns[0]`` has no BN, so no leaves).

A model with ``rnn_bias`` (DeepSpeech2's cells; the port's alone) adds
``rnns[i].{bwd,fwd}.b`` before each direction's weights.

``opt_state`` is the JAX package's optimizer tree flattened (``state.py:32-44``:
the hyperparameter-injected Adam, whatever clip or decay stands before it):
``count``, ``b1``, ``b2``, ``eps``, ``eps_root``, ``learning_rate``, Adam's own
``count``, then ``mu`` and ``nu``, each in params leaf order.  The port maps
them onto ``torch.optim.Adam``'s ``step``, ``exp_avg`` and ``exp_avg_sq`` and
its param group's ``lr``, so a resume package crosses frameworks both ways.
Serving needs no optimizer: ``model_from_package`` reads past ``opt_state``,
and ``save_package`` without an optimizer writes none.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec


def _trees(spec: ModelSpec) -> Tuple[dict, dict]:
    """The params and model_state trees' structure (leaves are None), as
    the JAX package's ``CTCModel.init`` builds them."""
    bn_p = {"scale": None, "bias": None}
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    if spec.add_cnn:
        params["cnn"], state["cnn"] = [], []
        for _ in range(spec.cnn.layers):
            p = {"w": None, "b": None}
            s = {}
            if spec.cnn.batch_norm:
                p["bn"] = dict(bn_p)
                s["bn"] = {"mean": None, "var": None}
            params["cnn"].append(p)
            state["cnn"].append(s)
    params["rnns"], state["rnns"] = [], []
    for i in range(spec.rnn_layers):
        leaves = ("b", "w_ih", "w_hh") if spec.rnn_bias else ("w_ih", "w_hh")
        p = {d: dict.fromkeys(leaves)
             for d in (("fwd", "bwd") if spec.bidirectional else ("fwd",))}
        s = {}
        if spec.batch_norm and i > 0:
            p["bn"] = dict(bn_p)
            s["bn"] = {"mean": None, "var": None, "count": None}
        params["rnns"].append(p)
        state["rnns"].append(s)
    if spec.batch_norm:
        params["fc_bn"] = dict(bn_p)
        state["fc_bn"] = {"mean": None, "var": None, "count": None}
    params["fc"] = {"w": None}
    return params, state


def _paths(tree, prefix: str = "") -> List[str]:
    """Leaf paths in ``jax.tree_util.tree_flatten`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def leaf_paths(spec: ModelSpec) -> Tuple[List[str], List[str]]:
    """(params paths, model_state paths) in checkpoint leaf order."""
    params, state = _trees(spec)
    return _paths(params), _paths(state)


def params_from_jax(spec: ModelSpec, params, model_state) -> Dict[str, torch.Tensor]:
    """JAX pytrees (nested dicts/lists of arrays) -> ``CTCModel`` state_dict."""
    sd = {}
    for tree, paths in zip((params, model_state), leaf_paths(spec)):
        for path in paths:
            node = tree
            for part in path.split("."):
                node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
            sd[path] = torch.from_numpy(np.array(node))
    return sd


def params_to_jax(spec: ModelSpec, state_dict) -> Tuple[dict, dict]:
    """``CTCModel`` state_dict -> (params, model_state) nested dicts/lists of
    numpy arrays in the JAX package's tree layout."""
    trees = _trees(spec)
    for tree, paths in zip(trees, leaf_paths(spec)):
        for path in paths:
            *parents, last = path.split(".")
            node = tree
            for part in parents:
                node = node[int(part)] if isinstance(node, list) else node[part]
            # a copy: the arrays must not follow later in-place updates
            node[last] = state_dict[path].detach().cpu().numpy().copy()
    return trees


ADAM_HYPERPARAMS = ("b1", "b2", "eps", "eps_root")  # sorted, before the lr


def opt_state_leaves(optimizer, shapes: List[tuple]) -> List[np.ndarray]:
    """``opt_state.{i}`` leaves from a ``torch.optim.Adam`` (or its
    ``state_dict()``) whose parameters stand in params leaf order with the
    given shapes."""
    sd = optimizer if isinstance(optimizer, Mapping) else optimizer.state_dict()
    group = sd["param_groups"][0]
    state = sd["state"]
    steps = {int(state[i]["step"]) for i in group["params"] if i in state}
    if len(steps) > 1:
        raise ValueError(f"parameters disagree on the Adam step: {steps}")
    count = np.asarray(steps.pop() if steps else 0, np.int32)

    def moments(key):
        return [state[i][key].detach().cpu().numpy().astype(np.float32)
                if i in state else np.zeros(shape, np.float32)
                for i, shape in zip(group["params"], shapes)]

    b1, b2 = group["betas"]
    hyper = {"b1": b1, "b2": b2, "eps": group["eps"], "eps_root": 0.0}
    return ([count] + [np.asarray(hyper[k], np.float32) for k in ADAM_HYPERPARAMS]
            + [np.asarray(float(group["lr"]), np.float32), count.copy()]
            + moments("exp_avg") + moments("exp_avg_sq"))


def load_opt_state(optimizer: torch.optim.Adam, leaves: List[np.ndarray]) -> None:
    """Set ``optimizer``'s step, moments and learning rate from
    ``opt_state.{i}`` leaves (the inverse of ``opt_state_leaves``), copied
    into the tensors the optimizer holds (``train/state.py``: a captured
    graph keeps stepping the state it was captured over)."""
    from ctc_pytorch_tpu_torch.train.state import init_optimizer_state, set_lr

    params = optimizer.param_groups[0]["params"]
    head = 3 + len(ADAM_HYPERPARAMS)
    if len(leaves) != head + 2 * len(params):
        raise ValueError(f"checkpoint has {len(leaves)} opt_state leaves, the "
                         f"optimizer expects {head + 2 * len(params)}")
    lr, count = float(leaves[head - 2]), int(leaves[head - 1])
    mu, nu = leaves[head:head + len(params)], leaves[head + len(params):]
    for p, m, v in zip(params, mu, nu):
        if tuple(m.shape) != tuple(p.shape) or tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"opt_state moment of shape {m.shape} for a "
                             f"parameter of shape {tuple(p.shape)}")
    set_lr(optimizer, lr)
    init_optimizer_state(optimizer)
    with torch.no_grad():
        for p, m, v in zip(params, mu, nu):
            live = optimizer.state[p]
            live["step"].fill_(float(count))
            live["exp_avg"].copy_(torch.from_numpy(np.array(m)))
            live["exp_avg_sq"].copy_(torch.from_numpy(np.array(v)))


def save_package(
    path: str | Path,
    spec: ModelSpec,
    model,
    *,
    optimizer=None,
    step: int = 0,
    config: Optional[Config] = None,
    scheduler_state: Optional[dict] = None,
    epoch: Optional[int] = None,
    loss_results: Optional[list] = None,
    dev_loss_results: Optional[list] = None,
    dev_cer_results: Optional[list] = None,
    training_cer_results: Optional[list] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a package that the JAX ``model_from_package`` loads and, given
    an ``optimizer``, its ``restore_train_state`` resumes from.

    ``model`` is a ``CTCModel`` or its ``state_dict()``; ``optimizer`` a
    ``torch.optim.Adam`` over ``ordered_params`` or its ``state_dict()``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    sd = model if isinstance(model, Mapping) else model.state_dict()
    p_paths, s_paths = leaf_paths(spec)
    arrays: Dict[str, np.ndarray] = {}
    for name, paths in (("params", p_paths), ("model_state", s_paths)):
        for i, key in enumerate(paths):
            arrays[f"{name}.{i}"] = sd[key].detach().cpu().numpy()
    n_opt = 0
    if optimizer is not None:
        opt = opt_state_leaves(optimizer,
                               [tuple(sd[k].shape) for k in p_paths])
        n_opt = len(opt)
        arrays.update({f"opt_state.{i}": leaf for i, leaf in enumerate(opt)})
    manifest = {
        "spec": spec.to_dict(),
        "config": config.to_dict() if config else None,
        "scheduler": scheduler_state,
        "epoch": epoch,
        "step": int(step),
        "loss_results": loss_results or [],
        "dev_loss_results": dev_loss_results or [],
        "dev_cer_results": dev_cer_results or [],
        "training_cer_results": training_cer_results or [],
        "extra": extra or {},
        "leaf_counts": {"params": len(p_paths), "model_state": len(s_paths),
                        "opt_state": n_opt},
    }
    buf = io.BytesIO()
    np.savez(buf, manifest=np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    ), **arrays)
    path.write_bytes(buf.getvalue())


def load_package(path: str | Path, with_opt_state: bool = False) -> Dict[str, Any]:
    """Raw package: manifest dict + named leaf arrays (``opt_state`` only on
    request: serving reads past it)."""
    wanted = ("params.", "model_state.") + (
        ("opt_state.",) if with_opt_state else ())
    with np.load(Path(path), allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k.startswith(wanted)}
    return {"manifest": manifest, "arrays": arrays}


def _leaves_of(arrays: Dict[str, np.ndarray], prefix: str) -> list:
    items = [(int(k.split(".")[-1]), v) for k, v in arrays.items()
             if k.startswith(prefix + ".")]
    return [v for _, v in sorted(items)]


def _model_state_dict(spec: ModelSpec, template, arrays) -> Dict[str, torch.Tensor]:
    """The package's params and model_state leaves as a ``state_dict``."""
    sd = {}
    for name, paths in zip(("params", "model_state"), leaf_paths(spec)):
        leaves = _leaves_of(arrays, name)
        if len(leaves) != len(paths):
            raise ValueError(
                f"checkpoint has {len(leaves)} {name} leaves, model expects "
                f"{len(paths)}"
            )
        for key, leaf in zip(paths, leaves):
            want = template[key]
            if tuple(leaf.shape) != tuple(want.shape):
                raise ValueError(f"leaf {name}:{key} has shape {leaf.shape}, "
                                 f"model expects {tuple(want.shape)}")
            sd[key] = torch.from_numpy(np.array(leaf)).to(want.dtype)
    return sd


def model_from_package(path: str | Path, device: str | torch.device = "cuda"):
    """Rebuild ``(spec, model, manifest)`` from a package alone; the model
    is in eval mode on ``device``."""
    dev = resolve_device(device)
    pkg = load_package(path)
    spec = ModelSpec.from_dict(pkg["manifest"]["spec"])
    model = CTCModel(spec)
    model.load_state_dict(
        _model_state_dict(spec, model.state_dict(), pkg["arrays"]))
    return spec, model.to(dev).eval(), pkg["manifest"]


def restore_train_state(path: str | Path, state, spec: ModelSpec) -> dict:
    """Load params, BN state, optimizer state and step of a resume package
    (written by either package) into ``state``, in place; the manifest."""
    pkg = load_package(path, with_opt_state=True)
    state.model.load_state_dict(
        _model_state_dict(spec, state.model.state_dict(), pkg["arrays"]))
    load_opt_state(state.optimizer, _leaves_of(pkg["arrays"], "opt_state"))
    state.step = int(pkg["manifest"].get("step", 0))
    return pkg["manifest"]


def latest_checkpoint(ckpt_dir: str | Path, pattern: str = "resume_ep*.npz"
                      ) -> Optional[Path]:
    """The newest resume checkpoint in ``ckpt_dir``: the match of
    ``pattern`` whose stem's digits make the largest number (the JAX
    ``latest_checkpoint``; ``Trainer`` writes ``resume_epNNNN.npz``), or
    None."""
    ckpts = sorted(
        Path(ckpt_dir).glob(pattern),
        key=lambda p: int("".join(ch for ch in p.stem if ch.isdigit()) or 0),
    )
    return ckpts[-1] if ckpts else None
