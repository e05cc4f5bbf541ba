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

Serving needs no optimizer: ``opt_state`` leaves are read past, and
``save_package`` writes none (``leaf_counts.opt_state = 0``).
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

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
        p = {d: {"w_ih": None, "w_hh": None}
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
            node[last] = state_dict[path].detach().cpu().numpy()
    return trees


def save_package(
    path: str | Path,
    spec: ModelSpec,
    model: CTCModel,
    *,
    config: Optional[Config] = None,
    epoch: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write ``model`` as a package the JAX ``model_from_package`` loads."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    sd = model.state_dict()
    p_paths, s_paths = leaf_paths(spec)
    arrays: Dict[str, np.ndarray] = {}
    for name, paths in (("params", p_paths), ("model_state", s_paths)):
        for i, key in enumerate(paths):
            arrays[f"{name}.{i}"] = sd[key].detach().cpu().numpy()
    manifest = {
        "spec": spec.to_dict(),
        "config": config.to_dict() if config else None,
        "scheduler": None,
        "epoch": epoch,
        "step": 0,
        "loss_results": [],
        "dev_loss_results": [],
        "dev_cer_results": [],
        "training_cer_results": [],
        "extra": extra or {},
        "leaf_counts": {"params": len(p_paths), "model_state": len(s_paths),
                        "opt_state": 0},
    }
    buf = io.BytesIO()
    np.savez(buf, manifest=np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    ), **arrays)
    path.write_bytes(buf.getvalue())


def load_package(path: str | Path) -> Dict[str, Any]:
    """Raw package: manifest dict + named leaf arrays (``opt_state`` skipped)."""
    with np.load(Path(path), allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files
                  if k.startswith(("params.", "model_state."))}
    return {"manifest": manifest, "arrays": arrays}


def _leaves_of(arrays: Dict[str, np.ndarray], prefix: str) -> list:
    items = [(int(k.split(".")[-1]), v) for k, v in arrays.items()
             if k.startswith(prefix + ".")]
    return [v for _, v in sorted(items)]


def model_from_package(path: str | Path, device: str | torch.device = "cuda"):
    """Rebuild ``(spec, model, manifest)`` from a package alone; the model
    is in eval mode on ``device``."""
    dev = resolve_device(device)
    pkg = load_package(path)
    spec = ModelSpec.from_dict(pkg["manifest"]["spec"])
    model = CTCModel(spec)
    template = model.state_dict()
    sd = {}
    for name, paths in zip(("params", "model_state"), leaf_paths(spec)):
        leaves = _leaves_of(pkg["arrays"], name)
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
    model.load_state_dict(sd)
    return spec, model.to(dev).eval(), pkg["manifest"]
