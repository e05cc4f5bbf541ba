"""Import a reference PyTorch checkpoint "package" (counterpart of
``ctc_pytorch_tpu/cli/import_torch.py``).  Host-only.

A user of the reference saves ``ctc_best_model.pkl`` via
``CTC_Model.save_package`` (``timit/models/model_ctc.py:209-229``):
hyperparameters (``rnn_param``, ``cnn_param``, ``add_cnn``, ``num_class``,
``_drop_out``) + ``state_dict``.  This tool rebuilds a ``ModelSpec`` from
those hyperparameters (per-layer pooling, the pickled class of
``rnn_type``), maps the reference's ``state_dict`` names onto the port's
``CTCModel`` (``REFERENCE_NAMES``; the recurrent weights transposed: torch's
``weight_ih_l0`` is ``(G*H, F)`` gate-major, the port's ``w_ih`` its
transpose), and writes a package with ``save_package``, which the port's
and the JAX package's ``cli.test`` / ``cli.visualize`` load.

The reference's BN ``num_batches_tracked`` is not a parameter of the
port's model and is skipped; the port's BN update counters start at 0, as
in the JAX import.  Any other key the map does not name raises: the
reference's cells are bias-free, and a package with recurrent biases is not
a model this port can hold.

Usage: ``python -m ctc_pytorch_tpu_torch.cli.import_torch ref.pkl out.npz``.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import numpy as np
import torch

from ctc_pytorch_tpu_torch.config import CNNConfig
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.train.checkpoint import save_package


def spec_from_torch_package(pkg: Dict) -> ModelSpec:
    rnn = pkg["rnn_param"]
    add_cnn = bool(pkg.get("add_cnn", False))
    cnn_cfg = CNNConfig(add_cnn=add_cnn)
    if add_cnn and pkg.get("cnn_param"):
        layers = pkg["cnn_param"]["layer"]
        cnn_cfg = CNNConfig(
            add_cnn=True,
            layers=len(layers),
            channel=[tuple(l[0]) for l in layers],
            kernel_size=[tuple(l[1]) for l in layers],
            stride=[tuple(l[2]) for l in layers],
            padding=[tuple(l[3]) for l in layers],
            # pooling is PER LAYER in the reference tuples (l[4] may be
            # None for some layers and a window for others)
            pooling=(
                [tuple(l[4]) if l[4] is not None else None for l in layers]
                if any(l[4] is not None for l in layers) else None
            ),
            batch_norm=bool(pkg["cnn_param"].get("batch_norm", True)),
        )
    rnn_type = rnn.get("rnn_type", "lstm")
    cell = getattr(rnn_type, "__name__", str(rnn_type)).lower()
    for name in ("lstm", "gru", "rnn"):
        if name in cell:
            cell = name
            break
    return ModelSpec(
        add_cnn=add_cnn,
        cnn=cnn_cfg,
        rnn_input_size=int(rnn["rnn_input_size"]),
        rnn_hidden_size=int(rnn["rnn_hidden_size"]),
        rnn_layers=int(rnn["rnn_layers"]),
        rnn_cell=cell,
        bidirectional=bool(rnn.get("bidirectional", True)),
        batch_norm=bool(rnn.get("batch_norm", True)),
        num_class=int(pkg["num_class"]),
        drop_out=float(pkg.get("_drop_out", 0.0)),
        compute_dtype="float32",
    )


_BN = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
       ("running_var", "var"))


def reference_names(spec: ModelSpec) -> List[Tuple[str, str, bool]]:
    """``(reference key, port key, transpose)`` for every tensor of the
    reference's ``CTC_Model`` tree that ``spec`` describes."""
    names = []
    if spec.add_cnn:
        for i in range(spec.cnn.layers):
            names += [(f"conv.{i}.conv.weight", f"cnn.{i}.w", False),
                      (f"conv.{i}.conv.bias", f"cnn.{i}.b", False)]
            if spec.cnn.batch_norm:
                names += [(f"conv.{i}.batch_norm.{r}", f"cnn.{i}.bn.{p}", False)
                          for r, p in _BN]
    for i in range(spec.rnn_layers):
        for suffix, d in (("", "fwd"), ("_reverse", "bwd"))[:spec.dirs]:
            names += [(f"rnns.{i}.rnn.weight_ih_l0{suffix}",
                       f"rnns.{i}.{d}.w_ih", True),
                      (f"rnns.{i}.rnn.weight_hh_l0{suffix}",
                       f"rnns.{i}.{d}.w_hh", True)]
        if spec.batch_norm and i > 0:
            names += [(f"rnns.{i}.batch_norm.{r}", f"rnns.{i}.bn.{p}", False)
                      for r, p in _BN]
    if spec.batch_norm:
        names += [(f"fc.0.{r}", f"fc_bn.{p}", False) for r, p in _BN]
        names.append(("fc.1.weight", "fc.w", True))
    else:
        names.append(("fc.weight", "fc.w", True))
    return names


def model_from_state_dict(spec: ModelSpec, sd: Dict) -> CTCModel:
    """The reference's ``state_dict`` as the port's ``CTCModel`` (fp32, on
    the CPU, eval mode)."""
    model = CTCModel(spec)
    template = model.state_dict()
    new = dict(template)
    names = reference_names(spec)
    extra = sorted(set(sd) - {ref for ref, _, _ in names}
                   - {k for k in sd if k.endswith("num_batches_tracked")})
    if extra:
        raise ValueError(f"reference keys with no place in the port's model: "
                         f"{extra}")
    for ref, port, transpose in names:
        if ref not in sd:
            raise KeyError(f"reference package lacks {ref!r}")
        v = torch.as_tensor(np.asarray(
            sd[ref].detach().cpu().numpy() if hasattr(sd[ref], "detach")
            else sd[ref], np.float32))
        if transpose:
            v = v.t()
        if tuple(v.shape) != tuple(template[port].shape):
            raise ValueError(f"{ref} has shape {tuple(v.shape)}, the port's "
                             f"{port} {tuple(template[port].shape)}")
        new[port] = v.contiguous()
    model.load_state_dict(new)
    return model


def import_torch_package(pkl_path: str, out_path: str) -> str:
    pkg = torch.load(pkl_path, map_location="cpu", weights_only=False)
    spec = spec_from_torch_package(pkg)
    model = model_from_state_dict(spec, pkg["state_dict"])
    epoch = pkg.get("epoch")
    save_package(
        out_path, spec, model,
        epoch=epoch.get("epoch") if isinstance(epoch, dict) else epoch,
        loss_results=_floats(pkg.get("loss_results")),
        dev_loss_results=_floats(pkg.get("dev_loss_results")),
        dev_cer_results=_floats(pkg.get("dev_cer_results")),
    )
    return out_path


def _floats(v) -> list:
    return [float(x) for x in np.ravel(np.asarray(v if v is not None else [],
                                                  np.float64))]


def main(argv=None):
    p = argparse.ArgumentParser(description="import reference torch checkpoint")
    p.add_argument("pkl")
    p.add_argument("out")
    args = p.parse_args(argv)
    out = import_torch_package(args.pkl, args.out)
    print(f"imported {args.pkl} -> {out}")


if __name__ == "__main__":
    main()
