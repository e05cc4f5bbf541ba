"""Packages cross between the two packages: a JAX-saved package loads into
the port and a port-saved package loads into the JAX package, with leaves
in ``jax.tree_util.tree_flatten`` order."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.config import load_config as jax_load_config
from ctc_pytorch_tpu.models.ctc_model import CTCModel as JModel
from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
from ctc_pytorch_tpu.train.checkpoint import model_from_package as jax_model_from_package
from ctc_pytorch_tpu.train.checkpoint import save_package as jax_save_package
from ctc_pytorch_tpu.train.state import TrainState
from ctc_pytorch_tpu_torch.config import load_config
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.train.checkpoint import (
    leaf_paths,
    model_from_package,
    params_from_jax,
    params_to_jax,
    save_package,
)
from tests.test_torch_model import RECIPE_VARIANTS, jax_weights, small_jax_spec

RECIPE = Path(__file__).resolve().parent.parent / "recipes/timit/ctc_config.yaml"


def _jax_paths(tree):
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", None)))

    return [".".join(key(k) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_flagship_leaf_order_equals_tree_flatten():
    jspec = JSpec.from_config(jax_load_config(RECIPE), num_class=41)
    params, state = jax.eval_shape(lambda: JModel.init(jax.random.PRNGKey(0), jspec))
    spec = ModelSpec.from_config(load_config(RECIPE), num_class=41)
    p_paths, s_paths = leaf_paths(spec)
    assert p_paths == _jax_paths(params)
    assert s_paths == _jax_paths(state)
    assert p_paths[:4] == ["cnn.0.b", "cnn.0.bn.bias", "cnn.0.bn.scale", "cnn.0.w"]
    assert "rnns.0.bn.mean" not in s_paths and "rnns.1.bn.count" in s_paths


@pytest.mark.parametrize("variant", sorted(RECIPE_VARIANTS))
def test_recipe_variant_leaf_order_equals_tree_flatten(variant):
    """The flagship recipe with ``rnn_type: nn.RNN`` or ``bidirectional:
    False``, at full width: the port's leaf order and shapes are JAX's."""
    rnn_type, bidir = RECIPE_VARIANTS[variant]
    jcfg, cfg = jax_load_config(RECIPE), load_config(RECIPE)
    for c in (jcfg, cfg):
        c.rnn_type, c.bidirectional = rnn_type, bidir
    jspec = JSpec.from_config(jcfg, num_class=41)
    params, state = jax.eval_shape(lambda: JModel.init(jax.random.PRNGKey(0), jspec))
    spec = ModelSpec.from_config(cfg, num_class=41)
    assert spec.to_dict() == jspec.to_dict()
    p_paths, s_paths = leaf_paths(spec)
    assert p_paths == _jax_paths(params)
    assert s_paths == _jax_paths(state)
    sd = CTCModel(spec).state_dict()
    leaves = jax.tree_util.tree_leaves(params)
    assert [tuple(sd[p].shape) for p in p_paths] == [tuple(x.shape) for x in leaves]
    n = 1 if rnn_type == "nn.RNN" else 4
    assert tuple(sd["rnns.0.fwd.w_hh"].shape) == (384, n * 384)
    assert ("rnns.0.bwd.w_ih" in p_paths) == bidir
    assert tuple(sd["fc.w"].shape) == ((2 if bidir else 1) * 384, 41)
    assert tuple(sd["rnns.1.fwd.w_ih"].shape)[0] == (2 if bidir else 1) * 384
    # every leaf is a state_dict entry of the module, with the JAX shape
    sd = CTCModel(spec).state_dict()
    assert sorted(sd) == sorted(p_paths + s_paths)
    shapes = {p: tuple(l.shape) for p, l in zip(
        p_paths + s_paths, jax.tree_util.tree_leaves(params)
        + jax.tree_util.tree_leaves(state))}
    assert all(tuple(sd[k].shape) == shapes[k] for k in sd)


@pytest.mark.parametrize("add_cnn,batch_norm", [
    (True, True), (False, True), (True, False),
])
def test_jax_package_loads_into_the_port(tmp_path, add_cnn, batch_norm):
    jspec = small_jax_spec(add_cnn=add_cnn, batch_norm=batch_norm, layers=3)
    params, state = jax_weights(jspec)
    opt_state = ({"mu": np.ones(3, np.float32)},)  # read past by the port
    jax_save_package(tmp_path / "p.npz", jspec,
                     TrainState(jnp.zeros((), jnp.int32), params, state, opt_state))
    spec, model, manifest = model_from_package(tmp_path / "p.npz", device="cpu")
    assert manifest["leaf_counts"]["opt_state"] == 1
    assert spec.to_dict() == jspec.to_dict()
    assert not model.training
    sd = model.state_dict()
    for key, arr in params_from_jax(spec, params, state).items():
        assert sd[key].dtype == arr.dtype and torch.equal(sd[key], arr), key


def test_port_package_loads_into_jax(tmp_path):
    jspec = small_jax_spec(layers=3)
    spec = ModelSpec.from_dict(jspec.to_dict())
    model = CTCModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.rnns[1].bn.mean.uniform_(-1, 1)
        model.fc_bn.count.fill_(7)
    save_package(tmp_path / "t.npz", spec, model)
    got_spec, params, state, manifest = jax_model_from_package(tmp_path / "t.npz")
    assert got_spec == jspec
    assert manifest["leaf_counts"] == {"params": 27, "model_state": 13,
                                       "opt_state": 0}
    want_p, want_s = params_to_jax(spec, model.state_dict())
    for got, want in ((params, want_p), (state, want_s)):
        g_leaves, g_def = jax.tree_util.tree_flatten(got)
        w_leaves, w_def = jax.tree_util.tree_flatten(want)
        assert g_def == w_def
        for g, w in zip(g_leaves, w_leaves):
            assert np.asarray(g).dtype == w.dtype
            np.testing.assert_array_equal(np.asarray(g), w)


def test_params_round_trip_through_jax_layout():
    spec = ModelSpec.from_dict(small_jax_spec().to_dict())
    model = CTCModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(1))
    sd = model.state_dict()
    back = params_from_jax(spec, *params_to_jax(spec, sd))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_leaf_count_mismatch_raises(tmp_path):
    jspec = small_jax_spec(layers=2)
    params, state = jax_weights(jspec)
    jax_save_package(tmp_path / "p.npz", jspec,
                     TrainState(jnp.zeros((), jnp.int32), params, state, ()))
    with np.load(tmp_path / "p.npz") as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays["manifest"].tobytes()).decode())
    manifest["spec"]["rnn_layers"] = 3
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(), np.uint8)
    np.savez(tmp_path / "bad.npz", **arrays)
    with pytest.raises(ValueError, match="leaves"):
        model_from_package(tmp_path / "bad.npz", device="cpu")
