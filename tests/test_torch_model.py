"""The port's whole model against the JAX package, eval, from one set of
JAX-initialised weights: log_probs at atol 1e-4 and input_sizes exactly,
with and without the CNN, under each pad_dynamics; and the flagship's two
recipe overrides (the tanh cell, one direction) in eval and train mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.config import CNNConfig as JCNNConfig
from ctc_pytorch_tpu.models.ctc_model import CTCModel as JModel
from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.train.checkpoint import params_from_jax


# the flagship recipe's overrides that slice 4 ports: (rnn_type, bidirectional)
RECIPE_VARIANTS = {"tanh": ("nn.RNN", True), "unidir": ("nn.LSTM", False)}


def variant_cell(variant):
    """``(rnn_cell, bidirectional)`` of a recipe variant."""
    rnn_type, bidirectional = RECIPE_VARIANTS[variant]
    return rnn_type[3:].lower(), bidirectional


def small_jax_spec(add_cnn=True, pad_dynamics="batchmax", layers=2, hidden=8,
                   feat=12, num_class=6, batch_norm=True, cell="lstm",
                   bidirectional=True):
    """A few-layer, narrow fp32 spec with the flagship's structure."""
    cnn = JCNNConfig(add_cnn=False)
    if add_cnn:
        cnn = JCNNConfig(add_cnn=True, layers=2, channel=[(1, 2), (2, 2)],
                         kernel_size=[(3, 3), (3, 3)], stride=[(1, 2), (2, 2)],
                         padding=[(1, 1), (1, 1)], batch_norm=batch_norm)
    return JSpec(add_cnn=add_cnn, cnn=cnn, rnn_input_size=feat,
                 rnn_hidden_size=hidden, rnn_layers=layers, rnn_cell=cell,
                 bidirectional=bidirectional, batch_norm=batch_norm,
                 num_class=num_class,
                 drop_out=0.0, compute_dtype="float32",
                 pad_dynamics=pad_dynamics)


def jax_weights(spec, seed=0, fc_scale=1.0):
    """JAX init plus numpy perturbations, so BN statistics are not identity."""
    params, state = JModel.init(jax.random.PRNGKey(seed), spec)
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32),
        params)
    params["fc"]["w"] = params["fc"]["w"] * fc_scale
    state = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                   if a.dtype == np.float32 else np.asarray(a)), state)
    return params, state


def port_model(jspec, params, state):
    spec = ModelSpec.from_dict(jspec.to_dict())
    model = CTCModel(spec)
    model.load_state_dict(params_from_jax(spec, params, state))
    return spec, model.eval()


# lengths 16, 13, 11 of 16, the last row repeat-padded: exercises the
# round/truncate arithmetic and the example_mask exclusion
FRAC = np.array([16, 13, 11], np.float32) / 16
EXAMPLE_MASK = np.array([1, 1, 0], np.float32)


@pytest.mark.parametrize("pad_dynamics", ["batchmax", "padded", "valid"])
@pytest.mark.parametrize("add_cnn", [True, False])
def test_log_probs_and_input_sizes_match_jax(add_cnn, pad_dynamics):
    jspec = small_jax_spec(add_cnn, pad_dynamics)
    params, state = jax_weights(jspec)
    spec, model = port_model(jspec, params, state)
    x = np.random.RandomState(5).randn(3, 16, 12).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    want, _ = JModel.apply(jspec, jp, js, jnp.asarray(x), frac=jnp.asarray(FRAC),
                           example_mask=jnp.asarray(EXAMPLE_MASK))
    with torch.no_grad():
        got = model(torch.from_numpy(x), frac=torch.from_numpy(FRAC),
                    example_mask=torch.from_numpy(EXAMPLE_MASK))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    sizes_j = JModel.input_sizes(jspec, jnp.asarray(FRAC), 16, want.shape[0],
                                 example_mask=jnp.asarray(EXAMPLE_MASK))
    sizes_t = CTCModel.input_sizes(spec, torch.from_numpy(FRAC), 16, got.shape[0],
                                   example_mask=torch.from_numpy(EXAMPLE_MASK))
    np.testing.assert_array_equal(sizes_t.numpy(), np.asarray(sizes_j))


def test_forward_without_frac_matches_jax():
    jspec = small_jax_spec()
    params, state = jax_weights(jspec, seed=2)
    spec, model = port_model(jspec, params, state)
    x = np.random.RandomState(6).randn(2, 9, 12).astype(np.float32)
    want, _ = JModel.apply(jspec, jax.tree_util.tree_map(jnp.asarray, params),
                           jax.tree_util.tree_map(jnp.asarray, state),
                           jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("t_in,lengths", [
    (16, [16, 13, 11]), (40, [37, 40, 1]), (24, [5, 6, 7]), (9, [9, 8, 3]),
])
def test_input_sizes_use_the_same_float32_ops(t_in, lengths):
    jspec = small_jax_spec(add_cnn=True)
    spec = ModelSpec.from_dict(jspec.to_dict())
    frac = np.asarray(lengths, np.float32) / t_in
    t_out = spec.output_time_len(t_in)
    for mask in (None, np.array([1, 1, 0], np.float32)):
        want = JModel.input_sizes(jspec, jnp.asarray(frac), t_in, t_out,
                                  None if mask is None else jnp.asarray(mask))
        got = CTCModel.input_sizes(spec, torch.from_numpy(frac), t_in, t_out,
                                   None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("legacy", [
    {"bn_mask_padding": True}, {"bn_mask_padding": False}, {},
])
def test_spec_from_dict_matches_jax(legacy):
    d = small_jax_spec(add_cnn=True).to_dict()
    d.pop("pad_dynamics")
    d.update(legacy)
    want = JSpec.from_dict(dict(d))
    got = ModelSpec.from_dict(dict(d))
    assert got.to_dict() == want.to_dict()
    assert dataclasses.asdict(got.cnn) == dataclasses.asdict(want.cnn)


def test_other_cells_are_not_ported():
    """Every cell and direction count of the JAX package builds; a cell name
    the JAX package has not either raises."""
    for cell in ("lstm", "gru", "rnn"):
        for bidir in (True, False):
            spec = ModelSpec.from_dict(
                {**small_jax_spec().to_dict(), "rnn_cell": cell,
                 "bidirectional": bidir})
            model = CTCModel(spec)
            assert model.fc.w.shape[0] == (2 if bidir else 1) * 8
    for bidir in (True, False):
        spec = ModelSpec.from_dict(
            {**small_jax_spec().to_dict(), "rnn_cell": "lstmp",
             "bidirectional": bidir})
        with pytest.raises(ValueError, match="unknown cell"):
            CTCModel(spec)


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("variant", sorted(RECIPE_VARIANTS))
def test_recipe_variant_log_probs_and_bn_state_match_jax(variant, train,
                                                         with_lengths):
    """The flagship's structure with the tanh cell or one direction: log
    probs and the new BN state from one JAX init, in eval and in train mode
    (batch statistics, running-stat updates), with and without ``lengths``."""
    cell, bidir = variant_cell(variant)
    jspec = small_jax_spec(cell=cell, bidirectional=bidir)
    params, state = jax_weights(jspec, seed=7)
    spec, model = port_model(jspec, params, state)
    x = np.random.RandomState(5).randn(3, 16, 12).astype(np.float32)
    t_out = spec.output_time_len(16)
    lens = (FRAC * t_out).astype(np.int32) if with_lengths else None
    want, want_state = JModel.apply(
        jspec, jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x), train=train,
        frac=jnp.asarray(FRAC), example_mask=jnp.asarray(EXAMPLE_MASK),
        lengths=None if lens is None else jnp.asarray(lens))
    with torch.set_grad_enabled(train):
        got = model(torch.from_numpy(x), frac=torch.from_numpy(FRAC),
                    example_mask=torch.from_numpy(EXAMPLE_MASK), train=train,
                    lengths=None if lens is None else torch.from_numpy(lens))
    assert got.shape == want.shape == (t_out, 3, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    from ctc_pytorch_tpu_torch.train.checkpoint import params_to_jax

    _, got_state = params_to_jax(spec, model.state_dict())
    g_leaves, g_def = jax.tree_util.tree_flatten(got_state)
    w_leaves, w_def = jax.tree_util.tree_flatten(want_state)
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)
    assert model.training == train
    assert all(len(layer.directions) == (2 if bidir else 1)
               for layer in model.rnns)
