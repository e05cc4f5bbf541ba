"""Import of a reference PyTorch package (``cli/import_torch.py``) against
the JAX package's import on the CPU: a module with the reference's
``CTC_Model`` tree (``chip_smoke.reference_package``) is saved as a
``.pkl``; the port's import gives the model spec and every parameter and
BN statistic of the JAX import, its eval forward equals the reference
module's (rtol 1e-3, atol 1e-4, as ``tests/test_import_torch.py``), and
the package it writes decodes in both packages' ``cli.test``."""

import jax
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.cli.import_torch import import_torch_package as jax_import
from ctc_pytorch_tpu.cli.import_torch import params_from_state_dict
from ctc_pytorch_tpu.cli.import_torch import spec_from_torch_package as jax_spec
from ctc_pytorch_tpu.train.checkpoint import model_from_package as jax_model_from_package
from ctc_pytorch_tpu_torch.cli import import_torch
from ctc_pytorch_tpu_torch.train.checkpoint import (
    load_package,
    model_from_package,
    params_from_jax,
)
from tests.test_torch_cuda import chip_smoke

# (feat, CNN layers, hidden, layers, classes, cell, activation, batch_norm,
# bidirectional): the flagship's tree, the 863 CNN's, no CNN, no BN, one
# direction
CASES = {
    "flagship": (20, [((1, 4), (3, 3), (1, 2), (1, 1)),
                      ((4, 4), (3, 3), (2, 2), (1, 1))], 8, 2, 6, "LSTM",
                 "relu", True, True),
    "863_cnn": (31, [((1, 3), (11, 5), (2, 2), (0, 0))], 8, 2, 7, "LSTM",
                "hardtanh", True, True),
    "no_cnn_gru": (12, [], 6, 2, 5, "GRU", "relu", True, True),
    "no_bn_unidir": (12, [], 6, 2, 5, "LSTM", "relu", False, False),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def saved(tmp_path, name):
    pkg = chip_smoke.reference_package(*CASES[name], seed=3)
    module = pkg.pop("module")
    path = tmp_path / "ctc_best_model.pkl"
    torch.save(pkg, path)
    return path, pkg, module


@pytest.mark.parametrize("name", list(CASES))
def test_import_matches_the_jax_import_and_the_reference_forward(
        tmp_path, name):
    path, pkg, module = saved(tmp_path, name)
    spec = import_torch.spec_from_torch_package(pkg)
    jspec = jax_spec(pkg)
    assert spec.to_dict() == jspec.to_dict()
    assert spec.compute_dtype == "float32"
    assert CASES[name][7] == ("num_batches_tracked" in " ".join(
        pkg["state_dict"]))  # BN's counters are in the state_dict
    model = import_torch.model_from_state_dict(spec, pkg["state_dict"])
    params, mstate = params_from_state_dict(jspec, pkg["state_dict"])
    want = params_from_jax(spec, jax.tree_util.tree_map(np.asarray, params),
                           jax.tree_util.tree_map(np.asarray, mstate))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)

    x = torch.from_numpy(np.random.RandomState(1).randn(
        3, 24, CASES[name][0]).astype(np.float32))
    with torch.no_grad():
        ref = module(x)
        ours = model(x)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-3, atol=1e-4)

    out = tmp_path / "imported.npz"
    jout = tmp_path / "jax_imported.npz"
    import_torch.main([str(path), str(out)])
    jax_import(str(path), str(jout))
    man, jman = (load_package(p)["manifest"] for p in (out, jout))
    for key in ("spec", "epoch", "leaf_counts"):
        assert man[key] == jman[key], key
    for key in ("loss_results", "dev_loss_results", "dev_cer_results"):
        assert man[key] == pytest.approx(jman[key]) == pkg[key], key
    # the port's package loads in both packages, leaf for leaf the JAX one's
    _, loaded, _ = model_from_package(out, "cpu")
    _, jloaded, _ = model_from_package(jout, "cpu")
    _, jp, jm, _ = jax_model_from_package(str(out))
    for k, v in jloaded.state_dict().items():
        np.testing.assert_array_equal(loaded.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves((jp, jm)),
                    jax.tree_util.tree_leaves((params, mstate))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_keys_the_port_cannot_hold_raise(tmp_path):
    _, pkg, _ = saved(tmp_path, "no_cnn_gru")
    spec = import_torch.spec_from_torch_package(pkg)
    sd = dict(pkg["state_dict"])
    sd["rnns.0.rnn.bias_ih_l0"] = torch.zeros(18)
    with pytest.raises(ValueError, match="bias_ih_l0"):
        import_torch.model_from_state_dict(spec, sd)
    sd = dict(pkg["state_dict"])
    del sd["fc.1.weight"]
    with pytest.raises(KeyError, match="fc.1.weight"):
        import_torch.model_from_state_dict(spec, sd)
