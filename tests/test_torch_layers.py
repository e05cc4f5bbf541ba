"""Port layers (BN, linear, CNN stack) against the JAX package, eval mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctc_pytorch_tpu.config import CNNConfig as JCNNConfig
from ctc_pytorch_tpu.models.cnn import cnn_stack_apply
from ctc_pytorch_tpu.models.layers import batchnorm_apply, linear_apply
from ctc_pytorch_tpu_torch.config import CNNConfig
from ctc_pytorch_tpu_torch.models.cnn import CNNStack
from ctc_pytorch_tpu_torch.models.layers import BatchNorm, Linear


def _bn_arrays(dim, rng, with_count=True):
    params = {"scale": rng.uniform(0.5, 1.5, dim).astype(np.float32),
              "bias": rng.randn(dim).astype(np.float32)}
    state = {"mean": rng.randn(dim).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, dim).astype(np.float32)}
    if with_count:
        state["count"] = np.int32(5)
    return params, state


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_eval_matches_jax(masked):
    rng = np.random.RandomState(0)
    x = rng.randn(6, 3, 10).astype(np.float32)
    mask = (rng.rand(6, 3) > 0.3).astype(np.float32) if masked else None
    params, state = _bn_arrays(10, rng)
    want, new_state = batchnorm_apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(x), train=False,
        mask=None if mask is None else jnp.asarray(mask))
    bn = BatchNorm(10).eval()
    bn.load_state_dict({k: torch.from_numpy(np.asarray(v))
                        for k, v in {**params, **state}.items()})
    with torch.no_grad():
        got = bn(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if masked:  # invalid rows are exactly zero in eval too
        assert np.all(got.numpy()[mask == 0] == 0)


def test_batchnorm_keeps_the_input_dtype():
    bn = BatchNorm(4).eval()
    x = torch.randn(3, 4).to(torch.bfloat16)
    assert bn(x).dtype == torch.bfloat16


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_linear_matches_jax(cd):
    rng = np.random.RandomState(1)
    x = rng.randn(5, 8).astype(np.float32)
    w = rng.randn(8, 3).astype(np.float32)
    want = np.asarray(linear_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                                   jnp.dtype(cd)))
    lin = Linear(8, 3)
    lin.load_state_dict({"w": torch.from_numpy(w)})
    with torch.no_grad():
        got = lin(torch.from_numpy(x), getattr(torch, cd))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _cnn_cfgs(pooling, activation):
    kw = dict(add_cnn=True, layers=2, channel=[(1, 2), (2, 3)],
              kernel_size=[(3, 3), (3, 3)], stride=[(1, 2), (2, 2)],
              padding=[(1, 1), (1, 1)], pooling=pooling,
              activation_function=activation)
    return JCNNConfig(**kw), CNNConfig(**kw)


@pytest.mark.parametrize("t_valid", [None, 11, 20])
@pytest.mark.parametrize("pooling,activation", [
    (None, "relu"),
    ([(2, 1), None], "hardtanh"),
])
def test_cnn_stack_eval_matches_jax(t_valid, pooling, activation):
    """Eval forward, including the batchmax cutoff and tail zeroing."""
    jcfg, tcfg = _cnn_cfgs(pooling, activation)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 1, 24, 12).astype(np.float32)
    jparams, jstates, sd = [], [], {}
    for i, (cin, cout) in enumerate(tcfg.channel):
        w = (rng.randn(cout, cin, 3, 3) * 0.4).astype(np.float32)
        b = rng.randn(cout).astype(np.float32) * 0.1
        bp, bs = _bn_arrays(cout, rng, with_count=False)
        jparams.append({"w": jnp.asarray(w), "b": jnp.asarray(b),
                        "bn": {k: jnp.asarray(v) for k, v in bp.items()}})
        jstates.append({"bn": {k: jnp.asarray(v) for k, v in bs.items()}})
        sd.update({f"{i}.w": w, f"{i}.b": b})
        sd.update({f"{i}.bn.{k}": v for k, v in {**bp, **bs}.items()})
    tv = None if t_valid is None else jnp.asarray(t_valid, jnp.int32)
    want, _ = cnn_stack_apply(jparams, jstates, jnp.asarray(x), jcfg,
                              compute_dtype=jnp.float32, t_valid=tv)
    stack = CNNStack(tcfg).eval()
    stack.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        got = stack(torch.from_numpy(x), torch.float32,
                    None if t_valid is None else torch.tensor(t_valid, dtype=torch.int32))
    want_nchw = np.asarray(want).transpose(0, 3, 1, 2)
    assert got.shape == want_nchw.shape
    np.testing.assert_allclose(got.numpy(), want_nchw, rtol=1e-5, atol=1e-5)
    if t_valid is not None and pooling is None:
        cut = tcfg.output_time_len(t_valid)
        assert cut < got.shape[2] and np.all(got.numpy()[:, :, cut:] == 0)
