"""The port's BiLSTM recurrence and RNN layer against the JAX package.

On the CPU ``ops.lstm_bidir`` runs its plain twin; it must compute what the
Pallas kernel ``lstm_bidir_pallas_v2`` computes (run here in interpret
mode) and what the scan path computes, at the tolerances of
``tests/test_lstm_pallas_v2.py``.  The kernel itself is held against the
plain twin on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctc_pytorch_tpu.models.rnn import _scan_bidir_fused, rnn_layer_apply
from ctc_pytorch_tpu.ops.lstm_pallas import stream_dtype_for as jax_stream_dtype
from ctc_pytorch_tpu.ops.lstm_pallas_v2 import lstm_bidir_pallas_v2
from ctc_pytorch_tpu_torch.models.rnn import RNNLayer, stream_dtype_for
from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops


def _weights(t, b, f, h, seed):
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(h)
    x = rng.randn(t, b, f).astype(np.float32)
    w_ih = rng.uniform(-bound, bound, (2, f, 4 * h)).astype(np.float32)
    w_hh = rng.uniform(-bound, bound, (2, h, 4 * h)).astype(np.float32)
    return x, w_ih, w_hh


def _port_lstm(x, w_ih, w_hh):
    t, b, f = x.shape
    w_cat = torch.cat([torch.from_numpy(w_ih[0]), torch.from_numpy(w_ih[1])], 1)
    gx = (torch.from_numpy(x).reshape(t * b, f) @ w_cat).reshape(t, b, -1)
    return lstm_ops.lstm_bidir(gx, torch.from_numpy(w_hh)).numpy()


@pytest.mark.parametrize("t,b,f,h,chunk", [
    (16, 3, 5, 4, 4),
    (9, 2, 4, 4, 1),  # odd T
    (1, 2, 4, 4, 1),  # T = 1
    (24, 4, 6, 16, 8),
])
def test_plain_lstm_matches_pallas_v2_and_scan(t, b, f, h, chunk):
    x, w_ih, w_hh = _weights(t, b, f, h, seed=t + h)
    got = _port_lstm(x, w_ih, w_hh)
    v2 = lstm_bidir_pallas_v2(jnp.asarray(x), jnp.asarray(w_ih),
                              jnp.asarray(w_hh), chunk=chunk, interpret=True)
    params = {"fwd": {"w_ih": jnp.asarray(w_ih[0]), "w_hh": jnp.asarray(w_hh[0])},
              "bwd": {"w_ih": jnp.asarray(w_ih[1]), "w_hh": jnp.asarray(w_hh[1])}}
    scan = _scan_bidir_fused(params, jnp.asarray(x), "lstm", h, jnp.float32)
    assert got.shape == (t, b, 2 * h) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(v2), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(scan), rtol=2e-4, atol=2e-5)


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    x, w_ih, w_hh = _weights(5, 2, 3, 4, seed=0)
    before = lstm_ops.launches
    _port_lstm(x, w_ih, w_hh)
    assert lstm_ops.launches == before


def test_plain_lstm_rounds_outputs_to_the_stream_dtype():
    gen = torch.Generator().manual_seed(0)
    gx = torch.randn(6, 3, 32, generator=gen).to(torch.bfloat16)
    w_hh = torch.rand(2, 4, 16, generator=gen) - 0.5
    ys = lstm_ops.lstm_bidir(gx, w_hh)
    assert ys.dtype == torch.float32
    assert torch.equal(ys, ys.to(torch.bfloat16).float())
    ref = lstm_ops.lstm_bidir(gx.float(), w_hh)
    assert (ys - ref).abs().max().item() < 2e-2


@pytest.mark.parametrize("b", [8, 16, 32])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_stream_dtype_rule_matches_jax(cd, b):
    want = jnp.dtype(jax_stream_dtype(jnp.dtype(cd), b)).name
    assert str(stream_dtype_for(getattr(torch, cd), b)) == f"torch.{want}"


@pytest.mark.parametrize("with_bn", [False, True])
def test_rnn_layer_matches_jax(with_bn):
    t, b, f, h = 7, 3, 6, 8
    x, w_ih, w_hh = _weights(t, b, f, h, seed=3)
    rng = np.random.RandomState(4)
    bn = {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
          "bias": rng.randn(f).astype(np.float32)}
    bn_state = {"mean": rng.randn(f).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, f).astype(np.float32),
                "count": np.int32(3)}
    mask = (np.arange(t)[:, None] < np.array([7, 5, 2])[None, :]).astype(np.float32)
    params = {"fwd": {"w_ih": w_ih[0], "w_hh": w_hh[0]},
              "bwd": {"w_ih": w_ih[1], "w_hh": w_hh[1]}}
    state = {}
    if with_bn:
        params["bn"], state["bn"] = bn, bn_state
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}
    js = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in state.items()}
    want, _ = rnn_layer_apply(jp, js, jnp.asarray(x), cell="lstm", hidden_size=h,
                              compute_dtype=jnp.float32,
                              bn_mask=jnp.asarray(mask) if with_bn else None)

    layer = RNNLayer(f, h, batch_norm=with_bn).eval()
    sd = {f"{d}.{w}": torch.from_numpy(params[d][w])
          for d in ("fwd", "bwd") for w in ("w_ih", "w_hh")}
    if with_bn:
        sd.update({f"bn.{k}": torch.from_numpy(np.asarray(v))
                   for k, v in {**bn, **bn_state}.items()})
    layer.load_state_dict(sd)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.float32,
                    torch.from_numpy(mask) if with_bn else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
