"""Unidirectional layers of all three cells against the JAX package.

A layer with ``bidirectional: False`` runs its cell's Hopper kernels with one
direction (``ndir = 1``); the JAX package runs it on its scan path
(``rnn_layer_apply`` with no ``bwd``, i.e. ``_scan_direction``).  On the CPU
the port runs the kernels' plain twins.

fp32: the same function, held to the layer tolerance of the other layer tests
(rtol 2e-4, atol 2e-5; gradients 1e-5 absolute, relative to the largest
entry for the weights).  bf16: the JAX scan keeps ``gx`` and the carries fp32
and rounds only the product operands, while the port stores ``gx`` and
``ys`` in bf16 too (bf16 streams at B % 16 == 0, ``models/rnn.py``), so the
two differ by those roundings: 3e-2 on outputs and ``dx``, 3e-2 of the
largest entry on weight gradients.  Each one-direction call is also held to
the forward half of the two-direction call of the same op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.models.rnn import rnn_layer_apply
from ctc_pytorch_tpu_torch.models.rnn import CELLS, RNNLayer

GATES = {"lstm": 4, "gru": 3, "rnn": 1}


def _inputs(cell, t, b, f, h, seed):
    n = GATES[cell]
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(h)
    return dict(
        x=rng.randn(t, b, f).astype(np.float32),
        w_ih=rng.uniform(-bound, bound, (f, n * h)).astype(np.float32),
        w_hh=rng.uniform(-bound, bound, (h, n * h)).astype(np.float32),
        bn={"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
            "bias": rng.randn(f).astype(np.float32)},
        bn_state={"mean": rng.randn(f).astype(np.float32),
                  "var": rng.uniform(0.5, 2.0, f).astype(np.float32),
                  "count": np.int32(3)},
        dy=rng.randn(t, b, h).astype(np.float32))


def _port_layer(cell, d, with_bn):
    f, nh = d["w_ih"].shape
    h = d["w_hh"].shape[0]
    layer = RNNLayer(f, h, batch_norm=with_bn, cell=cell, bidirectional=False)
    sd = {"fwd.w_ih": torch.from_numpy(d["w_ih"]),
          "fwd.w_hh": torch.from_numpy(d["w_hh"])}
    if with_bn:
        sd.update({f"bn.{k}": torch.from_numpy(np.asarray(v))
                   for k, v in {**d["bn"], **d["bn_state"]}.items()})
    layer.load_state_dict(sd)
    assert layer.bwd is None and nh == GATES[cell] * h
    return layer


def _jax_layer(cell, d, with_bn):
    params = {"fwd": {"w_ih": jnp.asarray(d["w_ih"]),
                      "w_hh": jnp.asarray(d["w_hh"])}}
    state = {}
    if with_bn:
        params["bn"] = jax.tree_util.tree_map(jnp.asarray, d["bn"])
        state["bn"] = jax.tree_util.tree_map(jnp.asarray, d["bn_state"])
    return params, state


@pytest.mark.parametrize("with_bn,with_lengths", [
    (False, False), (True, False), (False, True), (True, True),
])
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_eval_layer_matches_the_jax_scan_direction(cell, with_bn, with_lengths):
    t, b, f, h = 7, 3, 6, 8
    d = _inputs(cell, t, b, f, h, seed=4)
    lens = np.array([7, 5, 2], np.int32)
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    params, state = _jax_layer(cell, d, with_bn)
    want, _ = rnn_layer_apply(
        params, state, jnp.asarray(d["x"]), cell=cell, hidden_size=h,
        compute_dtype=jnp.float32, bn_mask=jnp.asarray(mask) if with_bn else None,
        lengths=jnp.asarray(lens) if with_lengths else None)
    layer = _port_layer(cell, d, with_bn).eval()
    with torch.no_grad():
        got = layer(torch.from_numpy(d["x"]), torch.float32,
                    torch.from_numpy(mask) if with_bn else None,
                    lengths=torch.from_numpy(lens) if with_lengths else None)
    assert got.shape == (t, b, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    if with_lengths:
        assert not got[5:, 1].any() and not got[2:, 2].any()  # zero past the length


@pytest.mark.parametrize("cd,b,tol", [("float32", 3, 1e-5), ("bfloat16", 16, 3e-2)])
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_train_layer_and_gradients_match_jax_grad(cell, cd, b, tol):
    t, f, h = 6, 5, 8
    d = _inputs(cell, t, b, f, h, seed=b + GATES[cell])
    params, _ = _jax_layer(cell, d, False)

    def jax_loss(x, w_ih, w_hh):
        p = {"fwd": {"w_ih": w_ih, "w_hh": w_hh}}
        ys, _ = rnn_layer_apply(p, {}, x, cell=cell, hidden_size=h, train=True,
                                compute_dtype=jnp.dtype(cd))
        return jnp.sum(ys * d["dy"]), ys

    (_, want_ys), want_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(d["x"]), params["fwd"]["w_ih"], params["fwd"]["w_hh"])
    layer = _port_layer(cell, d, False).train()
    x = torch.tensor(d["x"], requires_grad=True)
    ys = layer(x, getattr(torch, cd))
    (ys * torch.from_numpy(d["dy"])).sum().backward()
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(want_ys),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grads[0]),
                               rtol=0, atol=tol)
    for got, want in ((layer.fwd.w_ih.grad, want_grads[1]),
                      (layer.fwd.w_hh.grad, want_grads[2])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_one_direction_is_the_forward_half_of_two(cell):
    """The ops with ``w_hh (1, H, nH)`` compute what the forward direction of
    the two-direction call computes: outputs and both gradients."""
    t, b, h = 5, 3, 4
    n = GATES[cell]
    _, eval_op, train_op = CELLS[cell]
    rng = np.random.RandomState(9)
    gx = torch.tensor(rng.randn(t, b, 2 * n * h).astype(np.float32))
    w = torch.tensor((rng.randn(2, h, n * h) / np.sqrt(h)).astype(np.float32))
    dy = torch.tensor(rng.randn(t, b, h).astype(np.float32))
    both = eval_op(gx, w)
    one = eval_op(gx[..., :n * h].contiguous(), w[:1].contiguous())
    np.testing.assert_allclose(one.numpy(), both[..., :h].numpy(), atol=1e-6,
                               rtol=0)
    grads = []
    for gx_in, w_in, lanes in ((gx, w, slice(0, h)),
                               (gx[..., :n * h], w[:1], slice(0, h))):
        g = gx_in.clone().requires_grad_(True)
        ww = w_in.clone().requires_grad_(True)
        (train_op(g, ww)[..., lanes] * dy).sum().backward()
        grads.append((g.grad[..., :n * h], ww.grad[:1]))
    for got, want in zip(grads[1], grads[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
