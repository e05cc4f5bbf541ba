"""The trainable tanh-RNN's plain twins (forward and hand-written backward)
against the JAX package's Pallas training kernels in interpret mode and
``jax.grad`` of them: the layer output and all three gradients, and the
backward kernel's ``dgx`` plane itself.

fp32 streams are held to 1e-5 (same fp32 math, other summation order).  With
bf16 streams (B = 16) both sides round at the same points, so outputs differ
by at most a bf16 ulp or two: 2e-2 on ``ys`` and ``dx``, 2e-2 relative to the
largest entry on the weight gradients (sums of bf16-rounded products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.rnn_pallas_v2 import _bwd_pallas, _fwd_pallas
from ctc_pytorch_tpu.ops.rnn_pallas_v2 import rnn_bidir_v2, rnn_scan_v2
from ctc_pytorch_tpu_torch.models.rnn import RNNLayer
from ctc_pytorch_tpu_torch.ops import rnn_bidir as eval_ops
from ctc_pytorch_tpu_torch.ops import rnn_bidir_train as ops
from ctc_pytorch_tpu_torch.ops.lstm_bidir_train import dw_hh


def layer_inputs(t, b, f, h, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, b, f).astype(np.float32)
    w_ih = ((rng.rand(2, f, h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    w_hh = ((rng.rand(2, h, h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)
    return x, w_ih, w_hh, dy


@pytest.mark.parametrize("t,b,cd,chunk,tol", [
    (7, 3, "float32", 1, 1e-5),
    (1, 2, "float32", 1, 1e-5),  # T = 1: no recurrent step at all
    (6, 4, "float32", 2, 1e-5),  # the chunked Pallas backward
    (5, 1, "float32", 2, 1e-5),  # B = 1, odd T padded to the chunk in JAX
    (6, 16, "bfloat16", 1, 2e-2),  # bf16 streams need B % 16 == 0
])
def test_layer_output_and_gradients_match_the_pallas_kernels(t, b, cd, chunk, tol):
    f, h = 5, 16
    x, w_ih, w_hh, dy = layer_inputs(t, b, f, h, seed=t + b)

    def jax_loss(x, w_ih, w_hh):
        ys = rnn_bidir_v2(x, w_ih, w_hh, chunk=chunk, interpret=True,
                          compute_dtype=jnp.dtype(cd), train=True)
        return jnp.sum(ys * dy), ys

    (_, want_ys), (want_dx, want_dwih, want_dwhh) = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh))

    layer = RNNLayer(f, h, batch_norm=False, cell="rnn").train()
    with torch.no_grad():
        for d, mod in enumerate((layer.fwd, layer.bwd)):
            mod.w_ih.copy_(torch.tensor(w_ih[d]))
            mod.w_hh.copy_(torch.tensor(w_hh[d]))
    tx = torch.tensor(x, requires_grad=True)
    ys = layer(tx, getattr(torch, cd))
    assert ys.dtype == torch.float32
    (ys * torch.tensor(dy)).sum().backward()
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(want_ys),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=0,
                               atol=tol)
    for got, want in (
            (torch.stack([layer.fwd.w_ih.grad, layer.bwd.w_ih.grad]), want_dwih),
            (torch.stack([layer.fwd.w_hh.grad, layer.bwd.w_hh.grad]), want_dwhh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_dgx_matches_the_pallas_backward_plane(cd):
    """The kernel-level function: ``(ys, dgx, dW_hh)`` against
    ``rnn_scan_v2`` and its VJP, and ``dgx`` against ``_bwd_pallas`` run on
    the same saved plane and ``dy``, in the stream dtype."""
    t, b, h = 6, 16, 8
    sd = getattr(jnp, cd)
    rng = np.random.RandomState(0)
    gx = rng.randn(t, b, 2 * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)
    jgx, jdy = jnp.asarray(gx).astype(sd), jnp.asarray(dy).astype(sd)
    tg, tw = torch.tensor(gx).to(getattr(torch, cd)), torch.tensor(w_hh)
    td = torch.tensor(dy).to(tg.dtype)
    tol = 1e-5 if cd == "float32" else 2e-2

    ys_store = _fwd_pallas(jgx, jnp.asarray(w_hh), 2, True, with_guard=True)
    want_dgx = _bwd_pallas(jnp.asarray(w_hh), ys_store, jdy, 2, True)
    ys = eval_ops.rnn_bidir_plain(tg, tw)
    dgx = ops.rnn_bidir_train_backward_plain(tw, ys, td)
    assert ys.dtype == dgx.dtype == tg.dtype
    np.testing.assert_allclose(ys.float().numpy(),
                               np.asarray(ys_store[1:t + 1], np.float32),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(dgx.float().numpy(), np.asarray(want_dgx, np.float32),
                               rtol=0, atol=tol)
    if cd == "bfloat16":
        return

    def jax_loss(gx, w):
        ys = rnn_scan_v2(gx, w, 2, True)[1:t + 1]
        return jnp.sum(ys * dy), ys

    _, (want_dgx2, want_dw) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(gx), jnp.asarray(w_hh))
    np.testing.assert_allclose(dgx.numpy(), np.asarray(want_dgx2), atol=1e-5)
    np.testing.assert_allclose(dw_hh(ys, dgx, 2).numpy(), np.asarray(want_dw),
                               rtol=0, atol=1e-5)
    # h = 0 before the first step: dW_hh of a one-step sequence is zero
    assert not dw_hh(ys[:1], dgx[:1], 2).any()


def test_backward_twin_rounds_where_the_kernel_rounds():
    """bf16 streams: ``dgx`` holds bf16 values, ``1 - y^2`` comes from the
    stored (rounded) ``ys``, and ``dpre`` enters ``@ w_hh^T`` as stored."""
    t, b, h = 4, 16, 8
    rng = np.random.RandomState(2)
    w = torch.tensor((rng.randn(2, h, h) / np.sqrt(h)).astype(np.float32))
    ys = torch.tensor(np.tanh(3 * rng.randn(t, b, 2 * h)).astype(np.float32)).bfloat16()
    dy = torch.tensor(rng.randn(t, b, 2 * h).astype(np.float32)).bfloat16()
    dgx = ops.rnn_bidir_train_backward_plain(w, ys, dy)
    assert dgx.dtype == torch.bfloat16
    want = ops.rnn_bidir_train_backward_plain(w.bfloat16().float(), ys.float(),
                                              dy.float())
    assert 0 < (dgx.float() - want).abs().max() < 2e-2
    # the first step of each walk has no later carry: dpre is the fp32
    # formula on the stored values, rounded once
    y = ys.float()
    first = (dy.float() * (1.0 - y * y)).bfloat16()
    assert torch.equal(dgx[-1, :, :h], first[-1, :, :h])
    assert torch.equal(dgx[0, :, h:], first[0, :, h:])
    # the next step of direction 0 reads that stored dpre through w^T
    dh = first[-1, :, :h].float() @ w[0].bfloat16().float().t()
    second = ((dy[-2, :, :h].float() + dh) * (1.0 - y[-2, :, :h] ** 2)).bfloat16()
    assert torch.equal(dgx[-2, :, :h], second)


@pytest.mark.parametrize("ndir", [2, 1])
def test_hand_written_backward_passes_gradcheck_in_float64(ndir):
    t, b, h = 3, 2, 3
    rng = np.random.RandomState(1)
    gx = torch.tensor(rng.randn(t, b, ndir * h), dtype=torch.float64,
                      requires_grad=True)
    w_hh = torch.tensor(rng.randn(ndir, h, h) / np.sqrt(h), dtype=torch.float64,
                        requires_grad=True)
    assert torch.autograd.gradcheck(ops.rnn_bidir_train, (gx, w_hh),
                                    eps=1e-6, atol=1e-6)


def test_training_forward_is_the_eval_function():
    t, b, h = 6, 3, 8
    rng = np.random.RandomState(2)
    gx = torch.tensor(rng.randn(t, b, 2 * h).astype(np.float32))
    w = torch.tensor((rng.randn(2, h, h) / np.sqrt(h)).astype(np.float32))
    assert torch.equal(ops.rnn_bidir_train(gx, w), eval_ops.rnn_bidir_plain(gx, w))
    assert ops.LIBRARY.source.name == "rnn_bidir_train.cu"
    assert eval_ops.LIBRARY.source.name == "rnn_bidir.cu"


def test_wrapper_has_no_fallback_for_other_devices():
    gx = torch.zeros(2, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rnn_bidir_train(gx, torch.zeros(2, 4, 4, device="meta"))
    assert ops.launches_fwd == 0 and ops.launches_bwd == 0
