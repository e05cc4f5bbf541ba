"""The trainable BiGRU's plain twins (forward and hand-written backward)
against the JAX package's Pallas training kernels in interpret mode and
``jax.grad`` of them: the layer output and all three gradients.

fp32 streams are held to 1e-5 (same fp32 math, other summation order; the
chunked Pallas backward hoists its gate pre-pass and differs by ulps).  With
bf16 streams (B = 16) both sides round at the same points, so outputs differ
by at most a bf16 ulp or two: 2e-2 on ``ys`` and ``dx``, 2e-2 relative to the
largest entry on the weight gradients (sums of bf16-rounded products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.gru_pallas_v2 import gru_bidir_v2, gru_scan_train_v2
from ctc_pytorch_tpu_torch.models.rnn import RNNLayer
from ctc_pytorch_tpu_torch.ops import gru_bidir as eval_ops
from ctc_pytorch_tpu_torch.ops import gru_bidir_train as ops


def layer_inputs(t, b, f, h, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, b, f).astype(np.float32)
    w_ih = ((rng.rand(2, f, 3 * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    w_hh = ((rng.rand(2, h, 3 * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)
    return x, w_ih, w_hh, dy


@pytest.mark.parametrize("t,b,cd,chunk,tol", [
    (7, 3, "float32", 1, 1e-5),
    (1, 2, "float32", 1, 1e-5),  # T = 1: no recurrent step at all
    (6, 4, "float32", 2, 1e-5),  # the chunked (hoisted) Pallas backward
    (5, 1, "float32", 2, 1e-5),  # B = 1, odd T padded to the chunk in JAX
    (6, 16, "bfloat16", 1, 2e-2),  # bf16 streams need B % 16 == 0
])
def test_layer_output_and_gradients_match_the_pallas_kernels(t, b, cd, chunk, tol):
    f, h = 5, 16
    x, w_ih, w_hh, dy = layer_inputs(t, b, f, h, seed=t + b)

    def jax_loss(x, w_ih, w_hh):
        ys = gru_bidir_v2(x, w_ih, w_hh, chunk=chunk, interpret=True,
                          compute_dtype=jnp.dtype(cd), train=True)
        return jnp.sum(ys * dy), ys

    (_, want_ys), (want_dx, want_dwih, want_dwhh) = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh))

    layer = RNNLayer(f, h, batch_norm=False, cell="gru").train()
    with torch.no_grad():
        layer.fwd.w_ih.copy_(torch.tensor(w_ih[0]))
        layer.bwd.w_ih.copy_(torch.tensor(w_ih[1]))
        layer.fwd.w_hh.copy_(torch.tensor(w_hh[0]))
        layer.bwd.w_hh.copy_(torch.tensor(w_hh[1]))
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


def test_both_backward_planes_match_the_pallas_residuals():
    """The kernel-level function: gx in, (ys, dgx, dW_hh) out, against
    ``gru_scan_train_v2`` and its VJP; ``dhhn`` against its definition."""
    t, b, h = 5, 2, 16
    rng = np.random.RandomState(0)
    gx = rng.randn(t, b, 6 * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, 3 * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)

    def jax_loss(gx, w):
        ys = gru_scan_train_v2(gx, w, 1, True)[1:t + 1]
        return jnp.sum(ys * dy), ys

    (_, want_ys), (want_dgx, want_dw) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(gx), jnp.asarray(w_hh))
    tg, tw = torch.tensor(gx), torch.tensor(w_hh)
    ys = eval_ops.gru_bidir_plain(tg, tw)
    dgx, dhhn = ops.gru_bidir_train_backward_plain(tg, tw, ys, torch.tensor(dy))
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dgx.numpy(), np.asarray(want_dgx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ops.dw_hh(ys, dgx, dhhn).numpy(),
                               np.asarray(want_dw), rtol=0, atol=1e-5)
    # dhhn = dpre_n * r, with r recomputed from the saved ys of the step before
    h_prev = torch.cat([torch.zeros(1, b, h), ys[:-1, :, :h]])  # direction 0
    hh = h_prev @ tw[0]
    r = torch.sigmoid(tg[..., :h] + hh[..., :h])
    np.testing.assert_allclose(dhhn[..., :h].numpy(),
                               (dgx[..., 2 * h:3 * h] * r).numpy(), atol=1e-6)
    # h = 0 before the first step: dW_hh of a one-step sequence is zero
    assert not ops.dw_hh(ys[:1], dgx[:1], dhhn[:1]).any()


def test_hand_written_backward_passes_gradcheck_in_float64():
    t, b, h = 3, 2, 3
    rng = np.random.RandomState(1)
    gx = torch.tensor(rng.randn(t, b, 6 * h), dtype=torch.float64,
                      requires_grad=True)
    w_hh = torch.tensor(rng.randn(2, h, 3 * h) / np.sqrt(h), dtype=torch.float64,
                        requires_grad=True)
    assert torch.autograd.gradcheck(ops.gru_bidir_train, (gx, w_hh),
                                    eps=1e-6, atol=1e-6)


def test_backward_twin_rounds_where_the_kernel_rounds():
    """bf16 streams: both planes hold bf16 values, and the exchange operand
    ``[dpre_r, dpre_z, dhh_n]`` enters ``@ w_hh^T`` as stored."""
    t, b, h = 4, 16, 8
    rng = np.random.RandomState(2)
    gx = torch.tensor(rng.randn(t, b, 6 * h).astype(np.float32)).bfloat16()
    w = torch.tensor((rng.randn(2, h, 3 * h) / np.sqrt(h)).astype(np.float32))
    dy = torch.tensor(rng.randn(t, b, 2 * h).astype(np.float32)).bfloat16()
    ys = eval_ops.gru_bidir_plain(gx, w)
    dgx, dhhn = ops.gru_bidir_train_backward_plain(gx, w, ys, dy)
    assert dgx.dtype == dhhn.dtype == ys.dtype == torch.bfloat16
    want_dgx, want_dhhn = ops.gru_bidir_train_backward_plain(
        gx.float(), w.bfloat16().float(), ys.float(), dy.float())
    assert (dgx.float() - want_dgx).abs().max() < 2e-2
    assert (dhhn.float() - want_dhhn).abs().max() < 2e-2
    # the last step of each walk has no later step: its dh is dy alone, so
    # dpre there is exactly the fp32 formula rounded once
    assert torch.equal(dgx[-1, :, :3 * h], want_dgx[-1, :, :3 * h].bfloat16())
    assert torch.equal(dgx[0, :, 3 * h:], want_dgx[0, :, 3 * h:].bfloat16())


def test_training_forward_is_the_eval_function():
    t, b, h = 6, 3, 8
    rng = np.random.RandomState(2)
    gx = torch.tensor(rng.randn(t, b, 6 * h).astype(np.float32))
    w = torch.tensor((rng.randn(2, h, 3 * h) / np.sqrt(h)).astype(np.float32))
    assert torch.equal(ops.gru_bidir_train(gx, w), eval_ops.gru_bidir_plain(gx, w))
    assert ops.LIBRARY.source.name == "gru_bidir_train.cu"
    assert eval_ops.LIBRARY.source.name == "gru_bidir.cu"


def test_wrapper_has_no_fallback_for_other_devices():
    gx = torch.zeros(2, 1, 24, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.gru_bidir_train(gx, torch.zeros(2, 4, 12, device="meta"))
    assert ops.launches_fwd == 0 and ops.launches_bwd == 0


def _jax_gru_planes(gx, w_hh, ys):
    """The JAX package's pre-pass formulas (``gru_pallas_v2.py``, the
    hoisted branch of ``_make_bwd_kernel``) in jnp over forward time: the
    five planes ``(2, T, 5, B, H)``."""
    t, b, _ = gx.shape
    h = w_hh.shape[1]
    zero = jnp.zeros((1, b, h), jnp.float32)
    hp = jnp.stack([jnp.concatenate([zero, ys[:-1, :, :h]]),
                    jnp.concatenate([ys[1:, :, h:], zero])])
    hh = jax.lax.dot_general(
        hp.reshape(2, t * b, h), w_hh, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32).reshape(2, t, b, 3 * h)
    gxa = jnp.stack([gx[..., :3 * h], gx[..., 3 * h:]])
    r = jax.nn.sigmoid(gxa[..., :h] + hh[..., :h])
    z = jax.nn.sigmoid(gxa[..., h:2 * h] + hh[..., h:2 * h])
    hh_n = hh[..., 2 * h:]
    n = jnp.tanh(gxa[..., 2 * h:] + r * hh_n)
    p_n = (1.0 - z) * (1.0 - n * n)
    return jnp.stack([p_n * hh_n * (r * (1.0 - r)), (hp - n) * (z * (1.0 - z)),
                      p_n, p_n * r, z], axis=2)


@pytest.mark.parametrize("t,b,h", [(5, 3, 16), (1, 2, 8), (4, 1, 13)])
def test_prepass_planes_match_the_jax_formulas(t, b, h):
    rng = np.random.RandomState(t + b + h)
    gx = rng.randn(t, b, 6 * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, 3 * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    tg, tw = torch.tensor(gx), torch.tensor(w_hh)
    ys = eval_ops.gru_bidir_plain(tg, tw)
    planes = ops.gru_bidir_train_bwd_prepass_plain(tg, tw, ys)
    want = _jax_gru_planes(jnp.asarray(gx), jnp.asarray(w_hh),
                           jnp.asarray(ys.numpy()))
    assert planes.shape == (2, t, ops.PLANES, b, h)
    np.testing.assert_allclose(planes.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# (T, B, H, chunk of the Pallas kernel, directions, stream dtype, tolerance)
@pytest.mark.parametrize("t,b,h,chunk,ndir,cd,tol", [
    (6, 4, 16, 1, 2, "float32", 1e-5),
    (6, 4, 16, 2, 2, "float32", 1e-5),
    (1, 2, 16, 1, 2, "float32", 1e-5),  # T = 1
    (5, 1, 16, 1, 2, "float32", 1e-5),  # B = 1
    (6, 3, 13, 2, 2, "float32", 1e-5),  # odd H
    (6, 4, 16, 2, 1, "float32", 1e-5),  # one direction
    (4, 16, 16, 1, 2, "bfloat16", 2e-2),
])
def test_hoisted_backward_twin_matches_the_pallas_vjp(t, b, h, chunk, ndir,
                                                       cd, tol):
    """Pre-pass twin + serial twin against the VJP of ``gru_scan_train_v2``
    (interpret mode): dgx, and dW_hh, which is formed from dhhn; with one
    direction, against direction 0 of it."""
    rng = np.random.RandomState(10 * t + b + h)
    gx = rng.randn(t, b, 6 * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, 3 * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)
    sd = jnp.dtype(cd)

    def jax_loss(gx, w):
        ys = gru_scan_train_v2(gx, w, chunk, True)[1:t + 1]
        return jnp.sum(ys.astype(jnp.float32) * dy)

    want_dgx, want_dw = (np.asarray(a, dtype=np.float32) for a in jax.grad(
        jax_loss, argnums=(0, 1))(jnp.asarray(gx).astype(sd), jnp.asarray(w_hh)))
    tdt = getattr(torch, cd)
    tg, tw = torch.tensor(gx).to(tdt), torch.tensor(w_hh)
    td = torch.tensor(dy).to(tdt)
    if ndir == 1:
        tg, tw, td = tg[..., :3 * h], tw[:1], td[..., :h]
        want_dgx, want_dw = want_dgx[..., :3 * h], want_dw[:1]
    ys = eval_ops.gru_bidir_plain(tg, tw)
    dgx, dhhn = ops.gru_bidir_train_backward_plain(tg, tw, ys, td)
    assert dgx.dtype == dhhn.dtype == tdt and dhhn.shape == (t, b, ndir * h)
    np.testing.assert_allclose(dgx.float().numpy(), want_dgx, rtol=0, atol=tol)
    dw = ops.dw_hh(ys, dgx, dhhn, ndir).numpy()
    np.testing.assert_allclose(dw, want_dw, rtol=0,
                               atol=tol * max(1.0, np.abs(want_dw).max()))
