"""The port's CTC loss (plain twins on the CPU) against the JAX package's scan
loss and its Pallas kernels in interpret mode: value, gradient w.r.t. the
log-probabilities, every reduction, ``zero_infinity``, an empty label and an
infeasible utterance.  Inputs come from a numpy seed.

Tolerances: 1e-5 absolute on values of O(10) and on gradients in [-1, 0];
both sides are fp32 log-space sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from ctc_pytorch_tpu.ops.ctc_pallas import (
    _prepare,
    ctc_alpha_pallas,
    ctc_beta_pallas,
    ctc_loss_pallas,
)
from ctc_pytorch_tpu_torch.ops import ctc_loss as ops

TOL = 1e-5


def batch(seed=0, t=8, b=4, c=5, l=3):
    """Row 1 repeats a label (no skip), row 2 cannot be aligned (three equal
    labels need five frames, it has three), row 3 has an empty label."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(t, b, c).astype(np.float32)
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    labels = rng.randint(1, c, (b, l)).astype(np.int32)
    labels[1] = 2
    labels[2] = 3
    in_len = np.array([t, t - 3, 3, t], np.int32)
    lab_len = np.array([l, l, l, 0], np.int32)
    return log_probs, labels, in_len, lab_len


def jax_value_and_grad(fn, log_probs, labels, in_len, lab_len, **kw):
    def total(x):
        return jnp.sum(fn(x, jnp.asarray(labels), jnp.asarray(in_len),
                          jnp.asarray(lab_len), **kw))

    v, g = jax.value_and_grad(total)(jnp.asarray(log_probs))
    return float(v), np.asarray(g)


def port_value_and_grad(log_probs, labels, in_len, lab_len, **kw):
    x = torch.tensor(log_probs, requires_grad=True)
    out = ops.ctc_loss(x, torch.tensor(labels), torch.tensor(in_len),
                       torch.tensor(lab_len), **kw).sum()
    out.backward()
    return out.item(), x.grad.numpy()


@pytest.mark.parametrize("zero_infinity", [False, True])
@pytest.mark.parametrize("reduction",
                         ["none", "sum", "mean", "sum_over_batch"])
def test_loss_and_gradient_match_scan_and_pallas(reduction, zero_infinity):
    args = batch()
    kw = dict(reduction=reduction, zero_infinity=zero_infinity)
    got_v, got_g = port_value_and_grad(*args, **kw)
    assert np.isfinite(got_v) and np.isfinite(got_g).all()
    for fn, extra in ((jax_ctc_loss, {}), (ctc_loss_pallas, {"interpret": True})):
        want_v, want_g = jax_value_and_grad(fn, *args, **kw, **extra)
        np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=TOL)
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=TOL)


def test_infeasible_utterance_has_huge_loss_and_zero_gradient():
    log_probs, labels, in_len, lab_len = batch()
    x = torch.tensor(log_probs, requires_grad=True)
    loss = ops.ctc_loss(x, torch.tensor(labels), torch.tensor(in_len),
                        torch.tensor(lab_len), reduction="none")
    loss.sum().backward()
    assert loss[2].item() >= 1e29 and torch.isfinite(loss).all()
    assert (loss[[0, 1, 3]] < 100).all()
    assert torch.equal(x.grad[:, 2], torch.zeros_like(x.grad[:, 2]))
    assert x.grad[:, 0].abs().max() > 0.1
    zeroed = ops.ctc_loss(x, torch.tensor(labels), torch.tensor(in_len),
                          torch.tensor(lab_len), reduction="none",
                          zero_infinity=True)
    assert zeroed[2].item() == 0.0 and torch.equal(zeroed[[0, 1, 3]],
                                                   loss[[0, 1, 3]])


def test_empty_label_is_the_all_blank_path():
    log_probs, labels, in_len, lab_len = batch()
    loss = ops.ctc_loss(torch.tensor(log_probs), torch.tensor(labels),
                        torch.tensor(in_len), torch.tensor(lab_len),
                        reduction="none")
    np.testing.assert_allclose(loss[3].item(), -log_probs[:, 3, 0].sum(),
                               rtol=1e-6)
    # no label column at all: S = 1
    none = ops.ctc_loss(torch.tensor(log_probs), torch.zeros(4, 0, dtype=torch.int32),
                        torch.tensor(in_len), torch.zeros(4, dtype=torch.int32),
                        reduction="none")
    np.testing.assert_allclose(none[3].item(), loss[3].item(), rtol=1e-6)


def test_frames_past_the_input_length_get_no_gradient():
    log_probs, labels, in_len, lab_len = batch()
    _, g = port_value_and_grad(log_probs, labels, in_len, lab_len,
                               reduction="sum")
    assert np.all(g[in_len[1]:, 1] == 0) and np.any(g[:in_len[1], 1] != 0)


def test_plain_tables_match_the_interpreted_pallas_kernels():
    log_probs, labels, in_len, lab_len = batch(seed=3)
    ext, emit, skip_in, skip_out = _prepare(jnp.asarray(log_probs),
                                            jnp.asarray(labels), 0)
    s_len = 2 * lab_len + 1
    pos_mask = (np.arange(ext.shape[1])[None] < s_len[:, None]).astype(np.float32)
    want_a = np.asarray(ctc_alpha_pallas(emit, skip_in, jnp.asarray(pos_mask),
                                         jnp.asarray(in_len), interpret=True))
    want_b = np.asarray(ctc_beta_pallas(emit, skip_out, jnp.asarray(pos_mask),
                                        jnp.asarray(in_len), jnp.asarray(s_len),
                                        interpret=True))
    t_ext, t_emit, t_in, t_out, t_mask, t_slen = ops.prepare(
        torch.tensor(log_probs), torch.tensor(labels), torch.tensor(lab_len))
    np.testing.assert_array_equal(t_ext.numpy(), np.asarray(ext))
    np.testing.assert_array_equal(t_emit.numpy(), np.asarray(emit))
    np.testing.assert_array_equal(t_in.numpy(), np.asarray(skip_in))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(skip_out))
    got_a = ops.ctc_alpha_plain(t_emit, t_in, t_mask, torch.tensor(in_len)).numpy()
    got_b = ops.ctc_beta_plain(t_emit, t_out, t_mask, torch.tensor(in_len),
                               t_slen).numpy()
    for got, want in ((got_a, want_a), (got_b, want_b)):
        # dead cells sit at exactly NEG_INF in both; live ones agree closely
        np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
        live = want > -1e29
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=TOL)
        assert np.all(got[~live] == np.float32(ops.NEG_INF))


def test_wrapper_has_no_fallback_for_other_devices():
    lp = torch.zeros(2, 1, 3, device="meta")
    lengths = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ctc_fwd(lp, torch.zeros(1, 1, dtype=torch.int32, device="meta"),
                    lengths, lengths)
    assert ops.launches_alpha == 0 and ops.launches_beta == 0


def test_unknown_reduction_raises():
    log_probs, labels, in_len, lab_len = batch()
    with pytest.raises(ValueError, match="unknown reduction"):
        ops.ctc_loss(torch.tensor(log_probs), torch.tensor(labels),
                     torch.tensor(in_len), torch.tensor(lab_len),
                     reduction="median")
