"""The port's CTC loss as its two kernels' plain twins compute it on the CPU
(``ctc_fwd_plain`` and ``ctc_bwd_plain``, reached through ``ctc_loss``)
against the JAX package's scan loss and its Pallas loss in interpret mode,
at the cases the kernels must get right: repeated labels, a class three
times, a blank other than 0, S = 1, T = 1, an infeasible utterance, frames
past the input length, padded label slots, int64 labels, and an upstream
gradient that is not all ones (the trainer's masked mean).  Then the
dispatchers' checks, and bf16 log-probabilities.  Inputs come from a numpy
seed.

Tolerances: 1e-5 absolute on values of O(10) and on gradients in [-1, 0];
both sides are fp32 log-space sums in another order.  bf16: one bf16 ulp
at 1 (2^-8) on the bf16 gradient, which rounds an fp32 one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from ctc_pytorch_tpu.ops.ctc_pallas import ctc_loss_pallas
from ctc_pytorch_tpu_torch.ops import ctc_loss as ops

TOL = 1e-5
BF16_ULP = 2.0 ** -8


def log_softmax(rng, t, b, c):
    logits = rng.randn(t, b, c).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))


def case_batch(name):
    """``(log_probs, labels, input_lengths, label_lengths, blank)``."""
    rng = np.random.RandomState(sum(map(ord, name)))
    t, b, c, blank = 9, 3, 6, 0
    labels = np.array([[1, 2, 3, 4], [2, 3, 4, 5], [5, 4, 3, 2]], np.int32)
    in_len = np.array([9, 9, 9], np.int32)
    lab_len = np.array([4, 4, 4], np.int32)
    if name == "repeated labels":
        labels[0] = [2, 2, 3, 3]  # no skip between the equal neighbours
        labels[1] = [1, 1, 1, 4]
    elif name == "a class three times":
        labels[0] = [3, 1, 3, 3]
        labels[2] = [2, 5, 2, 5]
    elif name == "blank = C - 1":
        blank = c - 1
        labels = np.array([[0, 1, 2, 3], [4, 0, 4, 1], [2, 2, 0, 3]], np.int32)
    elif name == "S = 1":
        labels = np.zeros((b, 0), np.int32)
        lab_len[:] = 0
    elif name == "T = 1":
        t = 1
        in_len[:] = 1
        lab_len[:] = [1, 0, 1]
    elif name == "an infeasible utterance":
        labels[1] = [3, 3, 3, 3]  # needs seven frames, has five
        in_len[1] = 5
    elif name == "frames past the input length":
        in_len[:] = [9, 5, 7]
    elif name == "padded label slots":
        lab_len[:] = [4, 2, 1]
        labels[1, 2:] = 0  # the recipes' batches pad with 0
        labels[2, 1:] = 0
    elif name == "int64 labels":
        labels = labels.astype(np.int64)
        lab_len[:] = [4, 3, 2]
    return log_softmax(rng, t, b, c), labels, in_len, lab_len, blank


CASES = ["repeated labels", "a class three times", "blank = C - 1", "S = 1",
         "T = 1", "an infeasible utterance", "frames past the input length",
         "padded label slots", "int64 labels"]


def jax_value_and_grad(fn, log_probs, labels, in_len, lab_len, blank,
                       weights, **kw):
    """``(neg_ll (B,), d(sum(weights * neg_ll))/dlog_probs)``."""
    def loss(x):
        return fn(x, jnp.asarray(labels), jnp.asarray(in_len),
                  jnp.asarray(lab_len), blank=blank, reduction="none", **kw)

    def total(x):
        return jnp.sum(loss(x) * jnp.asarray(weights))

    x = jnp.asarray(log_probs)
    return np.asarray(loss(x)), np.asarray(jax.grad(total)(x))


def port_value_and_grad(log_probs, labels, in_len, lab_len, blank, weights,
                        dtype=torch.float32):
    x = torch.tensor(log_probs).to(dtype).requires_grad_(True)
    neg_ll = ops.ctc_loss(x, torch.tensor(labels), torch.tensor(in_len),
                          torch.tensor(lab_len), blank=blank,
                          reduction="none")
    (neg_ll * torch.tensor(weights)).sum().backward()
    return neg_ll.detach().numpy(), x.grad


def jax_references(log_probs, labels, in_len, lab_len, blank, weights):
    yield jax_value_and_grad(jax_ctc_loss, log_probs, labels, in_len, lab_len,
                             blank, weights)
    if labels.shape[1] > 0:  # the Pallas beta kernel rolls a row by 2
        yield jax_value_and_grad(ctc_loss_pallas, log_probs, labels, in_len,
                                 lab_len, blank, weights, interpret=True)


@pytest.mark.parametrize("name", CASES)
def test_value_and_gradient_match_jax(name):
    log_probs, labels, in_len, lab_len, blank = case_batch(name)
    weights = np.ones(len(in_len), np.float32)
    got_v, got_g = port_value_and_grad(log_probs, labels, in_len, lab_len,
                                       blank, weights)
    got_g = got_g.numpy()
    assert np.isfinite(got_v).all() and np.isfinite(got_g).all()
    for want_v, want_g in jax_references(log_probs, labels, in_len, lab_len,
                                         blank, weights):
        np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=TOL)
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=TOL)
    # frames past an utterance's input length get no gradient
    for u, n in enumerate(in_len):
        assert np.all(got_g[n:, u] == 0)


def test_infeasible_and_empty_cases_keep_their_meaning():
    log_probs, labels, in_len, lab_len, blank = case_batch(
        "an infeasible utterance")
    got_v, got_g = port_value_and_grad(log_probs, labels, in_len, lab_len,
                                       blank, np.ones(3, np.float32))
    assert got_v[1] >= 1e29 and (got_v[[0, 2]] < 100).all()
    assert torch.equal(got_g[:, 1], torch.zeros_like(got_g[:, 1]))
    log_probs, labels, in_len, lab_len, blank = case_batch("S = 1")
    got_v, _ = port_value_and_grad(log_probs, labels, in_len, lab_len, blank,
                                   np.ones(3, np.float32))
    np.testing.assert_allclose(got_v, -log_probs[:, :, blank].sum(0),
                               rtol=1e-6)


def test_masked_mean_upstream_gradient_matches_jax():
    """The trainer's loss (``train/loop.py``): the mean of ``neg_ll`` over
    the rows whose mask is 1; a zero-mask row gets a zero gradient."""
    log_probs, labels, in_len, lab_len, blank = case_batch(
        "frames past the input length")
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    weights = mask / max(mask.sum(), 1.0)
    got_v, got_g = port_value_and_grad(log_probs, labels, in_len, lab_len,
                                       blank, weights)
    got_g = got_g.numpy()
    assert np.all(got_g[:, 1] == 0) and np.any(got_g[:, 0] != 0)
    for want_v, want_g in jax_references(log_probs, labels, in_len, lab_len,
                                         blank, weights):
        np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=TOL)
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=TOL)


def test_bf16_log_probs_give_jax_value_and_a_bf16_gradient():
    """bf16 log-probabilities: the value JAX gives for the same bf16 values
    (as fp32: the JAX losses do not run bf16 on the CPU) and a bf16
    gradient within a bf16 ulp of JAX's."""
    log_probs, labels, in_len, lab_len, blank = case_batch("int64 labels")
    rounded = np.asarray(torch.tensor(log_probs).to(torch.bfloat16).float())
    weights = np.ones(3, np.float32)
    got_v, got_g = port_value_and_grad(log_probs, labels, in_len, lab_len,
                                       blank, weights, dtype=torch.bfloat16)
    assert got_g.dtype == torch.bfloat16
    want_v, want_g = jax_value_and_grad(jax_ctc_loss, rounded, labels, in_len,
                                        lab_len, blank, weights)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=TOL)
    np.testing.assert_allclose(got_g.float().numpy(), want_g, rtol=0,
                               atol=BF16_ULP)


def test_dispatchers_take_the_twins_on_the_cpu():
    log_probs, labels, in_len, lab_len, blank = case_batch("padded label slots")
    args = tuple(torch.tensor(x) for x in (log_probs, labels, in_len, lab_len))
    neg_ll, alphas = ops.ctc_fwd(*args, blank)
    want_ll, want_alphas = ops.ctc_fwd_plain(*args, blank)
    assert torch.equal(neg_ll, want_ll) and torch.equal(alphas, want_alphas)
    assert ops.ctc_fwd(*args, blank, with_alphas=False)[1] is None
    g = torch.tensor([0.5, 1.0, 0.0])
    grad, betas = ops.ctc_bwd(*args, alphas, neg_ll, g, blank,
                              with_betas=True)
    want_grad, want_betas = ops.ctc_bwd_plain(*args, alphas, neg_ll, g, blank,
                                              with_betas=True)
    assert torch.equal(grad, want_grad) and torch.equal(betas, want_betas)
    assert ops.launches_alpha == 0 and ops.launches_beta == 0


def _bad_calls():
    lp = torch.zeros(4, 2, 5)
    lab = torch.ones(2, 3, dtype=torch.int32)
    lens = torch.full((2,), 3, dtype=torch.int32)
    neg_ll, alphas = ops.ctc_fwd_plain(lp.log_softmax(-1), lab, lens, lens)
    meta = torch.zeros(4, 2, 5, device="meta")
    yield "unsupported device", lambda: ops.ctc_fwd(
        meta, lab.to("meta"), lens.to("meta"), lens.to("meta"))
    yield "unsupported device", lambda: ops.ctc_bwd(
        meta, lab.to("meta"), lens.to("meta"), lens.to("meta"),
        alphas.to("meta"), neg_ll.to("meta"), neg_ll.to("meta"))
    yield "input_lengths must be", lambda: ops.ctc_fwd(lp, lab, lens[:1], lens)
    yield "label_lengths must be", lambda: ops.ctc_fwd(
        lp, lab, lens, torch.ones(3, dtype=torch.int32))
    yield "g must be", lambda: ops.ctc_bwd(lp, lab, lens, lens, alphas,
                                          neg_ll, torch.ones(3))
    yield "neg_ll must be", lambda: ops.ctc_bwd(lp, lab, lens, lens, alphas,
                                               neg_ll[None], torch.ones(2))
    yield "blank must be", lambda: ops.ctc_fwd(lp, lab, lens, lens, blank=5)


@pytest.mark.parametrize("index", range(7))
def test_dispatchers_raise_without_launching(index):
    match, call = list(_bad_calls())[index]
    before = (ops.launches_alpha, ops.launches_beta,
              dict(ops.launches_fwd_branch), dict(ops.launches_bwd_branch))
    with pytest.raises((ValueError, TypeError), match=match):
        call()
    assert before == (ops.launches_alpha, ops.launches_beta,
                      dict(ops.launches_fwd_branch),
                      dict(ops.launches_bwd_branch))
