"""The ten stacked-layout (v1) entry points of ``ops/stacked.py``, each
against its own JAX function run in interpret mode: the Pallas kernels of
``lstm_pallas.py``, ``lstm_pallas_train.py``, ``gru_pallas.py``,
``gru_pallas_train.py`` and ``rnn_pallas.py`` (whose two entry points serve
eval and training alike, so they stand in both the eval and the trainable
cases).

fp32: the same function, held to 1e-5 absolute (gradients of weights relative
to their largest entry).  bf16 streams (v1 turns them on when 2B % 16 == 0,
here B = 8): the port runs the recurrences of the lane-layout kernels, which
round ``w_hh`` to bf16 where v1 keeps it fp32 in the forward (and, for the
tanh cell, round h and ``dpre`` where v1 does not), so results agree to a few
bf16 ulps and not bit for bit: 3e-2 absolute on outputs and ``dx``, 3e-2 of
the largest entry on weight gradients."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.gru_pallas import gru_bidir_pallas, gru_scan_pallas
from ctc_pytorch_tpu.ops.gru_pallas_train import gru_bidir_train, gru_scan_train
from ctc_pytorch_tpu.ops.lstm_pallas import lstm_bidir_pallas, lstm_scan_pallas
from ctc_pytorch_tpu.ops.lstm_pallas_train import lstm_bidir_train, lstm_scan_train
from ctc_pytorch_tpu.ops.rnn_pallas import rnn_bidir_pallas, rnn_scan_train
from ctc_pytorch_tpu_torch.ops import gru_bidir, gru_bidir_train as gru_train
from ctc_pytorch_tpu_torch.ops import lstm_bidir, lstm_bidir_train as lstm_train
from ctc_pytorch_tpu_torch.ops import rnn_bidir, rnn_bidir_train as rnn_train
from ctc_pytorch_tpu_torch.ops import stacked

GATES = {"lstm": 4, "gru": 3, "rnn": 1}


def _inputs(cell, t, b, f, h, seed):
    n = GATES[cell]
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(h)
    return dict(
        x=rng.randn(t, b, f).astype(np.float32),
        gx=rng.randn(t, 2 * b, n * h).astype(np.float32),
        w_ih=rng.uniform(-bound, bound, (2, f, n * h)).astype(np.float32),
        w_hh=rng.uniform(-bound, bound, (2, h, n * h)).astype(np.float32),
        dy_stacked=rng.randn(t, 2 * b, h).astype(np.float32),
        dy=rng.randn(t, b, 2 * h).astype(np.float32))


def _close(got, want, tol, relative=False):
    want = np.asarray(want, np.float32)
    scale = max(1.0, np.abs(want).max()) if relative else 1.0
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


SCAN_EVAL = {
    "lstm": (stacked.lstm_scan_stacked,
             lambda gx, w, c: lstm_scan_pallas(gx, w, chunk=c, interpret=True)),
    "gru": (stacked.gru_scan_stacked,
            lambda gx, w, c: gru_scan_pallas(gx, w, chunk=c, interpret=True)),
    "rnn": (stacked.rnn_scan_train_stacked,
            lambda gx, w, c: rnn_scan_train(gx, w, c, c, True)),
}
SCAN_TRAIN = {
    "lstm": (stacked.lstm_scan_train_stacked,
             lambda gx, w, c: lstm_scan_train(gx, w, c, max(c // 2, 1), True)),
    "gru": (stacked.gru_scan_train_stacked,
            lambda gx, w, c: gru_scan_train(gx, w, c, max(c // 2, 1), True)),
    "rnn": (stacked.rnn_scan_train_stacked,
            lambda gx, w, c: rnn_scan_train(gx, w, c, max(c // 2, 1), True)),
}
BIDIR_EVAL = {"lstm": (stacked.lstm_bidir_stacked, lstm_bidir_pallas),
              "gru": (stacked.gru_bidir_stacked, gru_bidir_pallas),
              "rnn": (stacked.rnn_bidir_stacked, rnn_bidir_pallas)}
BIDIR_TRAIN = {"lstm": (stacked.lstm_bidir_train_stacked, lstm_bidir_train),
               "gru": (stacked.gru_bidir_train_stacked, gru_bidir_train),
               "rnn": (functools.partial(stacked.rnn_bidir_stacked, train=True),
                       functools.partial(rnn_bidir_pallas, train=True))}


@pytest.mark.parametrize("t,b,h,chunk", [(9, 3, 8, 4), (1, 1, 4, 1), (6, 2, 16, 2)])
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_scan_entry_point_matches_its_pallas_kernel(cell, t, b, h, chunk):
    d = _inputs(cell, t, b, 3, h, seed=t + h)
    port, ref = SCAN_EVAL[cell]
    got = port(torch.tensor(d["gx"]), torch.tensor(d["w_hh"]))
    want = ref(jnp.asarray(d["gx"]), jnp.asarray(d["w_hh"]), chunk)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("t,b,h,chunk", [(7, 3, 8, 2), (1, 2, 4, 1), (6, 2, 16, 4)])
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_trainable_scan_entry_point_matches_its_pallas_kernels(cell, t, b, h, chunk):
    d = _inputs(cell, t, b, 3, h, seed=t + b)
    port, ref = SCAN_TRAIN[cell]

    def jax_loss(gx, w):
        ys = ref(gx, w, chunk)
        return jnp.sum(ys * d["dy_stacked"]), ys

    (_, want_ys), (want_dgx, want_dw) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(d["gx"]), jnp.asarray(d["w_hh"]))
    gx = torch.tensor(d["gx"], requires_grad=True)
    w = torch.tensor(d["w_hh"], requires_grad=True)
    ys = port(gx, w)
    (ys * torch.tensor(d["dy_stacked"])).sum().backward()
    _close(ys, want_ys, 1e-5)
    _close(gx.grad, want_dgx, 1e-5)
    _close(w.grad, want_dw, 1e-5, relative=True)


@pytest.mark.parametrize("cd,b,tol", [("float32", 3, 1e-5), ("bfloat16", 8, 3e-2)])
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_layer_entry_point_matches_its_pallas_kernel(cell, cd, b, tol):
    t, f, h = 9, 5, 16
    d = _inputs(cell, t, b, f, h, seed=b)
    port, ref = BIDIR_EVAL[cell]
    got = port(torch.tensor(d["x"]), torch.tensor(d["w_ih"]),
               torch.tensor(d["w_hh"]), getattr(torch, cd))
    want = ref(jnp.asarray(d["x"]), jnp.asarray(d["w_ih"]), jnp.asarray(d["w_hh"]),
               chunk=4, interpret=True, compute_dtype=jnp.dtype(cd))
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, b, 2 * h)
    _close(got, want, tol)
    if cd == "bfloat16":  # 2B = 16: the v1 rule turns bf16 streams on
        assert torch.equal(got, got.bfloat16().float())


@pytest.mark.parametrize("cd,b,tol", [("float32", 3, 1e-5), ("bfloat16", 8, 3e-2)])
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_trainable_layer_entry_point_matches_its_pallas_kernels(cell, cd, b, tol):
    t, f, h = 6, 5, 16
    d = _inputs(cell, t, b, f, h, seed=10 + b)
    port, ref = BIDIR_TRAIN[cell]

    def jax_loss(x, w_ih, w_hh):
        ys = ref(x, w_ih, w_hh, chunk=2, interpret=True,
                 compute_dtype=jnp.dtype(cd))
        return jnp.sum(ys * d["dy"]), ys

    (_, want_ys), want_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(d["x"]), jnp.asarray(d["w_ih"]), jnp.asarray(d["w_hh"]))
    args = [torch.tensor(d[k], requires_grad=True) for k in ("x", "w_ih", "w_hh")]
    ys = port(*args, getattr(torch, cd))
    (ys * torch.tensor(d["dy"])).sum().backward()
    _close(ys, want_ys, tol)
    _close(args[0].grad, want_grads[0], tol)
    _close(args[1].grad, want_grads[1], tol, relative=True)
    _close(args[2].grad, want_grads[2], tol, relative=True)


def test_layouts_are_inverse_and_flip_the_second_half():
    gx = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    lanes = stacked.lanes_from_stacked(gx)
    assert tuple(lanes.shape) == (2, 2, 6)
    assert torch.equal(lanes[0, :, :3], gx[0, :2])
    assert torch.equal(lanes[0, :, 3:], gx[1, 2:])  # time-flipped back
    assert torch.equal(stacked.stacked_from_lanes(lanes), gx)
    with pytest.raises(ValueError, match="even batch"):
        stacked.lstm_scan_stacked(torch.zeros(2, 3, 16), torch.zeros(2, 4, 16))


def test_entry_points_run_the_ops_of_the_lane_layout_and_count_nothing_on_cpu():
    """Each wrapper goes through the op whose kernel it launches on the card
    (checked there by the launch counts); on the CPU no count moves."""
    def counts():
        return (lstm_bidir.launches, lstm_train.launches_fwd,
                lstm_train.launches_bwd, gru_bidir.launches,
                gru_train.launches_fwd, gru_train.launches_bwd,
                rnn_bidir.launches, rnn_train.launches_fwd, rnn_train.launches_bwd)

    before = counts()
    for cell in ("lstm", "gru", "rnn"):
        d = _inputs(cell, 3, 2, 3, 4, seed=0)
        gx, w = torch.tensor(d["gx"]), torch.tensor(d["w_hh"])
        want = {"lstm": lstm_bidir.lstm_bidir, "gru": gru_bidir.gru_bidir,
                "rnn": rnn_bidir.rnn_bidir}[cell](
            stacked.lanes_from_stacked(gx), w)
        assert torch.equal(SCAN_EVAL[cell][0](gx, w),
                           stacked.stacked_from_lanes(want))
        assert torch.equal(SCAN_TRAIN[cell][0](gx, w),
                           stacked.stacked_from_lanes(want))
    assert before == counts()
    with pytest.raises(ValueError, match="unsupported device"):
        stacked.gru_scan_stacked(torch.zeros(2, 2, 12, device="meta"),
                                 torch.zeros(2, 4, 12, device="meta"))


def test_calls_count_every_entry_point_and_no_model_forward():
    """``stacked.calls`` moves once per entry-point call, scan level or layer
    level, and a model's forward never comes through the wrappers."""
    from ctc_pytorch_tpu_torch.models.rnn import RNNStack

    for cell in ("lstm", "gru", "rnn"):
        d = _inputs(cell, 3, 2, 3, 4, seed=1)
        gx, w = torch.tensor(d["gx"]), torch.tensor(d["w_hh"])
        x, w_ih = torch.tensor(d["x"]), torch.tensor(d["w_ih"])
        for fn, args in ((SCAN_EVAL[cell][0], (gx, w)),
                         (SCAN_TRAIN[cell][0], (gx, w)),
                         (BIDIR_EVAL[cell][0], (x, w_ih, w)),
                         (BIDIR_TRAIN[cell][0], (x, w_ih, w))):
            before = stacked.calls
            fn(*args)
            assert stacked.calls == before + 1
        before = stacked.calls
        stack = RNNStack(cell=cell, input_size=3, hidden_size=4, num_layers=2,
                         bidirectional=True, batch_norm=True)
        stack.train()
        stack(x, torch.float32).sum().backward()
        stack.eval()
        stack(x, torch.float32)
        assert stacked.calls == before
