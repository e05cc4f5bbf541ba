"""The LSTM and GRU forward twins against the JAX package's Pallas forward
kernels (interpret mode) at the shapes that the forward's cluster branches
(``csrc/fwd_cluster.cuh``) tell apart: H on each side of every resident
bound of the header, B = 1, 8, 17 and >= 32, T = 1, one direction, both
stream dtypes.  The twins define the function that every branch of the
kernels computes; the kernels are held against them on the card
(``chip_smoke.FWD_CASES``, ``tests/test_torch_cuda.py``).

Tolerances: fp32 1e-5 abs (the same fp32 math in another summation order),
bf16 streams 2e-2 abs (both round h to bf16 at the same points).  One
direction is held against direction 0 of the two-direction JAX kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.gru_pallas_v2 import gru_bidir_v2, gru_scan_train_v2
from ctc_pytorch_tpu.ops.lstm_pallas_train_v2 import lstm_scan_train_v2
from ctc_pytorch_tpu.ops.lstm_pallas_v2 import lstm_bidir_pallas_v2
from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as train_ops

FP32_TOL, BF16_TOL = 1e-5, 2e-2

# The resident bounds of csrc/fwd_cluster.cuh (largest H that a branch
# holds): the fp32 kernel with clusters of 8 and of 16, the tensor-core
# kernel with 16 and 32 batch rows, per cell.
FMA_BOUND_CL8, FMA_BOUND_CL16 = 309, 416
MMA_BOUND = {"lstm": {16: 432, 32: 384}, "gru": {16: 496, 32: 448}}


def shape_bounds(gates, h, rows):
    """Python mirror of the header's shape arithmetic: does the bf16
    cluster of ``rows`` batch rows hold H, does the fp32 cluster (and with
    how many CTAs)."""
    smem = 232448
    uc = -(-(-(-h // 8)) // 8) * 8
    ldk = -(-h // 16) * 16 + 8
    mma = uc <= 64 and (gates * uc + 2 * rows) * ldk * 2 <= smem
    for cl in (8, 16):
        ucf = -(-h // cl)
        if h * ucf * 16 + 2 * h * 16 * 4 <= smem:
            return mma, cl
    return mma, None


def test_the_bounds_are_the_headers():
    text = (lstm_ops.LIBRARY.headers[-1]).read_text()
    assert lstm_ops.LIBRARY.headers[-1].name == "fwd_cluster.cuh"
    for want in ("LSTM H <= 432", "(32 rows: H <= 384)", "GRU H <= 496",
                 "(32 rows: H <= 448)", "H <= 309 at CL = 8",
                 "H <= 416 at CL = 16"):
        assert want in " ".join(text.split()), want
    for cell, gates in (("lstm", 4), ("gru", 3)):
        for rows, bound in MMA_BOUND[cell].items():
            assert shape_bounds(gates, bound, rows)[0]
            assert not shape_bounds(gates, bound + 1, rows)[0]
    assert shape_bounds(4, FMA_BOUND_CL8, 16)[1] == 8
    assert shape_bounds(4, FMA_BOUND_CL8 + 1, 16)[1] == 16
    assert shape_bounds(4, FMA_BOUND_CL16, 16)[1] == 16
    assert shape_bounds(4, FMA_BOUND_CL16 + 1, 16)[1] is None


def inputs(t, b, h, gates, dtype, seed):
    rng = np.random.RandomState(seed)
    gx = rng.randn(t, b, 2 * gates * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, gates * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    gx = torch.from_numpy(gx).to(dtype)
    return gx, torch.from_numpy(w_hh)


def twin_vs(got, want, dtype, ndir, h):
    want = np.asarray(want, dtype=np.float32)[..., :ndir * h]
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def one_dir(gx, w_hh, gates, h, ndir):
    """The twin's inputs for ``ndir`` directions of a two-direction case."""
    return gx[..., :ndir * gates * h].contiguous(), w_hh[:ndir].contiguous()


# (T, B, H, stream dtype, directions): H on each side of the bounds of the
# fp32 cluster (every LSTM eval forward, and fp32 streams)
FMA_CASES = [
    (2, 8, FMA_BOUND_CL8, torch.float32, 2),
    (2, 8, FMA_BOUND_CL8 + 1, torch.float32, 1),
    (2, 1, FMA_BOUND_CL16, torch.float32, 2),
    (2, 17, FMA_BOUND_CL16 + 1, torch.float32, 2),
    (1, 16, 40, torch.bfloat16, 2),  # T = 1; the eval forward on bf16 streams
    (5, 33, 24, torch.bfloat16, 1),
]


@pytest.mark.parametrize("t,b,h,dtype,ndir", FMA_CASES)
def test_lstm_eval_twin_matches_pallas_v2(t, b, h, dtype, ndir):
    gx, w_hh = inputs(t, b, h, 4, dtype, seed=t + b + h)
    # the JAX kernel takes x and w_ih: an identity projection hands it gx
    eye = np.eye(8 * h, dtype=np.float32)
    w_ih = np.stack([eye[:, :4 * h], eye[:, 4 * h:]])
    cd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = lstm_bidir_pallas_v2(jnp.asarray(gx.float().numpy()),
                                jnp.asarray(w_ih), jnp.asarray(w_hh.numpy()),
                                chunk=1, interpret=True, compute_dtype=cd)
    got = lstm_ops.lstm_bidir(*one_dir(gx, w_hh, 4, h, ndir))
    twin_vs(got, want, dtype, ndir, h)


# the training forwards: the fp32 cluster's bounds with fp32 streams, the
# tensor-core cluster's with bf16 streams (B >= 32 for the 32-row one)
TRAIN_CASES = {
    "lstm": [
        (2, 8, FMA_BOUND_CL16, torch.float32, 2),
        (2, 17, FMA_BOUND_CL16 + 1, torch.float32, 1),
        (2, 16, MMA_BOUND["lstm"][16], torch.bfloat16, 2),
        (2, 1, MMA_BOUND["lstm"][16] + 1, torch.bfloat16, 2),
        (2, 32, MMA_BOUND["lstm"][32], torch.bfloat16, 2),
        (2, 33, MMA_BOUND["lstm"][32] + 1, torch.bfloat16, 1),
        (1, 8, 64, torch.bfloat16, 2),  # T = 1
    ],
    "gru": [
        (2, 8, FMA_BOUND_CL8, torch.float32, 2),
        (2, 1, FMA_BOUND_CL8 + 1, torch.float32, 2),
        (2, 16, MMA_BOUND["gru"][16], torch.bfloat16, 2),
        (2, 17, MMA_BOUND["gru"][16] + 1, torch.bfloat16, 1),
        (2, 32, MMA_BOUND["gru"][32], torch.bfloat16, 2),
        (2, 48, MMA_BOUND["gru"][32] + 1, torch.bfloat16, 2),
        (1, 8, 64, torch.float32, 1),  # T = 1
    ],
}


@pytest.mark.parametrize("t,b,h,dtype,ndir", TRAIN_CASES["lstm"])
def test_lstm_training_forward_twin_matches_pallas(t, b, h, dtype, ndir):
    gx, w_hh = inputs(t, b, h, 4, dtype, seed=2 * t + b + h)
    jgx = jnp.asarray(gx.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = lstm_scan_train_v2(jgx, jnp.asarray(w_hh.numpy()), 1, True)[1:t + 1]
    ys, cs = train_ops.lstm_bidir_train_plain(*one_dir(gx, w_hh, 4, h, ndir))
    assert ys.dtype == cs.dtype == dtype
    twin_vs(ys, want.astype(jnp.float32), dtype, ndir, h)


@pytest.mark.parametrize("t,b,h,dtype,ndir", TRAIN_CASES["gru"])
def test_gru_forward_twin_matches_pallas_eval_and_training(t, b, h, dtype, ndir):
    gx, w_hh = inputs(t, b, h, 3, dtype, seed=3 * t + b + h)
    sd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jgx = jnp.asarray(gx.float().numpy()).astype(sd)
    train = gru_scan_train_v2(jgx, jnp.asarray(w_hh.numpy()), 1, True)[1:t + 1]
    got = gru_ops.gru_bidir(*one_dir(gx, w_hh, 3, h, ndir))
    twin_vs(got, train.astype(jnp.float32), dtype, ndir, h)
    if dtype == torch.float32 or b % 16 == 0:
        # the eval kernel, through an identity projection (its stream dtype
        # follows the JAX rule: bf16 only where B % 16 == 0)
        eye = np.eye(6 * h, dtype=np.float32)
        w_ih = np.stack([eye[:, :3 * h], eye[:, 3 * h:]])
        ev = gru_bidir_v2(jnp.asarray(gx.float().numpy()), jnp.asarray(w_ih),
                          jnp.asarray(w_hh.numpy()), chunk=1, interpret=True,
                          compute_dtype=sd, train=False)
        twin_vs(got, ev, dtype, ndir, h)
