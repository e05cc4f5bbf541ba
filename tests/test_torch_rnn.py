"""The port's tanh-RNN recurrence (eval) against the JAX package.

On the CPU ``ops.rnn_bidir`` runs its plain twin; it must compute what the
Pallas kernels compute (``rnn_bidir_v2(train=False)``, ``rnn_scan_v2`` and
the v1 ``rnn_bidir_pallas``, all run here in interpret mode) and what the
scan path computes (``_scan_bidir_fused(..., "rnn", ...)``).  fp32 is held
to rtol 2e-4 / atol 2e-5 (same math, another summation order, as the LSTM
and GRU tests); with bf16 streams both sides round at the same points and
differ by a bf16 ulp or two, held to 2e-2.  The kernel itself is held
against the plain twin on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).  The layer with BN and ``lengths`` is held in
``tests/test_torch_gru.py::test_rnn_layer_matches_jax``, which covers every
cell.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.models.rnn import _scan_bidir_fused
from ctc_pytorch_tpu.ops.rnn_pallas import rnn_bidir_pallas
from ctc_pytorch_tpu.ops.rnn_pallas_v2 import rnn_bidir_v2, rnn_scan_v2
from ctc_pytorch_tpu_torch.models.rnn import RNNLayer
from ctc_pytorch_tpu_torch.ops import rnn_bidir as rnn_ops

RTOL, ATOL = 2e-4, 2e-5


def _weights(t, b, f, h, seed):
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(h)
    x = rng.randn(t, b, f).astype(np.float32)
    w_ih = rng.uniform(-bound, bound, (2, f, h)).astype(np.float32)
    w_hh = rng.uniform(-bound, bound, (2, h, h)).astype(np.float32)
    return x, w_ih, w_hh


def _layer(f, h, w_ih, w_hh):
    layer = RNNLayer(f, h, batch_norm=False, cell="rnn").eval()
    with torch.no_grad():
        for d, mod in enumerate((layer.fwd, layer.bwd)):
            mod.w_ih.copy_(torch.from_numpy(w_ih[d]))
            mod.w_hh.copy_(torch.from_numpy(w_hh[d]))
    return layer


def _jax_params(w_ih, w_hh):
    return {"fwd": {"w_ih": jnp.asarray(w_ih[0]), "w_hh": jnp.asarray(w_hh[0])},
            "bwd": {"w_ih": jnp.asarray(w_ih[1]), "w_hh": jnp.asarray(w_hh[1])}}


@pytest.mark.parametrize("t,b,f,h,chunk", [
    (16, 3, 5, 4, 4),
    (9, 2, 4, 4, 1),  # odd T
    (1, 2, 4, 4, 1),  # T = 1
    (24, 4, 6, 16, 8),
    (7, 1, 3, 32, 2),  # B = 1, T not a multiple of the Pallas chunk
])
def test_plain_rnn_matches_pallas_v2_v1_and_scan(t, b, f, h, chunk):
    x, w_ih, w_hh = _weights(t, b, f, h, seed=t + h)
    with torch.no_grad():
        got = _layer(f, h, w_ih, w_hh)(torch.from_numpy(x), torch.float32).numpy()
    jx, jwi, jwh = jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh)
    v2 = rnn_bidir_v2(jx, jwi, jwh, chunk=chunk, interpret=True, train=False)
    v1 = rnn_bidir_pallas(jx, jwi, jwh, chunk=chunk, interpret=True)
    scan = _scan_bidir_fused(_jax_params(w_ih, w_hh), jx, "rnn", h, jnp.float32)
    assert got.shape == (t, b, 2 * h) and got.dtype == np.float32
    for want in (v2, v1, scan):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t,chunk", [(8, 4), (6, 1)])
def test_plain_op_matches_the_kernel_level_scan(t, chunk):
    """The op on the hoisted projection against ``rnn_scan_v2``, whose output
    plane carries a guard row at each end."""
    b, h = 3, 8
    rng = np.random.RandomState(t)
    gx = rng.randn(t, b, 2 * h).astype(np.float32)
    w = rng.uniform(-0.4, 0.4, (2, h, h)).astype(np.float32)
    want = rnn_scan_v2(jnp.asarray(gx), jnp.asarray(w), chunk, True)
    assert not np.asarray(want)[0].any() and not np.asarray(want)[-1].any()
    got = rnn_ops.rnn_bidir(torch.from_numpy(gx), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[1:t + 1],
                               rtol=RTOL, atol=ATOL)


def test_plain_rnn_with_bf16_streams_matches_pallas_v2():
    t, b, f, h = 12, 16, 6, 16  # bf16 streams need B % 16 == 0
    x, w_ih, w_hh = _weights(t, b, f, h, seed=1)
    with torch.no_grad():
        got = _layer(f, h, w_ih, w_hh)(torch.from_numpy(x), torch.bfloat16).numpy()
    want = rnn_bidir_v2(jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh),
                        chunk=4, interpret=True, compute_dtype=jnp.bfloat16,
                        train=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-2)
    assert np.array_equal(got, np.asarray(torch.from_numpy(got).bfloat16().float()))


def test_plain_rnn_rounds_where_the_kernel_rounds():
    """bf16 streams: ``ys`` holds bf16 values, ``w_hh`` and the h that enters
    the product are rounded to bf16; the sum and the tanh are fp32."""
    gen = torch.Generator().manual_seed(0)
    gx = torch.randn(6, 3, 8, generator=gen).to(torch.bfloat16)
    w_hh = torch.rand(2, 4, 4, generator=gen) - 0.5
    ys = rnn_ops.rnn_bidir(gx, w_hh)
    assert ys.dtype == torch.float32
    assert torch.equal(ys, ys.to(torch.bfloat16).float())
    assert torch.equal(ys, rnn_ops.rnn_bidir(gx, w_hh.to(torch.bfloat16).float()))
    ref = rnn_ops.rnn_bidir(gx.float(), w_hh)
    assert 0 < (ys - ref).abs().max().item() < 2e-2
    # by hand, the first two steps of each direction
    w = w_hh.to(torch.bfloat16).float()
    for d, steps in ((0, (0, 1)), (1, (5, 4))):
        h = torch.zeros(3, 4)
        for t in steps:
            h = torch.tanh(gx[t, :, 4 * d:4 * (d + 1)].float() + h @ w[d])
            h = h.to(torch.bfloat16).float()
            assert torch.equal(ys[t, :, 4 * d:4 * (d + 1)], h)


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    x, w_ih, w_hh = _weights(5, 2, 3, 4, seed=0)
    before = rnn_ops.launches
    with torch.no_grad():
        _layer(3, 4, w_ih, w_hh)(torch.from_numpy(x), torch.float32)
    assert rnn_ops.launches == before


def test_rnn_wrapper_has_no_fallback_for_other_devices():
    gx = torch.zeros(2, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rnn_ops.rnn_bidir(gx, torch.zeros(2, 4, 4, device="meta"))
    assert rnn_ops.launches == 0


@pytest.mark.parametrize("bad_gx,bad_w,err", [
    (torch.zeros(2, 1, 8, dtype=torch.float16), torch.zeros(2, 4, 4), TypeError),
    (torch.zeros(2, 1, 8), torch.zeros(2, 4, 12), ValueError),  # 3H weights
    (torch.zeros(2, 1, 8), torch.zeros(2, 4, 4).double(), ValueError),
    (torch.zeros(2, 1, 12), torch.zeros(3, 4, 4), ValueError),  # 3 directions
    (torch.zeros(2, 1, 8), torch.zeros(1, 4, 4), ValueError),  # 2H lanes, 1 dir
    (torch.zeros(0, 1, 8), torch.zeros(2, 4, 4), ValueError),  # T = 0
    (torch.zeros(2, 0, 8), torch.zeros(2, 4, 4), ValueError),  # B = 0
])
def test_kernel_launcher_checks_its_inputs(bad_gx, bad_w, err):
    with pytest.raises(err):
        rnn_ops.check_inputs(bad_gx, bad_w)
    assert rnn_ops.check_inputs(torch.zeros(3, 2, 4), torch.zeros(1, 4, 4)) == (
        3, 2, 4, 1)
