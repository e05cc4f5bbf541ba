"""The port's BiGRU recurrence (eval) and GRU layer against the JAX package.

On the CPU ``ops.gru_bidir`` runs its plain twin; it must compute what the
Pallas kernels compute (``gru_bidir_v2(train=False)`` and the v1
``gru_bidir_pallas``, both run here in interpret mode) and what the scan path
computes.  fp32 is held to rtol 2e-4 / atol 2e-5 (same math, another summation
order, as ``tests/test_torch_lstm.py``); with bf16 streams both sides round at
the same points and differ by a bf16 ulp or two, held to 2e-2.  The kernel
itself is held against the plain twin on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.models.rnn import _scan_bidir_fused, rnn_layer_apply
from ctc_pytorch_tpu.ops.gru_pallas import gru_bidir_pallas
from ctc_pytorch_tpu.ops.gru_pallas_v2 import gru_bidir_v2
from ctc_pytorch_tpu_torch.models.rnn import RNNLayer, RNNStack
from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops


def _weights(t, b, f, h, seed):
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(h)
    x = rng.randn(t, b, f).astype(np.float32)
    w_ih = rng.uniform(-bound, bound, (2, f, 3 * h)).astype(np.float32)
    w_hh = rng.uniform(-bound, bound, (2, h, 3 * h)).astype(np.float32)
    return x, w_ih, w_hh


def _layer(f, h, w_ih, w_hh, batch_norm=False):
    layer = RNNLayer(f, h, batch_norm=batch_norm, cell="gru").eval()
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
def test_plain_gru_matches_pallas_v2_v1_and_scan(t, b, f, h, chunk):
    x, w_ih, w_hh = _weights(t, b, f, h, seed=t + h)
    with torch.no_grad():
        got = _layer(f, h, w_ih, w_hh)(torch.from_numpy(x), torch.float32).numpy()
    jx, jwi, jwh = jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh)
    v2 = gru_bidir_v2(jx, jwi, jwh, chunk=chunk, interpret=True, train=False)
    v1 = gru_bidir_pallas(jx, jwi, jwh, chunk=chunk, interpret=True)
    scan = _scan_bidir_fused(_jax_params(w_ih, w_hh), jx, "gru", h, jnp.float32)
    assert got.shape == (t, b, 2 * h) and got.dtype == np.float32
    for want in (v2, v1, scan):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)


def test_plain_gru_with_bf16_streams_matches_pallas_v2():
    t, b, f, h = 12, 16, 6, 16  # bf16 streams need B % 16 == 0
    x, w_ih, w_hh = _weights(t, b, f, h, seed=1)
    with torch.no_grad():
        got = _layer(f, h, w_ih, w_hh)(torch.from_numpy(x), torch.bfloat16).numpy()
    want = gru_bidir_v2(jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh),
                        chunk=4, interpret=True, compute_dtype=jnp.bfloat16,
                        train=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-2)


def test_plain_gru_rounds_where_the_kernel_rounds():
    """bf16 streams: ``ys`` holds bf16 values, ``w_hh`` and the h that enters
    the product are rounded to bf16, the carry in ``z * h`` is not."""
    gen = torch.Generator().manual_seed(0)
    gx = torch.randn(6, 3, 24, generator=gen).to(torch.bfloat16)
    w_hh = torch.rand(2, 4, 12, generator=gen) - 0.5
    ys = gru_ops.gru_bidir(gx, w_hh)
    assert ys.dtype == torch.float32
    assert torch.equal(ys, ys.to(torch.bfloat16).float())
    assert torch.equal(ys, gru_ops.gru_bidir(gx, w_hh.to(torch.bfloat16).float()))
    ref = gru_ops.gru_bidir(gx.float(), w_hh)
    assert 0 < (ys - ref).abs().max().item() < 2e-2
    # by hand, two steps of the forward direction
    w = w_hh[0].to(torch.bfloat16).float()
    h = torch.zeros(3, 4)
    for s in range(2):
        hh = h.to(torch.bfloat16).float() @ w
        g = gx[s, :, :12].float()
        r = torch.sigmoid(g[:, :4] + hh[:, :4])
        z = torch.sigmoid(g[:, 4:8] + hh[:, 4:8])
        n = torch.tanh(g[:, 8:] + r * hh[:, 8:])
        h = (1.0 - z) * n + z * h
        assert torch.equal(ys[s, :, :4], h.to(torch.bfloat16).float())


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    x, w_ih, w_hh = _weights(5, 2, 3, 4, seed=0)
    before = gru_ops.launches
    with torch.no_grad():
        _layer(3, 4, w_ih, w_hh)(torch.from_numpy(x), torch.float32)
    assert gru_ops.launches == before


def test_gru_wrapper_has_no_fallback_for_other_devices():
    gx = torch.zeros(2, 1, 24, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gru_ops.gru_bidir(gx, torch.zeros(2, 4, 12, device="meta"))
    assert gru_ops.launches == 0


@pytest.mark.parametrize("bad_gx,bad_w,err", [
    (torch.zeros(2, 1, 24, dtype=torch.float16), torch.zeros(2, 4, 12), TypeError),
    (torch.zeros(2, 1, 24), torch.zeros(2, 4, 16), ValueError),  # 4H weights
    (torch.zeros(2, 1, 32), torch.zeros(2, 4, 12), ValueError),  # 8H lanes
    (torch.zeros(0, 1, 24), torch.zeros(2, 4, 12), ValueError),  # T = 0
])
def test_kernel_launcher_checks_its_inputs(bad_gx, bad_w, err):
    with pytest.raises(err):
        gru_ops.check_inputs(bad_gx, bad_w)


@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
@pytest.mark.parametrize("with_bn,with_lengths", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_rnn_layer_matches_jax(cell, with_bn, with_lengths):
    """One layer of either cell, with and without the feature BN and the
    packed ``lengths`` mode: the JAX layer takes its scan path here, which
    reverses each utterance within its length; the port zeroes the padded
    rows, as the JAX layer does for its kernels.  Every row must agree."""
    t, b, f, h, n = 7, 3, 6, 8, {"lstm": 4, "gru": 3, "rnn": 1}[cell]
    rng = np.random.RandomState(3)
    bound = 1.0 / np.sqrt(h)
    x = rng.randn(t, b, f).astype(np.float32)
    params = {d: {"w_ih": rng.uniform(-bound, bound, (f, n * h)).astype(np.float32),
                  "w_hh": rng.uniform(-bound, bound, (h, n * h)).astype(np.float32)}
              for d in ("fwd", "bwd")}
    bn = {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
          "bias": rng.randn(f).astype(np.float32)}
    bn_state = {"mean": rng.randn(f).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, f).astype(np.float32),
                "count": np.int32(3)}
    lens = np.array([7, 5, 2], np.int32)
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    state = {}
    if with_bn:
        params["bn"], state["bn"] = bn, bn_state
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}
    js = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in state.items()}
    want, _ = rnn_layer_apply(
        jp, js, jnp.asarray(x), cell=cell, hidden_size=h,
        compute_dtype=jnp.float32, bn_mask=jnp.asarray(mask) if with_bn else None,
        lengths=jnp.asarray(lens) if with_lengths else None)

    layer = RNNLayer(f, h, batch_norm=with_bn, cell=cell).eval()
    sd = {f"{d}.{w}": torch.from_numpy(params[d][w])
          for d in ("fwd", "bwd") for w in ("w_ih", "w_hh")}
    if with_bn:
        sd.update({f"bn.{k}": torch.from_numpy(np.asarray(v))
                   for k, v in {**bn, **bn_state}.items()})
    layer.load_state_dict(sd)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.float32,
                    torch.from_numpy(mask) if with_bn else None,
                    lengths=torch.from_numpy(lens) if with_lengths else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    if with_lengths:
        assert not got[5:, 1].any() and not got[2:, 2].any()  # zero past the length


def test_stack_takes_gru_and_refuses_what_is_not_ported():
    """Every cell of the JAX package takes one direction or two; a name that
    is no cell raises."""
    stack = RNNStack(cell="gru", input_size=5, hidden_size=4, num_layers=2,
                     bidirectional=True, batch_norm=True)
    assert tuple(stack[0].fwd.w_ih.shape) == (5, 12)
    assert tuple(stack[1].bwd.w_hh.shape) == (4, 12)
    assert stack[0].bn is None and stack[1].bn is not None
    for cell, n in (("lstm", 4), ("gru", 3), ("rnn", 1)):
        uni = RNNStack(cell=cell, input_size=5, hidden_size=4, num_layers=2,
                       bidirectional=False, batch_norm=False)
        assert uni[0].bwd is None and len(uni[1].directions) == 1
        assert tuple(uni[1].fwd.w_ih.shape) == (4, n * 4)  # one direction in
    for bidir in (True, False):
        with pytest.raises(ValueError, match="unknown cell"):
            RNNStack(cell="lstmp", input_size=5, hidden_size=4, num_layers=1,
                     bidirectional=bidir, batch_norm=False)
