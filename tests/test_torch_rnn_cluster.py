"""The tanh cell's forward and backward twins against the JAX package's
Pallas kernels (interpret mode) at the shapes that the tanh cluster
branches (``csrc/fwd_cluster.cuh``: ``fwd_mma_kernel`` with ``TanhCell`` and
``TanhBwdCell`` on bf16 streams, ``fma1_kernel`` on fp32 streams) tell
apart: H on each side of every one-gate bound of the header, B = 1, 8, 17
and >= 32, T = 1, one direction, both stream dtypes.  The twins define the
function that every branch of the kernels computes; the kernels are held
against them on the card (``chip_smoke.RNN_CASES``,
``tests/test_torch_cuda.py``).

Tolerances: fp32 1e-5 abs (the same fp32 math in another summation order);
bf16 streams: the forward 2e-2 abs (both round h to bf16 at the same
points), the backward's dgx within 2 bf16 ulps (2^-6) of max(|want|, 1) per
entry (both round dpre to bf16 at the same points).  One direction is held
against direction 0 of the two-direction JAX kernel."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.rnn_pallas_v2 import rnn_bidir_v2, rnn_scan_v2
from ctc_pytorch_tpu_torch.ops import rnn_bidir as rnn_ops
from ctc_pytorch_tpu_torch.ops import rnn_bidir_train as train_ops

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  the card's cases

FP32_TOL, BF16_TOL, BF16_BWD_RTOL = 1e-5, 2e-2, 2.0 ** -6
SMEM = 232448  # an H100 CTA's shared memory, opt-in

# The one-gate bounds of csrc/fwd_cluster.cuh (largest H that a branch
# holds): the tensor-core kernel with 16 and 32 batch rows, the fp32 kernel
# (four adjacent units to a float4) with clusters of 8 and of 16.
MMA1_BOUND = {16: 512, 32: 512}
FMA1_BOUND_CL8, FMA1_BOUND_CL16 = 558, 726


def mma1_holds(h, rows):
    """Python mirror of ``mma_shape(1, H, rows / 16)`` and the launcher's
    test: at most 8 warps of 8 units a CTA, weights and h buffers within the
    shared memory."""
    uc = -(-(-(-h // 8)) // 8) * 8
    ldk = -(-h // 16) * 16 + 8
    return uc <= 64 and (uc + 2 * rows) * ldk * 2 <= SMEM


def fma1_cluster(h):
    """Python mirror of ``fma1_shape``: the cluster size (8, else 16) whose
    resident fp32 weights [H][Uc] (Uc a multiple of 4) and h buffers [2][H]
    [16] fit, or None."""
    for cl in (8, 16):
        uc = -(-(-(-h // cl)) // 4) * 4
        if 4 * h * uc + 2 * h * 16 * 4 <= SMEM:
            return cl
    return None


def fma1_slices(b, h):
    """Python mirror of ``fma1_slices``: the k slices of an item."""
    cl = fma1_cluster(h)
    uc = -(-(-(-h // cl)) // 4) * 4
    items = uc // 4 * ((min(b, 16) + 3) // 4)
    ksn = 1
    while ksn < 16 and items * ksn * 2 <= 256:
        ksn *= 2
    return ksn


def header_text():
    text = (rnn_ops.LIBRARY.headers[-1]).read_text()
    assert rnn_ops.LIBRARY.headers[-1].name == "fwd_cluster.cuh"
    return " ".join(w for w in text.split() if w != "//")


def test_the_one_gate_bounds_are_the_headers():
    text = header_text()
    for want in ("tanh H <= 512 with 16 and with 32 rows",
                 "H <= 558 at CL = 8, H <= 726 at CL = 16",
                 "37.6 KB at tanh H = 384 (Uc = 48, CL = 8; 63 KB a CTA",
                 "88 KB with 32", "74 KB a CTA in a portable cluster of 8"):
        assert want in text, want
    for rows, bound in MMA1_BOUND.items():
        assert mma1_holds(bound, rows) and not mma1_holds(bound + 1, rows)
    assert fma1_cluster(FMA1_BOUND_CL8) == 8
    assert fma1_cluster(FMA1_BOUND_CL8 + 1) == 16
    assert fma1_cluster(FMA1_BOUND_CL16) == 16
    assert fma1_cluster(FMA1_BOUND_CL16 + 1) is None


def test_the_header_sizes_at_the_bench_width():
    """H = 384: the bf16 CTA holds 48 units' w_hh columns in 37.6 KB, 63 KB
    with 16 rows' h buffers and 88 KB with 32; the fp32 CTA holds 74 KB of
    weights in a cluster of 8, and the recipe's batch of 8 gives its items
    8 k slices, B = 16 four."""
    h = 384
    uc, ldk = 48, 392
    assert round(uc * ldk * 2 / 1e3, 1) == 37.6
    assert [round((uc + 2 * rows) * ldk * 2 / 1e3) for rows in (16, 32)] == [63, 88]
    assert fma1_cluster(h) == 8 and round(4 * h * 48 / 1e3) == 74
    assert fma1_slices(8, h) == 8 and fma1_slices(16, h) == 4
    assert fma1_slices(1, 37) == 16


def test_the_card_cases_respect_the_bounds():
    """Every ``chip_smoke.RNN_CASES`` shape past its dtype's cluster bound
    expects the grid (fp32 streams: the wide branch where its shape holds,
    ``tests/test_torch_rnn_wide.py``), and every shape within it whose few
    clusters surely fit expects a cluster branch of its dtype; the list
    covers both sides of each bound, T = 1, one direction and both
    kernels."""
    from test_torch_wide_fwd import wide_shape

    seen = set()
    for kernel, t, b, h, dtype, ndir, branch, _ in chip_smoke.RNN_CASES:
        holds = (mma1_holds(h, 16) if dtype == "bf16"
                 else fma1_cluster(h) is not None)
        clusters = ndir * -(-b // 16)
        if not holds:
            wide = dtype == "fp32" and wide_shape(1, h, b, ndir) is not None
            assert branch == ("wide_fp32" if wide else "grid"), (
                kernel, t, b, h, dtype)
        elif clusters <= 8:
            assert branch.startswith("cluster"), (kernel, t, b, h, dtype)
            assert branch.endswith("_fp32") == (dtype == "fp32")
        seen.add((kernel, dtype, h, holds))
    for kernel in ("fwd", "bwd"):
        for dtype, bound in (("bf16", 512), ("fp32", FMA1_BOUND_CL8),
                             ("fp32", FMA1_BOUND_CL16)):
            assert (kernel, dtype, bound, True) in seen
            assert (kernel, dtype, bound + 1, bound == FMA1_BOUND_CL8) in seen
    assert any(c[1] == 1 for c in chip_smoke.RNN_CASES)
    assert any(c[5] == 1 for c in chip_smoke.RNN_CASES)


def inputs(t, b, h, dtype, seed):
    rng = np.random.RandomState(seed)
    gx = rng.randn(t, b, 2 * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)
    return (torch.from_numpy(gx).to(dtype), torch.from_numpy(w_hh),
            torch.from_numpy(dy).to(dtype))


def jax_stream(x: torch.Tensor):
    sd = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x.float().numpy()).astype(sd)


def one_dir(plane, h, ndir):
    """The first ``ndir`` directions' lanes of a two-direction plane."""
    return plane[..., :ndir * h].contiguous()


# (T, B, H, stream dtype, directions): H on each side of the bounds of the
# bf16 cluster (16 and 32 rows) and of the fp32 cluster (8 and 16 CTAs),
# T <= 4 at H >= 400
CASES = [
    (2, 16, MMA1_BOUND[16], torch.bfloat16, 2),
    (2, 1, MMA1_BOUND[16] + 1, torch.bfloat16, 1),
    (2, 32, MMA1_BOUND[32], torch.bfloat16, 1),
    (2, 33, MMA1_BOUND[32] + 1, torch.bfloat16, 2),
    (2, 8, FMA1_BOUND_CL8, torch.float32, 2),
    (2, 17, FMA1_BOUND_CL8 + 1, torch.float32, 1),
    (2, 1, FMA1_BOUND_CL16, torch.float32, 2),
    (2, 8, FMA1_BOUND_CL16 + 1, torch.float32, 2),
    (1, 8, 384, torch.float32, 2),  # T = 1
    (1, 16, 64, torch.bfloat16, 1),
    (4, 17, 64, torch.bfloat16, 2),  # B = 17
    (3, 48, 40, torch.float32, 1),  # B >= 32
    (5, 1, 37, torch.bfloat16, 2),  # B = 1, H % 8 != 0
    (6, 8, 384, torch.float32, 2),  # the recipe's batch and width
]


@pytest.mark.parametrize("t,b,h,dtype,ndir", CASES)
def test_tanh_forward_twin_matches_pallas_eval_and_training(t, b, h, dtype, ndir):
    gx, w_hh, _ = inputs(t, b, h, dtype, seed=t + 3 * b + h)
    got = rnn_ops.rnn_bidir(one_dir(gx, h, ndir), w_hh[:ndir].contiguous())
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    train = rnn_scan_v2(jax_stream(gx), jnp.asarray(w_hh.numpy()), 1, True)
    want = np.asarray(train[1:t + 1], np.float32)[..., :ndir * h]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    if dtype == torch.float32 or b % 16 == 0:
        # the eval kernel, through an identity projection (its stream dtype
        # follows the JAX rule: bf16 only where B % 16 == 0)
        eye = np.eye(2 * h, dtype=np.float32)
        w_ih = np.stack([eye[:, :h], eye[:, h:]])
        cd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        ev = rnn_bidir_v2(jnp.asarray(gx.float().numpy()), jnp.asarray(w_ih),
                          jnp.asarray(w_hh.numpy()), chunk=1, interpret=True,
                          compute_dtype=cd, train=False)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ev, np.float32)[..., :ndir * h], rtol=0,
            atol=tol)


@pytest.mark.parametrize("t,b,h,dtype,ndir", CASES)
def test_tanh_backward_twin_matches_the_pallas_vjp(t, b, h, dtype, ndir):
    """``dgx`` of the backward twin, given the Pallas forward's ``ys``,
    against the VJP of ``rnn_scan_v2`` (its ``_bwd_pallas``) with the same
    cotangent."""
    gx, w_hh, dy = inputs(t, b, h, dtype, seed=2 * t + b + h)
    jw = jnp.asarray(w_hh.numpy())
    ys, vjp = jax.vjp(lambda g: rnn_scan_v2(g, jw, 1, True)[1:t + 1],
                      jax_stream(gx))
    (want,) = vjp(jax_stream(dy))
    ys_t = torch.from_numpy(np.array(ys, np.float32)).to(dtype)
    got = train_ops.rnn_bidir_train_backward_plain(
        w_hh[:ndir].contiguous(), one_dir(ys_t, h, ndir), one_dir(dy, h, ndir))
    assert got.dtype == dtype
    want = torch.from_numpy(np.array(want, np.float32))[..., :ndir * h]
    err = (got.float() - want).abs()
    if dtype == torch.bfloat16:
        assert (err / want.abs().clamp(min=1.0)).max().item() <= BF16_BWD_RTOL
    else:
        assert err.max().item() <= FP32_TOL
