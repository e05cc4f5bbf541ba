"""The GRU backward's serial chain on fp32 streams, which the fp32 cluster
branch (``bwd_fma_kernel<GruCell>`` in ``csrc/bwd_hoist.cuh``,
``cluster16_fp32``) computes: the header's resident bounds at clusters of 8
and 16 against the shared-memory arithmetic, the branch every GRU entry of
``chip_smoke.HOIST_CASES`` expects, and an emulation of the kernel's
summation order -- CTA p multiplies its 3 Uc gate columns ``[dpre_r,
dpre_z, dhh_n]`` (padded with zero columns to Kp, a multiple of 16), k
slice ks the columns with ``k % KSN == ks``, the slices meeting in the
reduce-scatter's butterfly, the CTAs' partials added in rank order, and the
local ``dh_t Z`` added after them -- over the 863 recipe's longest bucket
(T' = 195, B = 8, H = 256), held against the VJP of the JAX package's
``gru_scan_train_v2`` in interpret mode.  Nothing here launches a kernel;
the kernel is held against the twins on the card (``chip_smoke.HOIST_CASES``,
``tests/test_torch_cuda.py``).

Tolerance: dgx 1e-4 abs, the card's fp32 tolerance (``PERF.md`` §2); dW_hh,
a sum over T B rows, 1e-4 of its largest entry, as
``tests/test_torch_gru_train.py`` holds the twin."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.gru_pallas_v2 import gru_scan_train_v2
from ctc_pytorch_tpu_torch.ops import gru_bidir as eval_ops
from ctc_pytorch_tpu_torch.ops import gru_bidir_train as ops
from ctc_pytorch_tpu_torch.ops._build import BRANCHES, CSRC, per_direction, step_times
from test_torch_wide_bwd import fp32_branch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  the card's cases

SMEM = 232448  # an H100 CTA's shared memory, opt-in
ROWS, LD, THREADS = 16, 20, 384  # kFmaBwdRows, kFmaBwdLd, kFmaBwdThreads
GATES = 3
# the GRU's fp32 cluster bounds (largest H) with 8 and 16 CTAs
BOUND_CL8, BOUND_CL16 = 344, 500
TOL = 1e-4


def fma_bwd_shape(h, gates=GATES):
    """Python mirror of the header's ``fma_bwd_shape``: ``(uc, cl, kp, ksn,
    threads, smem, ok)``."""
    nq = -(-h // 4)
    for cl in (8, 16):
        uc = -(-(-(-h // cl)) // 4) * 4
        cl_eff = -(-h // uc)
        kp = -(-(gates * uc) // 16) * 16
        smem = (kp * 4 * nq + kp * LD + cl_eff * ROWS * uc) * 4
        if smem <= SMEM:
            break
    ksn = 8
    while ksn > 1 and nq * ksn > THREADS:
        ksn //= 2
    threads = -(-(nq * ksn) // 32) * 32
    ok = smem <= SMEM and ksn >= 2 and ROWS * (uc // 4) <= threads
    return uc, cl_eff, kp, ksn, threads, smem, ok


def header_text():
    return " ".join(w for w in (CSRC / "bwd_hoist.cuh").read_text().split()
                    if w != "//")


def test_the_gru_bounds_are_the_headers():
    text = header_text()
    for want in (f"Bound: H <= {BOUND_CL8} at CL = 8, H <= {BOUND_CL16} at "
                 f"CL = 16",
                 "(Uc = 32, Kp = 96, 122 KB a CTA with dpre^T and the receive "
                 "buffer)"):
        assert want in text, want
    assert fma_bwd_shape(BOUND_CL8)[1] == 8 and fma_bwd_shape(BOUND_CL8)[-1]
    assert fma_bwd_shape(BOUND_CL8 + 1)[1] > 8  # 15 CTAs at H = 345
    assert fma_bwd_shape(BOUND_CL16)[1] == 16 and fma_bwd_shape(BOUND_CL16)[-1]
    assert not fma_bwd_shape(BOUND_CL16 + 1)[-1]
    assert all(fma_bwd_shape(h)[-1] for h in range(1, BOUND_CL16 + 1))
    uc, cl, kp, ksn, threads, smem, ok = fma_bwd_shape(256)
    assert (uc, cl, kp, ksn, threads, ok) == (32, 8, 96, 4, 256, True)
    assert round(smem / 1e3) == 122
    # the LSTM's four gate columns a unit need no padding: Kp = 4 Uc
    assert all(fma_bwd_shape(h, 4)[2] == 4 * fma_bwd_shape(h, 4)[0]
               for h in (37, 256, 384, 432))
    assert BRANCHES[3] == "cluster16_fp32"


def expected_branch(b, h, ndir):
    """The launcher's rule for the GRU on fp32 streams: the fp32 cluster
    where its shared memory fits and all of its clusters fit at once (15
    clusters of 8 one-CTA-per-SM blocks, surely four of 16, fewer than 8 of
    16), else the wide branch where its shape holds, else the grid; None
    where only the card's occupancy tells (``test_torch_wide_bwd.
    fp32_branch``)."""
    return fp32_branch("gru", b, h, ndir)


GRU_FP32 = [c for c in chip_smoke.HOIST_CASES if c[0] == "gru" and c[4] == "fp32"]


@pytest.mark.parametrize("case", GRU_FP32, ids=lambda c: "-".join(map(str, c)))
def test_each_gru_fp32_card_case_names_its_branch(case):
    _, t, b, h, _, ndir, branch = case
    assert expected_branch(b, h, ndir) == branch, case


def test_the_card_cases_cover_the_gru_fp32_branch():
    """The 863 GRU model at B = 8 and its longest bucket, B = 128 on the
    wide branch, T = 1 with B = 1, B = 17, one direction with H % 4 != 0,
    each side of both bounds (past the last, the wide branch); a graph case
    of the branch."""
    got = {(t, b, h, ndir): branch for _, t, b, h, _, ndir, branch in GRU_FP32}
    for key, branch in (((95, 8, 256, 2), "cluster16_fp32"),
                        ((195, 8, 256, 2), "cluster16_fp32"),
                        ((95, 128, 256, 2), "wide_fp32"),
                        ((1, 1, 32, 2), "cluster16_fp32"),
                        ((12, 17, 48, 2), "cluster16_fp32"),
                        ((10, 20, 37, 1), "cluster16_fp32"),
                        ((6, 8, BOUND_CL8, 2), "cluster16_fp32"),
                        ((6, 8, BOUND_CL8 + 1, 2), "cluster16_fp32"),
                        ((6, 8, BOUND_CL16, 2), "cluster16_fp32"),
                        ((6, 8, BOUND_CL16 + 1, 2), "wide_fp32")):
        assert got.get(key) == branch, key
    assert fma_bwd_shape(BOUND_CL8 + 1)[1] > 8  # 15 CTAs at H = 345
    assert ("gru_bwd", 95, 8, 256, "fp32", 2, "cluster16_fp32") in \
        chip_smoke.GRAPH_CASES


def cluster_order_contraction(dhh, w, h):
    """``dh (ndir, B, H) = dhh (ndir, B, 3H) @ w^T`` summed as the fp32
    cluster sums it: CTA p multiplies its columns ``q H + p Uc + u`` (q < 3,
    then zero columns up to Kp), k slice ks of them those with ``k % KSN ==
    ks`` (k = q Uc + u); the slices meet in the reduce-scatter's butterfly
    (round r adds the partner whose slice differs in bit r), row j finishing
    in slice ``j % KSN``; each CTA's partial enters dh in rank order."""
    uc, cl, kp, ksn, _, _, _ = fma_bwd_shape(h)
    ndir, b, _ = dhh.shape
    zero = 3 * h  # a zero column
    dpad = torch.cat([dhh, dhh.new_zeros(ndir, b, 1)], -1)
    wpad = torch.cat([w, w.new_zeros(ndir, h, 1)], -1)
    dh = dhh.new_zeros(ndir, b, h)
    rows = torch.arange(b) % ksn
    for p in range(cl):
        ks_cols = [q * h + p * uc + u if q < 3 and p * uc + u < h else zero
                   for q in range(kp // uc + 1) for u in range(uc)][:kp]
        cols = [ks_cols[ks::ksn] for ks in range(ksn)]
        idx = torch.tensor(cols)  # (KSN, Kp / KSN)
        part = torch.einsum("dbsk,dnsk->sdbn", dpad[..., idx], wpad[..., idx])
        lanes = list(part)
        for r in range(ksn.bit_length() - 1):
            lanes = [lanes[ks] + lanes[ks ^ (1 << r)] for ks in range(ksn)]
        dh = dh + torch.stack(lanes)[rows, :, torch.arange(b)].transpose(0, 1)
    return dh


def emulated_serial(planes, w_hh, dy):
    """``gru_bidir_train_bwd_serial_plain`` in fp32 with its contraction
    summed in the cluster's order and ``dh_t Z`` added after the receive
    sum: ``(dgx, dhhn)``."""
    ndir, t_len, _, b, h = planes.shape
    dy_d = per_direction(dy, ndir)
    dh = torch.zeros(ndir, b, h)
    carry = torch.zeros_like(dh)
    dgx = torch.empty(t_len, b, ndir * 3 * h)
    dhhn = torch.empty(t_len, b, ndir * h)
    for s in range(t_len):
        times = step_times(t_len, ndir, t_len - 1 - s)
        p_r, p_z, p_n, p_hn, z = torch.stack(
            [planes[d, t] for d, t in enumerate(times)]).unbind(1)
        dh_t = torch.stack([dy_d[d, t] for d, t in enumerate(times)]) + (
            dh + carry)
        dpre = torch.cat([dh_t * p_r, dh_t * p_z, dh_t * p_n], dim=-1)
        dhh_n = dh_t * p_hn
        for d, t in enumerate(times):
            dgx[t, :, 3 * d * h:3 * (d + 1) * h] = dpre[d]
            dhhn[t, :, d * h:(d + 1) * h] = dhh_n[d]
        dh = cluster_order_contraction(
            torch.cat([dpre[..., :2 * h], dhh_n], dim=-1), w_hh, h)
        carry = dh_t * z
    return dgx, dhhn


def test_the_emulation_is_the_twins_function_at_a_small_width():
    """At a small width (H % 4 != 0, so Kp pads) the emulated order is the
    serial twin's function, fp32 rounding apart."""
    gen = torch.Generator().manual_seed(4)
    t, b, h = 5, 3, 13
    gx = torch.randn(t, b, 6 * h, generator=gen)
    w_hh = (torch.rand(2, h, 3 * h, generator=gen) * 2 - 1) * h ** -0.5
    dy = torch.randn(t, b, 2 * h, generator=gen)
    ys = eval_ops.gru_bidir_plain(gx, w_hh)
    planes = ops.gru_bidir_train_bwd_prepass_plain(gx, w_hh, ys)
    want = ops.gru_bidir_train_bwd_serial_plain(planes, w_hh, dy)
    for got, ref in zip(emulated_serial(planes, w_hh, dy), want):
        assert (got - ref).abs().max().item() <= 1e-6


def test_the_cluster_order_holds_the_pallas_vjp_over_the_longest_bucket():
    """The 863 GRU model's layer at B = 8 (fp32 streams: the recipe's batch
    of 16 over two data-parallel ranks) over its longest bucket, T' = 195,
    H = 256, a cluster of 8: the emulated chain within 1e-4 of the VJP of
    ``gru_scan_train_v2`` (interpret mode) in dgx, and dW_hh formed from
    the emulated dgx and dhhn within 1e-4 of its largest entry."""
    t, b, h = 195, 8, 256
    assert fma_bwd_shape(h)[1] == 8
    rng = np.random.RandomState(195)
    gx = rng.randn(t, b, 6 * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, 3 * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)

    def jax_loss(g, w):
        ys = gru_scan_train_v2(g, w, 1, True)[1:t + 1]
        return jnp.sum(ys * dy)

    want_dgx, want_dw = (np.asarray(a, dtype=np.float32) for a in jax.grad(
        jax_loss, argnums=(0, 1))(jnp.asarray(gx), jnp.asarray(w_hh)))
    tg, tw, td = torch.tensor(gx), torch.tensor(w_hh), torch.tensor(dy)
    ys = eval_ops.gru_bidir_plain(tg, tw)
    planes = ops.gru_bidir_train_bwd_prepass_plain(tg, tw, ys)
    dgx, dhhn = emulated_serial(planes, tw, td)
    assert torch.isfinite(dgx).all() and torch.isfinite(dhhn).all()
    np.testing.assert_allclose(dgx.numpy(), want_dgx, rtol=0, atol=TOL)
    dw = ops.dw_hh(ys, dgx, dhhn, 2).numpy()
    np.testing.assert_allclose(dw, want_dw, rtol=0,
                               atol=TOL * max(1.0, np.abs(want_dw).max()))
