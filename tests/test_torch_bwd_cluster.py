"""The LSTM backward's serial chain on fp32 streams, which its fp32 cluster
branch (``bwd_fma_kernel`` in ``csrc/bwd_hoist.cuh``, ``cluster16_fp32``)
computes: the header's resident bounds against the shared-memory
arithmetic, the branch every ``chip_smoke.HOIST_CASES`` entry expects, the
hand-written backward twin against the JAX package's Pallas VJP (interpret
mode) at the shapes the branch tells apart, and an emulation of the
kernel's summation order against the serial twin over the recipes'
longest chains.  Nothing here launches a kernel; the kernel is held against
the twins on the card (``chip_smoke.HOIST_CASES``,
``tests/test_torch_cuda.py``).

Tolerances: the twin against Pallas fp32 1e-5 abs (the same fp32 math in
another summation order), as ``test_torch_lstm_train.py``; the emulation
against the twin 1e-4 abs, the card's fp32 tolerance (``PERF.md`` §2)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.lstm_pallas_train_v2 import lstm_scan_train_v2
from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as ops
from ctc_pytorch_tpu_torch.ops._build import BRANCHES, per_direction, step_times
from test_torch_wide_bwd import fp32_branch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  the card's cases

SMEM = 232448  # an H100 CTA's shared memory, opt-in
ROWS, LD, THREADS = 16, 20, 384  # kFmaBwdRows, kFmaBwdLd, kFmaBwdThreads
# the fp32 cluster's resident bounds (largest H) with 8 and 16 CTAs
BOUND_CL8, BOUND_CL16 = 308, 432
# the bf16 cluster's bounds (bwd_cluster_kernel), per cell
MMA_BOUND = {"lstm": 416, "gru": 480}


def fma_bwd_shape(h, gates=4):
    """Python mirror of the header's ``fma_bwd_shape``: ``(uc, cl, ksn,
    threads, smem, ok)``; the CTA's gate columns are ``gates`` Uc rounded up
    to 16 (the LSTM's 4 Uc already are)."""
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
    return uc, cl_eff, ksn, threads, smem, ok


def header_text():
    path = ops.LIBRARY.headers[1]
    assert path.name == "bwd_hoist.cuh"
    return " ".join(w for w in path.read_text().split() if w != "//")


def test_the_fp32_bounds_are_the_headers():
    text = header_text()
    for want in (f"H <= {BOUND_CL8} at CL = 8, H <= {BOUND_CL16} at CL = 16",
                 "Uc = 24, 147 KB a CTA", "(Uc = 32, 131 KB)",
                 "a CTA of a cluster of 16 sends 11.5 KB of partials a step",
                 "the gather would bring 49 KB into each CTA"):
        assert want in text, want
    assert fma_bwd_shape(BOUND_CL8)[1] == 8 and fma_bwd_shape(BOUND_CL8)[5]
    assert fma_bwd_shape(BOUND_CL8 + 1)[1] == 16
    assert fma_bwd_shape(BOUND_CL16)[1] == 16 and fma_bwd_shape(BOUND_CL16)[5]
    assert not fma_bwd_shape(BOUND_CL16 + 1)[5]
    assert BRANCHES[3] == "cluster16_fp32"


@pytest.mark.parametrize("h,uc,cl,ksn,threads,kb", [
    (384, 24, 16, 4, 384, 147.5),  # the flagship: a cluster of 16
    (256, 32, 8, 4, 256, 131.1),   # mfcc_39: a cluster of 8
    (48, 8, 6, 8, 96, 6.1),
    (37, 8, 5, 8, 96, 5.1),
])
def test_the_shapes_at_the_recipes_widths(h, uc, cl, ksn, threads, kb):
    """Units a CTA, CTAs, k slices, threads and the resident weights' KB; at
    B = 8, H = 384 a CTA sends 15 peers 8 rows x 24 units of fp32 a step
    (11.5 KB), where a split of the units would gather 8 x 4H (49 KB)."""
    got = fma_bwd_shape(h)
    assert got[:4] == (uc, cl, ksn, threads) and got[5]
    assert round(4 * uc * 4 * -(-h // 4) * 4 / 1e3, 1) == kb
    assert round(15 * 8 * 24 * 4 / 1e3, 1) == 11.5
    assert round(8 * 4 * 384 * 4 / 1e3) == 49


def expected_branch(cell, b, h, dtype, ndir):
    """The branch of the launcher's rule for a HOIST_CASES entry, or None
    where only the card's cluster capacity decides.  Clusters of 8 CTAs: 15
    fit at once on the card; clusters of 16 surely fit four at once and
    surely not more than eight (one a GPC).  fp32 streams take the fp32
    cluster for both cells (the GRU with three gate columns a unit); where
    it does not fit, the wide branch where its shape holds, else the grid
    (``test_torch_wide_bwd.fp32_branch``)."""
    if dtype == "bf16":
        return "cluster" if h <= MMA_BOUND[cell] else "grid"
    return fp32_branch(cell, b, h, ndir)


@pytest.mark.parametrize("case", chip_smoke.HOIST_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_each_card_case_names_its_branch(case):
    cell, t, b, h, dtype, ndir, branch = case
    want = expected_branch(cell, b, h, dtype, ndir)
    assert want is not None and branch == want, (case, want)


def test_the_card_cases_cover_the_fp32_branch():
    """Both sides of each fp32 bound, the recipes' shapes, T = 1, B = 1 with
    one direction, and B = 128 on the wide branch, which takes H past the
    cluster's bound too."""
    fp32 = {(t, b, h, ndir): branch for cell, t, b, h, dtype, ndir, branch
            in chip_smoke.HOIST_CASES if cell == "lstm" and dtype == "fp32"}
    for key, branch in (((100, 8, 384, 2), "cluster16_fp32"),
                        ((400, 8, 256, 2), "cluster16_fp32"),
                        ((100, 4, 384, 2), "cluster16_fp32"),
                        ((1, 8, 384, 2), "cluster16_fp32"),
                        ((9, 1, 384, 1), "cluster16_fp32"),
                        ((80, 128, 384, 2), "wide_fp32")):
        assert fp32.get(key) == branch, key
    hs = {h: branch for (_, b, h, _), branch in fp32.items() if b <= 8}
    assert hs.get(BOUND_CL16) == "cluster16_fp32"
    assert hs.get(BOUND_CL16 + 1) == "wide_fp32"
    assert any(fma_bwd_shape(h)[1] <= 8 for h in hs)


def pallas_dgx(t, b, h, ndir, seed):
    """``(want, gx, w_hh, dy)``: the VJP of ``lstm_scan_train_v2`` in
    interpret mode on fp32 inputs made with numpy (direction 0 of it for
    one direction), and the twin's inputs."""
    rng = np.random.RandomState(seed)
    gx = rng.randn(t, b, 8 * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, 4 * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)

    def jax_loss(g):
        ys = lstm_scan_train_v2(g, jnp.asarray(w_hh), 1, True)[1:t + 1]
        return jnp.sum(ys * dy)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(gx)))
    tg, tw, td = torch.tensor(gx), torch.tensor(w_hh), torch.tensor(dy)
    if ndir == 1:
        tg, tw, td = tg[..., :4 * h], tw[:1], td[..., :h]
        want = want[..., :4 * h]
    return want, tg, tw, td


# (T, B, H, directions): the batch sizes of the branch's row slices (1, 4,
# 8, 17), T = 1, one direction, H not a multiple of 4, H at the CL = 8 bound
@pytest.mark.parametrize("t,b,h,ndir", [
    (3, 1, 16, 2),
    (3, 4, 16, 2),
    (4, 8, 16, 2),
    (3, 17, 12, 2),
    (1, 8, 16, 2),
    (4, 8, 16, 1),
    (3, 5, 13, 2),
    (2, 2, BOUND_CL8, 1),
])
def test_fp32_backward_twin_matches_the_pallas_vjp(t, b, h, ndir):
    want, tg, tw, td = pallas_dgx(t, b, h, ndir, seed=7 * t + b + h)
    ys, cs = ops.lstm_bidir_train_plain(tg, tw)
    dgx = ops.lstm_bidir_train_backward_plain(tg, tw, ys, cs, td)
    assert dgx.dtype == torch.float32 and dgx.shape == (t, b, ndir * 4 * h)
    np.testing.assert_allclose(dgx.numpy(), want, rtol=0, atol=1e-5)


def cluster_order_contraction(dpre, w, h):
    """``dh (ndir, B, H)`` = ``dpre (ndir, B, 4H) @ w^T`` summed as the fp32
    cluster sums it: CTA p multiplies its gate columns ``q H + p Uc + u``,
    k slice ks of them the columns with ``k % KSN == ks`` (k = q Uc + u);
    the slices meet in the reduce-scatter's butterfly (round r adds the
    partner whose slice differs in bit r), row j finishing in slice ``j %
    KSN``; each CTA's partial then enters dh in rank order."""
    uc, cl, ksn, _, _, _ = fma_bwd_shape(h)
    ndir, b, _ = dpre.shape
    dpad = torch.cat([dpre, dpre.new_zeros(ndir, b, 1)], -1)  # col 4H: zero
    wpad = torch.cat([w, w.new_zeros(ndir, h, 1)], -1)
    dh = dpre.new_zeros(ndir, b, h)
    rows = torch.arange(b) % ksn
    for p in range(cl):
        cols = [[q * h + p * uc + u if p * uc + u < h else 4 * h
                 for q in range(4) for u in range(uc)][ks::ksn]
                for ks in range(ksn)]
        idx = torch.tensor(cols)  # (KSN, K / KSN)
        part = torch.einsum("dbsk,dnsk->sdbn", dpad[..., idx], wpad[..., idx])
        lanes = list(part)
        for r in range(ksn.bit_length() - 1):
            lanes = [lanes[ks] + lanes[ks ^ (1 << r)] for ks in range(ksn)]
        dh = dh + torch.stack(lanes)[rows, :, torch.arange(b)].transpose(0, 1)
    return dh


def emulated_serial(planes, w_hh, dy):
    """``lstm_bidir_train_bwd_serial_plain`` in fp32 with its contraction
    summed in the cluster's order."""
    ndir, t_len, _, b, h = planes.shape
    wt = w_hh
    dy_d = per_direction(dy, ndir)
    dh = torch.zeros(ndir, b, h)
    dc = torch.zeros_like(dh)
    dgx = torch.empty(t_len, b, ndir * 4 * h)
    for s in range(t_len):
        times = step_times(t_len, ndir, t_len - 1 - s)
        a, gi, gf, gg, go, f = torch.stack(
            [planes[d, t] for d, t in enumerate(times)]).unbind(1)
        dh_t = torch.stack([dy_d[d, t] for d, t in enumerate(times)]) + dh
        dct = dc + dh_t * a
        dpre = torch.cat([dct * gi, dct * gf, dct * gg, dh_t * go], dim=-1)
        for d, t in enumerate(times):
            dgx[t, :, 4 * d * h:4 * (d + 1) * h] = dpre[d]
        dh = cluster_order_contraction(dpre, wt, h)
        dc = dct * f
    return dgx


def test_the_emulation_sums_as_the_twin_on_a_small_chain():
    """At a small width the emulated order is the twin's function (fp32
    rounding apart): the emulation itself is right."""
    gen = torch.Generator().manual_seed(3)
    t, b, h = 5, 3, 13
    gx = torch.randn(t, b, 8 * h, generator=gen)
    w_hh = (torch.rand(2, h, 4 * h, generator=gen) * 2 - 1) * h ** -0.5
    dy = torch.randn(t, b, 2 * h, generator=gen)
    ys, cs = ops.lstm_bidir_train_plain(gx, w_hh)
    planes = ops.lstm_bidir_train_bwd_prepass_plain(gx, w_hh, ys, cs)
    want = ops.lstm_bidir_train_bwd_serial_plain(planes, w_hh, dy)
    got = emulated_serial(planes, w_hh, dy)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("t,b,h", [(100, 8, 384), (400, 8, 256)])
def test_the_cluster_summation_order_holds_the_tolerance(t, b, h):
    """The recipe's chain (T' = 100, H = 384, a cluster of 16) and
    mfcc_39's longest (T' = 400, H = 256, a cluster of 8), two directions:
    the emulated order stays within the card's fp32 tolerance of the
    serial twin over every step."""
    rng = np.random.RandomState(t + h)
    gx = torch.tensor(rng.randn(t, b, 8 * h).astype(np.float32))
    w_hh = torch.tensor(((rng.rand(2, h, 4 * h) * 2 - 1)
                         / np.sqrt(h)).astype(np.float32))
    dy = torch.tensor(rng.randn(t, b, 2 * h).astype(np.float32))
    ys, cs = ops.lstm_bidir_train_plain(gx, w_hh)
    planes = ops.lstm_bidir_train_bwd_prepass_plain(gx, w_hh, ys, cs)
    want = ops.lstm_bidir_train_bwd_serial_plain(planes, w_hh, dy)
    got = emulated_serial(planes, w_hh, dy)
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= 1e-4, err
