"""The wide-batch fp32 backward serial chain (``bwd_wide_kernel`` in
``csrc/bwd_wide.cuh``, branch ``wide_fp32``): the header's shapes, bounds
and scratch against the shared-memory arithmetic through a Python mirror of
its shape rule, the launcher's rule (``csrc/bwd_hoist.cuh:cluster_branch``)
for every ``chip_smoke.HOIST_CASES`` entry, and an emulation of the
kernel's arithmetic -- each CTA's partial dh over its own gate columns,
both operands split into tf32 hi (round to nearest on the mantissa) and lo
= x - hi, which the tensor core reads truncated to tf32, ``lo_a hi_w + hi_a
lo_w + hi_a hi_w`` summed in fp32 a k-step at a time in order, the
partials added in writer order -- through whole LSTM and GRU backward
chains at full width (T' = 20, B = 64, H = 384; the GRU H = 256), held
against the serial twins and against the JAX package's Pallas VJPs in
interpret mode.  Nothing here launches a kernel; the kernel is held
against the twins on the card (``chip_smoke.HOIST_CASES``,
``tests/test_torch_cuda.py``).

Tolerance: 1e-4 abs, the card's fp32 tolerance (``PERF.md`` §2); a single
TF32 pass would not hold it, 3xTF32 keeps the products' error near 2^-21."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.gru_pallas_v2 import gru_scan_train_v2
from ctc_pytorch_tpu.ops.lstm_pallas_train_v2 import lstm_scan_train_v2
from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_eval_ops
from ctc_pytorch_tpu_torch.ops import gru_bidir_train as gru_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as lstm_ops
from ctc_pytorch_tpu_torch.ops._build import (
    BRANCHES,
    CSRC,
    per_direction,
    step_times,
)
from test_torch_wide_fwd import split

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  the card's cases

SMEM = 232448  # an H100 CTA's shared memory, opt-in
SMS = 132      # an H100 SXM's SMs
MAX_WARPS, MAX_MT = 12, 4  # kWideMaxWarps, kBwdWideMaxMt
TOL = 1e-4


def bwd_wide_shape(gates, h, b, ndir, sms=SMS):
    """Python mirror of the header's ``bwd_wide_shape``: ``(uc, nj, rb, nr,
    ntw, wwarps, warps, smem)`` or None where no shape holds."""
    nt = -(-h // 8)
    ntw = -(-nt // MAX_WARPS)
    wwarps = -(-nt // ntw)
    bp = -(-b // 16) * 16
    best, best_work = None, None
    for uc in range(8, 8 * nt + 1, 8):
        nj = -(-h // uc)
        for rb in range(16, min(bp, 16 * MAX_MT) + 1, 16):
            nr = -(-b // rb)
            if ndir * nr * nj > sms:
                continue
            iwarps = -(-(rb * uc // 4) // 32)
            smem = 4 * gates * uc * 8 * nt + 8 * rb * gates * uc
            if iwarps > MAX_WARPS or smem > SMEM:
                break
            work = rb * uc
            if best is None or work < best_work or (
                    work == best_work and uc > best[0]):
                best = (uc, nj, rb, nr, ntw, wwarps, max(wwarps, iwarps), smem)
                best_work = work
            break
    return best


def header_text():
    return " ".join(w for w in (CSRC / "bwd_wide.cuh").read_text().split()
                    if w != "//")


def test_the_bench_shapes_are_the_headers():
    text = header_text()
    for want in ("Uc = 24, RB = 32, 128 CTAs of 12 warps, 147 KB of weights "
                 "+ 24 KB of dpre",
                 "B = 64: Uc = 24, RB = 16, 128 CTAs",
                 "Uc = 32, RB = 16, 128 CTAs of 11 warps, 98 KB + 12 KB",
                 "each CTA writes 49 KB and reads 49 KB a step, 6.3 MB each "
                 "way over the card",
                 "would read 25 MB a step"):
        assert want in text, want
    uc, nj, rb, nr, ntw, wwarps, warps, smem = bwd_wide_shape(4, 384, 128, 2)
    assert (uc, rb, warps, 2 * nr * nj) == (24, 32, 12, 128)
    weights = 4 * 4 * uc * 384
    assert round(weights / 1e3) == 147 and smem - weights == 24 * 1024
    b64 = bwd_wide_shape(4, 384, 64, 2)
    assert (b64[0], b64[2], 2 * b64[1] * b64[3]) == (24, 16, 128)
    g = bwd_wide_shape(3, 256, 128, 2)
    assert (g[0], g[2], g[6], 2 * g[1] * g[3]) == (32, 16, 11, 128)
    assert g[-1] == 98304 + 12 * 1024
    # the exchange a step at the bench shape: each CTA writes its RB rows
    # of all H units and reads nj partials of its RB x Uc block
    assert round(rb * 384 * 4 / 1e3) == 49 and round(nj * rb * uc * 4 / 1e3) == 49
    assert round(2 * nr * nj * rb * 384 * 4 / 1e6, 1) == 6.3
    assert round(2 * nr * nj * rb * 4 * 384 * 4 / 1e6) == 25


# (gates, directions, batch sizes, the largest H the branch holds): the
# header's bounds on a 132-SM H100
BOUNDS = [(4, 2, (1, 8, 16), 872), (4, 2, (64,), 776), (4, 2, (128,), 528),
          (3, 2, (1, 8, 16, 64), 1056), (3, 2, (128,), 672),
          (4, 1, (1, 16), 1056), (3, 1, (1, 16), 1176)]


@pytest.mark.parametrize("gates,ndir,bs,bound", BOUNDS)
def test_the_bounds_are_the_shared_memory_arithmetic(gates, ndir, bs, bound):
    """Every H up to the bound holds (weights and dpre within 227 KB, the
    CTAs within the SMs, the warps within their cap) and the next does not;
    the header says so."""
    assert ("two directions: LSTM H <= 872 at B <= 16, 776 at B = 64, 528 "
            "at B = 128; GRU H <= 1056 at B <= 64, 672 at B = 128; with one "
            "direction LSTM H <= 1056, GRU H <= 1176 at B <= 16"
            ) in header_text()
    for b in bs:
        assert all(bwd_wide_shape(gates, h, b, ndir)
                   for h in range(1, bound + 1, 17))
        s = bwd_wide_shape(gates, bound, b, ndir)
        assert s[-1] <= SMEM and ndir * s[1] * s[3] <= SMS
        assert s[6] <= MAX_WARPS and s[2] <= 16 * MAX_MT
        assert bwd_wide_shape(gates, bound + 1, b, ndir) is None


def test_the_scratch_is_the_headers():
    """The exchange buffer holds two steps of every (owner, writer) block of
    RB x Uc partials, the flags one count per (direction, row block,
    writer); the entry points report them and take them in the grid's
    scratch slots."""
    text = (CSRC / "bwd_wide.cuh").read_text()
    assert ("return (size_t)2 * ndir * s.nr * s.nj * s.nj * s.rb * s.uc;"
            in text)
    assert "return (size_t)ndir * s.nr * s.nj;" in text
    uc, nj, rb, nr = bwd_wide_shape(4, 384, 128, 2)[:4]
    assert 2 * 2 * nr * nj * nj * rb * uc * 4 == 12582912  # 12.6 MB
    for mod, prefix in ((lstm_ops, "lstm_bidir_train"),
                        (gru_ops, "gru_bidir_train")):
        assert f"{prefix}_bwd_wide_scratch" in mod.LIBRARY.functions
        source = mod.LIBRARY.source.read_text()
        assert "return launch_bwd_wide<" in source
        assert "int " + prefix + "_bwd_wide_scratch(" in source
    assert BRANCHES[4] == "wide_fp32"
    assert "kBwdWide = 4" in (CSRC / "bwd_hoist.cuh").read_text()


# --- the launcher's rule -----------------------------------------------------

def fma_bwd_shape(h, gates):
    """bwd_hoist.cuh's ``fma_bwd_shape``: ``(cl, smem, ok)`` of the fp32
    cluster (16 rows, kFmaBwdLd 20, at most 384 threads)."""
    nq = -(-h // 4)
    for cl in (8, 16):
        uc = -(-(-(-h // cl)) // 4) * 4
        cl_eff = -(-h // uc)
        kp = -(-(gates * uc) // 16) * 16
        smem = (kp * 4 * nq + kp * 20 + cl_eff * 16 * uc) * 4
        if smem <= SMEM:
            break
    ksn = 8
    while ksn > 1 and nq * ksn > 384:
        ksn //= 2
    threads = -(-(nq * ksn) // 32) * 32
    return cl_eff, smem, smem <= SMEM and ksn >= 2 and 16 * (uc // 4) <= threads


def fp32_branch(cell, b, h, ndir):
    """The launcher's rule on fp32 streams: the fp32 cluster where all its
    16-row clusters surely fit at once (15 of 8 one-CTA-per-SM blocks, four
    of 16), else the wide branch where its shape holds (its CTAs, one an
    SM, are within the SMs), else the grid; None where only the card's
    cluster occupancy tells.  ``test_torch_bwd_cluster.py`` and
    ``test_torch_gru_bwd_fp32.py`` hold every fp32 ``HOIST_CASES`` entry to
    it."""
    gates = 4 if cell == "lstm" else 3
    cl, smem, ok = fma_bwd_shape(h, gates)
    clusters = ndir * -(-b // 16)
    if ok and clusters <= (15 if cl <= 8 else 4):
        return "cluster16_fp32"
    surely_not = not ok or (cl > 8 and clusters >= 8) or (
        smem > SMEM // 2 and clusters >= 16)
    if not surely_not:
        return None
    return "wide_fp32" if bwd_wide_shape(gates, h, b, ndir) else "grid"


FP32_CASES = [c for c in chip_smoke.HOIST_CASES if c[4] == "fp32"]


def test_the_card_cases_cover_the_wide_branch():
    """The bench shapes (LSTM B = 128 and 64, GRU B = 128), B = 100 and 130,
    T' = 1 and 200, one direction, each side of the bounds at B = 128 and
    B = 8 (where H outgrows the fp32 cluster); graph and NaN-fill cases;
    the timed shapes."""
    wide = {c[:6] for c in FP32_CASES if c[-1] == "wide_fp32"}
    for key in (("lstm", 80, 128, 384, "fp32", 2),
                ("lstm", 80, 64, 384, "fp32", 2),
                ("gru", 95, 128, 256, "fp32", 2),
                ("lstm", 12, 100, 384, "fp32", 2),
                ("lstm", 12, 130, 384, "fp32", 2),
                ("gru", 12, 130, 256, "fp32", 2),
                ("lstm", 1, 128, 384, "fp32", 2),
                ("lstm", 200, 128, 384, "fp32", 2),
                ("lstm", 12, 144, 384, "fp32", 1),
                ("gru", 12, 256, 256, "fp32", 1),
                ("lstm", 6, 128, 528, "fp32", 2),
                ("gru", 6, 128, 672, "fp32", 2),
                ("lstm", 4, 8, 872, "fp32", 2),
                ("lstm", 6, 8, 433, "fp32", 2),
                ("gru", 6, 8, 501, "fp32", 2)):
        assert key in wide, key
    grid = {c[:6] for c in FP32_CASES if c[-1] == "grid"}
    assert {("lstm", 6, 128, 529, "fp32", 2), ("gru", 6, 128, 673, "fp32", 2),
            ("lstm", 4, 8, 873, "fp32", 2)} <= grid
    graphs = {(c[0], c[2], c[-1]) for c in chip_smoke.GRAPH_CASES}
    assert {("lstm_bwd", 128, "wide_fp32"), ("lstm_bwd", 64, "wide_fp32"),
            ("gru_bwd", 128, "wide_fp32"), ("lstm_bwd", 128, "grid"),
            ("gru_bwd", 128, "grid")} <= graphs
    nan = {c[0] for c in chip_smoke.WIDE_NAN_CASES}
    assert {"lstm_bwd", "gru_bwd"} <= nan
    assert chip_smoke.WIDE_BWD_TIMES == [
        ("lstm", 80, 128, 384), ("lstm", 80, 64, 384), ("gru", 95, 128, 256)]


# --- the kernel's arithmetic -------------------------------------------------

def wide_bwd_product(dpre, w, gates, uc):
    """``dpre (ndir, B, G H) @ w^T`` (w = w_hh (ndir, H, G H)) as the kernel
    sums it: CTA j multiplies its gate columns ``q H + j Uc + u`` (zero past
    H), a k-step (8 columns) at a time in order, each k-step's three tf32
    products (lo_a hi_w, hi_a lo_w, hi_a hi_w, each an 8-term dot in fp32)
    added to its fp32 sum in that order; the nj partials then enter dh in
    writer order."""
    ndir, b, _ = dpre.shape
    h = w.shape[1]
    nj = -(-h // uc)
    zero = gates * h  # a zero column
    cols = torch.tensor([[q * h + j * uc + u if j * uc + u < h else zero
                          for q in range(gates) for u in range(uc)]
                         for j in range(nj)])  # (nj, G Uc)
    dpad = torch.cat([dpre, dpre.new_zeros(ndir, b, 1)], -1)[..., cols]
    wpad = torch.cat([w, w.new_zeros(ndir, h, 1)], -1)[..., cols]
    (a_hi, a_lo), (w_hi, w_lo) = split(dpad), split(wpad)
    nk = gates * uc // 8

    def steps(a, ww):  # (ndir, nj, nk, B, H): each k-step's 8-term products
        return torch.einsum("dbjks,dnjks->djkbn", a.view(ndir, b, nj, nk, 8),
                            ww.reshape(ndir, h, nj, nk, 8))

    terms = (steps(a_lo, w_hi), steps(a_hi, w_lo), steps(a_hi, w_hi))
    part = dpre.new_zeros(ndir, nj, b, h)  # every writer's, at once
    for kb in range(nk):
        for term in terms:
            part = part + term[:, :, kb]
    dh = dpre.new_zeros(ndir, b, h)
    for j in range(nj):
        dh = dh + part[:, j]
    return dh


def emulated_lstm_serial(planes, w_hh, dy, uc):
    """``lstm_bidir_train_bwd_serial_plain`` (fp32) with its contraction
    summed as ``wide_bwd_product``."""
    ndir, t_len, _, b, h = planes.shape
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
        dh = wide_bwd_product(dpre, w_hh, 4, uc)
        dc = dct * f
    return dgx


def emulated_gru_serial(planes, w_hh, dy, uc):
    """``gru_bidir_train_bwd_serial_plain`` (fp32) with its contraction over
    ``[dpre_r, dpre_z, dhh_n]`` summed as ``wide_bwd_product`` and ``dh_t
    Z`` added after the sum: ``(dgx, dhhn)``."""
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
        dh = wide_bwd_product(torch.cat([dpre[..., :2 * h], dhh_n], dim=-1),
                              w_hh, 3, uc)
        carry = dh_t * z
    return dgx, dhhn


def chain_inputs(t, b, h, gates, seed):
    rng = np.random.RandomState(seed)
    gx = rng.randn(t, b, 2 * gates * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, gates * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)
    return gx, w_hh, dy


def test_the_emulation_is_the_twins_function_at_a_small_width():
    """At a small width (H % 8 != 0, so the last CTA's columns pad with
    zeros) the emulated sums are the serial twins' function, fp32 rounding
    and the split's 2^-21 apart: the emulation itself is right."""
    gx, w_hh, dy = (torch.from_numpy(a) for a in chain_inputs(5, 3, 13, 4, 3))
    planes = lstm_ops.lstm_bidir_train_bwd_prepass_plain(
        gx, w_hh, *lstm_ops.lstm_bidir_train_plain(gx, w_hh))
    want = lstm_ops.lstm_bidir_train_bwd_serial_plain(planes, w_hh, dy)
    assert (emulated_lstm_serial(planes, w_hh, dy, 8) - want).abs().max() <= 1e-5
    gx, w_hh, dy = (torch.from_numpy(a) for a in chain_inputs(5, 3, 13, 3, 4))
    planes = gru_ops.gru_bidir_train_bwd_prepass_plain(
        gx, w_hh, gru_eval_ops.gru_bidir_plain(gx, w_hh))
    want = gru_ops.gru_bidir_train_bwd_serial_plain(planes, w_hh, dy)
    for got, ref in zip(emulated_gru_serial(planes, w_hh, dy, 8), want):
        assert (got - ref).abs().max() <= 1e-5


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_the_3xtf32_chain_holds_the_twin_and_the_pallas_vjp(cell):
    """A whole backward chain at full width and B = 64 (the wide branch's
    shape there: the LSTM's Uc = 24, RB = 16), 20 steps, two directions:
    the emulated kernel within 1e-4 of the serial twin and of the VJP of the
    JAX package's training scan in interpret mode, in dgx."""
    t, b = 20, 64
    gates, h, scan = (4, 384, lstm_scan_train_v2) if cell == "lstm" else (
        3, 256, gru_scan_train_v2)
    shape = bwd_wide_shape(gates, h, b, 2)
    assert cell == "gru" or shape[:3:2] == (24, 16)
    gx, w_hh, dy = chain_inputs(t, b, h, gates, seed=17 + gates)

    def jax_loss(g):
        return jnp.sum(scan(g, jnp.asarray(w_hh), 1, True)[1:t + 1] * dy)

    pallas = np.asarray(jax.grad(jax_loss)(jnp.asarray(gx)), np.float32)
    tg, tw, td = (torch.from_numpy(a) for a in (gx, w_hh, dy))
    if cell == "lstm":
        planes = lstm_ops.lstm_bidir_train_bwd_prepass_plain(
            tg, tw, *lstm_ops.lstm_bidir_train_plain(tg, tw))
        got = emulated_lstm_serial(planes, tw, td, shape[0])
        twin = lstm_ops.lstm_bidir_train_bwd_serial_plain(planes, tw, td)
    else:
        planes = gru_ops.gru_bidir_train_bwd_prepass_plain(
            tg, tw, gru_eval_ops.gru_bidir_plain(tg, tw))
        got, dhhn = emulated_gru_serial(planes, tw, td, shape[0])
        twin, twin_dhhn = gru_ops.gru_bidir_train_bwd_serial_plain(planes, tw, td)
        assert (dhhn - twin_dhhn).abs().max().item() <= TOL
    assert torch.isfinite(got).all()
    assert (got - twin).abs().max().item() <= TOL
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL)
