"""The tanh cell's fp32 forward and backward on the wide branch
(``fwd_wide_kernel<TanhCell>`` and ``<TanhBwdCell>`` in
``csrc/fwd_wide.cuh``, branch ``wide_fp32``): the header's one-gate shape
and bounds through the Python mirror of its shape rule
(``test_torch_wide_fwd.wide_shape``), the scratch the tanh entries take, a
model of the launcher's one-gate rule (``csrc/fwd_cluster.cuh:fwd_branch``:
the fp32 cluster ``fma1_kernel`` where all its clusters fit, else the wide
branch where its shape holds, else the grid) for every
``chip_smoke.RNN_CASES`` entry, and an emulation of the kernel's arithmetic
-- both operands split into tf32 hi (round to nearest on the mantissa) and
lo = x - hi, which the tensor core reads truncated to tf32, ``lo hi_w + hi
lo_w + hi hi_w`` summed in fp32 a k-step at a time in order, the k splits
added in order (``test_torch_wide_fwd.wide_product``; the staging of h
moves no sum) -- through a whole tanh forward and a whole tanh backward at
full width (T' = 20, B = 64, H = 384), held against the plain twins and
against the JAX package's ``rnn_bidir_v2`` and ``rnn_scan_v2``'s VJP in
interpret mode.  Nothing here launches a kernel; the kernel is held against
the twins on the card (``chip_smoke.RNN_CASES``,
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

from ctc_pytorch_tpu.ops.rnn_pallas_v2 import rnn_bidir_v2, rnn_scan_v2
from ctc_pytorch_tpu_torch.ops import rnn_bidir as rnn_ops
from ctc_pytorch_tpu_torch.ops import rnn_bidir_train as train_ops
from ctc_pytorch_tpu_torch.ops._build import (
    CSRC,
    FWD_BRANCHES,
    step_times,
    wide_scratch_sizes,
)
from test_torch_rnn_cluster import fma1_cluster, mma1_holds
from test_torch_wide_fwd import SMEM, SMS, clusters_fit, wide_product, wide_shape

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  the card's cases

TOL = 1e-4


def header_text(name="fwd_wide.cuh"):
    return " ".join(w for w in (CSRC / name).read_text().split() if w != "//")


def test_the_bench_shape_is_the_headers():
    """At (B = 128, H = 384, two directions) the one-gate shape is Uc = 48,
    RB = 16, KS = 2: 128 CTAs of 12 warps, 74 KB of weights, 12 KB of
    partials and 48 KB of staged h (two steps of 16 rows); a CTA's step is
    0.9 M MACs, a quarter of the LSTM's; its unit blocks would read 147 KB
    of h a step from L2, 18.9 MB over the card, where the staging reads
    24.6 KB, 3.1 MB."""
    text = header_text()
    for want in ("Uc = 48, RB = 16, KS = 2, 128 CTAs of 12 warps, 74 KB of "
                 "weights + 12 KB of partials + 48 KB of staged h",
                 "48 times a step at H = 384 (18.9 MB at the tanh bench "
                 "shape, 147 KB a CTA)",
                 "24.6 KB a CTA a step, 3.1 MB over the card",
                 "(B = 128 at H past 552, B <= 16 past 1056)",
                 "16 rows x 48 columns x 384 x 3 = 0.9 M MACs a CTA, a "
                 "quarter of the LSTM's",
                 "6.04 GFLOP a launch, 0.090 ms of fp32 FMA (its three TF32 "
                 "passes 0.037 ms at 495 TFLOP/s)"):
        assert want in text, want
    uc, nj, rb, nr, ks, warps, nks, smem = wide_shape(1, 384, 128, 2)
    assert (uc, rb, ks, warps, 2 * nr * nj) == (48, 16, 2, 12, 128)
    weights = 4 * uc * 8 * nks
    assert round(weights / 1e3) == 74
    assert smem - weights == 12 * 1024 + 48 * 1024 == 12 * 1024 + 2 * rb * 384 * 4
    ctas, per_cta = 2 * nr * nj, rb * 384 * 4
    assert round(per_cta * uc // 8 / 1e3) == 147
    assert round(ctas * per_cta * uc // 8 / 1e6, 1) == 18.9
    assert round(per_cta / 1e3, 1) == 24.6
    assert round(ctas * per_cta / 1e6, 1) == 3.1
    assert round(rb * uc * 384 * 3 / 1e6, 1) == 0.9
    assert round(16 * 48 * 384 * 3 / (32 * 96 * 384 * 3), 2) == 0.25
    flop = 2 * 2 * 80 * 128 * 384 * 384
    assert round(flop / 1e9, 2) == 6.04
    assert round(flop / 67e12 * 1e3, 3) == 0.090
    assert round(3 * flop / 495e12 * 1e3, 3) == 0.037


# (directions, batch sizes, the largest H the branch holds): the header's
# one-gate bounds on a 132-SM H100
BOUNDS = [(2, (1, 4, 8, 16), 1752), (2, (64,), 1584), (2, (128,), 792),
          (1, (1, 4, 16), 2288)]


@pytest.mark.parametrize("ndir,bs,bound", BOUNDS)
def test_the_one_gate_bounds_are_the_shared_memory_arithmetic(ndir, bs, bound):
    """Every H up to the bound has a shape (weights and partial sums within
    227 KB, the CTAs within the SMs) and the next has none; the header
    says so."""
    assert ("its bound (chosen without the staging, which is taken where it "
            "fits) with two directions H <= 1752 at B <= 16, 1584 at B = 64, "
            "792 at B = 128, with one direction H <= 2288 at B <= 16"
            ) in header_text()
    for b in bs:
        assert all(wide_shape(1, h, b, ndir) for h in range(1, bound + 1, 37))
        s = wide_shape(1, bound, b, ndir)
        assert s is not None and s[-1] <= SMEM and ndir * s[1] * s[3] <= SMS
        assert wide_shape(1, bound + 1, b, ndir) is None


def staged(h, b, ndir):
    """Whether the one-gate shape stages h (its smem holds more than the
    weights and partials)."""
    uc, nj, rb, nr, ks, warps, nks, smem = wide_shape(1, h, b, ndir)
    base = 4 * uc * 8 * nks + (1024 * warps if ks > 1 else 0)
    return smem > base


def test_the_staging_limits_are_the_headers():
    """The staging fits to H = 552 at B = 128 and to 1056 at B <= 16 (two
    directions), not at 1064 nor at the bounds; the card's cases take the
    wide branch both staged and not."""
    assert staged(384, 128, 2) and staged(552, 128, 2)
    assert not staged(560, 128, 2) and not staged(792, 128, 2)
    for b in (1, 4, 16):
        assert staged(1056, b, 2) and not staged(1064, b, 2)
        assert not staged(1752, b, 2)
    wide = [c for c in chip_smoke.RNN_CASES if c[6] == "wide_fp32"]
    assert {staged(c[3], c[2], c[5]) for c in wide} == {True, False}


def test_the_tanh_entries_take_the_wide_scratch():
    """Both tanh entries launch the wide kernel with their cell, take its
    exchange buffer and flags in the grid's scratch slots (one more pointer
    than before: the forward's ``flags``, the backward's too), and the
    wrappers size them with ``wide_scratch_sizes``, the header's
    ``wide_hx_floats`` and ``wide_flag_ints``."""
    fwd = (CSRC / "rnn_bidir.cu").read_text()
    bwd = (CSRC / "rnn_bidir_train.cu").read_text()
    assert "launch_fwd_wide<TanhCell, float, true>(" in fwd
    assert "launch_fwd_wide<TanhBwdCell, float, true>(" in bwd
    assert "void* hbuf,\n                      void* flags, int T" in fwd
    assert "void* dgx, void* dpbuf, void* flags, int T" in bwd
    assert rnn_ops.LIBRARY.functions["rnn_bidir_forward"][0][:6] == [
        rnn_ops._VP] * 5 + [rnn_ops._CI]
    assert train_ops.LIBRARY.functions["rnn_bidir_train_backward"][0][:7] == [
        train_ops._VP] * 6 + [train_ops._CI]
    assert "wide_scratch_sizes(b, h, ndir)" in Path(
        train_ops.__file__).read_text()
    assert wide_scratch_sizes(128, 384, 2) == (2 * 2 * 128 * 384, 2 * 8 * 48)
    assert wide_scratch_sizes(130, 384, 2) == (2 * 2 * 144 * 384, 2 * 9 * 48)
    assert FWD_BRANCHES.index("wide_fp32") == 4
    # the wide arm is asked after either fp32 cluster arm, the parent forms
    # keep the grid
    text = (CSRC / "fwd_cluster.cuh").read_text()
    arm = text[text.index("fma1_kernel_for<Cell>(ksn), f.cl"):]
    assert arm.index("if (taken == kFwdGrid && !kParentBranches) {") < arm.index(
        "known[key] = taken;")


# --- the launcher's rule -----------------------------------------------------

def one_gate_branches(b, h, dtype, ndir):
    """The branches that ``fwd_branch``'s rule for the tanh cell (forward and
    backward alike) can give: one where the rule is certain, several where
    only the card's cluster occupancy tells them apart.  bf16 streams: the
    16-row mma cluster where its clusters fit, else the 32-row one, else
    the grid.  fp32 streams: ``fma1_kernel``'s 16-row clusters where they
    all fit (at most 256 threads for their items), else the wide branch
    where its shape holds, else the grid."""
    if dtype == "bf16":
        if not mma1_holds(h, 16):
            return {"grid"}
        return {"cluster16", "cluster32", "grid"}
    cl = fma1_cluster(h)
    fit = False
    if cl is not None:
        uc = -(-(-(-h // cl)) // 4) * 4
        if uc // 4 * ((min(b, 16) + 3) // 4) <= 256:
            smem = 4 * h * uc + 2 * h * 16 * 4
            fit = clusters_fit(-(-h // uc), ndir * -(-b // 16), smem)
    if fit is None:
        return {"cluster16_fp32", "wide_fp32", "grid"}
    if fit:
        return {"cluster16_fp32"}
    return {"wide_fp32" if wide_shape(1, h, b, ndir) else "grid"}


@pytest.mark.parametrize("case", chip_smoke.RNN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_each_tanh_card_case_names_its_branch(case):
    """The branch an RNN_CASES entry expects is the rule's: the one branch
    on fp32 streams, and on bf16 streams one of those the rule allows (the
    wide branch never takes bf16 streams)."""
    kernel, t, b, h, dtype, ndir, branch, scale = case
    got = one_gate_branches(b, h, dtype, ndir)
    if dtype == "fp32":
        assert got == {branch}, (case, got)
    else:
        assert branch in got and branch != "wide_fp32", (case, got)


def test_the_card_cases_cover_the_wide_branch():
    """The bench shape forward and backward, B = 130 and 200 (not multiples
    of 16), T' = 200, the saturated gates, T = 1, one direction, each side
    of the bound at B = 128 and B = 4; B = 64 and 100 on the fp32 cluster;
    the grid's resident and L2 forms on bf16 streams; graph, NaN-fill and
    timed cases."""
    cases = {c[:6] + (c[7],): c[6] for c in chip_smoke.RNN_CASES}
    for kernel in ("fwd", "bwd"):
        for key, want in (
                ((80, 128, 384, "fp32", 2, 1.0), "wide_fp32"),
                ((80, 128, 384, "fp32", 2, 8.0), "wide_fp32"),
                ((12, 130, 384, "fp32", 2, 1.0), "wide_fp32"),
                ((12, 200, 384, "fp32", 2, 1.0), "wide_fp32"),
                ((200, 128, 384, "fp32", 2, 1.0), "wide_fp32"),
                ((1, 128, 384, "fp32", 2, 1.0), "wide_fp32"),
                ((12, 256, 384, "fp32", 1, 1.0), "wide_fp32"),
                ((4, 128, 792, "fp32", 2, 1.0), "wide_fp32"),
                ((4, 128, 793, "fp32", 2, 1.0), "grid"),
                ((4, 4, 1752, "fp32", 2, 1.0), "wide_fp32"),
                ((4, 4, 1753, "fp32", 2, 1.0), "grid"),
                ((4, 4, 2288, "fp32", 1, 1.0), "wide_fp32"),
                ((4, 4, 2289, "fp32", 1, 1.0), "grid"),
                ((80, 64, 384, "fp32", 2, 1.0), "cluster16_fp32"),
                ((80, 100, 384, "fp32", 2, 1.0), "cluster16_fp32"),
                ((4, 4, 1056, "bf16", 2, 1.0), "grid"),
                ((4, 4, 1064, "bf16", 2, 1.0), "grid"),
                ((4, 4, 1568, "bf16", 1, 1.0), "grid"),
                ((4, 4, 1576, "bf16", 1, 1.0), "grid")):
            t, b, h, dtype, ndir, scale = key
            assert cases.get((kernel, t, b, h, dtype, ndir, scale)) == want, (
                kernel, key)
    graphs = {c[0] + ":" + c[-1] for c in chip_smoke.GRAPH_CASES
              if c[0].startswith("rnn") and c[4] == "fp32" and c[2] == 128}
    assert graphs == {"rnn_train:wide_fp32", "rnn_bwd:wide_fp32",
                      "rnn_train:grid", "rnn_bwd:grid"}
    nan = {c[:3] for c in chip_smoke.WIDE_NAN_CASES}
    assert {("rnn", 80, 128), ("rnn", 80, 130), ("rnn_bwd", 80, 128),
            ("rnn_bwd", 80, 130)} <= nan
    assert {("rnn", 80, 128, 384, "fp32"),
            ("rnn_bwd", 80, 128, 384, "fp32")} <= set(chip_smoke.WIDE_TIMES)


# --- the kernel's arithmetic -------------------------------------------------

def emulated_tanh(gx, w_hh, ks):
    """``rnn_bidir_plain`` (fp32 streams) with the recurrent product summed
    as the wide kernel sums it (``wide_product``)."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    hs = torch.zeros(ndir, b, h)
    ys = torch.empty(t_len, b, ndir * h)
    for s in range(t_len):
        times = step_times(t_len, ndir, s)
        pre = torch.stack([gx[t, :, d * h:(d + 1) * h]
                           for d, t in enumerate(times)])
        hs = torch.tanh(pre + wide_product(hs, w_hh, ks))
        for d, t in enumerate(times):
            ys[t, :, d * h:(d + 1) * h] = hs[d]
    return ys


def emulated_tanh_backward(w_hh, ys, dy, ks):
    """``rnn_bidir_train_backward_plain`` (fp32 streams) with dh = dpre @
    w_hh^T summed as the wide kernel sums it: its resident columns are the
    rows of w_hh, so the product is ``wide_product`` over w_hh^T."""
    t_len, b, _ = ys.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    wt = w_hh.transpose(1, 2).contiguous()
    dh = torch.zeros(ndir, b, h)
    dgx = torch.empty_like(ys)
    for s in range(t_len):
        times = step_times(t_len, ndir, t_len - 1 - s)

        def at(plane):
            return torch.stack([plane[t, :, d * h:(d + 1) * h]
                                for d, t in enumerate(times)])

        y = at(ys)
        dpre = (at(dy) + dh) * (1.0 - y * y)
        for d, t in enumerate(times):
            dgx[t, :, d * h:(d + 1) * h] = dpre[d]
        dh = wide_product(dpre, wt, ks)
    return dgx


def inputs(t, b, h, seed):
    rng = np.random.RandomState(seed)
    gx = rng.randn(t, b, 2 * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    dy = rng.randn(t, b, 2 * h).astype(np.float32)
    return torch.from_numpy(gx), torch.from_numpy(w_hh), torch.from_numpy(dy)


def test_the_emulation_is_the_twins_function_at_a_small_width():
    gx, w_hh, dy = inputs(5, 6, 13, seed=3)
    ys = rnn_ops.rnn_bidir_plain(gx, w_hh)
    want = train_ops.rnn_bidir_train_backward_plain(w_hh, ys, dy)
    for ks in (1, 2):
        assert (emulated_tanh(gx, w_hh, ks) - ys).abs().max().item() <= 1e-5
        assert (emulated_tanh_backward(w_hh, ys, dy, ks)
                - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_the_3xtf32_product_holds_the_twins_and_pallas(kernel):
    """A whole tanh forward or backward at full width and B = 64, 20 steps,
    two directions, with the k splits of the wide shape there (Uc = 24, RB
    = 16, KS = 4) and of the bench shape (KS = 2): the emulated kernel
    within 1e-4 of the plain twin and of the JAX package's Pallas forward
    (``rnn_bidir_v2``) or ``rnn_scan_v2``'s VJP (its ``_bwd_pallas``, given
    the Pallas forward's ys) in interpret mode."""
    t, b, h = 20, 64, 384
    shape = wide_shape(1, h, b, 2)
    assert shape[:5:2] == (24, 16, 4)
    gx, w_hh, dy = inputs(t, b, h, seed=19)
    jw = jnp.asarray(w_hh.numpy())
    if kernel == "fwd":
        twin = rnn_ops.rnn_bidir_plain(gx, w_hh)
        eye = np.eye(2 * h, dtype=np.float32)
        w_ih = np.stack([eye[:, :h], eye[:, h:]])
        pallas = np.asarray(rnn_bidir_v2(
            jnp.asarray(gx.numpy()), jnp.asarray(w_ih), jw, chunk=1,
            interpret=True, compute_dtype=jnp.float32, train=False),
            np.float32)
        runs = [emulated_tanh(gx, w_hh, ks) for ks in (shape[4], 2)]
    else:
        ys, vjp = jax.vjp(lambda g: rnn_scan_v2(g, jw, 1, True)[1:t + 1],
                          jnp.asarray(gx.numpy()))
        (pallas,) = vjp(jnp.asarray(dy.numpy()))
        pallas = np.asarray(pallas, np.float32)
        ys = torch.from_numpy(np.array(ys, np.float32))
        twin = train_ops.rnn_bidir_train_backward_plain(w_hh, ys, dy)
        runs = [emulated_tanh_backward(w_hh, ys, dy, ks)
                for ks in (shape[4], 2)]
    for got in runs:
        assert torch.isfinite(got).all()
        assert (got - twin).abs().max().item() <= TOL
        np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL)
