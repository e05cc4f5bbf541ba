"""The wide-batch fp32-product forward (``fwd_wide_kernel`` in
``csrc/fwd_wide.cuh``, branch ``wide_fp32``): the header's resident bounds
against the shared-memory arithmetic, the branch that every
``chip_smoke.FWD_CASES`` entry expects under a model of the launcher's rule
(``csrc/fwd_cluster.cuh:fwd_branch``), and an emulation of the kernel's
arithmetic -- each operand split into tf32 hi by round to nearest on the
mantissa and lo = x - hi, which the tensor core reads truncated to tf32,
``lo_h hi_w + hi_h lo_w + hi_h hi_w`` summed in fp32 a
k-step at a time in the kernel's fixed order, the k splits added in order
-- through whole LSTM and GRU recurrences at full width (B = 64, H = 384,
T = 20), held against the plain twins and against the JAX package's Pallas
forwards in interpret mode.  Nothing here launches a kernel; the kernel is
held against the twins on the card (``chip_smoke.FWD_CASES``,
``tests/test_torch_cuda.py``).

Tolerance: 1e-4 abs, the card's fp32 tolerance (``PERF.md`` §2); a single
TF32 pass would not hold it, 3xTF32 keeps the products' error near 2^-21."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.gru_pallas_v2 import gru_bidir_v2
from ctc_pytorch_tpu.ops.lstm_pallas_v2 import lstm_bidir_pallas_v2
from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
from ctc_pytorch_tpu_torch.ops._build import (
    CSRC,
    FWD_BRANCHES,
    step_times,
    wide_scratch_sizes,
)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  the card's cases

SMEM = 232448  # an H100 CTA's shared memory, opt-in
SMS = 132      # an H100 SXM's SMs
MAX_WARPS = 12  # kWideMaxWarps
TOL = 1e-4


def wide_shape(gates, h, b, ndir, sms=SMS, wbytes=4):
    """Python mirror of the header's ``wide_shape``: ``(uc, nj, rb, nr, ks,
    warps, nks, smem)`` or None where no shape holds, for resident weights
    of ``wbytes`` bytes (4: fp32 products, 2: the bf16 form); the one-gate
    cell's smem includes its staged h (two steps of RB rows) where that
    fits."""
    nks = -(-h // 8)
    bp = -(-b // 16) * 16
    best, best_work = None, None
    for uc in range(8, 8 * nks + 1, 8):
        nj = -(-h // uc)
        for rb in range(16, bp + 1, 16):
            nr = -(-b // rb)
            if ndir * nr * nj > sms:
                continue
            groups = rb // 16 * (uc // 8)
            if groups > MAX_WARPS:
                break
            ks = 1
            while (ks < 4 and groups * ks < 8
                   and groups * ks * 2 <= MAX_WARPS and ks * 2 <= nks):
                ks *= 2
            smem = (wbytes * gates * uc * 8 * nks
                    + 1024 * gates * (ks if ks > 1 else 0) * groups)
            if smem > SMEM:
                continue
            work = rb * uc
            if best is None or work < best_work or (
                    work == best_work and uc > best[0]):
                best = (uc, nj, rb, nr, ks, groups * ks, nks, smem)
                best_work = work
            break
    if gates == 1 and best is not None:
        staged = 2 * best[2] * 8 * nks * 4
        if best[-1] + staged <= SMEM:
            best = best[:-1] + (best[-1] + staged,)
    return best


def header_text():
    return " ".join(w for w in (CSRC / "fwd_wide.cuh").read_text().split()
                    if w != "//")


def test_the_bench_shapes_are_the_headers():
    text = header_text()
    for want in ("Uc = 24, RB = 32, KS = 2: 128 CTAs of 12 warps, 147 KB of "
                 "weights + 48 KB of partials",
                 "B = 64: RB = 16, KS = 4, 128 CTAs",
                 "Uc = 32, RB = 16, KS = 2, 128 CTAs of 8 warps, 98 KB + 24 KB",
                 "32 rows x 96 columns x 384 x 3 = 3.5 M MACs",
                 "a CTA reads 49 KB of h a step (6.3 MB over the card, not "
                 "25 MB)"):
        assert want in text, want
    uc, nj, rb, nr, ks, warps, nks, smem = wide_shape(4, 384, 128, 2)
    assert (uc, rb, ks, warps, 2 * nr * nj) == (24, 32, 2, 12, 128)
    assert round(4 * 4 * uc * 8 * nks / 1e3) == 147
    assert smem - 4 * 4 * uc * 8 * nks == 48 * 1024  # the partials
    assert wide_shape(4, 384, 64, 2)[2:6] == (16, 4, 4, 12)
    assert 2 * wide_shape(4, 384, 64, 2)[3] * wide_shape(4, 384, 64, 2)[1] == 128
    g = wide_shape(3, 256, 128, 2)
    assert (g[0], g[2], g[4], g[5], 2 * g[3] * g[1]) == (32, 16, 2, 8, 128)
    assert round(4 * 3 * 32 * 256 / 1e3) == 98 and g[-1] - 98304 == 24 * 1024
    assert round(rb * 4 * uc * 384 * 3 / 1e6, 1) == 3.5
    assert round(rb * 384 * 4 / 1e3) == 49
    assert round(2 * nr * nj * rb * 384 * 4 / 1e6, 1) == 6.3
    assert round(2 * 64 * 128 * 384 * 4 / 1e6) == 25


# (gates, directions, batch sizes, the largest H the branch holds): the
# header's bounds on a 132-SM H100
BOUNDS = [(4, 2, (1, 16), 776), (4, 2, (64,), 904), (4, 2, (128,), 600),
          (3, 2, (1, 16, 64), 1056), (3, 2, (128,), 792),
          (4, 1, (1, 16, 64, 128), 1056), (3, 1, (1, 16), 1080)]


@pytest.mark.parametrize("gates,ndir,bs,bound", BOUNDS)
def test_the_bounds_are_the_shared_memory_arithmetic(gates, ndir, bs, bound):
    """Every H up to the bound holds (weights and partial sums within 227
    KB, the CTAs within the SMs) and the next does not; the header says
    so."""
    text = header_text()
    assert ("two directions: LSTM H <= 776 at B <= 16, 904 at B = 64, 600 at "
            "B = 128; GRU H <= 1056 at B <= 64, 792 at B = 128; with one "
            "direction LSTM H <= 1056, GRU H <= 1080 at B <= 16") in text
    for b in bs:
        assert all(wide_shape(gates, h, b, ndir)
                   for h in range(1, bound + 1, 23))
        s = wide_shape(gates, bound, b, ndir)
        assert s is not None and s[-1] <= SMEM and ndir * s[1] * s[3] <= SMS
        assert wide_shape(gates, bound + 1, b, ndir) is None


# the bf16 form's bounds, its weights 2 bytes each: (gates, directions,
# batch sizes, the largest H the branch holds) on a 132-SM H100
BOUNDS_BF16 = [(4, 2, (1, 16), 1056), (4, 2, (64,), 1208), (4, 2, (128,), 792),
               (3, 2, (1, 16), 1352), (3, 2, (64,), 1584), (3, 2, (128,), 792),
               (4, 1, (1, 16), 1560), (3, 1, (1, 16), 2112)]


@pytest.mark.parametrize("gates,ndir,bs,bound", BOUNDS_BF16)
def test_the_bf16_bounds_are_the_shared_memory_arithmetic(gates, ndir, bs,
                                                          bound):
    """The same search with bf16 weights (``wide_shape``'s ``wbytes`` = 2):
    every H up to the bound holds and the next does not; the header says
    so."""
    assert ("Bound (two directions): LSTM H <= 1056 at B <= 16, 1208 at B = "
            "64, 792 at B = 128; GRU H <= 1352 at B <= 16, 1584 at B = 64, 792 "
            "at B = 128; with one direction LSTM H <= 1560, GRU H <= 2112 at B "
            "<= 16.") in header_text()
    for b in bs:
        assert all(wide_shape(gates, h, b, ndir, wbytes=2)
                   for h in range(1, bound + 1, 23))
        s = wide_shape(gates, bound, b, ndir, wbytes=2)
        assert s is not None and s[-1] <= SMEM and ndir * s[1] * s[3] <= SMS
        assert wide_shape(gates, bound + 1, b, ndir, wbytes=2) is None


def test_the_ds2_shape_is_the_headers():
    """DeepSpeech2's training forward (B = 64, H = 1024, two directions) on
    the bf16 form: Uc = 16, 64 unit blocks, RB = 64, one row block, KS = 1,
    8 warps and 131,072 bytes of weights, 128 CTAs; the fp32 form holds no
    shape there.  A step moves 16 rows x 1024 bf16 into each warp, 32 MiB
    over the card; the exchange buffer rounds H up to 16, the flags stay
    one an 8-unit block."""
    text = header_text()
    assert ("Uc = 16, RB = 64, KS = 1, 64 unit blocks x 1 row block x 2 "
            "directions = 128 CTAs of 8 warps, 131,072 bytes of weights a "
            "CTA") in text
    assert "16 rows x 1024 x 2 bytes of h into each warp, 32 MiB over the card" in text
    uc, nj, rb, nr, ks, warps, nks, smem = wide_shape(4, 1024, 64, 2, wbytes=2)
    assert (uc, nj, rb, nr, ks, warps, smem) == (16, 64, 64, 1, 1, 8, 131072)
    assert 2 * nr * nj == 128 <= SMS
    assert 2 * nj * nr * warps * 16 * 1024 * 2 == 32 * 2 ** 20
    assert wide_shape(4, 1024, 64, 2) is None
    code = (CSRC / "fwd_wide.cuh").read_text()
    assert ("return (size_t)2 * ndir * ((B + 15) / 16 * 16) * ((H + 15) / 16 * "
            "16);") in code
    assert wide_scratch_sizes(64, 1024, 2, True) == (2 * 2 * 64 * 1024,
                                                    2 * 4 * 128)
    assert wide_scratch_sizes(100, 1208, 2, True) == (2 * 2 * 112 * 1216,
                                                     2 * 7 * 151)
    assert FWD_BRANCHES.index("wide_bf16") == 5
    assert "kFwdWideBf16 = 5" in (CSRC / "fwd_cluster.cuh").read_text()


def test_the_scratch_is_the_headers():
    """The wrapper's exchange buffer and flags (``wide_scratch_sizes``) are
    the header's ``wide_hx_floats`` and ``wide_flag_ints``: two steps of h,
    B and H rounded up to 16 and 8, a flag per (direction, 16 rows, 8
    units)."""
    text = (CSRC / "fwd_wide.cuh").read_text()
    assert "return (size_t)2 * ndir * ((B + 15) / 16 * 16) * ((H + 7) / 8 * 8);" in text
    assert "return (size_t)ndir * ((B + 15) / 16) * ((H + 7) / 8);" in text
    assert wide_scratch_sizes(128, 384, 2) == (2 * 2 * 128 * 384, 2 * 8 * 48)
    assert wide_scratch_sizes(100, 37, 1) == (2 * 112 * 40, 7 * 5)
    assert FWD_BRANCHES[4] == "wide_fp32"


def test_the_parent_forms_are_the_same_sources_with_one_define(monkeypatch):
    """The grid that phases 9 and 16 time beside the wide branches (the
    tanh cell's too) and the GRU's fp32 cluster is the same sources built
    with ``-DPARENT_BRANCHES``
    (``tools/parent_forms.py``): only those launchers read the define, the
    package's flags never set it, a parent library builds to a path of its
    own, and the block that routes the ops through the parents restores
    them."""
    from ctc_pytorch_tpu_torch.ops import _build
    from tools.parent_forms import DEFINE, libraries, parent_forms

    assert DEFINE == "-DPARENT_BRANCHES"
    assert not any("PARENT" in f for f in _build.NVCC_FLAGS)
    hoist = (CSRC / "bwd_hoist.cuh").read_text()
    assert "#ifdef PARENT_BRANCHES" in hoist
    assert ("if (kParentBranches && !bf16 && std::is_same<Cell, GruCell>::value)"
            in hoist)
    assert ("if (taken == kFwdGrid && !kParentBranches) {"
            in (CSRC / "fwd_cluster.cuh").read_text())
    for path in CSRC.glob("*.cu*"):
        text = path.read_text()
        assert "#define PARENT_BRANCHES" not in text, path
        assert ("kParentBranches" in text) == (path.name in (
            "bwd_hoist.cuh", "fwd_cluster.cuh")), path
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    from ctc_pytorch_tpu_torch.ops import (gru_bidir_train,
                                           lstm_bidir_train, rnn_bidir,
                                           rnn_bidir_train)
    mods = (lstm_ops, lstm_bidir_train, gru_ops, gru_bidir_train, rnn_bidir,
            rnn_bidir_train)
    saved = [m.LIBRARY for m in mods]
    for parent, mod in zip(libraries(), mods):
        lib = mod.LIBRARY
        assert (parent.source, parent.headers, parent.functions) == (
            lib.source, lib.headers, lib.functions)
        assert parent.output_path() != lib.output_path()
        assert parent.output_path().parent == lib.output_path().parent
        out = parent.output_path()
        assert parent.build_command(out) == [
            "nvcc", DEFINE, *lib.build_command(out)[1:]]
    with parent_forms():
        assert [m.LIBRARY for m in mods] == libraries()
    assert [m.LIBRARY for m in mods] == saved


# --- the launcher's rule -----------------------------------------------------

def fma_shape(h):
    """fwd_cluster.cuh's ``fma_shape``: ``(CL, smem)`` of the fp32 cluster, or
    None where neither 8 nor 16 CTAs hold it (or a CTA would need more than
    256 threads for its 4 Uc items)."""
    for cl in (8, 16):
        uc = -(-h // cl)
        smem = h * uc * 16 + 2 * h * 16 * 4
        if smem <= SMEM:
            return (-(-h // uc), smem) if 4 * uc <= 256 else None
    return None


def mma_shape(gates, h, km):
    """fwd_cluster.cuh's ``mma_shape``: ``(uc, CL, smem)``."""
    uc = -(-(-(-h // 8)) // 8) * 8
    ldk = -(-h // 16) * 16 + 8
    return uc, -(-h // uc), (gates * uc + 2 * 16 * km) * ldk * 2


def clusters_fit(cl, clusters, smem):
    """Whether ``clusters`` clusters of ``cl`` CTAs fit on the card at once,
    or None where only the card's occupancy query can tell.  Measured on
    the H100 (``PERF.md``): at one CTA an SM it holds 15 clusters of 8 and
    fewer than 8 of 16 (the B = 64 eval forward's 8 took the grid before
    this branch), and surely four of 16."""
    if clusters <= 4 or (cl <= 8 and clusters <= 15):
        return True
    one_an_sm = smem > SMEM // 2
    if cl > 8 and clusters >= 8:
        return False
    if one_an_sm and 7 <= cl <= 8 and clusters >= 16:
        return False
    return None


def fwd_branches(kernel, b, h, dtype, ndir):
    """The branches the launcher's rule can give a FWD_CASES entry: one,
    where the rule is certain (always for fp32 products), or those that
    only the card's cluster occupancy tells apart.  Where bf16 products find
    no cluster the wide branch's bf16 form takes them up to its bound, then
    the grid."""
    gates = 3 if kernel == "gru" else 4
    if kernel == "lstm_eval" or dtype == "fp32":  # fp32 products
        f = fma_shape(h)
        fit = clusters_fit(f[0], ndir * -(-b // 16), f[1]) if f else False
        if fit is None:
            return {"cluster16_fp32", "wide_fp32", "grid"}
        if fit:
            return {"cluster16_fp32"}
        return {"wide_fp32" if wide_shape(gates, h, b, ndir) else "grid"}
    out = set()
    past = "wide_bf16" if wide_shape(gates, h, b, ndir, wbytes=2) else "grid"
    uc, cl, smem = mma_shape(gates, h, 1)
    if uc > 64:
        return {past}
    f1 = clusters_fit(cl, ndir * -(-b // 16), smem) if smem <= SMEM else False
    if f1 is not False:
        out.add("cluster16")
    if f1 is not True:
        _, cl2, smem2 = mma_shape(gates, h, 2)
        f2 = (clusters_fit(cl2, ndir * -(-b // 32), smem2) if smem2 <= SMEM
              else False)
        if f2 is not False:
            out.add("cluster32")
        if f2 is not True:
            out.add(past)
    return out


@pytest.mark.parametrize("case", chip_smoke.FWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_each_card_case_names_its_branch(case):
    """The branch a FWD_CASES entry expects is the rule's: the one branch
    for fp32 products, and for bf16 products one whose every outcome the
    expected prefix names."""
    kernel, t, b, h, dtype, ndir, branch = case
    got = fwd_branches(kernel, b, h, dtype, ndir)
    if kernel == "lstm_eval" or dtype == "fp32":
        assert got == {branch}, (case, got)
    assert all(g.startswith(branch) for g in got), (case, got)


def test_the_rule_takes_the_bf16_form_past_the_clusters_only():
    """On the bf16-product side the launcher asks the clusters first, then
    the bf16 form (not in the parent forms), then the grid; the tanh cell
    keeps the grid there.  So DeepSpeech2's training forward takes
    ``wide_bf16``, its eval op (fp32 products, past the fp32 bound) the
    grid, and the TIMIT cells keep their clusters."""
    assert fwd_branches("lstm_train", 64, 1024, "bf16", 2) == {"wide_bf16"}
    assert fwd_branches("lstm_eval", 64, 1024, "bf16", 2) == {"grid"}
    assert fwd_branches("lstm_train", 128, 384, "bf16", 2) == {"cluster32"}
    assert fwd_branches("lstm_train", 64, 384, "bf16", 2) == {"cluster16"}
    assert fwd_branches("lstm_train", 8, 384, "fp32", 2) == {"cluster16_fp32"}
    assert fwd_branches("lstm_eval", 8, 384, "fp32", 2) == {"cluster16_fp32"}
    assert fwd_branches("lstm_eval", 128, 384, "bf16", 2) == {"wide_fp32"}
    assert fwd_branches("lstm_train", 64, 1209, "bf16", 2) == {"grid"}
    text = (CSRC / "fwd_cluster.cuh").read_text()
    arm = text[text.index("if constexpr (kRound && kIsBf16<S>) {"):]
    arm = arm[:arm.index("if constexpr (Cell::kGates == 1) {")]
    assert (arm.index("taken = kFwdMma16") < arm.index("taken = kFwdMma32")
            < arm.index("if constexpr (Cell::kGates > 1) {")
            < arm.index("if (taken == kFwdGrid && !kParentBranches) {")
            < arm.index("taken = kFwdWideBf16"))
    for entry, cell in (("lstm_bidir_train.cu", "LstmCell"),
                        ("gru_bidir.cu", "GruCell")):
        assert (f"launch_fwd_wide<{cell}, __nv_bfloat16, true>("
                in (CSRC / entry).read_text()), entry
    for entry in ("lstm_bidir.cu", "rnn_bidir.cu", "rnn_bidir_train.cu"):
        assert "kFwdWideBf16" not in (CSRC / entry).read_text(), entry


def test_the_card_cases_cover_the_wide_branch():
    """The wide branch at the bench shape (B = 128 and 64, both stream
    dtypes of the eval forward, the training forward and the GRU on fp32
    streams), the waveform dev pass, T = 1, B not a multiple of 16, one
    direction, and each side of its bound; its bf16 form (wide_bf16) on each
    side of each of its two-direction bounds, for the LSTM and the GRU, with
    the grid past them; their graph cases too."""
    wide = {c[:6] for c in chip_smoke.FWD_CASES if c[-1] == "wide_fp32"}
    for key in (("lstm_eval", 80, 128, 384, "fp32", 2),
                ("lstm_eval", 80, 128, 384, "bf16", 2),
                ("lstm_eval", 80, 64, 384, "fp32", 2),
                ("lstm_eval", 80, 64, 384, "bf16", 2),
                ("lstm_eval", 200, 128, 384, "bf16", 2),
                ("lstm_train", 80, 128, 384, "fp32", 2),
                ("lstm_train", 80, 64, 384, "fp32", 2),
                ("gru", 95, 128, 256, "fp32", 2),
                ("lstm_eval", 1, 128, 384, "fp32", 2),
                ("lstm_eval", 12, 100, 384, "fp32", 2),
                ("gru", 12, 130, 256, "fp32", 2),
                ("lstm_train", 12, 144, 384, "fp32", 1),
                ("lstm_eval", 6, 8, 776, "fp32", 2),
                ("gru", 4, 4, 1056, "fp32", 2)):
        assert key in wide, key
    grid = {c[:6] for c in chip_smoke.FWD_CASES if c[-1] == "grid"}
    assert ("lstm_eval", 6, 8, 777, "fp32", 2) in grid
    assert ("gru", 4, 4, 1057, "fp32", 2) in grid
    graphs = {(c[0], c[2], c[-1]) for c in chip_smoke.GRAPH_CASES}
    assert {("lstm_eval", 128, "wide_fp32"), ("lstm_eval", 64, "wide_fp32"),
            ("lstm_train", 128, "wide_fp32"), ("gru_train", 128, "wide_fp32"),
            ("lstm_train", 128, "grid")} <= graphs
    # the bf16 form on each side of each of its bounds, for the LSTM and the
    # GRU: the bound itself on wide_bf16, one unit more on the grid
    cases = {c[:6]: c[-1] for c in chip_smoke.FWD_CASES}
    for gates, ndir, bs, bound in BOUNDS_BF16:
        if ndir != 2:
            continue
        kernel = "gru" if gates == 3 else "lstm_train"
        for b in bs[-1:]:
            assert cases.get((kernel, 4, b, bound, "bf16", 2)) == "wide_bf16", (
                kernel, b, bound)
            assert cases.get((kernel, 4, b, bound + 1, "bf16", 2)) == "grid", (
                kernel, b, bound + 1)
    assert {("lstm_train", 64, "wide_bf16"), ("gru_train", 128, "wide_bf16"),
            ("gru_train", 16, "grid")} <= graphs


# --- the kernel's arithmetic -------------------------------------------------

def tf32(x):
    """x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero:
    the bits plus 0x1000, the low 13 masked (the kernel's ``tf32_rna``)."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def truncated(x):
    """x as the tensor core reads a tf32 operand: its low 13 bits dropped."""
    return torch.bitwise_and(x.contiguous().view(torch.int32),
                             -0x2000).view(torch.float32)


def split(x):
    """The kernel's ``split_tf32`` as the tensor core sees it: hi = x
    rounded to tf32, lo = x - hi (exact) truncated to tf32."""
    hi = tf32(x)
    return hi, truncated(x - hi)


def wide_product(hp, w, ks):
    """``hp (ndir, B, H) @ w (ndir, H, GH)`` as the kernel sums it: H padded
    to k-steps of 8, each k-step's three tf32 products (lo_h hi_w, hi_h
    lo_w, hi_h hi_w, each an 8-term dot in fp32) added to an fp32 sum in
    that order, k-step by k-step; the KS splits of the k-steps each summed
    so, then added in split order."""
    ndir, b, h = hp.shape
    gh = w.shape[-1]
    nks = -(-h // 8)
    pad = 8 * nks - h
    hp = torch.nn.functional.pad(hp, (0, pad))
    w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    (a_hi, a_lo), (w_hi, w_lo) = split(hp), split(w)

    def steps(a, ww):  # (ndir, nks, B, GH): each k-step's 8-term products
        return torch.einsum("dbkj,dkjn->dkbn", a.view(ndir, b, nks, 8),
                            ww.view(ndir, nks, 8, gh))

    terms = (steps(a_lo, w_hi), steps(a_hi, w_lo), steps(a_hi, w_hi))
    kpw = -(-nks // ks)
    total = None
    for kh in range(ks):
        acc = hp.new_zeros(ndir, b, gh)
        for kb in range(kh * kpw, min(nks, kh * kpw + kpw)):
            for term in terms:
                acc = acc + term[:, kb]
        total = acc if total is None else total + acc
    return total


def emulated_lstm(gx, w_hh, ks):
    """``lstm_bidir_plain`` (fp32 streams) with the recurrent product summed
    as ``wide_product``."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    hs = torch.zeros(ndir, b, h)
    cs = torch.zeros_like(hs)
    ys = torch.empty(t_len, b, ndir * h)
    for s in range(t_len):
        times = step_times(t_len, ndir, s)
        g2 = torch.stack([gx[t, :, 4 * d * h:4 * (d + 1) * h]
                          for d, t in enumerate(times)])
        i, f, g, o = (g2 + wide_product(hs, w_hh, ks)).chunk(4, dim=-1)
        cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
        hs = torch.sigmoid(o) * torch.tanh(cs)
        for d, t in enumerate(times):
            ys[t, :, d * h:(d + 1) * h] = hs[d]
    return ys


def emulated_gru(gx, w_hh, ks):
    """``gru_bidir_plain`` (fp32 streams) with the recurrent product summed
    as ``wide_product``."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    hs = torch.zeros(ndir, b, h)
    ys = torch.empty(t_len, b, ndir * h)
    for s in range(t_len):
        times = step_times(t_len, ndir, s)
        pre = torch.stack([gx[t, :, 3 * d * h:3 * (d + 1) * h]
                           for d, t in enumerate(times)])
        r, z, n = gru_ops.gru_gates(pre, wide_product(hs, w_hh, ks))
        hs = (1.0 - z) * n + z * hs
        for d, t in enumerate(times):
            ys[t, :, d * h:(d + 1) * h] = hs[d]
    return ys


def inputs(t, b, h, gates, seed):
    rng = np.random.RandomState(seed)
    gx = rng.randn(t, b, 2 * gates * h).astype(np.float32)
    w_hh = ((rng.rand(2, h, gates * h) * 2 - 1) / np.sqrt(h)).astype(np.float32)
    return torch.from_numpy(gx), torch.from_numpy(w_hh)


def test_the_split_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 3 * 2 ** -11),
                      1.0 + 2 ** -10 + 2 ** -11, 3.0, -0.1], dtype=torch.float32)
    want = torch.tensor([1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -9),
                         1.0 + 2 * 2 ** -10, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(x)[:5], want)
    hi, lo = split(x)
    assert torch.equal((hi + lo)[:5], x[:5])  # the two parts hold x here
    assert (tf32(hi) == hi).all() and (truncated(lo) == lo).all()
    # what the split leaves out is below 2^-21 of x
    rng = np.random.RandomState(5)
    v = torch.from_numpy(rng.randn(4096).astype(np.float32))
    hi, lo = split(v)
    assert ((v - hi - lo).abs() <= v.abs() * 2.0 ** -21).all()


def test_the_emulation_is_the_twins_function_at_a_small_width():
    gx, w_hh = inputs(4, 5, 13, 4, seed=1)
    want = lstm_ops.lstm_bidir_plain(gx, w_hh)
    for ks in (1, 2):
        assert (emulated_lstm(gx, w_hh, ks) - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_the_3xtf32_product_holds_the_twin_and_pallas(cell):
    """A whole recurrence at full width and B = 64 (the wide branch's shape
    there: Uc = 24, RB = 16, KS = 4 for the LSTM), 20 steps, two
    directions: the emulated kernel within 1e-4 of the plain twin and of
    the JAX package's Pallas forward in interpret mode."""
    t, b, h = 20, 64, 384
    gates = 4 if cell == "lstm" else 3
    shape = wide_shape(gates, h, b, 2)
    assert shape is not None and (cell == "gru" or shape[:5:2] == (24, 16, 4))
    gx, w_hh = inputs(t, b, h, gates, seed=16 + gates)
    eye = np.eye(2 * gates * h, dtype=np.float32)
    w_ih = np.stack([eye[:, :gates * h], eye[:, gates * h:]])
    if cell == "lstm":
        got = emulated_lstm(gx, w_hh, shape[4])
        twin = lstm_ops.lstm_bidir_plain(gx, w_hh)
        pallas = lstm_bidir_pallas_v2(
            jnp.asarray(gx.numpy()), jnp.asarray(w_ih), jnp.asarray(w_hh.numpy()),
            chunk=1, interpret=True, compute_dtype=jnp.float32)
    else:
        got = emulated_gru(gx, w_hh, shape[4])
        twin = gru_ops.gru_bidir_plain(gx, w_hh)
        pallas = gru_bidir_v2(
            jnp.asarray(gx.numpy()), jnp.asarray(w_ih), jnp.asarray(w_hh.numpy()),
            chunk=1, interpret=True, compute_dtype=jnp.float32, train=False)
    assert torch.isfinite(got).all()
    assert (got - twin).abs().max().item() <= TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32),
                               rtol=0, atol=TOL)


# --- the bf16 form: fragment orders and arithmetic ---------------------------

def bf16_exchange(hs, nkp):
    """One step's bf16 exchange buffer ``[nmt][nkp][32 lanes][8 halves]`` as
    the writers fill it from ``hs (B, H)``: pair p = 2 e + jj of 8-unit block
    j (row 16 mt + g + 8 e, unit 8 j + 2 c + jj) into lane 4 g + c's half
    jj of word 2 (j % 2) + e of k-step j // 2; zero past B and H.  Block
    2 nkp - 1 has no writer where H / 8 is odd: NaN there."""
    b, h = hs.shape
    nmt, nks = -(-b // 16), -(-h // 8)
    buf = np.full((nmt, nkp, 32, 8), np.nan, np.float32)
    for mt in range(nmt):
        for j in range(nks):
            for lane in range(32):
                g, c = lane >> 2, lane & 3
                for e in range(2):
                    for jj in range(2):
                        r, u = 16 * mt + g + 8 * e, 8 * j + 2 * c + jj
                        v = hs[r, u] if r < b and u < h else 0.0
                        buf[mt, j // 2, lane, 2 * (2 * (j % 2) + e) + jj] = v
    return buf


def bf16_a_operand(buf, mt, kb, nks):
    """The 16 x 16 A operand a reader's m16n8k16 takes from k-step kb of
    m-tile mt: register r of lane 4 g + c holds rows g (r = 0, 2) or g + 8
    (r = 1, 3) at columns 2 c, 2 c + 1 (r < 2) or 2 c + 8, 2 c + 9, the
    second half zeroed where block 2 kb + 1 is past H / 8."""
    a = np.zeros((16, 16), np.float32)
    for lane in range(32):
        g, c = lane >> 2, lane & 3
        for reg in range(4):
            if reg >= 2 and 2 * kb + 1 >= nks:
                continue
            for t in range(2):
                a[g + 8 * (reg & 1), 2 * c + 8 * (reg >> 1) + t] = \
                    buf[mt, kb, lane, 2 * reg + t]
    return a


def bf16_resident(w, uc, own0, gates):
    """A CTA's resident bf16 weights as the loader stores them, halves of
    4-byte words ``[nub][G][32 nks]``: (unit u, k, gate q) to word 64 kb +
    2 lane + k / 8 % 2 of its (unit block, gate) row, or 64 kb + lane in an
    odd last k-step, lane 4 (u % 8) + k % 8 / 2, half k % 2."""
    h = w.shape[0]
    nks, nub = -(-h // 8), uc // 8
    words = np.zeros((nub, gates, 32 * nks, 2), np.float32)
    for q in range(gates):
        for u in range(uc):
            for k in range(8 * nks):
                unit = own0 + u
                v = w[k, q * h + unit] if k < h and unit < h else 0.0
                kb, ln = k >> 4, 4 * (u & 7) + ((k & 7) >> 1)
                word = 64 * kb + (2 * ln + ((k >> 3) & 1) if 2 * kb + 1 < nks
                                  else ln)
                words[u >> 3, q, word, k & 1] = v
    return words


def bf16_b_operand(words, ub, q, kb, nks):
    """The 16 x 8 B operand of k-step kb of n-tile (unit block ub, gate q):
    b0 of lane 4 g + c holds k = 2 c, 2 c + 1 of column g, b1 k = 2 c + 8,
    2 c + 9 (zero in an odd last k-step)."""
    bm = np.zeros((16, 8), np.float32)
    full = 2 * kb + 1 < nks
    for lane in range(32):
        g, c = lane >> 2, lane & 3
        regs = ([words[ub, q, 64 * kb + 2 * lane], words[ub, q, 64 * kb + 2 * lane + 1]]
                if full else [words[ub, q, 64 * kb + lane], np.zeros(2)])
        for reg, pair in enumerate(regs):
            for t in range(2):
                bm[2 * c + 8 * reg + t, g] = pair[t]
    return bm


@pytest.mark.parametrize("b,h", [(20, 40), (16, 48), (33, 8)])
def test_the_bf16_fragment_orders_meet(b, h):
    """The writers' placement of h and the readers' A operands are one
    order: each k-step's A is h's 16 x 16 block, zero past B and H, and no
    unwritten word (NaN) reaches it, H / 8 odd or even; the loader's
    placement of w_hh and the readers' B operands likewise (the header's
    word formula)."""
    rng = np.random.RandomState(b + h)
    hs = rng.randn(b, h).astype(np.float32)
    nks = -(-h // 8)
    nkp = -(-nks // 2)
    buf = bf16_exchange(hs, nkp)
    padded = np.zeros((16 * -(-b // 16), 16 * nkp), np.float32)
    padded[:b, :h] = hs
    for mt in range(-(-b // 16)):
        for kb in range(nkp):
            np.testing.assert_array_equal(
                bf16_a_operand(buf, mt, kb, nks),
                padded[16 * mt:16 * mt + 16, 16 * kb:16 * kb + 16])
    gates, uc = 4, 16
    w = rng.randn(h, gates * h).astype(np.float32)
    code = (CSRC / "fwd_wide.cuh").read_text()
    assert ("row + 64 * kb + (2 * kb + 1 < nks ? 2 * ln + ((k >> 3) & 1) : ln);"
            in code)
    for own0 in range(0, h, uc):
        words = bf16_resident(w, uc, own0, gates)
        for ub in range(uc // 8):
            for q in range(gates):
                want = np.zeros((16 * nkp, 8), np.float32)
                cols = [own0 + 8 * ub + n for n in range(8)]
                for n, unit in enumerate(cols):
                    if unit < h:
                        want[:h, n] = w[:, q * h + unit]
                for kb in range(nkp):
                    np.testing.assert_array_equal(
                        bf16_b_operand(words, ub, q, kb, nks),
                        want[16 * kb:16 * kb + 16])


def bf16_product(hp, w, ks):
    """``hp (ndir, B, H) @ w (ndir, H, GH)`` as the bf16 form sums it: both
    operands bf16 values, H padded to k-steps of 16, each k-step's 16-term
    dot in fp32 added to an fp32 sum k-step by k-step; the KS splits of the
    k-steps each summed so, then added in split order."""
    ndir, b, h = hp.shape
    gh = w.shape[-1]
    nkp = -(-(-(-h // 8)) // 2)
    pad = 16 * nkp - h
    hp = torch.nn.functional.pad(hp, (0, pad))
    w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    steps = torch.einsum("dbkj,dkjn->dkbn", hp.view(ndir, b, nkp, 16),
                         w.view(ndir, nkp, 16, gh))
    kpw = -(-nkp // ks)
    total = None
    for kh in range(ks):
        acc = hp.new_zeros(ndir, b, gh)
        for kb in range(kh * kpw, min(nkp, kh * kpw + kpw)):
            acc = acc + steps[:, kb]
        total = acc if total is None else total + acc
    return total


def emulated_lstm_bf16(gx, w_hh, ks):
    """``lstm_bidir_train_plain`` on bf16 streams with the recurrent product
    summed as ``bf16_product``: ``(ys, cs)`` in bf16."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    w = w_hh.to(torch.bfloat16).float()
    hs = torch.zeros(ndir, b, h)
    c = torch.zeros_like(hs)
    ys = torch.empty(t_len, b, ndir * h, dtype=torch.bfloat16)
    cs = torch.empty_like(ys)
    for s in range(t_len):
        times = step_times(t_len, ndir, s)
        pre = torch.stack([gx[t, :, 4 * d * h:4 * (d + 1) * h]
                           for d, t in enumerate(times)]).float()
        i, f, g, o = (pre + bf16_product(hs, w, ks)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hn = (torch.sigmoid(o) * torch.tanh(c)).to(torch.bfloat16)
        hs = hn.float()
        for d, t in enumerate(times):
            ys[t, :, d * h:(d + 1) * h] = hn[d]
            cs[t, :, d * h:(d + 1) * h] = c[d].to(torch.bfloat16)
    return ys, cs


def emulated_gru_bf16(gx, w_hh, ks):
    """``gru_bidir_plain`` on bf16 streams (the fp32 carry, h rounded to bf16
    for the product and the store) with the product summed as
    ``bf16_product``."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    w = w_hh.to(torch.bfloat16).float()
    hs = torch.zeros(ndir, b, h)
    ys = torch.empty(t_len, b, ndir * h, dtype=torch.bfloat16)
    for s in range(t_len):
        times = step_times(t_len, ndir, s)
        pre = torch.stack([gx[t, :, 3 * d * h:3 * (d + 1) * h]
                           for d, t in enumerate(times)]).float()
        hh = bf16_product(hs.to(torch.bfloat16).float(), w, ks)
        r, z, n = gru_ops.gru_gates(pre, hh)
        hs = (1.0 - z) * n + z * hs
        for d, t in enumerate(times):
            ys[t, :, d * h:(d + 1) * h] = hs[d].to(torch.bfloat16)
    return ys


BF16_TOL = 2e-2  # the card's bf16 tolerance (chip_smoke.BF16_TOL)


@pytest.mark.parametrize("cell,h", [("lstm", 456), ("gru", 520)])
def test_the_bf16_product_holds_the_twin_and_pallas(cell, h):
    """A whole training-forward recurrence at a reduced width past the
    bf16 clusters' bound (H / 8 odd: the half last k-step), B = 64, 12
    steps, two directions, bf16 streams, on the bf16 form's shape there:
    the emulated kernel within the bf16 tolerance of the plain twin and of
    the JAX package's Pallas training forward in interpret mode."""
    from ctc_pytorch_tpu.ops.gru_pallas_v2 import gru_scan_train_v2
    from ctc_pytorch_tpu.ops.lstm_pallas_train_v2 import lstm_scan_train_v2
    from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as train_ops

    assert chip_smoke.BF16_TOL == BF16_TOL
    t, b = 12, 64
    gates = 4 if cell == "lstm" else 3
    assert -(-h // 8) % 2 == 1
    assert fwd_branches("lstm_train" if cell == "lstm" else "gru", b, h,
                        "bf16", 2) == {"wide_bf16"}
    shape = wide_shape(gates, h, b, 2, wbytes=2)
    gx, w_hh = inputs(t, b, h, gates, seed=26 + gates)
    gx = gx.to(torch.bfloat16)
    jgx = jnp.asarray(gx.float().numpy()).astype(jnp.bfloat16)
    jw = jnp.asarray(w_hh.numpy())
    if cell == "lstm":
        got, got_cs = emulated_lstm_bf16(gx, w_hh, shape[4])
        twin, twin_cs = train_ops.lstm_bidir_train_plain(gx, w_hh)
        assert (got_cs.float() - twin_cs.float()).abs().max().item() <= BF16_TOL
        pallas = lstm_scan_train_v2(jgx, jw, 1, True)[1:t + 1]
    else:
        got = emulated_gru_bf16(gx, w_hh, shape[4])
        twin = gru_ops.gru_bidir_plain(gx, w_hh)
        pallas = gru_scan_train_v2(jgx, jw, 1, True)[1:t + 1]
    assert torch.isfinite(got.float()).all()
    assert (got.float() - twin.float()).abs().max().item() <= BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas.astype(jnp.float32)),
                               rtol=0, atol=BF16_TOL)
