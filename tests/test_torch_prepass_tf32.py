"""The fp32 backward pre-pass of the LSTM and GRU (``prepass_tf32_kernel``
in ``csrc/bwd_hoist.cuh``): a Python mirror of its tile, ring, shared
memory and grid against the constants the header declares, for G = 3 and
4, H from 1 to 1056 and T B from 1 to 25,600; the header's bound against
``chip_smoke.prepass_bound``; the pre-pass's edges among the fp32
``chip_smoke.HOIST_CASES`` entries; and an emulation of the kernel's arithmetic -- h_prev
and w_hh split into tf32 hi (round to nearest) and lo = x - hi, which the
tensor core reads truncated to tf32, ``lo_h hi_w + hi_h lo_w + hi_h hi_w``
added to an fp32 sum a k-step (8 deep) at a time in order -- through the
epilogue's formulas at full width (LSTM T' = 20, B = 64, H = 384; GRU H =
256; two directions), held against the pre-pass twins and against the JAX
package's pre-pass formulas.  A single TF32 pass is shown to miss.  Nothing
here launches a kernel; the kernel is held against the twins on the card
(``chip_smoke.HOIST_CASES``, ``tests/test_torch_cuda.py``).

Tolerance: 1e-4 abs, the card's fp32 tolerance (``PERF.md`` §2)."""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_eval_ops
from ctc_pytorch_tpu_torch.ops import gru_bidir_train as gru_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as lstm_ops
from ctc_pytorch_tpu_torch.ops._build import CSRC, per_direction, shifted
from test_torch_gru_train import _jax_gru_planes
from test_torch_lstm_train import _jax_lstm_planes
from test_torch_wide_fwd import split, tf32

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  the card's cases

SMEM = 232448  # an H100 CTA's shared memory, opt-in
TOL = 1e-4
# the kernel's constants, as the header declares them
WARP_ROWS, WARP_UNITS, WARPS_M, WARPS_U = 32, 16, 4, 2
K, STAGES, LDA, PADB = 32, 3, 36, 8


def header():
    return (CSRC / "bwd_hoist.cuh").read_text()


def header_text():
    return " ".join(w for w in header().split() if w != "//")


def tile_shape(gates):
    """The header's ``TfTile``: threads, rows, units, gate columns, the B
    row stride, one ring slot's floats (the A and the B tile), the CTA's
    shared memory in bytes and each thread's 16-byte chunks of A and (at
    most) of B a slot."""
    threads = 32 * WARPS_M * WARPS_U
    rows, units = WARP_ROWS * WARPS_M, WARP_UNITS * WARPS_U
    cols = gates * units
    ldb = cols + PADB
    slot = rows * LDA + K * ldb
    return {"threads": threads, "rows": rows, "units": units, "cols": cols,
            "ldb": ldb, "slot": slot, "smem": STAGES * slot * 4,
            "a_per": rows * (K // 4) / threads,
            "b_per": -(-(K * cols // 4) // threads)}


def grid(m, h, ndir):
    """The launcher's grid: (row tiles, unit groups, directions)."""
    s = tile_shape(4)
    return -(-m // s["rows"]), -(-h // s["units"]), ndir


def test_the_constants_are_the_headers():
    text = header()
    for name, want in (("kTfWarpRows", WARP_ROWS), ("kTfWarpUnits", WARP_UNITS),
                       ("kTfWarpsM", WARPS_M), ("kTfWarpsU", WARPS_U),
                       ("kTfK", K), ("kTfStages", STAGES),
                       ("kTfPadB", PADB)):
        assert re.search(rf"constexpr int {name} = {want};", text), name
    assert "constexpr int kTfLdA = kTfK + 4;" in text and LDA == K + 4
    # one kernel a cell on every fp32 stream, launched with the tile's
    # threads and ring; the CUDA-core kernel it replaced has left the sources
    launcher = text[text.index("cudaError_t launch_prepass("):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert launcher.count("<<<") == 2
    assert "prepass_mma_kernel<Cell><<<grid, 128, 0, stream>>>(" in launcher
    assert ("prepass_tf32_kernel<Cell><<<grid, Tile::kThreads, Tile::kSmem, "
            "stream>>>(" in launcher)
    for path in CSRC.glob("*.cu*"):
        assert "prepass_fma_kernel" not in path.read_text(), path
    assert "a CTA 4 x 2 warps: 128 rows x 32 units" in header_text()


@pytest.mark.parametrize("gates", [3, 4])
def test_the_tile_fits_and_its_fragments_hit_distinct_banks(gates):
    """The ring fits a CTA, twice an SM; every thread stages whole 16-byte
    chunks of A,
    16-byte aligned in shared memory; the A fragments' 4-byte loads (lane
    (g, c): row g, k c) and the B fragments' (k c, column g) fall in 32
    distinct banks."""
    s = tile_shape(gates)
    assert s["smem"] <= SMEM and s["threads"] <= 1024
    # two CTAs an SM by shared memory (the runtime keeps 1 KB of the SM's
    # 228 KB a CTA), as the header says
    assert 2 * (s["smem"] + 1024) <= 228 * 1024
    assert s["smem"] // 1024 == {4: 105, 3: 93}[gates]
    assert ("a ring of three k slots of 32, the next two in flight behind "
            "the one multiplied (105 KB, the GRU's 93 KB, so that two of the "
            "GRU's CTAs fit an SM") in header_text()
    assert s["a_per"] == int(s["a_per"]) and s["b_per"] <= 4
    assert (s["slot"] * 4) % 16 == 0 and (LDA * 4) % 16 == 0
    assert (s["ldb"] * 4) % 16 == 0
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    assert len({(g * LDA + c) % 32 for g, c in lanes}) == 32
    assert len({(c * s["ldb"] + g) % 32 for g, c in lanes}) == 32


def test_the_grid_covers_every_shape():
    """Over H from 1 to 1056 and T B from 1 to 25,600, one or two
    directions, the grid covers every row and unit within the card's
    limits, and the tail tiles hold fewer rows or units than a tile."""
    ms = sorted({1, 2, 7, 63, 64, 65, 127, 128, 129, 400, 760, 800, 3200,
                 5120, 10240, 12160, 25600} | set(range(1, 25601, 997)))
    s = tile_shape(4)
    for h in range(1, 1057):
        for m in ms:
            for ndir in (1, 2):
                gx_, gy, gz = grid(m, h, ndir)
                assert 0 < m - (gx_ - 1) * s["rows"] <= s["rows"]
                assert 0 < h - (gy - 1) * s["units"] <= s["units"]
                assert gx_ < 2 ** 31 and gy <= 65535 and gz == ndir
    # the recipe's batch of 8 and a data-parallel rank's 4 at H = 384
    assert grid(800, 384, 2) == (7, 12, 2) and grid(400, 384, 2) == (4, 12, 2)
    assert grid(10240, 384, 2) == (80, 12, 2)


def test_the_bound_is_the_headers():
    """The header's bound at the bench shape and the recipe's, from
    ``chip_smoke.prepass_bound`` (shapes only: meta tensors)."""
    text = header_text()
    for want in ("24.2 GFLOP and 382 MB (gx 126 MB, ys and cs 63 MB, w_hh "
                 "4.7 MB read; the six planes, 189 MB, written",
                 "0.114 ms of bytes at 3.35 TB/s, 0.361 ms of fp32 FMA at 67 "
                 "TFLOP/s, 0.146 ms for three TF32 passes at 495 TFLOP/s",
                 "at the recipe's (100, 8, 384) 1.89 GFLOP and 34 MB"):
        assert want in text, want

    def bound(t, b, h):
        return chip_smoke.prepass_bound(
            torch.empty(t, b, 8 * h, device="meta"),
            torch.empty(2, h, 4 * h, device="meta"), n_saved=2, n_planes=6,
            bf16=False)

    bench = bound(80, 128, 384)
    assert round(bench["gflop"], 1) == 24.2 and round(bench["mbytes"]) == 382
    assert round(bench["bytes_ms"], 3) == 0.114
    assert round(bench["fp32_ops_ms"], 3) == 0.361
    assert round(bench["tf32x3_ops_ms"], 3) == 0.146
    assert bench["bound_ms"] == bench["tf32x3_ops_ms"]
    assert bench["bound_by"] == "operations"
    recipe = bound(100, 8, 384)
    assert round(recipe["gflop"], 2) == 1.89 and round(recipe["mbytes"]) == 34


FP32_CASES = [c for c in chip_smoke.HOIST_CASES if c[4] == "fp32"]


def test_the_card_cases_hold_the_prepass_edges():
    """Every fp32 ``HOIST_CASES`` entry has a grid within the card's limits,
    and the list holds the pre-pass's edges: T' B off the tile's rows with H
    off its units, H % 4 != 0 with two directions in both cells, one
    direction at B = 1 in both, T' = 1, B = 1, scaled inputs in both cells,
    the widest H of the wide branch; phase 9 times the main paths' seven
    shapes."""
    s = tile_shape(4)
    for cell, t, b, h, _, ndir, _ in FP32_CASES:
        assert grid(t * b, h, ndir)[1] <= 65535
    keys = {c[:6] for c in FP32_CASES}
    for key in (("lstm", 7, 9, 200, "fp32", 2), ("gru", 7, 9, 200, "fp32", 2),
                ("lstm", 5, 24, 45, "fp32", 2), ("gru", 5, 24, 45, "fp32", 2),
                ("lstm", 9, 1, 384, "fp32", 1), ("gru", 9, 1, 256, "fp32", 1),
                ("gru", 1, 1, 32, "fp32", 2), ("gru", 3, 16, 1056, "fp32", 2),
                ("lstm", 3, 16, 1056, "fp32", 1)):
        assert key in keys, key
    assert any((t * b) % s["rows"] and h % s["units"] for _, t, b, h, _, _ in keys)
    assert set(chip_smoke.HOIST_SCALE) <= keys
    assert set(chip_smoke.HOIST_SCALE.values()) == {8.0}
    assert {k[0] for k in chip_smoke.HOIST_SCALE} == {"lstm", "gru"}
    assert set(chip_smoke.PREPASS_TIMES) == {
        ("lstm", 100, 8, 384), ("lstm", 400, 8, 256), ("lstm", 100, 4, 384),
        ("lstm", 80, 128, 384), ("lstm", 80, 64, 384), ("gru", 95, 128, 256),
        ("gru", 95, 8, 256)}


# --- the kernel's arithmetic -------------------------------------------------

def tf32_product(h_prev, w, passes=3):
    """``h_prev (ndir, M, H) @ w (ndir, H, G H)`` as the kernel sums it: H
    padded with zeros to k-steps of 8 (the ring's slots of 16 are two), each
    k-step's three tf32 products (lo_h hi_w, hi_h lo_w, hi_h hi_w, each an
    8-term dot in fp32) added to the fp32 sum in that order, k-step by
    k-step.  ``passes=1``: one TF32 pass, both operands rounded to tf32."""
    ndir, m, h = h_prev.shape
    nks = -(-h // 8)
    h_prev = torch.nn.functional.pad(h_prev, (0, 8 * nks - h))
    w = torch.nn.functional.pad(w, (0, 0, 0, 8 * nks - h))
    if passes == 3:
        (a_hi, a_lo), (w_hi, w_lo) = split(h_prev), split(w)
        terms = ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi))
    else:
        terms = ((tf32(h_prev), tf32(w)),)
    acc = h_prev.new_zeros(ndir, m, w.shape[-1])
    for kb in range(nks):
        ks = slice(8 * kb, 8 * kb + 8)
        for a, b in terms:
            acc = acc + torch.bmm(a[..., ks], b[:, ks])
    return acc


def epilogue(cell, gx, ys, cs, hh):
    """The kernel's epilogue (``emit_pair_f32``) over the products ``hh
    (ndir, T B, G H)``: the planes ``(ndir, T, P, B, H)``."""
    t, b, _ = gx.shape
    ndir, _, gh = hh.shape
    h = ys.shape[-1] // ndir
    pre = per_direction(gx, ndir)
    hh = hh.reshape(ndir, t, b, gh)
    if cell == "lstm":
        i, f = torch.sigmoid(pre[..., :h] + hh[..., :h]), torch.sigmoid(
            pre[..., h:2 * h] + hh[..., h:2 * h])
        g = torch.tanh(pre[..., 2 * h:3 * h] + hh[..., 2 * h:3 * h])
        o = torch.sigmoid(pre[..., 3 * h:] + hh[..., 3 * h:])
        tc = torch.tanh(per_direction(cs, ndir))
        c_prev = shifted(cs, ndir, torch.float32)
        return torch.stack([o * (1.0 - tc * tc), g * (i * (1.0 - i)),
                            c_prev * (f * (1.0 - f)), i * (1.0 - g * g),
                            tc * (o * (1.0 - o)), f], dim=2)
    r = torch.sigmoid(pre[..., :h] + hh[..., :h])
    z = torch.sigmoid(pre[..., h:2 * h] + hh[..., h:2 * h])
    hh_n = hh[..., 2 * h:]
    n = torch.tanh(pre[..., 2 * h:] + r * hh_n)
    p_n = (1.0 - z) * (1.0 - n * n)
    h_prev = shifted(ys, ndir, torch.float32)
    return torch.stack([p_n * hh_n * (r * (1.0 - r)), (h_prev - n) * (
        z * (1.0 - z)), p_n, p_n * r, z], dim=2)


def cell_inputs(cell, t, b, h, seed, ndir=2):
    """gx, w_hh and dy from a numpy seed, the saved planes of the forward
    twin, the pre-pass twin's planes and the serial twin (dgx only)."""
    gates = 4 if cell == "lstm" else 3
    rng = np.random.RandomState(seed)
    gx = torch.from_numpy(rng.randn(t, b, ndir * gates * h).astype(np.float32))
    w = torch.from_numpy(((rng.rand(ndir, h, gates * h) * 2 - 1)
                          / np.sqrt(h)).astype(np.float32))
    dy = torch.from_numpy(rng.randn(t, b, ndir * h).astype(np.float32))
    if cell == "lstm":
        ys, cs = lstm_ops.lstm_bidir_train_plain(gx, w)
        twin = lstm_ops.lstm_bidir_train_bwd_prepass_plain(gx, w, ys, cs)
        serial = lstm_ops.lstm_bidir_train_bwd_serial_plain
    else:
        ys, cs = gru_eval_ops.gru_bidir_plain(gx, w), None
        twin = gru_ops.gru_bidir_train_bwd_prepass_plain(gx, w, ys)

        def serial(planes, w_hh, d):
            return gru_ops.gru_bidir_train_bwd_serial_plain(planes, w_hh, d)[0]
    return gx, w, dy, ys, cs, twin, serial


@pytest.mark.parametrize("cell,t,b,h,ndir", [
    ("lstm", 5, 3, 13, 2), ("gru", 5, 3, 13, 2), ("lstm", 4, 1, 37, 1),
    ("gru", 1, 2, 37, 2)])
def test_the_emulation_is_the_twins_function_at_a_small_width(cell, t, b, h,
                                                              ndir):
    """H % 8 != 0 (zero-padded k-steps), one direction, T' = 1, B = 1: the
    emulated kernel is the twin's function, fp32 rounding and the split's
    2^-21 apart."""
    gx, w, _, ys, cs, twin, _ = cell_inputs(cell, t, b, h, seed=t + b + h,
                                            ndir=ndir)
    h_prev = shifted(ys, ndir, torch.float32).reshape(ndir, t * b, h)
    got = epilogue(cell, gx, ys, cs, tf32_product(h_prev, w))
    assert got.shape == twin.shape
    assert (got - twin).abs().max().item() <= 1e-5


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_the_3xtf32_prepass_holds_the_twin_and_the_jax_formulas(cell):
    """Full width, T' = 20, B = 64, two directions: the emulated products
    within 1e-5 of fp64 and the planes within 1e-4 of the pre-pass twin and
    of the JAX package's pre-pass formulas; one TF32 pass misses 1e-4 in the
    products and in dgx through the serial twin (the GRU's planes too), so
    the tolerance tells the two apart."""
    t, b = 20, 64
    h = 384 if cell == "lstm" else 256
    gx, w, dy, ys, cs, twin, serial = cell_inputs(cell, t, b, h, seed=9)
    h_prev = shifted(ys, 2, torch.float32).reshape(2, t * b, h)
    exact = torch.bmm(h_prev.double(), w.double())
    hh3, hh1 = tf32_product(h_prev, w), tf32_product(h_prev, w, passes=1)
    assert (hh3.double() - exact).abs().max().item() <= 1e-5
    assert (hh1.double() - exact).abs().max().item() > TOL
    got, one_pass = epilogue(cell, gx, ys, cs, hh3), epilogue(cell, gx, ys, cs,
                                                              hh1)
    assert torch.isfinite(got).all()
    assert (got - twin).abs().max().item() <= TOL
    if cell == "lstm":
        jax_planes = _jax_lstm_planes(jnp.asarray(gx.numpy()),
                                      jnp.asarray(w.numpy()),
                                      jnp.asarray(ys.numpy()),
                                      jnp.asarray(cs.numpy()))
    else:
        jax_planes = _jax_gru_planes(jnp.asarray(gx.numpy()),
                                     jnp.asarray(w.numpy()),
                                     jnp.asarray(ys.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_planes), rtol=0,
                               atol=TOL)
    want = serial(twin, w, dy)
    assert (serial(got, w, dy) - want).abs().max().item() <= TOL
    assert (serial(one_pass, w, dy) - want).abs().max().item() > TOL
    if cell == "gru":
        assert (one_pass - twin).abs().max().item() > TOL
