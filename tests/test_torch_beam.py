"""The port's beam decoders against the JAX package's on the CPU, on seeded
numpy inputs: the numpy and the native prefix search (``decode/beam.py``,
``native/``), the batched search (``decode/beam_device.py``) at the cases
of the JAX package's ``tests/test_beam_device.py`` and at cases built for
top-k ties and the merge mask's colliding rows, and ``BeamDecoder``'s
strings.  Tokens and lengths must be equal; scores within rtol 1e-9 (the
numpy copy), 1e-6 (the C++ search, float32 inputs summed in double) and
1e-5 (the batched search, float32)."""

import logging
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.decode.beam import BeamDecoder as JBeamDecoder
from ctc_pytorch_tpu.decode.beam import ctc_beam_search as jax_ctc_beam_search
from ctc_pytorch_tpu.decode.beam_device import _beam_step as jax_beam_step
from ctc_pytorch_tpu.decode.beam_device import batched_beam_search as jax_batched
from ctc_pytorch_tpu.decode.ngram_lm import LanguageModel, train_bigram_lm
from ctc_pytorch_tpu_torch import native
from ctc_pytorch_tpu_torch.decode import BeamDecoder, ctc_beam_search
from ctc_pytorch_tpu_torch.decode.beam_device import NEG, _beam_step
from ctc_pytorch_tpu_torch.decode.beam_device import batched_beam_search

INT2CHAR = {0: "blank", 1: "aa", 2: "bb"}


def random_batch(seed, b=4, t=12, c=5, alpha=1.0):
    """Dirichlet frames; ``alpha`` < 1 gives peaked frames, which merge many
    prefixes in the search."""
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(c, alpha), size=(b, t)).astype(np.float32)
    lengths = rng.randint(max(t // 2, 1), t + 1, size=b).astype(np.int32)
    return probs, lengths


@pytest.fixture(scope="module")
def lm_table(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "lm.arpa"
    train_bigram_lm(["aa bb aa bb", "bb aa", "aa aa bb"], path)
    return LanguageModel(path).dense_table(INT2CHAR, 3).astype(np.float32)


# ---------------------------------------------------------------------------
# the per-utterance prefix search: numpy copy and C++
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,c,width,alpha,with_lm", [
    (0, 5, 8, 1.0, False), (1, 5, 8, 1.0, False), (2, 4, 16, 0.3, False),
    (3, 40, 8, 0.4, False), (4, 3, 6, 1.0, True), (5, 3, 6, 0.3, True),
])
def test_prefix_search_matches_jax(lm_table, seed, c, width, alpha, with_lm):
    probs, lengths = random_batch(seed, b=3, t=30, c=c, alpha=alpha)
    table = lm_table if with_lm else None
    lm_alpha = 0.2 if with_lm else 0.0
    for i in range(probs.shape[0]):
        args = (probs[i], width, table, lm_alpha, 0, int(lengths[i]))
        y_want, s_want = jax_ctc_beam_search(*args)
        y_np, s_np = ctc_beam_search(*args)
        y_cc, s_cc = native.ctc_beam_search_native(*args)
        assert y_np == y_want and y_cc == y_want, (i, y_np, y_cc, y_want)
        np.testing.assert_allclose(s_np, s_want, rtol=1e-9)
        np.testing.assert_allclose(s_cc, s_want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the batched search
# ---------------------------------------------------------------------------

def assert_batched_matches_jax(probs, lengths, **kw):
    lm = kw.pop("lm_table", None)
    want = jax_batched(jnp.asarray(probs), jnp.asarray(lengths),
                       lm_table=None if lm is None else jnp.asarray(lm), **kw)
    got = batched_beam_search(torch.from_numpy(probs),
                              torch.from_numpy(lengths),
                              lm_table=None if lm is None
                              else torch.from_numpy(lm), **kw)
    seqs, lens, scores = (np.asarray(x) for x in want)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[1].numpy(), lens)
    np.testing.assert_array_equal(got[0].numpy(), seqs)
    np.testing.assert_allclose(got[2].numpy(), scores, rtol=1e-5)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_batched_search_matches_jax_no_lm(seed):
    probs, lengths = random_batch(seed)
    assert_batched_matches_jax(probs, lengths, beam_width=8, max_len=16)


@pytest.mark.parametrize("seed", range(4))
def test_batched_search_matches_jax_with_lm(lm_table, seed):
    probs, lengths = random_batch(seed + 10, b=3, t=10, c=3)
    assert_batched_matches_jax(probs, lengths, beam_width=6, max_len=12,
                               lm_table=lm_table, lm_alpha=0.2)


@pytest.mark.parametrize("seed,b,t,c,width,alpha", [
    # merge-heavy: tiny alphabet, peaked frames, many repeats
    (0, 3, 60, 4, 16, 0.3),
    (1, 3, 60, 4, 16, 0.3),
    (2, 2, 80, 6, 24, 0.5),
    (3, 2, 120, 8, 12, 0.2),
    # wide alphabet
    (4, 2, 50, 40, 8, 0.4),
])
def test_batched_search_matches_jax_peaked(seed, b, t, c, width, alpha):
    probs, lengths = random_batch(seed, b, t, c, alpha)
    got = assert_batched_matches_jax(probs, lengths, beam_width=width,
                                     max_len=t + 2)
    # and the dict algorithm, as the JAX package's test holds its search
    for i in range(b):
        y, _ = ctc_beam_search(probs[i], width, length=int(lengths[i]))
        assert tuple(got[0][i, :got[1][i]].tolist()) == y


@pytest.mark.parametrize("seed,c,width,alpha,with_lm", [
    (20, 5, 8, 1.0, False), (21, 8, 12, 0.3, False), (22, 3, 6, 0.5, True),
])
def test_batched_search_in_float64_matches_the_host_search(
        lm_table, seed, c, width, alpha, with_lm):
    """Float64 probabilities make the batched search run in float64, the
    host search's precision (its float32 inputs summed in double): the same
    tokens, scores to 1e-7 (the host search takes ``lm_alpha`` as a
    float32)."""
    probs, lengths = random_batch(seed, b=3, t=40, c=c, alpha=alpha)
    table = lm_table if with_lm else None
    lm_alpha = 0.2 if with_lm else 0.0
    seqs, lens, scores = batched_beam_search(
        torch.from_numpy(probs).double(), torch.from_numpy(lengths),
        beam_width=width, max_len=42,
        lm_table=None if table is None else torch.from_numpy(table),
        lm_alpha=lm_alpha)
    assert scores.dtype == torch.float64
    for i in range(probs.shape[0]):
        y, s = native.ctc_beam_search_native(probs[i], width, table, lm_alpha,
                                             0, int(lengths[i]))
        assert tuple(seqs[i, :lens[i]].tolist()) == y
        np.testing.assert_allclose(float(scores[i]), s, rtol=1e-7)


def test_batched_search_matches_jax_when_max_len_truncates(lm_table):
    probs, lengths = random_batch(6, b=4, t=40, c=3, alpha=0.3)
    seqs, lens, _ = assert_batched_matches_jax(
        probs, lengths, beam_width=6, max_len=3, lm_table=lm_table,
        lm_alpha=0.2)
    assert (lens == 3).any()


def test_batched_search_ties_and_zero_probabilities_match_jax():
    """Frames drawn from a few fixed rows: equal probabilities give equal
    extension scores, so the top K is decided among exact ties (index
    order), and zero probabilities log to -inf in float32."""
    rows = np.array([[0.4, 0.2, 0.2, 0.2], [0.1, 0.3, 0.3, 0.3],
                     [0.5, 0.5, 0.0, 0.0], [0.25, 0.25, 0.25, 0.25],
                     [0.05, 0.0, 0.95, 0.0]], np.float32)
    rng = np.random.RandomState(7)
    probs = rows[rng.randint(0, len(rows), (4, 24))]
    lengths = np.array([24, 20, 13, 1], np.int32)
    for width in (3, 5, 16):
        assert_batched_matches_jax(probs, lengths, beam_width=width,
                                   max_len=26)


def step_state(rows, k, max_len):
    """A beam state from ``rows`` of (prefix, pr_blank, pr_nonblank); the
    other beams are invalid."""
    prefixes = np.zeros((k, max_len), np.int32)
    lengths = np.zeros(k, np.int32)
    pr_b = np.full(k, NEG, np.float32)
    pr_nb = np.full(k, NEG, np.float32)
    valid = np.zeros(k, bool)
    for i, (prefix, b, nb) in enumerate(rows):
        prefixes[i, :len(prefix)] = prefix
        lengths[i], pr_b[i], pr_nb[i], valid[i] = len(prefix), b, nb, True
    return prefixes, lengths, pr_b, pr_nb, valid


def test_one_step_with_colliding_merge_rows_matches_jax():
    """Beam 2, ``(3, 2)``, has no parent in the beam, so its merge row
    points at ``(0, 2)``, the real pair of beam 1 (``(2,)``, child of the
    empty beam 0): the extension of beam 0 by 2 must still be merged into
    beam 1's copy and leave the pool.  Equal probabilities add ties."""
    k, max_len, c = 5, 4, 4
    states = [
        step_state([((), -1.0, NEG), ((2,), -2.0, -1.5), ((3, 2), -3.0, -2.5)],
                   k, max_len),
        step_state([((), -0.5, NEG), ((1,), -1.0, -1.0), ((1, 1), -2.0, -2.0),
                    ((2,), -1.0, -1.0)], k, max_len),
    ]
    frames = [(np.array([0.25, 0.25, 0.25, 0.25], np.float32),
               np.array([0.95, 0.05, 0.0, 0.0], np.float32)),
              (np.array([0.4, 0.0, 0.3, 0.3], np.float32),
               np.array([0.5, 0.2, 0.2, 0.1], np.float32))]
    for probs_t, probs_prev in frames:
        want = [jax_beam_step(
            tuple(jnp.asarray(x) for x in s),
            (jnp.asarray(probs_t), jnp.asarray(probs_prev), jnp.asarray(True)),
            k_width=k, num_class=c, max_len=max_len, blank=0, lm_table=None,
            lm_alpha=0.0)[0] for s in states]
        stacked = tuple(torch.from_numpy(np.stack(x)) for x in zip(*states))
        stacked = (stacked[0].long(), stacked[1].long()) + stacked[2:]
        got = _beam_step(
            stacked, torch.from_numpy(np.stack([probs_t] * 2)),
            torch.from_numpy(np.stack([probs_prev] * 2)),
            torch.tensor([True, True]), num_class=c, max_len=max_len,
            blank=0, lm_table=None, lm_alpha=0.0)
        for i, w in enumerate(want):
            for g, x in zip(got, w):
                np.testing.assert_allclose(g[i].numpy(), np.asarray(x),
                                           rtol=1e-6)
        # the merged extension (beam 0 + label 2) is not a beam of its own
        prefixes, lengths = got[0][0], got[1][0]
        beams = [tuple(prefixes[j, :lengths[j]].tolist())
                 for j in range(k) if got[4][0, j]]
        assert len(beams) == len(set(beams))


def test_native_search_rejects_what_it_would_read_out_of_bounds():
    probs = np.full((4, 3), 1 / 3, np.float32)
    with pytest.raises(ValueError, match="blank"):
        native.ctc_beam_search_native(probs, 4, blank=3)
    with pytest.raises(ValueError, match="lm_table"):
        native.ctc_beam_search_native(probs, 4, np.zeros((3, 3), np.float32))


def test_batched_search_blank_skip_and_last_blank():
    # a blank that is the LAST class
    mat = np.array([[[0.4, 0.0, 0.6], [0.4, 0.0, 0.6]]], np.float32)
    seqs, lens, _ = batched_beam_search(torch.from_numpy(mat),
                                        torch.tensor([2]), beam_width=10,
                                        max_len=4, blank=2)
    assert tuple(seqs[0, :lens[0]].tolist()) == (0,)
    # a frame with p(blank) > 0.9 does not change the result
    probs = np.array([[[0.95, 0.05], [0.2, 0.8]]], np.float32)
    s1, l1, _ = batched_beam_search(torch.from_numpy(probs), torch.tensor([2]),
                                    beam_width=4, max_len=4)
    s2, l2, _ = batched_beam_search(torch.from_numpy(probs[:, 1:]),
                                    torch.tensor([1]), beam_width=4, max_len=4)
    assert s1[0, :l1[0]].tolist() == s2[0, :l2[0]].tolist() == [1]


# ---------------------------------------------------------------------------
# BeamDecoder
# ---------------------------------------------------------------------------

@pytest.fixture
def decoders(tmp_path):
    path = tmp_path / "lm.arpa"
    units = ["aa", "bb", "cc", "dd"]
    rng = np.random.RandomState(8)
    train_bigram_lm([" ".join(rng.choice(units, 6)) for _ in range(20)], path)
    int2char = {0: "blank", 1: "UNK", **{i + 2: u for i, u in enumerate(units)}}
    kw = dict(beam_width=5, lm_path=str(path), lm_alpha=0.3)
    return BeamDecoder(int2char, **kw), JBeamDecoder(int2char, **kw)


def log_probs(seed, t=20, b=3, c=6):
    probs, _ = random_batch(seed, b, t, c, alpha=0.5)
    return np.log(probs).transpose(1, 0, 2), np.array([t, t - 5, 3], np.int32)


@pytest.mark.parametrize("use_native", [True, False])
def test_beam_decoder_strings_match_jax(decoders, use_native):
    dec, jdec = decoders
    np.testing.assert_array_equal(dec.lm_table, jdec.lm_table)
    lp, lens = log_probs(0)
    want = jdec.decode(lp, lens, use_native=use_native)
    got = dec.decode(torch.from_numpy(lp), torch.from_numpy(lens),
                     use_native=use_native)
    assert got == want and max(len(s.split()) for s in got) > 1
    assert not any(s.startswith(" ") for s in got)  # the beam join quirk


def test_beam_decoder_on_device_strings_match_jax(decoders):
    dec, jdec = decoders
    lp, lens = log_probs(1)
    want = jdec.decode_on_device(lp, lens, max_len=12)
    got = dec.decode_on_device(torch.from_numpy(lp), torch.from_numpy(lens),
                               max_len=12)
    assert got == want and max(len(s.split()) for s in got) > 1
    assert got == dec.decode(torch.from_numpy(lp), lens)  # host and device


def test_decode_on_device_warns_when_a_hypothesis_fills_max_len(caplog):
    dec = BeamDecoder(INT2CHAR, beam_width=4)
    # alternating strong labels force a hypothesis longer than max_len=2
    probs = np.tile(
        np.array([[0.05, 0.9, 0.05], [0.05, 0.05, 0.9]], np.float32), (4, 1)
    )[None]  # (1, 8, 3)
    lp = torch.from_numpy(np.log(probs).transpose(1, 0, 2))
    with caplog.at_level(logging.WARNING):
        out = dec.decode_on_device(lp, torch.tensor([8]), max_len=2)
    assert out == ["aa bb"]
    assert any("max_len=2" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# the native build: no silent fallback, safe when processes race
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_native(tmp_path, monkeypatch):
    """``native`` building into ``tmp_path`` from a source there."""
    src = tmp_path / "ctc_native.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    return src


def test_a_failed_native_build_raises_and_numpy_runs_only_when_asked(
        fresh_native, decoders, monkeypatch):
    fresh_native.write_text("this is not C++\n")
    dec, _ = decoders
    lp, lens = log_probs(2)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error: "):
        dec.decode(lp, lens)
    with monkeypatch.context() as m:
        m.setattr(native, "CXX", "/nonexistent/g++")
        with pytest.raises(RuntimeError, match="cannot run"):
            native.build()
    assert dec.decode(lp, lens, use_native=False)  # the caller's choice
    assert not list((fresh_native.parent / "build").glob("*.so"))


def test_concurrent_native_builds_each_load_a_whole_library(fresh_native):
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except RuntimeError as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads) and not errors
    assert len(set(paths)) == 1 and paths[0] == native.library_path()
    built = list(native.BUILD_DIR.iterdir())
    assert built == [paths[0]]  # no temporary file left behind
    y, _ = native.ctc_beam_search_native(
        np.array([[0.1, 0.9], [0.1, 0.9]], np.float32), 4)
    assert y == (1,)
