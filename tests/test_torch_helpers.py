"""The port's public helpers against their JAX functions on the CPU, from
seeded numpy inputs: ``ctc_forward_score`` (an impossible alignment
included), the host edit distance (native and its numpy twin),
``GreedyDecoder.batch_errors`` (zero capacity included),
``phone_word_error`` (flat and padded targets), ``latest_checkpoint``,
``make_global_batch`` with a world of one (two gloo ranks are in
``tests/test_torch_parallel.py``) and ``encode_shorten``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.data.prep import shorten as jsh
from ctc_pytorch_tpu.decode.greedy import GreedyDecoder as JGreedy
from ctc_pytorch_tpu.decode.metrics import phone_word_error as jax_pwe
from ctc_pytorch_tpu.ops import batch_edit_distance as jax_batch_ed
from ctc_pytorch_tpu.ops import ctc_forward_score as jax_score
from ctc_pytorch_tpu.ops.editdistance import (
    _padded_edit_distance_numpy as jax_padded_numpy,
)
from ctc_pytorch_tpu.train.checkpoint import latest_checkpoint as jax_latest
from ctc_pytorch_tpu_torch import ops
from ctc_pytorch_tpu_torch.data.prep import shorten as sh
from ctc_pytorch_tpu_torch.decode.greedy import GreedyDecoder
from ctc_pytorch_tpu_torch.decode.metrics import phone_word_error
from ctc_pytorch_tpu_torch.ops.ctc_loss import NEG_INF, ctc_forward_score
from ctc_pytorch_tpu_torch.ops.editdistance import (
    padded_edit_distance,
    padded_edit_distance_plain,
)
from ctc_pytorch_tpu_torch.parallel import make_global_batch
from ctc_pytorch_tpu_torch.train.checkpoint import latest_checkpoint
from tests.test_shorten import _speechlike

UNITS = ["_", "aa", "b", "iy", "k", "s"]  # blank first


def log_probs(t, b, c, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, b, c).astype(np.float32) * 2
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


# ---------------------------------------------------------------------------
# ctc_forward_score
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,b,c,l", [(12, 4, 6, 4), (30, 3, 9, 8)])
def test_ctc_forward_score_matches_jax(t, b, c, l):
    rng = np.random.RandomState(t)
    lp = log_probs(t, b, c, seed=t + 1)
    labels = rng.randint(1, c, (b, l)).astype(np.int32)
    label_lens = rng.randint(1, l + 1, b).astype(np.int32)
    input_lens = np.full(b, t, np.int32)
    input_lens[-1] = t - 3
    want = np.asarray(jax_score(*(jnp.asarray(a) for a in (
        lp, labels, input_lens, label_lens))))
    x = torch.from_numpy(lp).requires_grad_()
    got = ctc_forward_score(x, torch.from_numpy(labels),
                            torch.from_numpy(input_lens),
                            torch.from_numpy(label_lens))
    assert got.dtype == torch.float32 and got.shape == (b,)
    assert not got.requires_grad  # no gradient, as the JAX score
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert ops.ctc_forward_score is ctc_forward_score


def test_ctc_forward_score_of_an_impossible_alignment_is_neg_inf():
    """Labels that need more frames than the utterance has (a repeat needs
    a blank between): exactly the JAX score, ``NEG_INF`` (-1e30), not some
    other large finite number; the possible row is scored as in JAX."""
    lp = log_probs(4, 3, 5, seed=0)
    labels = np.array([[1, 2, 3], [1, 1, 0], [2, 2, 2]], np.int32)
    input_lens = np.array([4, 2, 4], np.int32)
    label_lens = np.array([3, 2, 3], np.int32)
    want = np.asarray(jax_score(*(jnp.asarray(a) for a in (
        lp, labels, input_lens, label_lens))))
    got = ctc_forward_score(*(torch.from_numpy(a) for a in (
        lp, labels, input_lens, label_lens))).numpy()
    assert got[1] == want[1] == np.float32(NEG_INF)
    assert got[2] == want[2] == np.float32(NEG_INF)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


# ---------------------------------------------------------------------------
# host edit distance
# ---------------------------------------------------------------------------

def padded_pairs(seed, b=9, n=7, m=9, vocab=4):
    rng = np.random.RandomState(seed)
    refs = rng.randint(0, vocab, (b, n)).astype(np.int32)
    hyps = rng.randint(0, vocab, (b, m)).astype(np.int32)
    ref_lens = rng.randint(0, n + 1, b).astype(np.int32)
    hyp_lens = rng.randint(0, m + 1, b).astype(np.int32)
    ref_lens[0], hyp_lens[1] = 0, 0  # empty sides
    return refs, ref_lens, hyps, hyp_lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_padded_edit_distance_native_matches_numpy_and_jax(seed):
    refs, ref_lens, hyps, hyp_lens = padded_pairs(seed)
    got = padded_edit_distance(refs, ref_lens, hyps, hyp_lens)
    plain = padded_edit_distance_plain(refs, ref_lens, hyps, hyp_lens)
    assert got.dtype == np.int64 and got.shape == (len(refs),)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(
        got, jax_padded_numpy(refs, ref_lens, hyps, hyp_lens))
    pairs = ([r[:n] for r, n in zip(refs, ref_lens)],
             [h[:m] for h, m in zip(hyps, hyp_lens)])
    np.testing.assert_array_equal(got, ops.batch_edit_distance(*pairs))
    np.testing.assert_array_equal(got, jax_batch_ed(*pairs))


def test_padded_edit_distance_clamps_lengths_past_the_padding():
    refs, ref_lens, hyps, hyp_lens = padded_pairs(3, b=4)
    ref_lens[2], hyp_lens[3] = 50, 60
    np.testing.assert_array_equal(
        padded_edit_distance(refs, ref_lens, hyps, hyp_lens),
        padded_edit_distance_plain(refs, ref_lens, hyps, hyp_lens))
    with pytest.raises(ValueError, match="batch sizes differ"):
        padded_edit_distance(refs, ref_lens, hyps[:3], hyp_lens)


# ---------------------------------------------------------------------------
# greedy batch errors and phone_word_error
# ---------------------------------------------------------------------------

def decode_case(t, seed, b=5, l=6):
    rng = np.random.RandomState(seed)
    lp = log_probs(t, b, len(UNITS), seed)
    frames = np.array([t, max(t - 2, 0), min(5, t), 0, t][:b], np.int32)
    targets = rng.randint(1, len(UNITS), (b, l)).astype(np.int32)
    sizes = np.array([6, 4, 1, 3, 0][:b], np.int32)
    return lp, frames, targets, sizes


@pytest.mark.parametrize("t", [14, 0])
def test_batch_errors_match_jax(t):
    """Greedy token errors and target tokens; T' = 0 is the zero-capacity
    branch (every target token a deletion)."""
    lp, frames, targets, sizes = decode_case(t, seed=t + 3)
    want = JGreedy(UNITS).batch_errors(jnp.asarray(lp), jnp.asarray(frames),
                                       targets, sizes)
    got = GreedyDecoder(UNITS).batch_errors(
        torch.from_numpy(lp), torch.from_numpy(frames),
        torch.from_numpy(targets), sizes)
    assert got == want and all(isinstance(v, int) for v in got)
    if t == 0:
        assert got == (int(sizes.sum()), int(sizes.sum()))


@pytest.mark.parametrize("flat", [False, True])
def test_phone_word_error_matches_jax(flat):
    lp, frames, targets, sizes = decode_case(20, seed=8)
    if flat:  # the 863 / warp-ctc convention: one 1-D array and sizes
        targets = np.concatenate([r[:s] for r, s in zip(targets, sizes)])
    dec, jdec = GreedyDecoder(UNITS), JGreedy(UNITS)
    for _ in range(2):  # the normalisers accumulate over calls
        got = phone_word_error(dec, torch.from_numpy(lp),
                               torch.from_numpy(frames),
                               torch.from_numpy(targets), sizes)
        want = jax_pwe(jdec, jnp.asarray(lp), jnp.asarray(frames), targets,
                       sizes)
        assert got == want
    assert (dec.scorer.num_word, dec.scorer.num_char) == (
        jdec.scorer.num_word, jdec.scorer.num_char)
    assert dec.scorer.num_word > 0


# ---------------------------------------------------------------------------
# latest_checkpoint, make_global_batch, encode_shorten
# ---------------------------------------------------------------------------

def test_latest_checkpoint_matches_jax(tmp_path):
    assert latest_checkpoint(tmp_path) is None is jax_latest(tmp_path)
    for name in ("resume_ep0002.npz", "resume_ep0010.npz",
                 "resume_ep0009.npz", "ctc_best_model.npz", "resume.txt"):
        (tmp_path / name).write_bytes(b"")
    got = latest_checkpoint(tmp_path)
    assert got == jax_latest(tmp_path) == tmp_path / "resume_ep0010.npz"
    assert (latest_checkpoint(str(tmp_path), "ctc_*.npz")
            == jax_latest(tmp_path, "ctc_*.npz"))


def test_make_global_batch_of_a_world_of_one():
    rng = np.random.RandomState(0)
    arrays = (rng.randn(4, 3).astype(np.float32),
              rng.randint(0, 5, (4, 2)).astype(np.int32),
              torch.arange(4))
    got = make_global_batch(arrays, None, "cpu")
    assert len(got) == 3 and all(isinstance(t, torch.Tensor) for t in got)
    for t, a in zip(got, arrays):
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    assert got[1].dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_global_batch(arrays, None)  # the card by default


@pytest.mark.parametrize("ftype,nmean,blocksize,n", [
    (sh.TYPE_S16LH, 0, 256, 3001), (sh.TYPE_S16HL, 4, 100, 2345),
    (sh.TYPE_U16LH, 0, 128, 999), (sh.TYPE_S16LH, 4, 256, 0)])
def test_encode_shorten_is_byte_equal_to_jax(ftype, nmean, blocksize, n):
    x = _speechlike(n, seed=n + nmean)
    enc = sh.encode_shorten(x, ftype=ftype, blocksize=blocksize, nmean=nmean)
    assert enc == jsh.encode_shorten(x, ftype=ftype, blocksize=blocksize,
                                     nmean=nmean)
    np.testing.assert_array_equal(sh.decode_shorten(enc)[0],
                                  x.astype(np.int32))
    with pytest.raises(ValueError, match="v2 streams only"):
        sh.encode_shorten(x, version=1)
