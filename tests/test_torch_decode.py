"""Greedy and beam decoding, scoring and stage 4 of the port against the JAX
package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.cli import train_lm as jax_train_lm
from ctc_pytorch_tpu.cli.test import evaluate as jax_evaluate
from ctc_pytorch_tpu.config import CNNConfig as JCNNConfig
from ctc_pytorch_tpu.config import Config as JConfig
from ctc_pytorch_tpu.decode.greedy import GreedyDecoder as JGreedy
from ctc_pytorch_tpu.decode.greedy import greedy_collapse as jax_collapse
from ctc_pytorch_tpu.decode.metrics import Scorer as JScorer
from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
from ctc_pytorch_tpu.ops.editdistance import edit_distance as jax_edit_distance
from ctc_pytorch_tpu.train.checkpoint import save_package as jax_save_package
from ctc_pytorch_tpu.train.state import TrainState
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.cli import train_lm
from ctc_pytorch_tpu_torch.cli.test import evaluate
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.decode.greedy import GreedyDecoder, greedy_collapse
from ctc_pytorch_tpu_torch.decode.metrics import Scorer
from ctc_pytorch_tpu_torch.ops.editdistance import edit_distance
from tests.test_torch_data import write_corpus
from tests.test_torch_model import RECIPE_VARIANTS, jax_weights, variant_cell


def _indices(seed, b=5, t=17, c=4):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, c, (b, t)).astype(np.int32)
    idx[:, 3:6] = 2  # repeats
    idx[0, 7:9] = 0  # blanks between repeats
    lengths = np.array([t, t - 1, 5, 0, 1][:b], np.int32)
    return idx, lengths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_collapse_matches_jax(seed):
    idx, lengths = _indices(seed)
    want_tok, want_len = jax_collapse(jnp.asarray(idx), jnp.asarray(lengths))
    got_tok, got_len = greedy_collapse(torch.from_numpy(idx),
                                       torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))


def test_greedy_decoder_strings_match_jax():
    int2char = {0: "blank", 1: "UNK", 2: "aa", 3: "bb", 4: "cc"}
    rng = np.random.RandomState(3)
    lp = rng.randn(12, 4, 5).astype(np.float32)
    lengths = np.array([12, 7, 3, 0], np.int32)
    want = JGreedy(int2char).decode(lp, lengths)
    got = GreedyDecoder(int2char).decode(torch.from_numpy(lp),
                                         torch.from_numpy(lengths))
    assert got == want


def test_scorer_and_edit_distance_match_jax():
    int2char = {0: "blank", 1: "UNK", 2: "aa", 3: "bb", 4: "cc"}
    ours, ref = Scorer(int2char), JScorer(int2char)
    rng = np.random.RandomState(4)
    for _ in range(20):
        a = list(rng.randint(0, 5, rng.randint(0, 9)))
        b = list(rng.randint(0, 5, rng.randint(0, 9)))
        assert edit_distance(a, b) == jax_edit_distance(a, b)
        sa, sb = ours.to_string(a, remove_rep=True), ours.to_string(b)
        assert sa == ref.to_string(a, remove_rep=True)
        assert ours.cer(sa, sb) == ref.cer(sa, sb)
        assert ours.wer(sa, sb) == ref.wer(sa, sb)


def _stage4_setup(tmp_path, add_cnn, cell="lstm", bidirectional=True,
                  fc_scale=10.0):
    dim = 7
    write_corpus(tmp_path / "data", n_utts=11, dim=dim, frames=(12, 40))
    cnn = (JCNNConfig(add_cnn=True, layers=2, channel=[(1, 2), (2, 2)],
                      kernel_size=[(3, 3), (3, 3)], stride=[(1, 2), (2, 2)],
                      padding=[(1, 1), (1, 1)])
           if add_cnn else JCNNConfig(add_cnn=False))
    jspec = JSpec(add_cnn=add_cnn, cnn=cnn, rnn_input_size=dim * 2,
                  rnn_hidden_size=8, rnn_layers=2, rnn_cell=cell,
                  bidirectional=bidirectional, batch_norm=True,
                  num_class=JVocab(tmp_path / "data" / "units").n_words,
                  drop_out=0.0, compute_dtype="float32")
    # a sharp output layer: near-flat random posteriors would let a 1e-7
    # difference between frameworks flip an argmax
    params, state = jax_weights(jspec, seed=1, fc_scale=fc_scale)
    pkg = tmp_path / "pkg.npz"
    jax_save_package(pkg, jspec,
                     TrainState(jnp.zeros((), jnp.int32), params, state, ()))
    confs = []
    for cls in (JConfig, Config):
        cfg = cls()
        cfg.feature_dim = dim
        cfg.left_ctx, cfg.right_ctx = 0, 1
        cfg.n_skip_frame, cfg.n_downsample = 1, 2
        cfg.batch_size, cfg.num_buckets, cfg.num_workers = 4, 2, 1
        cfg.vocab_file = str(tmp_path / "data" / "units")
        cfg.test_scp_path = str(tmp_path / "data" / "f.scp")
        cfg.test_lab_path = str(tmp_path / "data" / "lab")
        confs.append(cfg)
    return pkg, confs


@pytest.mark.parametrize("add_cnn", [True, False])
def test_evaluate_on_cpu_matches_jax_evaluate(tmp_path, add_cnn):
    evaluate_matches_jax(*_stage4_setup(tmp_path, add_cnn))


@pytest.mark.parametrize("variant", sorted(RECIPE_VARIANTS))
def test_recipe_variant_evaluate_decodes_the_jax_strings(tmp_path, variant):
    """A JAX package of the tanh-cell or the one-direction model decodes to
    the JAX strings through the port's stage 4."""
    cell, bidir = variant_cell(variant)
    evaluate_matches_jax(*_stage4_setup(tmp_path, True, cell, bidir))


def evaluate_matches_jax(pkg, confs, decode_type="Greedy"):
    """The port's ``evaluate(device="cpu")`` and the JAX ``evaluate`` of one
    package over the 11-utterance test set with ``decode_type``: the same
    strings, CER and WER, and the same printed lines.  The fused and the
    streaming paths print the utterances in other orders, so the lines are
    compared per utterance."""
    jcfg, cfg = confs
    for c in confs:
        c.decode_type = decode_type
    want_lines, got_lines = [], []
    want = jax_evaluate(jcfg, str(pkg), log=want_lines.append)
    got = evaluate(cfg, str(pkg), device="cpu", log=got_lines.append)

    def decoded(lines):
        pairs = zip(lines[::3], lines[2::3])
        return {u: d for u, d in pairs if d.startswith("decoded: ")}

    def utterances(lines):
        return {tuple(lines[i:i + 3]) for i in range(0, len(lines), 3)}

    got_lines = [ln for ln in got_lines if not ln.startswith("fused_decode")]
    n = 3 * 11  # utt / origin / decoded per utterance
    assert decoded(got_lines[:n]) == decoded(want_lines[:n])
    assert utterances(got_lines[:n]) == utterances(want_lines[:n])
    assert len(decoded(got_lines[:n])) == 11
    assert any(len(d.split()) > 1 for d in decoded(got_lines[:n]).values())
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]
    assert got_lines[n:n + 2] == want_lines[n:n + 2]  # CER / WER lines
    return got, got_lines[:n]


def _beam_setup(tmp_path, fused):
    """``_stage4_setup`` with a bigram LM made by both packages' stage 3
    from the test transcripts (which must write the same bytes), the JAX
    package's under the name the configs read.  A softer output layer than
    the greedy tests' leaves the search more than one label to keep."""
    pkg, confs = _stage4_setup(tmp_path, add_cnn=True, fc_scale=0.5)
    data = tmp_path / "data"
    jax_train_lm.main([str(data), "--text", "lab", "--out", "lm_jax.arpa"])
    train_lm.main([str(data), "--text", "lab", "--out", "lm.arpa"])
    assert (data / "lm.arpa").read_bytes() == (data / "lm_jax.arpa").read_bytes()
    for c in confs:
        c.lm_path = str(data / "lm_jax.arpa")
        c.lm_alpha = 0.5
        c.beam_width = 8
        c.fused_decode = fused
    return pkg, confs


@pytest.mark.parametrize("decode_type,fused", [
    ("Beam", True),  # streams from the host whatever fused_decode says
    ("BeamDevice", True),
    ("BeamDevice", False),
])
def test_beam_evaluate_on_cpu_matches_jax_evaluate(tmp_path, decode_type,
                                                   fused):
    """Stage 4 with the beam decoders and an LM from stage 3: the port's
    strings, scores and lines are the JAX package's.  The port takes the
    fused path for ``BeamDevice`` with ``fused_decode`` and streams
    otherwise; the JAX package, which sees the tests' eight virtual CPU
    devices, streams ``BeamDevice`` sharded over a mesh (its fused group
    decoder is held in ``tests/test_torch_fused_decode.py``).  Beam strings
    have no leading space."""
    pkg, confs = _beam_setup(tmp_path, fused)
    got, lines = evaluate_matches_jax(pkg, confs, decode_type)
    assert bool(got.get("fused")) == (decode_type == "BeamDevice" and fused)
    hyps = [ln[len("decoded: "):] for ln in lines[2::3]]
    assert all(not h.startswith(" ") for h in hyps)
    assert max(len(h.split()) for h in hyps) >= 3


def test_evaluate_rejects_an_unknown_decoder(tmp_path):
    pkg, (_, cfg) = _stage4_setup(tmp_path, add_cnn=False)
    cfg.decode_type = "beam"
    with pytest.raises(ValueError, match="unknown decode_type"):
        evaluate(cfg, str(pkg), device="cpu")
