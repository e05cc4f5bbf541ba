"""The port's bigram LM (``decode/ngram_lm.py``) and stage 3
(``cli/train_lm.py``) against the JAX package's: the same ARPA bytes from
the same transcripts, the same lookups and the same dense table."""

import numpy as np
import pytest

from ctc_pytorch_tpu.cli import train_lm as jax_train_lm
from ctc_pytorch_tpu.decode.ngram_lm import LanguageModel as JLanguageModel
from ctc_pytorch_tpu.decode.ngram_lm import train_bigram_lm as jax_train_bigram_lm
from ctc_pytorch_tpu_torch.cli import train_lm
from ctc_pytorch_tpu_torch.decode import LanguageModel, train_bigram_lm

UNITS = ["aa", "ae", "b", "ch", "d", "eh", "sil"]


def sentences(seed, n=40, units=UNITS):
    rng = np.random.RandomState(seed)
    out = [" ".join(rng.choice(units, rng.randint(1, 12))) for _ in range(n)]
    return out + ["", "  "]  # empty lines are skipped by both


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_bigram_lm_writes_the_jax_bytes(tmp_path, seed):
    sents = sentences(seed)
    jax_train_bigram_lm(sents, tmp_path / "jax.arpa")
    train_bigram_lm(sents, tmp_path / "port.arpa")
    assert ((tmp_path / "port.arpa").read_bytes()
            == (tmp_path / "jax.arpa").read_bytes())


def test_stage3_cli_writes_the_jax_bytes(tmp_path, capsys):
    (tmp_path / "train").mkdir()
    lines = [f"utt{i:03d} {s}" for i, s in enumerate(sentences(3))]
    lines.append("utt_no_units")  # an utterance id alone is skipped
    (tmp_path / "train" / "phn_text").write_text("\n".join(lines) + "\n")
    want = jax_train_lm.main([str(tmp_path), "--out", "jax.arpa"])
    got = train_lm.main([str(tmp_path)])
    assert got == tmp_path / "lm_phone_bg.arpa"
    assert got.read_bytes() == want.read_bytes()
    assert f"Write Arpa format language model to {got}" in capsys.readouterr().out


def test_lookups_and_dense_table_match_jax(tmp_path):
    # a unit the LM never saw (row and column stay -1e10) and UNK (<unk>)
    units = UNITS + ["zh"]
    train_bigram_lm(sentences(4), tmp_path / "lm.arpa")
    lm, jlm = LanguageModel(tmp_path / "lm.arpa"), JLanguageModel(tmp_path / "lm.arpa")
    assert lm.unigram == jlm.unigram and lm.bigram == jlm.bigram
    assert "UNK" in lm.unigram
    for w1 in ["", "<s>"] + UNITS:
        for w2 in UNITS + ["", "</s>"]:
            assert lm.get_bi_prob(w1, w2) == jlm.get_bi_prob(w1, w2)
    for s in sentences(5, n=5)[:5]:
        assert lm.score_bg(s) == jlm.score_bg(s)
    int2char = {0: "blank", 1: "UNK", **{i + 2: u for i, u in enumerate(units)}}
    table = lm.dense_table(int2char, len(int2char))
    want = jlm.dense_table(int2char, len(int2char))
    assert table.dtype == want.dtype == np.float32
    assert table.shape == (len(int2char) + 1,) * 2
    np.testing.assert_array_equal(table, want)
    assert (table[-1, :] > -1e9).sum() > 0  # <s> row
    assert (table[len(int2char) - 1] == -1e10).all()  # unseen unit "zh"
