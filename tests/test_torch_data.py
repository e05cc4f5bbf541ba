"""The port's copies of the host-side data path give what the JAX package
gives: the same items, the same batch streams for one seed, the same
config and vocab."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from ctc_pytorch_tpu.config import load_config as jax_load_config
from ctc_pytorch_tpu.data.batching import SpeechDataLoader as JLoader
from ctc_pytorch_tpu.data.dataset import SpeechDataset as JDataset
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.config import Config, load_config
from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset
from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter
from ctc_pytorch_tpu_torch.vocab import Vocab

ROOT = Path(__file__).resolve().parent.parent


def write_corpus(root: Path, n_utts=13, dim=5, units=("a", "b", "c", "d"),
                 seed=0, frames=(9, 40)):
    """Tiny TIMIT-layout set: ark/scp features, phn_text, units."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "units").write_text("".join(u + "\n" for u in units))
    lines = []
    with ArkWriter(root / "f.ark", root / "f.scp") as w:
        for i in range(n_utts):
            w.write(f"u{i:02d}", rng.randn(rng.randint(*frames), dim)
                    .astype(np.float32))
            # one OOV unit in the first transcript (-> UNK)
            labs = list(rng.choice(units, 1 + rng.randint(5)))
            lines.append(f"u{i:02d} " + " ".join(labs + (["zz"] if i == 0 else [])))
    (root / "lab").write_text("\n".join(lines) + "\n")


def _cfg(cls, dim=5, right_ctx=2, skip=2, down=2):
    cfg = cls()
    cfg.left_ctx, cfg.right_ctx = 1, right_ctx
    cfg.n_skip_frame, cfg.n_downsample = skip, down
    cfg.feature_dim = dim
    return cfg


@pytest.mark.parametrize("skip,down", [(2, 2), (1, 1), (3, 4)])
def test_dataset_items_match_jax(tmp_path, skip, down):
    write_corpus(tmp_path)
    from ctc_pytorch_tpu.config import Config as JConfig

    ours = SpeechDataset(Vocab(tmp_path / "units"), tmp_path / "f.scp",
                         tmp_path / "lab", _cfg(Config, skip=skip, down=down))
    ref = JDataset(JVocab(tmp_path / "units"), tmp_path / "f.scp",
                   tmp_path / "lab", _cfg(JConfig, skip=skip, down=down))
    np.testing.assert_array_equal(ours.lengths(), ref.lengths())
    np.testing.assert_array_equal(ours.label_lengths(), ref.label_lengths())
    for i in range(len(ref)):
        f, lab, utt = ours[i]
        rf, rlab, rutt = ref[i]
        assert utt == rutt and f.dtype == np.float32
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(lab, rlab)
    assert ours[0][1][-1] == 1  # OOV -> UNK


@pytest.mark.parametrize("mode,num_buckets,shuffle", [
    ("quantized", 3, True), ("quantized", 3, False), ("bucket", 2, True),
    ("quantized", 0, True),
])
def test_batch_streams_match_jax(tmp_path, mode, num_buckets, shuffle):
    write_corpus(tmp_path)
    from ctc_pytorch_tpu.config import Config as JConfig

    ds = SpeechDataset(Vocab(tmp_path / "units"), tmp_path / "f.scp",
                       tmp_path / "lab", _cfg(Config))
    jds = JDataset(JVocab(tmp_path / "units"), tmp_path / "f.scp",
                   tmp_path / "lab", _cfg(JConfig))
    kw = dict(shuffle=shuffle, num_buckets=num_buckets, seed=5, mode=mode)
    ours, ref = SpeechDataLoader(ds, 4, **kw), JLoader(jds, 4, **kw)
    assert len(ours) == len(ref)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for field in dataclasses.fields(b):
                va, vb = getattr(a, field.name), getattr(b, field.name)
                if isinstance(vb, np.ndarray):
                    assert va.dtype == vb.dtype
                    np.testing.assert_array_equal(va, vb)
                else:
                    assert va == vb


def test_waveform_and_mel_raise(tmp_path):
    """``feature_type: waveform`` and ``mel: True`` no longer raise: their
    items and lengths are the JAX dataset's (F_Mel-warped processed
    features; raw (S, 1) samples of SPHERE and WAV files with sample
    counts from the headers)."""
    from ctc_pytorch_tpu.config import Config as JConfig
    from tests.test_torch_waveform import audio_corpus

    # F_Mel reads bins up to sample_rate/2 x 25 ms = 200: 201-d spectra
    write_corpus(tmp_path, n_utts=5, dim=201)
    audio_corpus(tmp_path / "audio", (("train", 5),))
    for key, value, scp in (("mel", True, tmp_path / "f.scp"),
                            ("feature_type", "waveform",
                             tmp_path / "audio" / "train" / "wav.scp")):
        lab = tmp_path / ("lab" if key == "mel" else "audio/train/phn_text")
        units = tmp_path / ("units" if key == "mel" else "audio/units")
        cfg, jcfg = _cfg(Config), _cfg(JConfig)
        setattr(cfg, key, value)
        setattr(jcfg, key, value)
        ours = SpeechDataset(Vocab(units), scp, lab, cfg)
        ref = JDataset(JVocab(units), scp, lab, jcfg)
        np.testing.assert_array_equal(ours.lengths(), ref.lengths())
        for i in range(len(ref)):
            f, lab_ids, utt = ours[i]
            rf, rlab, rutt = ref[i]
            assert utt == rutt and f.dtype == np.float32
            np.testing.assert_allclose(f, rf, rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(lab_ids, rlab)
        if key == "feature_type":
            assert ours[0][0].shape == (ours.lengths()[0], 1)


@pytest.mark.parametrize("recipe", [
    "recipes/timit/ctc_config.yaml", "recipes/timit/mfcc_39_config.yaml",
    "recipes/timit/waveform_config.yaml", "recipes/my_863/cnn_lstm_ctc.conf",
])
def test_config_copy_loads_recipes_like_jax(recipe):
    assert load_config(ROOT / recipe).to_dict() == \
        jax_load_config(ROOT / recipe).to_dict()


def test_vocab_copy_matches_jax(tmp_path):
    (tmp_path / "units").write_text("w1 aa bb\ncc\naa\n")
    ours, ref = Vocab(tmp_path / "units"), JVocab(tmp_path / "units")
    assert ours.word2index == ref.word2index and ours.n_words == ref.n_words
    assert ours.encode("aa qq cc") == ref.encode("aa qq cc")
