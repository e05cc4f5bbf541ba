"""The port's ``data/convert.py`` (the 863 ingestion path) against the JAX
package's on the CPU: a text-format Kaldi dump converts to byte-equal
binary ark and scp files, and the npz dataset cache (``cache_dataset``,
``CachedDataset``) gives ``SpeechDataset``'s items and lengths, and the
JAX cache's."""

import numpy as np
import pytest

from ctc_pytorch_tpu.data.convert import CachedDataset as JCachedDataset
from ctc_pytorch_tpu.data.convert import text_ark_to_binary as jax_text_ark_to_binary
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.data import SpeechDataset
from ctc_pytorch_tpu_torch.data.convert import (
    CachedDataset,
    cache_dataset,
    text_ark_to_binary,
)
from ctc_pytorch_tpu_torch.data.kaldi_io import load_mat, read_scp, read_text_ark
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_cuda import chip_smoke

UNITS = [f"u{i:02d}" for i in range(9)]


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    root = tmp_path_factory.mktemp("dump")
    text = chip_smoke.write_text_corpus(root, "train", 6, seed=3, dim=40,
                                        units=UNITS, feats="fbank",
                                        frames=(20, 61))
    return root, text


@pytest.mark.parametrize("feat_size", [None, 24])
def test_text_dump_converts_to_the_jax_bytes(dump, tmp_path, feat_size):
    root, text = dump
    n = text_ark_to_binary(text, tmp_path / "p.ark", tmp_path / "p.scp",
                           feat_size)
    jn = jax_text_ark_to_binary(text, tmp_path / "j.ark", tmp_path / "j.scp",
                                feat_size)
    assert n == jn == 6
    assert (tmp_path / "p.ark").read_bytes() == (tmp_path / "j.ark").read_bytes()
    scp = (tmp_path / "p.scp").read_text()
    assert scp == (tmp_path / "j.scp").read_text().replace("j.ark", "p.ark")
    mats = read_text_ark(text)
    for utt, rx in read_scp(tmp_path / "p.scp"):
        want = mats[utt][:, :feat_size] if feat_size else mats[utt]
        assert want.shape[1] == (feat_size or 40)
        np.testing.assert_array_equal(load_mat(rx), want)


def test_cached_dataset_gives_the_speech_dataset_items(dump, tmp_path):
    root, text = dump
    text_ark_to_binary(text, root / "train" / "fbank.ark",
                       root / "train" / "fbank.scp")
    cfg = Config()
    cfg.left_ctx, cfg.right_ctx, cfg.n_skip_frame, cfg.n_downsample = 0, 1, 2, 2
    ds = SpeechDataset(Vocab(str(root / "units")), root / "train" / "fbank.scp",
                       root / "train" / "text", cfg)
    path = cache_dataset(ds, tmp_path / "cache.npz")
    for cached in (CachedDataset(path), JCachedDataset(path)):
        assert len(cached) == len(ds) == 6
        for i in range(len(ds)):
            for got, want in zip(cached[i][:2], ds[i][:2]):
                np.testing.assert_array_equal(got, want)
            assert cached[i][2] == ds[i][2]
        np.testing.assert_array_equal(cached.lengths(), ds.lengths())
        np.testing.assert_array_equal(cached.label_lengths(),
                                      ds.label_lengths())
