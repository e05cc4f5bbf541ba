"""Feature-format converters and on-disk caching, host-only numpy: a copy
of ``ctc_pytorch_tpu/data/convert.py``.

Covers the 863 recipe's ingestion paths without h5py:

- text-format Kaldi feature dumps (``process_kaldi_feat``,
  ``my_863_corpus/steps/utils.py:75-97``) -> binary ark+scp, so the standard
  dataset path applies;
- an npz disk cache per dataset (the h5py ``train.h5py`` replacement,
  ``my_863_corpus/steps/data_loader.py:126-155``): first pass materialises
  processed features once; later runs load items lazily from the archive
  and keep them in memory (the reference's h5py path also ends up as an
  in-memory list).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter, read_text_ark


def text_ark_to_binary(
    text_path: str | Path,
    ark_out: str | Path,
    scp_out: str | Path,
    feat_size: Optional[int] = None,
) -> int:
    """Convert a text feature dump to binary ark+scp; returns utt count."""
    feats = read_text_ark(text_path, feat_size)
    with ArkWriter(ark_out, scp_out) as w:
        for utt, mat in feats.items():
            w.write(utt, mat)
    return len(feats)


def cache_dataset(dataset, cache_path: str | Path) -> Path:
    """Materialise every processed item of a SpeechDataset into one npz.

    Frame/label lengths are stored alongside so bucketing never has to
    decode the feature payloads just for shapes."""
    cache_path = Path(cache_path)
    arrays: Dict[str, np.ndarray] = {}
    utts = []
    lens, lab_lens = [], []
    for i in range(len(dataset)):
        feat, label, utt = dataset[i]
        arrays[f"f{i}"] = feat
        arrays[f"l{i}"] = label
        utts.append(utt)
        lens.append(feat.shape[0])
        lab_lens.append(label.shape[0])
    np.savez(cache_path, utts=np.array(utts), n=np.array(len(utts)),
             lens=np.asarray(lens), lab_lens=np.asarray(lab_lens), **arrays)
    return cache_path


class CachedDataset:
    """Dataset view over a cache npz; same item contract as SpeechDataset:
    (feat, label, utt).

    Items decode from the archive on first access and stay cached in
    memory — the same contract as the reference's h5py path, which loads
    ``train.h5py`` into an in-memory list
    (``my_863_corpus/steps/data_loader.py:141-155``).  Note ``np.load``
    does NOT memory-map npz members, so without this cache every epoch
    would re-read and decompress each matrix per access."""

    def __init__(self, cache_path: str | Path):
        self._z = np.load(Path(cache_path))
        self._n = int(self._z["n"])
        self._utts = [str(u) for u in self._z["utts"]]
        self._lengths = None
        self._items: list = [None] * self._n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int):
        if self._items[idx] is None:
            self._items[idx] = (
                np.asarray(self._z[f"f{idx}"]),
                np.asarray(self._z[f"l{idx}"]),
                self._utts[idx],
            )
        return self._items[idx]

    def lengths(self) -> np.ndarray:
        if self._lengths is None:
            if "lens" in self._z.files:
                self._lengths = np.asarray(self._z["lens"])
            else:  # caches written before lens were stored
                self._lengths = np.asarray(
                    [self._z[f"f{i}"].shape[0] for i in range(self._n)]
                )
        return self._lengths

    def label_lengths(self) -> np.ndarray:
        if "lab_lens" in self._z.files:
            return np.asarray(self._z["lab_lens"])
        return np.asarray(
            [self._z[f"l{i}"].shape[0] for i in range(self._n)]
        )
