"""The one traffic generator: a mix's parameters and a seed -> a corpus.

A mix (``traffic/<mix>.json``) fixes the set of utterance lengths and label
counts: frame counts are the quantiles of its length distribution at
``(i + 0.5) / n``, put in an order fixed by the mix's ``order_seed``, so
every seed trains or decodes the same padded shapes in the same batches.
The seed draws what the shapes are filled with: the features (unit normal,
as features after mean and variance normalisation) and the label ids.

Distributions (``frames``): ``{"dist": "lognormal", "median", "sigma",
"min", "max"}`` and ``{"dist": "uniform", "min", "max"}``, in frames as the
model's input sees them (after splice and frame skip).  Frame counts are
rounded up to the configuration's ``n_downsample``, as the dataset pads
them.  Labels: ``round(labels_per_frame * T)``, at least 1, ids drawn
uniformly from ``[2, num_class)`` (0 is the blank, 1 the unknown unit).
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import List

import numpy as np
import torch


def frame_counts(mix: dict, multiple: int) -> np.ndarray:
    """The mix's fixed frame counts, in its fixed order."""
    n = int(mix["utterances"])
    spec = mix["frames"]
    q = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(p)) for p in q])
        t = float(spec["median"]) * np.exp(float(spec["sigma"]) * z)
    elif spec["dist"] == "uniform":
        t = float(spec["min"]) + (float(spec["max"]) - float(spec["min"])) * q
    else:
        raise ValueError(f"unknown frame distribution {spec['dist']!r}")
    t = np.clip(np.rint(t), spec["min"], spec["max"]).astype(np.int64)
    t = -(-t // multiple) * multiple
    return t[np.random.RandomState(int(mix["order_seed"])).permutation(n)]


def label_counts(mix: dict, frames: np.ndarray) -> np.ndarray:
    return np.maximum(np.rint(float(mix["labels_per_frame"]) * frames), 1
                      ).astype(np.int64)


def num_class(config: dict) -> int:
    """Output classes of a recipe: the 863 recipes' ``num_class`` plus the
    blank, else ``output_class_dim``."""
    c = config.get("num_class", 0)
    return int(c) + 1 if c else int(config["output_class_dim"])


def feature_dim(config: dict) -> int:
    return int(config["rnn_input_size"])


@dataclasses.dataclass
class Corpus:
    """Utterances as the model's input sees them: ``feats`` (total frames,
    F) float32 on the host, utterance ``i`` at rows ``offsets[i] :
    offsets[i] + frames[i]``; ``labels[i]`` int32 ids."""

    feats: np.ndarray
    offsets: np.ndarray
    frames: np.ndarray
    labels: List[np.ndarray]

    def __len__(self) -> int:
        return len(self.frames)

    def feat(self, i: int) -> np.ndarray:
        return self.feats[self.offsets[i]:self.offsets[i] + self.frames[i]]


def make_corpus(mix: dict, config: dict, seed: int,
                device: str | torch.device = "cpu") -> Corpus:
    """The mix's corpus filled from ``seed``: the features drawn in one call
    on ``device`` (the card, in a run) and brought to the host."""
    frames = frame_counts(mix, int(config.get("n_downsample", 1) or 1))
    n_lab = label_counts(mix, frames)
    seed = int(seed) % (1 << 63)
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn(int(frames.sum()), feature_dim(config),
                        generator=gen, device=device).cpu().numpy()
    lab_gen = torch.Generator().manual_seed(seed ^ 0x1ABE1)
    ids = torch.randint(2, num_class(config), (int(n_lab.sum()),),
                        generator=lab_gen, dtype=torch.int32).numpy()
    offsets = np.concatenate([[0], np.cumsum(frames)[:-1]])
    lab_off = np.concatenate([[0], np.cumsum(n_lab)])
    labels = [ids[lab_off[i]:lab_off[i + 1]] for i in range(len(frames))]
    return Corpus(feats, offsets, frames, labels)


class CorpusDataset:
    """A ``Corpus`` with the interface of the port's ``SpeechDataset`` that
    its loaders use (``items``, ``__getitem__``, ``lengths``,
    ``label_lengths``), so batches are made by the port's own
    ``SpeechDataLoader`` and ``DeviceCachedLoader``."""

    def __init__(self, corpus: Corpus):
        self.corpus = corpus
        self.items = [(f"utt{i:05d}", "", corpus.labels[i])
                      for i in range(len(corpus))]

    def __len__(self) -> int:
        return len(self.corpus)

    def __getitem__(self, i: int):
        return self.corpus.feat(i), self.corpus.labels[i], self.items[i][0]

    def lengths(self) -> np.ndarray:
        return self.corpus.frames.copy()

    def label_lengths(self) -> np.ndarray:
        return np.array([len(x) for x in self.corpus.labels])


def batch_arrays(corpus: Corpus, indices, t_pad: int, l_pad: int = 0):
    """The benchmark's own padding of utterances ``indices`` into one batch,
    for the reference: ``(feats (B, t_pad, F), frames (B,), labels (B,
    l_pad), label counts (B,))`` as tensors; ``l_pad`` 0 pads the labels
    to the longest."""
    indices = [int(i) for i in indices]
    b = len(indices)
    l_pad = l_pad or max(len(corpus.labels[i]) for i in indices)
    feats = np.zeros((b, t_pad, corpus.feats.shape[1]), np.float32)
    labels = np.zeros((b, l_pad), np.int64)
    frames = np.zeros(b, np.int64)
    n_lab = np.zeros(b, np.int64)
    for r, i in enumerate(indices):
        feats[r, :corpus.frames[i]] = corpus.feat(i)
        labels[r, :len(corpus.labels[i])] = corpus.labels[i]
        frames[r], n_lab[r] = corpus.frames[i], len(corpus.labels[i])
    return (torch.from_numpy(feats), torch.from_numpy(frames),
            torch.from_numpy(labels), torch.from_numpy(n_lab))

