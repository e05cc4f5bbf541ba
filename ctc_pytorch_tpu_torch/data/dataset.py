"""Speech dataset: scp/ark features or audio files, and transcript labels,
host-side numpy.

Copy of ``ctc_pytorch_tpu/data/dataset.py`` (itself mirroring the
reference ``SpeechDataset``, ``timit/utils/data_loader.py:50-117``): per
item ``load_mat`` -> context splice -> frame skip -> zero-pad rows to a
multiple of ``n_downsample``, then F_Mel warping with ``mel: True``
(``data_loader.py:111-112``); labels come from ``utt unit unit ...``
transcript lines with OOV -> UNK.  With ``feature_type: waveform`` the scp
entries are SPHERE or WAV files and an item is its raw samples, ``(S, 1)``
float32: the frontend, splice and skip run in the step
(``frontend/e2e.py``), and ``lengths()`` are sample counts, read from the
audio headers.

An uncompressed float matrix (``BFM``, what ``ArkWriter`` and stage 1
write) is read, spliced, skipped and padded in one native pass
(``native/ark_native.cpp``, as ``ctc_pytorch_tpu/data/dataset.py:112-122``
reads it), bit for bit the numpy path's; the call releases the GIL, so
``preload``'s threads run in parallel.  Other formats (compressed, double),
``mel: True`` and waveform items take the numpy path: dispatch by format,
not a fallback.  ``READS`` counts the feature items each reader produced.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ctc_pytorch_tpu_torch import native
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.data import kaldi_io
from ctc_pytorch_tpu_torch.data.prep.sphere import audio_num_samples, read_audio
from ctc_pytorch_tpu_torch.frontend.fmel import f_mel
from ctc_pytorch_tpu_torch.frontend.splice import downsampled_len, skipped_len
from ctc_pytorch_tpu_torch.vocab import Vocab


# items read by each reader since the last reset_reads(), over every dataset
READS = {"native": 0, "numpy": 0}
_reads_lock = threading.Lock()


def reset_reads() -> None:
    with _reads_lock:
        READS.update(dict.fromkeys(READS, 0))


def _count_read(reader: str) -> None:
    with _reads_lock:
        READS[reader] += 1


def _splice_numpy(feat: np.ndarray, left: int, right: int) -> np.ndarray:
    """Edge-replicated context splice (tools.py:66-75 semantics), host numpy."""
    if left == 0 and right == 0:
        return feat
    cols = []
    for shift in range(-left, right + 1):
        if shift < 0:
            cols.append(np.vstack([np.repeat(feat[:1], -shift, 0), feat[:shift]]))
        elif shift > 0:
            cols.append(np.vstack([feat[shift:], np.repeat(feat[-1:], shift, 0)]))
        else:
            cols.append(feat)
    return np.hstack(cols)


def read_labels(lab_path: str | Path, vocab: Vocab) -> Dict[str, List[int]]:
    """``utt unit unit ...`` lines -> id lists (OOV -> UNK)."""
    labels = {}
    for line in Path(lab_path).read_text().splitlines():
        parts = line.strip().split(" ", 1)
        if not parts or not parts[0]:
            continue
        utt = parts[0]
        labels[utt] = vocab.encode(parts[1]) if len(parts) > 1 else []
    return labels


class SpeechDataset:
    def __init__(
        self,
        vocab: Vocab,
        scp_path: str | Path,
        lab_path: str | Path,
        opts: Config,
        cache: bool = True,
    ):
        self.vocab = vocab
        self.opts = opts
        self.left_ctx = opts.left_ctx
        self.right_ctx = opts.right_ctx
        self.n_skip_frame = opts.n_skip_frame
        self.n_downsample = opts.n_downsample
        self.feature_type = opts.feature_type

        self.scp = kaldi_io.read_scp(scp_path)
        label_dict = read_labels(lab_path, vocab)
        missing = [u for u, _ in self.scp if u not in label_dict]
        if missing:
            raise ValueError(f"{len(missing)} utts missing labels, e.g. {missing[:3]}")
        self.items: List[Tuple[str, str, List[int]]] = [
            (utt, rx, label_dict[utt]) for utt, rx in self.scp
        ]
        self._cache: Optional[list] = [None] * len(self.items) if cache else None
        self._lengths: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.items)

    def raw_feature(self, idx: int) -> np.ndarray:
        rx = self.items[idx][1]
        if self.feature_type == "waveform":
            return read_audio(rx)
        return kaldi_io.load_mat(rx)

    def process_feature(self, feat: np.ndarray) -> np.ndarray:
        """splice -> skip -> pad-to-downsample (data_loader.py:104-110)."""
        feat = _splice_numpy(feat, self.left_ctx, self.right_ctx)
        if self.n_skip_frame > 1:
            feat = feat[:: self.n_skip_frame]
        if self.n_downsample > 1:
            rem = feat.shape[0] % self.n_downsample
            if rem:
                feat = np.vstack(
                    [feat, np.zeros((self.n_downsample - rem, feat.shape[1]), feat.dtype)]
                )
        return feat.astype(np.float32)

    def _native_processed(self, rx: str) -> Optional[np.ndarray]:
        """read + splice + skip + pad in one native pass
        (``ark_native.cpp``); None for an entry that is not an uncompressed
        BFM matrix and for ``mel`` features, which the numpy path reads."""
        if self.opts.mel:
            return None
        return native.ark_load_processed_native(
            rx, self.left_ctx, self.right_ctx, self.n_skip_frame,
            self.n_downsample)

    def preload(self, workers: int = 4) -> None:
        """Fill the cache with `workers` threads (the reference's
        ``num_workers`` DataLoader knob, ``timit/utils/data_loader.py:148``).
        The native reader releases the GIL, so the threads run in parallel;
        on the numpy path they overlap file IO."""
        if self._cache is None:
            return
        from concurrent.futures import ThreadPoolExecutor

        todo = [i for i in range(len(self)) if self._cache[i] is None]
        if not todo:
            return
        with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
            list(pool.map(self.__getitem__, todo))

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        if self._cache is not None and self._cache[idx] is not None:
            return self._cache[idx]
        utt, rx, label = self.items[idx]
        if self.feature_type == "waveform":
            # raw samples as (S, 1), so that batching pads them like
            # features; splice and skip run in the step's frontend
            feat = self.raw_feature(idx).reshape(-1, 1).astype(np.float32)
        else:
            feat = self._native_processed(rx)
            _count_read("numpy" if feat is None else "native")
            if feat is None:
                feat = self.process_feature(self.raw_feature(idx))
            if self.opts.mel:
                # F_Mel warping of the processed log spectrum
                # (data_loader.py:111-112)
                feat = f_mel(torch.from_numpy(feat)).numpy()
        out = (feat, np.asarray(label, np.int32), utt)
        if self._cache is not None:
            self._cache[idx] = out
        return out

    def _raw_rows(self, idx: int) -> int:
        """Raw row or sample count of one item from the file HEADER when the
        format allows (BFM/BDM/CM ark matrices, SPHERE/WAV): a length scan
        then costs a few bytes per item instead of decoding the corpus
        twice."""
        rx = self.items[idx][1]
        if self.feature_type == "waveform":
            n = audio_num_samples(rx)
        else:
            n = kaldi_io.mat_rows(rx)
        if n is not None:
            return n
        return self.raw_feature(idx).shape[0]

    def lengths(self) -> np.ndarray:
        """Processed frame count per item (cheap: header peek, no payload)."""
        if self._lengths is None:
            lens = []
            for i in range(len(self.items)):
                if self._cache is not None and self._cache[i] is not None:
                    lens.append(self._cache[i][0].shape[0])
                else:
                    t = self._raw_rows(i)
                    if self.feature_type != "waveform":
                        # sample counts stay raw: the frame transforms run
                        # in the step's frontend
                        t = skipped_len(t, self.n_skip_frame)
                        t = downsampled_len(t, self.n_downsample)
                    lens.append(t)
            self._lengths = np.asarray(lens)
        return self._lengths

    def label_lengths(self) -> np.ndarray:
        return np.asarray([len(it[2]) for it in self.items])
