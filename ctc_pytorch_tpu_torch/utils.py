"""Rotating file logging for stage 2, the target layout converters and
seeding (counterparts of ``ctc_pytorch_tpu/utils/misc.py``)."""

from __future__ import annotations

import logging
import random
from logging.handlers import RotatingFileHandler
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch


def init_file_logger(
    log_dir: str | Path,
    name: str = "ctc_train",
    max_bytes: int = 1024 * 1024,
    backup_count: int = 5,
) -> logging.Logger:
    """Logger that writes ``<log_dir>/<name>.log`` (rotating) and prints to
    the console (863's ``init_logger``, ``my_863_corpus/steps/
    cnn_lstm_ctc.py:84-94``).  A second call for another directory moves the
    logger's file there."""
    path = (Path(log_dir) / f"{name}.log").resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(f"ctc_pytorch_tpu_torch.{name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not any(getattr(h, "baseFilename", None) == str(path)
               for h in logger.handlers):
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        handler = RotatingFileHandler(path, maxBytes=max_bytes,
                                      backupCount=backup_count)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        stream = logging.StreamHandler()
        stream.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(stream)
    return logger


def flatten_targets(
    labels: np.ndarray, label_lengths: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Padded (B, L) -> flat 1-D targets (the warp-ctc convention the 863
    collate produces, ``my_863_corpus/steps/data_loader.py:195``)."""
    flat = np.concatenate([
        labels[i, : int(label_lengths[i])] for i in range(labels.shape[0])
    ]) if labels.shape[0] else np.zeros((0,), labels.dtype)
    return flat, np.asarray(label_lengths)


def unflatten_targets(
    flat: np.ndarray, label_lengths: Sequence[int], pad_to: int | None = None
) -> np.ndarray:
    """Flat 1-D targets -> padded (B, L) (``ctcDecoder.py:51-64`` semantics)."""
    b = len(label_lengths)
    l_max = pad_to or max((int(l) for l in label_lengths), default=1)
    out = np.zeros((b, max(l_max, 1)), flat.dtype if flat.size else np.int32)
    off = 0
    for i, l in enumerate(label_lengths):
        l = int(l)
        out[i, :l] = flat[off : off + l]
        off += l
    return out


def seed_all(seed: int) -> None:
    """Seed torch (the CPU and every card), numpy and ``random``.  The
    port's entry points draw from explicit generators (``Trainer`` seeds
    its own); this is for scripts and tests that use the global streams."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
