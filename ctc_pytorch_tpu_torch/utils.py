"""Rotating file logging for stage 2 (copy of ``init_file_logger`` of
``ctc_pytorch_tpu/utils/misc.py``)."""

from __future__ import annotations

import logging
from logging.handlers import RotatingFileHandler
from pathlib import Path


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
