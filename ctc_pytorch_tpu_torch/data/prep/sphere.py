"""NIST SPHERE and RIFF/WAVE readers, host-side numpy.

Copy of ``ctc_pytorch_tpu/data/prep/sphere.py``, which replaces the
sph2pipe C binary of the reference (``timit/local/timit_data_prep.sh:18,52``):
I/O, not compute, so a host reader suffices.  Handles the TIMIT encoding
(1024-byte ASCII header, 16-bit linear PCM), the ``embedded-shorten-v*``
payloads of the stock LDC distribution (``prep/shorten.py``) and plain WAV
files, so prepared corpora work unchanged.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Tuple

import numpy as np


def read_sphere(path: str | Path) -> Tuple[np.ndarray, int]:
    """Return (int16 samples, sample_rate)."""
    data = Path(path).read_bytes()
    if not data.startswith(b"NIST_1A"):
        raise ValueError(f"{path} is not a NIST SPHERE file")
    header_size = int(data[8:16].split()[0])
    header = data[:header_size].decode("ascii", errors="replace")
    fields = {}
    for line in header.splitlines():
        parts = line.split()
        if len(parts) >= 3 and parts[1].startswith("-"):
            fields[parts[0]] = parts[2]
    rate = int(fields.get("sample_rate", 16000))
    n_bytes = int(fields.get("sample_n_bytes", 2))
    coding = fields.get("sample_coding", "pcm")
    byte_format = fields.get("sample_byte_format", "01")
    raw = data[header_size:]
    if "shorten" in coding:
        from ctc_pytorch_tpu_torch.data.prep.shorten import decode_shorten

        n = int(fields["sample_count"]) if "sample_count" in fields else None
        samples, _ = decode_shorten(raw, max_samples=n)
        if int(fields.get("channel_count", 1)) > 1 and samples.ndim > 1:
            samples = samples.mean(axis=1)
        return np.clip(samples, -32768, 32767).astype(np.int16), rate
    if n_bytes == 2:
        dtype = "<i2" if byte_format == "01" else ">i2"
        samples = np.frombuffer(raw[: len(raw) - len(raw) % 2], dtype=dtype)
        samples = samples.astype(np.int16)
    elif n_bytes == 1:
        samples = np.frombuffer(raw, dtype=np.int8).astype(np.int16) << 8
    else:
        raise ValueError(f"unsupported sample_n_bytes={n_bytes}")
    n = int(fields.get("sample_count", len(samples)))
    return samples[:n], rate


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width != 2:
        raise ValueError(f"unsupported sample width {width}")
    samples = np.frombuffer(raw, dtype="<i2")
    if channels > 1:
        samples = samples.reshape(-1, channels).mean(axis=1).astype(np.int16)
    return samples, rate


def read_audio(path: str | Path, normalize: bool = False) -> np.ndarray:
    """SPHERE or WAV -> float32 samples (Kaldi-style int16 range).

    ``normalize=True`` reproduces ``tools.load_wave`` (``timit/utils/tools.py:
    28-41``): per-utterance mean/std normalisation of the raw waveform.
    """
    p = Path(path)
    with p.open("rb") as f:
        head = f.read(8)
    if head.startswith(b"NIST_1A"):
        samples, _ = read_sphere(p)
    else:
        samples, _ = read_wav(p)
    wav = samples.astype(np.float32)
    if normalize:
        std = wav.std()
        wav = (wav - wav.mean()) / (std if std > 0 else 1.0)
    return wav


def audio_num_samples(path: str | Path) -> int | None:
    """Sample count from the SPHERE/WAV header only (no payload decode);
    None when the header doesn't carry it — callers fall back to a full
    read.  Used by dataset length scans so bucketing doesn't decode the
    whole corpus twice."""
    p = Path(path)
    try:
        with p.open("rb") as f:
            head = f.read(8)
        if head.startswith(b"NIST_1A"):
            with p.open("rb") as f:
                header_size = int(f.read(16)[8:16].split()[0])
                f.seek(0)
                header = f.read(header_size).decode("ascii", errors="replace")
            for line in header.splitlines():
                parts = line.split()
                if (len(parts) >= 3 and parts[0] == "sample_count"
                        and parts[1].startswith("-")):
                    return int(parts[2])
            return None
        with wave.open(str(p), "rb") as w:
            return w.getnframes()  # mono-mixdown keeps the frame count
    except (OSError, ValueError, wave.Error, EOFError):
        return None


def write_wav(path: str | Path, samples: np.ndarray, rate: int = 16000) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(samples, np.int16).tobytes())
