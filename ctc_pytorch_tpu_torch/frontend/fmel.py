"""F_Mel: linear-interpolation mel warping of a log spectrum.

Counterpart of ``ctc_pytorch_tpu/frontend/fmel.py``, which reproduces
``tools.F_Mel`` (``timit/utils/tools.py:43-64``), used when the config sets
``mel: True`` (``timit/utils/data_loader.py:111-112``): for each of ``n_mels
= F`` mel-spaced centre frequencies (librosa/Slaney spacing, 0 to
sample_rate/2, scaled by ``window_size`` seconds into fractional FFT-bin
coordinates), the frame's spectrum is interpolated linearly.  One gather and
a lerp.
"""

from __future__ import annotations

import numpy as np
import torch


def _slaney_mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.mel_frequencies (Slaney scale: linear < 1 kHz, log above)."""
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(f / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def f_mel(log_spec: torch.Tensor, sample_rate: int = 16000,
          window_size: float = 0.025) -> torch.Tensor:
    """(..., T, F) -> (..., T, F) mel-warped by linear interpolation:
    ``spec[right]·frac + spec[left]·(1-frac)`` at ``left = floor(mel_bin)``,
    as ``tools.py:55-62`` (reading bin ``left+1``, clamped to the last)."""
    n_mels = log_spec.shape[-1]
    mel_bin = _slaney_mel_frequencies(n_mels, 0.0, sample_rate / 2.0)
    mel_bin = mel_bin * window_size
    left = np.floor(mel_bin).astype(np.int64)
    frac = torch.from_numpy((mel_bin - left).astype(np.float32)).to(
        log_spec.device)
    right = np.minimum(left + 1, n_mels - 1)
    lo = log_spec[..., torch.from_numpy(left).to(log_spec.device)]
    hi = log_spec[..., torch.from_numpy(right).to(log_spec.device)]
    return (hi - lo) * frac + lo
