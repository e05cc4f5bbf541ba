"""Kaldi-compatible feature extraction as torch ops, on the tensor's device.

Counterpart of ``ctc_pytorch_tpu/frontend/features.py``, which replaces the
Kaldi binaries the reference shells out to (``compute-fbank-feats`` /
``compute-mfcc-feats`` / ``compute-spectrogram-feats``,
``timit/steps/make_feat.sh:25,35``) and the librosa log spectrum
(``timit/local/make_spectrum.py:54-96``).  Where XLA compiles the JAX
functions, these are torch ops: framing is a strided view
(``Tensor.unfold``), the FFT is ``torch.fft.rfft`` (cuFFT on the card) and
the mel and DCT matrices are matmuls (cuBLAS).  Batched ``(..., S)``
waveforms in, ``(..., T, F)`` features out; valid frame counts are the
caller's (``num_frames``).

Kaldi conventions reproduced (FrameExtractionOptions / MelBanksOptions):
snip-edges framing, 25 ms window / 10 ms shift; dither, per-frame DC removal,
raw log-energy, preemphasis 0.97 with ``x[0] -= coeff * x[0]``, then the
window, in that order; FFT padded to the next power of two, power spectrum;
mel(f) = 1127 ln(1 + f/700), low 20 Hz, high Nyquist; fbank log(mel) with
the energy as column 0 when ``use_energy``; mfcc an orthonormal DCT-II, 13
ceps, lifter 22.

Two sums run in float64, where the JAX package (XLA) sums in float32: the
frame mean of the DC removal and the FFT.  In float32 the card and the CPU
(cuFFT against MKL/pocketfft, and a mean rounded once or twice) part by
~5e-7 of a frame's peak power in every bin, which is a relative error of
1e-3 in the low mel bands that preemphasis leaves ~60 dB under the peak;
with these two sums in float64 both devices land on the same float32
features to its rounding, and the features are closer to the exact ones
than the JAX package's.  The rest is float32.

Dither (off by default, as in the JAX package): the noise comes from a
``torch.Generator`` seeded with ``dither_seed`` folded with the bit pattern
of the input's ``sum(|x|)``, so it is deterministic for a seed and content
and differs between utterances, as the JAX key is.  The streams differ from
JAX's, and the fold reads the sum on the host (so a dithering frontend
cannot run inside a captured CUDA graph).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import struct
from typing import Tuple

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)
# the dtype of the DC removal's mean and of the FFT (see above);
# ``chip_smoke.py`` phase 12 times the frontend with float32 here beside it
SUM_DTYPE = torch.float64


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemph: float = 0.97
    remove_dc: bool = True
    raw_energy: bool = True
    window: str = "hamming"  # povey | hamming | hanning | rectangular | blackman
    round_to_power_of_two: bool = True
    dither: float = 0.0  # deterministic by default; Kaldi defaults to 1.0
    dither_seed: int = 0
    # mel options
    num_mel_bins: int = 80
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 means offset from Nyquist
    # fbank options
    use_energy: bool = True
    use_log_fbank: bool = True
    use_power: bool = True
    # mfcc options
    num_ceps: int = 13
    cepstral_lifter: float = 22.0
    mfcc_use_energy: bool = False

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def fft_size(self) -> int:
        n = self.frame_length
        if self.round_to_power_of_two:
            return 1 << (n - 1).bit_length()
        return n


def num_frames(num_samples, frame_length: int, frame_shift: int):
    """Kaldi snip-edges frame count of an int or an integer tensor."""
    if isinstance(num_samples, torch.Tensor):
        return torch.clamp(1 + torch.div(num_samples - frame_length,
                                         frame_shift, rounding_mode="floor"),
                           min=0)
    return max(0, 1 + (num_samples - frame_length) // frame_shift)


def _window_coeffs(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if cfg.window == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window == "rectangular":
        w = np.ones(n)
    elif cfg.window == "blackman":
        coeff = 0.42
        w = coeff - 0.5 * np.cos(a * i) + (0.5 - coeff) * np.cos(2 * a * i)
    else:
        raise ValueError(f"unknown window type {cfg.window!r}")
    return w.astype(np.float32)


def frame_signal(wav: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(..., S) waveform -> (..., T, frame_length) frames (snip-edges), a
    view of ``wav``."""
    flen, shift = cfg.frame_length, cfg.frame_shift
    if wav.shape[-1] < flen:
        return wav.new_zeros(wav.shape[:-1] + (0, flen))
    return wav.unfold(-1, flen, shift)


def _dither_generator(cfg: FrontendConfig, x: torch.Tensor) -> torch.Generator:
    """``dither_seed`` folded with the float32 bit pattern of ``sum(|x|)``."""
    total = float(x.abs().sum().to(torch.float32))
    bits = struct.unpack("<I", struct.pack("<f", total))[0]
    gen = torch.Generator(device=x.device)
    gen.manual_seed((cfg.dither_seed * 0x9E3779B1 + bits) % (1 << 63))
    return gen


def _preprocess_frames(frames: torch.Tensor, cfg: FrontendConfig,
                       window: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dither, DC removal, raw energy, preemphasis, windowing (Kaldi's
    ProcessWindow order).  Returns (windowed_frames, raw_log_energy)."""
    x = frames.to(torch.float32)
    if cfg.dither > 0.0:
        x = x + cfg.dither * torch.randn(
            x.shape, generator=_dither_generator(cfg, x), device=x.device)
    if cfg.remove_dc:
        x = x - x.mean(dim=-1, keepdim=True, dtype=SUM_DTYPE).to(x.dtype)
    log_energy = torch.log(torch.clamp((x * x).sum(-1), min=EPS))
    if cfg.preemph != 0.0:
        shifted = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        x = x - cfg.preemph * shifted
    x = x * window
    if not cfg.raw_energy:
        log_energy = torch.log(torch.clamp((x * x).sum(-1), min=EPS))
    return x, log_energy


def power_spectrum(wav: torch.Tensor, cfg: FrontendConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., S) -> ((..., T, nfft/2+1) power spectrum, (..., T) raw
    log-energy)."""
    frames = frame_signal(wav, cfg)
    window = _const(_window_coeffs, (cfg,), wav.device)
    x, log_energy = _preprocess_frames(frames, cfg, window)
    if x.shape[-2] == 0:  # shorter than a frame: no FFT of nothing
        return x.new_zeros(x.shape[:-1] + (cfg.fft_size // 2 + 1,)), log_energy
    spec = torch.fft.rfft(x.to(SUM_DTYPE), n=cfg.fft_size, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).to(torch.float32), log_energy


# ---------------------------------------------------------------------------
# Mel filterbank (Kaldi MelBanks), DCT, lifter: host numpy constants
# ---------------------------------------------------------------------------

def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """Dense (nfft/2+1, num_mel_bins) triangular mel matrix, Kaldi-style:
    per-bin weights on the FFT bins' centre frequencies in mel space
    (feat/mel-computations.cc), so the filterbank is one matmul."""
    nfft = cfg.fft_size
    nyquist = cfg.sample_rate / 2.0
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_low, mel_high = _mel(cfg.low_freq), _mel(high)
    n_bins = cfg.num_mel_bins
    mel_delta = (mel_high - mel_low) / (n_bins + 1)
    fft_mels = _mel(np.arange(nfft // 2 + 1) * (cfg.sample_rate / nfft))
    centers = mel_low + np.arange(n_bins + 2) * mel_delta  # left, centre, right
    left = centers[:-2][None, :]
    center = centers[1:-1][None, :]
    right = centers[2:][None, :]
    m = fft_mels[:, None]
    up = (m - left) / (center - left)
    down = (right - m) / (right - center)
    # zero outside [left, right], which also drops the bins below low_freq
    # and above high_freq
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in), Kaldi's ComputeDctMatrix."""
    i = np.arange(n_out)[:, None]
    j = np.arange(n_in)[None, :]
    mat = np.sqrt(2.0 / n_in) * np.cos(math.pi * i * (2 * j + 1) / (2.0 * n_in))
    mat[0, :] = np.sqrt(1.0 / n_in)
    return mat.astype(np.float32)


def _lifter_coeffs(cfg: FrontendConfig) -> np.ndarray:
    q = cfg.cepstral_lifter
    i = np.arange(cfg.num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def _hamming(n: int) -> np.ndarray:
    return np.hamming(n).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _const(fn, args: tuple, device: torch.device) -> torch.Tensor:
    """``fn(*args)`` (a host constant: window, mel matrix, DCT, lifter) as a
    tensor on ``device``, copied there once: a host-to-device copy cannot run
    inside a captured CUDA graph, and the step's first (warm-up) call makes
    it before the capture."""
    return torch.from_numpy(fn(*args)).to(device)


# ---------------------------------------------------------------------------
# Feature types
# ---------------------------------------------------------------------------

def fbank(wav: torch.Tensor, cfg: FrontendConfig = FrontendConfig()
          ) -> torch.Tensor:
    """Log-mel filterbank features, (..., S) -> (..., T, n_mels [+1]).

    ``compute-fbank-feats`` with ``timit/conf/fbank.conf``: the raw energy is
    column 0 when ``use_energy`` (80 mel + energy = 81 dims)."""
    power, log_energy = power_spectrum(wav, cfg)
    mel = power @ _const(mel_filterbank, (cfg,), power.device)
    if not cfg.use_power:
        mel = torch.sqrt(torch.clamp(mel, min=0.0))
    feats = torch.log(torch.clamp(mel, min=EPS)) if cfg.use_log_fbank else mel
    if cfg.use_energy:
        feats = torch.cat([log_energy[..., None], feats], dim=-1)
    return feats


def mfcc(wav: torch.Tensor, cfg: FrontendConfig = FrontendConfig(),
         num_mel_bins: int = 23) -> torch.Tensor:
    """MFCC features, (..., S) -> (..., T, num_ceps): ``compute-mfcc-feats``
    with ``timit/conf/mfcc.conf`` (``--use-energy=false``: C0 kept)."""
    mel_cfg = dataclasses.replace(cfg, num_mel_bins=num_mel_bins)
    power, log_energy = power_spectrum(wav, mel_cfg)
    mel = power @ _const(mel_filterbank, (mel_cfg,), power.device)
    log_mel = torch.log(torch.clamp(mel, min=EPS))
    ceps = log_mel @ _const(dct_matrix, (num_mel_bins, cfg.num_ceps),
                           log_mel.device).T
    if cfg.cepstral_lifter > 0:
        ceps = ceps * _const(_lifter_coeffs, (cfg,), ceps.device)
    if cfg.mfcc_use_energy:
        ceps = torch.cat([log_energy[..., None], ceps[..., 1:]], dim=-1)
    return ceps


def spectrogram(wav: torch.Tensor, cfg: FrontendConfig = FrontendConfig()
                ) -> torch.Tensor:
    """Log power spectrogram, (..., S) -> (..., T, nfft/2+1):
    ``compute-spectrogram-feats``, bin 0 replaced by the raw log-energy."""
    power, log_energy = power_spectrum(wav, cfg)
    feats = torch.log(torch.clamp(power, min=EPS))
    return torch.cat([log_energy[..., None], feats[..., 1:]], dim=-1)


def log_spectrum_librosa(wav: torch.Tensor, n_fft: int = 400, hop: int = 160,
                         normalize: bool = True) -> torch.Tensor:
    """The reference's librosa alternative (``timit/local/
    make_spectrum.py:54-80``): ``log1p(|STFT|)`` with a hamming window,
    centred (reflect-padded by ``n_fft // 2``), 201 dims at n_fft=400, then
    per-utterance mean/std normalisation."""
    pad = n_fft // 2
    x = wav.to(torch.float32)
    lead = x.shape[:-1]
    x = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                                mode="reflect").reshape(lead + (-1,))
    frames = x.unfold(-1, n_fft, hop)
    window = _const(_hamming, (n_fft,), x.device)
    spec = torch.fft.rfft((frames * window).to(torch.float64), dim=-1)
    feats = torch.log1p(spec.abs().to(torch.float32))
    if normalize:
        mean = feats.mean(dim=(-2, -1), keepdim=True)
        std = feats.std(dim=(-2, -1), keepdim=True, correction=0)
        feats = (feats - mean) / torch.clamp(std, min=EPS)
    return feats


# ---------------------------------------------------------------------------
# Deltas (Kaldi add-deltas, order 2, window 2)
# ---------------------------------------------------------------------------

def _delta_scales(order: int, window: int) -> list:
    """Kaldi DeltaFeatures scales: iterated regression filters."""
    scales = [np.array([1.0], dtype=np.float64)]
    for _ in range(order):
        prev = scales[-1]
        denom = 2.0 * sum(j * j for j in range(1, window + 1))
        cur = np.zeros(len(prev) + 2 * window)
        for j in range(-window, window + 1):
            cur[j + window: j + window + len(prev)] += (j / denom) * prev
        scales.append(cur)
    return [s.astype(np.float32) for s in scales]


def add_deltas(feats: torch.Tensor, order: int = 2, window: int = 2
               ) -> torch.Tensor:
    """(..., T, F) -> (..., T, F*(order+1)) with delta/ddelta, edges
    replicated (the README's "39dim mfcc": 13 + delta + ddelta)."""
    t = feats.shape[-2]
    outs = []
    for scale in _delta_scales(order, window):
        half = (len(scale) - 1) // 2
        if half == 0:
            outs.append(feats)
            continue
        padded = torch.cat([feats[..., :1, :].expand(
            feats.shape[:-2] + (half, feats.shape[-1])), feats,
            feats[..., -1:, :].expand(feats.shape[:-2] + (half,
                                                          feats.shape[-1]))],
            dim=-2)
        acc = None
        for k in range(len(scale)):
            if scale[k] != 0.0:
                term = float(scale[k]) * padded[..., k:k + t, :]
                acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=-1)
