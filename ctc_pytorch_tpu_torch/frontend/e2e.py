"""Waveform in: the audio frontend inside the training and decoding step.

Counterpart of ``ctc_pytorch_tpu/frontend/e2e.py`` (the waveform-in
configuration, ``BASELINE.json`` config 5; the reference's own waveform path
is dead code, ``timit/utils/data_loader.py:62-68``): batches carry padded raw
samples and their sample counts, and the step runs frontend -> CMVN ->
splice/skip -> model -> CTC on the device.  In a fused epoch the frontend is
part of the captured CUDA graph, so features never reach the host or disk.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ctc_pytorch_tpu_torch.frontend.cmvn import apply_cmvn
from ctc_pytorch_tpu_torch.frontend.features import (
    FrontendConfig,
    add_deltas,
    fbank,
    mfcc,
    num_frames,
    spectrogram,
)
from ctc_pytorch_tpu_torch.frontend.splice import (
    ceil_div,
    make_context,
    pad_to_downsample,
    skip_frames,
)


@dataclasses.dataclass(frozen=True)
class WaveFrontendSpec:
    """Static description of the in-step frontend chain."""

    feat_type: str = "fbank"  # fbank | mfcc | mfcc39 | spectrogram
    frontend: FrontendConfig = FrontendConfig()
    left_ctx: int = 0
    right_ctx: int = 2
    n_skip_frame: int = 2
    # zero-pad T (and round valid frame counts up) to a multiple of this,
    # as the offline path pads to n_downsample (data/dataset.py
    # process_feature; ref data_loader.py:106-110)
    n_downsample: int = 1

    def feature_dim(self) -> int:
        base = {
            "fbank": self.frontend.num_mel_bins + int(self.frontend.use_energy),
            "mfcc": self.frontend.num_ceps,
            "mfcc39": self.frontend.num_ceps * 3,
            "spectrogram": self.frontend.fft_size // 2 + 1,
        }[self.feat_type]
        return base * (self.left_ctx + self.right_ctx + 1)


def waveform_frontend(
    spec: WaveFrontendSpec,
    wavs: torch.Tensor,  # (B, S) padded samples
    wav_lengths: torch.Tensor,  # (B,) valid sample counts, integer
    cmvn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S) waveforms -> ((B, T', F'), frac, frame_lengths) on their
    device.

    Valid frame counts follow Kaldi snip-edges on the true sample counts
    (int32 throughout); frames past them are excluded by ``frac`` and the
    lengths (the reference's zero-pad + fractional sizes contract)."""
    cfg = spec.frontend
    if spec.feat_type == "fbank":
        feats = fbank(wavs, cfg)
    elif spec.feat_type == "mfcc":
        feats = mfcc(wavs, cfg)
    elif spec.feat_type == "mfcc39":
        feats = add_deltas(mfcc(wavs, cfg))
    elif spec.feat_type == "spectrogram":
        feats = spectrogram(wavs, cfg)
    else:
        raise ValueError(f"unknown feat_type {spec.feat_type!r}")
    if cmvn is not None:
        feats = apply_cmvn(feats, cmvn[0], cmvn[1])
    # valid frame counts BEFORE splicing: the splice replicates each
    # utterance's own edge, not the padded buffer's
    n_frames = num_frames(wav_lengths.to(torch.int32), cfg.frame_length,
                          cfg.frame_shift)
    feats = make_context(feats, spec.left_ctx, spec.right_ctx,
                         lengths=n_frames)
    feats = skip_frames(feats, spec.n_skip_frame)
    ds = max(spec.n_downsample, 1)
    feats = pad_to_downsample(feats, ds)
    frame_len = n_frames
    if spec.n_skip_frame > 1:
        frame_len = ceil_div(frame_len, spec.n_skip_frame)
    if ds > 1:
        # as the offline path: each item's rows are zero-padded to a
        # multiple of n_downsample and the padded count is its length
        frame_len = ceil_div(frame_len, ds) * ds
    t_out = feats.shape[-2]
    frame_len = torch.clamp(frame_len, max=t_out)
    # a tensor divisor: CUDA divides by a Python number through its
    # reciprocal, an ulp off the correctly rounded quotient of the CPU and
    # of JAX, and ``input_sizes`` truncates frac * T'
    frac = frame_len.to(torch.float32) / frame_len.new_full(
        (), t_out, dtype=torch.float32)
    return feats, frac, frame_len


def build_frontend_fn(spec: WaveFrontendSpec,
                      cmvn: Optional[Tuple] = None) -> Callable:
    """The step's frontend: ``fn(wavs, wav_lengths) -> (feats, frac,
    frame_lengths)``, where ``wavs`` is (B, S) or the collate's (B, S, 1)
    and ``wav_lengths`` the sample counts (the batch's ``frac`` slot, as
    float32).  ``cmvn`` (mean, inv_std) goes to each call's device once."""
    on_device: dict = {}

    def fn(wavs: torch.Tensor, wav_lengths: torch.Tensor):
        if wavs.ndim == 3:  # collate shape (B, S, 1)
            wavs = wavs[..., 0]
        stats = None
        if cmvn is not None:
            if wavs.device not in on_device:
                on_device[wavs.device] = tuple(
                    torch.as_tensor(np.asarray(c, np.float32)).to(wavs.device)
                    for c in cmvn)
            stats = on_device[wavs.device]
        return waveform_frontend(spec, wavs, wav_lengths.to(torch.int32),
                                 stats)

    return fn


def spec_from_config(cfg) -> WaveFrontendSpec:
    """The frontend of a ``feature_type: waveform`` config: fbank with
    ``feature_dim - 1`` mel bins and the energy, the config's splice, skip
    and downsample padding."""
    return WaveFrontendSpec(
        feat_type="fbank",
        frontend=FrontendConfig(num_mel_bins=max(cfg.feature_dim - 1, 1)),
        left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
        n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample,
    )


def cmvn_from_config(cfg) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(mean, inv_std) of ``<data_dir>/global_fbank_cmvn.npz`` when stage 1
    wrote it, else None."""
    path = Path(cfg.data_dir) / "global_fbank_cmvn.npz"
    if not path.exists():
        return None
    with np.load(path) as z:
        return z["mean"], z["inv_std"]


def frontend_fn_from_config(cfg) -> Optional[Callable]:
    """The step's frontend for a ``feature_type: waveform`` config, with the
    training-time CMVN stats where stage 1 wrote them; None for
    offline-feature configs.  Stage 2 (``cli.train``) and stage 4
    (``cli.test``) both build it, so a waveform package decodes with the
    frontend it was trained with."""
    if cfg.feature_type != "waveform":
        return None
    return build_frontend_fn(spec_from_config(cfg), cmvn_from_config(cfg))
