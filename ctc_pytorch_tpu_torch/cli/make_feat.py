"""Stage 1: feature extraction and global CMVN on the card.

Counterpart of ``ctc_pytorch_tpu/cli/make_feat.py`` (the reference's
``steps/make_feat.sh``), with the same argv and the same outputs: reads
``wav.scp`` of each split, runs the frontend (``frontend/features.py``:
fbank, mfcc with ``--deltas``, spectrogram, or the librosa ``spectrum``),
computes the global CMVN stats on the first split (train), applies
variance-normalising CMVN to every split, and writes
``<split>/<feat>.ark`` / ``.scp`` and ``<data>/global_<feat>_cmvn.npz``,
which either package reads.  As in the JAX stage 1, each utterance is
zero-padded to a multiple of 16000 samples (the librosa ``spectrum``
reflects the true signal's tail into the pad) and its frames cut back to
the true count, so the features do not depend on the padding.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises.  TF32 is off, so the mel and DCT products run in fp32 and the card
agrees with the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter, read_scp
from ctc_pytorch_tpu_torch.data.prep.sphere import read_audio
from ctc_pytorch_tpu_torch.frontend import (
    FrontendConfig,
    accumulate_cmvn,
    add_deltas,
    apply_cmvn,
    fbank,
    finalize_cmvn,
    init_cmvn,
    log_spectrum_librosa,
    mfcc,
    spectrogram,
)


def extract_features(wav: np.ndarray, feat_type: str, cfg: FrontendConfig,
                     deltas: bool = False,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Features of the (padded) samples ``wav`` on ``device``."""
    x = torch.from_numpy(np.asarray(wav, np.float32)).to(resolve_device(device))
    if feat_type == "fbank":
        return fbank(x, cfg)
    if feat_type == "mfcc":
        feats = mfcc(x, cfg)
        return add_deltas(feats) if deltas else feats
    if feat_type == "spectrogram":
        return spectrogram(x, cfg)
    if feat_type == "spectrum":
        # the 863/librosa variant: log1p(|STFT|), 201-dim
        # (timit/local/make_spectrum.py:54-96)
        return log_spectrum_librosa(x, normalize=False)
    raise ValueError(f"Feature type {feat_type} does not support!")


def _bucket_pad(n: int, align: int = 16000) -> int:
    return ((n + align - 1) // align) * align


def padded_audio(wav: np.ndarray, feat_type: str, cfg: FrontendConfig):
    """``(padded samples, valid frames)`` of one utterance, as the JAX
    stage 1 pads it."""
    n = len(wav)
    flen, shift = cfg.frame_length, cfg.frame_shift
    if feat_type == "spectrum":  # centred STFT framing (librosa)
        t = 1 + n // shift
    else:  # Kaldi snip-edges
        t = max(0, 1 + (n - flen) // shift)
    padded = np.zeros(_bucket_pad(max(n, flen)), np.float32)
    padded[:n] = wav
    if feat_type == "spectrum" and n >= 2:
        # librosa's center=True reflects the TRUE signal's tail: the last
        # valid frames' windows reach n + n_fft//2 samples, so the tail is
        # reflected into the pad instead of leaving zeros in those frames
        m = min(flen // 2 + shift, n - 1, len(padded) - n)
        if m > 0:
            padded[n:n + m] = wav[n - 2:n - 2 - m:-1]
    return padded, t


def run_split(scp_path: Path, out_dir: Path, feat_type: str,
              cfg: FrontendConfig, mean: Optional[torch.Tensor],
              inv_std: Optional[torch.Tensor], deltas: bool = False,
              collect_stats: bool = False,
              device: str | torch.device = "cuda"):
    """Extract (optionally CMVN-normalised) features for one split; with
    ``collect_stats``, the split's CMVN stats are computed first and used.
    Returns ``(mean, inv_std)``."""
    dev = resolve_device(device)
    stats = None
    feats_out: Dict[str, torch.Tensor] = {}
    for utt, path in read_scp(scp_path):
        padded, t = padded_audio(read_audio(path), feat_type, cfg)
        full = extract_features(padded, feat_type, cfg, deltas, dev)[:t]
        feats_out[utt] = full
        if collect_stats:
            if stats is None:
                stats = init_cmvn(full.shape[1], dev)
            stats = accumulate_cmvn(stats, full[None])
    if collect_stats:
        mean, inv_std = finalize_cmvn(stats)
    out_dir.mkdir(parents=True, exist_ok=True)
    with ArkWriter(out_dir / f"{feat_type}.ark",
                   out_dir / f"{feat_type}.scp") as w:
        for utt, f in feats_out.items():
            if mean is not None:
                f = apply_cmvn(f, mean, inv_std)
            w.write(utt, f.cpu().numpy())
    return mean, inv_std


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="feature extraction + global CMVN")
    p.add_argument("feat_type",
                   choices=["fbank", "mfcc", "spectrogram", "spectrum"])
    p.add_argument("data_dir")
    p.add_argument("--num-mel-bins", type=int, default=80)
    p.add_argument("--window", default="hamming")
    p.add_argument("--use-energy", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="append the log-energy channel (--no-use-energy "
                        "to disable; fbank.conf default is on)")
    p.add_argument("--deltas", action="store_true",
                   help="append delta+ddelta (39-dim mfcc)")
    p.add_argument("--splits", nargs="+", default=["train", "dev", "test"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FrontendConfig(num_mel_bins=args.num_mel_bins, window=args.window,
                         use_energy=args.use_energy)
    data = Path(args.data_dir)
    # train first: the global stats come from it (make_feat.sh:25-31)
    mean, inv_std = run_split(
        data / args.splits[0] / "wav.scp", data / args.splits[0],
        args.feat_type, cfg, None, None, args.deltas, collect_stats=True,
        device=dev)
    np.savez(data / f"global_{args.feat_type}_cmvn.npz",
             mean=mean.cpu().numpy(), inv_std=inv_std.cpu().numpy())
    for split in args.splits[1:]:
        run_split(data / split / "wav.scp", data / split, args.feat_type, cfg,
                  mean, inv_std, args.deltas, device=dev)
    print(f"Finished {args.feat_type} extraction for {args.splits}")


if __name__ == "__main__":
    main()
