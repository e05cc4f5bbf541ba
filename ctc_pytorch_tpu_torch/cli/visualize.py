"""Activation visualization (``timit/steps/visualize.py`` replacement;
counterpart of ``ctc_pytorch_tpu/cli/visualize.py``).

Loads a checkpoint package, runs the first test utterance with
``visualize=True`` (input spectrum, post-CNN activations, pre-RNN features,
per-frame class log-probs: the four tensors the reference pushes to
visdom, ``visualize.py:107-132``), and writes them as an ``.npz`` with the
JAX tool's keys, plus PNG heatmaps when matplotlib imports.  Class
probabilities can be folded 48->39 for display (``--fold-48-39``).  A
package trained on waveforms runs its utterance through the frontend it was
trained with.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises.  TF32 is off, so an fp32 package computes in full fp32.

Usage: ``python -m ctc_pytorch_tpu_torch.cli.visualize --conf <yaml>
--package <npz> [--out visualize/activations.npz] [--fold-48-39]
[--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.config import load_config
from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset
from ctc_pytorch_tpu_torch.data.prep.phones import phone_map
from ctc_pytorch_tpu_torch.frontend.e2e import frontend_fn_from_config
from ctc_pytorch_tpu_torch.train.checkpoint import model_from_package
from ctc_pytorch_tpu_torch.vocab import Vocab


def visualize(cfg, package_path: str, out_path: str, fold_48_39: bool = False,
              log=print, device: str | torch.device = "cuda") -> Path:
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab = Vocab(cfg.vocab_file)
    spec, model, _ = model_from_package(package_path, dev)
    ds = SpeechDataset(vocab, cfg.test_scp_path, cfg.test_lab_path, cfg)
    # num_buckets=0: reference-exact per-utterance padding -- bucket padding
    # would append a long garbage tail (up to the corpus max length) to
    # every visualized tensor
    loader = SpeechDataLoader(ds, 1, shuffle=False, num_buckets=0)
    batch = next(iter(loader))
    feats = torch.from_numpy(batch.feats).to(dev)
    frontend_fn = frontend_fn_from_config(cfg)
    if frontend_fn is not None:
        feats, _, _ = frontend_fn(feats, torch.from_numpy(
            batch.input_lengths.astype(np.float32)).to(dev))
    with torch.inference_mode():
        _, visual = model(feats, visualize=True)
    arrays = {
        "utt": np.array(batch.utts[0]),
        "input": visual[0][0].float().cpu().numpy(),  # (T, F)
        "log_probs": visual[-1][:, 0, :].cpu().numpy(),  # (T', C)
    }
    if spec.add_cnn:
        arrays["post_cnn"] = visual[1][0].cpu().numpy()  # (C, T', F')
        arrays["pre_rnn"] = visual[2][:, 0, :].float().cpu().numpy()
    probs = np.exp(arrays["log_probs"])
    if fold_48_39:
        m = phone_map("48-39")
        folded: dict = {}
        for idx in range(probs.shape[1]):
            name = vocab.index2word.get(idx, "UNK")
            tgt = m.get(name, name)
            folded.setdefault(tgt, np.zeros(probs.shape[0]))
            folded[tgt] += probs[:, idx]
        arrays["folded_names"] = np.array(sorted(folded))
        arrays["folded_probs"] = np.stack(
            [folded[k] for k in sorted(folded)], axis=1)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, figsize=(10, 6))
        axes[0].imshow(arrays["input"].T, aspect="auto", origin="lower")
        axes[0].set_title(f"input spectrum: {batch.utts[0]}")
        axes[1].imshow(probs.T, aspect="auto", origin="lower")
        axes[1].set_title("per-frame class probabilities")
        fig.tight_layout()
        fig.savefig(out.with_suffix(".png"))
        plt.close(fig)
        log(f"wrote {out} and {out.with_suffix('.png')}")
    except ImportError:
        log(f"wrote {out} (matplotlib unavailable; npz only)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="activation visualization (torch)")
    p.add_argument("--conf", default="conf/ctc_config.yaml")
    p.add_argument("--package", required=True)
    p.add_argument("--out", default="visualize/activations.npz")
    p.add_argument("--fold-48-39", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)
    cfg = load_config(args.conf)
    return visualize(cfg, args.package, args.out, args.fold_48_39,
                     device=args.device)


if __name__ == "__main__":
    main()
