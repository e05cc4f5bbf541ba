"""Pipeline orchestrator, the ``timit/run.sh`` replacement (counterpart of
``ctc_pytorch_tpu/cli/run.py``).

Stages (``run.sh:22-46``):
  0  corpus prep (TIMIT walk + phone folding + units), host-only
  1  feature extraction + global CMVN (``cli.make_feat``), on the card
  2  acoustic model training (``cli.train``), on the card
  3  LM training (``cli.train_lm``), host-only
  4  decode + score (``cli.test``), on the card

``python -m ctc_pytorch_tpu_torch.cli.run --timit /path/to/TIMIT --stage 0``
runs from the given stage to ``--stop-stage`` (default 4), like ``bash
run.sh [stage]``.  Stages communicate through the same on-disk artifacts as
the reference and the JAX package (data/<split>/{wav.scp,phn_text,
<feat>.scp,...}, data/units, the ARPA LM, the checkpoint package), so
either package can take over at any stage.  Stages 1, 2 and 4 run on
``--device`` (``cuda`` unless ``--device cpu`` is given); without a card the
run raises before its first stage.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.cli import make_feat, test as test_cli, train as train_cli
from ctc_pytorch_tpu_torch.cli import train_lm
from ctc_pytorch_tpu_torch.config import load_config
from ctc_pytorch_tpu_torch.data.prep import prepare_timit


def main(argv=None):
    p = argparse.ArgumentParser(description="CTC pipeline (torch)")
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--stop-stage", type=int, default=4,
                   help="last stage to run (inclusive)")
    p.add_argument("--timit", default=None, help="TIMIT corpus root (stage 0)")
    p.add_argument("--data", default="data")
    p.add_argument("--conf", default="conf/ctc_config.yaml")
    p.add_argument("--feat", default="fbank",
                   choices=["fbank", "mfcc", "spectrogram", "spectrum"])
    p.add_argument("--phoneme-map", default="60-39")
    p.add_argument("--device", default="cuda",
                   help="device of stages 1, 2 and 4: cuda (default) or cpu")
    args = p.parse_args(argv)

    def active(n):
        return args.stage <= n <= args.stop_stage

    if any(active(n) for n in (1, 2, 4)):
        resolve_device(args.device)  # no card: raise before any stage runs
    device = ["--device", args.device]
    if active(0):
        assert args.timit, "--timit is required for stage 0"
        counts = prepare_timit(args.timit, args.data, args.phoneme_map)
        print(f"Data preparation succeeded: {counts}")
    if active(1):
        make_feat.main([args.feat, args.data, *device])
    conf = args.conf
    if active(2) or active(4):
        # stages 2/4 read corpus paths from the conf; when --data points
        # somewhere else, remap the conf's data-relative paths onto it
        # (otherwise training would miss the artifacts stages 0-1 just
        # wrote, or silently pick up a stale default data/ tree)
        conf = _conf_for_data(args.conf, args.data)
    if active(2):
        train_cli.main(["--conf", conf, *device])
    if active(3):
        train_lm.main([args.data])
    if active(4):
        test_cli.main(["--conf", conf, *device])


def _conf_for_data(conf_path: str, data_dir: str) -> str:
    """Rewrite the conf's data-relative path fields onto ``data_dir`` into
    ``<data_dir>/conf_resolved.yaml``; returns the original path when it
    already matches."""
    cfg = load_config(conf_path)
    old = Path(cfg.data_dir)
    new = Path(data_dir)
    if old.resolve() == new.resolve():
        return conf_path
    for field in ("vocab_file", "train_scp_path", "train_lab_path",
                  "valid_scp_path", "valid_lab_path", "test_scp_path",
                  "test_lab_path", "lm_path"):
        v = getattr(cfg, field, None)
        if not v:
            continue
        try:
            rel = Path(v).relative_to(old)
        except ValueError:
            continue  # not under the conf's data_dir: leave it alone
        setattr(cfg, field, str(new / rel))
    cfg.data_dir = str(new)
    out = new / "conf_resolved.yaml"
    out.parent.mkdir(parents=True, exist_ok=True)
    cfg.to_yaml(out)
    return str(out)


if __name__ == "__main__":
    main()
