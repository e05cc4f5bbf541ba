"""Stage 3: phoneme bigram LM training (copy of
``ctc_pytorch_tpu/cli/train_lm.py``, the ``steps/train_lm.sh`` replacement).

Host-only (numpy), so it needs no device.  Reads training transcripts
(``utt unit unit ...``), strips the utt ids, trains a Witten-Bell bigram
(IRSTLM ``build-lm.sh -n 2`` default smoothing), and writes a text ARPA to
``<data>/lm_phone_bg.arpa``, byte for byte the JAX stage 3's.  <s>/</s>
wrapping happens inside the trainer (``train_lm.sh:18`` semantics).

Usage: ``python -m ctc_pytorch_tpu_torch.cli.train_lm <data_dir>
[--text train/phn_text] [--out lm_phone_bg.arpa]``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ctc_pytorch_tpu_torch.decode.ngram_lm import train_bigram_lm


def main(argv=None):
    p = argparse.ArgumentParser(description="train phoneme bigram LM")
    p.add_argument("data_dir")
    p.add_argument("--text", default="train/phn_text")
    p.add_argument("--out", default="lm_phone_bg.arpa")
    args = p.parse_args(argv)
    data = Path(args.data_dir)
    sentences = []
    for line in (data / args.text).read_text().splitlines():
        parts = line.strip().split(" ", 1)
        if len(parts) == 2:
            sentences.append(parts[1])
    out = data / args.out
    train_bigram_lm(sentences, out)
    print(f"Write Arpa format language model to {out}")
    return out


if __name__ == "__main__":
    main()
