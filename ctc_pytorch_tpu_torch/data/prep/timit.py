"""TIMIT corpus preparation (stage 0), host-only: a copy of
``ctc_pytorch_tpu/data/prep/timit.py``, the python replacement for
``timit/local/timit_data_prep.sh`` + ``normalize_phone.py``.

Produces the same on-disk artifacts per split (train/dev/test):
  * ``wav.scp``    — ``spkr_utt /path/to/file.WAV`` (sorted by utt id)
  * ``phn_text``   — phone transcripts after 60->{48,39} folding
  * ``wrd_text``   — word transcripts
plus ``data/units`` via the units builder.  Semantics preserved:
  * only SI & SX sentences (SA excluded, ``timit_data_prep.sh:41``),
  * utt id is ``<speaker>_<sentence>`` lowercased,
  * dev/test speaker lists from config; train = all train-dir speakers,
  * phones mapping to "" (q; and closures at 39) are dropped.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional

from ctc_pytorch_tpu_torch.data.prep.phones import normalize_phones
from ctc_pytorch_tpu_torch.vocab import build_units

# the 50-speaker dev and 24-speaker core-test sets shipped by the reference
# (timit/conf/dev_spk.list, test_spk.list)
DEV_SPEAKERS = """faks0 fdac1 fjem0 mgwt0 mjar0 mmdb1 mmdm2 mpdf0 fcmh0 fkms0
mbdg0 mbwm0 mcsh0 fadg0 fdms0 fedw0 mgjf0 mglb0 mrtk0 mtaa0 mtdt0 mthc0 mwjg0
fnmr0 frew0 fsem0 mbns0 mmjr0 mdls0 mdlf0 mdvc0 mers0 fmah0 fdrw0 mrcs0 mrjm4
fcal1 mmwh0 fjsj0 majc0 mjsw0 mreb0 fgjd0 fjmg0 mroa0 mteb0 mjfc0 mrjr0 fmml0
mrws1""".split()

TEST_SPEAKERS = """mdab0 mwbt0 felc0 mtas1 mwew0 fpas0 mjmp0 mlnt0 fpkt0 mlll0
mtls0 fjlm0 mbpm0 mklt0 fnlp0 mcmj0 mjdh0 fmgd0 mgrt0 mnjm0 fdhc0 mjln0 mpam0
fmld0""".split()


def _find_utts(split_dirs: Iterable[Path], speakers: Optional[set]) -> Dict[str, Path]:
    """Map utt-id -> .wav path for SI/SX sentences of the given speakers."""
    utts: Dict[str, Path] = {}
    for root in split_dirs:
        if not root.is_dir():
            continue
        for wav in root.rglob("*"):
            if wav.suffix.lower() != ".wav":
                continue
            stem = wav.stem.lower()
            if stem.startswith("sa"):
                continue
            speaker = wav.parent.name.lower()
            if speakers is not None and speaker not in speakers:
                continue
            utts[f"{speaker}_{stem}"] = wav
    return utts


def _read_transcript(path: Path) -> List[str]:
    """Third column of each .PHN/.WRD line."""
    toks = []
    for line in path.read_text().splitlines():
        parts = line.strip().split()
        if len(parts) >= 3:
            toks.append(parts[2])
    return toks


def prepare_timit(
    timit_dir: str | Path,
    out_dir: str | Path,
    phoneme_map: str = "60-39",
    dev_speakers: Optional[List[str]] = None,
    test_speakers: Optional[List[str]] = None,
) -> Dict[str, int]:
    """Write data/{train,dev,test}/{wav.scp,phn_text,wrd_text} + data/units."""
    timit_dir = Path(timit_dir)
    out_dir = Path(out_dir)
    train_root = next(
        (timit_dir / n for n in ("train", "TRAIN") if (timit_dir / n).is_dir()),
        timit_dir / "train",
    )
    test_root = next(
        (timit_dir / n for n in ("test", "TEST") if (timit_dir / n).is_dir()),
        timit_dir / "test",
    )
    dev = set(dev_speakers or DEV_SPEAKERS)
    test = set(test_speakers or TEST_SPEAKERS)
    splits = {
        "train": _find_utts([train_root], None),
        "dev": _find_utts([train_root, test_root], dev),
        "test": _find_utts([train_root, test_root], test),
    }
    # train excludes dev/test speakers that live under test_root only; TIMIT's
    # dev/test come from the test portion, so train keeps all train speakers.
    counts = {}
    for split, utts in splits.items():
        sdir = out_dir / split
        sdir.mkdir(parents=True, exist_ok=True)
        ordered = sorted(utts.items())
        with open(sdir / "wav.scp", "w") as f:
            for utt, wav in ordered:
                f.write(f"{utt} {wav}\n")
        for kind, ext in (("phn", ".phn"), ("wrd", ".wrd")):
            with open(sdir / f"{kind}_text", "w") as f:
                for utt, wav in ordered:
                    tfile = _sibling(wav, ext)
                    if tfile is None:
                        continue
                    toks = _read_transcript(tfile)
                    if kind == "phn":
                        toks = normalize_phones(toks, phoneme_map)
                    f.write(f"{utt} {' '.join(toks)}\n")
        counts[split] = len(ordered)
    build_units([out_dir / "train" / "phn_text"], out_dir / "units")
    return counts


def _sibling(wav: Path, ext: str) -> Optional[Path]:
    for cand in (wav.with_suffix(ext), wav.with_suffix(ext.upper())):
        if cand.exists():
            return cand
    return None
