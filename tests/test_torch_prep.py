"""Stage 0 of the port (``data/prep/timit.py``, ``data/prep/phones.py``)
against the JAX package's on the CPU: the same synthetic TIMIT tree gives
byte-equal ``wav.scp``, ``phn_text``, ``wrd_text`` and ``units`` with the
60->48 and the 60->39 folding."""

import pytest

from ctc_pytorch_tpu.data.prep import normalize_phones as jax_normalize_phones
from ctc_pytorch_tpu.data.prep import phone_map as jax_phone_map
from ctc_pytorch_tpu.data.prep import prepare_timit as jax_prepare_timit
from ctc_pytorch_tpu_torch.data.prep import (
    PHONE_MAP_60_48_39,
    normalize_phones,
    phone_map,
    prepare_timit,
)
from ctc_pytorch_tpu_torch.data.prep.timit import DEV_SPEAKERS, TEST_SPEAKERS
from tests.test_torch_cuda import chip_smoke

FILES = ("wav.scp", "phn_text", "wrd_text")


@pytest.fixture(scope="module")
def timit(tmp_path_factory):
    root = tmp_path_factory.mktemp("timit")
    # 1 s utterances at most: stage 0 reads no audio, so length is no cost
    counts = chip_smoke.write_timit_corpus(root, 3, 2, 2, seed=5,
                                           phones_per_utt=(4, 9))
    return root, counts


@pytest.mark.parametrize("mapping", ["60-48", "60-39"])
def test_stage0_writes_the_jax_files_byte_for_byte(timit, tmp_path, mapping):
    root, counts = timit
    got = prepare_timit(root, tmp_path / "port", mapping)
    want = jax_prepare_timit(root, tmp_path / "jax", mapping)
    assert got == want == counts
    for split in ("train", "dev", "test"):
        for name in FILES:
            ours = (tmp_path / "port" / split / name).read_bytes()
            assert ours == (tmp_path / "jax" / split / name).read_bytes()
            assert ours.count(b"\n") == counts[split]
    units = (tmp_path / "port" / "units").read_bytes()
    assert units == (tmp_path / "jax" / "units").read_bytes()
    n_units = len(units.split())
    assert n_units <= (48 if mapping == "60-48" else 39)


def test_stage0_keeps_the_reference_rules(timit, tmp_path):
    """SA sentences left out, ``<speaker>_<sentence>`` ids in lower case,
    dev and core-test speakers by the shipped lists, ``.PHN`` and ``.phn``
    both found, phones that fold to nothing dropped, ``units`` from train's
    ``phn_text``."""
    root, _ = timit
    prepare_timit(root, tmp_path, "60-39")
    assert len(DEV_SPEAKERS) == 50 and len(TEST_SPEAKERS) == 24
    for split, speakers in (("dev", DEV_SPEAKERS[:2]),
                            ("test", TEST_SPEAKERS[:2])):
        utts = [ln.split()[0] for ln in
                (tmp_path / split / "wav.scp").read_text().splitlines()]
        assert {u.split("_")[0] for u in utts} == set(speakers)
    scp = (tmp_path / "train" / "wav.scp").read_text().splitlines()
    ids = [ln.split()[0] for ln in scp]
    assert ids == sorted(ids) and all(i == i.lower() for i in ids)
    assert not any("_sa" in i for i in ids)
    # upper- and lower-case trees both give their transcripts
    assert any(ln.split()[1].endswith(".WAV") for ln in scp)
    assert any(ln.split()[1].endswith(".wav") for ln in scp)
    phn = (tmp_path / "train" / "phn_text").read_text().splitlines()
    assert [ln.split()[0] for ln in phn] == ids
    folded = {p for ln in phn for p in ln.split()[1:]}
    assert "q" not in folded and "h#" not in folded and "sil" in folded
    assert folded == set((tmp_path / "units").read_text().split())


def test_phone_tables_equal_the_jax_tables():
    for to in ("60-48", "60-39", "48-39"):
        assert phone_map(to) == jax_phone_map(to)
    assert len(PHONE_MAP_60_48_39) == 61  # the 60 phones and ax-h
    seq = ["h#", "sh", "ix", "q", "kcl", "k", "ax-h", "zh", "h#"]
    for to in ("60-48", "60-39"):
        assert normalize_phones(seq, to) == jax_normalize_phones(seq, to)
    with pytest.raises(ValueError, match="unsupported"):
        phone_map("61-39")
