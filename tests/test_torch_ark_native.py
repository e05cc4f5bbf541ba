"""The port's one-pass native ark reader (``native/ark_native.cpp`` through
``native.ark_load_processed_native``, and ``SpeechDataset``'s dispatch to
it) against the numpy path and the JAX package's reader on the CPU: bit for
bit for every splice, skip and pad setting; a matrix that is not an
uncompressed float matrix goes to numpy; ``preload`` over threads gives the
serial items; a failed build raises with the compiler's output."""

import struct

import numpy as np
import pytest

from ctc_pytorch_tpu import native as jax_native
from ctc_pytorch_tpu.config import Config as JConfig
from ctc_pytorch_tpu.data.dataset import SpeechDataset as JDataset
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch import native
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.data import dataset as dataset_mod
from ctc_pytorch_tpu_torch.data.dataset import SpeechDataset, _splice_numpy
from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter, load_mat
from ctc_pytorch_tpu_torch.vocab import Vocab

# (left, right, skip, downsample): the recipes' settings and edge ones
SETTINGS = [(0, 0, 1, 1), (0, 2, 2, 2), (1, 2, 2, 2), (3, 3, 1, 4),
            (0, 2, 3, 1), (2, 0, 1, 3), (5, 5, 4, 2)]


def numpy_ref(mat, left, right, skip, ds):
    ref = _splice_numpy(mat, left, right)[::skip]
    rem = ref.shape[0] % ds
    if rem:
        ref = np.vstack([ref, np.zeros((ds - rem, ref.shape[1]), np.float32)])
    return ref.astype(np.float32)


def write_ark(tmp_path, n=6, dim=9, seed=0, name="x"):
    rng = np.random.RandomState(seed)
    ark, scp = tmp_path / f"{name}.ark", tmp_path / f"{name}.scp"
    mats = {}
    with ArkWriter(ark, scp) as w:
        for i in range(n):
            # 6, 7, 8 rows: as long as the widest context (the numpy
            # splice needs that much), and lengths off every pad multiple
            mats[f"u{i}"] = rng.randn(6 + i if i < 3 else 7 + 13 * i,
                                      dim).astype(np.float32)
            w.write(f"u{i}", mats[f"u{i}"])
    entries = [ln.split() for ln in scp.read_text().splitlines()]
    return mats, entries, scp


@pytest.mark.parametrize("left,right,skip,ds", SETTINGS)
def test_native_reader_is_bit_equal_to_numpy_and_jax(tmp_path, left, right,
                                                     skip, ds):
    mats, entries, _ = write_ark(tmp_path)
    for utt, rx in entries:
        got = native.ark_load_processed_native(rx, left, right, skip, ds)
        want = numpy_ref(load_mat(rx), left, right, skip, ds)
        assert got.dtype == np.float32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
        assert got.shape[0] % ds == 0
        if jax_native.available():
            np.testing.assert_array_equal(
                got, jax_native.ark_load_processed_native(rx, left, right,
                                                          skip, ds))


def double_ark(path):
    """One double-precision ("BDM") entry: a format the native reader
    leaves to numpy."""
    mat = np.arange(12, dtype=np.float64).reshape(4, 3)
    with open(path, "wb") as f:
        f.write(b"d0 ")
        off = f.tell()
        f.write(b"\x00BDM \x04" + struct.pack("<i", 4) + b"\x04"
                + struct.pack("<i", 3) + mat.tobytes())
    return f"{path}:{off}", mat


def test_other_formats_go_to_numpy(tmp_path):
    rx, mat = double_ark(tmp_path / "d.ark")
    assert native.ark_load_processed_native(rx, 0, 0, 1, 1) is None
    bad = tmp_path / "bad.ark"
    bad.write_bytes(b"not an ark at all")
    assert native.ark_load_processed_native(f"{bad}:0", 0, 0, 1, 1) is None
    # the dataset reads the double entry through numpy, as the JAX one
    (tmp_path / "d.scp").write_text(f"d0 {rx}\n")
    (tmp_path / "units").write_text("a\nb\n")
    (tmp_path / "lab").write_text("d0 a b\n")
    cfg = Config()
    cfg.left_ctx, cfg.right_ctx, cfg.n_skip_frame, cfg.n_downsample = 1, 1, 1, 2
    dataset_mod.reset_reads()
    feat, _, _ = SpeechDataset(Vocab(str(tmp_path / "units")),
                               tmp_path / "d.scp", tmp_path / "lab", cfg)[0]
    assert dataset_mod.READS == {"native": 0, "numpy": 1}
    np.testing.assert_array_equal(feat, numpy_ref(mat.astype(np.float32),
                                                  1, 1, 1, 2))
    with pytest.raises(OSError):  # a missing file is an error, not a format
        native.ark_load_processed_native(f"{tmp_path}/none.ark:0", 0, 0, 1, 1)


def test_dataset_reads_natively_and_preload_threads_match(tmp_path):
    """``SpeechDataset`` reads BFM entries natively (counted), the items of
    a threaded ``preload`` equal the serial ones and the JAX dataset's, and
    ``mel`` features stay on the numpy path."""
    _, entries, scp = write_ark(tmp_path, n=12, dim=5, seed=1)
    (tmp_path / "units").write_text("a\nb\n")
    lab = tmp_path / "lab"
    lab.write_text("".join(f"{u} a b a\n" for u, _ in entries))
    datasets = []
    for cls, cfg_cls, vocab_cls in ((SpeechDataset, Config, Vocab),
                                    (JDataset, JConfig, JVocab)):
        cfg = cfg_cls()
        cfg.left_ctx, cfg.right_ctx = 1, 2
        cfg.n_skip_frame, cfg.n_downsample = 2, 2
        datasets.append((cls, cfg, vocab_cls(str(tmp_path / "units"))))
    (cls, cfg, vocab), (jcls, jcfg, jvocab) = datasets
    dataset_mod.reset_reads()
    threaded = cls(vocab, scp, lab, cfg)
    threaded.preload(workers=4)
    assert dataset_mod.READS == {"native": 12, "numpy": 0}
    serial = cls(vocab, scp, lab, cfg)
    ref = jcls(jvocab, scp, lab, jcfg)
    for i in range(12):
        for other in (serial, ref):
            a, b = threaded[i], other[i]
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]
    np.testing.assert_array_equal(threaded.lengths(), ref.lengths())
    # F_Mel warps 201-d log spectra: 201-d entries, no splicing
    _, _, scp201 = write_ark(tmp_path, n=12, dim=201, seed=2, name="s")
    cfg.mel, cfg.left_ctx, cfg.right_ctx = True, 0, 0
    dataset_mod.reset_reads()
    cls(vocab, scp201, lab, cfg)[3]
    assert dataset_mod.READS == {"native": 0, "numpy": 1}


def test_a_rewritten_ark_is_read_anew(tmp_path):
    """The fd cache is keyed by inode: an ark replaced under its name is
    opened again, not read through the old descriptor."""
    mats, entries, _ = write_ark(tmp_path, n=4, seed=2)
    rx = entries[3][1]
    np.testing.assert_array_equal(
        native.ark_load_processed_native(rx, 0, 0, 1, 1), mats["u3"])
    new = tmp_path / "new"
    new.mkdir()
    mats2, entries2, _ = write_ark(new, n=4, seed=3)
    (new / "x.ark").replace(tmp_path / "x.ark")
    np.testing.assert_array_equal(
        native.ark_load_processed_native(rx, 0, 0, 1, 1), mats2["u3"])
    native.close_ark_files()
    assert not native._ark_fds


def test_a_broken_compiler_raises_with_its_output(tmp_path, monkeypatch):
    src = tmp_path / "ark_native.cpp"
    src.write_text("this is not C++\n")
    (tmp_path / "ctc_native.cpp").write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", tmp_path / "ctc_native.cpp")
    monkeypatch.setattr(native, "ARK_SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_ark_fds", {})
    _, entries, _ = write_ark(tmp_path, n=1)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error: "):
        native.ark_load_processed_native(entries[0][1], 0, 0, 1, 1)
    monkeypatch.setattr(native, "CXX", "/nonexistent/g++")
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
