"""The port's SPHERE/WAV readers and shorten decoder
(``ctc_pytorch_tpu_torch/data/prep/``) against the JAX package's: the
committed ``tests/fixtures/shorten_v2.sph`` decodes to
``shorten_v2_samples.npz`` exactly, streams from the port's encoder (byte for
byte the JAX encoder's) and the hand-packed streams of
``tests/test_shorten.py`` decode to the same samples, and WAV files
round-trip with their header sample counts."""

from pathlib import Path

import numpy as np
import pytest

from ctc_pytorch_tpu.data.prep import shorten as jsh
from ctc_pytorch_tpu.data.prep import sphere as jsphere
from ctc_pytorch_tpu_torch.data.prep import shorten as sh
from ctc_pytorch_tpu_torch.data.prep.sphere import (
    audio_num_samples,
    read_audio,
    read_sphere,
    read_wav,
    write_wav,
)
from tests.test_shorten import (
    _bits_to_bytes,
    _speechlike,
    _sphere_bytes,
    _ulong_bits,
    _uvar_bits,
    _var_bits,
)
from tests.test_torch_cuda import chip_smoke

FIXDIR = Path(__file__).parent / "fixtures"


def test_committed_fixture_decodes_exactly():
    samples, rate = read_sphere(FIXDIR / "shorten_v2.sph")
    ref = np.load(FIXDIR / "shorten_v2_samples.npz")["samples"]
    assert rate == 16000 and samples.dtype == np.int16
    np.testing.assert_array_equal(samples, ref)
    np.testing.assert_array_equal(read_audio(FIXDIR / "shorten_v2.sph"),
                                  ref.astype(np.float32))
    assert audio_num_samples(FIXDIR / "shorten_v2.sph") == len(ref)


@pytest.mark.parametrize("ftype,nmean,blocksize", [
    (jsh.TYPE_S16LH, 0, 256), (jsh.TYPE_S16LH, 4, 256),
    (jsh.TYPE_U16LH, 0, 128), (jsh.TYPE_S16HL, 4, 100)])
def test_streams_of_the_jax_encoder_decode_as_in_jax(ftype, nmean, blocksize):
    x = _speechlike(3001, seed=nmean + blocksize)
    enc = sh.encode_shorten(x, ftype=ftype, blocksize=blocksize, nmean=nmean)
    assert enc == jsh.encode_shorten(x, ftype=ftype, blocksize=blocksize,
                                     nmean=nmean)
    got, got_type = sh.decode_shorten(enc)
    want, want_type = jsh.decode_shorten(enc)
    assert got_type == want_type == ftype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.astype(np.int32))
    np.testing.assert_array_equal(sh.decode_shorten(enc, max_samples=1000)[0],
                                  x[:1000])


def test_hand_packed_stream_and_tables():
    bits = (_ulong_bits(sh.TYPE_S16LH, 3) + _ulong_bits(1, 1)
            + _ulong_bits(4, 3) + _ulong_bits(0, 0) + _ulong_bits(0, 0)
            + _ulong_bits(0, 0) + _uvar_bits(sh.FN_DIFF1, sh.FNSIZE)
            + _uvar_bits(2, sh.ENERGYSIZE) + _var_bits(3, 2)
            + _var_bits(-2, 2) + _var_bits(-3, 2) + _var_bits(2, 2)
            + _uvar_bits(sh.FN_QUIT, sh.FNSIZE))
    samples, _ = sh.decode_shorten(sh.MAGIC + bytes([2]) + _bits_to_bytes(bits))
    np.testing.assert_array_equal(samples, [3, 1, -2, 0])
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(sh._ulaw_to_linear(codes),
                                  jsh._ulaw_to_linear(codes))
    np.testing.assert_array_equal(sh._alaw_to_linear(codes),
                                  jsh._alaw_to_linear(codes))
    with pytest.raises(ValueError, match="bad magic"):
        sh.decode_shorten(b"RIFF" + bytes(16))


def test_sphere_pcm_shorten_and_wav_round_trip(tmp_path):
    x = _speechlike(2345, seed=3)
    pcm, emb, wav = (tmp_path / n for n in ("a.sph", "b.sph", "c.wav"))
    chip_smoke.write_sphere(pcm, x)
    emb.write_bytes(_sphere_bytes(sh.encode_shorten(x), len(x)))
    write_wav(wav, x)
    for path in (pcm, emb, wav):
        got = read_audio(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, x.astype(np.float32))
        np.testing.assert_array_equal(got, jsphere.read_audio(path))
        np.testing.assert_allclose(read_audio(path, normalize=True),
                                   jsphere.read_audio(path, normalize=True),
                                   rtol=1e-6, atol=1e-6)
        assert audio_num_samples(path) == jsphere.audio_num_samples(path) == 2345
    samples, rate = read_wav(wav)
    assert rate == 16000 and samples.dtype == np.dtype("<i2")
    assert read_sphere(pcm)[1] == 16000
    with pytest.raises(ValueError, match="not a NIST SPHERE"):
        read_sphere(wav)
    (tmp_path / "junk.wav").write_bytes(b"nothing")
    assert audio_num_samples(tmp_path / "junk.wav") is None
