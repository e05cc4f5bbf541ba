"""The port's serving API (``ctc_pytorch_tpu_torch/api.py``) against the JAX
package's on the CPU: ``Recognizer`` strings for one utterance and a batch
(files and arrays) from the same JAX-written package, greedy and beam;
``StreamingRecognizer`` texts on the same streams; and the non-mesh cases
of ``tests/test_api.py`` (the mesh cases: ``tests/test_torch_parallel.py``): the final text equals the batch decode, the
committed prefix never retracts, a long stream stays within its window,
and the windowed commits neither drop nor duplicate a token."""

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.api import Recognizer as JRecognizer
from ctc_pytorch_tpu.api import StreamingRecognizer as JStreaming
from ctc_pytorch_tpu.frontend.e2e import WaveFrontendSpec as JSpec
from ctc_pytorch_tpu.frontend.features import FrontendConfig as JFrontendConfig
from ctc_pytorch_tpu_torch.api import Recognizer, StreamingRecognizer
from ctc_pytorch_tpu_torch.data.prep.sphere import write_wav
from ctc_pytorch_tpu_torch.frontend.e2e import WaveFrontendSpec
from ctc_pytorch_tpu_torch.frontend.features import FrontendConfig
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_api import _mini_package

KW = dict(left_ctx=0, right_ctx=0, n_skip_frame=1)


def fe():
    return WaveFrontendSpec(frontend=FrontendConfig(num_mel_bins=12), **KW)


def jfe():
    return JSpec(frontend=JFrontendConfig(num_mel_bins=12), **KW)


def recognizers(tmp_path, **kw):
    """The port's and the JAX ``Recognizer`` over one JAX-written package."""
    pkg = _mini_package(tmp_path, jfe())
    vocab = Vocab.from_units(["aa", "bb"])
    return (Recognizer(pkg, vocab, frontend=fe(), device="cpu", **kw),
            JRecognizer(pkg, vocab, frontend=jfe(), **kw))


def test_recognizer_strings_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    rec, jrec = recognizers(tmp_path)
    wav = (rng.randn(8000) * 500).astype(np.float32)
    path = tmp_path / "x.wav"
    write_wav(path, (rng.randn(4000) * 500).astype(np.int16))
    one = rec.recognize(wav)
    assert one == jrec.recognize(wav) and len(one) == 1
    batch = rec.recognize([wav, path, wav[:3000]])
    assert batch == jrec.recognize([wav, path, wav[:3000]])
    assert len(batch) == 3 and batch[0] == one[0]
    assert any(batch) and all(t in ("aa", "bb", "UNK")
                              for s in batch for t in s.split())


def test_recognizer_beam_strings_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    rec, jrec = recognizers(tmp_path, decode_type="Beam", beam_width=4)
    wavs = [(rng.randn(n) * 500).astype(np.float32) for n in (7000, 4500)]
    assert rec.recognize(wavs) == jrec.recognize(wavs)


def test_recognizer_raises_for_a_mesh_and_without_a_card(tmp_path,
                                                         monkeypatch):
    pkg = _mini_package(tmp_path, jfe())
    vocab = Vocab.from_units(["aa", "bb"])
    with pytest.raises(ValueError, match="at least one device"):
        Recognizer(pkg, vocab, frontend=fe(), mesh=[], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Recognizer(pkg, vocab, frontend=fe())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Recognizer(pkg, vocab, frontend=fe(), mesh=["cpu", "cuda:0"],
                   device="cpu")


def _stream(sr, wav, chunk, trace=None):
    for start in range(0, len(wav), chunk):
        sr.feed(wav[start:start + chunk])
        if trace is not None:
            trace.append(list(sr._committed))
    return sr.finish()


@pytest.mark.parametrize("n,window,hop,look,chunk", [
    (12000, 4.0, 0.2, 0.2, 1600), (40000, 1.0, 0.25, 0.1, 4000)])
def test_streaming_texts_match_jax(tmp_path, n, window, hop, look, chunk):
    rec, jrec = recognizers(tmp_path)
    wav = (np.random.RandomState(3).randn(n) * 500).astype(np.float32)
    kw = dict(window_seconds=window, hop_seconds=hop, lookahead_seconds=look)
    sr = StreamingRecognizer(rec, **kw)
    trace, jtrace = [], []
    got = _stream(sr, wav, chunk, trace)
    want = _stream(JStreaming(jrec, **kw), wav, chunk, jtrace)
    assert got == want and trace == jtrace


def test_streaming_final_text_equals_the_batch_decode(tmp_path):
    rec, _ = recognizers(tmp_path)
    wav = (np.random.RandomState(3).randn(12000) * 500).astype(np.float32)
    kw = dict(window_seconds=4.0, hop_seconds=0.2, lookahead_seconds=0.2)
    final = _stream(StreamingRecognizer(rec, **kw), wav, 1600)
    # the audio never outgrew the window: the final text is the batch
    # decode of the same power-of-two padded signal
    n = 1 << int(np.ceil(np.log2(len(wav))))
    assert final == rec.recognize(wav, pad_multiple=n)[0]
    trace = []
    _stream(StreamingRecognizer(rec, **kw), wav, 3200, trace)
    for before, after in zip(trace, trace[1:]):
        assert after[:len(before)] == before  # commits never retract


def test_streaming_long_stream_stays_within_the_window(tmp_path):
    rec, _ = recognizers(tmp_path)
    rng = np.random.RandomState(5)
    sr = StreamingRecognizer(rec, window_seconds=1.0, hop_seconds=0.25,
                             lookahead_seconds=0.1)
    for _ in range(10):
        sr.feed((rng.randn(4000) * 500).astype(np.float32))
    assert len(sr._buf) <= sr.window
    assert sr._buf_start + len(sr._buf) == 40000
    committed = list(sr._committed)
    out = sr.finish()
    assert out.split()[:len(committed)] == committed


def test_streaming_commit_no_drop_no_dup(tmp_path):
    """A fake forward emits one token per 10 ms frame whose label depends
    only on the frame's absolute stream position (encoded in a sample
    ramp), so a dropped or duplicated commit changes the text."""
    rec, _ = recognizers(tmp_path)
    hop_samples = 160

    def fake_forward(wavs, lengths):
        wav = wavs[0].numpy()
        n_valid = int(lengths[0])
        abs0 = int(round(float(wav[0])))
        t_out = max(n_valid // hop_samples, 1)
        lp = np.full((t_out, 1, 4), -10.0, np.float32)
        for i in range(t_out):
            lp[i, 0, 2 + (abs0 // hop_samples + i) % 2] = 0.0
        return torch.from_numpy(lp), torch.tensor([t_out], dtype=torch.int32)

    rec._forward = fake_forward
    sr = StreamingRecognizer(rec, window_seconds=1.0, hop_seconds=0.25,
                             lookahead_seconds=0.05)
    total = 64000  # 4 s: four windows
    out = _stream(sr, np.arange(total, dtype=np.float32), 2000).split()
    assert out == [("aa", "bb")[i % 2] for i in range(total // hop_samples)]
