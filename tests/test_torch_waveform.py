"""The waveform-in path of the port against the JAX package on the CPU: the
step's frontend (``frontend/e2e.py``), the dataset's waveform items and
batches, three fp32 optimizer steps of ``recipes/timit/waveform_config.yaml``
through both ``Trainer``s (streaming, and fused, which runs eagerly on the
CPU), and stage 1 -> stage 2 -> stage 4 through the CLIs on a tiny audio
corpus of SPHERE and WAV files.

The recipe is cut only in width and depth (12 mel bins + energy, 2 x
BiLSTM(16)), with ``drop_out: 0`` and fp32.  Features to atol 3e-4, rtol
1e-5 (``tests/test_frontend_fixture.py``); losses to rtol 1e-4 and
parameters to 1e-4 absolute (``tests/test_torch_mfcc39.py``): the same fp32
math in another summation order, from one init."""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.cli import make_feat as jax_make_feat
from ctc_pytorch_tpu.cli.test import evaluate as jax_evaluate
from ctc_pytorch_tpu.config import load_config as jax_load_config
from ctc_pytorch_tpu.data import SpeechDataLoader as JLoader
from ctc_pytorch_tpu.data import SpeechDataset as JDataset
from ctc_pytorch_tpu.frontend import e2e as je2e
from ctc_pytorch_tpu.frontend.features import FrontendConfig as JFrontendConfig
from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
from ctc_pytorch_tpu.train.loop import Trainer as JTrainer
from ctc_pytorch_tpu.train.state import TrainState as JTrainState
from ctc_pytorch_tpu.train.state import snapshot as jax_snapshot
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.cli import make_feat, train_lm
from ctc_pytorch_tpu_torch.cli import train as cli_train
from ctc_pytorch_tpu_torch.cli.test import evaluate
from ctc_pytorch_tpu_torch.config import load_config
from ctc_pytorch_tpu_torch.data import (
    SpeechDataLoader,
    SpeechDataset,
    estimate_bytes,
)
from ctc_pytorch_tpu_torch.data.kaldi_io import iter_ark, read_scp
from ctc_pytorch_tpu_torch.data.prep.sphere import read_audio
from ctc_pytorch_tpu_torch.frontend import e2e
from ctc_pytorch_tpu_torch.frontend.features import FrontendConfig
from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec
from ctc_pytorch_tpu_torch.train.checkpoint import params_to_jax
from ctc_pytorch_tpu_torch.train.loop import Trainer
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_cuda import chip_smoke
from tests.test_torch_fused_order import jax_loaders
from tests.test_torch_frontend import close_log_power
from tests.test_torch_train import assert_state_matches, to_jnp

RECIPE = (Path(__file__).resolve().parent.parent
          / "recipes/timit/waveform_config.yaml")
PHONES = ["aa", "ae", "b", "d", "iy", "k", "s", "sh"]
TOL = dict(rtol=1e-5, atol=3e-4)
RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run the port's steps as many small ops: in one thread
    they run about as fast alone and do not spin against the suite's other
    workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def audio_corpus(root: Path, sizes=(("train", 24), ("dev", 8), ("test", 8)),
                 seconds=(0.3, 0.7)):
    """``chip_smoke.py``'s synthetic audio corpus at a small size: SPHERE
    and WAV files of 0.3-0.7 s, ``wav.scp``, ``phn_text`` and ``units``."""
    for seed, (split, n) in enumerate(sizes):
        chip_smoke.write_audio_corpus(root, split, n, seed, seconds, PHONES)


def recipe(load, root: Path, exp_name="wave"):
    """The waveform recipe as shipped, its data under ``root``, cut in width
    and depth, fp32, without dropout; the LM at ``root``; a beam capacity
    that truncates nothing."""
    cfg = load(RECIPE)
    assert cfg.feature_type == "waveform" and not cfg.mel
    assert (cfg.feature_dim, cfg.rnn_input_size, cfg.rnn_hidden_size,
            cfg.rnn_layers) == (81, 243, 384, 4)
    assert not cfg.cnn.add_cnn and cfg.rnn_type == "nn.LSTM" and cfg.bidirectional
    assert (cfg.left_ctx, cfg.right_ctx, cfg.n_skip_frame,
            cfg.n_downsample) == (0, 2, 2, 2)
    assert cfg.batch_size == 128 and cfg.dtype == "bfloat16"
    assert cfg.device_cache and cfg.fused_epoch and cfg.host_prefetch
    assert cfg.fused_dispatch == "epoch" and cfg.num_buckets == 4
    assert (cfg.decode_type, cfg.beam_width, cfg.lm_alpha) == ("BeamDevice",
                                                              20, 0.1)
    cfg.vocab_file = str(root / "units")
    for key, split in (("train", "train"), ("valid", "dev"), ("test", "test")):
        setattr(cfg, f"{key}_scp_path", str(root / split / "wav.scp"))
        setattr(cfg, f"{key}_lab_path", str(root / split / "phn_text"))
    cfg.data_dir = str(root)
    cfg.lm_path = str(root / "lm_phone_bg.arpa")
    cfg.checkpoint_dir, cfg.exp_name = str(root / "checkpoint"), exp_name
    cfg.feature_dim, cfg.rnn_input_size = 13, 39
    cfg.rnn_hidden_size, cfg.rnn_layers = 16, 2
    cfg.batch_size, cfg.drop_out, cfg.dtype = 8, 0.0, "float32"
    cfg.beam_max_len = 64
    return cfg


# ---------------------------------------------------------------------------
# the step's frontend
# ---------------------------------------------------------------------------

SPECS = [
    ("fbank", 0, 2, 2, 1), ("fbank", 1, 1, 2, 4), ("mfcc", 0, 1, 1, 2),
    ("mfcc39", 2, 0, 3, 1), ("spectrogram", 0, 1, 2, 2),
]


def _batch(seed=0):
    wav = np.zeros((3, 4800), np.float32)
    lens = np.array([4800, 3000, 350], np.int32)  # the last: no whole frame
    rng = np.random.RandomState(seed)
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000.0
        wav[i, :n] = (3000 * np.sin(2 * np.pi * rng.uniform(150, 900) * t)
                      + 300 * rng.randn(n))
    return wav, lens


@pytest.mark.parametrize("feat_type,left,right,skip,down", SPECS)
def test_waveform_frontend_matches_jax(feat_type, left, right, skip, down):
    """Features, frame fractions and valid frame counts of a padded batch,
    downsample padding included, with and without CMVN."""
    kw = dict(feat_type=feat_type, left_ctx=left, right_ctx=right,
              n_skip_frame=skip, n_downsample=down)
    spec = e2e.WaveFrontendSpec(frontend=FrontendConfig(num_mel_bins=12), **kw)
    jspec = je2e.WaveFrontendSpec(frontend=JFrontendConfig(num_mel_bins=12),
                                  **kw)
    assert spec.feature_dim() == jspec.feature_dim()
    wav, lens = _batch()
    dim = spec.feature_dim() // (left + right + 1)
    rng = np.random.RandomState(1)
    stats = (rng.randn(dim).astype(np.float32),
             rng.uniform(0.5, 2, dim).astype(np.float32))
    for cmvn in (None, stats):
        got = e2e.waveform_frontend(
            spec, torch.from_numpy(wav), torch.from_numpy(lens),
            None if cmvn is None else tuple(map(torch.from_numpy, cmvn)))
        want = je2e.waveform_frontend(
            jspec, jnp.asarray(wav), jnp.asarray(lens),
            None if cmvn is None else tuple(map(jnp.asarray, cmvn)))
        assert got[0].shape == want[0].shape
        assert got[0].shape[1] % down == 0
        if feat_type == "spectrogram" and cmvn is None:
            close_log_power(got[0], want[0])
        elif feat_type != "spectrogram":
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       **TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[2][-1] == 0 and (got[2] % down == 0).all()
    # the step's closure: (B, S, 1) planes, sample counts as float32
    fn = e2e.build_frontend_fn(spec, stats)
    jfn = je2e.build_frontend_fn(jspec, stats)
    got = fn(torch.from_numpy(wav[..., None]), torch.from_numpy(lens).float())
    want = jfn(jnp.asarray(wav[..., None]), jnp.asarray(lens, jnp.float32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if feat_type != "spectrogram":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)


def test_frontend_from_config_reads_the_stage1_stats(tmp_path):
    cfg = load_config(RECIPE)
    cfg.data_dir = str(tmp_path)
    assert e2e.cmvn_from_config(cfg) is None
    spec = e2e.spec_from_config(cfg)
    assert spec.frontend.num_mel_bins == 80 and spec.feature_dim() == 243
    assert (spec.right_ctx, spec.n_skip_frame, spec.n_downsample) == (2, 2, 2)
    mean, inv = np.arange(81, dtype=np.float32), np.ones(81, np.float32)
    np.savez(tmp_path / "global_fbank_cmvn.npz", mean=mean, inv_std=inv)
    got = e2e.cmvn_from_config(cfg)
    np.testing.assert_array_equal(got[0], mean)
    wav, lens = _batch()
    feats, _, _ = e2e.frontend_fn_from_config(cfg)(
        torch.from_numpy(wav), torch.from_numpy(lens).float())
    jfeats, _, _ = je2e.frontend_fn_from_config(cfg)(jnp.asarray(wav),
                                                     jnp.asarray(lens))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), **TOL)
    cfg.feature_type = "fbank"
    assert e2e.frontend_fn_from_config(cfg) is None


def test_waveform_batches_match_jax(tmp_path):
    """The loaders bucket and pad raw samples by sample count, as the JAX
    loaders do, with the sample counts in ``input_lengths``."""
    audio_corpus(tmp_path, (("train", 13),))
    cfg, jcfg = recipe(load_config, tmp_path), recipe(jax_load_config, tmp_path)
    ds = SpeechDataset(Vocab(cfg.vocab_file), cfg.train_scp_path,
                       cfg.train_lab_path, cfg)
    jds = JDataset(JVocab(jcfg.vocab_file), jcfg.train_scp_path,
                   jcfg.train_lab_path, jcfg)
    kw = dict(shuffle=True, num_buckets=cfg.num_buckets, seed=2)
    loader, jloader = SpeechDataLoader(ds, 4, **kw), JLoader(jds, 4, **kw)
    for a, b in zip(loader, jloader):
        assert a.feats.shape[2] == 1 and a.feats.shape == b.feats.shape
        for field in ("feats", "input_frac", "input_lengths", "labels",
                      "label_lengths", "example_mask"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        assert a.utts == b.utts
    assert estimate_bytes(loader) == 13 * (loader.batcher.boundaries[-1] * 4
                                           + loader.batcher.label_pad * 4 + 8)


# ---------------------------------------------------------------------------
# the Trainer, streaming and fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_three_waveform_steps_through_the_trainer_match_jax(tmp_path, fused):
    """One epoch of three batches through both ``Trainer``s with their
    step frontends and the stage-1 CMVN stats, from one init: the losses of
    the train and dev passes, then parameters, BN state and Adam moments."""
    audio_corpus(tmp_path, (("train", 24), ("dev", 8)))
    make_feat.main(["fbank", str(tmp_path), "--num-mel-bins", "12",
                    "--splits", "train", "--device", "cpu"])
    cfg, jcfg = recipe(load_config, tmp_path), recipe(jax_load_config, tmp_path)
    for c in (cfg, jcfg):
        c.fused_epoch = c.device_cache = fused
    vocab = Vocab(cfg.vocab_file)
    tr, dv = cli_train.build_loaders(cfg, vocab, device="cpu")
    assert len(tr) == 3
    if fused:
        jtr, jdv = jax_loaders(jcfg)
    else:
        jvocab = JVocab(jcfg.vocab_file)
        jtr, jdv = (JLoader(JDataset(jvocab, scp, lab, jcfg), jcfg.batch_size,
                            shuffle=shuffle, num_buckets=jcfg.num_buckets,
                            seed=jcfg.seed, mode=jcfg.batch_mode)
                    for scp, lab, shuffle in (
                        (jcfg.train_scp_path, jcfg.train_lab_path, True),
                        (jcfg.valid_scp_path, jcfg.valid_lab_path, False)))
    spec = ModelSpec.from_config(cfg, num_class=vocab.n_words)
    jspec = JSpec.from_config(jcfg, num_class=JVocab(jcfg.vocab_file).n_words)
    assert spec.to_dict() == jspec.to_dict() and spec.rnn_input_size == 39
    trainer = Trainer(cfg, spec, device="cpu",
                      frontend_fn=e2e.frontend_fn_from_config(cfg))
    jtrainer = JTrainer(jcfg, jspec,
                        frontend_fn=je2e.frontend_fn_from_config(jcfg))
    p, s = params_to_jax(spec, trainer.state.model.state_dict())
    jtrainer.state = JTrainState(jnp.zeros((), jnp.int32), to_jnp(p), to_jnp(s),
                                 jtrainer.tx.init(to_jnp(p)))
    jtrainer._rollback = jax_snapshot(jtrainer.state)
    jtrainer._best = jax_snapshot(jtrainer.state)
    lines = []
    trainer.fit(tr, dv, num_epoches=1, log=lines.append)
    jtrainer.fit(jtr, jdv, num_epoches=1, log=lambda *a, **k: None)
    assert any(ln.startswith("fused_epoch: the epochs run over the device "
                             "cache") for ln in lines) == fused
    assert trainer.state.step == int(jtrainer.state.step) == 3
    for key in ("loss_results", "dev_loss_results"):
        np.testing.assert_allclose(trainer.histories[key],
                                   jtrainer.histories[key], rtol=RTOL)
    assert_state_matches(spec, trainer.state, jtrainer.state)


# ---------------------------------------------------------------------------
# stage 1 -> stage 2 -> stage 4 through the CLIs
# ---------------------------------------------------------------------------

def test_stage1_train_and_stage4_match_the_jax_clis(tmp_path):
    """Stage 1 of both packages on one corpus gives the same ark and CMVN
    files; stage 2 of the port (``cli.train --device cpu``) trains the
    waveform recipe from them, and stage 4 of the saved package gives the
    JAX CLI's strings and scores with ``Greedy`` and ``BeamDevice``."""
    root, jroot = tmp_path / "data", tmp_path / "jax_data"
    fcfg = FrontendConfig(num_mel_bins=12)
    audio_corpus(root)
    shutil.copytree(root, jroot)
    argv = ["fbank", "--num-mel-bins", "12", "--splits", "train", "dev", "test"]
    jax_make_feat.main([argv[0], str(jroot)] + argv[1:])
    make_feat.main([argv[0], str(root)] + argv[1:] + ["--device", "cpu"])
    got, want = (np.load(r / "global_fbank_cmvn.npz") for r in (root, jroot))
    # the port's stats are the float64 statistics of its features; the JAX
    # stats sum in float32, which resolves the variances of this corpus,
    # whose bands vary in loudness as speech does, to ~1e-4
    def raw_feats(path):
        padded, t = make_feat.padded_audio(read_audio(path), "fbank", fcfg)
        return make_feat.extract_features(padded, "fbank", fcfg,
                                          device="cpu")[:t].numpy()

    raw = np.concatenate([raw_feats(path) for _, path in read_scp(
        root / "train" / "wav.scp")]).astype(np.float64)
    np.testing.assert_allclose(got["mean"], raw.mean(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["inv_std"], 1 / raw.std(0), rtol=1e-6)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["inv_std"], want["inv_std"], rtol=1e-4)
    for split in ("train", "dev", "test"):
        ours = dict(iter_ark(root / split / "fbank.ark"))
        ref = dict(iter_ark(jroot / split / "fbank.ark"))
        assert list(ours) == list(ref)
        for utt, feats in ref.items():
            assert ours[utt].shape == feats.shape == (ours[utt].shape[0], 13)
            np.testing.assert_allclose(ours[utt], feats, **TOL)

    cfg = recipe(load_config, root)
    conf = tmp_path / "wave.yaml"
    cfg.num_epoches = 2
    cfg.to_yaml(conf)
    best = cli_train.main(["--conf", str(conf), "--device", "cpu"])
    assert best.exists()
    train_lm.main([str(root)])
    n = 3 * 8
    jcfg = recipe(jax_load_config, root)
    for decode_type in ("Greedy", "BeamDevice"):
        cfg.decode_type = jcfg.decode_type = decode_type
        got_lines, want_lines = [], []
        res = evaluate(cfg, str(best), device="cpu", log=got_lines.append)
        jres = jax_evaluate(jcfg, str(best), log=want_lines.append)
        assert "fused" not in res  # no fused waveform decode, as in JAX
        assert got_lines[:n + 2] == want_lines[:n + 2]
        assert res["cer"] == jres["cer"] and res["wer"] == jres["wer"]
        assert any(ln.startswith("decoded: ") and len(ln.split()) > 2
                   for ln in got_lines)


def test_chip_smoke_phase12_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 12 with ``device="cpu"``, on the recipe cut
    in width, depth and batch (the runners run eagerly): stage 1, stage 3,
    one fused epoch through ``cli.train.train``, stage 4 with ``Greedy`` and
    ``BeamDevice``, ``Recognizer`` (its fp32 strings equal to stage 4's)
    and ``StreamingRecognizer``, and the graphed-against-streaming
    comparison."""
    cut = RECIPE.read_text()
    for a, b in (("rnn_hidden_size: 384", "rnn_hidden_size: 16"),
                 ("rnn_layers: 4", "rnn_layers: 2"),
                 ("batch_size: 128", "batch_size: 8"),
                 ('dtype: "bfloat16"', 'dtype: "float32"')):
        assert a in cut
        cut = cut.replace(a, b)
    (tmp_path / "wave.yaml").write_text(cut)
    monkeypatch.setattr(chip_smoke, "RECIPE_WAVE", tmp_path / "wave.yaml")
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    monkeypatch.setattr(chip_smoke, "WAVE_SPLITS", (
        ("train", 16, 1), ("dev", 4, 2), ("test", 8, 3)))
    # utterances of 0.3-0.6 s and a 2 s stream: the CPU's plain recurrences
    # step frame by frame, so the card's 1-4 s and 20 s would take minutes
    write = chip_smoke.write_audio_corpus
    monkeypatch.setattr(chip_smoke, "write_audio_corpus",
                        lambda root, split, n, seed: write(root, split, n, seed,
                                                           (0.3, 0.6)))
    monkeypatch.setattr(chip_smoke, "STREAM_SECONDS", 2.0)
    out = chip_smoke.phase_waveform_slice("cpu", device="cpu")
    assert out["steps"] == 2 and out["corpus_utts"] == 28
    assert out["serving"]["recognizer_fp32"]["equal"] == 8
    assert out["serving"]["streaming"]["feeds"] == 4
    assert set(out["stage4"]) == {"Greedy", "BeamDevice"}
    assert out["fused_vs_streaming"]["train_steps"] == 2
