"""The port's pipeline orchestrator (``cli/run.py``, stages 0-4) against
the JAX package's on the CPU, on a synthetic TIMIT tree
(``chip_smoke.write_timit_corpus``): stages 0 and 1 write the JAX run's
scp, transcript and units bytes and features within ``TOL`` of its
(``tests/test_torch_frontend.py``; the corpus's bands vary in loudness as
speech does, so the float32 CMVN of the JAX stage 1 resolves its
variances), but for mel bands under ``FLOOR`` of their frame's strongest
band, which the JAX package's float32 FFT sets and which are held, as
``tests/test_torch_frontend.py`` holds them, to lie within that floor;
``_conf_for_data`` writes the JAX ``conf_resolved.yaml`` from
a YAML and from an INI conf; stages 2-4 on a cut flagship conf leave a
package that the JAX ``cli.test`` decodes to the port's strings; without
``--device cpu`` and without a card the run raises before any stage."""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.cli import run as jax_run
from ctc_pytorch_tpu.cli.test import evaluate as jax_evaluate
from ctc_pytorch_tpu.config import load_config as jax_load_config
from ctc_pytorch_tpu_torch.cli import run
from ctc_pytorch_tpu_torch.cli.test import evaluate
from ctc_pytorch_tpu_torch.config import load_config
from ctc_pytorch_tpu_torch.data.kaldi_io import iter_ark
from ctc_pytorch_tpu_torch.train.checkpoint import model_from_package
from tests.test_torch_cuda import chip_smoke

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=3e-4)
FLOOR = 1e-8  # of the frame's strongest band: the fp32 FFT's noise floor
TEXT = ("wav.scp", "phn_text", "wrd_text")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def timit(tmp_path_factory):
    root = tmp_path_factory.mktemp("timit")
    counts = chip_smoke.write_timit_corpus(root, 2, 1, 1, seed=7,
                                           phones_per_utt=(4, 9))
    return root, counts


def test_stages_0_and_1_match_the_jax_run(timit, tmp_path):
    corpus, counts = timit
    data, jdata = tmp_path / "data", tmp_path / "jax_data"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main(["--timit", str(corpus), "--data", str(data), "--stage", "0",
                  "--stop-stage", "1", "--device", "cpu"])
    assert f"Data preparation succeeded: {counts}" in out.getvalue()
    jax_run.main(["--timit", str(corpus), "--data", str(jdata), "--stage",
                  "0", "--stop-stage", "1"])
    got, want = (np.load(d / "global_fbank_cmvn.npz") for d in (data, jdata))
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["inv_std"], want["inv_std"], rtol=1e-4)
    for split in ("train", "dev", "test"):
        for name in TEXT:
            assert ((data / split / name).read_bytes()
                    == (jdata / split / name).read_bytes())
        ours = dict(iter_ark(data / split / "fbank.ark"))
        ref = dict(iter_ark(jdata / split / "fbank.ark"))
        assert list(ours) == list(ref) and len(ours) == counts[split]
        for utt, feats in ref.items():
            assert ours[utt].shape == feats.shape and feats.shape[1] == 81
            close_features(ours[utt], feats, got, want)
        scp = (data / split / "fbank.scp").read_text()
        assert scp == (jdata / split / "fbank.scp").read_text().replace(
            str(jdata), str(data))
    assert (data / "units").read_bytes() == (jdata / "units").read_bytes()


def close_features(ours, ref, cmvn, jcmvn):
    """Stage 1's normalised fbank (energy first, then the mel bands) against
    the JAX package's: within ``TOL`` where a band holds more than
    ``FLOOR`` of its frame's strongest band's power, and below that, the
    bands' powers within ``FLOOR`` of that strongest."""
    raw = ref / jcmvn["inv_std"] + jcmvn["mean"]  # log powers, JAX stats
    mine = ours / cmvn["inv_std"] + cmvn["mean"]
    top = raw[:, 1:].max(1, keepdims=True)
    deep = np.zeros(ref.shape, bool)
    deep[:, 1:] = raw[:, 1:] < top + np.log(FLOOR)
    np.testing.assert_allclose(ours[~deep], ref[~deep], **TOL)
    top = np.broadcast_to(top, ref.shape)[deep]
    np.testing.assert_allclose(np.exp(mine[deep] - top),
                               np.exp(raw[deep] - top), rtol=0, atol=FLOOR)


@pytest.mark.parametrize("conf", ["timit/ctc_config.yaml",
                                  "my_863/lstm_ctc.conf"])
def test_conf_for_data_writes_the_jax_file(tmp_path, conf):
    src = ROOT / "recipes" / conf
    data = tmp_path / "elsewhere"
    out = run._conf_for_data(str(src), str(data))
    assert out == str(data / "conf_resolved.yaml")
    ours = Path(out).read_bytes()
    assert jax_run._conf_for_data(str(src), str(data)) == out
    assert Path(out).read_bytes() == ours
    cfg = load_config(out)
    assert cfg.data_dir == str(data)
    assert cfg.vocab_file == str(data / "units")
    assert cfg.train_scp_path.startswith(str(data))
    # every other key as the source conf has it
    for key, v in load_config(src).to_dict().items():
        if isinstance(v, str) and v.startswith("data/"):
            assert cfg.to_dict()[key] == str(data / v[len("data/"):]), key
        elif key != "data_dir":
            assert cfg.to_dict()[key] == v, key
    # a conf already on --data is used as it is
    assert run._conf_for_data(out, str(data)) == out


def test_stages_2_to_4_leave_a_package_the_jax_stage_4_decodes(timit,
                                                               tmp_path):
    corpus, counts = timit
    data = tmp_path / "data"
    with contextlib.redirect_stdout(io.StringIO()):
        run.main(["--timit", str(corpus), "--data", str(data), "--stage", "0",
                  "--stop-stage", "1", "--device", "cpu"])
    # the flagship recipe cut in width and depth, fp32, one epoch
    cut = (ROOT / "recipes/timit/ctc_config.yaml").read_text()
    for a, b in (("rnn_hidden_size: 384", "rnn_hidden_size: 8"),
                 ("rnn_layers: 4", "rnn_layers: 2"),
                 ('channel: "[(1, 32), (32, 32)]"', 'channel: "[(1, 4), (4, 4)]"'),
                 ('dtype: "bfloat16"', 'dtype: "float32"'),
                 ("drop_out: 0.2", "drop_out: 0.0"),
                 ("num_epoches: 500", "num_epoches: 1"),
                 ("checkpoint_dir: 'checkpoint/'",
                  f"checkpoint_dir: '{tmp_path / 'checkpoint'}'")):
        assert a in cut
        cut = cut.replace(a, b)
    conf = tmp_path / "cut.yaml"
    conf.write_text(cut)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main(["--data", str(data), "--conf", str(conf), "--stage", "2",
                  "--device", "cpu"])
    printed = out.getvalue().splitlines()
    assert (data / "lm_phone_bg.arpa").exists()  # stage 3
    resolved = data / "conf_resolved.yaml"
    best = tmp_path / "checkpoint" / "ctc_fbank_cnn" / "ctc_best_model.npz"
    spec, _, manifest = model_from_package(best, "cpu")
    assert spec.rnn_hidden_size == 8 and spec.add_cnn and manifest["step"] > 0
    cfg, jcfg = load_config(resolved), jax_load_config(resolved)
    got_lines, want_lines = [], []
    got = evaluate(cfg, str(best), device="cpu", log=got_lines.append)
    want = jax_evaluate(jcfg, str(best), log=want_lines.append)
    n = 3 * counts["test"]
    assert got_lines[:n + 2] == want_lines[:n + 2]
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]
    # stage 4 of the run printed the same utterances and scores
    decoded = [ln for ln in printed if ln.startswith("decoded: ")]
    assert decoded == [ln for ln in got_lines if ln.startswith("decoded: ")]
    assert f"word error rate on test set: {got['wer']:.4f}" in printed


def test_the_run_raises_without_a_card(timit, tmp_path, monkeypatch):
    corpus, _ = timit
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for stages in (["--stage", "0"], ["--stage", "1", "--stop-stage", "1"],
                   ["--stage", "4"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.main(["--timit", str(corpus), "--data", str(tmp_path / "d"),
                      *stages])
    assert not (tmp_path / "d").exists()
    # stages 0 and 3 are host-only: they need no card
    with contextlib.redirect_stdout(io.StringIO()):
        run.main(["--timit", str(corpus), "--data", str(tmp_path / "d"),
                  "--stage", "0", "--stop-stage", "0"])
        run.main(["--data", str(tmp_path / "d"), "--stage", "3",
                  "--stop-stage", "3"])
    assert (tmp_path / "d" / "lm_phone_bg.arpa").exists()


def test_chip_smoke_phase13_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 13 with ``device="cpu"`` on the flagship
    recipe cut in width and depth (fp32), on a tree of four speakers:
    stages 0-4 through ``cli.run`` with ``profile: True``, every stage-2
    utterance read natively, the trace written, ``cli.visualize`` against
    the model's forward and ``cli.import_torch`` against the
    reference-format module's."""
    cut = (ROOT / "recipes/timit/ctc_config.yaml").read_text()
    for a, b in (("rnn_hidden_size: 384", "rnn_hidden_size: 8"),
                 ("rnn_layers: 4", "rnn_layers: 2"),
                 ('channel: "[(1, 32), (32, 32)]"', 'channel: "[(1, 4), (4, 4)]"'),
                 ('dtype: "bfloat16"', 'dtype: "float32"')):
        assert a in cut
        cut = cut.replace(a, b)
    (tmp_path / "cut.yaml").write_text(cut)
    monkeypatch.setattr(chip_smoke, "RECIPE_PIPELINE", tmp_path / "cut.yaml")
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    monkeypatch.setattr(chip_smoke, "PIPELINE_SPEAKERS", (2, 1, 1))
    out = chip_smoke.phase_pipeline_slice("cpu", device="cpu")
    assert out["utterances"] == {"train": 16, "dev": 8, "test": 8}
    assert out["reads_stage2"] == {"native": 24, "numpy": 0}
    assert out["steps"] == 2 and set(out["stage_walls_s"]) == {
        0, 1, 2, 3, 4, "2_without_profile"}
    assert out["trace"]["bytes"] > 0 and out["readers"]["utts"] == 16
    assert out["visualize_err"] <= 1e-4 and out["import_err"] <= 1e-3
