"""Activation dumps (``cli/visualize.py``, ``CTCModel.forward(visualize=
True)``) against the JAX package's on the CPU: one package, one test set,
the same ``.npz`` keys and arrays (fp32, atol 1e-4), with and without the
CNN and with the 48->39 folding of the class probabilities."""

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.cli.visualize import visualize as jax_visualize
from ctc_pytorch_tpu.config import load_config as jax_load_config
from ctc_pytorch_tpu_torch.cli import visualize as cli_visualize
from ctc_pytorch_tpu_torch.config import CNNConfig, Config, load_config
from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.train.checkpoint import save_package
from ctc_pytorch_tpu_torch.vocab import Vocab

# 48-set names, some of which fold together at 39 (cl, vcl, epi -> sil)
UNITS = ["cl", "vcl", "sil", "ix", "ih", "sh", "k", "epi"]
ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(tmp_path, add_cnn):
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(0)
    (data / "units").write_text("\n".join(UNITS) + "\n")
    with ArkWriter(data / "f.ark", data / "f.scp") as w, \
            open(data / "phn_text", "w") as lab:
        for i, t in enumerate((27, 19, 33)):
            w.write(f"u{i}", rng.randn(t, 20).astype(np.float32))
            lab.write(f"u{i} sh ih k cl\n")
    cfg = Config()
    cfg.vocab_file = str(data / "units")
    cfg.test_scp_path = str(data / "f.scp")
    cfg.test_lab_path = str(data / "phn_text")
    cfg.feature_dim = cfg.rnn_input_size = 20
    cfg.left_ctx = cfg.right_ctx = 0
    cfg.n_skip_frame = cfg.n_downsample = 1
    cfg.rnn_hidden_size, cfg.rnn_layers = 8, 2
    cfg.cnn = CNNConfig(add_cnn=add_cnn, layers=1, channel=[(1, 4)],
                        kernel_size=[(3, 3)], stride=[(1, 2)],
                        padding=[(1, 1)])
    cfg.dtype, cfg.drop_out = "float32", 0.0
    conf = tmp_path / "conf.yaml"
    cfg.to_yaml(conf)
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    model = CTCModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():  # BN statistics off identity
        for name, buf in model.named_buffers():
            if name.endswith(("mean", "var")):
                buf.copy_(0.5 + torch.rand(buf.shape,
                                           generator=torch.Generator()
                                           .manual_seed(len(name))))
    pkg = tmp_path / "m.npz"
    save_package(pkg, spec, model, config=cfg)
    return conf, pkg, model


@pytest.mark.parametrize("add_cnn,fold", [(True, False), (False, False),
                                          (True, True)])
def test_npz_matches_the_jax_dump(tmp_path, add_cnn, fold):
    conf, pkg, model = setup(tmp_path, add_cnn)
    argv = ["--conf", str(conf), "--package", str(pkg), "--out",
            str(tmp_path / "port" / "act.npz"), "--device", "cpu"]
    out = cli_visualize.main(argv + (["--fold-48-39"] if fold else []))
    jout = jax_visualize(jax_load_config(conf), str(pkg),
                         str(tmp_path / "jax" / "act.npz"), fold,
                         log=lambda *a: None)
    got, want = np.load(out), np.load(jout)
    keys = {"utt", "input", "log_probs"} | (
        {"post_cnn", "pre_rnn"} if add_cnn else set()) | (
        {"folded_names", "folded_probs"} if fold else set())
    assert set(got.files) == set(want.files) == keys
    assert str(got["utt"]) == str(want["utt"]) == "u0"
    for k in keys - {"utt", "folded_names"}:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)
    assert got["input"].shape == (27, 20)
    if add_cnn:
        assert got["post_cnn"].shape == (4, 27, 10)
        assert got["pre_rnn"].shape == (27, 40)
    np.testing.assert_allclose(np.exp(got["log_probs"]).sum(-1), 1.0,
                               rtol=1e-4)
    if fold:
        assert list(got["folded_names"]) == list(want["folded_names"])
        assert "cl" not in got["folded_names"] and "sil" in got["folded_names"]
        np.testing.assert_allclose(got["folded_probs"].sum(-1), 1.0, rtol=1e-4)
    # the dump's log-probs are the model's eval forward of that utterance
    x = torch.from_numpy(got["input"][None])
    with torch.no_grad():
        lp, visual = model(x, visualize=True)
    assert len(visual) == (4 if add_cnn else 2)
    np.testing.assert_array_equal(visual[-1][:, 0].numpy(), got["log_probs"])
    np.testing.assert_array_equal(lp.numpy(), visual[-1].numpy())


def test_visualize_raises_without_a_card(tmp_path, monkeypatch):
    conf, pkg, _ = setup(tmp_path, False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_visualize.main(["--conf", str(conf), "--package", str(pkg),
                            "--out", str(tmp_path / "v" / "a.npz")])
    assert not (tmp_path / "v").exists()
    assert load_config(conf).test_scp_path.endswith("f.scp")
