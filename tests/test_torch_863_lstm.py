"""The two 863 LSTM recipes as shipped, ``recipes/my_863/cnn_lstm_ctc.conf``
(201-d log spectrum, CNN 1->16 (11, 5) stride (2, 2) + Hardtanh(0, 20),
BiLSTM stack) and ``recipes/my_863/lstm_ctc.conf`` (40-d fbank, no CNN),
through the port against the JAX package on the CPU: ``rnn_type =
nn.LSTM`` as shipped, batch 16, the accuracy-keyed scheduler,
``dev_over_train`` and the fused epoch dispatched once an epoch.  The
corpus is ingested the reference's 863 way: a text-format Kaldi dump
converted by ``data/convert.py:text_ark_to_binary``.  The recipes are cut
only in width and depth (H=8, 2 layers), with fp32.

Losses to rtol 1e-4 and parameters to 1e-4 absolute, as
``tests/test_torch_mfcc39.py``, on all but a share of 1e-4 of the entries,
which are held to Adam's sign-flip bound instead (``assert_state_close``);
the greedy strings of stage 4 equal."""

from itertools import islice
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.cli.test import evaluate as jax_evaluate
from ctc_pytorch_tpu.config import load_config as jax_load_config
from ctc_pytorch_tpu.data import SpeechDataLoader as JLoader
from ctc_pytorch_tpu.data import SpeechDataset as JDataset
from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
from ctc_pytorch_tpu.train.loop import Trainer as JTrainer
from ctc_pytorch_tpu.train.loop import make_step_fns
from ctc_pytorch_tpu.train.state import TrainState as JTrainState
from ctc_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
from ctc_pytorch_tpu.train.state import snapshot as jax_snapshot
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.cli import train as cli_train
from ctc_pytorch_tpu_torch.cli.test import evaluate
from ctc_pytorch_tpu_torch.config import load_config
from ctc_pytorch_tpu_torch.data import GroupedLoader, SpeechDataLoader, SpeechDataset
from ctc_pytorch_tpu_torch.data.convert import text_ark_to_binary
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.train.checkpoint import params_from_jax, params_to_jax
from ctc_pytorch_tpu_torch.train.loop import Trainer, train_step
from ctc_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_cuda import chip_smoke
from tests.test_torch_fused_order import jax_loaders
from tests.test_torch_model import jax_weights
from ctc_pytorch_tpu_torch.train.checkpoint import opt_state_leaves
from tests.test_torch_train import to_jnp

RECIPES = Path(__file__).resolve().parent.parent / "recipes" / "my_863"
# recipe -> (features, dim, CNN)
SHIPPED = {"cnn_lstm_ctc": ("spectrum", 201, True),
           "lstm_ctc": ("fbank", 40, False)}
RTOL = 1e-4
TOL = 1e-4
# Adam's first steps move an entry by about +-lr whatever its gradient's
# size; where the recipes' coupled decay (0.005 w) cancels the gradient to
# ~1e-9, the two frameworks' rounding picks the sign, and the entry parts
# by up to 2 lr a step.  chip_smoke.py holds kernels to twins the same way
# (STEP_OFF_SHARE)
OFF_SHARE = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def corpus(root: Path, recipe: str, sizes=(("train", 48), ("dev", 16))):
    """The recipe's layout under ``root``: a text dump per split converted
    to ``<feats>.ark/.scp``, ``text`` labels over the 65 units."""
    feats, dim, _ = SHIPPED[recipe]
    for seed, (split, n) in enumerate(sizes):
        text = chip_smoke.write_text_corpus(
            root, split, n, seed, dim, chip_smoke.UNITS_863, feats,
            frames=(20, 61))
        assert text_ark_to_binary(text, root / split / f"{feats}.ark",
                                  root / split / f"{feats}.scp") == n


def recipe_config(load, root: Path, recipe: str, exp_name: str):
    """The recipe as shipped, its data under ``root`` (the test set is the
    dev split), cut in width and depth, fp32."""
    feats, dim, cnn = SHIPPED[recipe]
    cfg = load(RECIPES / f"{recipe}.conf")
    assert cfg.rnn_type == "nn.LSTM" and cfg.rnn_cell == "lstm"
    assert cfg.bidirectional and cfg.batch_norm and cfg.drop_out == 0
    assert (cfg.feature_dim, cfg.rnn_input_size, cfg.rnn_hidden_size,
            cfg.rnn_layers, cfg.num_class) == (dim, dim, 256, 4, 66)
    assert cfg.cnn.add_cnn == cnn and cfg.n_downsample == (2 if cnn else 1)
    assert (cfg.left_ctx, cfg.right_ctx, cfg.n_skip_frame) == (0, 0, 1)
    assert cfg.batch_size == 16 and cfg.dtype == "bfloat16"
    assert cfg.scheduler_mode == "acc" and cfg.dev_over_train
    assert cfg.grad_clip == 400 and cfg.weight_decay == 0.005
    assert cfg.fused_epoch and cfg.fused_dispatch == "epoch"
    if cnn:
        assert cfg.cnn.kernel_size == [(11, 5)] and cfg.cnn.stride == [(2, 2)]
        assert cfg.cnn.activation_function == "hardtanh"
    cfg.vocab_file = str(root / "units")
    for key, split in (("train", "train"), ("valid", "dev"), ("test", "dev")):
        setattr(cfg, f"{key}_scp_path", str(root / split / f"{feats}.scp"))
        setattr(cfg, f"{key}_lab_path", str(root / split / "text"))
    cfg.checkpoint_dir, cfg.exp_name = str(root / "checkpoint"), exp_name
    cfg.log_dir = str(root / "log")
    cfg.rnn_hidden_size, cfg.rnn_layers, cfg.dtype = 8, 2, "float32"
    return cfg


def assert_state_close(spec, state, jstate, lr, steps):
    """Parameters, BN state and Adam moments of the port against the JAX
    package's: within ``TOL`` (the moments also rtol 1e-6) but for at most
    ``OFF_SHARE`` of all entries, where a sign flip moved a parameter (by at
    most 2 lr a step) and, through the forward, the next gradients a little;
    no parameter parts by more than 2 lr a step."""
    got_p, got_s = params_to_jax(spec, state.model.state_dict())
    pairs = []
    for got, want in ((got_p, jstate.params), (got_s, jstate.model_state)):
        g_leaves, g_def = jax.tree_util.tree_flatten(got)
        w_leaves, w_def = jax.tree_util.tree_flatten(want)
        assert g_def == w_def
        for g, w in zip(g_leaves, w_leaves):
            d = np.abs(g - np.asarray(w))
            assert d.max() <= 2 * lr * steps * 1.01
            pairs.append(d > TOL)
    shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(jstate.params)]
    got_opt = opt_state_leaves(state.optimizer, shapes)
    want_opt = jax.tree_util.tree_leaves(jstate.opt_state)
    assert len(got_opt) == len(want_opt) == 7 + 2 * len(shapes)
    for g, w in zip(got_opt, want_opt):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        pairs.append(np.abs(g - w) > TOL + 1e-6 * np.abs(w))
    off = sum(int(m.sum()) for m in pairs)
    assert off <= OFF_SHARE * sum(m.size for m in pairs), off


@pytest.mark.parametrize("recipe", list(SHIPPED))
def test_three_recipe_steps_match_jax(tmp_path, recipe):
    """Three optimizer steps on the recipe's first three batches of 16, from
    one init: the losses each step, then parameters, BN state and Adam
    moments (clip 400, coupled decay 0.005)."""
    corpus(tmp_path, recipe)
    cfg = recipe_config(load_config, tmp_path, recipe, "port")
    jcfg = recipe_config(jax_load_config, tmp_path, recipe, "jax")
    # the class count as stage 2 takes it from an 863 config: num_class + blank
    spec = ModelSpec.from_config(cfg, num_class=cfg.num_class + 1)
    jspec = JSpec.from_config(jcfg, num_class=jcfg.num_class + 1)
    assert spec.to_dict() == jspec.to_dict() and spec.num_class == 67
    assert Vocab(cfg.vocab_file).n_words == 67

    params, mstate = jax_weights(jspec, seed=6)
    tx = jax_make_optimizer(jcfg.init_lr, jcfg.weight_decay, jcfg.grad_clip)
    jstate = JTrainState(jnp.zeros((), jnp.int32), to_jnp(params),
                         to_jnp(mstate), tx.init(to_jnp(params)))
    train_jit, _ = make_step_fns(jspec, tx)
    model = CTCModel(spec)
    model.load_state_dict(params_from_jax(spec, params, mstate))
    state = TrainState(model, make_optimizer(model, spec, cfg.init_lr,
                                             cfg.weight_decay),
                       grad_clip=cfg.grad_clip)

    def loader(ds_cls, loader_cls, vocab, c):
        out = loader_cls(ds_cls(vocab, c.train_scp_path, c.train_lab_path, c),
                         c.batch_size, shuffle=c.shuffle_train,
                         num_buckets=c.num_buckets, seed=c.seed,
                         mode=c.batch_mode)
        out.set_epoch(1)
        return out

    batches = zip(loader(SpeechDataset, SpeechDataLoader, Vocab(cfg.vocab_file),
                         cfg),
                  loader(JDataset, JLoader, JVocab(jcfg.vocab_file), jcfg))
    fields = ("feats", "input_frac", "labels", "label_lengths", "example_mask")
    for batch, jbatch in islice(batches, 3):
        arrays = [getattr(batch, k) for k in fields]
        for a, k in zip(arrays, fields):
            np.testing.assert_array_equal(a, getattr(jbatch, k))
        assert arrays[0].shape[0] == 16 and arrays[0].shape[2] == SHIPPED[
            recipe][1]
        jstate, want_loss, _, want_sizes = train_jit(
            jstate, *(jnp.asarray(a) for a in arrays), jax.random.PRNGKey(0))
        loss, _, sizes = train_step(state, spec,
                                    *(torch.from_numpy(a) for a in arrays))
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
        np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    assert state.step == int(jstate.step) == 3
    assert_state_close(spec, state, jstate, cfg.init_lr, 3)


@pytest.mark.parametrize("recipe", list(SHIPPED))
def test_recipe_epoch_and_stage4_match_jax(tmp_path, recipe):
    """One epoch of both ``Trainer``s on the recipe's fused path, with the
    ``dev_over_train`` pass and the accuracy-keyed scheduler: the same
    losses and accuracies; stage 2 through ``cli.train.train`` writes a
    package, and stage 4 of it gives the JAX stage 4's greedy strings."""
    corpus(tmp_path, recipe)
    cfg = recipe_config(load_config, tmp_path, recipe, "port")
    jcfg = recipe_config(jax_load_config, tmp_path, recipe, "jax")
    vocab = Vocab(cfg.vocab_file)
    tr, dv = cli_train.build_loaders(cfg, vocab, device="cpu")
    assert isinstance(tr, GroupedLoader) and len(tr) == 3
    jtr, jdv = jax_loaders(jcfg)
    spec = ModelSpec.from_config(cfg, num_class=cfg.num_class + 1)
    trainer = Trainer(cfg, spec, device="cpu")
    jtrainer = JTrainer(jcfg, JSpec.from_config(jcfg,
                                                num_class=jcfg.num_class + 1))
    p, s = params_to_jax(spec, trainer.state.model.state_dict())
    jtrainer.state = JTrainState(jnp.zeros((), jnp.int32), to_jnp(p), to_jnp(s),
                                 jtrainer.tx.init(to_jnp(p)))
    jtrainer._rollback = jax_snapshot(jtrainer.state)
    jtrainer._best = jax_snapshot(jtrainer.state)
    lines = []
    trainer.fit(tr, dv, num_epoches=1, log=lines.append)
    jtrainer.fit(jtr, jdv, num_epoches=1, log=lambda *a, **k: None)
    assert any(ln.startswith("fused_epoch: the epochs run over the device "
                             "cache") for ln in lines)
    for key in ("loss_results", "dev_loss_results", "dev_cer_results",
                "training_cer_results"):
        np.testing.assert_allclose(trainer.histories[key],
                                   jtrainer.histories[key], rtol=RTOL)
    assert_state_close(spec, trainer.state, jtrainer.state, cfg.init_lr, 3)

    # stage 2 through the CLI's entry point, then stage 4 in both packages
    trained, best = cli_train.train(cfg, device="cpu", num_epoches=1,
                                    log=lambda *a: None)
    assert trained.spec == spec and best.exists()
    got_lines, want_lines = [], []
    got = evaluate(cfg, str(best), device="cpu", log=got_lines.append)
    want = jax_evaluate(jcfg, str(best), log=want_lines.append)
    n = 3 * 16
    assert got_lines[:n + 2] == want_lines[:n + 2]  # utterances, CER, WER
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]
    assert any(ln.startswith("decoded: ") and len(ln.split()) > 2
               for ln in got_lines)


def test_chip_smoke_phase14_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 14 with ``device="cpu"`` on both recipes
    cut in width and depth (fp32) and on short utterances: text dumps
    converted, one fused epoch each through ``cli.train.train`` (the loss
    falls), stage 4, and the graphed-against-streaming comparison (eager on
    the CPU)."""
    cut = {}
    for recipe, (feats, dim, _) in SHIPPED.items():
        text = (RECIPES / f"{recipe}.conf").read_text()
        for a, b in (("rnn_hidden_size = 256", "rnn_hidden_size = 8"),
                     ("rnn_layers = 4", "rnn_layers = 2")):
            assert a in text
            text = text.replace(a, b)
        (tmp_path / f"{recipe}.conf").write_text(text + "dtype = float32\n")
        cut[tmp_path / f"{recipe}.conf"] = (feats, dim)
    monkeypatch.setattr(chip_smoke, "RECIPES_863_LSTM", cut)
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    monkeypatch.setattr(chip_smoke, "SPLITS_863_LSTM", (("train", 32, 31),
                                                        ("dev", 16, 32)))
    write = chip_smoke.write_text_corpus
    monkeypatch.setattr(chip_smoke, "write_text_corpus",
                        lambda *a, **k: write(*a, **k, frames=(20, 61)))
    out = chip_smoke.phase_863_lstm_slice("cpu", device="cpu")
    assert set(out) == set(SHIPPED)
    for r in out.values():
        assert r["steps"] == 2 and r["loss_after"] < r["loss_before"]
        assert r["fused_vs_streaming"]["train_steps"] == 2
