"""The 863 slice (CNN (11, 5) stride 2 + Hardtanh(0, 20) -> BiGRU stack ->
BN + Linear, accuracy-keyed scheduler, ``dev_over_train``) against the JAX
package on the CPU, at a small size, from JAX-initialised weights and numpy
inputs, in fp32.

Tolerance 1e-4 absolute unless stated, as ``tests/test_torch_train.py``: both
sides do the same fp32 math in another summation order, and Adam turns
rounding noise on near-zero gradients into a fraction of the learning rate."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.cli.test import evaluate as jax_evaluate
from ctc_pytorch_tpu.config import CNNConfig as JCNNConfig
from ctc_pytorch_tpu.config import load_config as jax_load_config
from ctc_pytorch_tpu.data import SpeechDataLoader as JLoader
from ctc_pytorch_tpu.data import SpeechDataset as JDataset
from ctc_pytorch_tpu.models.ctc_model import CTCModel as JModel
from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
from ctc_pytorch_tpu.train import checkpoint as jckpt
from ctc_pytorch_tpu.train.loop import Trainer as JTrainer
from ctc_pytorch_tpu.train.loop import make_step_fns
from ctc_pytorch_tpu.train.state import TrainState as JTrainState
from ctc_pytorch_tpu.train.state import get_lr as jax_get_lr
from ctc_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
from ctc_pytorch_tpu.train.state import snapshot as jax_snapshot
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.cli.test import evaluate
from ctc_pytorch_tpu_torch.config import load_config
from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset
from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.train.checkpoint import (
    leaf_paths,
    model_from_package,
    params_from_jax,
    params_to_jax,
)
from ctc_pytorch_tpu_torch.train.loop import Trainer, train_step
from ctc_pytorch_tpu_torch.train.state import TrainState, get_lr, make_optimizer
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_model import jax_weights
from tests.test_torch_train import assert_state_matches, step_batches, to_jnp

TOL = 1e-4
RECIPE = Path(__file__).resolve().parent.parent / "recipes/my_863/cnn_lstm_ctc.conf"


def gru_spec(add_cnn=True, feat=21, hidden=16, layers=2, num_class=7):
    """The 863 model's structure, narrow: one conv layer (11, 5) stride
    (2, 2) without padding, Hardtanh(0, 20), BiGRU layers with BN between."""
    cnn = JCNNConfig(add_cnn=False)
    if add_cnn:
        cnn = JCNNConfig(add_cnn=True, layers=1, channel=[(1, 2)],
                         kernel_size=[(11, 5)], stride=[(2, 2)],
                         padding=[(0, 0)], pooling=None,
                         activation_function="hardtanh")
    return JSpec(add_cnn=add_cnn, cnn=cnn, rnn_input_size=feat,
                 rnn_hidden_size=hidden, rnn_layers=layers, rnn_cell="gru",
                 bidirectional=True, batch_norm=True, num_class=num_class,
                 drop_out=0.0, compute_dtype="float32")


def port_model(jspec, params, state):
    spec = ModelSpec.from_dict(jspec.to_dict())
    model = CTCModel(spec)
    model.load_state_dict(params_from_jax(spec, params, state))
    return spec, model


# ---------------------------------------------------------------------------
# the model, eval and train, with and without the CNN and `lengths`
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("add_cnn", [True, False])
def test_gru_model_log_probs_and_bn_state_match_jax(add_cnn, train, with_lengths):
    jspec = gru_spec(add_cnn)
    params, state = jax_weights(jspec, seed=3)
    spec, model = port_model(jspec, params, state)
    t_in = 40
    x = np.random.RandomState(5).randn(3, t_in, 21).astype(np.float32) * 3
    frac = np.array([40, 33, 25], np.float32) / t_in
    # the trainer always passes the rows' validity; the last row is a
    # repeat-padded one, left out of the batchmax BN statistics
    rows = np.array([1, 1, 0], np.float32)
    t_out = spec.output_time_len(t_in)
    assert t_out == ((t_in - 11) // 2 + 1 if add_cnn else t_in)
    lens = (frac * t_out).astype(np.int32) if with_lengths else None
    want, want_state = JModel.apply(
        jspec, to_jnp(params), to_jnp(state), jnp.asarray(x), train=train,
        frac=jnp.asarray(frac), example_mask=jnp.asarray(rows),
        lengths=None if lens is None else jnp.asarray(lens))
    with torch.set_grad_enabled(train):
        got = model(torch.from_numpy(x), frac=torch.from_numpy(frac),
                    example_mask=torch.from_numpy(rows), train=train,
                    lengths=None if lens is None else torch.from_numpy(lens))
    assert got.shape == want.shape == (t_out, 3, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    _, got_state = params_to_jax(spec, model.state_dict())
    g_leaves, g_def = jax.tree_util.tree_flatten(got_state)
    w_leaves, w_def = jax.tree_util.tree_flatten(want_state)
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0)
    assert int(model.fc_bn.count) == int(state["fc_bn"]["count"]) + int(train)
    assert model.training == train


def test_hardtanh_front_end_clips_at_twenty():
    """The 863 activation is Hardtanh(0, 20), not ReLU: a large input must
    saturate, in both packages alike."""
    jspec = gru_spec()
    params, state = jax_weights(jspec, seed=1)
    params["cnn"][0]["bn"]["scale"] = params["cnn"][0]["bn"]["scale"] * 100.0
    spec, model = port_model(jspec, params, state)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 30, 21).astype(np.float32))
    with torch.no_grad():
        planes = model.cnn(x[:, None], torch.float32)
    assert planes.min() == 0.0 and planes.max() == 20.0
    want, _ = JModel.apply(jspec, to_jnp(params), to_jnp(state), jnp.asarray(x.numpy()))
    with torch.no_grad():
        got = model(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# three optimizer steps with the recipe's clip and decay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("add_cnn", [True, False])
def test_three_gru_train_steps_match_jax(add_cnn):
    jspec = gru_spec(add_cnn, feat=8, num_class=6)
    params, mstate = jax_weights(jspec, seed=4)
    lr, wd, clip = 1e-3, 0.005, 400.0  # the 863 recipe's
    tx = jax_make_optimizer(lr, wd, clip)
    jstate = JTrainState(jnp.zeros((), jnp.int32), to_jnp(params),
                         to_jnp(mstate), tx.init(to_jnp(params)))
    train_jit, _ = make_step_fns(jspec, tx)
    spec, model = port_model(jspec, params, mstate)
    state = TrainState(model, make_optimizer(model, spec, lr, wd), grad_clip=clip)
    order = ("feats", "frac", "labels", "label_lens", "mask")
    for batch in step_batches(3, seed=7):
        jstate, want_loss, _, want_sizes = train_jit(
            jstate, *(jnp.asarray(batch[k]) for k in order), jax.random.PRNGKey(0))
        loss, _, sizes = train_step(
            state, spec, *(torch.from_numpy(batch[k]) for k in order))
        np.testing.assert_allclose(loss.item(), float(want_loss), atol=TOL,
                                   rtol=1e-5)
        np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    assert state.step == int(jstate.step) == 3 and int(model.fc_bn.count) == 3
    assert_state_matches(spec, state, jstate)


def test_gru_leaf_order_equals_tree_flatten():
    jspec = gru_spec()
    params, state = JModel.init(jax.random.PRNGKey(0), jspec)
    spec = ModelSpec.from_dict(jspec.to_dict())
    p_paths, _ = leaf_paths(spec)
    sd = CTCModel(spec).state_dict()
    leaves = jax.tree_util.tree_leaves(params)
    assert len(p_paths) == len(leaves)
    assert all(tuple(sd[p].shape) == tuple(l.shape) for p, l in zip(p_paths, leaves))
    assert tuple(sd["rnns.0.fwd.w_ih"].shape) == (2 * 9, 3 * 16)  # 3 gates
    assert tuple(sd["rnns.1.bwd.w_hh"].shape) == (16, 3 * 16)


# ---------------------------------------------------------------------------
# the recipe: Trainer.fit in acc mode with dev_over_train, packages, decode
# ---------------------------------------------------------------------------

# 65 units + blank + UNK = the recipe's num_class 66 + blank: every class of
# the 67-way output has a name to decode to
PHONES = [f"u{i:02d}" for i in range(65)]


def write_split(root, name, n, seed, dim=21):
    rng = np.random.RandomState(seed)
    d = root / name
    d.mkdir(parents=True)
    lines = []
    with ArkWriter(d / "spectrum.ark", d / "spectrum.scp") as w:
        for i in range(n):
            utt = f"{name}{i:02d}"
            frames = int(rng.randint(30, 49))
            w.write(utt, rng.randn(frames, dim).astype(np.float32))
            lines.append(utt + " " + " ".join(rng.choice(PHONES, 3)))
    (d / "text").write_text("\n".join(lines) + "\n")


def recipe_config(load, root):
    """``recipes/my_863/cnn_lstm_ctc.conf`` with the GRU cell, cut to a
    21-d, 16-unit, 2-layer model in fp32 on a synthetic corpus under
    ``root``; everything else (CNN shape, Hardtanh, clip 400, decay 0.005,
    ``scheduler_mode acc``, ``dev_over_train``, band 1.5, 5 warm-up epochs) is
    the recipe's."""
    cfg = load(RECIPE)
    assert cfg.scheduler_mode == "acc" and cfg.dev_over_train
    assert cfg.grad_clip == 400 and cfg.weight_decay == 0.005
    assert cfg.cnn.activation_function == "hardtanh" and cfg.feature_dim == 201
    assert cfg.cnn.kernel_size == [(11, 5)] and cfg.cnn.padding == [(0, 0)]
    assert cfg.rnn_cell == "lstm" and cfg.fused_epoch
    cfg.rnn_type = "nn.GRU"
    cfg.exp_name = load.__module__.split(".")[0]
    cfg.checkpoint_dir = str(root / "checkpoint")
    cfg.vocab_file = str(root / "units")
    for split, name in (("train", "train"), ("valid", "dev"), ("test", "dev")):
        setattr(cfg, f"{split}_scp_path", str(root / name / "spectrum.scp"))
        setattr(cfg, f"{split}_lab_path", str(root / name / "text"))
    cfg.feature_dim = cfg.rnn_input_size = 21
    cfg.rnn_hidden_size, cfg.rnn_layers = 16, 2
    cfg.dtype, cfg.batch_size, cfg.num_buckets = "float32", 4, 1
    cfg.device_cache, cfg.log_dir = False, ""
    return cfg


@pytest.fixture
def recipe(tmp_path):
    (tmp_path / "units").write_text("".join(p + "\n" for p in PHONES))
    write_split(tmp_path, "train", 8, seed=0)
    write_split(tmp_path, "dev", 4, seed=1)
    cfg = recipe_config(load_config, tmp_path)
    jcfg = recipe_config(jax_load_config, tmp_path)
    # the class count as stage 2 takes it from an 863 config: num_class + blank
    spec = ModelSpec.from_config(cfg, num_class=cfg.num_class + 1)
    jspec = JSpec.from_config(jcfg, num_class=jcfg.num_class + 1)
    assert spec.to_dict() == jspec.to_dict()
    assert spec.rnn_cell == "gru" and spec.num_class == 67
    assert spec.rnn_in_after_cnn == 9 * 16
    return cfg, spec, jcfg, jspec


def loaders(ds_cls, loader_cls, vocab_cls, cfg):
    vocab = vocab_cls(cfg.vocab_file)
    tr = ds_cls(vocab, cfg.train_scp_path, cfg.train_lab_path, cfg)
    dv = ds_cls(vocab, cfg.valid_scp_path, cfg.valid_lab_path, cfg)
    return (loader_cls(tr, 4, shuffle=True, num_buckets=1, seed=cfg.seed),
            loader_cls(dv, 4, shuffle=False, num_buckets=1, seed=cfg.seed))


def records(trainer):
    return [json.loads(ln) for ln in
            (trainer.out_dir / "train_metrics.jsonl").read_text().splitlines()]


def test_recipe_trainer_in_acc_mode_makes_the_jax_trainers_decisions(
        recipe, tmp_path):
    cfg, spec, jcfg, jspec = recipe
    tr, dv = loaders(SpeechDataset, SpeechDataLoader, Vocab, cfg)
    jtr, jdv = loaders(JDataset, JLoader, JVocab, jcfg)
    trainer = Trainer(cfg, spec, device="cpu")
    jtrainer = JTrainer(jcfg, jspec)
    assert trainer.state.grad_clip == 400 and trainer.scheduler.mode == "acc"
    # one init for both: the port's, in the JAX tree layout
    p, s = params_to_jax(spec, trainer.state.model.state_dict())
    jtrainer.state = JTrainState(jnp.zeros((), jnp.int32), to_jnp(p), to_jnp(s),
                                 jtrainer.tx.init(to_jnp(p)))
    jtrainer._rollback = jax_snapshot(jtrainer.state)
    jtrainer._best = jax_snapshot(jtrainer.state)
    both = (trainer, jtrainer)
    lines, quiet = [], (lambda *_: None)

    # epoch 1: a big improvement on the initial best: snapshot, and (acc mode)
    # the true best stays where it was
    trainer.fit(tr, dv, num_epoches=1, log=lines.append)
    jtrainer.fit(jtr, jdv, num_epoches=1, log=quiet)
    # fused_epoch over plain loaders, as the JAX side here: streaming order
    assert any("fused_epoch requested but running the streaming order" in ln
               for ln in lines)
    assert any(ln.startswith("cer on training set is ") for ln in lines)
    for t in both:
        assert t.scheduler.loss_best_true == 1000.0 and t.scheduler.loss_best < 900
    # epoch 2: the tenth epoch inside the band, but within the recipe's
    # least_train_epoch = 5: the count resets and nothing is adjusted
    for t in both:
        t.scheduler.adjust_rate_count, t.scheduler.end_adjust_acc = 9, 1e6
    trainer.fit(tr, dv, num_epoches=2, log=quiet)
    jtrainer.fit(jtr, jdv, num_epoches=2, log=quiet)
    # epoch 3: the same past the warm-up: roll back to the newest snapshot
    # and halve the rate; acc mode sets the best to the true best regardless
    for t in both:
        t.scheduler.adjust_rate_count, t.cfg.least_train_epoch = 9, 0
    trainer.fit(tr, dv, num_epoches=3, log=quiet)
    jtrainer.fit(jtr, jdv, num_epoches=3, log=quiet)
    # epoch 4 runs from the rolled-back state at half the rate; an epoch much
    # worse than the band resets the count in acc mode (no forced decay)
    for t in both:
        t.scheduler.end_adjust_acc, t.scheduler.loss_best = 1.5, -1000.0
        t.scheduler.adjust_rate_count = 4
    best = trainer.fit(tr, dv, num_epoches=4, log=quiet)
    jbest = jtrainer.fit(jtr, jdv, num_epoches=4, log=quiet)

    got, want = records(trainer), records(jtrainer)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("epoch", "rollback", "decay_lr", "snapshot", "adjust_time"):
            assert g[k] == w[k], (k, g, w)
        for k in ("lr", "train_loss", "dev_loss", "train_acc", "dev_acc"):
            assert g[k] == pytest.approx(w[k], abs=TOL), (k, g, w)
    assert [g["rollback"] for g in got] == [False, False, True, False]
    assert [g["decay_lr"] for g in got] == [False, False, True, False]
    assert [g["adjust_time"] for g in got] == [0, 0, 1, 1]
    assert got[0]["snapshot"] and got[3]["lr"] == pytest.approx(5e-4)
    assert trainer.scheduler.state_dict() == jtrainer.scheduler.state_dict()
    assert trainer.scheduler.adjust_rate_count == 0
    for key in ("loss_results", "dev_loss_results", "dev_cer_results",
                "training_cer_results"):
        assert len(trainer.histories[key]) == 4
        assert trainer.histories[key] == pytest.approx(jtrainer.histories[key],
                                                       abs=100 * TOL)
    # epochs 2 and 3 were rolled back to epoch 1's snapshot: four optimizer
    # steps stand behind the live state.  Adam's noise on near-zero gradients,
    # a fraction of lr = 1e-3 per step, goes a little past the three-step
    # tests' 1e-4 (one entry of 6912 read 1.1e-4), so 3e-4 here
    assert trainer.state.step == int(jtrainer.state.step) == 4
    assert_state_matches(spec, trainer.state, jtrainer.state, tol=3e-4)

    # acc mode saves the live model, not the best-dev-accuracy snapshot
    _, live, _ = model_from_package(best, device="cpu")
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(live.state_dict()[k], v), k
    # the best packages hold the same model: each loads into the other side
    _, jparams, jmstate, jman = jckpt.model_from_package(best)
    _, wparams, wmstate, wman = jckpt.model_from_package(jbest)
    assert jman["epoch"] == wman["epoch"] == 4
    assert jman["leaf_counts"] == wman["leaf_counts"]
    assert len(jman["training_cer_results"]) == 4
    for g, w in zip(jax.tree_util.tree_leaves((jparams, jmstate)),
                    jax.tree_util.tree_leaves((wparams, wmstate))):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=3e-4, rtol=0)

    # resume packages, optimizer state included, cross both ways
    restored, man = jckpt.restore_train_state(trainer.save_resume_checkpoint(),
                                              jtrainer.state)
    assert man["scheduler"] == trainer.scheduler.state_dict()
    assert_state_matches(spec, trainer.state, restored, tol=0)
    fresh = Trainer(cfg, spec, device="cpu", out_dir=str(tmp_path / "resumed"))
    fresh.resume(jtrainer.save_resume_checkpoint())
    assert fresh.epoch == 4 and fresh.scheduler.mode == "acc"
    assert get_lr(fresh.state) == pytest.approx(jax_get_lr(jtrainer.state.opt_state))
    assert fresh.histories["training_cer_results"] == \
        jtrainer.histories["training_cer_results"]
    assert_state_matches(spec, fresh.state, jtrainer.state, tol=0)


def test_recipe_evaluate_on_cpu_decodes_the_jax_strings(recipe, tmp_path):
    cfg, spec, jcfg, jspec = recipe
    # a sharp output layer: near-flat random posteriors would let a 1e-7
    # difference between frameworks flip an argmax
    params, state = jax_weights(jspec, seed=1, fc_scale=10.0)
    pkg = tmp_path / "gru.npz"
    jckpt.save_package(pkg, jspec, JTrainState(jnp.zeros((), jnp.int32), params,
                                               state, ()))
    want_lines, got_lines = [], []
    want = jax_evaluate(jcfg, str(pkg), log=want_lines.append)
    got = evaluate(cfg, str(pkg), device="cpu", log=got_lines.append)
    got_lines = [ln for ln in got_lines if not ln.startswith("fused_decode")]

    def decoded(lines):
        return {u: d for u, d in zip(lines[::3], lines[2::3])
                if d.startswith("decoded: ")}

    n = 3 * 4  # utt / origin / decoded per utterance
    assert decoded(got_lines[:n]) == decoded(want_lines[:n])
    assert len(decoded(got_lines[:n])) == 4
    assert any(len(d.split()) > 1 for d in decoded(got_lines[:n]).values())
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]
    assert got_lines[n:n + 2] == want_lines[n:n + 2]  # CER / WER lines


def test_recipe_trains_through_the_cli_on_the_cpu(recipe, tmp_path):
    """``cli.train`` takes the class count from the 863 config (num_class +
    blank) and ``cli.test`` decodes what it wrote."""
    from ctc_pytorch_tpu_torch.cli import train as cli_train

    cfg, spec, _, _ = recipe
    cfg.exp_name = "cli_863"
    lines = []
    trainer, best = cli_train.train(cfg, device="cpu", num_epoches=1,
                                    log=lines.append)
    assert trainer.spec == spec and best.exists()
    assert trainer.histories["training_cer_results"]
    got_spec, model, manifest = model_from_package(best, device="cpu")
    assert got_spec.rnn_cell == "gru" and got_spec.num_class == 67
    assert manifest["config"]["scheduler_mode"] == "acc"
    res = evaluate(cfg, str(best), device="cpu", verbose=False, log=lambda *_: None)
    assert res["batches"] == 1 and np.isfinite(res["wer"])
