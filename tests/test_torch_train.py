"""The port's training slice against the JAX package on the CPU, from one
init and the same batches (numpy seed), in fp32 with ``drop_out: 0``:
train-mode BN, three optimizer steps, the ``Trainer`` with a forced rollback
and LR decay, and resume packages crossing the frameworks both ways; the
steps, the ``Trainer`` and the packages also for the flagship's two recipe
overrides, the tanh cell and one direction.

Tolerance 1e-4 absolute unless stated: both sides do the same fp32 math in
another summation order, and Adam's ``g / (|g| + eps)`` amplifies rounding
noise on near-zero gradients (a conv bias in front of a BN) up to a fraction
of the learning rate, here 1e-3."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.config import CNNConfig as JCNNConfig
from ctc_pytorch_tpu.config import Config as JConfig
from ctc_pytorch_tpu.data import SpeechDataLoader as JLoader
from ctc_pytorch_tpu.data import SpeechDataset as JDataset
from ctc_pytorch_tpu.models.cnn import _bn2d
from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
from ctc_pytorch_tpu.models.layers import batchnorm_apply
from ctc_pytorch_tpu.train import checkpoint as jckpt
from ctc_pytorch_tpu.train.loop import Trainer as JTrainer
from ctc_pytorch_tpu.train.loop import make_step_fns
from ctc_pytorch_tpu.train.state import TrainState as JTrainState
from ctc_pytorch_tpu.train.state import get_lr as jax_get_lr
from ctc_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
from ctc_pytorch_tpu.train.state import snapshot as jax_snapshot
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset
from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter
from ctc_pytorch_tpu_torch.models.cnn import BatchNorm2d
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.models.layers import BatchNorm, dropout
from ctc_pytorch_tpu_torch.train.checkpoint import (
    opt_state_leaves,
    params_from_jax,
    params_to_jax,
)
from ctc_pytorch_tpu_torch.train.loop import Trainer, train_step
from ctc_pytorch_tpu_torch.train.state import (
    TrainState,
    get_lr,
    make_optimizer,
    restore,
    scale_lr,
    snapshot,
)
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_model import RECIPE_VARIANTS, jax_weights, variant_cell

TOL = 1e-4


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# train-mode BN and dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_matches_jax(masked):
    rng = np.random.RandomState(0)
    x = rng.randn(6, 4, 10).astype(np.float32) * 2 + 1
    mask = (rng.rand(6, 4) > 0.3).astype(np.float32) if masked else None
    params = {"scale": rng.rand(10).astype(np.float32) + 0.5,
              "bias": rng.randn(10).astype(np.float32)}
    state = {"mean": rng.randn(10).astype(np.float32),
             "var": rng.rand(10).astype(np.float32) + 0.5,
             "count": np.asarray(3, np.int32)}
    want, want_state = batchnorm_apply(
        to_jnp(params), to_jnp(state), jnp.asarray(x), True,
        mask=None if mask is None else jnp.asarray(mask))
    bn = BatchNorm(10).train()
    bn.load_state_dict({k: torch.tensor(v) for k, v in {**params, **state}.items()})
    got = bn(torch.tensor(x), None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(want_state[k]), atol=1e-6, rtol=0)
    assert int(bn.count) == int(want_state["count"]) == 4
    assert bn.count.dtype == torch.int32


def test_batchnorm_train_with_an_empty_mask_divides_by_one():
    bn = BatchNorm(3).train()
    out = bn(torch.ones(4, 3), torch.zeros(4))
    assert torch.isfinite(out).all() and torch.equal(out, torch.zeros(4, 3))
    np.testing.assert_allclose(bn.mean.numpy(), 0.0)
    np.testing.assert_allclose(bn.var.numpy(), 0.9)


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm2d_train_matches_jax(masked):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 2, 7, 5).astype(np.float32) + 0.5  # (B, C, T, F)
    mask = None
    if masked:  # frames below a cutoff, one row repeat-padded
        mask = (np.arange(7)[None, :] < 5) & np.array([1, 1, 0], bool)[:, None]
    params = {"scale": rng.rand(2).astype(np.float32) + 0.5,
              "bias": rng.randn(2).astype(np.float32)}
    state = {"mean": rng.randn(2).astype(np.float32),
             "var": rng.rand(2).astype(np.float32) + 0.5}
    want, want_state = _bn2d(
        to_jnp(params), to_jnp(state), jnp.asarray(x.transpose(0, 2, 3, 1)),
        True, mask=None if mask is None else jnp.asarray(mask)[:, :, None, None])
    bn = BatchNorm2d(2).train()
    bn.load_state_dict({k: torch.tensor(v) for k, v in {**params, **state}.items()})
    got = bn(torch.tensor(x),
             None if mask is None else torch.tensor(mask)[:, None, :, None])
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(want_state[k]), atol=1e-6, rtol=0)
    assert not hasattr(bn, "count")


def test_dropout_keeps_n_over_256_and_is_unbiased():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    out = dropout(x, 0.2, gen, True)
    kept = out != 0
    assert torch.allclose(out[kept], torch.tensor(256.0 / 205.0))
    assert abs(kept.float().mean().item() - 205 / 256) < 5e-3
    assert abs(out.mean().item() - 1.0) < 1e-2
    assert dropout(x, 0.2, gen, False) is x and dropout(x, 0.0, gen, True) is x
    assert dropout(x, 0.2, None, False) is x and dropout(x, 0.0, None, True) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.2, None, True)  # train mode never drops dropout silently


# ---------------------------------------------------------------------------
# three optimizer steps
# ---------------------------------------------------------------------------

def small_spec(pad_dynamics, add_cnn=True, cell="lstm", bidirectional=True):
    cnn = JCNNConfig(add_cnn=False)
    if add_cnn:
        cnn = JCNNConfig(add_cnn=True, layers=1, channel=[(1, 2)],
                         kernel_size=[(3, 3)], stride=[(2, 2)],
                         padding=[(1, 1)], batch_norm=True)
    return JSpec(add_cnn=add_cnn, cnn=cnn, rnn_input_size=8,
                 rnn_hidden_size=16, rnn_layers=2, rnn_cell=cell,
                 bidirectional=bidirectional, batch_norm=True, num_class=6,
                 drop_out=0.0, compute_dtype="float32",
                 pad_dynamics=pad_dynamics)


def step_batches(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lens = np.array([24, 19, 16, 16], np.float32)
        out.append(dict(
            feats=rng.randn(4, 24, 8).astype(np.float32),
            frac=lens / 24,
            labels=rng.randint(1, 6, (4, 5)).astype(np.int32),
            label_lens=np.array([5, 3, 1, 1], np.int32),
            # the last row of the last batch is a repeat-padded one
            mask=np.array([1, 1, 1, 0 if i == n - 1 else 1], np.float32)))
    return out


def assert_state_matches(spec, state, jstate, tol=TOL):
    got_p, got_s = params_to_jax(spec, state.model.state_dict())
    for got, want in ((got_p, jstate.params), (got_s, jstate.model_state)):
        g_leaves, g_def = jax.tree_util.tree_flatten(got)
        w_leaves, w_def = jax.tree_util.tree_flatten(want)
        assert g_def == w_def
        for g, w in zip(g_leaves, w_leaves):
            np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=0)
    shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(jstate.params)]
    got_opt = opt_state_leaves(state.optimizer, shapes)
    want_opt = jax.tree_util.tree_leaves(jstate.opt_state)
    assert len(got_opt) == len(want_opt) == 7 + 2 * len(shapes)
    for g, w in zip(got_opt, want_opt):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol, rtol=1e-6)


@pytest.mark.parametrize("pad_dynamics,grad_clip", [
    ("batchmax", 0.0), ("padded", 0.5), ("valid", 0.0),
])
def test_three_train_steps_match_jax(pad_dynamics, grad_clip):
    three_steps_match_jax(small_spec(pad_dynamics), grad_clip)


@pytest.mark.parametrize("variant", sorted(RECIPE_VARIANTS))
def test_recipe_variant_three_train_steps_match_jax(variant):
    cell, bidir = variant_cell(variant)
    three_steps_match_jax(small_spec("batchmax", cell=cell, bidirectional=bidir),
                          0.0)


def three_steps_match_jax(jspec, grad_clip):
    """Three fp32 steps of the port and of the JAX package from one init on
    the same batches: loss and sizes each step, then params, BN state and
    Adam moments."""
    params, mstate = jax_weights(jspec, seed=4)
    lr, wd = 1e-3, 5e-4
    tx = jax_make_optimizer(lr, wd, grad_clip)
    jstate = JTrainState(jnp.zeros((), jnp.int32), to_jnp(params),
                         to_jnp(mstate), tx.init(to_jnp(params)))
    train_jit, _ = make_step_fns(jspec, tx)

    spec = ModelSpec.from_dict(jspec.to_dict())
    model = CTCModel(spec)
    model.load_state_dict(params_from_jax(spec, params, mstate))
    state = TrainState(model, make_optimizer(model, spec, lr, wd),
                       grad_clip=grad_clip)

    for batch in step_batches(3, seed=7):
        order = ("feats", "frac", "labels", "label_lens", "mask")
        jstate, want_loss, want_idx, want_sizes = train_jit(
            jstate, *(jnp.asarray(batch[k]) for k in order),
            jax.random.PRNGKey(0))
        loss, idx, sizes = train_step(
            state, spec, *(torch.from_numpy(batch[k]) for k in order))
        np.testing.assert_allclose(loss.item(), float(want_loss), atol=TOL,
                                   rtol=1e-5)
        np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
        assert idx.shape == want_idx.shape
    assert state.step == int(jstate.step) == 3
    assert int(model.fc_bn.count) == 3 and model.training
    assert_state_matches(spec, state, jstate)


def test_snapshot_restore_and_lr_scaling():
    spec = ModelSpec.from_dict(small_spec("padded", add_cnn=False).to_dict())
    model = CTCModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(model, spec, 1e-2, 0.0))
    batch = step_batches(1, seed=1)[0]
    args = [torch.from_numpy(batch[k])
            for k in ("feats", "frac", "labels", "label_lens", "mask")]
    train_step(state, spec, *args)
    snap = snapshot(state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    scale_lr(state, 0.5)
    train_step(state, spec, *args)
    assert state.step == 2 and get_lr(state) == pytest.approx(5e-3)
    assert not torch.equal(model.fc.w, before["fc.w"])
    restore(state, snap)
    assert state.step == 1 and get_lr(state) == pytest.approx(1e-2)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    # the snapshot is a copy: another step leaves it intact
    train_step(state, spec, *args)
    assert all(torch.equal(snap["model"][k], before[k]) for k in before)
    assert float(snap["optimizer"]["state"][0]["step"]) == 1.0


# ---------------------------------------------------------------------------
# Trainer.fit and resume packages
# ---------------------------------------------------------------------------

PHONES = ["aa", "b", "iy", "k", "s"]


def write_split(root, name, n, seed):
    rng = np.random.RandomState(seed)
    d = root / name
    d.mkdir(parents=True)
    lines = []
    with ArkWriter(d / "fbank.ark", d / "fbank.scp") as w:
        for i in range(n):
            utt = f"{name}{i:02d}"
            frames = int(rng.randint(14, 25))
            w.write(utt, rng.randn(frames, 8).astype(np.float32))
            lines.append(utt + " " + " ".join(rng.choice(PHONES, 3)))
    (d / "phn_text").write_text("\n".join(lines) + "\n")


def tiny_config(cls, root):
    cfg = cls()
    cfg.exp_name = cls.__module__.split(".")[0]
    cfg.checkpoint_dir = str(root / "checkpoint")
    cfg.vocab_file = str(root / "units")
    cfg.train_scp_path = str(root / "train/fbank.scp")
    cfg.train_lab_path = str(root / "train/phn_text")
    cfg.valid_scp_path = str(root / "dev/fbank.scp")
    cfg.valid_lab_path = str(root / "dev/phn_text")
    cfg.left_ctx = cfg.right_ctx = 0
    cfg.n_skip_frame = cfg.n_downsample = 1
    cfg.feature_dim = cfg.rnn_input_size = 8
    cfg.rnn_hidden_size, cfg.rnn_layers = 16, 2
    cfg.drop_out, cfg.dtype = 0.0, "float32"
    cfg.batch_size, cfg.num_buckets = 4, 1
    cfg.init_lr, cfg.weight_decay = 1e-3, 5e-4
    cfg.fused_epoch, cfg.device_cache = False, False
    cfg.save_every = 0
    return cfg


@pytest.fixture
def trainers(tmp_path):
    return make_trainers(tmp_path)


def make_trainers(tmp_path, rnn_type="nn.LSTM", bidirectional=True):
    """A port and a JAX ``Trainer`` on one tiny corpus, from one init, and
    their loaders: ``(trainer, (train, dev), jtrainer, (jtrain, jdev))``."""
    (tmp_path / "units").write_text("".join(p + "\n" for p in PHONES))
    write_split(tmp_path, "train", 8, seed=0)
    write_split(tmp_path, "dev", 4, seed=1)
    cfg, jcfg = tiny_config(Config, tmp_path), tiny_config(JConfig, tmp_path)
    for c in (cfg, jcfg):
        c.rnn_type, c.bidirectional = rnn_type, bidirectional
    vocab, jvocab = Vocab(cfg.vocab_file), JVocab(jcfg.vocab_file)
    spec = ModelSpec.from_config(cfg, num_class=vocab.n_words)
    jspec = JSpec.from_config(jcfg, num_class=jvocab.n_words)
    assert spec.to_dict() == jspec.to_dict()

    def loaders(ds_cls, loader_cls, c, v):
        tr = ds_cls(v, c.train_scp_path, c.train_lab_path, c)
        dv = ds_cls(v, c.valid_scp_path, c.valid_lab_path, c)
        return (loader_cls(tr, 4, shuffle=True, num_buckets=1, seed=c.seed),
                loader_cls(dv, 4, shuffle=False, num_buckets=1, seed=c.seed))

    trainer = Trainer(cfg, spec, device="cpu")
    jtrainer = JTrainer(jcfg, jspec)
    # one init for both: the port's, in the JAX tree layout
    p, s = params_to_jax(spec, trainer.state.model.state_dict())
    jtrainer.state = JTrainState(jnp.zeros((), jnp.int32), to_jnp(p), to_jnp(s),
                                 jtrainer.tx.init(to_jnp(p)))
    jtrainer._rollback = jax_snapshot(jtrainer.state)
    jtrainer._best = jax_snapshot(jtrainer.state)
    return (trainer, loaders(SpeechDataset, SpeechDataLoader, cfg, vocab),
            jtrainer, loaders(JDataset, JLoader, jcfg, jvocab))


def records(trainer):
    return [json.loads(ln) for ln in
            (trainer.out_dir / "train_metrics.jsonl").read_text().splitlines()]


def test_trainer_fit_rollback_decay_and_resume_match_jax(trainers, tmp_path):
    trainer, (tr, dv), jtrainer, (jtr, jdv) = trainers
    quiet = lambda *_: None  # noqa: E731
    # epoch 1: a first snapshot and a first best; epoch 2: the scheduler is
    # told of an unreachable best, so it rolls back and asks for a decay;
    # epoch 3 (bests reset) runs from the epoch-1 snapshot at half the rate
    for last_epoch, best_so_far in ((1, None), (2, -1000.0), (3, 1000.0)):
        for t in (trainer, jtrainer):
            if best_so_far is not None:
                t.scheduler.loss_best = t.scheduler.loss_best_true = best_so_far
        best = trainer.fit(tr, dv, num_epoches=last_epoch, log=quiet)
        jbest = jtrainer.fit(jtr, jdv, num_epoches=last_epoch, log=quiet)
    got, want = records(trainer), records(jtrainer)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("epoch", "rollback", "decay_lr", "snapshot", "adjust_time"):
            assert g[k] == w[k], (k, g, w)
        for k in ("lr", "train_loss", "dev_loss", "train_acc", "dev_acc"):
            assert g[k] == pytest.approx(w[k], abs=TOL), (k, g, w)
    assert [g["rollback"] for g in got] == [False, True, False]
    assert [g["decay_lr"] for g in got] == [False, True, False]
    assert got[0]["snapshot"] and got[2]["lr"] == pytest.approx(5e-4)
    assert trainer.scheduler.state_dict() == jtrainer.scheduler.state_dict()
    assert_state_matches(trainer.spec, trainer.state, jtrainer.state)
    assert trainer.state.step == int(jtrainer.state.step) == 4  # 2 rolled back
    assert trainer.histories["loss_results"] == pytest.approx(
        jtrainer.histories["loss_results"], abs=TOL)

    # the best packages hold the same model: each loads into the other side
    _, jparams, jmstate, jman = jckpt.model_from_package(best)
    _, wparams, wmstate, wman = jckpt.model_from_package(jbest)
    assert jman["epoch"] == wman["epoch"] == 3
    assert jman["leaf_counts"] == wman["leaf_counts"]
    for g, w in zip(jax.tree_util.tree_leaves((jparams, jmstate)),
                    jax.tree_util.tree_leaves((wparams, wmstate))):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=TOL, rtol=0)

    # resume, port -> JAX: the JAX restore reads the port's package
    path = trainer.save_resume_checkpoint()
    restored, man = jckpt.restore_train_state(path, jtrainer.state)
    assert man["step"] == 4 and man["epoch"] == 3
    assert man["scheduler"] == trainer.scheduler.state_dict()
    assert_state_matches(trainer.spec, trainer.state, restored, tol=0)
    assert jax_get_lr(restored.opt_state) == pytest.approx(get_lr(trainer.state))

    # resume, JAX -> port: a fresh port trainer picks up the JAX package
    jpath = jtrainer.save_resume_checkpoint()
    fresh = Trainer(trainer.cfg, trainer.spec, device="cpu",
                    out_dir=str(tmp_path / "resumed"))
    fresh.resume(jpath)
    assert fresh.epoch == 3 and fresh.state.step == 4
    assert get_lr(fresh.state) == pytest.approx(jax_get_lr(jtrainer.state.opt_state))
    assert fresh.scheduler.state_dict() == jtrainer.scheduler.state_dict()
    assert fresh.histories["dev_loss_results"] == jtrainer.histories["dev_loss_results"]
    assert_state_matches(fresh.spec, fresh.state, jtrainer.state, tol=0)
    # and trains on from there like the trainer that never stopped
    fresh.fit(tr, dv, num_epoches=4, log=quiet)
    trainer.fit(tr, dv, num_epoches=4, log=quiet)
    for k, v in trainer.state.model.state_dict().items():
        np.testing.assert_allclose(fresh.state.model.state_dict()[k].numpy(),
                                   v.numpy(), atol=TOL, rtol=0)


def test_trainer_logs_the_unported_fused_epoch_and_refuses_profile(trainers):
    trainer, (tr, dv), _, _ = trainers
    trainer.cfg.fused_epoch = True
    lines = []
    trainer.fit(tr, dv, num_epoches=1, compute_wer=False, log=lines.append)
    # plain loaders have no grouped order: the epoch streams, and says so
    assert any("fused_epoch requested but running the streaming order" in ln
               for ln in lines)
    assert (trainer.out_dir / "ctc_best_model.npz").exists()
    # profile: True is ported: the first epoch's training pass is traced
    trainer.cfg.profile = True
    traced = Trainer(trainer.cfg, trainer.spec, device="cpu",
                     out_dir=str(trainer.out_dir / "traced"))
    traced.fit(tr, dv, num_epoches=1, compute_wer=False, log=lines.append)
    traces = list((traced.out_dir / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1 and "aten::" in traces[0].read_text()


def test_cli_trains_on_the_cpu_and_its_package_decodes(trainers, tmp_path):
    from ctc_pytorch_tpu_torch.cli import test as cli_test
    from ctc_pytorch_tpu_torch.cli import train as cli_train

    trainer, _, _, _ = trainers
    cfg = trainer.cfg
    cfg.num_epoches, cfg.save_every, cfg.exp_name = 2, 1, "cli_run"
    cfg.test_scp_path, cfg.test_lab_path = cfg.valid_scp_path, cfg.valid_lab_path
    conf = tmp_path / "conf.yaml"
    cfg.to_yaml(conf)
    best = cli_train.main(["--conf", str(conf), "--device", "cpu"])
    out = tmp_path / "checkpoint" / "cli_run"
    assert best == out / "ctc_best_model.npz" and best.exists()
    assert (out / "resume_ep0002.npz").exists()
    assert (out / "config_used.yaml").exists()
    assert len((out / "train_metrics.jsonl").read_text().splitlines()) == 2
    # a second run resumes where the first stopped: nothing left to train
    lines = []
    cfg2 = cli_train.load_config(conf)
    _, again = cli_train.train(cfg2, device="cpu",
                               resume=str(out / "resume_ep0002.npz"),
                               log=lines.append)
    assert again == best and not any("Start training" in ln for ln in lines)
    res = cli_test.evaluate(cli_train.load_config(conf), str(best),
                            device="cpu", verbose=False, log=lambda *_: None)
    assert res["batches"] == 1 and np.isfinite(res["wer"])


@pytest.mark.parametrize("variant", sorted(RECIPE_VARIANTS))
def test_recipe_variant_trainer_and_packages_cross_both_ways(tmp_path, variant):
    """``Trainer.fit`` of the tanh-cell and the one-direction model makes the
    JAX trainer's epoch; best and resume packages load on the other side."""
    rnn_type, bidir = RECIPE_VARIANTS[variant]
    trainer, (tr, dv), jtrainer, (jtr, jdv) = make_trainers(
        tmp_path, rnn_type, bidir)
    assert trainer.spec.rnn_cell == variant_cell(variant)[0]
    assert trainer.spec.bidirectional == bidir
    quiet = lambda *_: None  # noqa: E731
    best = trainer.fit(tr, dv, num_epoches=2, log=quiet)
    jbest = jtrainer.fit(jtr, jdv, num_epoches=2, log=quiet)
    got, want = records(trainer), records(jtrainer)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("lr", "train_loss", "dev_loss", "train_acc", "dev_acc"):
            assert g[k] == pytest.approx(w[k], abs=TOL), (k, g, w)
    assert_state_matches(trainer.spec, trainer.state, jtrainer.state)

    _, jparams, jmstate, jman = jckpt.model_from_package(best)
    _, wparams, wmstate, wman = jckpt.model_from_package(jbest)
    assert jman["leaf_counts"] == wman["leaf_counts"]
    for g, w in zip(jax.tree_util.tree_leaves((jparams, jmstate)),
                    jax.tree_util.tree_leaves((wparams, wmstate))):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=TOL, rtol=0)

    restored, man = jckpt.restore_train_state(trainer.save_resume_checkpoint(),
                                              jtrainer.state)
    assert man["step"] == trainer.state.step == 4
    assert_state_matches(trainer.spec, trainer.state, restored, tol=0)
    fresh = Trainer(trainer.cfg, trainer.spec, device="cpu",
                    out_dir=str(tmp_path / "resumed"))
    fresh.resume(jtrainer.save_resume_checkpoint())
    assert fresh.epoch == 2 and fresh.state.step == 4
    assert_state_matches(fresh.spec, fresh.state, jtrainer.state, tol=0)
