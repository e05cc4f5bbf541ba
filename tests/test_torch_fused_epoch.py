"""The port's fused epochs against the JAX package's on the CPU: the group
runners (``make_fused_fns``) and the epoch runners (``run_epoch_fused``,
``run_epoch_single``) over a device cache, in both dispatch modes, over two
epochs, and the ``Trainer`` with a rollback and an LR decay between fused
epochs.  On the CPU the runners run their step eagerly (on the card, from
captured CUDA graphs: ``tests/test_torch_cuda.py``).

From one init, fp32, ``drop_out: 0``.  Losses to rtol 1e-4 and parameters
to 1e-4 (the same fp32 math in another summation order; Adam's ``g / (|g| +
eps)`` lifts rounding noise on near-zero gradients to a fraction of lr =
1e-3); token errors and token counts exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.config import Config as JConfig
from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
from ctc_pytorch_tpu.train.loop import Trainer as JTrainer
from ctc_pytorch_tpu.train.loop import _pad_group
from ctc_pytorch_tpu.train.loop import make_epoch_fns as jax_make_epoch_fns
from ctc_pytorch_tpu.train.loop import make_fused_fns as jax_make_fused_fns
from ctc_pytorch_tpu.train.loop import make_step_fns
from ctc_pytorch_tpu.train.loop import run_epoch_fused as jax_run_epoch_fused
from ctc_pytorch_tpu.train.loop import run_epoch_single as jax_run_epoch_single
from ctc_pytorch_tpu.train.state import TrainState as JTrainState
from ctc_pytorch_tpu.train.state import snapshot as jax_snapshot
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.cli import train as cli_train
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.data import DeviceCachedLoader
from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec
from ctc_pytorch_tpu_torch.train import checkpoint as ckpt
from ctc_pytorch_tpu_torch.train.checkpoint import params_to_jax
from ctc_pytorch_tpu_torch.train.loop import (
    Trainer,
    make_epoch_fns,
    make_fused_fns,
    run_epoch_fused,
    run_epoch_single,
)
from ctc_pytorch_tpu_torch.train.state import (
    create_train_state,
    get_lr,
    restore,
    scale_lr,
    snapshot,
)
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_cuda import chip_smoke, tiny_recipe
from tests.test_torch_fused_order import corpus, fused_config, jax_loaders
from tests.test_torch_train import assert_state_matches, records, to_jnp

RTOL = 1e-4


def setup(tmp_path, dispatch="group", mode="quantized"):
    """A port and a JAX ``Trainer`` from one init, with their device caches:
    ``(trainer, (train, dev), jtrainer, (jtrain, jdev))``."""
    corpus(tmp_path)
    cfg = fused_config(Config, tmp_path, dispatch, mode)
    jcfg = fused_config(JConfig, tmp_path, dispatch, mode)
    vocab = Vocab(cfg.vocab_file)
    tr, dv = cli_train.build_loaders(cfg, vocab, device="cpu")
    assert isinstance(tr, DeviceCachedLoader) and isinstance(dv,
                                                             DeviceCachedLoader)
    spec = ModelSpec.from_config(cfg, num_class=vocab.n_words)
    jspec = JSpec.from_config(jcfg, num_class=JVocab(jcfg.vocab_file).n_words)
    trainer = Trainer(cfg, spec, device="cpu")
    jtrainer = JTrainer(jcfg, jspec)
    p, s = params_to_jax(spec, trainer.state.model.state_dict())
    jtrainer.state = JTrainState(jnp.zeros((), jnp.int32), to_jnp(p), to_jnp(s),
                                 jtrainer.tx.init(to_jnp(p)))
    jtrainer._rollback = jax_snapshot(jtrainer.state)
    jtrainer._best = jax_snapshot(jtrainer.state)
    return trainer, (tr, dv), jtrainer, jax_loaders(jcfg)


@pytest.mark.parametrize("mode", ["quantized", "bucket"])
def test_group_runners_match_jax(tmp_path, mode):
    """Group by group: each batch's loss, the group's token errors and
    tokens, train and eval, over two epochs; then the state."""
    trainer, (tr, dv), jtrainer, (jtr, jdv) = setup(tmp_path, mode=mode)
    raw = make_step_fns(jtrainer.spec, jtrainer.tx, return_raw=True)[2:]
    jtrain, jeval = jax_make_fused_fns(raw)
    train, evaluate = make_fused_fns(trainer.spec)
    state, jstate = trainer.state, jtrainer.state
    rng = jax.random.PRNGKey(0)
    n_groups = 0
    for epoch in (1, 2):
        for (arrs, pos, mask, t_pad), (jarrs, jpos, jmask, jt) in zip(
                tr.epoch_groups(epoch), jtr.epoch_groups(epoch)):
            k = pos.shape[0]
            losses, errs, toks = train(state, arrs, pos, mask, t_pad)
            ppos, pmask, valid = _pad_group(jpos, jmask)
            jstate, jlosses, jerrs, jtoks = jtrain(
                jstate, jarrs["feats"], jarrs["labels"], jarrs["in_len"],
                jarrs["lab_len"], jnp.asarray(ppos), jnp.asarray(pmask),
                jnp.asarray(valid), rng, jt, True)
            assert losses.shape == (k,)
            np.testing.assert_allclose(losses.numpy(),
                                       np.asarray(jlosses)[:k], rtol=RTOL)
            assert (int(errs), int(toks)) == (int(jerrs), int(jtoks))
            assert int(toks) > 0
            n_groups += 1
        for (arrs, pos, mask, t_pad), (jarrs, jpos, jmask, jt) in zip(
                dv.epoch_groups(0), jdv.epoch_groups(0)):
            losses, errs, toks = evaluate(state, arrs, pos, mask, t_pad)
            ppos, pmask, valid = _pad_group(jpos, jmask)
            jlosses, jerrs, jtoks = jeval(
                jstate, jarrs["feats"], jarrs["labels"], jarrs["in_len"],
                jarrs["lab_len"], jnp.asarray(ppos), jnp.asarray(pmask),
                jnp.asarray(valid), jt, True)
            np.testing.assert_allclose(losses.numpy(),
                                       np.asarray(jlosses)[:pos.shape[0]],
                                       rtol=RTOL)
            assert (int(errs), int(toks)) == (int(jerrs), int(jtoks))
    assert n_groups >= 4
    assert state.step == int(jstate.step) == 2 * len(tr)
    assert_state_matches(trainer.spec, state, jstate)
    # without compute_wer nothing is counted
    arrs, pos, mask, t_pad = next(dv.epoch_groups(0))
    _, errs, toks = evaluate(state, arrs, pos, mask, t_pad, False)
    assert int(errs) == int(toks) == 0


@pytest.mark.parametrize("dispatch", ["group", "epoch"])
def test_epoch_runners_match_jax(tmp_path, dispatch):
    """``run_epoch_fused`` ("group") and ``run_epoch_single`` ("epoch")
    against the JAX runners: accuracy, average loss and the progress lines
    of two epochs of training and their dev passes, then the state."""
    trainer, (tr, dv), jtrainer, (jtr, jdv) = setup(tmp_path, dispatch)
    raw = make_step_fns(jtrainer.spec, jtrainer.tx, return_raw=True)[2:]
    fused = make_fused_fns(trainer.spec)
    if dispatch == "epoch":
        ours, theirs = make_epoch_fns(fused), jax_make_epoch_fns(raw)
        run, jrun = run_epoch_single, jax_run_epoch_single
    else:
        ours, theirs = fused, jax_make_fused_fns(raw)
        run, jrun = run_epoch_fused, jax_run_epoch_fused
    state, jstate = trainer.state, jtrainer.state
    for epoch in (1, 2):
        for loader, jloader, training in ((tr, jtr, True), (dv, jdv, False)):
            if training:
                loader.set_epoch(epoch)
                jloader.set_epoch(epoch)
            lines, jlines = [], []
            acc, loss = run(epoch, ours, state, loader, training=training,
                            log=lines.append)
            jstate, jacc, jloss = jrun(
                epoch, theirs, jstate, jloader, training=training,
                rng=jax.random.PRNGKey(0) if training else None,
                log=jlines.append)
            assert acc == pytest.approx(jacc, abs=1e-12)
            assert loss == pytest.approx(jloss, rel=RTOL)
            assert len(lines) == len(jlines) >= 1
            # the same lines, their losses to 4 decimals aside
            for got, want in zip(lines, jlines):
                assert got.split("loss")[0] == want.split("loss")[0]
                assert got.split("wer")[-1] == want.split("wer")[-1]
            if training and dispatch == "group":
                assert len(lines) == 1 + len(list(tr.epoch_groups(epoch)))
            elif training:
                assert lines[0].startswith(f"Epoch = {epoch}, step = {len(tr)},")
    assert state.step == int(jstate.step) == 2 * len(tr)
    assert_state_matches(trainer.spec, state, jstate)


def test_trainer_fused_rollback_and_decay_match_jax(tmp_path):
    """``Trainer.fit`` on the fused path with a forced rollback and LR decay
    after epoch 2: the same decisions, losses and final state as the JAX
    trainer's, with the rollback and the decay acting on the live state."""
    trainer, (tr, dv), jtrainer, (jtr, jdv) = setup(tmp_path, "epoch")
    quiet = lambda *_: None  # noqa: E731
    lines = []
    for last_epoch, best_so_far in ((1, None), (2, -1000.0), (3, 1000.0)):
        for t in (trainer, jtrainer):
            if best_so_far is not None:
                t.scheduler.loss_best = t.scheduler.loss_best_true = best_so_far
        trainer.fit(tr, dv, num_epoches=last_epoch, log=lines.append)
        jtrainer.fit(jtr, jdv, num_epoches=last_epoch, log=quiet)
        if last_epoch == 1:
            # the rollback target: the epoch-1 state, as the tensors hold it
            after_1 = {k: v.clone()
                       for k, v in trainer.state.model.state_dict().items()}
    assert any(ln.startswith("fused_epoch: the epochs run over the device "
                             "cache") for ln in lines)
    got, want = records(trainer), records(jtrainer)
    assert [g["rollback"] for g in got] == [w["rollback"] for w in want] == [
        False, True, False]
    assert [g["decay_lr"] for g in got] == [False, True, False]
    for g, w in zip(got, want):
        for k in ("lr", "train_loss", "dev_loss", "train_acc", "dev_acc"):
            assert g[k] == pytest.approx(w[k], abs=1e-4), (k, g, w)
    assert got[2]["lr"] == pytest.approx(0.5 * got[0]["lr"])
    # epoch 3 trained from the epoch-1 state (epoch 2 was rolled back)
    assert trainer.state.step == int(jtrainer.state.step) == 2 * len(tr)
    assert_state_matches(trainer.spec, trainer.state, jtrainer.state)
    assert not torch.equal(trainer.state.model.fc.w, after_1["fc.w"])


def test_restore_and_lr_decay_write_the_live_tensors(tmp_path):
    """What a captured graph reads is never replaced: ``restore``,
    ``scale_lr`` and ``load_opt_state`` write into the tensors the state
    already holds, and the Adam state exists before the first step."""
    corpus(tmp_path)
    cfg = fused_config(Config, tmp_path)
    spec = ModelSpec.from_config(cfg,
                                 num_class=Vocab(cfg.vocab_file).n_words)
    state = create_train_state(spec, 1e-3, 5e-4, device="cpu")
    opt = state.optimizer

    def storage():
        out = [v.data_ptr() for v in state.model.state_dict().values()]
        out.append(opt.param_groups[0]["lr"].data_ptr())
        for p in opt.param_groups[0]["params"]:
            out += [opt.state[p][k].data_ptr()
                    for k in ("step", "exp_avg", "exp_avg_sq")]
        return out

    assert all(len(opt.state[p]) == 3 for p in opt.param_groups[0]["params"])
    before = storage()
    tr, _ = cli_train.build_loaders(cfg, Vocab(cfg.vocab_file), device="cpu")
    train, _ = make_fused_fns(spec)
    arrs, pos, mask, t_pad = next(tr.epoch_groups(1))
    snap = snapshot(state)
    train(state, arrs, pos, mask, t_pad)
    scale_lr(state, 0.5)
    assert get_lr(state) == pytest.approx(5e-4)
    assert state.step == pos.shape[0] and storage() == before
    restore(state, snap)
    assert storage() == before and state.step == 0
    assert get_lr(state) == pytest.approx(1e-3)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, snap["model"][k])
    assert all(float(opt.state[p]["step"]) == 0.0
               for p in opt.param_groups[0]["params"])
    # a resume package loads into the same tensors
    train(state, arrs, pos, mask, t_pad)
    path = tmp_path / "resume.npz"
    ckpt.save_package(path, spec, state.model, optimizer=opt,
                      step=state.step)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = [opt.state[p]["exp_avg"].clone()
               for p in opt.param_groups[0]["params"]]
    restore(state, snap)
    ckpt.restore_train_state(path, state, spec)
    assert storage() == before and state.step == pos.shape[0]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k])
    for p, m in zip(opt.param_groups[0]["params"], moments):
        assert torch.equal(opt.state[p]["exp_avg"], m)
        assert float(opt.state[p]["step"]) == pos.shape[0]


def test_the_card_check_of_fused_against_streaming_rehearses_on_the_cpu(
        tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 10 at a small size with ``device="cpu"``:
    the eager runners on both sides, so the check's own logic (the same
    batches in the same order, the records it compares, both decodes, the
    timed passes) runs where the tests run."""
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    cfg, spec = tiny_recipe(tmp_path / "data")
    out = chip_smoke.phase_fused_vs_streaming(cfg, spec, "tiny", "cpu",
                                              device="cpu")
    assert out["train_steps"] == 6 and out["dev_batches"] == 2
    assert out["graphs"] == 0 and out["utterances"] == 32
    assert len(out["train_pass_s"]["prefetch"]) == 2
