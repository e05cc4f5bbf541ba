"""The port's stage 2 under the shipped recipes' ``fused_epoch`` and
``device_cache`` against the JAX package on the CPU: the batch order of the
JAX fused path (``DeviceCachedLoader.epoch_groups``), the per-epoch losses
of the two ``Trainer``s over it, and the ``log_dir`` file log.

Losses to rtol 1e-4: the same fp32 math in another summation order, from
one init, with ``drop_out: 0``."""

import jax.numpy as jnp
import numpy as np
import pytest

from ctc_pytorch_tpu.config import Config as JConfig
from ctc_pytorch_tpu.data import SpeechDataLoader as JLoader
from ctc_pytorch_tpu.data import SpeechDataset as JDataset
from ctc_pytorch_tpu.data.batching import DeviceCachedLoader
from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
from ctc_pytorch_tpu.train.loop import Trainer as JTrainer
from ctc_pytorch_tpu.train.state import TrainState as JTrainState
from ctc_pytorch_tpu.train.state import snapshot as jax_snapshot
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.cli import train as cli_train
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.data import (
    GroupedLoader,
    PrefetchLoader,
    SpeechDataLoader,
    SpeechDataset,
    estimate_bytes,
)
from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter
from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec
from ctc_pytorch_tpu_torch.train.checkpoint import params_to_jax
from ctc_pytorch_tpu_torch.train.loop import Trainer
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_train import PHONES, tiny_config, to_jnp

RTOL = 1e-4


def write_split(root, name, n, seed):
    """A split of mostly short utterances (6-15 frames) and some long ones
    (40-89): the batches' padded lengths spread over several buckets, so
    that grouping them changes their order."""
    rng = np.random.RandomState(seed)
    d = root / name
    d.mkdir(parents=True)
    lines = []
    with ArkWriter(d / "fbank.ark", d / "fbank.scp") as w:
        for i in range(n):
            utt = f"{name}{i:02d}"
            frames = int(rng.randint(6, 16) if rng.rand() < 0.75 else rng.randint(40, 90))
            w.write(utt, rng.randn(frames, 8).astype(np.float32))
            lines.append(utt + " " + " ".join(rng.choice(PHONES, 3)))
    (d / "phn_text").write_text("\n".join(lines) + "\n")


def corpus(root, n_train=24, n_dev=8):
    (root / "units").write_text("".join(p + "\n" for p in PHONES))
    write_split(root, "train", n_train, seed=3)
    write_split(root, "dev", n_dev, seed=4)


def fused_config(cls, root, dispatch="epoch", mode="quantized"):
    cfg = tiny_config(cls, root)
    cfg.num_buckets, cfg.batch_mode = 3, mode
    cfg.fused_epoch, cfg.device_cache, cfg.fused_dispatch = True, True, dispatch
    cfg.rnn_layers = 1
    return cfg


def jax_loaders(cfg):
    """The JAX stage 2's loaders with its device cache."""
    vocab = JVocab(cfg.vocab_file)
    tr = JDataset(vocab, cfg.train_scp_path, cfg.train_lab_path, cfg)
    dv = JDataset(vocab, cfg.valid_scp_path, cfg.valid_lab_path, cfg)
    tr_l = JLoader(tr, cfg.batch_size, shuffle=cfg.shuffle_train,
                   num_buckets=cfg.num_buckets, seed=cfg.seed, mode=cfg.batch_mode)
    dv_l = JLoader(dv, cfg.batch_size, shuffle=False,
                   num_buckets=cfg.num_buckets, seed=cfg.seed, mode=cfg.batch_mode)
    budget = cfg.device_cache_max_gb * (1 << 30)
    assert (DeviceCachedLoader.estimate_bytes(tr_l)
            + DeviceCachedLoader.estimate_bytes(dv_l)) <= budget
    return DeviceCachedLoader(tr_l), DeviceCachedLoader(dv_l)


def jax_order(loader, epoch, dispatch):
    """Dataset indices of the JAX fused path's batches, in its order."""
    groups = list(loader.epoch_groups(epoch, with_indices=True))
    if dispatch == "epoch":
        groups.sort(key=lambda g: g[3])  # run_epoch_single's order
    return [list(row) for g in groups for row in g[4]]


def port_order(loader, epoch, dispatch):
    out = []
    for indices, _, _ in loader.epoch_plan(epoch, dispatch):
        idx = list(indices)
        out.append(idx + idx[-1:] * (loader.batch_size - len(idx)))
    return out


@pytest.mark.parametrize("dispatch", ["epoch", "group"])
def test_fused_epochs_visit_the_jax_order_and_give_its_losses(tmp_path, dispatch):
    corpus(tmp_path)
    cfg = fused_config(Config, tmp_path, dispatch)
    jcfg = fused_config(JConfig, tmp_path, dispatch)
    vocab = Vocab(cfg.vocab_file)
    tr, dv = cli_train.build_loaders(cfg, vocab, device="cpu")
    assert isinstance(tr, GroupedLoader) and isinstance(dv, GroupedLoader)
    jtr, jdv = jax_loaders(jcfg)

    spec = ModelSpec.from_config(cfg, num_class=vocab.n_words)
    jspec = JSpec.from_config(jcfg, num_class=JVocab(jcfg.vocab_file).n_words)
    trainer = Trainer(cfg, spec, device="cpu")
    jtrainer = JTrainer(jcfg, jspec)
    assert jtrainer.fused_fns is not None
    p, s = params_to_jax(spec, trainer.state.model.state_dict())
    jtrainer.state = JTrainState(jnp.zeros((), jnp.int32), to_jnp(p), to_jnp(s),
                                 jtrainer.tx.init(to_jnp(p)))
    jtrainer._rollback = jax_snapshot(jtrainer.state)
    jtrainer._best = jax_snapshot(jtrainer.state)

    # the batch sequence of both epochs, read from the two loaders: the
    # grouping reorders the streaming sequence
    for epoch in (1, 2):
        want = jax_order(jtr, epoch, dispatch)
        assert port_order(tr, epoch, dispatch) == want
        assert len(want) == len(tr) == 6
    assert port_order(dv, 0, dispatch) == jax_order(jdv, 0, dispatch)
    assert any(port_order(tr, e, dispatch)
               != [list(i) + list(i[-1:]) * (4 - len(i))
                   for i, _, _ in tr.batcher.epoch_batches(e)] for e in (1, 2))

    lines = []
    trainer.fit(tr, dv, num_epoches=2, log=lines.append)
    jtrainer.fit(jtr, jdv, num_epoches=2, log=lambda *a, **k: None)
    assert any(ln.startswith("fused_epoch: the epochs run over the device "
                             "cache in the JAX fused path's order")
               and "one eager step per batch on the CPU" in ln for ln in lines)
    for key in ("loss_results", "dev_loss_results"):
        np.testing.assert_allclose(trainer.histories[key],
                                   jtrainer.histories[key], rtol=RTOL)
    np.testing.assert_allclose(trainer.histories["dev_cer_results"],
                               jtrainer.histories["dev_cer_results"], atol=1e-6)


@pytest.mark.parametrize("mode", ["quantized", "bucket"])
def test_grouped_plan_is_the_device_cache_order(tmp_path, mode):
    corpus(tmp_path, n_train=40)
    cfg = fused_config(Config, tmp_path, mode=mode)
    jcfg = fused_config(JConfig, tmp_path, mode=mode)
    tr, _ = cli_train.build_loaders(cfg, Vocab(cfg.vocab_file), device="cpu")
    jtr, _ = jax_loaders(jcfg)
    assert estimate_bytes(tr.loader) == DeviceCachedLoader.estimate_bytes(jtr.loader)
    for epoch in (1, 2, 3):
        for dispatch in ("group", "epoch"):
            assert port_order(tr, epoch, dispatch) == jax_order(jtr, epoch,
                                                                dispatch)
        # the same batches as the streaming order, only visited otherwise
        tr.set_epoch(epoch)
        grouped = [b.utts for b in tr.grouped("epoch")]
        streaming = [b.utts for b in tr]
        assert sorted(grouped) == sorted(streaming)


def test_build_loaders_streams_past_the_cache_budget(tmp_path):
    corpus(tmp_path)
    cfg = fused_config(Config, tmp_path)
    cfg.device_cache_max_gb = 1e-9
    lines = []
    tr, dv = cli_train.build_loaders(cfg, Vocab(cfg.vocab_file), lines.append,
                                     device="cpu")
    # past the budget the batches stream from the host, prefetched as the
    # JAX stage 2 prefetches them (host_prefetch), or plain without it
    assert type(tr) is PrefetchLoader and type(dv) is PrefetchLoader
    assert type(tr.loader) is SpeechDataLoader
    assert any("exceeds device_cache_max_gb" in ln for ln in lines)
    cfg.host_prefetch = False
    tr, _ = cli_train.build_loaders(cfg, Vocab(cfg.vocab_file), device="cpu")
    assert type(tr) is SpeechDataLoader
    cfg.device_cache, cfg.device_cache_max_gb = False, 6.0
    tr, _ = cli_train.build_loaders(cfg, Vocab(cfg.vocab_file), device="cpu")
    assert type(tr) is SpeechDataLoader
    # the streaming order's Trainer says that it is not the fused order
    cfg.device_cache_max_gb = 1e-9
    trainer = Trainer(cfg, ModelSpec.from_config(
        cfg, num_class=Vocab(cfg.vocab_file).n_words), device="cpu")
    lines = []
    trainer.fit(tr, tr, num_epoches=1, compute_wer=False, log=lines.append)
    assert any("fused_epoch requested but running the streaming order" in ln
               for ln in lines)
    cfg.fused_dispatch = "nope"
    with pytest.raises(ValueError, match="fused_dispatch"):
        Trainer(cfg, trainer.spec, device="cpu")


def test_log_dir_writes_the_epoch_lines_to_a_file(tmp_path):
    corpus(tmp_path, n_train=8, n_dev=4)
    cfg = fused_config(Config, tmp_path)
    cfg.num_epoches, cfg.exp_name = 2, "logged_run"
    cfg.log_dir = str(tmp_path / "log")
    conf = tmp_path / "conf.yaml"
    cfg.to_yaml(conf)
    cli_train.main(["--conf", str(conf), "--device", "cpu"])
    text = (tmp_path / "log" / "logged_run.log").read_text()
    for want in ("Start training epoch: 1", "Start training epoch: 2",
                 "Epoch 2 Train done", "Epoch 2 Valid done",
                 "End training, best model saved to"):
        assert want in text
