"""The shipped ``recipes/timit/mfcc_39_config.yaml`` through the port against
the JAX package on the CPU: 39-d MFCC features read from an ``.scp``, no
CNN, no splicing or frame skipping, a BiLSTM stack, batch 8, the fused epoch
dispatched once an epoch, and the ``Beam`` decoder with the stage-3 bigram
LM.  The recipe is cut only in width and depth (H=8, 2 layers), with
``drop_out: 0`` and fp32, on a synthetic corpus in its layout.

Losses to rtol 1e-4 and parameters to 1e-4 absolute, as the flagship's
three-step test (``tests/test_torch_train.py``): the same fp32 math in
another summation order, from one init."""

from itertools import islice
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
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
from ctc_pytorch_tpu_torch.cli import train_lm
from ctc_pytorch_tpu_torch.cli.test import evaluate
from ctc_pytorch_tpu_torch.config import load_config
from ctc_pytorch_tpu_torch.data import GroupedLoader, SpeechDataLoader, SpeechDataset
from ctc_pytorch_tpu_torch.data.kaldi_io import ArkWriter
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.train.checkpoint import params_from_jax, params_to_jax
from ctc_pytorch_tpu_torch.train.loop import Trainer, train_step
from ctc_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_fused_order import jax_loaders
from tests.test_torch_model import jax_weights
from tests.test_torch_train import assert_state_matches, to_jnp

RECIPE = Path(__file__).resolve().parent.parent / "recipes/timit/mfcc_39_config.yaml"
PHONES = ["aa", "ae", "b", "d", "iy", "k", "s", "sh"]
RTOL = 1e-4


def corpus(root, sizes=(("train", 24), ("dev", 8), ("test", 8))):
    """The recipe's data layout: ``units``, and per split 39-d features of
    20-60 frames in ``mfcc.ark/.scp`` with their ``phn_text``."""
    (root / "units").write_text("".join(p + "\n" for p in PHONES))
    for seed, (split, n) in enumerate(sizes):
        rng = np.random.RandomState(seed)
        d = root / split
        d.mkdir(parents=True)
        lines = []
        with ArkWriter(d / "mfcc.ark", d / "mfcc.scp") as w:
            for i in range(n):
                utt = f"{split}{i:02d}"
                w.write(utt, rng.randn(rng.randint(20, 61), 39)
                        .astype(np.float32))
                lines.append(utt + " " + " ".join(
                    rng.choice(PHONES, rng.randint(2, 7))))
        (d / "phn_text").write_text("\n".join(lines) + "\n")


def recipe(load, root, exp_name="mfcc39"):
    """The recipe as shipped, its data under ``root``, cut in width and
    depth, fp32 and without dropout."""
    cfg = load(RECIPE)
    assert (cfg.feature_dim, cfg.rnn_input_size, cfg.rnn_hidden_size,
            cfg.rnn_layers) == (39, 39, 256, 4)
    assert not cfg.cnn.add_cnn and cfg.rnn_type == "nn.LSTM" and cfg.bidirectional
    assert (cfg.left_ctx, cfg.right_ctx, cfg.n_skip_frame,
            cfg.n_downsample) == (0, 0, 1, 1)
    assert cfg.batch_size == 8 and cfg.dtype == "bfloat16" and cfg.drop_out == 0.2
    assert cfg.fused_epoch and cfg.fused_dispatch == "epoch"
    assert (cfg.decode_type, cfg.beam_width, cfg.lm_alpha) == ("Beam", 20, 0.1)
    cfg.vocab_file = str(root / "units")
    for key, split in (("train", "train"), ("valid", "dev"), ("test", "test")):
        setattr(cfg, f"{key}_scp_path", str(root / split / "mfcc.scp"))
        setattr(cfg, f"{key}_lab_path", str(root / split / "phn_text"))
    cfg.lm_path = str(root / "lm_phone_bg.arpa")
    cfg.checkpoint_dir, cfg.exp_name = str(root / "checkpoint"), exp_name
    cfg.rnn_hidden_size, cfg.rnn_layers = 8, 2
    cfg.drop_out, cfg.dtype = 0.0, "float32"
    return cfg


def test_three_recipe_steps_match_jax(tmp_path):
    """Three optimizer steps on the recipe's first three batches, from one
    init: the losses each step, then parameters, BN state and Adam
    moments."""
    corpus(tmp_path)
    cfg, jcfg = recipe(load_config, tmp_path), recipe(jax_load_config, tmp_path)
    vocab, jvocab = Vocab(cfg.vocab_file), JVocab(jcfg.vocab_file)
    jspec = JSpec.from_config(jcfg, num_class=jvocab.n_words)
    spec = ModelSpec.from_config(cfg, num_class=vocab.n_words)
    assert spec.to_dict() == jspec.to_dict()
    assert not spec.add_cnn and spec.rnn_input_size == 39 and spec.num_class == 10

    params, mstate = jax_weights(jspec, seed=4)
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

    batches = zip(loader(SpeechDataset, SpeechDataLoader, vocab, cfg),
                  loader(JDataset, JLoader, jvocab, jcfg))
    fields = ("feats", "input_frac", "labels", "label_lengths", "example_mask")
    for batch, jbatch in islice(batches, 3):
        arrays = [getattr(batch, k) for k in fields]
        for a, k in zip(arrays, fields):
            np.testing.assert_array_equal(a, getattr(jbatch, k))
        assert arrays[0].shape[0] == 8 and arrays[0].shape[2] == 39
        jstate, want_loss, _, want_sizes = train_jit(
            jstate, *(jnp.asarray(a) for a in arrays), jax.random.PRNGKey(0))
        loss, _, sizes = train_step(state, spec,
                                    *(torch.from_numpy(a) for a in arrays))
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
        np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    assert state.step == int(jstate.step) == 3
    assert_state_matches(spec, state, jstate)


def test_recipe_epoch_stage3_and_beam_stage4_match_jax(tmp_path):
    """One epoch of both ``Trainer``s on the recipe's fused path (the batch
    order of the JAX device cache, dispatched once an epoch), the losses
    equal; then stage 3 on the training transcripts and stage 4 of the saved
    package with the recipe's ``Beam`` decoder (width 20, the LM at 0.1):
    the JAX strings and scores, and the port's fused and streamed
    ``BeamDevice`` decodes give the same strings."""
    corpus(tmp_path)
    cfg = recipe(load_config, tmp_path, "port")
    jcfg = recipe(jax_load_config, tmp_path, "jax")
    vocab = Vocab(cfg.vocab_file)
    tr, dv = cli_train.build_loaders(cfg, vocab, device="cpu")
    assert isinstance(tr, GroupedLoader) and len(tr) == 3
    jtr, jdv = jax_loaders(jcfg)
    spec = ModelSpec.from_config(cfg, num_class=vocab.n_words)
    trainer = Trainer(cfg, spec, device="cpu")
    jtrainer = JTrainer(jcfg, JSpec.from_config(
        jcfg, num_class=JVocab(jcfg.vocab_file).n_words))
    p, s = params_to_jax(spec, trainer.state.model.state_dict())
    jtrainer.state = JTrainState(jnp.zeros((), jnp.int32), to_jnp(p), to_jnp(s),
                                 jtrainer.tx.init(to_jnp(p)))
    jtrainer._rollback = jax_snapshot(jtrainer.state)
    jtrainer._best = jax_snapshot(jtrainer.state)
    lines = []
    best = trainer.fit(tr, dv, num_epoches=1, log=lines.append)
    jtrainer.fit(jtr, jdv, num_epoches=1, log=lambda *a, **k: None)
    assert any(ln.startswith("fused_epoch: the epochs run over the device "
                             "cache") for ln in lines)
    for key in ("loss_results", "dev_loss_results"):
        np.testing.assert_allclose(trainer.histories[key],
                                   jtrainer.histories[key], rtol=RTOL)

    arpa = train_lm.main([str(tmp_path)])
    assert arpa == Path(cfg.lm_path) and arpa.exists()
    got_lines, want_lines = [], []
    got = evaluate(cfg, str(best), device="cpu", log=got_lines.append)
    want = jax_evaluate(jcfg, str(best), log=want_lines.append)
    n = 3 * 8
    assert got_lines[:n + 2] == want_lines[:n + 2]  # utterances, CER, WER
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]
    hyps = {u: d for u, d in zip(got_lines[:n:3], got_lines[2:n:3])}
    assert any(len(d.split()) > 2 for d in hyps.values())
    for fused in (True, False):
        cfg.decode_type, cfg.fused_decode = "BeamDevice", fused
        dev_lines = []
        res = evaluate(cfg, str(best), device="cpu", log=dev_lines.append)
        assert bool(res.get("fused")) == fused
        assert {u: d for u, d in zip(dev_lines[:n:3],
                                     dev_lines[2:n:3])} == hyps
        assert res["cer"] == got["cer"] and res["wer"] == got["wer"]
