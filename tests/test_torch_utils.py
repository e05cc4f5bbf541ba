"""The port's small surfaces against the JAX package on the CPU: the
target layout helpers and ``seed_all`` (``utils.py``), the reference's
Gaussian weight noise (``CTCModel.add_weights_noise``) and ``profile:
True`` (``train/metrics_log.py:profile_ctx`` around the first epoch)."""

import json
import random

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.utils import flatten_targets as jax_flatten_targets
from ctc_pytorch_tpu.utils import unflatten_targets as jax_unflatten_targets
from ctc_pytorch_tpu_torch.config import CNNConfig
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.train.loop import Trainer
from ctc_pytorch_tpu_torch.train.metrics_log import profile_ctx
from ctc_pytorch_tpu_torch.utils import (
    flatten_targets,
    seed_all,
    unflatten_targets,
)
from tests.test_torch_train import make_trainers


@pytest.mark.parametrize("lengths", [[3, 0, 5, 1], [2], []])
def test_target_layouts_match_jax(lengths):
    rng = np.random.RandomState(len(lengths))
    b, l_max = len(lengths), max(lengths, default=0) + 2
    labels = rng.randint(1, 9, (b, l_max)).astype(np.int32)
    flat, lens = flatten_targets(labels, np.asarray(lengths))
    jflat, jlens = jax_flatten_targets(labels, np.asarray(lengths))
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(lens, jlens)
    assert flat.shape == (sum(lengths),)
    for pad_to in (None, l_max):
        back = unflatten_targets(flat, lengths, pad_to)
        np.testing.assert_array_equal(back, jax_unflatten_targets(
            jflat, lengths, pad_to))
        for i, n in enumerate(lengths):
            np.testing.assert_array_equal(back[i, :n], labels[i, :n])
            assert not back[i, n:].any()


def test_seed_all_seeds_torch_numpy_and_random():
    draws = []
    for _ in range(2):
        seed_all(11)
        draws.append((torch.rand(3).tolist(), np.random.rand(3).tolist(),
                      random.random()))
    assert draws[0] == draws[1]
    seed_all(12)
    assert torch.rand(3).tolist() != draws[0][0]


def test_weight_noise_moves_every_parameter_and_no_bn_statistic():
    """Gaussian noise of the reference's 0.075 on every parameter (RNG
    streams cannot match the JAX package's, so its mean and spread are
    held), from an explicit generator; BN statistics and counters are
    buffers and stay."""
    spec = ModelSpec(add_cnn=True, cnn=CNNConfig(
        add_cnn=True, layers=1, channel=[(1, 4)], kernel_size=[(3, 3)],
        stride=[(1, 2)], padding=[(1, 1)]), rnn_input_size=16,
        rnn_hidden_size=32, rnn_layers=2, rnn_cell="lstm", bidirectional=True,
        batch_norm=True, num_class=12, drop_out=0.0, compute_dtype="float32")
    model = CTCModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    model.add_weights_noise(generator=torch.Generator().manual_seed(1))
    noise = torch.cat([(p.detach() - params[k]).flatten()
                       for k, p in model.named_parameters()])
    assert noise.numel() > 40_000 and (noise != 0).all()
    assert abs(noise.mean().item()) < 3 * 0.075 / noise.numel() ** 0.5
    assert noise.std().item() == pytest.approx(0.075, rel=0.02)
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    # the same generator seed draws the same noise
    again = CTCModel(spec)
    again.load_state_dict({**params, **buffers})
    again.add_weights_noise(generator=torch.Generator().manual_seed(1))
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    again.add_weights_noise(stddev=0.0, generator=torch.Generator())
    assert torch.equal(again.fc.w, model.fc.w)


def test_profile_traces_the_first_epoch_with_the_steps_ops(tmp_path):
    trainer, (tr, dv), _, _ = make_trainers(tmp_path)
    trainer.cfg.profile = True
    traced = Trainer(trainer.cfg, trainer.spec, device="cpu",
                     out_dir=str(tmp_path / "traced"))
    traced.fit(tr, dv, num_epoches=2, compute_wer=False, log=lambda *a: None)
    traces = list((traced.out_dir / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1  # the first epoch only
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the step: the recurrence's forward and backward, BN, the loss, Adam
    for op in ("_LstmBidirTrain", "_LstmBidirTrainBackward", "aten::rsqrt",
               "aten::log_softmax", "Optimizer.step#Adam.step"):
        assert any(n.startswith(op) for n in names), op
    assert traced.state.step == 2 * len(tr)
    with profile_ctx(False, tmp_path / "off"):
        torch.ones(2).sum()
    assert not (tmp_path / "off").exists()
