"""The plain reference against the port's CPU path at tiny sizes, in
float32 (the port with ``dtype: float32``): the same function up to the
order of sums."""

import math

import pytest
import torch

from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.decode.greedy import greedy_collapse
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.ops.ctc_loss import ctc_loss
from ctc_pytorch_tpu_torch.train.loop import train_step
from ctc_pytorch_tpu_torch.train.state import create_train_state
from gpubench import judge
from gpubench.reference.decode import alignment_gaps, greedy_hypotheses
from gpubench.reference.model import Arch, ctc_mean_loss, forward
from gpubench.reference.train import train_steps
from gpubench.weights import make_weights

LSTM = {"rnn_input_size": 15, "feature_dim": 15, "rnn_hidden_size": 8,
        "rnn_layers": 2, "rnn_type": "nn.LSTM", "bidirectional": True,
        "batch_norm": True, "output_class_dim": 7, "add_cnn": True,
        "layers": 2, "channel": "[(1, 4), (4, 4)]",
        "kernel_size": "[(3, 3), (3, 3)]", "stride": "[(1, 2), (2, 2)]",
        "padding": "[(1, 1), (1, 1)]", "pooling": "None",
        "activation_function": "relu", "init_lr": 0.001,
        "weight_decay": 0.0005, "drop_out": 0, "dtype": "float32",
        "left_ctx": 0, "right_ctx": 0, "n_skip_frame": 1, "n_downsample": 2}
GRU = {**LSTM, "rnn_type": "nn.GRU", "num_class": 5, "layers": 1,
       "channel": "[(1, 4)]", "kernel_size": "[(5, 3)]", "stride": "[(2, 2)]",
       "padding": "[(0, 0)]", "activation_function": "hardtanh",
       "weight_decay": 0.005, "grad_clip": 0.5}
CONFIGS = {"lstm": LSTM, "gru": GRU}


def port_model(conf: dict, weights: dict, arch: Arch):
    spec = ModelSpec.from_config(Config.from_dict(conf), num_class=arch.n_class)
    model = CTCModel(spec)
    model.load_state_dict(weights)
    return spec, model


def batch(seed: int, arch: Arch, t_pad: int = 24, b: int = 4):
    gen = torch.Generator().manual_seed(seed)
    frames = torch.tensor([24, 20, 14, 24][:b])
    feats = torch.randn(b, t_pad, arch.in_dim, generator=gen)
    feats *= (torch.arange(t_pad)[None, :, None] < frames[:, None, None])
    frac = frames.to(torch.float32) / t_pad
    labels = torch.randint(2, arch.n_class, (b, 5), generator=gen)
    lab_len = torch.tensor([5, 4, 3, 5][:b])
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0][:b])  # a repeat-padded row
    return feats, frac, labels, lab_len, mask


@pytest.mark.parametrize("cell", sorted(CONFIGS))
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_the_port(cell, train):
    conf = CONFIGS[cell]
    arch = Arch.from_config(conf)
    w = make_weights(arch, 5, "cpu")
    spec, model = port_model(conf, w, arch)
    feats, frac, _, _, mask = batch(1, arch)
    m = mask if train else None
    want = model(feats, frac=frac, example_mask=m, train=train)
    want_sizes = CTCModel.input_sizes(spec, frac, feats.shape[1],
                                      want.shape[0], example_mask=m)
    got, sizes = forward(w, arch, feats, frac, m, train)
    assert torch.equal(sizes, want_sizes.to(torch.int64))
    rows = (mask > 0) if train else slice(None)
    torch.testing.assert_close(got[:, rows], want[:, rows], atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_three_steps_match_the_port(cell):
    conf = CONFIGS[cell]
    arch = Arch.from_config(conf)
    w = make_weights(arch, 9, "cpu")
    cfg = Config.from_dict(conf)
    spec = ModelSpec.from_config(cfg, num_class=arch.n_class)
    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, device="cpu")
    state.model.load_state_dict(w)
    batches = [batch(s, arch) for s in (1, 2, 3)]
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [(names[id(p)], p)
              for p in state.optimizer.param_groups[0]["params"]]
    losses, grads = [], {}
    for k, (feats, frac, labels, lab_len, mask) in enumerate(batches):
        loss, _, _ = train_step(state, spec, feats, frac, labels, lab_len,
                                mask)
        losses.append(float(loss))
        if k == 0:
            grads = {n: state.optimizer.state[p]["exp_avg"] / 0.1
                     for n, p in params}
    step = {n: float((p.detach() - w[n]).norm()) for n, p in params}
    ref = train_steps(w, arch, batches)
    norms = {"losses": ref["losses"], "grads": ref["first_grad"],
             "grad_norms": {n: float(g.norm())
                            for n, g in ref["first_grad"].items()},
             "raw_grad_norms": {n: float(g.norm())
                                for n, g in ref["raw_grad"].items()},
             "step_norms": {n: float((p - w[n]).norm())
                            for n, p in ref["params"].items()}}
    got = judge.train_numbers(
        {"losses": losses, "grads": grads, "step_norms": step,
         "grad_norms": {n: float(g.norm()) for n, g in grads.items()}}, norms)
    assert got["loss_gap"] < 1e-5
    assert got["grad_norm_gap"] < 1e-4
    assert got["step_norm_gap"] < 1e-3
    assert got["grad_error"] < 1e-4


def test_ctc_loss_matches_the_port():
    gen = torch.Generator().manual_seed(3)
    lp = torch.log_softmax(torch.randn(12, 3, 6, generator=gen), -1)
    labels = torch.randint(1, 6, (3, 4), generator=gen)
    sizes, lab_len = torch.tensor([12, 9, 7]), torch.tensor([4, 3, 2])
    mask = torch.ones(3)
    want = ctc_loss(lp, labels, sizes, lab_len, reduction="none").mean()
    got = ctc_mean_loss(lp, sizes, labels, lab_len, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_greedy_matches_the_port_and_scores_zero():
    gen = torch.Generator().manual_seed(4)
    lp = torch.log_softmax(torch.randn(30, 5, 7, generator=gen) * 2, -1)
    sizes = torch.tensor([30, 25, 11, 1, 30])
    tokens, lens = greedy_collapse(lp.argmax(-1).t(), sizes)
    hyps = greedy_hypotheses(lp, sizes)
    assert hyps == [tokens[i, :lens[i]].tolist() for i in range(5)]
    gaps = alignment_gaps(lp, sizes, hyps)
    assert torch.all(gaps.abs() < 1e-9)
    wrong = [[(h[0] % 6) + 1] + h[1:] if h else [3] for h in hyps]
    assert torch.all(alignment_gaps(lp, sizes, wrong) > 0)
    too_long = [list(range(1, 7)) * 3] * 5
    assert math.isinf(float(alignment_gaps(lp, sizes, too_long)[3]))
