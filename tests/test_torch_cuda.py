"""The port on the card: each Hopper kernel (eval LSTM, GRU and tanh RNN,
their trainable forwards and backwards, the LSTM's and GRU's forwards on
each of their branches, the LSTM's and GRU's backward pre-pass and serial
chain on both of its branches, the CTC loss's forward and backward, at
phase 3's CTC cases) against its plain twin, with two directions and with one, the stacked-layout
entry points' launch counts, and the models on CUDA against the same models
on the CPU, in eval and in a train step; each kernel branch and the CTC
kernels replayed from a captured CUDA graph against the eager call, a
graphed epoch against the eager one, a graphed ``Trainer`` run with a
rollback and an LR decay against the same run on the CPU, the runners'
spans around the replays and captures, the CNN's conv epilogue against
its CPU arithmetic and its plain twin, eager and replayed, and DeepSpeech2
at its published widths against the plain reference
(``gpubench/reference/ds2.py``) for one step and in eval mode, its packed
rows against their padding.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  The file
imports neither JAX nor the JAX package, so on the GPU host it runs without
the JAX-only ``tests/conftest.py``:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu_torch.config import CNNConfig
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.models.layers import matmul_f32
from ctc_pytorch_tpu_torch.ops import ctc_loss as ctc_ops
from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
from ctc_pytorch_tpu_torch.ops import gru_bidir_train as gru_train_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops
from ctc_pytorch_tpu_torch.ops import lstm_bidir_train as train_ops
from ctc_pytorch_tpu_torch.ops import rnn_bidir as rnn_ops
from ctc_pytorch_tpu_torch.ops import rnn_bidir_train as rnn_train_ops
from ctc_pytorch_tpu_torch.ops import stacked

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from chip_smoke import (  # noqa: E402  phase 3's shapes
    CTC_CASES,
    CTC_GRAPH_CASES,
    FWD_CASES,
    GRAPH_CASES,
    HOIST_CASES,
    RNN_CASES,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("t,b,h,dtype,tol", [
    (80, 128, 384, torch.bfloat16, 2e-2),
    (40, 8, 384, torch.float32, 1e-4),
    (1, 1, 32, torch.float32, 1e-4),
    (7, 5, 36, torch.float32, 1e-4),
    (4, 4, 528, torch.float32, 1e-4),  # widest H with w_hh resident on 132 SMs
    (4, 4, 600, torch.float32, 1e-4),  # w_hh read from L2
    (3, 4, 1024, torch.float32, 1e-4),
])
def test_kernel_matches_plain_on_the_card(card, t, b, h, dtype, tol):
    gen = torch.Generator().manual_seed(t + b + h)
    gx = torch.randn(t, b, 8 * h, generator=gen).to(dtype).to(card)
    w_hh = ((torch.rand(2, h, 4 * h, generator=gen) * 2 - 1) * h ** -0.5).to(card)
    before = lstm_ops.launches
    got = lstm_ops.lstm_bidir(gx, w_hh)
    want = lstm_ops.lstm_bidir_plain(gx, w_hh).float()
    torch.cuda.synchronize()
    assert lstm_ops.launches == before + 1
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("pad_dynamics", ["batchmax", "padded", "valid"])
def test_model_on_the_card_matches_the_cpu(card, pad_dynamics):
    cnn = CNNConfig(add_cnn=True, layers=2, channel=[(1, 4), (4, 4)],
                    kernel_size=[(3, 3), (3, 3)], stride=[(1, 2), (2, 2)],
                    padding=[(1, 1), (1, 1)])
    spec = ModelSpec(add_cnn=True, cnn=cnn, rnn_input_size=24,
                     rnn_hidden_size=32, rnn_layers=2, rnn_cell="lstm",
                     bidirectional=True, batch_norm=True, num_class=8,
                     drop_out=0.0, compute_dtype="float32",
                     pad_dynamics=pad_dynamics)
    model = CTCModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 20, 24).astype(np.float32))
    frac = torch.tensor([1.0, 0.75, 0.5])
    with torch.no_grad():
        want = model(x, frac=frac)
        model.to(card)
        before = lstm_ops.launches
        got = model(x.to(card), frac=frac.to(card))
        torch.cuda.synchronize()
    assert lstm_ops.launches == before + spec.rnn_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=0)


def test_bf16_matmul_with_fp32_result_on_the_card(card):
    """The tensor-core GEMM (bf16 operands, fp32 sums and result) against
    the CPU's fp32 product of the same rounded operands."""
    rng = np.random.RandomState(2)
    a = torch.from_numpy(rng.randn(2, 40, 1952).astype(np.float32))
    b = torch.from_numpy(rng.randn(1952, 3072).astype(np.float32))
    want = matmul_f32(a, b, torch.bfloat16)
    got = matmul_f32(a.to(card), b.to(card), torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == (2, 40, 3072)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-5)


def _train_inputs(t, b, h, dtype, card):
    gen = torch.Generator().manual_seed(t + b + h)
    gx = torch.randn(t, b, 8 * h, generator=gen).to(dtype).to(card)
    w_hh = ((torch.rand(2, h, 4 * h, generator=gen) * 2 - 1) * h ** -0.5).to(card)
    dy = torch.randn(t, b, 2 * h, generator=gen).to(dtype).to(card)
    return gx, w_hh, dy


# fp32: absolute.  bf16: both sides round the same values to bf16, so an entry
# differs by an ulp or two of its own size: each entry is held to 2 bf16 ulps
# (2^-7 of the value each) of max(|want|, 1)
@pytest.mark.parametrize("t,b,h,dtype,tol", [
    (80, 128, 384, torch.bfloat16, 2.0 ** -6),
    (100, 8, 384, torch.float32, 1e-4),  # the recipe's batch
    (1, 1, 32, torch.float32, 1e-4),
    (33, 5, 36, torch.float32, 1e-4),  # odd T, H not a multiple of 8
    (6, 200, 64, torch.bfloat16, 2.0 ** -6),  # B over one 128-row tile
    (4, 4, 528, torch.float32, 1e-4),  # widest H with w_hh resident
    (4, 4, 600, torch.float32, 1e-4),  # w_hh read from L2
])
def test_train_kernels_match_plain_on_the_card(card, t, b, h, dtype, tol):
    gx, w_hh, dy = _train_inputs(t, b, h, dtype, card)
    fwd, bwd = train_ops.launches_fwd, train_ops.launches_bwd
    ys, cs = train_ops.lstm_bidir_train_cuda(gx, w_hh)
    want_ys, want_cs = train_ops.lstm_bidir_train_plain(gx, w_hh)
    # the backward kernel gets the twin's planes, so only it is under test
    dgx = train_ops.lstm_bidir_train_backward_cuda(gx, w_hh, want_ys, want_cs, dy)
    want_dgx = train_ops.lstm_bidir_train_backward_plain(gx, w_hh, want_ys,
                                                         want_cs, dy)
    torch.cuda.synchronize()
    assert (train_ops.launches_fwd, train_ops.launches_bwd) == (fwd + 1, bwd + 1)
    for got, want in ((ys, want_ys), (cs, want_cs), (dgx, want_dgx)):
        err = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            err = err / want.float().abs().clamp(min=1.0)
        assert err.max().item() <= tol
    dw, want_dw = train_ops.dw_hh(want_ys, dgx), train_ops.dw_hh(want_ys, want_dgx)
    assert ((dw - want_dw).abs().max().item()
            <= tol * max(1.0, want_dw.abs().max().item()))


def test_lstm_train_autograd_goes_through_both_kernels(card):
    gx, w_hh, dy = _train_inputs(12, 8, 64, torch.float32, card)
    gx.requires_grad_(True)
    w_hh.requires_grad_(True)
    fwd, bwd = train_ops.launches_fwd, train_ops.launches_bwd
    ys = train_ops.lstm_bidir_train(gx, w_hh)
    (ys * dy).sum().backward()
    torch.cuda.synchronize()
    assert (train_ops.launches_fwd, train_ops.launches_bwd) == (fwd + 1, bwd + 1)
    gx_c = gx.detach().cpu().requires_grad_(True)
    w_c = w_hh.detach().cpu().requires_grad_(True)
    (train_ops.lstm_bidir_train(gx_c, w_c) * dy.cpu()).sum().backward()
    assert (gx.grad.cpu() - gx_c.grad).abs().max().item() <= 1e-4
    assert (w_hh.grad.cpu() - w_c.grad).abs().max().item() <= 1e-4


@pytest.mark.parametrize("t,b,c,l", [
    (80, 128, 41, 48),  # bench shape, S = 97
    (100, 8, 41, 40),  # the recipe's batch
    (1, 1, 5, 0),  # T = 1, S = 1: an empty label
    (7, 3, 5, 2),
    (30, 2, 50, 600),  # S = 1201: more positions than threads in a CTA
])
def test_ctc_kernels_match_plain_on_the_card(card, t, b, c, l):
    """The forward kernel's alpha table and the backward kernel's beta table
    (its debug output) against the twins' on random labels, which repeat
    neighbours; one launch each way."""
    gen = torch.Generator().manual_seed(t + b)
    log_probs = torch.log_softmax(torch.randn(t, b, c, generator=gen), -1).to(card)
    labels = torch.randint(1, c, (b, l), generator=gen).to(card)
    in_len = torch.randint(max(1, t // 2), t + 1, (b,), generator=gen).to(card)
    lab_len = torch.randint(0, l + 1, (b,), generator=gen).to(card)
    args = (log_probs, labels, in_len, lab_len)
    g = torch.ones(b, device=card)
    a0, b0 = ctc_ops.launches_alpha, ctc_ops.launches_beta
    neg_ll, alphas = ctc_ops.ctc_fwd(*args)
    _, betas = ctc_ops.ctc_bwd(*args, alphas, neg_ll, g, with_betas=True)
    torch.cuda.synchronize()
    assert (ctc_ops.launches_alpha, ctc_ops.launches_beta) == (a0 + 1, b0 + 1)
    want_ll, want_alphas = ctc_ops.ctc_fwd_plain(*args)
    _, want_betas = ctc_ops.ctc_bwd_plain(*args, want_alphas, want_ll, g,
                                          with_betas=True)
    for got, want in ((alphas, want_alphas), (betas, want_betas)):
        dead = want <= -1e29
        assert torch.equal(got <= -1e29, dead)
        assert torch.all(got[dead] == ctc_ops.NEG_INF)
        assert (got - want)[~dead].abs().max().item() <= 1e-4


@pytest.mark.parametrize("case", CTC_CASES)
def test_ctc_kernels_match_plain_at_each_case(card, case):
    """``chip_smoke.py``'s phase 3 CTC case: tables, neg_ll, the gradient,
    two backward calls bit-equal, one launch each way, the branch."""
    chip_smoke.ctc_case(case, seed=300 + CTC_CASES.index(case))


def test_ctc_loss_on_the_card_matches_the_cpu(card):
    gen = torch.Generator().manual_seed(5)
    log_probs = torch.log_softmax(torch.randn(20, 4, 6, generator=gen), -1)
    labels = torch.randint(1, 6, (4, 4), generator=gen)
    labels[2] = 3  # four equal labels need seven frames: infeasible in five
    in_len = torch.tensor([20, 17, 5, 20])
    lab_len = torch.tensor([4, 2, 4, 0])
    grads, losses = [], []
    for dev in ("cpu", card):
        x = log_probs.clone().to(dev).requires_grad_(True)
        loss = ctc_ops.ctc_loss(x, labels.to(dev), in_len.to(dev),
                                lab_len.to(dev), reduction="none")
        loss.sum().backward()
        losses.append(loss.detach().cpu())
        grads.append(x.grad.cpu())
    assert losses[1][2] >= 1e29 and torch.isfinite(grads[1]).all()
    assert torch.equal(grads[1][:, 2], torch.zeros(20, 6))
    np.testing.assert_allclose(losses[1].numpy(), losses[0].numpy(), rtol=1e-5)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), atol=1e-5)


def test_train_step_on_the_card_matches_the_cpu(card):
    from ctc_pytorch_tpu_torch.train.loop import train_step
    from ctc_pytorch_tpu_torch.train.state import TrainState, make_optimizer

    cnn = CNNConfig(add_cnn=True, layers=1, channel=[(1, 4)],
                    kernel_size=[(3, 3)], stride=[(2, 2)], padding=[(1, 1)])
    spec = ModelSpec(add_cnn=True, cnn=cnn, rnn_input_size=24,
                     rnn_hidden_size=32, rnn_layers=2, rnn_cell="lstm",
                     bidirectional=True, batch_norm=True, num_class=8,
                     drop_out=0.0, compute_dtype="float32")
    rng = np.random.RandomState(3)
    batch = [torch.from_numpy(a) for a in (
        rng.randn(4, 40, 24).astype(np.float32),
        np.array([1.0, 0.9, 0.75, 0.75], np.float32),
        rng.randint(1, 8, (4, 5)).astype(np.int32),
        np.array([5, 4, 2, 2], np.int32),
        np.array([1, 1, 1, 0], np.float32))]
    results = []
    for dev in ("cpu", card):
        model = CTCModel(spec)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev)
        state = TrainState(model, make_optimizer(model, spec, 1e-3, 5e-4))
        counts = (train_ops.launches_fwd, train_ops.launches_bwd,
                  ctc_ops.launches_alpha, ctc_ops.launches_beta)
        losses = [train_step(state, spec, *(a.to(dev) for a in batch))[0].item()
                  for _ in range(2)]
        after = (train_ops.launches_fwd, train_ops.launches_bwd,
                 ctc_ops.launches_alpha, ctc_ops.launches_beta)
        launched = tuple(a - c for a, c in zip(after, counts))
        assert launched == ((4, 4, 2, 2) if dev == card else (0, 0, 0, 0))
        results.append((losses, {k: v.cpu() for k, v in model.state_dict().items()}))
    (cpu_losses, cpu_sd), (gpu_losses, gpu_sd) = results
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
    for k, v in cpu_sd.items():
        np.testing.assert_allclose(gpu_sd[k].numpy(), v.numpy(), atol=1e-4, rtol=0)


def _gru_inputs(t, b, h, dtype, card):
    gen = torch.Generator().manual_seed(t + b + h)
    gx = torch.randn(t, b, 6 * h, generator=gen).to(dtype).to(card)
    w_hh = ((torch.rand(2, h, 3 * h, generator=gen) * 2 - 1) * h ** -0.5).to(card)
    dy = torch.randn(t, b, 2 * h, generator=gen).to(dtype).to(card)
    return gx, w_hh, dy


# tolerances as the LSTM cases above: fp32 absolute; bf16 forward 2e-2
# absolute, bf16 backward 2 bf16 ulps of max(|want|, 1) per entry
@pytest.mark.parametrize("t,b,h,dtype", [
    (95, 128, 256, torch.bfloat16),  # the 863 bench shape
    (95, 16, 256, torch.bfloat16),  # the 863 recipe's batch
    (95, 128, 256, torch.float32),
    (1, 1, 32, torch.float32),
    (33, 5, 36, torch.float32),  # odd T, B % 4 != 0, H % 8 != 0
    (7, 3, 37, torch.float32),  # 3H not a multiple of 4
    (6, 200, 64, torch.bfloat16),  # B over one 128-row tile
    (4, 4, 528, torch.float32),  # widest H with w_hh resident
    (4, 4, 600, torch.float32),  # w_hh read from L2
    (3, 3, 1024, torch.float32),
])
def test_gru_kernels_match_plain_on_the_card(card, t, b, h, dtype):
    bf16 = dtype == torch.bfloat16
    gx, w_hh, dy = _gru_inputs(t, b, h, dtype, card)
    counts = (gru_ops.launches, gru_train_ops.launches_fwd,
              gru_train_ops.launches_bwd)
    ys_eval = gru_ops.gru_bidir_cuda(gx, w_hh)
    ys_train = gru_train_ops.gru_bidir_train_cuda(gx, w_hh)
    want_ys = gru_ops.gru_bidir_plain(gx, w_hh)
    # the backward kernel gets the twin's plane, so only it is under test
    dgx, dhhn = gru_train_ops.gru_bidir_train_backward_cuda(gx, w_hh, want_ys, dy)
    want_dgx, want_dhhn = gru_train_ops.gru_bidir_train_backward_plain(
        gx, w_hh, want_ys, dy)
    torch.cuda.synchronize()
    assert (gru_ops.launches, gru_train_ops.launches_fwd,
            gru_train_ops.launches_bwd) == tuple(c + 1 for c in counts)
    for got in (ys_eval, ys_train):
        assert ((got.float() - want_ys.float()).abs().max().item()
                <= (2e-2 if bf16 else 1e-4))
    tol = 2.0 ** -6 if bf16 else 1e-4
    for got, want in ((dgx, want_dgx), (dhhn, want_dhhn)):
        err = (got.float() - want.float()).abs()
        if bf16:
            err = err / want.float().abs().clamp(min=1.0)
        assert err.max().item() <= tol
    dw = gru_train_ops.dw_hh(want_ys, dgx, dhhn)
    want_dw = gru_train_ops.dw_hh(want_ys, want_dgx, want_dhhn)
    assert ((dw - want_dw).abs().max().item()
            <= tol * max(1.0, want_dw.abs().max().item()))


def test_gru_train_autograd_goes_through_both_kernels(card):
    gx, w_hh, dy = _gru_inputs(12, 8, 64, torch.float32, card)
    gx.requires_grad_(True)
    w_hh.requires_grad_(True)
    fwd, bwd = gru_train_ops.launches_fwd, gru_train_ops.launches_bwd
    ys = gru_train_ops.gru_bidir_train(gx, w_hh)
    (ys * dy).sum().backward()
    torch.cuda.synchronize()
    assert (gru_train_ops.launches_fwd, gru_train_ops.launches_bwd) == (fwd + 1,
                                                                        bwd + 1)
    gx_c = gx.detach().cpu().requires_grad_(True)
    w_c = w_hh.detach().cpu().requires_grad_(True)
    (gru_train_ops.gru_bidir_train(gx_c, w_c) * dy.cpu()).sum().backward()
    assert (gx.grad.cpu() - gx_c.grad).abs().max().item() <= 1e-4
    assert (w_hh.grad.cpu() - w_c.grad).abs().max().item() <= 1e-4


def _launches():
    return (lstm_ops.launches, train_ops.launches_fwd, train_ops.launches_bwd,
            gru_ops.launches, gru_train_ops.launches_fwd,
            gru_train_ops.launches_bwd, rnn_ops.launches,
            rnn_train_ops.launches_fwd, rnn_train_ops.launches_bwd)


@pytest.mark.parametrize("name,cell,train", [
    ("lstm_bidir_stacked", "lstm", False),
    ("lstm_bidir_train_stacked", "lstm", True),
    ("gru_bidir_stacked", "gru", False),
    ("gru_bidir_train_stacked", "gru", True),
    ("rnn_bidir_stacked", "rnn", True),  # one entry point, trainable
])
def test_stacked_entry_points_launch_the_kernels_and_match_the_cpu(
        card, name, cell, train):
    """Each layer-level entry point (which runs its scan-level one) launches
    the kernel of its cell and pass, once, and no other."""
    t, b, f, h, n = 9, 8, 12, 32, {"lstm": 4, "gru": 3, "rnn": 1}[cell]
    rng = np.random.RandomState(7)
    x, w_ih, w_hh = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(t, b, f), rng.randn(2, f, n * h) / np.sqrt(h),
        rng.randn(2, h, n * h) / np.sqrt(h)))
    fn = getattr(stacked, name)
    results = []
    for dev in ("cpu", card):
        args = [a.clone().to(dev).requires_grad_(train) for a in (x, w_ih, w_hh)]
        before = _launches()
        ys = fn(*args, torch.float32)
        if train:
            ys.square().sum().backward()
        delta = tuple(a - c for a, c in zip(_launches(), before))
        on = 1 if dev == card else 0
        want = {("lstm", False): (on, 0, 0, 0, 0, 0, 0, 0, 0),
                ("lstm", True): (0, on, on, 0, 0, 0, 0, 0, 0),
                ("gru", False): (0, 0, 0, on, 0, 0, 0, 0, 0),
                ("gru", True): (0, 0, 0, 0, on, on, 0, 0, 0),
                ("rnn", True): (0, 0, 0, 0, 0, 0, 0, on, on)}[(cell, train)]
        assert delta == want
        results.append([ys.detach().cpu()]
                       + ([a.grad.cpu() for a in args] if train else []))
    for got, want in zip(results[1], results[0]):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-4 * scale


def test_863_train_step_on_the_card_matches_the_cpu(card):
    from ctc_pytorch_tpu_torch.train.loop import train_step
    from ctc_pytorch_tpu_torch.train.state import TrainState, make_optimizer

    cnn = CNNConfig(add_cnn=True, layers=1, channel=[(1, 4)],
                    kernel_size=[(11, 5)], stride=[(2, 2)], padding=[(0, 0)],
                    activation_function="hardtanh")
    spec = ModelSpec(add_cnn=True, cnn=cnn, rnn_input_size=24,
                     rnn_hidden_size=32, rnn_layers=2, rnn_cell="gru",
                     bidirectional=True, batch_norm=True, num_class=8,
                     drop_out=0.0, compute_dtype="float32")
    rng = np.random.RandomState(3)
    batch = [torch.from_numpy(a) for a in (
        rng.randn(4, 40, 24).astype(np.float32),
        np.array([1.0, 0.9, 0.75, 0.75], np.float32),
        rng.randint(1, 8, (4, 5)).astype(np.int32),
        np.array([5, 4, 2, 2], np.int32),
        np.array([1, 1, 1, 0], np.float32))]
    lens = torch.tensor([15, 13, 11, 11])
    results = []
    for dev in ("cpu", card):
        model = CTCModel(spec)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev)
        state = TrainState(model, make_optimizer(model, spec, 1e-3, 0.005),
                           grad_clip=400.0)
        counts = (gru_train_ops.launches_fwd, gru_train_ops.launches_bwd,
                  ctc_ops.launches_alpha, ctc_ops.launches_beta)
        losses = [train_step(state, spec, *(a.to(dev) for a in batch))[0].item()
                  for _ in range(2)]
        after = (gru_train_ops.launches_fwd, gru_train_ops.launches_bwd,
                 ctc_ops.launches_alpha, ctc_ops.launches_beta)
        launched = tuple(a - c for a, c in zip(after, counts))
        assert launched == ((4, 4, 2, 2) if dev == card else (0, 0, 0, 0))
        with torch.no_grad():  # eval, packed `lengths` mode through the kernel
            before = gru_ops.launches
            packed = model(batch[0].to(dev), frac=batch[1].to(dev), train=False,
                           lengths=lens.to(dev))
            assert gru_ops.launches == before + (2 if dev == card else 0)
        results.append((losses, packed.cpu(),
                        {k: v.cpu() for k, v in model.state_dict().items()}))
    (cpu_losses, cpu_packed, cpu_sd), (gpu_losses, gpu_packed, gpu_sd) = results
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
    np.testing.assert_allclose(gpu_packed.numpy(), cpu_packed.numpy(), atol=1e-4)
    for k, v in cpu_sd.items():
        np.testing.assert_allclose(gpu_sd[k].numpy(), v.numpy(), atol=1e-4, rtol=0)


def _rnn_inputs(t, b, h, dtype, card, ndir=2, scale=1.0):
    gen = torch.Generator().manual_seed(t + b + h + ndir)
    gx = (scale * torch.randn(t, b, ndir * h, generator=gen)).to(dtype).to(card)
    w_hh = ((torch.rand(ndir, h, h, generator=gen) * 2 - 1) * h ** -0.5).to(card)
    dy = torch.randn(t, b, ndir * h, generator=gen).to(dtype).to(card)
    return gx, w_hh, dy


# tolerances as the LSTM and GRU cases: fp32 absolute; bf16 forward 2e-2
# absolute, bf16 backward 2 bf16 ulps of max(|want|, 1) per entry
@pytest.mark.parametrize("t,b,h,dtype,ndir,scale", [
    (80, 128, 384, torch.bfloat16, 2, 1.0),  # the TIMIT bench shape
    (100, 8, 384, torch.float32, 2, 1.0),  # the recipe's batch
    (80, 128, 384, torch.bfloat16, 2, 8.0),  # saturated: |h| near 1
    (1, 1, 37, torch.float32, 2, 1.0),
    (33, 5, 37, torch.float32, 1, 1.0),  # odd T, B % 4 != 0, H % 8 != 0
    (6, 200, 64, torch.bfloat16, 2, 1.0),  # B over one 128-row tile
    (4, 4, 1056, torch.float32, 2, 1.0),  # widest H with w_hh resident
    (4, 4, 1064, torch.float32, 2, 1.0),  # w_hh read from L2
    (4, 4, 1600, torch.float32, 1, 1.0),  # one direction past residency
])
def test_rnn_kernels_match_plain_on_the_card(card, t, b, h, dtype, ndir, scale):
    bf16 = dtype == torch.bfloat16
    gx, w_hh, dy = _rnn_inputs(t, b, h, dtype, card, ndir, scale)
    counts = (rnn_ops.launches, rnn_train_ops.launches_fwd,
              rnn_train_ops.launches_bwd)
    ys_eval = rnn_ops.rnn_bidir_cuda(gx, w_hh)
    ys_train = rnn_train_ops.rnn_bidir_train_cuda(gx, w_hh)
    want_ys = rnn_ops.rnn_bidir_plain(gx, w_hh)
    # the backward kernel gets the twin's plane, so only it is under test
    dgx = rnn_train_ops.rnn_bidir_train_backward_cuda(w_hh, want_ys, dy)
    want_dgx = rnn_train_ops.rnn_bidir_train_backward_plain(w_hh, want_ys, dy)
    torch.cuda.synchronize()
    assert (rnn_ops.launches, rnn_train_ops.launches_fwd,
            rnn_train_ops.launches_bwd) == tuple(c + 1 for c in counts)
    for got in (ys_eval, ys_train):
        assert ((got.float() - want_ys.float()).abs().max().item()
                <= (2e-2 if bf16 else 1e-4))
    tol = 2.0 ** -6 if bf16 else 1e-4
    err = (dgx.float() - want_dgx.float()).abs()
    if bf16:
        err = err / want_dgx.float().abs().clamp(min=1.0)
    assert err.max().item() <= tol
    dw = train_ops.dw_hh(want_ys, dgx, ndir)
    want_dw = train_ops.dw_hh(want_ys, want_dgx, ndir)
    assert ((dw - want_dw).abs().max().item()
            <= tol * max(1.0, want_dw.abs().max().item()))


def test_rnn_train_autograd_goes_through_both_kernels(card):
    gx, w_hh, dy = _rnn_inputs(12, 8, 64, torch.float32, card)
    gx.requires_grad_(True)
    w_hh.requires_grad_(True)
    fwd, bwd = rnn_train_ops.launches_fwd, rnn_train_ops.launches_bwd
    ys = rnn_train_ops.rnn_bidir_train(gx, w_hh)
    (ys * dy).sum().backward()
    torch.cuda.synchronize()
    assert (rnn_train_ops.launches_fwd, rnn_train_ops.launches_bwd) == (fwd + 1,
                                                                        bwd + 1)
    gx_c = gx.detach().cpu().requires_grad_(True)
    w_c = w_hh.detach().cpu().requires_grad_(True)
    (rnn_train_ops.rnn_bidir_train(gx_c, w_c) * dy.cpu()).sum().backward()
    assert (gx.grad.cpu() - gx_c.grad).abs().max().item() <= 1e-4
    assert (w_hh.grad.cpu() - w_c.grad).abs().max().item() <= 1e-4


def test_rnn_train_autograd_takes_the_wide_branch_at_the_bench_batch(card):
    """fp32 streams at B = 128, H = 384 (16 clusters of 8 do not fit):
    through ``rnn_bidir_train`` and ``.backward()`` both kernels launch the
    wide branch once, and the gradients hold the CPU twins' (gx within
    1e-4; dW_hh, a sum over T x B, within 1e-4 of its largest entry)."""
    gx, w_hh, dy = _rnn_inputs(20, 128, 384, torch.float32, card)
    gx.requires_grad_(True)
    w_hh.requires_grad_(True)
    fwd = dict(rnn_train_ops.launches_fwd_branch)
    bwd = dict(rnn_train_ops.launches_bwd_branch)
    ys = rnn_train_ops.rnn_bidir_train(gx, w_hh)
    (ys * dy).sum().backward()
    torch.cuda.synchronize()
    for now, before in ((rnn_train_ops.launches_fwd_branch, fwd),
                        (rnn_train_ops.launches_bwd_branch, bwd)):
        assert {k: v - before[k] for k, v in now.items()
                if v != before[k]} == {"wide_fp32": 1}
    gx_c = gx.detach().cpu().requires_grad_(True)
    w_c = w_hh.detach().cpu().requires_grad_(True)
    (rnn_train_ops.rnn_bidir_train(gx_c, w_c) * dy.cpu()).sum().backward()
    assert (gx.grad.cpu() - gx_c.grad).abs().max().item() <= 1e-4
    scale = max(1.0, w_c.grad.abs().max().item())
    assert (w_hh.grad.cpu() - w_c.grad).abs().max().item() <= 1e-4 * scale


# (eval op, trainable op, gates) per cell, for the one-direction launches
UNIDIR = {"lstm": (lstm_ops, train_ops, 4), "gru": (gru_ops, gru_train_ops, 3),
          "rnn": (rnn_ops, rnn_train_ops, 1)}


@pytest.mark.parametrize("t,b,h", [(40, 8, 384), (7, 3, 37), (5, 16, 64)])
@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_one_direction_kernels_match_the_cpu(card, cell, t, b, h):
    """ndir = 1: the eval op and the trainable op, forward and backward, on
    the card against the same calls on the CPU (the plain twins)."""
    eval_mod, train_mod, n = UNIDIR[cell]
    gen = torch.Generator().manual_seed(t + b + h)
    gx = torch.randn(t, b, n * h, generator=gen)
    w_hh = (torch.rand(1, h, n * h, generator=gen) * 2 - 1) * h ** -0.5
    dy = torch.randn(t, b, h, generator=gen)
    eval_fn = getattr(eval_mod, f"{cell}_bidir")
    train_fn = getattr(train_mod, f"{cell}_bidir_train")
    results = []
    for dev in ("cpu", card):
        before = _launches()
        ys_eval = eval_fn(gx.to(dev), w_hh.to(dev))
        g, w = (a.clone().to(dev).requires_grad_(True) for a in (gx, w_hh))
        ys = train_fn(g, w)
        (ys * dy.to(dev)).sum().backward()
        launched = sum(a - c for a, c in zip(_launches(), before))
        assert launched == (3 if dev == card else 0)
        assert ys.shape == (t, b, h)
        results.append([x.detach().cpu() for x in (ys_eval, ys, g.grad, w.grad)])
    for got, want in zip(results[1], results[0]):
        assert ((got - want).abs().max().item()
                <= 1e-4 * max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("cell,bidirectional", [("rnn", True), ("lstm", False)])
def test_rnn_variant_train_step_on_the_card_matches_the_cpu(card, cell,
                                                            bidirectional):
    """The tanh-RNN model and the unidirectional LSTM model: two fp32 steps
    and a packed-``lengths`` eval forward, on the card against the CPU."""
    from ctc_pytorch_tpu_torch.train.loop import train_step
    from ctc_pytorch_tpu_torch.train.state import TrainState, make_optimizer

    cnn = CNNConfig(add_cnn=True, layers=1, channel=[(1, 4)],
                    kernel_size=[(3, 3)], stride=[(2, 2)], padding=[(1, 1)])
    spec = ModelSpec(add_cnn=True, cnn=cnn, rnn_input_size=24,
                     rnn_hidden_size=32, rnn_layers=2, rnn_cell=cell,
                     bidirectional=bidirectional, batch_norm=True, num_class=8,
                     drop_out=0.0, compute_dtype="float32")
    eval_mod, train_mod, _ = UNIDIR[cell]
    rng = np.random.RandomState(3)
    batch = [torch.from_numpy(a) for a in (
        rng.randn(4, 40, 24).astype(np.float32),
        np.array([1.0, 0.9, 0.75, 0.75], np.float32),
        rng.randint(1, 8, (4, 5)).astype(np.int32),
        np.array([5, 4, 2, 2], np.int32),
        np.array([1, 1, 1, 0], np.float32))]
    lens = torch.tensor([20, 18, 15, 15])
    results = []
    for dev in ("cpu", card):
        model = CTCModel(spec)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev)
        state = TrainState(model, make_optimizer(model, spec, 1e-3, 5e-4))
        counts = (train_mod.launches_fwd, train_mod.launches_bwd)
        losses = [train_step(state, spec, *(a.to(dev) for a in batch))[0].item()
                  for _ in range(2)]
        launched = (train_mod.launches_fwd - counts[0],
                    train_mod.launches_bwd - counts[1])
        assert launched == ((4, 4) if dev == card else (0, 0))
        with torch.no_grad():
            before = eval_mod.launches
            packed = model(batch[0].to(dev), frac=batch[1].to(dev), train=False,
                           lengths=lens.to(dev))
            assert eval_mod.launches == before + (2 if dev == card else 0)
        results.append((losses, packed.cpu(),
                        {k: v.cpu() for k, v in model.state_dict().items()}))
    (cpu_losses, cpu_packed, cpu_sd), (gpu_losses, gpu_packed, gpu_sd) = results
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
    np.testing.assert_allclose(gpu_packed.numpy(), cpu_packed.numpy(), atol=1e-4)
    for k, v in cpu_sd.items():
        np.testing.assert_allclose(gpu_sd[k].numpy(), v.numpy(), atol=1e-4, rtol=0)


def _held(got, want, bf16):
    """fp32: the largest absolute error; bf16: in units of max(|want|, 1)."""
    err = (got.float() - want.float()).abs()
    return (err / want.float().abs().clamp(min=1.0) if bf16 else err).max().item()


@pytest.mark.parametrize("cell,t,b,h,dtype,ndir,branch", HOIST_CASES)
def test_hoisted_backward_kernels_match_plain_on_the_card(card, cell, t, b, h,
                                                          dtype, ndir, branch):
    """The pre-pass kernel against its twin (planes, fp32 sums in another
    order: 1e-4), the serial kernel on the twin's planes against the serial
    twin and the whole backward against the whole twin (tolerances as the
    backward cases above), and the branch the launcher reported, at
    ``chip_smoke.py``'s shapes."""
    bf16 = dtype == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    gates = 4 if cell == "lstm" else 3
    mod = train_ops if cell == "lstm" else gru_train_ops
    gen = torch.Generator().manual_seed(t + b + h + ndir)
    gx = torch.randn(t, b, ndir * gates * h, generator=gen).to(dtype).to(card)
    w_hh = ((torch.rand(ndir, h, gates * h, generator=gen) * 2 - 1)
            * h ** -0.5).to(card)
    dy = torch.randn(t, b, ndir * h, generator=gen).to(dtype).to(card)
    if cell == "lstm":
        saved = train_ops.lstm_bidir_train_plain(gx, w_hh)
    else:
        saved = (gru_ops.gru_bidir_plain(gx, w_hh),)
    counts = (mod.launches_bwd_prepass, mod.launches_bwd,
              dict(mod.launches_bwd_branch))
    planes = getattr(mod, f"{cell}_bidir_train_bwd_prepass_cuda")(gx, w_hh, *saved)
    want_planes = getattr(mod, f"{cell}_bidir_train_bwd_prepass_plain")(
        gx, w_hh, *saved)
    got_serial = getattr(mod, f"{cell}_bidir_train_bwd_serial_cuda")(
        want_planes, w_hh, dy)
    want_serial = getattr(mod, f"{cell}_bidir_train_bwd_serial_plain")(
        want_planes, w_hh, dy)
    got = getattr(mod, f"{cell}_bidir_train_backward_cuda")(gx, w_hh, *saved, dy)
    want = getattr(mod, f"{cell}_bidir_train_backward_plain")(gx, w_hh, *saved, dy)
    torch.cuda.synchronize()
    assert mod.launches_bwd_prepass == counts[0] + 2
    assert mod.launches_bwd == counts[1] + 2
    # both serial launches took the one branch expected (a cluster branch of
    # 16 or 32 rows, as the card's capacity for clusters decides)
    delta = {k: v - counts[2][k] for k, v in mod.launches_bwd_branch.items()}
    took = [k for k, v in delta.items() if v]
    assert sum(delta.values()) == 2 and len(took) == 1
    assert took[0].startswith(branch)
    assert planes.shape == want_planes.shape == (ndir, t, mod.PLANES, b, h)
    assert (planes - want_planes).abs().max().item() <= 1e-4
    tol = 2.0 ** -6 if bf16 else 1e-4
    for g_out, w_out in ((got_serial, want_serial), (got, want)):
        for g_plane, w_plane in zip(*(
                (x,) if cell == "lstm" else x for x in (g_out, w_out))):
            assert torch.isfinite(g_plane.float()).all()
            assert _held(g_plane, w_plane, bf16) <= tol


@pytest.mark.parametrize("kernel,t,b,h,dtype,ndir,branch", FWD_CASES)
def test_forward_kernels_match_plain_on_each_branch(card, kernel, t, b, h,
                                                    dtype, ndir, branch):
    """Each LSTM and GRU forward kernel against its twin at ``chip_smoke.py``'s
    shapes, with the branch the library reported: ys (and cs, in units of
    max(|want|, 1)) within 1e-4, 2e-2 with bf16 streams."""
    bf16 = dtype == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    gates = 3 if kernel == "gru" else 4
    gen = torch.Generator().manual_seed(t + b + h + ndir)
    gx = torch.randn(t, b, ndir * gates * h, generator=gen).to(dtype).to(card)
    w_hh = ((torch.rand(ndir, h, gates * h, generator=gen) * 2 - 1)
            * h ** -0.5).to(card)
    if kernel == "lstm_eval":
        runs = [(lstm_ops, lstm_ops.lstm_bidir_cuda, lstm_ops.lstm_bidir_plain)]
    elif kernel == "lstm_train":
        runs = [(train_ops, train_ops.lstm_bidir_train_cuda,
                 train_ops.lstm_bidir_train_plain)]
    else:
        runs = [(gru_ops, gru_ops.gru_bidir_cuda, gru_ops.gru_bidir_plain),
                (gru_train_ops, gru_train_ops.gru_bidir_train_cuda,
                 gru_ops.gru_bidir_plain)]
    tol = 2e-2 if bf16 else 1e-4
    for mod, fn, twin in runs:
        before = dict(mod.launches_fwd_branch)
        got, want = fn(gx, w_hh), twin(gx, w_hh)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in mod.launches_fwd_branch.items()}
        took = [k for k, v in delta.items() if v]
        assert sum(delta.values()) == 1 and took[0].startswith(branch)
        for i, (g, w) in enumerate(zip(
                *((x,) if torch.is_tensor(x) else x for x in (got, want)))):
            assert torch.isfinite(g.float()).all()
            err = (g.float() - w.float()).abs()
            if i == 1:  # cs
                err = err / w.float().abs().clamp(min=1.0)
            assert err.max().item() <= tol


@pytest.mark.parametrize("kernel,t,b,h,dtype,ndir,branch,scale", RNN_CASES)
def test_rnn_kernels_match_plain_on_each_branch(card, kernel, t, b, h, dtype,
                                                ndir, branch, scale):
    """The tanh cell's forward (the eval op and the training forward) or
    backward against its twin at ``chip_smoke.py``'s shapes, with the branch
    the library reported: ys within 1e-4, 2e-2 with bf16 streams; dgx within
    1e-4, 2 bf16 ulps of max(|want|, 1) with bf16 streams."""
    bf16 = dtype == "bf16"
    gx, w_hh, dy = _rnn_inputs(t, b, h, torch.bfloat16 if bf16 else torch.float32,
                               card, ndir, scale)
    want_ys = rnn_ops.rnn_bidir_plain(gx, w_hh)
    if kernel == "fwd":
        runs = [(rnn_ops.launches_fwd_branch,
                 lambda: rnn_ops.rnn_bidir_cuda(gx, w_hh), want_ys),
                (rnn_train_ops.launches_fwd_branch,
                 lambda: rnn_train_ops.rnn_bidir_train_cuda(gx, w_hh), want_ys)]
    else:
        runs = [(rnn_train_ops.launches_bwd_branch,
                 lambda: rnn_train_ops.rnn_bidir_train_backward_cuda(
                     w_hh, want_ys, dy),
                 rnn_train_ops.rnn_bidir_train_backward_plain(w_hh, want_ys, dy))]
    for counts, fn, want in runs:
        before = dict(counts)
        got = fn()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts.items()}
        took = [k for k, v in delta.items() if v]
        assert sum(delta.values()) == 1 and took[0].startswith(branch)
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs()
        if kernel == "bwd" and bf16:
            err = err / want.float().abs().clamp(min=1.0)
        tol = (2e-2 if kernel == "fwd" else 2.0 ** -6) if bf16 else 1e-4
        assert err.max().item() <= tol


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_kernel_replays_in_a_captured_graph(card, case):
    """Each recurrence kernel on each branch, captured through the port's
    ``train/graphs.py`` and replayed: the replay equals the eager call bit
    for bit, counts its launches once, and the branch is the listed one."""
    chip_smoke.graph_case(case, seed=700 + GRAPH_CASES.index(case))


@pytest.mark.parametrize("t,b,l", CTC_GRAPH_CASES)
def test_ctc_kernels_replay_in_a_captured_graph(card, t, b, l):
    for _, call in chip_smoke.ctc_graph_calls(t, b, l, seed=t):
        err, eager, left, replay = chip_smoke.captured_vs_eager(call)
        assert err == 0.0 and not left and replay == eager and eager


def test_ctc_loss_is_one_launch_each_way_with_a_deterministic_gradient(card):
    """A CUDA call of ``ctc_loss`` launches one forward and one backward
    kernel, and two calls give bit-equal gradients with deterministic
    algorithms off."""
    lp, lab, il, ll = chip_smoke.ctc_inputs(100, 8, 41, 33, seed=5)
    assert not torch.are_deterministic_algorithms_enabled()
    grads = []
    for _ in range(2):
        a0, b0 = ctc_ops.launches_alpha, ctc_ops.launches_beta
        x = lp.clone().requires_grad_(True)
        ctc_ops.ctc_loss(x, lab, il, ll).backward()
        assert (ctc_ops.launches_alpha, ctc_ops.launches_beta) == (a0 + 1, b0 + 1)
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


def tiny_recipe(root, split_sizes=(("train", 24), ("dev", 8), ("test", 8))):
    """A tiny fp32 config (BiLSTM(16) x 2, 8-d features skipped by 4 to
    38-100 frames, batch 4, three buckets, fused epochs in ``t_pad`` order)
    on a synthetic corpus under ``root``: ``(cfg, spec)``.  The CPU tests
    use it too."""
    from ctc_pytorch_tpu_torch.config import Config
    from ctc_pytorch_tpu_torch.vocab import Vocab

    for i, (split, n) in enumerate(split_sizes):
        chip_smoke.write_corpus(root, split, n, seed=i, dim=8)
    cfg = Config()
    cfg.exp_name, cfg.checkpoint_dir = "tiny", str(root / "checkpoint")
    cfg.vocab_file = str(root / "units")
    for key, split in (("train", "train"), ("valid", "dev"), ("test", "test")):
        setattr(cfg, f"{key}_scp_path", str(root / split / "fbank.scp"))
        setattr(cfg, f"{key}_lab_path", str(root / split / "phn_text"))
    cfg.left_ctx = cfg.right_ctx = 0
    cfg.n_skip_frame, cfg.n_downsample = 4, 1
    cfg.feature_dim = cfg.rnn_input_size = 8
    cfg.rnn_hidden_size, cfg.rnn_layers = 16, 2
    cfg.drop_out, cfg.dtype = 0.0, "float32"
    cfg.batch_size, cfg.num_buckets = 4, 3
    cfg.init_lr, cfg.weight_decay = 1e-3, 5e-4
    cfg.fused_epoch, cfg.device_cache, cfg.fused_dispatch = True, True, "epoch"
    cfg.save_every = 0
    return cfg, ModelSpec.from_config(cfg,
                                      num_class=Vocab(cfg.vocab_file).n_words)


def test_graphed_epoch_matches_the_eager_epoch(card, tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 10 at a small size: one epoch and its dev
    pass through the graphed ``run_epoch_single`` and the eager
    ``run_epoch``, the same batches in the same order (losses, token counts,
    parameters, the fused and the streaming decode's strings)."""
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    cfg, spec = tiny_recipe(tmp_path / "data")
    out = chip_smoke.phase_fused_vs_streaming(cfg, spec, "tiny", "card")
    assert out["graphs"] >= 2 and out["pool_bytes"] > 0


def test_graphed_trainer_rollback_and_decay_act_on_the_live_state(card,
                                                                  tmp_path):
    """``Trainer.fit`` from captured graphs on the card and eagerly on the
    CPU, from one init, with a forced rollback and LR decay after epoch 2:
    the same decisions, losses within 1e-4 and final parameters within 1e-4
    (fp32, kernels against their twins), so the rollback and the decay
    reached the tensors the graphs hold."""
    from ctc_pytorch_tpu_torch.cli.train import build_loaders
    from ctc_pytorch_tpu_torch.data import DeviceCachedLoader
    from ctc_pytorch_tpu_torch.train.loop import Trainer
    from ctc_pytorch_tpu_torch.vocab import Vocab

    cfg, spec = tiny_recipe(tmp_path / "data")
    trainers, loaders = {}, {}
    for dev in ("cpu", "cuda"):
        loaders[dev] = build_loaders(cfg, Vocab(cfg.vocab_file), device=dev)
        assert isinstance(loaders[dev][0], DeviceCachedLoader)
        trainers[dev] = Trainer(cfg, spec, device=dev,
                                out_dir=str(tmp_path / dev))
    # one init: the CPU trainer's
    trainers["cuda"].state.model.load_state_dict(
        trainers["cpu"].state.model.state_dict())
    for dev, trainer in trainers.items():
        for last, best in ((1, None), (2, -1000.0), (3, 1000.0)):
            if best is not None:
                trainer.scheduler.loss_best = best
                trainer.scheduler.loss_best_true = best
            trainer.fit(*loaders[dev], num_epoches=last, log=lambda *_: None)
    cpu, gpu = trainers["cpu"], trainers["cuda"]
    tr, dv = loaders["cuda"]
    graphs = gpu.graphs()
    # every pass from graphs, the rolled-back epoch's too
    assert len(graphs) >= 2 and graphs.replays() == 3 * (len(tr) + len(dv))
    assert gpu.state.step == cpu.state.step == 2 * len(tr)
    for key in ("loss_results", "dev_loss_results"):
        np.testing.assert_allclose(gpu.histories[key], cpu.histories[key],
                                   rtol=1e-4)
    for k, v in cpu.state.model.state_dict().items():
        np.testing.assert_allclose(gpu.state.model.state_dict()[k].cpu().numpy(),
                                   v.numpy(), atol=1e-4, rtol=0)
    lr = gpu.state.optimizer.param_groups[0]["lr"]
    assert lr.is_cuda and float(lr) == pytest.approx(0.5e-3)


def _beam_inputs(seed, b=8, t=160, c=41, with_lm=True):
    """Peaked probabilities (B, T, C), lengths and a random bigram table."""
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(c, 0.3), size=(b, t)).astype(np.float32)
    lengths = rng.randint(t // 2, t + 1, b).astype(np.int32)
    table = (np.log(rng.dirichlet(np.ones(c + 1), c + 1)).astype(np.float32)
             if with_lm else None)
    return probs, lengths, table


@pytest.mark.parametrize("with_lm", [False, True])
def test_batched_beam_search_on_the_card_matches_the_cpu(card, with_lm):
    """The batched search (torch ops) on the card and on the CPU, the same
    inputs at the recipe's width 20 and capacity 96: the same tokens and
    lengths, scores within rtol 1e-5."""
    from ctc_pytorch_tpu_torch.decode.beam_device import batched_beam_search

    probs, lengths, table = _beam_inputs(11, with_lm=with_lm)
    kw = dict(beam_width=20, max_len=96, lm_alpha=0.1)
    out = {}
    for dev in ("cpu", card):
        out[str(dev)] = batched_beam_search(
            torch.from_numpy(probs).to(dev), torch.from_numpy(lengths).to(dev),
            lm_table=None if table is None else torch.from_numpy(table).to(dev),
            **kw)
    cpu, gpu = out["cpu"], [x.cpu() for x in out[str(card)]]
    assert torch.equal(gpu[0], cpu[0]) and torch.equal(gpu[1], cpu[1])
    assert int(cpu[1].sum()) > 0
    np.testing.assert_allclose(gpu[2].numpy(), cpu[2].numpy(), rtol=1e-5)


def test_batched_beam_search_replays_in_a_captured_graph(card):
    """The search captured through ``train/graphs.py`` (no host sync in it)
    and replayed on new inputs copied into its buffers: the eager call's
    results bit for bit."""
    from ctc_pytorch_tpu_torch.decode.beam_device import batched_beam_search
    from ctc_pytorch_tpu_torch.train.graphs import StepGraphs

    probs, lengths, table = _beam_inputs(12, t=60)
    lm = torch.from_numpy(table).to(card)
    inputs = {"probs": torch.from_numpy(probs).to(card),
              "lengths": torch.from_numpy(lengths).to(card)}

    def step():
        return batched_beam_search(inputs["probs"], inputs["lengths"],
                                   beam_width=20, max_len=96, lm_table=lm,
                                   lm_alpha=0.1)

    cap = StepGraphs().capture("beam", step, inputs)
    for seed in (13, 14):
        probs, lengths, _ = _beam_inputs(seed, t=60)
        inputs["probs"].copy_(torch.from_numpy(probs))
        inputs["lengths"].copy_(torch.from_numpy(lengths))
        got = [x.clone() for x in cap.replay()]
        want = step()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_waveform_frontend_on_the_card_matches_the_cpu(card):
    """The step's frontend (fbank + CMVN, mfcc + deltas, spectrogram) on the
    card against the CPU at stage 1's tolerance (``chip_smoke.FEAT_TOL``)."""
    from ctc_pytorch_tpu_torch.frontend.e2e import (
        WaveFrontendSpec,
        waveform_frontend,
    )
    from ctc_pytorch_tpu_torch.frontend.features import FrontendConfig

    rng = np.random.RandomState(0)
    wavs = (rng.randn(8, 64000) * 2000).astype(np.float32)
    lens = rng.randint(16000, 64001, 8).astype(np.int32)
    for i, n in enumerate(lens):
        wavs[i, n:] = 0.0
    for feat_type, n_mels in (("fbank", 80), ("mfcc39", 23),
                              ("spectrogram", 80)):
        spec = WaveFrontendSpec(feat_type=feat_type,
                                frontend=FrontendConfig(num_mel_bins=n_mels),
                                n_downsample=2)
        dim = spec.feature_dim() // 3
        cmvn = (None if feat_type == "spectrogram" else
                (rng.randn(dim).astype(np.float32),
                 rng.uniform(0.5, 2, dim).astype(np.float32)))
        out = {}
        for dev in ("cpu", card):
            out[str(dev)] = waveform_frontend(
                spec, torch.from_numpy(wavs).to(dev),
                torch.from_numpy(lens).to(dev),
                None if cmvn is None else tuple(
                    torch.from_numpy(c).to(dev) for c in cmvn))
        cpu, gpu = out["cpu"], out[str(card)]
        chip_smoke.feature_err(gpu[0], cpu[0], feat_type)
        assert torch.equal(gpu[1].cpu(), cpu[1])
        assert torch.equal(gpu[2].cpu(), cpu[2])


def test_fused_waveform_step_replays_against_the_eager_step(card, tmp_path):
    """One training step of a waveform model, frontend (cuFFT) included,
    captured by the fused runner over a device cache of raw samples and
    replayed, against the same step run eagerly from the same state: the
    loss and every parameter and BN buffer."""
    from ctc_pytorch_tpu_torch.cli.train import build_loaders
    from ctc_pytorch_tpu_torch.config import load_config
    from ctc_pytorch_tpu_torch.data.batching import gather_rows
    from ctc_pytorch_tpu_torch.frontend.e2e import frontend_fn_from_config
    from ctc_pytorch_tpu_torch.train.loop import make_fused_fns, train_step
    from ctc_pytorch_tpu_torch.train.state import create_train_state
    from ctc_pytorch_tpu_torch.vocab import Vocab

    # the waveform recipe cut to 12 mel bins + energy, 2 x BiLSTM(16), B=8
    for seed, (split, n) in enumerate((("train", 16), ("dev", 4))):
        chip_smoke.write_audio_corpus(tmp_path, split, n, seed, (0.3, 0.7))
    cfg = load_config(chip_smoke.RECIPE_WAVE)
    cfg.vocab_file = str(tmp_path / "units")
    for key, split in (("train", "train"), ("valid", "dev")):
        setattr(cfg, f"{key}_scp_path", str(tmp_path / split / "wav.scp"))
        setattr(cfg, f"{key}_lab_path", str(tmp_path / split / "phn_text"))
    cfg.data_dir = str(tmp_path)
    cfg.feature_dim, cfg.rnn_input_size = 13, 39
    cfg.rnn_hidden_size, cfg.rnn_layers = 16, 2
    cfg.batch_size, cfg.drop_out, cfg.dtype = 8, 0.0, "float32"
    tr, _ = build_loaders(cfg, Vocab(cfg.vocab_file), device=card)
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    fe = frontend_fn_from_config(cfg)
    arrs, pos, mask, t_pad = next(tr.epoch_groups(1))
    states = [create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                                 cfg.grad_clip, seed=3, device=card)
              for _ in range(2)]
    fused_train, _ = make_fused_fns(spec, None, fe)
    losses, _, _ = fused_train(states[0], arrs, pos[:1], mask[:1], t_pad)
    assert len(fused_train.graphs) == 1 and fused_train.graphs.replays() == 1
    feats, frac, _, labels, lab_len = gather_rows(
        arrs, torch.from_numpy(pos[0].astype(np.int64)).to(card), t_pad,
        waveform=True)
    loss, _, _ = train_step(states[1], spec, feats, frac, labels, lab_len,
                            torch.from_numpy(mask[0]).to(card), None, fe)
    np.testing.assert_allclose(losses[0].item(), loss.item(), rtol=1e-6)
    want = states[1].model.state_dict()
    for k, v in states[0].model.state_dict().items():
        np.testing.assert_allclose(v.cpu().numpy(), want[k].cpu().numpy(),
                                   atol=1e-6, rtol=0)
    assert states[0].step == states[1].step == 1


# the 863 LSTM recipes' kernel shapes among phase 3's lists: H=256, B=16
# on bf16 streams, T' from cnn_lstm_ctc.conf's 95 to lstm_ctc.conf's 400
SHAPES_863_LSTM = [c for c in FWD_CASES + HOIST_CASES
                   if c[0].startswith("lstm") and c[2:5] == (16, 256, "bf16")]


def test_phase3_holds_the_863_lstm_recipe_shapes():
    """The lists the cases above run (and ``chip_smoke.py`` phase 3) hold
    the 863 LSTM recipes' shapes on their branches, and the CTC cases the
    ``lstm_ctc.conf`` batch; a list check, so it runs without a card."""
    assert {(c[0], c[1], c[-1]) for c in SHAPES_863_LSTM} >= {
        ("lstm_train", 95, "cluster16"), ("lstm_train", 195, "cluster16"),
        ("lstm_train", 400, "cluster16"), ("lstm_eval", 95, "cluster16_fp32"),
        ("lstm_eval", 400, "cluster16_fp32"), ("lstm", 95, "cluster"),
        ("lstm", 195, "cluster"), ("lstm", 400, "cluster")}
    assert any(c[:4] == (400, 16, 67, 40) for c in CTC_CASES)


@pytest.mark.parametrize("t,add_cnn", [(95, True), (400, False)])
def test_863_lstm_train_step_takes_the_16_row_clusters(card, t, add_cnn):
    """A bf16 train step of an 863 LSTM model at H=256, B=16 (the recipes'
    bf16 streams) on the card: the training forward on ``cluster16``, the
    backward's serial launches on 16-row clusters, a finite loss that
    agrees with the same step through the twins."""
    from ctc_pytorch_tpu_torch.train.loop import train_step
    from ctc_pytorch_tpu_torch.train.state import create_train_state

    cnn = CNNConfig(add_cnn=add_cnn, layers=1, channel=[(1, 16)],
                    kernel_size=[(11, 5)], stride=[(2, 2)], padding=[(0, 0)],
                    activation_function="hardtanh")
    feat = 201 if add_cnn else 40
    spec = ModelSpec(add_cnn=add_cnn, cnn=cnn, rnn_input_size=feat,
                     rnn_hidden_size=256, rnn_layers=2, rnn_cell="lstm",
                     bidirectional=True, batch_norm=True, num_class=67,
                     drop_out=0.0, compute_dtype="bfloat16")
    t_in = 2 * t + 10 if add_cnn else t
    gen = torch.Generator().manual_seed(t)
    feats = torch.randn(16, t_in, feat, generator=gen).to(card)
    frac = torch.ones(16, device=card)
    labels = torch.randint(1, 67, (16, 30), generator=gen).int().to(card)
    lab_len = torch.full((16,), 30, dtype=torch.int32, device=card)
    mask = torch.ones(16, device=card)
    state = create_train_state(spec, 1e-3, 0.005, 400.0, seed=1, device=card)
    fwd = dict(train_ops.launches_fwd_branch)
    bwd = dict(train_ops.launches_bwd_branch)
    loss, _, _ = train_step(state, spec, feats, frac, labels, lab_len, mask)
    torch.cuda.synchronize()
    took_fwd = {k: v - fwd[k] for k, v in train_ops.launches_fwd_branch.items()
                if v != fwd[k]}
    took_bwd = {k: v - bwd[k] for k, v in train_ops.launches_bwd_branch.items()
                if v != bwd[k]}
    assert took_fwd == {"cluster16": 2} and took_bwd == {"cluster16": 2}
    assert torch.isfinite(loss).item()
    with chip_smoke.plain_twins():
        twin = create_train_state(spec, 1e-3, 0.005, 400.0, seed=1, device=card)
        want, _, _ = train_step(twin, spec, feats, frac, labels, lab_len, mask)
    np.testing.assert_allclose(loss.item(), want.item(), rtol=2e-2)


def test_cli_run_stage_2_reads_every_utterance_natively_on_the_card(
        card, tmp_path):
    """Stages 0-2 of a cut flagship conf through ``cli.run`` on the card:
    stage 2 reads its train and dev utterances through the native ark
    reader, none through numpy, and trains from graphs."""
    from ctc_pytorch_tpu_torch.cli import run
    from ctc_pytorch_tpu_torch.data import dataset as dataset_mod

    want = chip_smoke.write_timit_corpus(tmp_path / "timit", 2, 1, 1, seed=3)
    cut = chip_smoke.RECIPE.read_text()
    for a, b in (("rnn_hidden_size: 384", "rnn_hidden_size: 32"),
                 ("rnn_layers: 4", "rnn_layers: 2"),
                 ("num_epoches: 500", "num_epoches: 1"),
                 ("checkpoint_dir: 'checkpoint/'",
                  f"checkpoint_dir: '{tmp_path / 'checkpoint'}'")):
        cut = cut.replace(a, b)
    (tmp_path / "cut.yaml").write_text(cut)
    argv = ["--timit", str(tmp_path / "timit"), "--data", str(tmp_path / "d"),
            "--conf", str(tmp_path / "cut.yaml")]
    run.main(argv + ["--stage", "0", "--stop-stage", "1"])
    dataset_mod.reset_reads()
    before = train_ops.launches_fwd
    run.main(argv + ["--stage", "2", "--stop-stage", "2"])
    assert dataset_mod.READS == {"native": want["train"] + want["dev"],
                                 "numpy": 0}
    assert train_ops.launches_fwd > before
    assert (tmp_path / "checkpoint" / "ctc_fbank_cnn"
            / "ctc_best_model.npz").exists()


@pytest.mark.parametrize("case", chip_smoke.WIDE_NAN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wide_forward_reads_only_published_h(card, case):
    """The wide branches (``csrc/fwd_wide.cuh``; the backward's serial chain,
    ``csrc/bwd_wide.cuh``, at its cases) launched again and again with
    their exchange buffer filled with NaN and their step flags with a large
    count before every launch (``chip_smoke.wide_nan_launches``), from gates
    at 0.05 and at unit scale: a read of a block of h (of a partial dh)
    before its writers published it would read NaN at the first step and a
    stale value after, and the kernels are deterministic, so no launch may
    hold a non-finite value or differ in any bit from the first; the first
    holds the twin (fp32 1e-4, bf16 streams 2e-2, as the other cases
    here)."""
    tol = 1e-4 if case[-1] == "fp32" else 2e-2
    for scale in chip_smoke.DECODE_SCALES:
        r = chip_smoke.wide_nan_launches(*case, scale, seed=5, n=40)
        assert (r["nonfinite_launches"], r["differing_launches"]) == (0, 0), r
        assert r["twin_max_abs_err"] <= tol, r


@pytest.mark.parametrize("cell,rnn_type", [("lstm", "nn.LSTM"),
                                           ("gru", "nn.GRU"),
                                           ("rnn", "nn.RNN")])
def test_remat_fit_and_step_equal_the_plain_ones_on_the_card(card, tmp_path,
                                                             monkeypatch, cell,
                                                             rnn_type):
    """``chip_smoke.py``'s phase 17 at a small size: a graphed fused epoch
    through ``cli.train.train`` and an eager step, with dropout 0.2, under
    ``remat: true`` against ``remat: false`` (``chip_smoke.hold_remat``):
    every tensor bit for bit, the training forward launched twice a layer
    a step under remat and once without, every other kernel as often; the
    graphs captured the recompute."""
    import dataclasses

    from ctc_pytorch_tpu_torch.vocab import Vocab

    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    cfg, _ = tiny_recipe(tmp_path / "data")
    cfg = dataclasses.replace(cfg, rnn_type=rnn_type, drop_out=0.2)
    fits = [chip_smoke.remat_fit(dataclasses.replace(
        cfg, remat=remat, exp_name=f"remat{int(remat)}"), "cuda")
        for remat in (False, True)]
    steps = fits[0]["steps"]
    assert steps > 0 and fits[1]["replays"] == fits[0]["replays"] > 0
    chip_smoke.hold_remat("tiny fit", cell, cfg.rnn_layers, *fits, steps,
                          "cuda")
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    args = chip_smoke.host_batch(cfg, Vocab(cfg.vocab_file), False, "cuda")
    runs = [chip_smoke.remat_step(cfg, dataclasses.replace(spec, remat=remat),
                                  args, None, "cuda", times=True)
            for remat in (False, True)]
    chip_smoke.hold_remat("tiny step", cell, cfg.rnn_layers, *runs, 1, "cuda")
    assert all(r["peak_bytes"] > 0 for r in runs)


def test_spans_hold_one_replay_a_step_and_no_capture_after_set_up(card,
                                                                  tmp_path):
    """The runners' spans (``spans.py``) on the card, under ``torch.
    profiler``: a first fused epoch and dev pass (set-up) capture every step
    shape, each in one ``ctc.graphs.capture`` range inside a step; a second
    epoch and pass (the window) capture nothing, and each of their batches
    is one ``ctc.runner.step`` range holding exactly one
    ``ctc.graphs.replay``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ctc_pytorch_tpu_torch.cli.train import build_loaders
    from ctc_pytorch_tpu_torch.train.loop import (
        Trainer,
        quiet,
        run_epoch_single,
    )
    from ctc_pytorch_tpu_torch.vocab import Vocab

    cfg, spec = tiny_recipe(tmp_path / "data")
    train, dev = build_loaders(cfg, Vocab(cfg.vocab_file), device="cuda")
    trainer = Trainer(cfg, spec, device="cuda", out_dir=str(tmp_path / "out"))
    batches = len(train) + len(dev)

    def epoch(e):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for loader, training in ((train, True), (dev, False)):
                loader.set_epoch(e)
                run_epoch_single(e, trainer.epoch_fns, trainer.state, loader,
                                 training=training, log=quiet)
            torch.cuda.synchronize()
        host, kernels = {}, []
        for ev in prof.events():
            tr = (ev.time_range.start, ev.time_range.end)
            if ev.device_type == DeviceType.CPU and ev.name.startswith("ctc."):
                host.setdefault(ev.name, []).append(tr)
            elif (ev.device_type == DeviceType.CUDA
                  and not ev.name.startswith("ctc.")
                  and not getattr(ev, "is_user_annotation", False)):
                kernels.append(tr)
        return host, kernels

    graphs = trainer.epoch_fns[0].graphs
    setup, _ = epoch(1)
    assert len(setup["ctc.graphs.capture"]) == len(graphs) >= 2
    assert len(setup["ctc.runner.step"]) == batches
    captured = graphs.capture_seconds
    window, kernels = epoch(2)
    assert "ctc.graphs.capture" not in window
    assert graphs.capture_seconds == captured
    steps, replays = window["ctc.runner.step"], window["ctc.graphs.replay"]
    assert len(steps) == len(replays) == batches
    for s, e in steps:
        assert sum(s <= a and b <= e for a, b in replays) == 1
    assert kernels and len(window["ctc.runner.fetch"]) == 2
    for a, b in setup["ctc.graphs.capture"]:
        assert any(s <= a and b <= e for s, e in setup["ctc.runner.step"])


# ---- the CNN's conv epilogue (ops/conv_epilogue.py) ----

def _epilogue_operands(b, c, t, f, dtype, seed):
    """A raw conv plane on the card, its fp32 (C,) operands, a frame count
    below T and one repeat-padded row."""
    gen = torch.Generator().manual_seed(seed)
    conv = (torch.randn(b, c, t, f, generator=gen) * 2).to(dtype)
    vec = [torch.rand(c, generator=gen) * 0.6 - 0.3 for _ in range(3)]
    k = torch.rand(c, generator=gen) + 0.5
    dy = torch.randn(b, c, t, f, generator=gen).to(dtype)
    ds = [torch.randn(c, generator=gen) * 1e-3 for _ in range(2)]
    rows = torch.ones(b, dtype=torch.bool)
    rows[b // 2] = False
    tv = torch.tensor(t - 3, dtype=torch.int32)
    return conv, vec[0], vec[1], k, vec[2], dy, ds, tv, rows


@pytest.mark.parametrize("act", ["relu", "hardtanh"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,t,f", [(6, 5, 37, 13), (3, 2, 9, 5000),
                                     (2, 3, 1, 3)])
def test_conv_epilogue_kernels_match_their_cpu_arithmetic(card, b, c, t, f,
                                                          dtype, act):
    """Each launch against the same arithmetic in torch ops on the CPU:
    the elementwise outputs bit for bit, the per-channel sums within their
    order's rounding.  Odd F and T*F put 16-byte vectors across rows,
    slices and runs; F = 5000 gives one row a block."""
    from ctc_pytorch_tpu_torch.ops import conv_epilogue as ce

    ops = _epilogue_operands(b, c, t, f, dtype, seed=b * t + f)
    conv, bias, mean, k, beta, dy, (ds1, ds2), tv, rows = ops
    cuda = [x.to(card) for x in (conv, bias, mean, k, beta, dy, ds1, ds2, tv,
                                 rows)]
    cconv, cbias, cmean, ck, cbeta, cdy, cds1, cds2, ctv, crows = cuda
    got = {
        "stats": ce.stats(cconv, cbias, ctv, crows),
        "y": ce.apply(cconv, cbias, cmean, ck, cbeta, ctv, act),
        "sums": ce.grad_sums(cconv, cdy, cbias, cmean, ck, cbeta, ctv, act),
        "train": ce.grad_apply(cconv, cdy, cbias, cmean, ck, cbeta, cds1,
                               cds2, ctv, crows, act),
        "eval": ce.grad_apply(cconv, cdy, cbias, cmean, ck, cbeta, None, None,
                              None, None, act),
    }
    torch.cuda.synchronize()
    want = {
        "stats": ce._stats_cpu(conv, bias, tv, rows),
        "y": ce._apply_cpu(conv, bias, mean, k, beta, tv, act),
        "sums": ce._grad_sums_cpu(conv, dy, bias, mean, k, beta, tv, act),
        "train": ce._grad_apply_cpu(conv, dy, bias, mean, k, beta, ds1, ds2,
                                    tv, rows, act),
        "eval": ce._grad_apply_cpu(conv, dy, bias, mean, k, beta, None, None,
                                   None, None, act),
    }
    assert torch.equal(got["y"].cpu(), want["y"])
    for part in ("train", "eval"):
        assert torch.equal(got[part][0].cpu(), want[part][0])
        # the bias's gradient: a sum of the plane, rounded to its dtype
        err = (got[part][1].cpu() - want[part][1]).abs().max().item()
        scale = want[part][0].float().abs().sum((0, 2, 3)).max().item()
        assert err <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * scale
    assert got["stats"][2].item() == want["stats"][2].item()
    for part, n in (("stats", 2), ("sums", 3)):
        for g, w in zip(got[part][:n], want[part][:n]):
            err = (g.cpu() - w).abs().max().item()
            assert err <= 1e-5 * max(1.0, w.abs().max().item()), part


@pytest.mark.parametrize("act", ["relu", "hardtanh"])
def test_conv_epilogue_activation_ties_follow_autograd(card, act):
    """Normalised values at exactly 0 and 20 (and -0, and around them):
    the output and the gate of relu (passes where its output is > 0) and
    clamp(0, 20) (passes where 0 <= z <= 20) as autograd takes them."""
    from ctc_pytorch_tpu_torch.ops import conv_epilogue as ce

    vals = torch.tensor([0.0, -0.0, 20.0, 1.0, -1.0, 19.875, 20.125, 0.5])
    conv = vals.repeat(2, 1, 3, 4).view(2, 1, 3, 32).to(torch.bfloat16)
    one, zero = torch.ones(1), torch.zeros(1)
    dy = torch.linspace(1.0, 2.0, conv.numel()).view_as(conv).to(
        torch.bfloat16)
    args = [x.to(card) for x in (conv, zero, zero, one, zero)]
    y = ce.apply(*args, None, act)
    dconv, _ = ce.grad_apply(args[0], dy.to(card), *args[1:], None, None, None,
                             None, act)
    x = conv.float().requires_grad_(True)
    want = ce.ACTIVATIONS[act](x.to(torch.bfloat16))
    want.backward(dy)
    assert torch.equal(y.cpu().float(), want.float())
    assert torch.equal(dconv.cpu().float(), x.grad)


# the cells' padded shapes (B, T) at the flagship's first conv input
# (F = 243, CNN 1 -> 32 -> 32) and the 863 recipe's one layer (B = 16, F =
# 201, 1 -> 16, (11, 5), stride 2, clamp(0, 20))
EPILOGUE_CASES = [("flagship", 8, 200, torch.bfloat16),
                  ("flagship", 8, 392, torch.bfloat16),
                  ("flagship", 128, 288, torch.bfloat16),
                  ("flagship", 128, 392, torch.bfloat16),
                  ("flagship", 8, 200, torch.float32),
                  ("863", 16, 400, torch.bfloat16)]


def _epilogue_stack(recipe, card):
    from ctc_pytorch_tpu_torch.models.cnn import CNNStack

    if recipe == "863":
        cfg = CNNConfig(add_cnn=True, layers=1, channel=[(1, 16)],
                        kernel_size=[(11, 5)], stride=[(2, 2)],
                        padding=[(0, 0)], activation_function="hardtanh")
        f = 201
    else:
        cfg = CNNConfig(add_cnn=True, layers=2, channel=[(1, 32), (32, 32)],
                        kernel_size=[(3, 3), (3, 3)], stride=[(1, 2), (2, 2)],
                        padding=[(1, 1), (1, 1)])
        f = 243
    gen = torch.Generator().manual_seed(11)
    stack = CNNStack(cfg)
    for layer in stack:
        layer.reset_parameters(gen)
        with torch.no_grad():
            layer.bn.scale.uniform_(0.5, 1.5, generator=gen)
            layer.bn.bias.uniform_(-0.3, 0.3, generator=gen)
            layer.bn.mean.uniform_(-0.2, 0.2, generator=gen)
            layer.bn.var.uniform_(0.5, 2.0, generator=gen)
    return stack.to(card), f


def _epilogue_step(stack, x, dtype, tv, em, w, train):
    """The stack's output, every leaf's gradient and the buffers after one
    call and a backward of ``sum(y * w)``."""
    stack.train(train)
    stack.zero_grad(set_to_none=True)
    y = stack(x, dtype, t_valid=tv, example_mask=em)
    (y.float() * w).sum().backward()
    grads = {n: p.grad.float().clone() for n, p in stack.named_parameters()}
    bufs = {n: v.clone() for n, v in stack.named_buffers()}
    return y.float(), grads, bufs


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("recipe,b,t,dtype", EPILOGUE_CASES)
def test_conv_epilogue_matches_the_plain_twin_on_the_card(
        card, monkeypatch, recipe, b, t, dtype, train):
    """The fused route against the plain twin, both on the card, at the
    cells' shapes: outputs within a few roundings of the plane's dtype (the
    statistics' sums run in another order, which moves a value across a
    rounding edge now and then, and the second layer carries that on),
    every leaf's gradient within 1e-2 of its largest entry in bf16 (1e-4
    in fp32; the conv biases under BN, rounding alone, against their
    layer's weight gradient), the running buffers within 1e-5."""
    from ctc_pytorch_tpu_torch.ops import conv_epilogue as ce

    stack, f = _epilogue_stack(recipe, card)
    gen = torch.Generator().manual_seed(b * t)
    x = torch.randn(b, 1, t, f, generator=gen).to(card)
    if recipe == "863":
        x = x * 8  # some values past the clamp's 20
    em = torch.ones(b, device=card)
    em[-1] = 0.0  # a repeat-padded row
    tv = torch.tensor(t - 7, dtype=torch.int32, device=card)
    with torch.no_grad():
        t_out = stack.eval()(x, dtype, t_valid=tv).shape
    start = {n: v.clone() for n, v in stack.state_dict().items()}
    w = torch.randn(t_out, generator=gen).to(card)
    before = dict(ce.launches_route)
    got = _epilogue_step(stack, x, dtype, tv, em, w, train)
    torch.cuda.synchronize()
    layers = len(stack)
    assert ce.launches_route == dict(
        before, fused_fwd=before["fused_fwd"] + layers,
        fused_bwd=before["fused_bwd"] + layers)
    stack.load_state_dict(start)
    monkeypatch.setattr(ce, "fused_route", lambda *a, **k: False)
    want = _epilogue_step(stack, x, dtype, tv, em, w, train)
    bf16 = dtype == torch.bfloat16
    err = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1.0)).max()
    print(f"{recipe} B={b} T={t} {dtype} train={train}: output "
          f"{err.item():.3g}", end="")
    assert err.item() <= (2.0 ** -5 if bf16 else 1e-5)
    tol = 1e-2 if bf16 else 1e-4
    for name, value in want[1].items():
        ref = want[1][name[:-1] + "w"] if name.endswith(".b") else value
        e = ((got[1][name] - value).abs().max() / ref.abs().max()).item()
        print(f", {name} {e:.3g}", end="")
        assert e <= tol, name
    print()
    for name, value in want[2].items():
        e = (got[2][name] - value).abs().max().item()
        assert e <= 1e-5 * max(1.0, value.abs().max().item()), name


@pytest.mark.parametrize("train", [True, False])
def test_conv_epilogue_replays_in_a_captured_graph(card, train):
    """The flagship's CNN at B=8, T=200 forward and backward (train) or
    forward (eval), captured through ``train/graphs.py`` and replayed: the
    replay equals the eager call bit for bit (no float atomics), and the
    route counter adds a replay's layer calls."""
    stack, f = _epilogue_stack("flagship", card)
    stack.train(train)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 1, 200, f, generator=gen).to(card)
    em = torch.ones(8, device=card)
    em[5] = 0.0
    tv = torch.tensor(190, dtype=torch.int32, device=card)
    params = list(stack.parameters())

    def call():
        if not train:
            with torch.no_grad():
                return (stack(x, torch.bfloat16, t_valid=tv),)
        y = stack(x, torch.bfloat16, t_valid=tv, example_mask=em)
        grads = torch.autograd.grad(y.float().square().sum(), params)
        return (y.detach(), *grads)  # no autograd graph outlives the call

    err, eager, left, replay = chip_smoke.captured_vs_eager(call)
    route = ({"fused_fwd": 2, "fused_bwd": 2} if train else {"fused_fwd": 2})
    assert eager == {("conv_epilogue", "launches_route"): route}
    assert err == 0.0 and not left and replay == eager


DS2_CHECK_T = 200  # input frames of the card's DeepSpeech2 check: T' = 100


def _ds2_case(card, seed: int):
    """DeepSpeech2 at its published widths (``gpubench/configs/
    ds2_librispeech.json``: 161 bins, CNN 1-32-32, 5 x BiLSTM(1024) with
    biases, packed, summed; 29 classes; bf16) and a B=64 batch of unequal
    lengths cut to ``DS2_CHECK_T`` frames, with the reference's weights."""
    import json

    from ctc_pytorch_tpu_torch.config import Config
    from gpubench.reference import ds2
    from gpubench.weights import make_weights

    conf = json.loads((ROOT / "gpubench/configs/ds2_librispeech.json"
                       ).read_text())["config"]
    arch = ds2.Arch.from_config(conf)
    cfg = Config.from_dict(conf)
    spec = ModelSpec.from_config(cfg, num_class=arch.n_class)
    w = make_weights(arch, seed, card)
    gen = torch.Generator().manual_seed(seed)
    b, t_in = 64, DS2_CHECK_T
    frames = torch.linspace(t_in // 2, t_in, b).round().long() // 2 * 2
    feats = torch.randn(b, t_in, arch.in_dim, generator=gen)
    feats *= (torch.arange(t_in)[None, :, None] < frames[:, None, None])
    lab_len = (0.14 * frames).round().long()
    labels = torch.randint(2, arch.n_class, (b, int(lab_len.max())),
                           generator=gen)
    mask = torch.ones(b)
    mask[0] = 0.0  # a repeat-padded row (the shortest: T' stays T / 2)
    batch = tuple(x.to(card) for x in (feats, frames / t_in, labels, lab_len,
                                       mask))
    return arch, cfg, spec, w, batch


def test_ds2_train_step_at_the_published_widths_matches_the_reference(card):
    """One bf16 train step of DeepSpeech2 through ``train_step`` against
    the float32 reference's step from the same weights on the same rows:
    the loss, the first gradient as Adam takes it (``grad_error``, all
    leaves; the worst leaf's norm gap) and the weights' change.  The
    recurrence's training forward at H=1024, B=64 takes the wide branch's
    bf16 form and its serial backward the grid; the counters see 5 packed,
    summed layer calls and T' serial steps a layer each way."""
    from ctc_pytorch_tpu_torch.ops import launch_counts
    from ctc_pytorch_tpu_torch.train.loop import train_step
    from ctc_pytorch_tpu_torch.train.state import create_train_state
    from gpubench import judge
    from gpubench.reference import ds2

    arch, cfg, spec, w, batch = _ds2_case(card, 2500000001)
    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, device=card)
    state.model.load_state_dict(w)
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [(names[id(p)], p)
              for p in state.optimizer.param_groups[0]["params"]]
    before = launch_counts.read()
    loss, _, sizes = train_step(state, spec, *batch)
    torch.cuda.synchronize()
    moved = launch_counts.diff(launch_counts.read(), before)
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    grads = {n: (state.optimizer.state[p]["exp_avg"] / (1 - beta1)).cpu()
             for n, p in params}
    steps = {n: float((p.detach() - w[n]).double().norm()) for n, p in params}
    ref = ds2.train_steps(w, arch, [batch])
    norm = {n: float(g.double().norm()) for n, g in ref["first_grad"].items()}
    numbers = judge.train_numbers(
        {"losses": [float(loss)], "grads": grads, "step_norms": steps,
         "grad_norms": {n: float(g.double().norm()) for n, g in grads.items()}},
        {"losses": ref["losses"],
         "grads": {n: g.cpu() for n, g in ref["first_grad"].items()},
         "grad_norms": norm,
         "raw_grad_norms": {n: float(g.double().norm())
                            for n, g in ref["raw_grad"].items()},
         "step_norms": {n: float((p - w[n]).double().norm())
                        for n, p in ref["params"].items()}})
    t_out = DS2_CHECK_T // 2
    print(f"DS2 one step at T={DS2_CHECK_T}, B=64, H=1024: {numbers}; "
          f"branches fwd {moved.get(('lstm_bidir_train', 'launches_fwd_branch'))}"
          f" bwd {moved.get(('lstm_bidir_train', 'launches_bwd_branch'))}")
    assert numbers["loss_gap"] < 0.01
    assert numbers["grad_error"] < 0.1
    assert numbers["grad_norm_gap"] < 0.05
    assert numbers["step_norm_gap"] < 0.1
    assert moved[("lstm_bidir_train", "launches_fwd_branch")] == {
        "wide_bf16": 5}
    assert moved[("lstm_bidir_train", "launches_bwd_branch")] == {"grid": 5}
    assert moved[("lstm_bidir_train", "launches_steps")] == {
        "fwd": 5 * t_out, "bwd": 5 * t_out}
    assert moved[("rnn_io", "launches_mask")] == {"gate": 5}
    assert moved[("rnn_io", "launches_merge")] == {"sum": 5}
    assert int(sizes.max()) == t_out


def test_ds2_packed_rows_ignore_their_padding_on_the_card(card):
    """The published model's train-mode log-probs of a B=64 batch padded to
    T and to 2T agree on every row's frames: the biased cells never see the
    extra padding (bf16: within a rounding step of the logits)."""
    _, cfg, spec, w, (feats, frac, labels, lab_len, mask) = _ds2_case(
        card, 2500000002)
    model = CTCModel(spec).to(card)
    model.load_state_dict(w)
    with torch.no_grad():
        short = model(feats, frac=frac, example_mask=mask, train=True)
        model.load_state_dict(w)
        long = model(torch.cat([feats, torch.zeros_like(feats)], dim=1),
                     frac=frac / 2, example_mask=mask, train=True)
    t_out = short.shape[0]
    err = float((short - long[:t_out]).abs().max())
    print(f"DS2 padded to T and 2T: largest log-prob gap {err:.3g}")
    assert err < 0.05


def test_ds2_eval_forward_at_the_published_widths_matches_the_reference(card):
    """DeepSpeech2's eval forward, the greedy decode's (the eval op
    ``lstm_bidir_cuda`` at H=1024, B=64 with bf16 streams, the input gate
    shut on padded frames, the directions summed in fp32), with running
    statistics from the reference's train-mode pass over the batch: against
    ``reference/ds2.forward(train=False)`` on every valid frame (log-probs
    less their mean over the classes, the norm of the difference over the
    reference's) and against itself padded to 2T; the eval op launched once
    a layer, on the grid, T' serial steps each."""
    from ctc_pytorch_tpu_torch.ops import launch_counts
    from gpubench.reference import ds2

    arch, _, spec, w, (feats, frac, _, _, mask) = _ds2_case(card, 2500000003)
    stats: dict = {}
    with torch.no_grad():
        ds2.forward(w, arch, feats, frac, mask, True, stats=stats)
        for prefix, (mean, var) in stats.items():
            w[f"{prefix}.mean"].copy_(mean)
            w[f"{prefix}.var"].copy_(var)
        want, sizes = ds2.forward(w, arch, feats, frac, mask, False)
    model = CTCModel(spec).to(card)
    model.load_state_dict(w)
    before = launch_counts.read()
    with torch.no_grad():
        got = model(feats, frac=frac, example_mask=mask, train=False)
        torch.cuda.synchronize()
        moved = launch_counts.diff(launch_counts.read(), before)
        long = model(torch.cat([feats, torch.zeros_like(feats)], dim=1),
                     frac=frac / 2, example_mask=mask, train=False)
    t_out = DS2_CHECK_T // 2
    assert got.shape[0] == want.shape[0] == t_out
    valid = ((torch.arange(t_out, device=card)[:, None] < sizes)
             & (mask > 0))[..., None]

    def centred(lp):
        return (lp.double() - lp.double().mean(-1, keepdim=True)) * valid

    err = float((centred(got) - centred(want)).norm() / centred(want).norm())
    pad = float(((got - long[:t_out]) * valid).abs().max())
    print(f"DS2 eval at T={DS2_CHECK_T}, B=64, H=1024 against the reference: "
          f"{err:.3g}; padded to 2T: {pad:.3g}; branches "
          f"{moved.get(('lstm_bidir', 'launches_fwd_branch'))}")
    assert err < 0.1
    assert pad < 0.05
    assert moved[("lstm_bidir", "launches_fwd_branch")] == {"grid": 5}
    assert moved[("lstm_bidir", "launches_steps")] == {"fwd": 5 * t_out}
    assert moved[("rnn_io", "launches_mask")] == {"gate": 5}
    assert moved[("rnn_io", "launches_merge")] == {"sum": 5}
