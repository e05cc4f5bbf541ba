"""The port on the card: the Hopper BiLSTM kernel against its plain twin, and
the eval model on CUDA against the same model on the CPU.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  The file
imports neither JAX nor the JAX package, so on the GPU host it runs without
the JAX-only ``tests/conftest.py``:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu_torch.config import CNNConfig
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.models.layers import matmul_f32
from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops

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
