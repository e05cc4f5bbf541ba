"""The benchmark's work arithmetic against numbers worked by hand."""

import json
from pathlib import Path

import pytest

from gpubench import peaks, work
from gpubench.reference.model import Arch

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def arch(name: str) -> Arch:
    return Arch.from_config(json.loads((CONFIGS / f"{name}.json").read_text())
                            ["config"])


def test_flagship_forward_flops_at_200_frames():
    # conv 1 (3x3, stride (1, 2), pad 1): 200 x 122 outputs of 32 channels
    conv1 = 2 * 9 * 1 * 32 * 200 * 122
    # conv 2 (3x3, stride (2, 2), pad 1): 100 x 61 outputs, 32 in channels
    conv2 = 2 * 9 * 32 * 32 * 100 * 61
    rec = 2 * 2 * 100 * 384 * 1536  # both directions' h @ w_hh, 100 steps
    layer0 = 2 * 100 * (61 * 32) * (2 * 1536) + rec
    layers = 3 * (2 * 100 * 768 * (2 * 1536) + rec)
    fc = 2 * 100 * 768 * 39
    want = conv1 + conv2 + layer0 + layers + fc
    assert want == 3_691_084_800  # ~3.7 GFLOP an utterance
    assert work.utterance_flops(arch("timit_lstm"), 200, False) == want
    assert work.utterance_flops(arch("timit_lstm"), 200, True) == 3 * want


# the 863 recipe's model (recipes/my_863/cnn_lstm_ctc.conf) with nn.GRU
GRU863 = {"rnn_input_size": 201, "add_cnn": True, "channel": "[(1, 16)]",
          "kernel_size": "[(11, 5)]", "stride": "[(2, 2)]",
          "padding": "[(0, 0)]", "pooling": "None", "rnn_type": "nn.GRU",
          "rnn_hidden_size": 256, "rnn_layers": 4, "num_class": 66,
          "activation_function": "hardtanh"}


def test_gru863_forward_flops_at_200_frames():
    conv = 2 * (11 * 5) * 1 * 16 * 95 * 99  # (11, 5), stride 2, no padding
    rec = 2 * 2 * 95 * 256 * 768
    layer0 = 2 * 95 * (99 * 16) * (2 * 768) + rec
    layers = 3 * (2 * 95 * 512 * (2 * 768) + rec)
    fc = 2 * 95 * 512 * 67
    assert conv + layer0 + layers + fc == 1_232_455_520
    assert work.utterance_flops(Arch.from_config(GRU863), 200,
                                False) == 1_232_455_520


def test_recurrence_call_work():
    a = arch("timit_lstm")
    flops, nbytes = work.recurrence_call(a, 100, 8, "float32", False)
    assert flops == 2 * 2 * 100 * 8 * 384 * 1536
    # gx (4H a direction) read and ys (H) written, fp32, and w_hh
    assert nbytes == 4 * 100 * 8 * 2 * (1536 + 384) + 4 * 2 * 384 * 1536
    _, bwd = work.recurrence_call(a, 100, 8, "bfloat16", True)
    # dy, ys, gx read and dgx written in bf16, and w_hh
    assert bwd == 2 * 100 * 8 * 2 * (2 * 384 + 2 * 1536) + 2 * 2 * 384 * 1536


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(495e9, 1.0, "float32") == pytest.approx(1e-3)
    assert work.least_seconds(1.0, 3.35e9, "bfloat16") == pytest.approx(1e-3)
    assert peaks.product_peak("bfloat16") == 989e12
    assert peaks.product_peak("float32") == 495e12


def test_recurrence_least_seconds_sums_the_groups():
    a = arch("timit_lstm")
    one = sum(work.least_seconds(*work.recurrence_call(a, 100, 8, "float32",
                                                       bwd), "float32")
              for bwd in (False, True))
    # 4 layers a step: a group of 3 batches at 200 input frames (T' = 100)
    got = work.recurrence_least_seconds(a, "bfloat16", [(200, 8, 3)], 12, 12)
    assert got == pytest.approx(3 * 4 * one)
    with pytest.raises(ValueError):
        work.recurrence_least_seconds(a, "bfloat16", [(200, 8, 3)], 13, 12)


def test_stream_dtype_rule():
    assert work.stream_dtype("bfloat16", 16) == "bfloat16"
    assert work.stream_dtype("bfloat16", 8) == "float32"
    assert work.stream_dtype("float32", 128) == "float32"

