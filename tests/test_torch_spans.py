"""The runners' spans (``ctc_pytorch_tpu_torch/spans.py``) on the CPU.

In the Chrome trace of ``profile: True`` (``metrics_log.profile_ctx``), a
fused training epoch (``run_epoch_single``) and a fused decode of a tiny
model give one ``ctc.loader.plan`` and one ``ctc.runner.upload`` range a
group, one ``ctc.runner.step`` a batch and one ``ctc.runner.fetch`` an
epoch, and no plan range holds a runner's.  Without a profiler a span is
one shared null context.  Losses and tokens are the same bits with and
without a profiler.  On the card, the replays and captures inside the
steps: ``tests/test_torch_cuda.py``."""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler
from torch.profiler import ProfilerActivity, profile

from ctc_pytorch_tpu_torch import spans
from ctc_pytorch_tpu_torch.cli.train import build_loaders
from ctc_pytorch_tpu_torch.decode.fused import make_fused_decode_fn
from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec
from ctc_pytorch_tpu_torch.train.loop import Trainer, quiet, run_epoch_single
from ctc_pytorch_tpu_torch.train.metrics_log import profile_ctx
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_cuda import tiny_recipe


def ranges(out_dir) -> list:
    """``(name, start, end)`` of the ``ctc.*`` ranges of the one Chrome
    trace in ``out_dir``, in order."""
    (path,) = out_dir.glob("*.pt.trace.json")
    return sorted((ev["name"], ev["ts"], ev["ts"] + ev["dur"])
                  for ev in json.loads(path.read_text())["traceEvents"]
                  if ev.get("ph") == "X"
                  and ev.get("name", "").startswith(spans.PREFIX))


def run(root, traced: bool, state_dict=None) -> dict:
    """One fused training epoch and one fused decode of the dev set of the
    tiny recipe with one layer at two buckets (two groups each), from
    ``state_dict`` if given; each in a trace of its own when ``traced``."""
    cfg, _ = tiny_recipe(root / "data", (("train", 16), ("dev", 8)))
    cfg.num_buckets, cfg.rnn_layers = 2, 1
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    train, dev = build_loaders(cfg, Vocab(cfg.vocab_file), device="cpu")
    trainer = Trainer(cfg, spec, device="cpu")
    if state_dict is not None:
        trainer.state.model.load_state_dict(state_dict)
    init = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}

    record: dict = {}
    train.set_epoch(1)
    with profile_ctx(traced, root / "train"):
        run_epoch_single(1, trainer.epoch_fns, trainer.state, train,
                         training=True, log=quiet, record=record)
    model = trainer.state.model.eval()
    fused = make_fused_decode_fn(spec, model)
    with profile_ctx(traced, root / "decode"):
        out = [tuple(x.numpy() for x in fused(arrs, pos, t_pad))
               for arrs, pos, _, t_pad in dev.epoch_groups(0)]
    return {"init": init, "losses": record["losses"], "tokens": out,
            "params": {k: v.clone() for k, v in model.state_dict().items()},
            "train": train, "dev": dev,
            "ranges": ((ranges(root / "train"), ranges(root / "decode"))
                       if traced else None)}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    return run(tmp_path_factory.mktemp("spans"), True)


def counts(rs) -> dict:
    out: dict = {}
    for name, _, _ in rs:
        out[name] = out.get(name, 0) + 1
    return out


def test_one_range_a_group_a_batch_and_a_fetch(traced):
    train_groups = list(traced["train"].epoch_groups(1))
    dev_groups = list(traced["dev"].epoch_groups(0))
    assert len(train_groups) == len(dev_groups) == 2
    train_ranges, decode_ranges = traced["ranges"]
    assert counts(train_ranges) == {
        "ctc.loader.plan": 2, "ctc.runner.upload": 2,
        "ctc.runner.step": sum(len(g[1]) for g in train_groups),
        "ctc.runner.fetch": 1}
    assert len(traced["losses"]) == sum(len(g[1]) for g in train_groups)
    assert counts(decode_ranges) == {
        "ctc.loader.plan": 2, "ctc.runner.upload": 2,
        "ctc.runner.step": sum(len(g[1]) for g in dev_groups)}


def test_no_plan_range_holds_a_runner_range(traced):
    for rs in traced["ranges"]:
        plans = [(s, e) for n, s, e in rs if n == "ctc.loader.plan"]
        runners = [(s, e) for n, s, e in rs if n.startswith("ctc.runner.")]
        assert plans and runners
        for ps, pe in plans:
            assert not any(ps <= s and e <= pe for s, e in runners)
        # every step lies after its group's upload, outside the plans
        for s, e in runners:
            assert not any(ps < s < pe for ps, pe in plans)


def test_a_span_is_one_shared_null_context_without_a_profiler(monkeypatch):
    assert not profiler._is_profiler_enabled

    def refuse(*_):
        raise AssertionError("record_function made without a profiler")

    monkeypatch.setattr(profiler, "record_function", refuse)
    made = [spans.span("runner.step", (96, 4, 2)), spans.span("loader.plan")]
    assert made[0] is made[1]
    assert isinstance(made[0], contextlib.nullcontext)
    with made[0]:
        pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("runner.step", (96, 4, 2)) as rf:
            assert isinstance(rf, profiler.record_function)
            assert rf.name == "ctc.runner.step" and rf.args == "(96, 4, 2)"
    assert [ev.name for ev in prof.events()
            if ev.name.startswith(spans.PREFIX)] == ["ctc.runner.step"]


def test_a_profiler_changes_no_loss_and_no_token(traced, tmp_path):
    plain = run(tmp_path, False, state_dict=traced["init"])
    assert plain["losses"] == traced["losses"]
    assert len(plain["tokens"]) == len(traced["tokens"]) == 2
    for (tok, ln), (ttok, tln) in zip(plain["tokens"], traced["tokens"]):
        np.testing.assert_array_equal(tok, ttok)
        np.testing.assert_array_equal(ln, tln)
    for k, v in plain["params"].items():
        assert torch.equal(v, traced["params"][k]), k
