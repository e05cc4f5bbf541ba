"""DeepSpeech2 on the port's CPU path (``rnn_merge: sum``, ``rnn_bias``,
packed sequences), held against the plain reference
``gpubench/reference/ds2.py`` at a small width with the published conv
kernels; packing against padding; the recipes' models and manifests as the
JAX package's; the route counters."""

import json
from pathlib import Path

import pytest
import torch

from ctc_pytorch_tpu_torch.config import Config, load_config
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.models.rnn import RNNLayer
from ctc_pytorch_tpu_torch.ops import launch_counts
from ctc_pytorch_tpu_torch.train import checkpoint as ckpt
from ctc_pytorch_tpu_torch.train.loop import forward_loss, train_step
from ctc_pytorch_tpu_torch.train.state import create_train_state
from gpubench.reference import ds2
from gpubench.reference.model import ctc_mean_loss
from gpubench.weights import make_weights

ROOT = Path(__file__).resolve().parent.parent
BENCH_CONFIG = json.loads(
    (ROOT / "gpubench/configs/ds2_librispeech.json").read_text())["config"]
# the published model at a width the CPU holds: 2 layers of 8 units, 41
# frequency bins, 4 channels; the DS2 kernels, strides and paddings
SMALL = {**BENCH_CONFIG, "feature_dim": 41, "rnn_input_size": 41,
         "rnn_hidden_size": 8, "rnn_layers": 2, "channel": "[(1, 4), (4, 4)]",
         "dtype": "float32", "grad_clip": 0.5, "weight_decay": 0.01}
LENGTHS = [40, 26, 34, 40]  # input frames; the last row repeat-padded


def small(conf=SMALL, seed=5):
    arch = ds2.Arch.from_config(conf)
    w = make_weights(arch, seed, "cpu")
    cfg = Config.from_dict(conf)
    spec = ModelSpec.from_config(cfg, num_class=arch.n_class)
    return arch, w, cfg, spec


def batch(arch, t_pad=40, seed=1):
    gen = torch.Generator().manual_seed(seed)
    frames = torch.tensor(LENGTHS)
    feats = torch.randn(len(LENGTHS), t_pad, arch.in_dim, generator=gen)
    feats *= (torch.arange(t_pad)[None, :, None] < frames[:, None, None])
    frac = frames.to(torch.float32) / t_pad
    labels = torch.randint(2, arch.n_class, (len(LENGTHS), 6), generator=gen)
    lab_len = torch.tensor([6, 4, 5, 6])
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    return feats, frac, labels, lab_len, mask


def port_grads(spec, cfg, w, feats, frac, labels, lab_len, mask):
    """The port's train-mode log-probs, loss and raw gradient by leaf."""
    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, device="cpu")
    state.model.load_state_dict(w)
    loss, lp, _ = forward_loss(state, spec, feats, frac, labels, lab_len,
                               mask, True, None)
    loss.backward()
    return lp, loss, {n: p.grad for n, p in state.model.named_parameters()}


def assert_leaves_close(got: dict, want: dict, rel: float) -> None:
    """Each leaf within ``rel`` of its largest entry or of a tenth of the
    largest leaf's, whichever is larger: a conv bias under BN has a
    gradient of rounding alone."""
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        scale = max(float(g.abs().max()), 0.1 * top)
        assert float((got[n] - g).abs().max()) <= rel * scale, n


def test_the_reference_arch_has_the_ports_leaves():
    arch, w, _, spec = small()
    model = CTCModel(spec)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in w.items()}
    assert model.state_dict()["rnns.1.fwd.w_ih"].shape == (8, 32)
    assert arch.rnn_out == 8 and spec.rnn_out == 8


def test_log_probs_loss_and_every_gradient_match_the_reference():
    arch, w, cfg, spec = small()
    feats, frac, labels, lab_len, mask = batch(arch)
    lp, loss, grads = port_grads(spec, cfg, w, feats, frac, labels, lab_len,
                                 mask)
    params = {n: w[n].clone().requires_grad_(True)
              for n in arch.param_names()}
    ref_lp, sizes = ds2.forward({**w, **params}, arch, feats, frac, mask, True)
    ref_loss = ctc_mean_loss(ref_lp, sizes, labels, lab_len, mask)
    ref_grads = dict(zip(params, torch.autograd.grad(ref_loss,
                                                     list(params.values()))))
    rows = mask > 0
    for t, n in enumerate(sizes.tolist()):
        torch.testing.assert_close(lp[:n, t], ref_lp[:n, t], atol=2e-5,
                                   rtol=1e-5) if rows[t] else None
    torch.testing.assert_close(loss, ref_loss, atol=1e-5, rtol=1e-5)
    assert_leaves_close(grads, ref_grads, 2e-4)
    # the biases take gradient, the padded frames none
    assert float(grads["rnns.0.bwd.b"].abs().max()) > 0


def test_three_steps_match_the_reference():
    arch, w, cfg, spec = small(seed=9)
    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, device="cpu")
    state.model.load_state_dict(w)
    batches = [batch(arch, seed=s) for s in (1, 2, 3)]
    losses = [float(train_step(state, spec, *b)[0]) for b in batches]
    ref = ds2.train_steps(w, arch, batches)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    got = state.model.state_dict()
    for n, p in ref["params"].items():
        moved = float((p - w[n]).norm())
        assert float((got[n] - p).norm()) <= 1e-3 * max(moved, 1e-8), n


def test_padding_to_twice_the_length_changes_nothing():
    """The whole batch padded to T and to 2T: the same log-probs on every
    row's frames and the same gradients (batchmax: the CNN's edge and the
    BN statistics follow the batch's longest utterance; the recurrence is
    packed, so the biased cells never see the extra padding)."""
    arch, w, cfg, spec = small()
    feats, frac, labels, lab_len, mask = batch(arch)
    long = torch.cat([feats, torch.zeros_like(feats)], dim=1)
    a = port_grads(spec, cfg, w, feats, frac, labels, lab_len, mask)
    b = port_grads(spec, cfg, w, long, frac / 2, labels, lab_len, mask)
    t_out = a[0].shape[0]
    torch.testing.assert_close(a[0], b[0][:t_out], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(a[1], b[1], atol=1e-6, rtol=1e-6)
    assert_leaves_close(b[2], a[2], 2e-5)


@pytest.mark.parametrize("train", [False, True])
def test_a_packed_layer_gives_each_utterance_what_it_gives_alone(train):
    """One biased layer: each utterance's outputs, and in train mode its
    input's and the weights' gradients, in a batch padded to 12 frames
    are those of the utterance alone at its own length."""
    torch.manual_seed(0)
    layer = RNNLayer(6, 5, False, "lstm", True, "sum", True)
    with torch.no_grad():
        for p in layer.parameters():
            p.uniform_(-0.5, 0.5)
    layer.train(train)
    lengths = torch.tensor([12, 7, 3])
    x = torch.randn(12, 3, 6, requires_grad=True)
    out = layer(x, torch.float32, lengths=lengths)
    assert out.shape == (12, 3, 5)
    grads = torch.autograd.grad((out ** 2).sum(), [x, layer.fwd.b]) if train \
        else None
    for r, n in enumerate(lengths.tolist()):
        xr = x[:n, r:r + 1].detach().clone().requires_grad_(True)
        alone = layer(xr, torch.float32, lengths=torch.tensor([n]))
        torch.testing.assert_close(out[:n, r:r + 1], alone, atol=1e-6,
                                   rtol=1e-6)
        assert torch.all(out[n:, r] == 0)
        if train:
            gx = torch.autograd.grad((alone ** 2).sum(), xr)[0]
            torch.testing.assert_close(grads[0][:n, r:r + 1], gx, atol=1e-6,
                                       rtol=1e-6)
            assert torch.all(grads[0][n:, r] == 0)


def _recipes():
    return sorted((ROOT / "recipes").glob("timit/*.yaml")) + sorted(
        (ROOT / "recipes").glob("my_863/*.conf"))


@pytest.mark.parametrize("path", _recipes(), ids=lambda p: p.name)
def test_the_shipped_recipes_build_as_the_jax_package_does(path):
    """Every recipe's spec, config and leaves at the new keys' defaults:
    the manifest is the JAX package's and no ``b`` leaf appears."""
    from ctc_pytorch_tpu.config import load_config as jax_load_config
    from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec

    cfg, jcfg = load_config(path), jax_load_config(path)
    n = cfg.num_class + 1 if cfg.num_class else cfg.output_class_dim
    spec = ModelSpec.from_config(cfg, num_class=n)
    assert (spec.rnn_merge, spec.rnn_bias) == ("concat", False)
    assert spec.to_dict() == JSpec.from_config(jcfg, num_class=n).to_dict()
    assert "rnn_merge" not in cfg.to_dict() and "rnn_bias" not in \
        cfg.to_dict()
    keys = CTCModel(spec).state_dict().keys()
    assert list(keys) == list(CTCModel(ModelSpec.from_dict(
        spec.to_dict())).state_dict().keys())
    assert not [k for k in keys if k.endswith(".b") and k.startswith("rnns")]
    params, _ = ckpt.leaf_paths(spec)
    assert all(not p.endswith(".b") for p in params if p.startswith("rnns"))


def test_a_checkpoint_with_the_new_keys_round_trips(tmp_path):
    arch, w, cfg, spec = small()
    state = create_train_state(spec, cfg.init_lr, cfg.weight_decay,
                               cfg.grad_clip, device="cpu")
    state.model.load_state_dict(w)
    ckpt.save_package(tmp_path / "ds2.npz", spec, state.model,
                      optimizer=state.optimizer, config=cfg)
    got_spec, model, manifest = ckpt.model_from_package(tmp_path / "ds2.npz",
                                                        device="cpu")
    assert got_spec == spec
    assert manifest["spec"]["rnn_merge"] == "sum"
    assert manifest["config"]["rnn_bias"] is True
    assert "rnns.0.bwd.b" in ckpt.leaf_paths(spec)[0]
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("ds2_keys", [True, False])
def test_the_route_counters_count_one_a_layer_call(ds2_keys):
    conf = SMALL if ds2_keys else {**SMALL, "rnn_merge": "concat",
                                   "rnn_bias": False}
    arch, _, cfg, spec = small(conf)
    state = create_train_state(spec, cfg.init_lr, 0.0, 0.0, device="cpu")
    feats, frac, labels, lab_len, mask = batch(arch)
    before = launch_counts.read()
    train_step(state, spec, feats, frac, labels, lab_len, mask)
    moved = launch_counts.diff(launch_counts.read(), before)
    launch_counts.restore(before)
    layers = spec.rnn_layers
    want = ({"gate": layers}, {"sum": layers}) if ds2_keys else \
        ({"none": layers}, {"concat": layers})
    assert moved[("rnn_io", "launches_mask")] == want[0]
    assert moved[("rnn_io", "launches_merge")] == want[1]
    # the plain twins launch nothing: no serial step is counted on the CPU
    assert not [k for k in moved if k[1] == "launches_steps"]


def test_the_user_recipe_is_the_bench_model():
    cfg = load_config(ROOT / "recipes/librispeech/ds2_config.yaml")
    bench = Config.from_dict(BENCH_CONFIG)
    assert ModelSpec.from_config(cfg, 29) == ModelSpec.from_config(bench, 29)
    for key in ("batch_size", "init_lr", "weight_decay", "grad_clip",
                "num_buckets", "batch_mode", "dtype", "feature_type",
                "fused_epoch", "fused_dispatch"):
        assert getattr(cfg, key) == getattr(bench, key), key
    assert cfg.train_scp_path.endswith("spectrum.scp")
