"""``remat`` in the port: each recurrent layer recomputed in the backward
pass (``torch.utils.checkpoint`` around the layer up to its dropout), the
counterpart of the JAX package's ``jax.checkpoint(rnn_layer_apply)``.

For the LSTM, GRU and tanh cells with one and two directions:

- a remat train step (loss, every gradient, the new BN state) against the
  JAX package's ``remat: True`` step on the same weights and batch, at the
  port-vs-JAX step tolerance of ``tests/test_torch_train.py`` (1e-4);
- a remat step against the port's own plain step, bit for bit (loss,
  gradients, BN ``mean`` / ``var`` / ``count``, the dropout generator's
  state), with ``drop_out`` 0 and 0.2: the recompute moves no BN buffer and
  draws no dropout mask;
- what the forward keeps: under remat only each layer's input (and the
  dropout masks, outside the region); without it the recurrence's planes
  (the LSTM's ``gx``, ``ys``, ``cs``; the GRU's ``gx``, ``ys``; the tanh
  cell's ``ys``) and the projection's operands, counted by a saved-tensor
  hook.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.models.ctc_model import CTCModel as JModel
from ctc_pytorch_tpu.ops import ctc_loss as jctc_loss
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.models.rnn import RNNLayer
from ctc_pytorch_tpu_torch.ops.ctc_loss import ctc_loss
from ctc_pytorch_tpu_torch.train.checkpoint import params_from_jax, params_to_jax
from tests.test_torch_model import jax_weights, small_jax_spec

TOL = 1e-4  # the port-vs-JAX step tolerance (tests/test_torch_train.py)
GATES = {"lstm": 4, "gru": 3, "rnn": 1}
CELLS = [(cell, bidir) for cell in ("lstm", "gru", "rnn")
         for bidir in (True, False)]
B, T, FEAT, H = 4, 16, 12, 8
LENS = np.array([16, 13, 11, 16], np.float32)
MASK = np.array([1, 1, 1, 0], np.float32)  # the last row repeat-padded


def jspec_of(cell, bidir, remat, drop=0.0):
    spec = small_jax_spec(add_cnn=False, cell=cell, bidirectional=bidir,
                          hidden=H, feat=FEAT)
    return dataclasses.replace(spec, remat=remat, drop_out=drop)


def batch(seed=0):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(B, T, FEAT).astype(np.float32),
                frac=LENS / T,
                labels=rng.randint(1, 6, (B, 4)).astype(np.int32),
                label_lens=np.array([4, 3, 2, 2], np.int32))


def port_model(jspec, params, state):
    spec = ModelSpec.from_dict(jspec.to_dict())
    model = CTCModel(spec)
    model.load_state_dict(params_from_jax(spec, params, state))
    return spec, model


def port_step(jspec, params, state, bt, generator=None, lengths=None):
    """One train-mode forward and backward: ``(loss, grads by name, buffers
    by name, model)``."""
    spec, model = port_model(jspec, params, state)
    frac = torch.from_numpy(bt["frac"])
    mask = torch.from_numpy(MASK)
    lp = model(torch.from_numpy(bt["x"]), frac, mask, train=True,
               generator=generator, lengths=lengths)
    sizes = CTCModel.input_sizes(spec, frac, T, lp.shape[0], mask)
    loss = ctc_loss(lp, torch.from_numpy(bt["labels"]), sizes,
                    torch.from_numpy(bt["label_lens"]), reduction="sum")
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    bufs = {k: b.clone() for k, b in model.named_buffers()}
    return loss.detach(), grads, bufs, model


@pytest.mark.parametrize("cell,bidir", CELLS)
def test_remat_step_matches_the_jax_remat_step(cell, bidir):
    jspec = jspec_of(cell, bidir, remat=True)
    params, state = jax_weights(jspec, seed=3)
    bt = batch()
    loss, grads, bufs, model = port_step(jspec, params, state, bt)

    def jloss(p):
        lp, new_state = JModel.apply(
            jspec, p, jax.tree_util.tree_map(jnp.asarray, state),
            jnp.asarray(bt["x"]), train=True, frac=jnp.asarray(bt["frac"]),
            example_mask=jnp.asarray(MASK))
        sizes = JModel.input_sizes(jspec, jnp.asarray(bt["frac"]), T,
                                   lp.shape[0], jnp.asarray(MASK))
        return jctc_loss(lp, jnp.asarray(bt["labels"]), sizes,
                         jnp.asarray(bt["label_lens"]),
                         reduction="sum"), new_state

    (want_loss, want_state), want_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=TOL,
                               rtol=1e-5)
    spec = ModelSpec.from_dict(jspec.to_dict())
    got_g, got_s = params_to_jax(spec, {**model.state_dict(), **grads})
    for got, want in ((got_g, want_grads), (got_s, want_state)):
        g_leaves, g_def = jax.tree_util.tree_flatten(got)
        w_leaves, w_def = jax.tree_util.tree_flatten(want)
        assert g_def == w_def
        for g, w in zip(g_leaves, w_leaves):
            np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("drop", [0.0, 0.2])
@pytest.mark.parametrize("cell,bidir", CELLS)
def test_remat_step_equals_the_plain_step_bit_for_bit(cell, bidir, drop):
    """Loss, gradients, BN buffers and the dropout generator's state after
    one step, with ``lengths`` (the packed-sequence masks inside the
    region): a recompute that moved a BN buffer again or drew another mask
    would differ."""
    params, state = jax_weights(jspec_of(cell, bidir, False), seed=5)
    bt = batch(1)
    lengths = torch.from_numpy(LENS.astype(np.int64))
    runs = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(11)
        loss, grads, bufs, model = port_step(
            jspec_of(cell, bidir, remat, drop), params, state, bt, gen,
            lengths)
        runs.append((loss, grads, bufs, gen.get_state()))
    (l0, g0, b0, s0), (l1, g1, b1, s1) = runs
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys() and b0.keys() == b1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k
    counts = [int(v) for k, v in b1.items() if k.endswith("count")]
    assert counts and set(counts) == {1}  # one update each, not two
    assert torch.equal(s0, s1)


@pytest.mark.parametrize("cell,bidir", CELLS)
def test_remat_keeps_each_layers_input_and_nothing_inside(cell, bidir):
    """A saved-tensor hook over the train-mode forward sees, with remat,
    each recurrent layer's input once and no other (T, B, ...) float tensor
    of the stack's widths: no ``gx``, ``ys``, ``cs``, BN or projection
    operand (the log-softmax's output, past the stack, is kept either
    way).  Without remat it sees the recurrence's planes, and remat keeps
    less by at least their bytes."""
    gates, dirs = GATES[cell], 2 if bidir else 1
    # the planes each op saves beside w_hh: gx, ys and cs; gx, ys; ys
    planes = {"lstm": (gates, 1, 1), "gru": (gates, 1), "rnn": (1,)}[cell]
    params, state = jax_weights(jspec_of(cell, bidir, False), seed=2)
    bt = batch(2)
    seen = {}
    for remat in (False, True):
        spec, model = port_model(jspec_of(cell, bidir, remat, 0.2), params,
                                 state)
        inputs = []
        for layer in model.rnns:
            layer.register_forward_pre_hook(
                lambda mod, args: inputs.append(args[0]))
        packed = []

        def pack(t):
            packed.append(t)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(torch.from_numpy(bt["x"]), train=True,
                  generator=torch.Generator().manual_seed(0))
        seen[remat] = (packed, inputs)
    plain, _ = seen[False]
    kept, inputs = seen[True]
    n_layers = len(model.rnns)
    assert len(inputs) == n_layers and isinstance(model.rnns[0], RNNLayer)
    width = [t.shape[-1] for t in plain if t.dim() == 3
             and t.shape[:2] == (T, B)]
    assert width.count(dirs * gates * H) >= (n_layers if cell != "rnn"
                                             else 0)
    widths = (FEAT, dirs * H, dirs * gates * H)
    in_region = [t for t in kept if t.is_floating_point() and t.dim() == 3
                 and t.shape[:2] == (T, B) and t.shape[-1] in widths]
    ptrs = [t.data_ptr() for t in inputs]
    assert sorted(t.data_ptr() for t in in_region) == sorted(ptrs)
    plane_bytes = n_layers * sum(T * B * dirs * w * H * 4 for w in planes)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    assert nbytes(plain) - nbytes(kept) >= plane_bytes


def test_remat_changes_nothing_in_eval_or_without_grad():
    jspec = jspec_of("lstm", True, True)
    params, state = jax_weights(jspec, seed=1)
    x = torch.from_numpy(batch()["x"])
    _, plain = port_model(jspec_of("lstm", True, False), params, state)
    _, remat = port_model(jspec, params, state)
    assert torch.equal(plain(x), remat(x))  # eval mode
    with torch.no_grad():
        assert torch.equal(plain(x, train=True), remat(x, train=True))
    assert torch.equal(plain.rnns[1].bn.count, remat.rnns[1].bn.count)


def test_chip_smoke_phase17_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 17 with ``device="cpu"``, on the waveform
    recipe, the flagship and the 863 recipe cut in width, depth and batch
    (the runners run eagerly): each remat fit and step equal to its plain
    one bit for bit, and ``ctc_forward_score`` against its twin, the
    impossible rows at ``NEG_INF``.  What only the card has (launches,
    branches, memory, times) is not checked."""
    from tests.test_torch_cuda import chip_smoke

    def cut(src, name, pairs):
        text = src.read_text()
        for a, b in pairs:
            assert a in text
            text = text.replace(a, b)
        (tmp_path / name).write_text(text)
        return tmp_path / name

    narrow = (("rnn_hidden_size: 384", "rnn_hidden_size: 16"),
              ("rnn_layers: 4", "rnn_layers: 2"))
    monkeypatch.setattr(chip_smoke, "RECIPE_WAVE", cut(
        chip_smoke.RECIPE_WAVE, "wave.yaml",
        narrow + (("batch_size: 128", "batch_size: 8"),)))
    monkeypatch.setattr(chip_smoke, "RECIPE", cut(
        chip_smoke.RECIPE, "flagship.yaml",
        narrow + (('channel: "[(1, 32), (32, 32)]"',
                   'channel: "[(1, 4), (4, 4)]"'),)))
    monkeypatch.setattr(chip_smoke, "RECIPE_863", cut(
        chip_smoke.RECIPE_863, "863.conf",
        (("rnn_hidden_size = 256", "rnn_hidden_size = 16"),
         ("rnn_layers = 4", "rnn_layers = 2"),
         ("channel = [(1, 16)]", "channel = [(1, 4)]"))))
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    monkeypatch.setattr(chip_smoke, "WAVE_SPLITS", (
        ("train", 16, 1), ("dev", 4, 2), ("test", 4, 3)))
    monkeypatch.setattr(chip_smoke, "N_TRAIN_UTTS", 16)
    monkeypatch.setattr(chip_smoke, "N_DEV_UTTS", 8)
    monkeypatch.setattr(chip_smoke, "N_TRAIN_UTTS_863", 16)
    monkeypatch.setattr(chip_smoke, "N_DEV_UTTS_863", 16)
    write = chip_smoke.write_audio_corpus
    monkeypatch.setattr(chip_smoke, "write_audio_corpus",
                        lambda root, split, n, seed: write(root, split, n, seed,
                                                           (0.3, 0.6)))
    out = chip_smoke.phase_remat("cpu", device="cpu")
    assert out["waveform_fit"]["steps"] == 2
    assert out["flagship_fit"]["steps"] == 2
    assert out["ctc_forward_score"]["calls"] == 3
    assert out["ctc_forward_score"]["max_rel_err"] <= chip_smoke.FP32_TOL
