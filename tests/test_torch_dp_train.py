"""The port's data-parallel training on two gloo ranks spawned on the CPU,
against the JAX mesh step (``make_step_fns(spec, tx, mesh)`` on a 2-device
mesh) and against the port's own single process: the train step (LSTM and
GRU cells, the CNN on, batchmax pad dynamics, halves whose maxima differ,
a mask-0 row), the eval step, per-rank dropout, the loaders' rows, fused
epochs, ``Trainer.fit`` and ``cli.train --data-parallel``.

Tolerances.  Against the single process (the same fp32 math over two
shards): losses rtol 1e-5, parameters and BN state rtol 1e-4, atol 1e-6, as
the JAX package's ``tests/test_parallel.py`` holds its mesh step.  Against
the JAX mesh step: the port's step-parity tolerance, 1e-4 absolute
(``tests/test_torch_train.py``).  Token counts and sizes exactly."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu_torch.cli import train as cli_train
from ctc_pytorch_tpu_torch.config import Config, load_config
from ctc_pytorch_tpu_torch.data import DeviceCachedLoader, PrefetchLoader
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.parallel import (
    DataGroup,
    initialize,
    local_rows,
    spawn_ranks,
)
from ctc_pytorch_tpu_torch.train.checkpoint import (
    model_from_package,
    params_from_jax,
)
from ctc_pytorch_tpu_torch.train.loop import (
    Trainer,
    device_token_errors,
    eval_step,
    train_step,
)
from ctc_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_train import small_spec, tiny_config, write_split

WORLD = 2
ORDER = ("feats", "frac", "labels", "label_lens", "mask")
LR, WD = 1e-3, 5e-4
SINGLE = dict(rtol=1e-4, atol=1e-6)
JAX_TOL = 1e-4
# (cell, grad clip): the flagship's LSTM; the 863 recipe's GRU with its
# clip of 400; an LSTM clip that the global norm crosses
STEP_CASES = [("lstm", 0.0), ("gru", 400.0), ("lstm", 0.5)]


def dp_batches(n, seed):
    """Global batches of 8 (T=24): the first half's max is 24 frames, the
    second's 18 (its 20-frame row is a repeat-padded one, mask 0)."""
    rng = np.random.RandomState(seed)
    lens = np.array([24, 19, 16, 12, 18, 14, 10, 20], np.float32)
    return [dict(feats=rng.randn(8, 24, 8).astype(np.float32),
                 frac=lens / 24,
                 labels=rng.randint(1, 6, (8, 5)).astype(np.int32),
                 label_lens=np.array([5, 3, 1, 2, 3, 4, 2, 1], np.int32),
                 mask=np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32))
            for _ in range(n)]


def jspec_for(cell):
    jspec = small_spec("batchmax", cell=cell)
    return jspec.to_dict()


def jax_init(cell, seed=4):
    from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
    from tests.test_torch_model import jax_weights

    return jax_weights(JSpec.from_dict(jspec_for(cell)), seed=seed)


def port_state(spec_dict, params, mstate, grad_clip):
    spec = ModelSpec.from_dict(spec_dict)
    model = CTCModel(spec)
    model.load_state_dict(params_from_jax(spec, params, mstate))
    return spec, TrainState(model, make_optimizer(model, spec, LR, WD),
                            grad_clip=grad_clip)


def state_arrays(state):
    return {k: v.detach().numpy().copy()
            for k, v in state.model.state_dict().items()}


def run_case(spec_dict, params, mstate, grad_clip, batches, group=None,
             rows=lambda a: a):
    """The eval step from the init on the first batch, then a train step
    per batch: losses, sizes, log-probs, token counts and the final state."""
    spec, state = port_state(spec_dict, params, mstate, grad_clip)
    out = {"losses": [], "sizes": []}
    args = [torch.from_numpy(rows(batches[0][k])) for k in ORDER]
    loss, idx, sizes, lp = eval_step(state, spec, *args, group=group)
    errs, toks = device_token_errors(idx, sizes, args[2], args[3], args[4])
    both = torch.stack([errs, toks])
    if group is not None:
        from ctc_pytorch_tpu_torch.parallel import all_sum

        both = all_sum(both, group)
    out["eval"] = (float(loss), lp.numpy(), sizes.numpy(), both.tolist())
    for b in batches:
        args = [torch.from_numpy(rows(b[k])) for k in ORDER]
        loss, _, sizes = train_step(state, spec, *args, group=group)
        out["losses"].append(float(loss))
        out["sizes"].append(sizes.numpy())
    out["state"] = state_arrays(state)
    return out


def dropout_case(init, group, rows, drop):
    """One step of a spec with heavy dropout on identical rows, drawing from
    the rank's stream (``rank_seed``, as ``Trainer`` seeds it): the greedy
    indices of this rank's rows (the JAX package's decorrelation test)."""
    from ctc_pytorch_tpu_torch.parallel.distributed import rank_seed

    spec, state = port_state(dropout_spec(drop), *init, 0.0)
    b = dp_batches(1, seed=3)[0]
    b["feats"][:] = b["feats"][:1]
    b["labels"][:] = b["labels"][:1]
    b["frac"][:] = 1.0
    b["label_lens"][:] = 3
    b["mask"][:] = 1.0
    gen = torch.Generator().manual_seed(rank_seed(5, group.rank))
    _, idx, _ = train_step(state, spec,
                           *(torch.from_numpy(rows(b[k])) for k in ORDER),
                           generator=gen, group=group)
    return idx.numpy()


def dropout_spec(drop=0.0):
    spec_dict = jspec_for("lstm")
    spec_dict.update(drop_out=drop, add_cnn=False, rnn_hidden_size=16)
    return spec_dict


def step_ranks(rank, world, init_method, inits, batches, dropout_init):
    group = initialize("gloo", init_method, world, rank, device="cpu")
    rows = lambda a: local_rows(a, rank, world)  # noqa: E731
    out = {case: run_case(jspec_for(case[0]), *inits[case[0]], case[1],
                          batches, group, rows)
           for case in STEP_CASES}
    out["dropout"] = {drop: dropout_case(dropout_init, group, rows, drop)
                      for drop in (0.8, 0.0)}
    return out


@pytest.fixture(scope="module")
def steps():
    """Each case on two ranks, in one spawn, and in this process."""
    from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
    from tests.test_torch_model import jax_weights

    inits = {cell: jax_init(cell) for cell in ("lstm", "gru")}
    dropout_init = jax_weights(JSpec.from_dict(dropout_spec()), seed=6)
    batches = dp_batches(2, seed=7)
    ranks = spawn_ranks(step_ranks, WORLD, (inits, batches, dropout_init),
                        timeout=600, threads=1)
    single = {case: run_case(jspec_for(case[0]), *inits[case[0]], case[1],
                             batches) for case in STEP_CASES}
    return inits, batches, ranks, single


def jax_mesh_steps(cell, grad_clip, inits, batches):
    """The JAX package's mesh step on 2 CPU devices from the same init:
    per-step losses and sizes, and the final params and BN state."""
    import jax
    import jax.numpy as jnp

    from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec
    from ctc_pytorch_tpu.parallel import make_mesh, replicate, shard_batch
    from ctc_pytorch_tpu.train.loop import make_step_fns
    from ctc_pytorch_tpu.train.state import TrainState as JTrainState
    from ctc_pytorch_tpu.train.state import make_optimizer as jmake_optimizer

    jspec = JSpec.from_dict(jspec_for(cell))
    params, mstate = inits[cell]
    tx = jmake_optimizer(LR, WD, grad_clip)
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    mesh = make_mesh(jax.devices()[:WORLD])
    state = replicate(JTrainState(jnp.zeros((), jnp.int32), to_j(params),
                                  to_j(mstate), tx.init(to_j(params))), mesh)
    train, _ = make_step_fns(jspec, tx, mesh)
    key = replicate(jax.random.PRNGKey(0), mesh)
    losses, sizes = [], []
    for b in batches:
        state, loss, _, s = train(state, *shard_batch(
            tuple(b[k] for k in ORDER), mesh), key)
        losses.append(float(loss))
        sizes.append(np.asarray(s))
    return losses, sizes, state


def assert_states_close(got, want, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: f"{c[0]}-clip{c[1]}")
def test_two_rank_steps_match_one_process(steps, case):
    _, _, ranks, single = steps
    want = single[case]
    for r in ranks:
        np.testing.assert_allclose(r[case]["losses"], want["losses"],
                                   rtol=1e-5)
        assert_states_close(r[case]["state"], want["state"], **SINGLE)
    # the ranks agree with each other exactly: the same summed update
    for k, v in ranks[0][case]["state"].items():
        np.testing.assert_array_equal(ranks[1][case]["state"][k], v)
    for i, s in enumerate(want["sizes"]):
        np.testing.assert_array_equal(
            np.concatenate([r[case]["sizes"][i] for r in ranks]), s)


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: f"{c[0]}-clip{c[1]}")
def test_two_rank_steps_match_the_jax_mesh_step(steps, case):
    import jax

    from ctc_pytorch_tpu_torch.train.checkpoint import params_to_jax

    inits, batches, ranks, _ = steps
    losses, sizes, jstate = jax_mesh_steps(*case, inits, batches)
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"], losses, atol=JAX_TOL, rtol=1e-5)
    for i, s in enumerate(sizes):
        np.testing.assert_array_equal(
            np.concatenate([r[case]["sizes"][i] for r in ranks]), s)
    spec = ModelSpec.from_dict(jspec_for(case[0]))
    p, s = params_to_jax(spec, {k: torch.from_numpy(v)
                                for k, v in got["state"].items()})
    for g, w in zip(jax.tree_util.tree_leaves((p, s)),
                    jax.tree_util.tree_leaves((jstate.params,
                                               jstate.model_state))):
        np.testing.assert_allclose(g, np.asarray(w), atol=JAX_TOL, rtol=0)


def test_clip_sees_the_global_norm(steps):
    """With clip 0.5 the global gradient norm is clipped: the step differs
    from the unclipped one, on both ranks alike, as in one process."""
    _, _, ranks, single = steps
    clipped, free = ranks[0][("lstm", 0.5)], ranks[0][("lstm", 0.0)]
    assert any(np.abs(clipped["state"][k] - free["state"][k]).max() > 1e-5
               for k in free["state"])


def test_two_rank_eval_step_matches_one_process(steps):
    """The eval loss (summed), each rank's log-probs (its columns of the
    single process's), sizes and the summed token counts."""
    _, _, ranks, single = steps
    for case in STEP_CASES:
        loss, lp, sizes, counts = single[case]["eval"]
        for r in ranks:
            assert r[case]["eval"][0] == pytest.approx(loss, rel=1e-5)
            assert r[case]["eval"][3] == counts
        np.testing.assert_allclose(
            np.concatenate([r[case]["eval"][1] for r in ranks], axis=1), lp,
            atol=1e-5, rtol=0)
        np.testing.assert_array_equal(
            np.concatenate([r[case]["eval"][2] for r in ranks]), sizes)
        assert counts[1] > 0


def test_dropout_masks_decorrelated_across_ranks(steps):
    """Every row identical: with heavy dropout the two ranks' rows decode
    differently (each rank draws from its own stream), without dropout
    alike (``test_mesh_dropout_masks_decorrelated_across_shards``)."""
    _, _, ranks, _ = steps
    a, b = (r["dropout"][0.8] for r in ranks)
    assert a.shape == b.shape and not np.array_equal(a, b)
    a, b = (r["dropout"][0.0] for r in ranks)
    assert np.array_equal(a, b)
    assert all(np.array_equal(a[0], row) for row in a)


# ---------------------------------------------------------------------------
# the loaders' rows (no collective: a group names the rank's rows)
# ---------------------------------------------------------------------------

def corpus(root, n_train=8, n_dev=4):
    from tests.test_torch_train import PHONES

    (root / "units").write_text("".join(p + "\n" for p in PHONES))
    write_split(root, "train", n_train, seed=0)
    write_split(root, "dev", n_dev, seed=1)


def host_loader(root):
    from ctc_pytorch_tpu_torch.data import SpeechDataLoader, SpeechDataset

    cfg = tiny_config(Config, root)
    ds = SpeechDataset(Vocab(cfg.vocab_file), cfg.train_scp_path,
                       cfg.train_lab_path, cfg)
    return SpeechDataLoader(ds, 4, shuffle=True, num_buckets=2, seed=3,
                            mode="bucket")


def cpu_group(rank):
    return DataGroup(None, rank, WORLD, torch.device("cpu"), "gloo")


def test_device_cache_gives_each_rank_its_rows(tmp_path):
    corpus(tmp_path, n_train=11)
    full = DeviceCachedLoader(host_loader(tmp_path), "cpu")
    parts = [DeviceCachedLoader(host_loader(tmp_path), "cpu", cpu_group(r))
             for r in range(WORLD)]
    for ep in (1, 2):
        for loader in [full, *parts]:
            loader.set_epoch(ep)
        want = list(full.epoch_groups(ep, with_indices=True))
        got = [list(p.epoch_groups(ep, with_indices=True)) for p in parts]
        assert len(want) == len(got[0]) == len(got[1]) >= 1
        for g, w in zip(zip(*got), want):
            for i in (1, 2, 4):  # pos, mask, indices: the rank's columns
                np.testing.assert_array_equal(
                    np.concatenate([p[i] for p in g], axis=1), w[i])
            assert all(p[3] == w[3] and p[0] is not None for p in g)
        for batches in zip(full, *parts):
            w, *g = batches
            for k in ("feats", "input_frac", "labels", "example_mask"):
                torch.testing.assert_close(
                    torch.cat([getattr(p, k) for p in g]), getattr(w, k),
                    rtol=0, atol=0)
            assert sum((p.utts for p in g), []) == w.utts
    assert (parts[1].total_bytes() == full.total_bytes() > 0)  # replicated


def test_prefetch_loader_gives_each_rank_its_rows(tmp_path):
    corpus(tmp_path, n_train=10)
    full = PrefetchLoader(host_loader(tmp_path), "cpu")
    parts = [PrefetchLoader(host_loader(tmp_path), "cpu", group=cpu_group(r))
             for r in range(WORLD)]
    for loader in [full, *parts]:
        loader.set_epoch(1)
    n = 0
    for w, *g in zip(full, *parts):
        for k in PrefetchLoader.FIELDS:
            assert torch.equal(torch.cat([getattr(p, k) for p in g]),
                               getattr(w, k))
        n += 1
    assert n == len(full) == 3


def test_trainer_refuses_a_gloo_group_with_fused_epochs_on_the_card(
        tmp_path, monkeypatch):
    cfg = tiny_config(Config, tmp_path)
    cfg.fused_epoch = True
    spec = ModelSpec.from_dict(jspec_for("lstm"))
    gloo = DataGroup(None, 0, 2, torch.device("cuda"), "gloo")
    with pytest.raises(ValueError, match="fused_epoch: false"):
        Trainer(cfg, spec, device="cuda", group=gloo)
    # no card here: an NCCL group passes that check and meets resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nccl = DataGroup(None, 0, 2, torch.device("cuda"), "nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, spec, device="cuda", group=nccl)


def test_cli_batch_size_must_divide_the_world(tmp_path):
    corpus(tmp_path)
    cfg = tiny_config(Config, tmp_path)
    three = DataGroup(None, 0, 3, torch.device("cpu"), "gloo")
    with pytest.raises(SystemExit, match="multiple of the 3 ranks"):
        cli_train.train(cfg, device="cpu", group=three)
    assert not (tmp_path / "checkpoint").exists()


# ---------------------------------------------------------------------------
# Trainer.fit and cli.train on two ranks
# ---------------------------------------------------------------------------

def fit_config(root, fused: bool):
    cfg = tiny_config(Config, root)
    cfg.fused_epoch = cfg.device_cache = fused
    cfg.num_buckets = 2
    cfg.batch_mode = "bucket"
    cfg.exp_name = f"fused{int(fused)}"
    return cfg


def fit(root, fused: bool, out_dir, group=None):
    cfg = fit_config(root, fused)
    vocab = Vocab(cfg.vocab_file)
    tr, dv = cli_train.build_loaders(cfg, vocab, log=lambda *_: None,
                                     device="cpu", group=group)
    assert isinstance(tr, DeviceCachedLoader) == fused
    spec = ModelSpec.from_config(cfg, num_class=vocab.n_words)
    trainer = Trainer(cfg, spec, device="cpu", out_dir=str(out_dir),
                      group=group)
    lines = []
    best = trainer.fit(tr, dv, num_epoches=2, log=lines.append)
    return {"histories": trainer.histories, "state": state_arrays(
        trainer.state), "step": trainer.state.step, "lines": lines,
        "scheduler": trainer.scheduler.state_dict(), "best": str(best)}


def fit_ranks(rank, world, init_method, root):
    from pathlib import Path

    group = initialize("gloo", init_method, world, rank, device="cpu")
    return {fused: fit(Path(root), fused, Path(root) / f"fused{fused}_rank{rank}",
                       group) for fused in (False, True)}


def test_trainer_fit_on_two_ranks_matches_one_process(tmp_path):
    """Streaming and fused epochs (the CPU runs the fused runners eagerly):
    the two ranks' histories and states are identical, equal to one
    process's, and only rank 0 logs and writes."""
    corpus(tmp_path, n_train=12, n_dev=4)
    ranks = spawn_ranks(fit_ranks, WORLD, (str(tmp_path),), timeout=600,
                        threads=1)
    for fused in (False, True):
        want = fit(tmp_path, fused, tmp_path / f"single{fused}")
        r0, r1 = ranks[0][fused], ranks[1][fused]
        assert r0["histories"] == r1["histories"]
        assert r0["scheduler"] == r1["scheduler"] == want["scheduler"]
        for k, v in r0["state"].items():
            np.testing.assert_array_equal(r1["state"][k], v)
        assert_states_close(r0["state"], want["state"], **SINGLE)
        assert r0["step"] == want["step"] == 6
        for k, v in want["histories"].items():
            np.testing.assert_allclose(r0["histories"][k], v, rtol=1e-5)
        assert r1["lines"] == [] and len(r0["lines"]) > 4
        written = sorted(p.name for p in (tmp_path / f"fused{fused}_rank0")
                         .iterdir())
        assert "ctc_best_model.npz" in written
        assert "train_metrics.jsonl" in written
        assert not (tmp_path / f"fused{fused}_rank1").exists()
        assert written == sorted(p.name for p in (tmp_path / f"single{fused}")
                                 .iterdir())


def cli_ranks(rank, world, init_method, conf):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        best = cli_train.main(["--conf", conf, "--data-parallel", "--device",
                               "cpu", "--dist-backend", "gloo",
                               "--dist-init-method", init_method])
    return str(best), out.getvalue()


def test_cli_train_data_parallel_matches_the_single_process_run(
        tmp_path, monkeypatch):
    """``cli.train --data-parallel`` as two gloo ranks equals the same
    command in one process (where ``WORLD_SIZE`` is unset it is the plain
    run): the best package and the metrics.  Rank 0 prints the log; rank 1
    prints nothing."""
    corpus(tmp_path, n_train=12, n_dev=4)
    confs = {}
    for name in ("single", "ranks"):
        cfg = fit_config(tmp_path, fused=True)
        cfg.checkpoint_dir = str(tmp_path / f"ckpt_{name}")
        cfg.num_epoches = 2
        confs[name] = str(tmp_path / f"{name}.yaml")
        cfg.to_yaml(confs[name])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    single = cli_train.main(["--conf", confs["single"], "--data-parallel",
                             "--device", "cpu"])
    ranks = spawn_ranks(cli_ranks, WORLD, (confs["ranks"],), timeout=600,
                        threads=1)
    (best0, out0), (best1, out1) = ranks
    assert best0 == best1 and out1 == ""
    assert "End training, best model saved to" in out0
    _, got, _ = model_from_package(best0, "cpu")
    _, want, _ = model_from_package(single, "cpu")
    for k, v in want.state_dict().items():
        np.testing.assert_allclose(got.state_dict()[k].numpy(), v.numpy(),
                                   **SINGLE)
    exp = load_config(confs["ranks"]).exp_name
    recs = [[json.loads(ln) for ln in (tmp_path / f"ckpt_{n}" / exp /
                                        "train_metrics.jsonl").read_text()
             .splitlines()] for n in ("ranks", "single")]
    assert len(recs[0]) == len(recs[1]) == 2
    for g, w in zip(*recs):
        for k in ("train_loss", "dev_loss", "dev_acc", "lr"):
            assert g[k] == pytest.approx(w[k], rel=1e-5)


def test_chip_smoke_phase15_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 15 with ``device="cpu"`` on the flagship
    recipe cut in width and depth: (a) and (b) on two gloo ranks against
    one process, (d) ``cli.train --data-parallel`` on two ranks and its
    package decoded, (e) the sharded search and the mesh ``Recognizer``
    against the unsplit ones ((c) needs NCCL and the card)."""
    from pathlib import Path

    import chip_smoke

    root = Path(__file__).resolve().parent.parent
    cut = (root / "recipes/timit/ctc_config.yaml").read_text()
    for a, b in (("rnn_hidden_size: 384", "rnn_hidden_size: 8"),
                 ("rnn_layers: 4", "rnn_layers: 2"),
                 ('channel: "[(1, 32), (32, 32)]"', 'channel: "[(1, 4), (4, 4)]"')):
        assert a in cut
        cut = cut.replace(a, b)
    (tmp_path / "cut.yaml").write_text(cut)
    monkeypatch.setattr(chip_smoke, "RECIPE", tmp_path / "cut.yaml")
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    for split, n, seed in (("train", 16, 1), ("dev", 8, 2), ("test", 7, 0)):
        chip_smoke.write_corpus(tmp_path / "data", split, n, seed=seed)
    cfg = chip_smoke.recipe_config(chip_smoke.RECIPE)
    spec = ModelSpec.from_config(cfg, num_class=Vocab(cfg.vocab_file).n_words)
    assert spec.rnn_hidden_size == 8
    out = chip_smoke.phase_data_parallel("cpu", spec, device="cpu",
                                         big_batch=16, t_frames=40,
                                         label_len=5)
    assert out["world"] == 2 and "nccl_one_rank" not in out
    for name in ("a", "b"):
        ranks = out["steps"][name]["ranks"]
        assert ranks[0]["losses"] == ranks[1]["losses"]
    assert out["steps"]["b"]["ranks"][0]["step_device_ms"] is None
    # on the CPU the ops run their twins: no kernel is counted
    assert "lstm_bidir_train_bwd" in out["counts"]
    assert not any(out["counts"].values())
    assert out["cli"]["files"].count("ctc_best_model.npz") == 1
