"""The port's data parallelism (``ctc_pytorch_tpu_torch/parallel/``) against
the JAX package's on its 2-device CPU mesh: the row placement of a sharded
batch, the collectives inside the model (synchronised BN1d and BN2d in
train mode, the batch max of the batchmax pad dynamics, CMVN), the sharded
batched beam search, and the mesh ``Recognizer``; and, on the ranks alone,
``make_global_batch`` and a ``remat`` step with synchronised BN against the
plain step.

The port's collectives run in two gloo ranks spawned on the CPU
(``spawn_ranks``); one spawn computes every rank-side result of this file
(the ``ranks`` fixture).  Tolerances: BN outputs, statistics and input
gradients 1e-5 absolute (fp32, other summation orders); integer sizes and
decoded strings exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu_torch.frontend import cmvn
from ctc_pytorch_tpu_torch.models.cnn import BatchNorm2d
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.models import layers
from ctc_pytorch_tpu_torch.models.layers import BatchNorm
from ctc_pytorch_tpu_torch.parallel import (
    DataGroup,
    initialize,
    local_rows,
    make_global_batch,
    make_mesh,
    pad_batch_to_devices,
    shard_batch,
    shard_for_host,
    spawn_ranks,
)

WORLD = 2
TOL = 1e-5


# ---------------------------------------------------------------------------
# the cases, made from numpy seeds on both sides
# ---------------------------------------------------------------------------

def bn1d_case(masked: bool):
    """x (B=8, T=5, F=6) batch-major, its 0/1 mask, BN params and state, and
    the fixed weights ``w`` of the scalar loss sum(bn(x) * w)."""
    rng = np.random.RandomState(10 + masked)
    x = (rng.randn(8, 5, 6) * 2 + 1).astype(np.float32)
    x[4:] *= 3  # the two halves have different statistics
    mask = (rng.rand(8, 5) > 0.3).astype(np.float32) if masked else None
    if masked:
        mask[7] = 0.0  # a repeat-padded row
    params = {"scale": (rng.rand(6) + 0.5).astype(np.float32),
              "bias": rng.randn(6).astype(np.float32)}
    state = {"mean": rng.randn(6).astype(np.float32),
             "var": (rng.rand(6) + 0.5).astype(np.float32),
             "count": np.asarray(3, np.int32)}
    w = rng.randn(*x.shape).astype(np.float32)
    return x, mask, params, state, w


def bn2d_case(masked: bool):
    """NCHW planes x (B=8, C=3, T=7, F=5), a (B, 1, T, 1) mask (frames
    below a cutoff, a repeat-padded row), params, state, loss weights."""
    rng = np.random.RandomState(20 + masked)
    x = (rng.randn(8, 3, 7, 5) + 0.5).astype(np.float32)
    x[:4] *= 2
    mask = None
    if masked:
        rows = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)
        mask = (np.arange(7)[None, :] < 5) & rows[:, None]
        mask = mask[:, None, :, None]
    params = {"scale": (rng.rand(3) + 0.5).astype(np.float32),
              "bias": rng.randn(3).astype(np.float32)}
    state = {"mean": rng.randn(3).astype(np.float32),
             "var": (rng.rand(3) + 0.5).astype(np.float32)}
    w = rng.randn(*x.shape).astype(np.float32)
    return x, mask, params, state, w


# global batch of 8, T=16: the halves' maxima differ (16 and 13), and the
# second half has a mask-0 row whose length would otherwise be its max
BMAX_LENS = np.array([16, 11, 9, 14, 13, 8, 10, 15], np.float32)
BMAX_MASK = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)


def small_spec():
    from ctc_pytorch_tpu_torch.config import CNNConfig

    cnn = CNNConfig(add_cnn=True, layers=2, channel=[(1, 2), (2, 2)],
                    kernel_size=[(3, 3), (3, 3)], stride=[(1, 2), (2, 2)],
                    padding=[(1, 1), (1, 1)], batch_norm=True)
    return ModelSpec(add_cnn=True, cnn=cnn, rnn_input_size=8,
                     rnn_hidden_size=8, rnn_layers=1, rnn_cell="lstm",
                     bidirectional=True, batch_norm=True, num_class=5,
                     drop_out=0.0, compute_dtype="float32")


# a global batch whose rank shares make_global_batch places
GLOBAL_FEATS = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
GLOBAL_LABELS = np.arange(8 * 2, dtype=np.int32).reshape(8, 2) % 5


def cmvn_case():
    rng = np.random.RandomState(0)
    feats = (rng.randn(8, 10, 4) * 3 + 2).astype(np.float32)
    mask = (rng.rand(8, 10) > 0.2).astype(np.float32)
    return feats, mask


# ---------------------------------------------------------------------------
# the rank side: one spawn of two gloo ranks for the whole file
# ---------------------------------------------------------------------------

def plain_all_sum(x, group):
    """A sum over the group that autograd does not see: the forward of
    ``all_sum`` with the backward of the identity (what a bare
    ``torch.distributed.all_reduce`` on the sums gives)."""
    import torch.distributed as dist

    s = x.detach().clone()
    dist.all_reduce(s)
    return x + (s - x.detach())


def run_bn(module_cls, case, group, rank, rows_of):
    x, mask, params, state, w = case
    bn = module_cls(x.shape[1] if module_cls is BatchNorm2d else x.shape[-1])
    bn.load_state_dict({k: torch.tensor(v) for k, v in {**params,
                                                         **state}.items()})
    bn.train()
    xl = torch.from_numpy(rows_of(x)).requires_grad_()
    ml = None if mask is None else torch.from_numpy(rows_of(mask))
    y = bn(xl, ml, group)
    (y * torch.from_numpy(rows_of(w))).sum().backward()
    return {"y": y.detach().numpy(), "mean": bn.mean.numpy(),
            "var": bn.var.numpy(), "grad": xl.grad.numpy()}


def global_batch_rank(group, rank, rows_of):
    """The rank's share through ``make_global_batch``, and the error a
    mismatch of row counts (3 rows on rank 0, 2 on rank 1) raises."""
    got = make_global_batch((rows_of(GLOBAL_FEATS), rows_of(GLOBAL_LABELS)),
                            group, "cpu")
    try:
        make_global_batch((np.zeros((3 - rank, 4), np.float32),), group,
                          "cpu")
        err = None
    except ValueError as exc:
        err = str(exc)
    return {"arrays": [t.numpy() for t in got], "mismatch": err}


def remat_rank(group, rows_of):
    """One train-mode forward and backward of a two-layer model (its second
    layer's BN synchronised, inside the remat region) on the rank's rows,
    without and with ``remat``: loss, gradients and buffers of each."""
    rng = np.random.RandomState(4)
    feats = rng.randn(8, 16, 8).astype(np.float32)
    w = rng.randn(8, 8, 5).astype(np.float32)  # (T', B, C) loss weights
    out = {}
    for remat in (False, True):
        spec = dataclasses.replace(small_spec(), rnn_layers=2, remat=remat)
        model = CTCModel(spec)
        model.reset_parameters(torch.Generator().manual_seed(0))
        lp = model(torch.from_numpy(rows_of(feats)),
                   torch.from_numpy(rows_of(BMAX_LENS / 16)),
                   torch.from_numpy(rows_of(BMAX_MASK)), train=True,
                   group=group)
        loss = (lp * torch.from_numpy(w[:, :lp.shape[1]])).sum()
        loss.backward()
        out[remat] = {"loss": loss.detach(),
                      **{k: p.grad for k, p in model.named_parameters()},
                      **dict(model.named_buffers())}
    return out


def collective_ranks(rank, world, init_method):
    group = initialize("gloo", init_method, world, rank, device="cpu")
    rows_of = lambda a: local_rows(a, rank, world)  # noqa: E731
    out = {"group": (group.rank, group.world, str(group.device),
                     group.backend)}
    for masked in (False, True):
        for name, cls, case in (("bn1d", BatchNorm, bn1d_case(masked)),
                                ("bn2d", BatchNorm2d, bn2d_case(masked))):
            out[name, masked] = run_bn(cls, case, group, rank, rows_of)
            # the same with a sum autograd does not see
            saved = layers.all_sum
            layers.all_sum = plain_all_sum
            try:
                out[name, masked, "plain"] = run_bn(cls, case, group, rank,
                                                    rows_of)
            finally:
                layers.all_sum = saved
    frac = torch.from_numpy(rows_of(BMAX_LENS / 16))
    mask = torch.from_numpy(rows_of(BMAX_MASK))
    spec = small_spec()
    out["bmax"] = [int(CTCModel.batch_max_frames(frac, 16, mask, g)[1])
                   for g in (group, None)]
    out["sizes"] = [CTCModel.input_sizes(spec, frac, 16,
                                         spec.output_time_len(16), mask,
                                         g).numpy() for g in (group, None)]
    feats, fmask = cmvn_case()
    stats = cmvn.accumulate_cmvn(cmvn.init_cmvn(4),
                                 torch.from_numpy(rows_of(feats)),
                                 torch.from_numpy(rows_of(fmask)), group)
    out["cmvn"] = [t.numpy() for t in stats]
    out["global_batch"] = global_batch_rank(group, rank, rows_of)
    out["remat"] = remat_rank(group, rows_of)
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(collective_ranks, WORLD, timeout=300, threads=1)


# ---------------------------------------------------------------------------
# the JAX side on a 2-device mesh
# ---------------------------------------------------------------------------

def jax_mesh():
    import jax

    from ctc_pytorch_tpu.parallel import make_mesh as jmake_mesh

    return jmake_mesh(jax.devices()[:WORLD])


def jax_sharded(fn, in_specs, out_specs):
    from ctc_pytorch_tpu.parallel.mesh import shard_map_compat

    return shard_map_compat(fn, jax_mesh(), in_specs, out_specs)


def jax_bn(kind: str, masked: bool):
    """The JAX BN on the mesh with ``axis_name``: (y, new state, dx)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ctc_pytorch_tpu.models.cnn import _bn2d
    from ctc_pytorch_tpu.models.layers import batchnorm_apply

    if kind == "bn1d":
        x, mask, params, state, w = bn1d_case(masked)
        to_nat = from_nat = lambda a: a  # noqa: E731
        m = None if mask is None else jnp.asarray(mask)
        bn = batchnorm_apply
    else:
        x, mask, params, state, w = bn2d_case(masked)
        to_nat = lambda a: a.transpose(0, 2, 3, 1)  # noqa: E731  NCHW->NHWC
        from_nat = lambda a: a.transpose(0, 3, 1, 2)  # noqa: E731
        # the JAX mask is (B, T, 1, 1)
        m = None if mask is None else jnp.asarray(mask[:, 0, :, :, None])
        bn = _bn2d
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = jax.tree_util.tree_map(jnp.asarray, state)

    def body(xs, ms):
        return bn(p, s, xs, True, axis_name="data", mask=ms)

    data = P("data")
    if m is None:
        f = jax_sharded(lambda xs: body(xs, None), (data,), (data, P()))
        run = lambda xs: f(xs)  # noqa: E731
    else:
        f = jax_sharded(body, (data, data), (data, P()))
        run = lambda xs: f(xs, m)  # noqa: E731
    xn = jnp.asarray(to_nat(x))
    y, new_state = run(xn)
    dx = jax.grad(lambda a: jnp.sum(run(a)[0] * jnp.asarray(to_nat(w))))(xn)
    return (from_nat(np.asarray(y)), {k: np.asarray(v) for k, v in
                                      new_state.items()},
            from_nat(np.asarray(dx)))


def gathered(ranks, key, field):
    return np.concatenate([r[key][field] for r in ranks])


# ---------------------------------------------------------------------------
# row placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3, 4])
def test_shard_for_host_matches_jax(world):
    from ctc_pytorch_tpu.parallel.distributed import shard_for_host as jshard

    items = [f"utt{i}" for i in range(11)]
    got = [shard_for_host(items, r, world) for r in range(world)]
    assert got == [jshard(items, r, world) for r in range(world)]
    assert sorted(sum(got, [])) == sorted(items)


@pytest.mark.parametrize("world", [2, 4])
def test_local_rows_and_shard_batch_place_rows_as_named_sharding(world):
    import jax

    from ctc_pytorch_tpu.parallel import make_mesh as jmake_mesh
    from ctc_pytorch_tpu.parallel import shard_batch as jshard_batch

    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    mesh = jmake_mesh(jax.devices()[:world])
    (jx,) = jshard_batch((x,), mesh)
    by_device = {s.device: np.asarray(s.data) for s in jx.addressable_shards}
    want = [by_device[d] for d in mesh.devices.flat]
    for r in range(world):
        np.testing.assert_array_equal(local_rows(x, r, world), want[r])
    shards = shard_batch((torch.from_numpy(x),), ["cpu"] * world)
    for r, (t,) in enumerate(shards):
        np.testing.assert_array_equal(t.numpy(), want[r])


def test_local_rows_cuts_every_field_of_a_batch():
    from ctc_pytorch_tpu_torch.data.batching import Batch

    b = Batch(feats=np.zeros((4, 3, 2), np.float32),
              input_frac=np.arange(4, dtype=np.float32),
              input_lengths=np.arange(4, dtype=np.int32),
              labels=np.zeros((4, 2), np.int32),
              label_lengths=np.ones(4, np.int32), utts=list("abcd"),
              example_mask=np.ones(4, np.float32))
    got = local_rows(b, 1, 2)
    assert got.utts == ["c", "d"] and got.feats.shape == (2, 3, 2)
    np.testing.assert_array_equal(got.input_frac, [2, 3])
    with pytest.raises(ValueError, match="multiple of the world"):
        local_rows(b, 0, 3)


def test_shard_batch_raises_and_pad_batch_to_devices_rounds_up():
    with pytest.raises(ValueError, match="must divide"):
        shard_batch((torch.zeros(5, 2),), ["cpu", "cpu"])
    assert [pad_batch_to_devices(n, 4) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]


def test_make_mesh_names_devices_and_raises_without_a_card(monkeypatch):
    assert make_mesh(["cpu", torch.device("cpu")]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


# ---------------------------------------------------------------------------
# start-up and the launcher
# ---------------------------------------------------------------------------

def test_initialize_is_a_no_op_for_one_process_and_raises_without_a_rank(
        monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize("gloo", device="cpu") is None
    assert initialize("gloo", world_size=1, device="cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize("gloo", device="cpu")


def failing_rank(rank, world, init_method):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def sleeping_rank(rank, world, init_method):
    import time

    time.sleep(60)


def bad_backend_rank(rank, world, init_method):
    initialize("no-such-backend", init_method, world, rank, device="cpu")


def test_spawn_ranks_raises_what_a_rank_raises():
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_ranks(failing_rank, 2, timeout=120, threads=1)
    # a failed start raises: no rank continues alone
    with pytest.raises(Exception, match="no-such-backend"):
        spawn_ranks(bad_backend_rank, 2, timeout=120, threads=1)


def test_spawn_ranks_kills_ranks_past_the_timeout():
    with pytest.raises(TimeoutError, match="past"):
        spawn_ranks(sleeping_rank, 2, timeout=5, threads=1)


def test_ranks_join_one_gloo_group(ranks):
    assert [r["group"] for r in ranks] == [(0, 2, "cpu", "gloo"),
                                           (1, 2, "cpu", "gloo")]
    assert DataGroup(None, 0, 2, torch.device("cuda"), "nccl").capturable
    assert not DataGroup(None, 0, 2, torch.device("cuda"), "gloo").capturable


# ---------------------------------------------------------------------------
# collectives in the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bn1d", "bn2d"])
@pytest.mark.parametrize("masked", [False, True])
def test_synced_batchnorm_matches_jax_with_the_input_gradient(ranks, kind,
                                                               masked):
    """Outputs, running statistics and the input gradient of a train-mode
    BN over two ranks equal the JAX BN under ``shard_map`` with
    ``axis_name``.  The same BN with a sum that autograd does not see gives
    the same outputs but another input gradient: that is what the
    differentiable ``all_sum`` is for."""
    y, state, dx = jax_bn(kind, masked)
    np.testing.assert_allclose(gathered(ranks, (kind, masked), "y"), y,
                               atol=TOL, rtol=0)
    for r in ranks:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r[kind, masked][k], state[k],
                                       atol=TOL, rtol=0)
    np.testing.assert_allclose(gathered(ranks, (kind, masked), "grad"), dx,
                               atol=TOL, rtol=0)
    plain = (kind, masked, "plain")
    np.testing.assert_allclose(gathered(ranks, plain, "y"), y, atol=TOL,
                               rtol=0)
    assert np.abs(gathered(ranks, plain, "grad") - dx).max() > 100 * TOL


def test_make_global_batch_places_each_ranks_rows(ranks):
    """The ranks' shares in rank order are the global batch (the rows
    ``local_rows`` cuts); unequal row counts raise on every rank."""
    for i, want in enumerate((GLOBAL_FEATS, GLOBAL_LABELS)):
        got = np.concatenate([r["global_batch"]["arrays"][i] for r in ranks])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for r in ranks:
        assert "different row counts" in r["global_batch"]["mismatch"]
        assert "[[3], [2]]" in r["global_batch"]["mismatch"]


def test_remat_step_with_synced_batchnorm_equals_the_plain_step(ranks):
    """Under remat the recompute sums the BN statistics over the group
    again, as every rank does, but moves the running buffers once: loss,
    gradients and buffers equal the plain step's bit for bit on each
    rank."""
    for r in ranks:
        plain, remat = r["remat"][False], r["remat"][True]
        assert plain.keys() == remat.keys()
        for k in plain:
            assert torch.equal(plain[k], remat[k]), k
        assert int(remat["rnns.1.bn.count"]) == 1
    # the synchronised statistics: both ranks hold the same buffers
    assert torch.equal(ranks[0]["remat"][True]["rnns.1.bn.mean"],
                       ranks[1]["remat"][True]["rnns.1.bn.mean"])


def test_batch_max_and_input_sizes_take_the_global_max(ranks):
    """Each half's own max (16 and 13, the mask-0 row's 15 left out)
    differs; over the group both ranks see JAX's ``pmax``, 16."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ctc_pytorch_tpu.models.ctc_model import CTCModel as JModel
    from ctc_pytorch_tpu.models.ctc_model import ModelSpec as JSpec

    assert [r["bmax"][1] for r in ranks] == [16, 13]
    assert [r["bmax"][0] for r in ranks] == [16, 16]
    spec = small_spec()
    jspec = JSpec.from_dict(spec.to_dict())
    t_out = spec.output_time_len(16)
    data = P("data")
    f = jax_sharded(
        lambda fr, m: (JModel.batch_max_frames(fr, 16, m, "data")[1][None],
                       JModel.input_sizes(jspec, fr, 16, t_out, m, "data")),
        (data, data), (data, data))
    jmax, jsizes = f(jnp.asarray(BMAX_LENS / 16), jnp.asarray(BMAX_MASK))
    assert np.asarray(jmax).tolist() == [16, 16]
    np.testing.assert_array_equal(
        np.concatenate([r["sizes"][0] for r in ranks]), np.asarray(jsizes))
    # the local max gives other sizes on the second half: its 13-frame row
    # has 7 output frames of 7, against 6 of 8 in the global batch
    assert ranks[1]["sizes"][1][0] == 7 and ranks[1]["sizes"][0][0] == 6


def test_accumulate_cmvn_over_the_group_matches_jax_psum(ranks):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ctc_pytorch_tpu.frontend import cmvn as jcmvn

    feats, mask = cmvn_case()
    f = jax_sharded(
        lambda fs, ms: tuple(a[None] for a in jcmvn.accumulate_cmvn(
            jcmvn.init_cmvn(4), fs, ms, axis_name="data")),
        (P("data"), P("data")), (P(), P(), P()))
    want = [np.asarray(a)[0] for a in f(jnp.asarray(feats), jnp.asarray(mask))]
    host = cmvn.accumulate_cmvn(cmvn.init_cmvn(4), torch.from_numpy(feats),
                                torch.from_numpy(mask))
    for r in ranks:
        for got, w, h in zip(r["cmvn"], want, host):
            np.testing.assert_allclose(got, w, rtol=1e-5)
            np.testing.assert_allclose(got, h.numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# the sharded search and the mesh Recognizer (one process, no collective)
# ---------------------------------------------------------------------------

def test_sharded_beam_search_matches_the_unsplit_and_jax_sharded_search():
    import jax
    import jax.numpy as jnp

    from ctc_pytorch_tpu.decode.beam_device import (
        batched_beam_search_sharded as jsharded,
    )
    from ctc_pytorch_tpu_torch.decode.beam_device import (
        batched_beam_search,
        batched_beam_search_sharded,
    )

    rng = np.random.RandomState(3)
    b, t, c = 5, 12, 6  # an odd batch: one padded row on two devices
    probs = rng.dirichlet(np.ones(c) * 0.5, size=(b, t)).astype(np.float32)
    lengths = np.array([12, 7, 10, 3, 12], np.int32)
    lm = np.log(rng.dirichlet(np.ones(c), size=c)).astype(np.float32)
    kw = dict(beam_width=4, max_len=12, lm_alpha=0.3)
    p, n = torch.from_numpy(probs), torch.from_numpy(lengths)
    got = batched_beam_search_sharded(p, n, make_mesh(["cpu", "cpu"]),
                                      lm_table=torch.from_numpy(lm), **kw)
    want = batched_beam_search(p, n, lm_table=torch.from_numpy(lm), **kw)
    for g, w in zip(got, want):
        assert g.shape[0] == b
        assert torch.equal(g, w)
    from ctc_pytorch_tpu.parallel import make_mesh as jmake_mesh

    jgot = jsharded(jnp.asarray(probs), jnp.asarray(lengths),
                    jmake_mesh(jax.devices()[:2]), lm_table=jnp.asarray(lm),
                    **kw)
    for i in range(b):
        k = int(jgot[1][i])
        assert int(got[1][i]) == k
        assert got[0][i, :k].tolist() == np.asarray(jgot[0])[i, :k].tolist()
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jgot[2]), rtol=1e-5)


def mesh_recognizers(tmp_path, **kw):
    from tests.test_torch_api import fe, jfe

    from ctc_pytorch_tpu_torch.api import Recognizer
    from ctc_pytorch_tpu_torch.vocab import Vocab
    from tests.test_api import _mini_package

    pkg = _mini_package(tmp_path, jfe())
    vocab = Vocab.from_units(["aa", "bb"])
    return (pkg, vocab,
            Recognizer(pkg, vocab, frontend=fe(), device="cpu", **kw),
            Recognizer(pkg, vocab, frontend=fe(), device="cpu",
                       mesh=["cpu", "cpu"], **kw))


def test_mesh_recognizer_matches_single_device_and_jax_mesh(tmp_path):
    """``tests/test_api.py``'s mesh case: three utterances on a mesh of two
    (one padded row): the strings of the single-device ``Recognizer``, of
    the JAX one and of the JAX mesh one."""
    import jax

    from ctc_pytorch_tpu.api import Recognizer as JRecognizer
    from ctc_pytorch_tpu.parallel import make_mesh as jmake_mesh
    from tests.test_torch_api import jfe

    pkg, vocab, single, meshed = mesh_recognizers(tmp_path)
    rng = np.random.RandomState(3)
    wavs = [(rng.randn(n) * 500).astype(np.float32)
            for n in (8000, 5000, 6500)]
    want = single.recognize(wavs)
    assert meshed.recognize(wavs) == want
    assert JRecognizer(pkg, vocab, frontend=jfe()).recognize(wavs) == want
    jmesh = JRecognizer(pkg, vocab, frontend=jfe(),
                        mesh=jmake_mesh(jax.devices()[:2]))
    assert jmesh.recognize(wavs) == want
    assert meshed.recognize(wavs[:1]) == want[:1]


def test_mesh_recognizer_takes_the_whole_batch_max(tmp_path):
    """A known difference: under batchmax the JAX mesh ``Recognizer`` takes
    each shard's own max (``ctc_pytorch_tpu/api.py:71-80``); the port's
    shards take the whole batch's, so its mesh outputs are the
    single-device ones.  On a batch whose shards' maxima differ, the JAX
    mesh zeroes the second shard's frames past its own max after each BN,
    where its single-device path keeps the normalised padding up to the
    batch max, so the backward direction starts from other states and its
    log-probs differ from the single-device ones."""
    import jax
    import jax.numpy as jnp

    from ctc_pytorch_tpu.api import Recognizer as JRecognizer
    from ctc_pytorch_tpu.parallel import make_mesh as jmake_mesh
    from tests.test_torch_api import jfe

    pkg, vocab, single, meshed = mesh_recognizers(tmp_path)
    assert single.spec.pad_dynamics == "batchmax"
    rng = np.random.RandomState(9)
    lens = np.array([16000, 15000, 4000, 3000], np.int32)  # shard maxima differ
    batch = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = rng.randn(n) * 500
    args = (torch.from_numpy(batch), torch.from_numpy(lens))
    lp1, sizes1 = single._forward(*args)
    lp2, sizes2 = meshed._forward(*args)
    assert torch.equal(sizes1, sizes2)
    np.testing.assert_allclose(lp2.numpy(), lp1.numpy(), atol=1e-5, rtol=0)
    jsingle = JRecognizer(pkg, vocab, frontend=jfe())
    jmesh = JRecognizer(pkg, vocab, frontend=jfe(),
                        mesh=jmake_mesh(jax.devices()[:2]))
    jargs = (jnp.asarray(batch), jnp.asarray(lens))
    j1 = jsingle._forward(jsingle.params, jsingle.mstate, *jargs)
    j2 = jmesh._forward(jmesh.params, jmesh.mstate, *jargs)
    np.testing.assert_array_equal(np.asarray(j1[1]), sizes1.numpy())
    np.testing.assert_allclose(lp1.numpy(), np.asarray(j1[0]), atol=1e-4,
                               rtol=0)
    # the JAX mesh: the first shard holds the batch max, the second not
    first, second = np.asarray(j2[0])[:, :2], np.asarray(j2[0])[:, 2:]
    np.testing.assert_allclose(first, np.asarray(j1[0])[:, :2], atol=1e-4,
                               rtol=0)
    assert np.abs(second - np.asarray(j1[0])[:, 2:]).max() > 1e-3


def test_streaming_over_a_mesh_recognizer_matches_single_device(tmp_path):
    from ctc_pytorch_tpu_torch.api import StreamingRecognizer

    _, _, single, meshed = mesh_recognizers(tmp_path)
    wav = (np.random.RandomState(7).randn(9000) * 500).astype(np.float32)
    outs = []
    for rec in (single, meshed):
        sr = StreamingRecognizer(rec, window_seconds=4.0, hop_seconds=0.2,
                                 lookahead_seconds=0.2)
        for start in range(0, len(wav), 1600):
            sr.feed(wav[start:start + 1600])
        outs.append(sr.finish())
    assert outs[0] == outs[1]
