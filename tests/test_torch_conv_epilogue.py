"""The CNN's conv epilogue (``ops/conv_epilogue.py``) on the CPU: its plain
twin against the stack's previous chain of ops, the fused path's autograd
plumbing (its ``Function``s run the kernels' arithmetic in torch ops on CPU
tensors) against the plain twin, the route, and its launch counter beside
the recurrence counts.  The kernels themselves are held against the plain
twin on the card in ``tests/test_torch_cuda.py``."""

import sys
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from ctc_pytorch_tpu_torch.config import CNNConfig
from ctc_pytorch_tpu_torch.models.cnn import CNNStack
from ctc_pytorch_tpu_torch.models.layers import dropout
from ctc_pytorch_tpu_torch.ops import conv_epilogue as ce
from ctc_pytorch_tpu_torch.ops import launch_counts

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

ACTS = {"relu": torch.relu, "hardtanh": lambda x: torch.clamp(x, 0.0, 20.0),
        "tanh": torch.tanh}


def _previous_stack(stack, x, compute_dtype, t_valid, example_mask, group):
    """``CNNStack.forward`` as it was before the epilogue became an op, the
    reference the plain twin is held to (dropout at rate 0)."""
    cfg = stack.cfg
    x = x.to(compute_dtype)
    tv = t_valid
    rows = None
    if t_valid is not None and example_mask is not None:
        rows = (example_mask > 0).view(-1, 1, 1, 1)
    for i, layer in enumerate(stack):
        pad = cfg.padding[i]
        out = F.conv2d(x, layer.w.to(compute_dtype), stride=cfg.stride[i],
                       padding=pad)
        out = out + layer.b.to(compute_dtype).view(1, -1, 1, 1)
        mask = None
        if tv is not None:
            tv = torch.clamp(cfg.conv_out(i, tv, 0)[0], min=1)
            t_idx = torch.arange(out.shape[2], device=out.device)
            mask = (t_idx < tv).view(1, 1, -1, 1)
            if rows is not None:
                mask = mask & rows
        if layer.bn is not None:
            out = layer.bn(out, mask, group)
        out = ACTS[stack.act_name](out)
        pk = cfg.pool_at(i)
        if pk:
            out = F.max_pool2d(out, kernel_size=pk, stride=pk)
            if tv is not None:
                tv = torch.clamp((tv - pk[0]) // pk[0] + 1, min=1)
        if tv is not None:
            t_idx = torch.arange(out.shape[2], device=out.device)
            out = out * (t_idx < tv).to(out.dtype).view(1, 1, -1, 1)
        x = dropout(out, 0.0, None, stack.training)
    return x


def _cfg(act, pooling=None, recipe="flagship"):
    if recipe == "863":  # cnn_lstm_ctc.conf's one layer
        return CNNConfig(add_cnn=True, layers=1, channel=[(1, 4)],
                         kernel_size=[(11, 5)], stride=[(2, 2)],
                         padding=[(0, 0)], activation_function=act)
    return CNNConfig(add_cnn=True, layers=2, channel=[(1, 4), (4, 3)],
                     kernel_size=[(3, 3), (3, 3)], stride=[(1, 2), (2, 2)],
                     padding=[(1, 1), (1, 1)], pooling=pooling,
                     activation_function=act)


def _stacks(cfg, n=2, seed=0):
    """``n`` stacks with equal seeded weights, BN scale and shift off their
    identity start, and unit-ish running statistics."""
    gen = torch.Generator().manual_seed(seed)
    first = CNNStack(cfg)
    for layer in first:
        layer.reset_parameters(gen)
        with torch.no_grad():
            layer.bn.scale.uniform_(0.5, 1.5, generator=gen)
            layer.bn.bias.uniform_(-0.3, 0.3, generator=gen)
            layer.bn.mean.uniform_(-0.2, 0.2, generator=gen)
            layer.bn.var.uniform_(0.5, 2.0, generator=gen)
    out = [first]
    for _ in range(n - 1):
        other = CNNStack(cfg)
        other.load_state_dict(first.state_dict())
        out.append(other)
    return out


def _inputs(dtype, act, t=24, f=20, b=5, seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 1, t, f, generator=gen) * (4.0 if act == "hardtanh"
                                                   else 1.0)
    # the last real frame below t; row 3 repeat-padded
    return (x.to(dtype), torch.tensor(t - 5, dtype=torch.int32),
            torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0]))


def _step(stack, forward, x, train):
    """Output, every leaf's gradient and the input's, after a weighted sum
    of the output; then the buffers."""
    stack.train(train)
    x = x.clone().requires_grad_(True)
    y = forward(x)
    w = torch.linspace(-1.0, 1.0, y.numel()).view_as(y)
    (y.float() * w).sum().backward()
    grads = {n: p.grad.clone() for n, p in stack.named_parameters()}
    grads["x"] = x.grad.float()
    return y.float(), grads, {n: b.clone() for n, b in stack.named_buffers()}


def _fused(monkeypatch) -> list:
    """Send every layer down the fused route (its CPU arithmetic); the
    planes the route was asked about, one a layer call."""
    asked = []

    def route(out, *args, **kwargs):
        asked.append(tuple(out.shape))
        return True

    monkeypatch.setattr(ce, "fused_route", route)
    return asked


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("act", ["relu", "hardtanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_twin_matches_the_previous_stack(dtype, act, train):
    """Bit for bit: outputs, gradients of every leaf and of the input, and
    the running buffers, with a repeat-padded row and a tail cut."""
    new, old = _stacks(_cfg(act))
    x, tv, em = _inputs(dtype, act)
    before = dict(ce.launches_route)
    got = _step(new, lambda v: new(v, dtype, t_valid=tv, example_mask=em), x,
                train)
    want = _step(old, lambda v: _previous_stack(old, v, dtype, tv, em, None),
                 x, train)
    assert torch.equal(got[0], want[0])
    for part in (1, 2):
        for name, value in want[part].items():
            assert torch.equal(got[part][name], value), name
    assert ce.launches_route["plain"] == before["plain"] + 2
    assert ce.launches_route["fused_fwd"] == before["fused_fwd"]


@pytest.mark.parametrize("pooling,act", [([(2, 2), None], "relu"),
                                         (None, "tanh")])
def test_plain_twin_matches_the_previous_stack_off_the_route(pooling, act):
    """A pooled layer and ``tanh`` (never fused) through the twin."""
    new, old = _stacks(_cfg(act, pooling))
    x, tv, em = _inputs(torch.float32, act)
    got = _step(new, lambda v: new(v, torch.float32, t_valid=tv,
                                   example_mask=em), x, True)
    want = _step(old, lambda v: _previous_stack(old, v, torch.float32, tv, em,
                                                None), x, True)
    assert torch.equal(got[0], want[0])
    for name, value in want[1].items():
        assert torch.equal(got[1][name], value), name


def _held(got, want, conv_biases, atol_rel):
    """Each leaf within ``atol_rel`` of its largest entry.  The conv biases
    under BN get a gradient that is rounding alone (the BN takes the mean
    out), so they are held against the largest weight gradient of their
    layer."""
    for name, value in want.items():
        scale = value.abs().max()
        if name in conv_biases:
            scale = want[name[:-1] + "w"].abs().max()
        err = (got[name] - value).abs().max()
        assert err <= atol_rel * scale + 1e-30, (name, err.item(),
                                                 scale.item())


@pytest.mark.parametrize("recipe", ["flagship", "863"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("act", ["relu", "hardtanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_functions_match_the_plain_twin(monkeypatch, dtype, act, train,
                                              recipe):
    """The fused path's two ``Function``s and the ``(C,)`` chain between
    them, on the kernels' CPU arithmetic: outputs, every leaf's gradient,
    the input's and the running buffers against the plain twin."""
    cfg = _cfg(act, recipe=recipe)
    plain, fused = _stacks(cfg)
    x, tv, em = _inputs(dtype, act, t=30 if recipe == "863" else 24)
    want = _step(plain, lambda v: plain(v, dtype, t_valid=tv, example_mask=em),
                 x, train)
    asked = _fused(monkeypatch)
    before = dict(ce.launches_route)
    got = _step(fused, lambda v: fused(v, dtype, t_valid=tv, example_mask=em),
                x, train)
    layers = cfg.layers
    assert len(asked) == layers
    # the counter moves where a kernel launches: the CPU arithmetic none
    assert ce.launches_route == before
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    step = 2.0 ** (-23 if dtype == torch.float32 else -8)
    assert (got[0] - want[0]).abs().max() <= 2 * step * want[0].abs().max()
    biases = {f"{i}.b" for i in range(layers)}
    _held(got[1], want[1], biases, tol)
    _held(got[2], want[2], set(), 1e-6)


def test_fused_functions_without_a_tail_in_eval(monkeypatch):
    """Eval with no frame count (the 'padded' dynamics): no tail mask."""
    plain, fused = _stacks(_cfg("relu"))
    x, _, _ = _inputs(torch.float32, "relu")
    want = _step(plain, lambda v: plain(v, torch.float32), x, False)
    _fused(monkeypatch)
    got = _step(fused, lambda v: fused(v, torch.float32), x, False)
    assert torch.allclose(got[0], want[0], atol=1e-6, rtol=0)
    _held(got[1], want[1], {"0.b", "1.b"}, 1e-5)


def test_fused_functions_through_a_data_parallel_group(monkeypatch, tmp_path):
    """The statistics cross ``synced_sums``'s differentiable collective
    between the two ``Function``s: one gloo rank gives the ungrouped
    numbers."""
    import torch.distributed as dist

    from ctc_pytorch_tpu_torch.parallel.mesh import DataGroup

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        group = DataGroup(None, 0, 1, torch.device("cpu"), "gloo")
        alone, grouped = _stacks(_cfg("relu"))
        x, tv, em = _inputs(torch.float32, "relu")
        _fused(monkeypatch)
        want = _step(alone, lambda v: alone(v, torch.float32, t_valid=tv,
                                            example_mask=em), x, True)
        got = _step(grouped, lambda v: grouped(v, torch.float32, t_valid=tv,
                                               example_mask=em, group=group),
                    x, True)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got[0], want[0])
    for part in (1, 2):
        for name, value in want[part].items():
            assert torch.equal(got[part][name], value), name


def _plane(dtype, cuda=True):
    return types.SimpleNamespace(is_cuda=cuda, dtype=dtype)


def test_the_route_takes_the_recipes_layers_and_only_those():
    layer = _stacks(_cfg("relu"), n=1)[0][0]
    bare = types.SimpleNamespace(bn=None)
    tv = torch.tensor(7)
    bf16 = _plane(torch.bfloat16)
    assert ce.fused_route(bf16, layer, "relu", tv, None, True)
    assert ce.fused_route(_plane(torch.float32), layer, "hardtanh", tv, None,
                          True)
    assert ce.fused_route(bf16, layer, "relu", None, None, False)  # eval
    assert not ce.fused_route(_plane(torch.bfloat16, cuda=False), layer,
                              "relu", tv, None, True)
    assert not ce.fused_route(bf16, layer, "relu", tv, (2, 2), True)
    assert not ce.fused_route(bf16, layer, "tanh", tv, None, True)
    assert not ce.fused_route(bf16, bare, "relu", tv, None, True)
    assert not ce.fused_route(_plane(torch.float16), layer, "relu", tv, None,
                              True)
    # train mode without a frame count: unmasked statistics, the twin's
    assert not ce.fused_route(bf16, layer, "relu", None, None, True)


@pytest.mark.parametrize("pooling,act", [(None, "relu"),
                                         ([(2, 2), None], "relu"),
                                         (None, "tanh")])
def test_the_cpu_takes_the_plain_route(pooling, act):
    stack = _stacks(_cfg(act, pooling), n=1)[0].train()
    x, tv, em = _inputs(torch.float32, act)
    before = dict(ce.launches_route)
    stack(x, torch.float32, t_valid=tv, example_mask=em).sum().backward()
    assert ce.launches_route == dict(before, plain=before["plain"] + 2)


@pytest.mark.parametrize("fused", [False, True])
def test_the_route_counter_is_no_recurrence_launch(monkeypatch, fused):
    """``gpubench/program.py:recurrence_calls`` reads ints named
    ``launches``, ``launches_fwd``, ``launches_bwd``; the epilogue's dict
    moves and the recurrence count stays at 0.  The fused route's CPU
    arithmetic launches nothing, so its card counts are added as a graph
    replay adds them (``launch_counts.add``)."""
    from gpubench.program import recurrence_calls

    asked = _fused(monkeypatch) if fused else []
    stack = _stacks(_cfg("relu"), n=1)[0].train()
    x, tv, em = _inputs(torch.bfloat16, "relu")
    before = launch_counts.read()
    stack(x, torch.bfloat16, t_valid=tv, example_mask=em).float().sum(
        ).backward()
    key = ("conv_epilogue", "launches_route")
    if fused:
        assert len(asked) == 2 and launch_counts.read() == before
        launch_counts.add({key: {"fused_fwd": 2, "fused_bwd": 2}})
    after = launch_counts.read()
    launch_counts.restore(before)
    assert recurrence_calls(before, after) == (0, 0)
    moved = launch_counts.diff(after, before)
    want = ({"fused_fwd": 2, "fused_bwd": 2} if fused else {"plain": 2})
    assert moved == {key: want}


@pytest.mark.parametrize("fused", [False, True])
def test_chip_smoke_epilogue_phase_rehearsed_on_the_cpu(monkeypatch, fused):
    """``chip_smoke.py``'s phase-3 check of the epilogue at small shapes on
    the CPU: the twin on both sides, or the fused ``Function``s' CPU
    arithmetic against the twin (which ``plain_twins`` selects), within the
    phase's tolerances and with no launch counted."""
    import chip_smoke

    if fused:
        _fused(monkeypatch)
    route = ce.fused_route
    errs = chip_smoke.phase_conv_epilogue_vs_plain(
        chip_smoke.recipe_config(), "cpu",
        ((3, 40, "bfloat16"), (2, 30, "float32")))
    assert ce.fused_route is route  # plain_twins put it back
    for dname, worst in errs.items():
        out_tol, grad_tol = chip_smoke.EPILOGUE_TOL[dname]
        assert worst["output"] <= out_tol and worst["gradients"] <= grad_tol
        if not fused:  # the twin on both sides
            assert worst == {"output": 0.0, "gradients": 0.0, "buffers": 0.0}


def _operands():
    conv = torch.zeros(2, 3, 4, 8, dtype=torch.bfloat16)
    vec = torch.zeros(3)
    return conv, vec, torch.tensor(3, dtype=torch.int32), torch.ones(
        2, dtype=torch.bool)


@pytest.mark.parametrize("bad", ["plane_dtype", "dy_shape", "dy_strides",
                                 "vector_dtype", "vector_shape", "tv_dtype",
                                 "rows_shape"])
def test_the_launchers_check_their_operands(bad):
    """What the kernels cannot take raises before a pointer is passed."""
    conv, vec, tv, rows = _operands()
    assert len(ce._checked(conv, (conv.clone(),), (vec, None), tv, rows)) == 2
    dy, vectors = conv.clone(), (vec,)
    if bad == "plane_dtype":
        conv, dy = conv.half(), dy.half()
    elif bad == "dy_shape":
        dy = dy[:, :2].contiguous()
    elif bad == "dy_strides":
        dy = dy.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "vector_dtype":
        vectors = (vec.double(),)
    elif bad == "vector_shape":
        vectors = (torch.zeros(4),)
    elif bad == "tv_dtype":
        tv = tv.long()
    else:
        rows = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError):
        ce._checked(conv, (dy,), vectors, tv, rows)
