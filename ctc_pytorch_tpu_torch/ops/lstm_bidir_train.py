"""Trainable bidirectional LSTM recurrence: two Hopper kernels (forward and
backward) and their plain twins, joined in one ``torch.autograd.Function``.

Replaces ``ctc_pytorch_tpu/ops/lstm_pallas_train_v2.py:lstm_scan_train_v2``
(forward ``_fwd_pallas``, backward ``_bwd_pallas``).  ``lstm_bidir_train(gx,
w_hh)`` takes the hoisted input projection ``gx (T, B, 8H)`` in the stream
dtype S (lanes ``[0, 4H)`` forward, ``[4H, 8H)`` backward direction) and
``w_hh (2, H, 4H)`` fp32 and returns ``ys (T, B, 2H)`` in S; h0 = c0 = 0.  A
unidirectional layer passes one direction (``gx (T, B, 4H)``, ``w_hh (1, H,
4H)``, ``ys (T, B, H)``) to the same kernels.

Rounding points, the JAX training kernels' (they differ from the eval
kernel's): with bf16 streams ``w_hh`` is rounded to bf16, each h is rounded to
bf16 before the recurrent product (it is the stored ``ys`` row), ``ys``, the
cell states ``cs`` and ``dgx`` are stored in bf16, and ``dpre`` is rounded to
bf16 before ``dpre @ w_hh^T``.  Carries (h, c, dh, dc), gate math and sums are
fp32.  With fp32 streams everything is fp32.

The backward is the hoisted form of the JAX kernel, in two launches: a gate
pre-pass over every (t, b, direction) at once (``h_prev @ w_hh`` with
``h_prev`` read from the saved ``ys``, the gates and their Jacobians folded
with ``cs`` into six fp32 factor planes ``[A | Gi | Gf | Gg | Go | F]``), then
the serial chain over those planes, which carries ``(dh, dc)`` and emits
``dgx``.  ``dW_hh`` is formed here, outside the kernels, as two plain GEMMs of
shifted ``ys`` against ``dgx`` (as the JAX package forms it outside Pallas);
the input projection and its gradients belong to the caller's
``torch.matmul``.

The serial chain has four branches, which the launcher chooses by shape
and reports (``launches_bwd_branch``).  Two are a thread-block cluster per
direction and slice of batch rows, with the rows of ``w_hh`` that each
CTA's gate columns meet resident in its shared memory and the partial dh
exchanged in distributed shared memory: with bf16 streams and H <= 416,
16 or 32 rows a cluster and the step product on the tensor cores
(``cluster16``, ``cluster32``); with fp32 streams and H <= 432, 16 rows a
cluster of 8 or 16 CTAs and the product in fp32 on CUDA cores
(``cluster16_fp32``: the recipes' batch of 8).  With fp32 streams where
those clusters do not all fit (B >= 64) the wide branch (``wide_fp32``,
``csrc/bwd_wide.cuh``): one CTA an SM, the same split of the contraction,
the product in 3xTF32 on the tensor cores and the partial dh exchanged
through L2 under step flags.  Every other shape (H past the bounds) takes
the persistent cooperative grid, fp32 products on CUDA cores
(``csrc/bwd_hoist.cuh``, ``csrc/lstm_bidir_train.cu``).  The grid and the
wide branch take global scratch.  The forward has
branches of its own, chosen and reported the same way
(``launches_fwd_branch``): a thread-block cluster per direction and 16 or 32
batch rows with ``w_hh`` resident across it and h exchanged in distributed
shared memory, its step product on the tensor cores with bf16 streams and
on CUDA cores in fp32 with fp32 streams (``csrc/fwd_cluster.cuh``); where
those clusters do not hold the shape, the wide branch (``csrc/fwd_wide.cuh``:
one CTA an SM, ``w_hh`` resident, h exchanged through L2 under step flags):
``wide_fp32`` on fp32 streams (B = 128; the product in 3xTF32 on the tensor
cores) and ``wide_bf16`` on bf16 streams (H past the bf16 clusters' bound,
DeepSpeech2's H = 1024 at B = 64: ``w_hh`` resident as bf16, the product
in bf16 ``mma.sync`` m16n8k16 with fp32 sums, h exchanged as bf16); or the
cooperative grid where neither holds the shape.  With bf16 streams the products' operands
are bf16 values, so the card's limit for the work is its bytes; with fp32
streams it is the fp32 operations.  Any T >= 1, B >= 1 and H run, with no
padding of the caller's tensors.

CPU tensors take the plain twins; a CUDA tensor launches the kernels or the
call raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ctc_pytorch_tpu_torch.ops._build import (
    FWD_BRANCHES,
    KernelLibrary,
    acc_dtype as _acc_dtype,
    check_plane,
    BRANCHES,
    check_recurrence,
    check_serial,
    device_kind,
    launch_forward,
    padded_planes,
    prepass_weights,
    per_direction,
    serial_scratch,
    shifted,
    step_times,
)

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "lstm_bidir_train.cu",
    {"lstm_bidir_train_fwd_branch": ([_CI] * 4 + [ctypes.POINTER(_CI)], _CI),
     "lstm_bidir_train_forward": (
         [_VP] * 6 + [_CI] * 6 + [_VP, ctypes.POINTER(_CI)], _CI),
     "lstm_bidir_train_bwd_prepass": ([_VP] * 5 + [_CI] * 6 + [_VP], _CI),
     "lstm_bidir_train_bwd_branch": ([_CI] * 4 + [ctypes.POINTER(_CI)], _CI),
     "lstm_bidir_train_bwd_wide_scratch": (
         [_CI] * 3 + [ctypes.POINTER(ctypes.c_size_t)] * 2, _CI),
     "lstm_bidir_train_backward": (
         [_VP] * 7 + [_CI] * 7 + [_VP, ctypes.POINTER(_CI)], _CI),
     "lstm_bidir_train_error_string": ([_CI], ctypes.c_char_p)},
    headers=["lstm_fwd.cuh", "bwd_hoist.cuh", "bwd_wide.cuh", "gru_fwd.cuh",
             "fwd_wide.cuh", "fwd_cluster.cuh"])

PLANES = 6  # the pre-pass planes [A | Gi | Gf | Gg | Go | F]

# kernel launches made through ``lstm_bidir_train`` and its backward (one
# pre-pass and one serial launch per backward); the plain path adds nothing
launches_fwd = 0
launches_bwd_prepass = 0
# of them on fp32 streams: prepass_tf32_kernel (csrc/bwd_hoist.cuh)
launches_bwd_prepass_tf32 = 0
launches_bwd = 0
# forward and serial launches by the branch the launcher reported
launches_fwd_branch = dict.fromkeys(FWD_BRANCHES, 0)
launches_bwd_branch = dict.fromkeys(BRANCHES, 0)
# serial time steps of those launches, forward and backward apart (T a
# launch; the backward's pre-pass has none)
launches_steps = {"fwd": 0, "bwd": 0}


def _gates(pre: torch.Tensor):
    i, f, g, o = pre.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def dw_hh(ys: torch.Tensor, dgx: torch.Tensor, ndir: int = 2) -> torch.Tensor:
    """``dW_hh (ndir, H, nH)`` fp32 from the saved outputs ``ys (T, B, ndir *
    H)`` and ``dgx (T, B, ndir * nH)``, for any gate count n (the tanh cell's
    op uses it with n = 1): direction 0 pairs ``ys[t-1]`` with ``dpre[t]``,
    direction 1 ``ys[t+1]`` with ``dpre[t]``; operands in the stream dtype,
    sums in fp32."""
    t_len = ys.shape[0]
    h, nh = ys.shape[-1] // ndir, dgx.shape[-1] // ndir
    acc = _acc_dtype(ys.dtype)
    if t_len == 1:
        return torch.zeros(ndir, h, nh, dtype=acc, device=ys.device)

    def gemm(a, b):  # (N, H)^T @ (N, nH)
        a, b = a.reshape(-1, h).t(), b.reshape(-1, nh)
        if a.dtype == torch.bfloat16 and a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a.to(acc), b.to(acc))

    pairs = [(ys[:-1, :, :h], dgx[1:, :, :nh]),
             (ys[1:, :, h:], dgx[:-1, :, nh:])]
    return torch.stack([gemm(a, b) for a, b in pairs[:ndir]])


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def lstm_bidir_train_plain(gx: torch.Tensor, w_hh: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: ``(ys, cs)``, both
    ``(T, B, ndir * H)`` in the stream dtype."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    sd, acc = gx.dtype, _acc_dtype(gx.dtype)
    w = w_hh.to(sd).to(acc)
    hs = torch.zeros(ndir, b, h, dtype=acc, device=gx.device)
    c = torch.zeros_like(hs)
    ys = torch.empty(t_len, b, ndir * h, dtype=sd, device=gx.device)
    cs = torch.empty_like(ys)
    for s in range(t_len):
        times = step_times(t_len, ndir, s)
        pre = torch.stack([gx[t, :, 4 * d * h:4 * (d + 1) * h]
                           for d, t in enumerate(times)]).to(acc)
        i, f, g, o = _gates(pre + torch.bmm(hs, w))
        c = f * c + i * g
        hn = (o * torch.tanh(c)).to(sd)
        hs = hn.to(acc)  # the next product reads h as ys holds it
        for d, t in enumerate(times):
            ys[t, :, d * h:(d + 1) * h] = hn[d]
            cs[t, :, d * h:(d + 1) * h] = c[d].to(sd)
    return ys, cs


def lstm_bidir_train_bwd_prepass_plain(gx, w_hh, ys, cs) -> torch.Tensor:
    """The pre-pass kernel's function in plain PyTorch: the carry-free
    factor planes ``(ndir, T, 6, B, H)`` in the carries' dtype, ``[A | Gi |
    Gf | Gg | Go | F]`` of every step, indexed by forward time (the JAX
    ``_lstm_prepass``, which stores them in step order)."""
    ndir = w_hh.shape[0]
    acc = _acc_dtype(gx.dtype)
    w = w_hh.to(gx.dtype).to(acc)
    h_prev, c_prev = shifted(ys, ndir, acc), shifted(cs, ndir, acc)
    # one product a direction over every (step, row): a broadcast of w over
    # the steps would copy it T times
    pre = per_direction(gx, ndir).to(acc) + torch.bmm(
        h_prev.flatten(1, 2), w).view(*h_prev.shape[:3], -1)
    i, f, g, o = _gates(pre)
    tc = torch.tanh(per_direction(cs, ndir).to(acc))
    return torch.stack([
        o * (1.0 - tc * tc),        # A: dct = dc + dh_t A
        g * (i * (1.0 - i)),        # Gi: dpre_i = dct Gi
        c_prev * (f * (1.0 - f)),   # Gf: dpre_f = dct Gf
        i * (1.0 - g * g),          # Gg: dpre_g = dct Gg
        tc * (o * (1.0 - o)),       # Go: dpre_o = dh_t Go
        f,                          # F: dc_prev = dct F
    ], dim=2)


def lstm_bidir_train_bwd_serial_plain(planes, w_hh, dy) -> torch.Tensor:
    """The serial kernel's function in plain PyTorch, over the pre-pass
    planes: ``dgx (T, B, ndir * 4H)`` in ``dy``'s dtype, rounded where the
    kernel rounds (``dpre`` before ``@ w_hh^T``)."""
    ndir, t_len, _, b, h = planes.shape
    sd, acc = dy.dtype, planes.dtype
    wt = w_hh.to(sd).to(acc).transpose(1, 2)
    dy_d = per_direction(dy, ndir)
    dh = torch.zeros(ndir, b, h, dtype=acc, device=dy.device)
    dc = torch.zeros_like(dh)
    dgx = torch.empty(t_len, b, ndir * 4 * h, dtype=sd, device=dy.device)
    for s in range(t_len):
        # direction 0 walks back, direction 1 forth
        times = step_times(t_len, ndir, t_len - 1 - s)
        a, gi, gf, gg, go, f = torch.stack(
            [planes[d, t] for d, t in enumerate(times)]).unbind(1)
        dh_t = torch.stack([dy_d[d, t] for d, t in enumerate(times)]).to(acc) + dh
        dct = dc + dh_t * a
        dpre = torch.cat([dct * gi, dct * gf, dct * gg, dh_t * go],
                         dim=-1).to(sd)
        for d, t in enumerate(times):
            dgx[t, :, 4 * d * h:4 * (d + 1) * h] = dpre[d]
        dh = torch.bmm(dpre.to(acc), wt)
        dc = dct * f
    return dgx


def lstm_bidir_train_backward_plain(gx, w_hh, ys, cs, dy) -> torch.Tensor:
    """The backward's function in plain PyTorch, written out by hand in the
    kernels' hoisted arithmetic (not autograd of the forward): ``dgx (T, B,
    ndir * 4H)`` in the stream dtype."""
    return lstm_bidir_train_bwd_serial_plain(
        lstm_bidir_train_bwd_prepass_plain(gx, w_hh, ys, cs), w_hh, dy)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _raise(lib, err: int, what: str, t_len: int, b: int, h: int) -> None:
    msg = lib.lstm_bidir_train_error_string(err).decode()
    raise RuntimeError(f"{what} kernel launch failed ({err}: {msg}) at "
                       f"T={t_len} B={b} H={h}")


def lstm_bidir_train_cuda(gx: torch.Tensor, w_hh: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream: ``(ys, cs)`` in the
    stream dtype.  Does not synchronise."""
    global launches_fwd
    t_len, b, h, ndir = check_recurrence(gx, w_hh, 4)
    gx = gx.contiguous()
    w = w_hh.to(gx.dtype).float().contiguous()  # rounded to the stream dtype
    lib = LIBRARY.load()
    with torch.cuda.device(gx.device):
        ys = torch.empty(t_len, b, ndir * h, dtype=gx.dtype, device=gx.device)
        cs = torch.empty_like(ys)
        # the grid branch's c scratch, (direction, B, H)
        branch = launch_forward(lib, "lstm_bidir_train", gx, w, [ys, cs],
                                t_len, b, h, ndir, [(ndir, b, h)])
    launches_fwd += 1
    launches_fwd_branch[branch] += 1
    launches_steps["fwd"] += t_len
    return ys, cs


def _launch_prepass(lib, gx, w_hh, ys, cs, ndir, h) -> torch.Tensor:
    w = prepass_weights(w_hh, gx.dtype)
    global launches_bwd_prepass, launches_bwd_prepass_tf32
    t_len, b = gx.shape[:2]
    hp = -(-h // 4) * 4  # rows padded for the serial kernel's 16-byte loads
    planes = torch.empty(ndir, t_len, PLANES, b, hp, dtype=torch.float32,
                         device=gx.device)
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    err = lib.lstm_bidir_train_bwd_prepass(
        gx.data_ptr(), w.data_ptr(), ys.data_ptr(), cs.data_ptr(),
        planes.data_ptr(), t_len, b, h, hp, ndir,
        int(gx.dtype == torch.bfloat16), stream)
    if err != 0:
        _raise(lib, err, "lstm_bidir_train backward pre-pass", t_len, b, h)
    launches_bwd_prepass += 1
    if gx.dtype != torch.bfloat16:
        launches_bwd_prepass_tf32 += 1
    return planes


def _launch_serial(lib, planes, hp, w, dy, ndir, h) -> torch.Tensor:
    global launches_bwd
    t_len, b = dy.shape[:2]
    bf16 = int(dy.dtype == torch.bfloat16)
    dgx = torch.empty(t_len, b, ndir * 4 * h, dtype=dy.dtype, device=dy.device)
    branch = ctypes.c_int(-1)
    err = lib.lstm_bidir_train_bwd_branch(b, h, ndir, bf16, ctypes.byref(branch))
    if err != 0:
        _raise(lib, err, "lstm_bidir_train backward branch", t_len, b, h)
    ldh = -(-b // 4) * 4
    # the grid's dpre double buffer (4H rows), dh and dc scratch; the wide
    # branch's exchange buffer and flags
    scratch = serial_scratch(lib, "lstm_bidir_train", BRANCHES[branch.value],
                             b, h, ndir, 4 * h, dy.device)
    if BRANCHES[branch.value] == "grid":
        scratch.append(torch.zeros_like(scratch[1]))
    ptrs = [x.data_ptr() for x in scratch] + [None] * (3 - len(scratch))
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    err = lib.lstm_bidir_train_backward(
        planes.data_ptr(), w.data_ptr(), dy.data_ptr(), dgx.data_ptr(), *ptrs,
        t_len, b, h, hp, ldh, ndir, bf16, stream, ctypes.byref(branch))
    if err != 0:
        _raise(lib, err, "lstm_bidir_train backward", t_len, b, h)
    launches_bwd += 1
    launches_bwd_branch[BRANCHES[branch.value]] += 1
    launches_steps["bwd"] += t_len
    return dgx


def lstm_bidir_train_bwd_prepass_cuda(gx, w_hh, ys, cs) -> torch.Tensor:
    """Launch the pre-pass kernel on the current stream: the planes ``(ndir,
    T, 6, B, H)`` fp32 (a view of the padded buffer the serial kernel
    reads).  Does not synchronise."""
    t_len, b, h, ndir = check_recurrence(gx, w_hh, 4)
    for name, plane in (("ys", ys), ("cs", cs)):
        check_plane(name, plane, gx, ndir * h)
    gx, ys, cs = (p.contiguous() for p in (gx, ys, cs))
    with torch.cuda.device(gx.device):
        planes = _launch_prepass(LIBRARY.load(), gx, w_hh, ys, cs, ndir, h)
    return planes[..., :h]


def lstm_bidir_train_bwd_serial_cuda(planes, w_hh, dy) -> torch.Tensor:
    """Launch the serial kernel on the current stream over the planes
    ``(ndir, T, 6, B, H)`` fp32: ``dgx`` in ``dy``'s dtype.  Does not
    synchronise."""
    ndir, t_len, b, h = check_serial(planes, w_hh, dy, PLANES, 4)
    buf, hp = padded_planes(planes)
    w = w_hh.to(dy.dtype).float().contiguous()
    with torch.cuda.device(dy.device):
        return _launch_serial(LIBRARY.load(), buf, hp, w, dy.contiguous(),
                              ndir, h)


def lstm_bidir_train_backward_cuda(gx, w_hh, ys, cs, dy) -> torch.Tensor:
    """Launch the backward on the current stream, the pre-pass and then the
    serial kernel: ``dgx`` in the stream dtype.  Does not synchronise."""
    t_len, b, h, ndir = check_recurrence(gx, w_hh, 4)
    for name, plane in (("ys", ys), ("cs", cs), ("dy", dy)):
        check_plane(name, plane, gx, ndir * h)
    gx, ys, cs, dy = (p.contiguous() for p in (gx, ys, cs, dy))
    w = w_hh.to(gx.dtype).float().contiguous()  # rounded to the stream dtype
    lib = LIBRARY.load()
    with torch.cuda.device(gx.device):
        planes = _launch_prepass(lib, gx, w_hh, ys, cs, ndir, h)
        return _launch_serial(lib, planes, planes.shape[-1], w, dy, ndir, h)


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

class _LstmBidirTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gx, w_hh):
        if device_kind(gx, "lstm_bidir_train") == "cuda":
            ys, cs = lstm_bidir_train_cuda(gx, w_hh)
        else:
            ys, cs = lstm_bidir_train_plain(gx, w_hh)
        ctx.save_for_backward(gx, w_hh, ys, cs)
        return ys

    @staticmethod
    def backward(ctx, dy):
        gx, w_hh, ys, cs = ctx.saved_tensors
        dy = dy.to(gx.dtype)
        if device_kind(gx, "lstm_bidir_train") == "cuda":
            dgx = lstm_bidir_train_backward_cuda(gx, w_hh, ys, cs, dy)
        else:
            dgx = lstm_bidir_train_backward_plain(gx, w_hh, ys, cs, dy)
        return dgx, dw_hh(ys, dgx, w_hh.shape[0]).to(w_hh.dtype)


def lstm_bidir_train(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, B, ndir * 4H) stream-dtype gates + (ndir, H, 4H) weights -> ``ys``
    (T, B, ndir * H) in the stream dtype, differentiable in both arguments.

    CUDA tensors launch the kernels (forward here, backward under
    ``.backward()``); CPU tensors run the plain twins."""
    return _LstmBidirTrain.apply(gx, w_hh)
