"""Trainable bidirectional GRU recurrence: the Hopper forward and backward
kernels and their plain twins, joined in one ``torch.autograd.Function``.

Replaces ``ctc_pytorch_tpu/ops/gru_pallas_v2.py:gru_scan_train_v2`` (forward
``_fwd_pallas``, backward ``_bwd_pallas``, the un-hoisted step).
``gru_bidir_train(gx, w_hh)`` takes the hoisted input projection ``gx (T, B,
6H)`` in the stream dtype S (lanes ``[0, 3H)`` forward, ``[3H, 6H)`` backward
direction, gate order r, z, n) and ``w_hh (2, H, 3H)`` fp32 and returns ``ys
(T, B, 2H)`` in S; h0 = 0.  A unidirectional layer passes one direction
(``gx (T, B, 3H)``, ``w_hh (1, H, 3H)``) to the same kernels.

The forward is the eval op's function and kernel (``ops/gru_bidir.py``,
``csrc/gru_bidir.cu``: a GRU saves nothing but ``ys``, and in the JAX package
too one ``_fwd_pallas`` serves both), with a launch count of its own.  The
backward is the hoisted form of the JAX kernel, in two launches: a gate
pre-pass over every (t, b, direction) at once (``hh = h_prev @ w_hh`` with
``h_prev`` read from the saved ``ys``, in S, used both in the product and in
``P_z``; the gates and their Jacobians folded into five fp32 factor planes
``[P_r | P_z | P_n | P_hn | Z]``), then the serial chain over those planes,
which carries ``dh`` in fp32 and emits two planes in S: ``dgx (T, B, 6H) =
[dpre_r | dpre_z | dpre_n]`` per direction and ``dhhn (T, B, 2H) = dpre_n *
r``, the gradient of the n gate's recurrent branch (the n gate sees ``r * (h
W_n)``).  ``[dpre_r, dpre_z, dhh_n]`` is rounded to S before ``@ w_hh^T``;
``dh_t * z`` is added in fp32.  ``dW_hh = [hp^T dpre_r | hp^T dpre_z | hp^T
dhh_n]`` is formed here, outside the kernels, as plain GEMMs (as the JAX
package forms it outside Pallas); the input projection and its gradients
belong to the caller's ``torch.matmul``.

The forward's branches are the eval op's, counted here by the branch the
library reported (``launches_fwd_branch``; with fp32 streams at B = 128 the
wide branch, ``wide_fp32``, and with bf16 streams past the bf16 clusters'
bound its bf16 form, ``wide_bf16``).  The serial chain has four branches, which
the launcher chooses by shape and reports (``launches_bwd_branch``): with
bf16 streams and H <= 480 a thread-block cluster per (direction, 16 or 32
batch rows) runs its step product on the tensor cores and exchanges it in
distributed shared memory (``cluster16``, ``cluster32``); with fp32 streams
(B = 8, the 863 GRU recipe over two data-parallel ranks) a cluster of 8 or
16 CTAs per (direction, 16 rows) does it in fp32 FMA (``cluster16_fp32``,
H <= 500, where all its clusters fit at once); with fp32 streams where
those clusters do not all fit (B = 128) the wide branch (``wide_fp32``,
``csrc/bwd_wide.cuh``: one CTA an SM with its gate columns' rows of
``w_hh`` resident, the product in 3xTF32 on the tensor cores, the partial
dh exchanged through L2 under step flags); every other shape takes the
persistent cooperative grid, fp32 products on CUDA cores
(``csrc/bwd_hoist.cuh``, ``csrc/gru_bidir_train.cu`` count the limits).  Any
T >= 1, B >= 1 and H run, with no padding of the caller's tensors.

CPU tensors take the plain twins; a CUDA tensor launches the kernels or the
call raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
from ctc_pytorch_tpu_torch.ops._build import (
    BRANCHES,
    FWD_BRANCHES,
    KernelLibrary,
    acc_dtype,
    check_plane,
    check_serial,
    device_kind,
    padded_planes,
    prepass_weights,
    per_direction,
    serial_scratch,
    shifted,
    step_times,
)

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "gru_bidir_train.cu",
    {"gru_bidir_train_bwd_prepass": ([_VP] * 4 + [_CI] * 6 + [_VP], _CI),
     "gru_bidir_train_bwd_branch": ([_CI] * 4 + [ctypes.POINTER(_CI)], _CI),
     "gru_bidir_train_bwd_wide_scratch": (
         [_CI] * 3 + [ctypes.POINTER(ctypes.c_size_t)] * 2, _CI),
     "gru_bidir_train_backward": (
         [_VP] * 7 + [_CI] * 7 + [_VP, ctypes.POINTER(_CI)], _CI),
     "gru_bidir_train_error_string": ([_CI], ctypes.c_char_p)},
    headers=["lstm_fwd.cuh", "gru_fwd.cuh", "bwd_hoist.cuh", "bwd_wide.cuh"])

PLANES = 5  # the pre-pass planes [P_r | P_z | P_n | P_hn | Z]

# kernel launches made through ``gru_bidir_train`` and its backward (one
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


def dw_hh(ys: torch.Tensor, dgx: torch.Tensor, dhhn: torch.Tensor,
          ndir: int = 2) -> torch.Tensor:
    """``dW_hh (ndir, H, 3H)`` fp32 from the saved outputs and the backward's
    two planes: direction 0 pairs ``ys[t-1]`` with step t, direction 1
    ``ys[t+1]`` with step t; the r and z blocks come from ``dgx``, the n block
    from ``dhhn``.  Operands in the stream dtype, sums in fp32."""
    t_len = ys.shape[0]
    h = ys.shape[-1] // ndir
    acc = acc_dtype(ys.dtype)
    if t_len == 1:
        return torch.zeros(ndir, h, 3 * h, dtype=acc, device=ys.device)

    def gemm(hp, drz, dn):  # (N, H)^T @ [(N, 2H) | (N, H)]
        a = hp.reshape(-1, h).t()
        b = torch.cat([drz, dn], dim=-1).reshape(-1, 3 * h)
        if a.dtype == torch.bfloat16 and a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a.to(acc), b.to(acc))

    pairs = [(ys[:-1, :, :h], dgx[1:, :, :2 * h], dhhn[1:, :, :h]),
             (ys[1:, :, h:], dgx[:-1, :, 3 * h:5 * h], dhhn[:-1, :, h:])]
    return torch.stack([gemm(*p) for p in pairs[:ndir]])


def gru_bidir_train_bwd_prepass_plain(gx, w_hh, ys) -> torch.Tensor:
    """The pre-pass kernel's function in plain PyTorch: the carry-free
    factor planes ``(ndir, T, 5, B, H)`` in the carries' dtype, ``[P_r | P_z
    | P_n | P_hn | Z]`` of every step, indexed by forward time (the JAX
    pre-pass stores them in step order)."""
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    acc = acc_dtype(gx.dtype)
    w = w_hh.to(gx.dtype).to(acc)
    h_prev = shifted(ys, ndir, acc)
    hh = torch.matmul(h_prev, w[:, None])
    hh_n = hh[..., 2 * h:]
    r, z, n = gru_ops.gru_gates(per_direction(gx, ndir).to(acc), hh)
    p_n = (1.0 - z) * (1.0 - n * n)
    return torch.stack([
        p_n * hh_n * (r * (1.0 - r)),      # P_r: dpre_r = dh_t P_r
        (h_prev - n) * (z * (1.0 - z)),    # P_z: dpre_z = dh_t P_z
        p_n,                               # P_n: dpre_n = dh_t P_n
        p_n * r,                           # P_hn: dhh_n = dh_t P_hn
        z,                                 # Z: dh_prev gets dh_t Z
    ], dim=2)


def gru_bidir_train_bwd_serial_plain(planes, w_hh, dy
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serial kernel's function in plain PyTorch, over the pre-pass
    planes: ``(dgx (T, B, ndir * 3H), dhhn (T, B, ndir * H))`` in ``dy``'s
    dtype, rounded where the kernel rounds (``[dpre_r, dpre_z, dhh_n]``
    before ``@ w_hh^T``)."""
    ndir, t_len, _, b, h = planes.shape
    sd, acc = dy.dtype, planes.dtype
    wt = w_hh.to(sd).to(acc).transpose(1, 2)
    dy_d = per_direction(dy, ndir)
    dh = torch.zeros(ndir, b, h, dtype=acc, device=dy.device)
    dgx = torch.empty(t_len, b, ndir * 3 * h, dtype=sd, device=dy.device)
    dhhn = torch.empty(t_len, b, ndir * h, dtype=sd, device=dy.device)
    for s in range(t_len):
        # direction 0 walks back, direction 1 forth
        times = step_times(t_len, ndir, t_len - 1 - s)
        p_r, p_z, p_n, p_hn, z = torch.stack(
            [planes[d, t] for d, t in enumerate(times)]).unbind(1)
        dh_t = torch.stack([dy_d[d, t] for d, t in enumerate(times)]).to(acc) + dh
        dpre = torch.cat([dh_t * p_r, dh_t * p_z, dh_t * p_n], dim=-1).to(sd)
        dhh_n = (dh_t * p_hn).to(sd)
        for d, t in enumerate(times):
            dgx[t, :, 3 * d * h:3 * (d + 1) * h] = dpre[d]
            dhhn[t, :, d * h:(d + 1) * h] = dhh_n[d]
        dhh = torch.cat([dpre[..., :2 * h], dhh_n], dim=-1).to(acc)
        dh = torch.bmm(dhh, wt) + dh_t * z
    return dgx, dhhn


def gru_bidir_train_backward_plain(gx, w_hh, ys, dy
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's function in plain PyTorch, written out by hand in the
    kernels' hoisted arithmetic (not autograd of the forward): ``(dgx (T, B,
    ndir * 3H), dhhn (T, B, ndir * H))`` in the stream dtype."""
    return gru_bidir_train_bwd_serial_plain(
        gru_bidir_train_bwd_prepass_plain(gx, w_hh, ys), w_hh, dy)


def gru_bidir_train_cuda(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel (the eval op's) on the current stream:
    ``ys`` in the stream dtype.  Does not synchronise."""
    global launches_fwd
    ys, branch = gru_ops.launch_forward(gx, w_hh)
    launches_fwd += 1
    launches_fwd_branch[branch] += 1
    launches_steps["fwd"] += ys.shape[0]
    return ys


def _raise(lib, err: int, what: str, t_len: int, b: int, h: int) -> None:
    msg = lib.gru_bidir_train_error_string(err).decode()
    raise RuntimeError(f"{what} kernel launch failed ({err}: {msg}) at "
                       f"T={t_len} B={b} H={h}")


def _launch_prepass(lib, gx, w_hh, ys, ndir, h) -> torch.Tensor:
    w = prepass_weights(w_hh, gx.dtype)
    global launches_bwd_prepass, launches_bwd_prepass_tf32
    t_len, b = gx.shape[:2]
    hp = -(-h // 4) * 4  # rows padded for the serial kernel's 16-byte loads
    planes = torch.empty(ndir, t_len, PLANES, b, hp, dtype=torch.float32,
                         device=gx.device)
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    err = lib.gru_bidir_train_bwd_prepass(
        gx.data_ptr(), w.data_ptr(), ys.data_ptr(), planes.data_ptr(), t_len,
        b, h, hp, ndir, int(gx.dtype == torch.bfloat16), stream)
    if err != 0:
        _raise(lib, err, "gru_bidir_train backward pre-pass", t_len, b, h)
    launches_bwd_prepass += 1
    if gx.dtype != torch.bfloat16:
        launches_bwd_prepass_tf32 += 1
    return planes


def _launch_serial(lib, planes, hp, w, dy, ndir, h
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches_bwd
    t_len, b = dy.shape[:2]
    bf16 = int(dy.dtype == torch.bfloat16)
    dgx = torch.empty(t_len, b, ndir * 3 * h, dtype=dy.dtype, device=dy.device)
    dhhn = torch.empty_like(dy)
    branch = ctypes.c_int(-1)
    err = lib.gru_bidir_train_bwd_branch(b, h, ndir, bf16, ctypes.byref(branch))
    if err != 0:
        _raise(lib, err, "gru_bidir_train backward branch", t_len, b, h)
    ldh = -(-b // 4) * 4
    # the grid's exchange double buffer (3H rows padded to a multiple of 4,
    # for 16-byte copies) and dh scratch; the wide branch's exchange buffer
    # and flags
    scratch = serial_scratch(lib, "gru_bidir_train", BRANCHES[branch.value],
                             b, h, ndir, -(-3 * h // 4) * 4, dy.device)
    ptrs = [x.data_ptr() for x in scratch] or [None] * 2
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    err = lib.gru_bidir_train_backward(
        planes.data_ptr(), w.data_ptr(), dy.data_ptr(), dgx.data_ptr(),
        dhhn.data_ptr(), *ptrs, t_len, b, h, hp, ldh, ndir, bf16, stream,
        ctypes.byref(branch))
    if err != 0:
        _raise(lib, err, "gru_bidir_train backward", t_len, b, h)
    launches_bwd += 1
    launches_bwd_branch[BRANCHES[branch.value]] += 1
    launches_steps["bwd"] += t_len
    return dgx, dhhn


def gru_bidir_train_bwd_prepass_cuda(gx, w_hh, ys) -> torch.Tensor:
    """Launch the pre-pass kernel on the current stream: the planes ``(ndir,
    T, 5, B, H)`` fp32 (a view of the padded buffer the serial kernel
    reads).  Does not synchronise."""
    t_len, b, h, ndir = gru_ops.check_inputs(gx, w_hh)
    check_plane("ys", ys, gx, ndir * h)
    gx, ys = gx.contiguous(), ys.contiguous()
    with torch.cuda.device(gx.device):
        planes = _launch_prepass(LIBRARY.load(), gx, w_hh, ys, ndir, h)
    return planes[..., :h]


def gru_bidir_train_bwd_serial_cuda(planes, w_hh, dy
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the serial kernel on the current stream over the planes
    ``(ndir, T, 5, B, H)`` fp32: ``(dgx, dhhn)`` in ``dy``'s dtype.  Does not
    synchronise."""
    ndir, _, _, h = check_serial(planes, w_hh, dy, PLANES, 3)
    buf, hp = padded_planes(planes)
    w = w_hh.to(dy.dtype).float().contiguous()
    with torch.cuda.device(dy.device):
        return _launch_serial(LIBRARY.load(), buf, hp, w, dy.contiguous(),
                              ndir, h)


def gru_bidir_train_backward_cuda(gx, w_hh, ys, dy
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward on the current stream, the pre-pass and then the
    serial kernel: ``(dgx, dhhn)`` in the stream dtype.  Does not
    synchronise."""
    t_len, b, h, ndir = gru_ops.check_inputs(gx, w_hh)
    for name, plane in (("ys", ys), ("dy", dy)):
        check_plane(name, plane, gx, ndir * h)
    gx, ys, dy = (p.contiguous() for p in (gx, ys, dy))
    w = w_hh.to(gx.dtype).float().contiguous()  # rounded to the stream dtype
    lib = LIBRARY.load()
    with torch.cuda.device(gx.device):
        planes = _launch_prepass(lib, gx, w_hh, ys, ndir, h)
        return _launch_serial(lib, planes, planes.shape[-1], w, dy, ndir, h)


class _GruBidirTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gx, w_hh):
        if device_kind(gx, "gru_bidir_train") == "cuda":
            ys = gru_bidir_train_cuda(gx, w_hh)
        else:
            ys = gru_ops.gru_bidir_plain(gx, w_hh)
        ctx.save_for_backward(gx, w_hh, ys)
        return ys

    @staticmethod
    def backward(ctx, dy):
        gx, w_hh, ys = ctx.saved_tensors
        dy = dy.to(gx.dtype)
        if device_kind(gx, "gru_bidir_train") == "cuda":
            dgx, dhhn = gru_bidir_train_backward_cuda(gx, w_hh, ys, dy)
        else:
            dgx, dhhn = gru_bidir_train_backward_plain(gx, w_hh, ys, dy)
        return dgx, dw_hh(ys, dgx, dhhn, w_hh.shape[0]).to(w_hh.dtype)


def gru_bidir_train(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, B, ndir * 3H) stream-dtype gates + (ndir, H, 3H) weights -> ``ys``
    (T, B, ndir * H) in the stream dtype, differentiable in both arguments.

    CUDA tensors launch the kernels (forward here, backward under
    ``.backward()``); CPU tensors run the plain twins."""
    return _GruBidirTrain.apply(gx, w_hh)
