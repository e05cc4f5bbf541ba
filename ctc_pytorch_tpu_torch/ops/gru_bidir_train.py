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
backward recomputes the gates from ``gx`` and ``h_prev @ w_hh`` with
``h_prev`` read from the saved ``ys`` (in S, used both in the product and in
``dz = dh_t * (h_prev - n)``), carries ``dh`` in fp32 and emits two planes in
S: ``dgx (T, B, 6H) = [dpre_r | dpre_z | dpre_n]`` per direction and ``dhhn
(T, B, 2H) = dpre_n * r``, the gradient of the n gate's recurrent branch
(the n gate sees ``r * (h W_n)``).  ``[dpre_r, dpre_z, dhh_n]`` is rounded to
S before ``@ w_hh^T``; ``dh_t * z`` is added in fp32.  ``dW_hh = [hp^T dpre_r
| hp^T dpre_z | hp^T dhh_n]`` is formed here, outside the kernel, as plain
GEMMs (as the JAX package forms it outside Pallas); the input projection and
its gradients belong to the caller's ``torch.matmul``.

The kernels do their products on CUDA cores in fp32 and meet at one grid
barrier per time step; that serial chain, not the card's limits, sets their
time (``csrc/gru_bidir_train.cu`` counts the limits).  Any T >= 1, B >= 1 and
H run, with no padding.

CPU tensors take the plain twins; a CUDA tensor launches the kernels or the
call raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ctc_pytorch_tpu_torch.ops import gru_bidir as gru_ops
from ctc_pytorch_tpu_torch.ops._build import (
    KernelLibrary,
    acc_dtype,
    check_plane,
    device_kind,
    step_times,
)

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "gru_bidir_train.cu",
    {"gru_bidir_train_backward": ([_VP] * 8 + [_CI] * 6 + [_VP], _CI),
     "gru_bidir_train_error_string": ([_CI], ctypes.c_char_p)},
    headers=gru_ops.HEADERS)

# kernel launches made through ``gru_bidir_train`` and its backward; the
# plain path adds nothing
launches_fwd = 0
launches_bwd = 0


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


def gru_bidir_train_backward_plain(gx, w_hh, ys, dy
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, written out by hand
    in the kernel's arithmetic (not autograd of the forward): ``(dgx (T, B,
    ndir * 3H), dhhn (T, B, ndir * H))`` in the stream dtype."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    sd, acc = gx.dtype, acc_dtype(gx.dtype)
    w = w_hh.to(sd).to(acc)
    wt = w.transpose(1, 2)
    zero = torch.zeros(b, h, dtype=acc, device=gx.device)
    dh = torch.zeros(ndir, b, h, dtype=acc, device=gx.device)
    dgx = torch.empty_like(gx)
    dhhn = torch.empty_like(ys)
    for s in range(t_len):
        # direction 0 walks back, direction 1 forth; h_prev is the state the
        # step started from, one step earlier in its own walk
        times = step_times(t_len, ndir, t_len - 1 - s)

        def at(plane, d, t):
            return (plane[t, :, d * h:(d + 1) * h].to(acc) if 0 <= t < t_len
                    else zero)

        h_prev = torch.stack([at(ys, d, t + (1 if d else -1))
                              for d, t in enumerate(times)])
        dy_t = torch.stack([at(dy, d, t) for d, t in enumerate(times)])
        pre = torch.stack([gx[t, :, 3 * d * h:3 * (d + 1) * h]
                           for d, t in enumerate(times)]).to(acc)
        hh = torch.bmm(h_prev, w)
        hh_n = hh[..., 2 * h:]
        r, z, n = gru_ops.gru_gates(pre, hh)
        dh_t = dy_t + dh
        dz = dh_t * (h_prev - n)
        dn = dh_t * (1.0 - z)
        dpre_n = dn * (1.0 - n * n)
        dr = dpre_n * hh_n
        dpre_r = dr * r * (1.0 - r)
        dpre_z = dz * z * (1.0 - z)
        dhh_n = (dpre_n * r).to(sd)
        dpre = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1).to(sd)
        for d, t in enumerate(times):
            dgx[t, :, 3 * d * h:3 * (d + 1) * h] = dpre[d]
            dhhn[t, :, d * h:(d + 1) * h] = dhh_n[d]
        dhh = torch.cat([dpre[..., :2 * h], dhh_n], dim=-1).to(acc)
        dh = torch.bmm(dhh, wt) + dh_t * z
    return dgx, dhhn


def gru_bidir_train_cuda(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel (the eval op's) on the current stream:
    ``ys`` in the stream dtype.  Does not synchronise."""
    global launches_fwd
    ys = gru_ops.launch_forward(gx, w_hh)
    launches_fwd += 1
    return ys


def gru_bidir_train_backward_cuda(gx, w_hh, ys, dy
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on the current stream: ``(dgx, dhhn)`` in
    the stream dtype.  Does not synchronise."""
    global launches_bwd
    t_len, b, h, ndir = gru_ops.check_inputs(gx, w_hh)
    for name, plane in (("ys", ys), ("dy", dy)):
        check_plane(name, plane, gx, ndir * h)
    gx, ys, dy = (p.contiguous() for p in (gx, ys, dy))
    w = w_hh.to(gx.dtype).float().contiguous()
    lib = LIBRARY.load()
    with torch.cuda.device(gx.device):
        dgx = torch.empty_like(gx)
        dhhn = torch.empty_like(ys)
        # exchange double buffer, (direction, parity, K4, ldh): 3H rows padded
        # to a multiple of 4, row length to a multiple of 4 floats (16-byte
        # copies)
        ldh = -(-b // 4) * 4
        k4 = -(-3 * h // 4) * 4
        dpbuf = torch.zeros(ndir, 2, k4, ldh, dtype=torch.float32,
                            device=gx.device)
        dhbuf = torch.zeros(ndir, b, h, dtype=torch.float32, device=gx.device)
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = lib.gru_bidir_train_backward(
            gx.data_ptr(), w.data_ptr(), ys.data_ptr(), dy.data_ptr(),
            dgx.data_ptr(), dhhn.data_ptr(), dpbuf.data_ptr(),
            dhbuf.data_ptr(), t_len, b, h, ldh, ndir,
            int(gx.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.gru_bidir_train_error_string(err).decode()
        raise RuntimeError(f"gru_bidir_train backward kernel launch failed "
                           f"({err}: {msg}) at T={t_len} B={b} H={h}")
    launches_bwd += 1
    return dgx, dhhn


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
