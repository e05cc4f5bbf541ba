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

The backward kernel recomputes the gates from ``gx + h_prev @ w_hh`` with
``h_prev`` read from the saved ``ys``, carries ``(dh, dc)`` and emits ``dgx``.
``dW_hh`` is formed here, outside the kernel, as two plain GEMMs of shifted
``ys`` against ``dgx`` (as the JAX package forms it outside Pallas); the input
projection and its gradients belong to the caller's ``torch.matmul``.

The kernels do their products on CUDA cores in fp32 and meet at one grid
barrier per time step; that serial chain of T steps, not the card's limits,
sets their time.  With bf16 streams the products' operands are bf16 values,
which the tensor cores could multiply, so the card's limit for the work is
then its bytes; with fp32 streams it is the fp32 operations
(``csrc/lstm_bidir_train.cu`` counts both).  Any T >= 1, B >= 1 and H run,
with no padding.

CPU tensors take the plain twins; a CUDA tensor launches the kernels or the
call raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ctc_pytorch_tpu_torch.ops._build import (
    KernelLibrary,
    acc_dtype as _acc_dtype,
    check_plane,
    check_recurrence,
    device_kind,
    step_times,
)

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "lstm_bidir_train.cu",
    {"lstm_bidir_train_forward": ([_VP] * 6 + [_CI] * 6 + [_VP], _CI),
     "lstm_bidir_train_backward": ([_VP] * 9 + [_CI] * 6 + [_VP], _CI),
     "lstm_bidir_train_error_string": ([_CI], ctypes.c_char_p)},
    headers=["lstm_fwd.cuh"])

# kernel launches made through ``lstm_bidir_train`` and its backward; the
# plain path adds nothing
launches_fwd = 0
launches_bwd = 0


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


def lstm_bidir_train_backward_plain(gx, w_hh, ys, cs, dy) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch, written out by hand
    in the kernel's arithmetic (not autograd of the forward): ``dgx (T, B,
    ndir * 4H)`` in the stream dtype."""
    t_len, b, _ = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    sd, acc = gx.dtype, _acc_dtype(gx.dtype)
    w = w_hh.to(sd).to(acc)
    wt = w.transpose(1, 2)
    zero = torch.zeros(b, h, dtype=acc, device=gx.device)
    dh = torch.zeros(ndir, b, h, dtype=acc, device=gx.device)
    dc = torch.zeros_like(dh)
    dgx = torch.empty_like(gx)
    for s in range(t_len):
        # direction 0 walks back, direction 1 forth; each steps from t to
        # t_prev, the step before it in its own walk
        times = step_times(t_len, ndir, t_len - 1 - s)
        walk = (-1, 1)

        def at(plane, d, t):
            return (plane[t, :, d * h:(d + 1) * h].to(acc) if 0 <= t < t_len
                    else zero)

        def per_dir(plane, shift=0):
            return torch.stack([at(plane, d, t + shift * walk[d])
                                for d, t in enumerate(times)])

        h_prev, c_prev = per_dir(ys, 1), per_dir(cs, 1)
        c_t, dy_t = per_dir(cs), per_dir(dy)
        pre = torch.stack([gx[t, :, 4 * d * h:4 * (d + 1) * h]
                           for d, t in enumerate(times)]).to(acc)
        i, f, g, o = _gates(pre + torch.bmm(h_prev, w))
        tc = torch.tanh(c_t)
        dh_t = dy_t + dh
        d_o = dh_t * tc
        dct = dc + dh_t * o * (1.0 - tc * tc)
        dpre = torch.cat([
            dct * g * (i * (1.0 - i)),
            dct * c_prev * (f * (1.0 - f)),
            dct * i * (1.0 - g * g),
            d_o * (o * (1.0 - o)),
        ], dim=-1).to(sd)
        for d, t in enumerate(times):
            dgx[t, :, 4 * d * h:4 * (d + 1) * h] = dpre[d]
        dh = torch.bmm(dpre.to(acc), wt)
        dc = dct * f
    return dgx


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
        # h double buffer, (direction, parity, H, ldh): rows padded to a
        # multiple of 4 floats so the kernel copies them in 16-byte pieces
        ldh = -(-b // 4) * 4
        hbuf = torch.zeros(ndir, 2, h, ldh, dtype=torch.float32,
                           device=gx.device)
        cbuf = torch.zeros(ndir, b, h, dtype=torch.float32, device=gx.device)
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = lib.lstm_bidir_train_forward(
            gx.data_ptr(), w.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            hbuf.data_ptr(), cbuf.data_ptr(), t_len, b, h, ldh, ndir,
            int(gx.dtype == torch.bfloat16), stream)
    if err != 0:
        _raise(lib, err, "lstm_bidir_train forward", t_len, b, h)
    launches_fwd += 1
    return ys, cs


def lstm_bidir_train_backward_cuda(gx, w_hh, ys, cs, dy) -> torch.Tensor:
    """Launch the backward kernel on the current stream: ``dgx`` in the
    stream dtype.  Does not synchronise."""
    global launches_bwd
    t_len, b, h, ndir = check_recurrence(gx, w_hh, 4)
    for name, plane in (("ys", ys), ("cs", cs), ("dy", dy)):
        check_plane(name, plane, gx, ndir * h)
    gx, ys, cs, dy = (p.contiguous() for p in (gx, ys, cs, dy))
    w = w_hh.to(gx.dtype).float().contiguous()
    lib = LIBRARY.load()
    with torch.cuda.device(gx.device):
        dgx = torch.empty_like(gx)
        # dpre double buffer, (direction, parity, 4H, ldh), as hbuf above
        ldh = -(-b // 4) * 4
        dpbuf = torch.zeros(ndir, 2, 4 * h, ldh, dtype=torch.float32,
                            device=gx.device)
        dhbuf = torch.zeros(ndir, b, h, dtype=torch.float32, device=gx.device)
        dcbuf = torch.zeros_like(dhbuf)
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = lib.lstm_bidir_train_backward(
            gx.data_ptr(), w.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            dy.data_ptr(), dgx.data_ptr(), dpbuf.data_ptr(), dhbuf.data_ptr(),
            dcbuf.data_ptr(), t_len, b, h, ldh, ndir,
            int(gx.dtype == torch.bfloat16), stream)
    if err != 0:
        _raise(lib, err, "lstm_bidir_train backward", t_len, b, h)
    launches_bwd += 1
    return dgx


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
