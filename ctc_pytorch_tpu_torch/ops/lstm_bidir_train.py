"""Trainable bidirectional LSTM recurrence: two Hopper kernels (forward and
backward) and their plain twins, joined in one ``torch.autograd.Function``.

Replaces ``ctc_pytorch_tpu/ops/lstm_pallas_train_v2.py:lstm_scan_train_v2``
(forward ``_fwd_pallas``, backward ``_bwd_pallas``).  ``lstm_bidir_train(gx,
w_hh)`` takes the hoisted input projection ``gx (T, B, 8H)`` in the stream
dtype S (lanes ``[0, 4H)`` forward, ``[4H, 8H)`` backward direction) and
``w_hh (2, H, 4H)`` fp32 and returns ``ys (T, B, 2H)`` in S; h0 = c0 = 0.

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
    device_kind,
)

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "lstm_bidir_train.cu",
    {"lstm_bidir_train_forward": ([_VP] * 6 + [_CI] * 5 + [_VP], _CI),
     "lstm_bidir_train_backward": ([_VP] * 9 + [_CI] * 5 + [_VP], _CI),
     "lstm_bidir_train_error_string": ([_CI], ctypes.c_char_p)},
    headers=["lstm_fwd.cuh"])

# kernel launches made through ``lstm_bidir_train`` and its backward; the
# plain path adds nothing
launches_fwd = 0
launches_bwd = 0


def _gates(pre: torch.Tensor):
    i, f, g, o = pre.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def dw_hh(ys: torch.Tensor, dgx: torch.Tensor) -> torch.Tensor:
    """``dW_hh (2, H, 4H)`` fp32 from the saved outputs and ``dgx``:
    direction 0 pairs ``ys[t-1]`` with ``dpre[t]``, direction 1 ``ys[t+1]``
    with ``dpre[t]``; operands in the stream dtype, sums in fp32."""
    t_len, _, h2 = ys.shape
    h = h2 // 2
    acc = _acc_dtype(ys.dtype)
    if t_len == 1:
        return torch.zeros(2, h, 4 * h, dtype=acc, device=ys.device)

    def gemm(a, b):  # (N, H)^T @ (N, 4H)
        a, b = a.reshape(-1, h).t(), b.reshape(-1, 4 * h)
        if a.dtype == torch.bfloat16 and a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a.to(acc), b.to(acc))

    return torch.stack([gemm(ys[:-1, :, :h], dgx[1:, :, :4 * h]),
                        gemm(ys[1:, :, h:], dgx[:-1, :, 4 * h:])])


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def lstm_bidir_train_plain(gx: torch.Tensor, w_hh: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: ``(ys, cs)``, both
    ``(T, B, 2H)`` in the stream dtype."""
    t_len, b, _ = gx.shape
    h = w_hh.shape[1]
    sd, acc = gx.dtype, _acc_dtype(gx.dtype)
    w = w_hh.to(sd).to(acc)
    hs = torch.zeros(2, b, h, dtype=acc, device=gx.device)
    c = torch.zeros_like(hs)
    ys = torch.empty(t_len, b, 2 * h, dtype=sd, device=gx.device)
    cs = torch.empty_like(ys)
    for s in range(t_len):
        r = t_len - 1 - s
        pre = torch.stack([gx[s, :, :4 * h], gx[r, :, 4 * h:]]).to(acc)
        i, f, g, o = _gates(pre + torch.bmm(hs, w))
        c = f * c + i * g
        hn = (o * torch.tanh(c)).to(sd)
        hs = hn.to(acc)  # the next product reads h as ys holds it
        ys[s, :, :h], ys[r, :, h:] = hn[0], hn[1]
        cs[s, :, :h], cs[r, :, h:] = c[0].to(sd), c[1].to(sd)
    return ys, cs


def lstm_bidir_train_backward_plain(gx, w_hh, ys, cs, dy) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch, written out by hand
    in the kernel's arithmetic (not autograd of the forward): ``dgx (T, B,
    8H)`` in the stream dtype."""
    t_len, b, _ = gx.shape
    h = w_hh.shape[1]
    sd, acc = gx.dtype, _acc_dtype(gx.dtype)
    w = w_hh.to(sd).to(acc)
    wt = w.transpose(1, 2)
    zero = torch.zeros(b, h, dtype=acc, device=gx.device)
    dh = torch.zeros(2, b, h, dtype=acc, device=gx.device)
    dc = torch.zeros_like(dh)
    dgx = torch.empty_like(gx)
    for s in range(t_len):
        t0, t1 = t_len - 1 - s, s  # direction 0 walks back, direction 1 forth

        def at(plane, t, lanes):
            return plane[t, :, lanes].to(acc) if 0 <= t < t_len else zero

        lo, hi = slice(0, h), slice(h, 2 * h)
        h_prev = torch.stack([at(ys, t0 - 1, lo), at(ys, t1 + 1, hi)])
        c_prev = torch.stack([at(cs, t0 - 1, lo), at(cs, t1 + 1, hi)])
        c_t = torch.stack([at(cs, t0, lo), at(cs, t1, hi)])
        dy_t = torch.stack([at(dy, t0, lo), at(dy, t1, hi)])
        pre = torch.stack([gx[t0, :, :4 * h], gx[t1, :, 4 * h:]]).to(acc)
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
        dgx[t0, :, :4 * h], dgx[t1, :, 4 * h:] = dpre[0], dpre[1]
        dh = torch.bmm(dpre.to(acc), wt)
        dc = dct * f
    return dgx


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check(gx: torch.Tensor, w_hh: torch.Tensor) -> Tuple[int, int, int]:
    t_len, b, lanes = gx.shape
    h = w_hh.shape[1]
    if gx.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gx must be float32 or bfloat16, got {gx.dtype}")
    if w_hh.dtype != torch.float32 or tuple(w_hh.shape) != (2, h, 4 * h):
        raise ValueError(f"w_hh must be fp32 (2, H, 4H), got {w_hh.dtype} "
                         f"{tuple(w_hh.shape)}")
    if lanes != 8 * h or t_len < 1 or b < 1:
        raise ValueError(f"gx must be (T>=1, B>=1, 8H={8 * h}), got "
                         f"{tuple(gx.shape)}")
    if w_hh.device != gx.device:
        raise ValueError("gx and w_hh must be on the same device")
    return t_len, b, h


def _raise(lib, err: int, what: str, t_len: int, b: int, h: int) -> None:
    msg = lib.lstm_bidir_train_error_string(err).decode()
    raise RuntimeError(f"{what} kernel launch failed ({err}: {msg}) at "
                       f"T={t_len} B={b} H={h}")


def lstm_bidir_train_cuda(gx: torch.Tensor, w_hh: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream: ``(ys, cs)`` in the
    stream dtype.  Does not synchronise."""
    global launches_fwd
    t_len, b, h = _check(gx, w_hh)
    gx = gx.contiguous()
    w = w_hh.to(gx.dtype).float().contiguous()  # rounded to the stream dtype
    lib = LIBRARY.load()
    with torch.cuda.device(gx.device):
        ys = torch.empty(t_len, b, 2 * h, dtype=gx.dtype, device=gx.device)
        cs = torch.empty_like(ys)
        # h double buffer, (direction, parity, H, ldh): rows padded to a
        # multiple of 4 floats so the kernel copies them in 16-byte pieces
        ldh = -(-b // 4) * 4
        hbuf = torch.zeros(2, 2, h, ldh, dtype=torch.float32, device=gx.device)
        cbuf = torch.zeros(2, b, h, dtype=torch.float32, device=gx.device)
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = lib.lstm_bidir_train_forward(
            gx.data_ptr(), w.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            hbuf.data_ptr(), cbuf.data_ptr(), t_len, b, h, ldh,
            int(gx.dtype == torch.bfloat16), stream)
    if err != 0:
        _raise(lib, err, "lstm_bidir_train forward", t_len, b, h)
    launches_fwd += 1
    return ys, cs


def lstm_bidir_train_backward_cuda(gx, w_hh, ys, cs, dy) -> torch.Tensor:
    """Launch the backward kernel on the current stream: ``dgx`` in the
    stream dtype.  Does not synchronise."""
    global launches_bwd
    t_len, b, h = _check(gx, w_hh)
    for name, plane in (("ys", ys), ("cs", cs), ("dy", dy)):
        if (plane.dtype != gx.dtype or plane.device != gx.device
                or tuple(plane.shape) != (t_len, b, 2 * h)):
            raise ValueError(
                f"{name} must be {gx.dtype} {(t_len, b, 2 * h)} on "
                f"{gx.device}, got {plane.dtype} {tuple(plane.shape)} on "
                f"{plane.device}")
    gx, ys, cs, dy = (p.contiguous() for p in (gx, ys, cs, dy))
    w = w_hh.to(gx.dtype).float().contiguous()
    lib = LIBRARY.load()
    with torch.cuda.device(gx.device):
        dgx = torch.empty_like(gx)
        # dpre double buffer, (direction, parity, 4H, ldh), as hbuf above
        ldh = -(-b // 4) * 4
        dpbuf = torch.zeros(2, 2, 4 * h, ldh, dtype=torch.float32,
                            device=gx.device)
        dhbuf = torch.zeros(2, b, h, dtype=torch.float32, device=gx.device)
        dcbuf = torch.zeros_like(dhbuf)
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = lib.lstm_bidir_train_backward(
            gx.data_ptr(), w.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            dy.data_ptr(), dgx.data_ptr(), dpbuf.data_ptr(), dhbuf.data_ptr(),
            dcbuf.data_ptr(), t_len, b, h, ldh,
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
        return dgx, dw_hh(ys, dgx).to(w_hh.dtype)


def lstm_bidir_train(gx: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, B, 8H) stream-dtype gates + (2, H, 4H) weights -> ``ys`` (T, B, 2H)
    in the stream dtype, differentiable in both arguments.

    CUDA tensors launch the kernels (forward here, backward under
    ``.backward()``); CPU tensors run the plain twins."""
    return _LstmBidirTrain.apply(gx, w_hh)
