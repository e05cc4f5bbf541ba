"""CTC loss with the JAX package's own VJP: alpha and beta dynamic programs
as two Hopper kernels, their plain twins, and the ``autograd.Function``.

Replaces ``ctc_pytorch_tpu/ops/ctc_pallas.py`` (``ctc_alpha_pallas``,
``ctc_beta_pallas``, ``ctc_loss_pallas``) and ``ops/ctc_loss.py`` (the scan
loss): one function with one VJP, whatever the ``ctc_impl`` config key says.

- log domain, ``NEG_INF = -1e30``; extended labels ``z = [blank, l1, blank,
  ..., lL, blank]`` of length ``S = 2L + 1``;
- alpha freezes once ``t >= input_length``; ``ll`` is the logaddexp of the
  last two valid positions of the row at ``input_length - 1``;
- the gradient is taken w.r.t. the **log-probabilities**:
  ``d(-ll)/dlogp(t, k) = -exp(log_gamma_k(t) - ll)`` on valid frames, zero
  elsewhere.  (``torch.nn.functional.ctc_loss`` returns the gradient w.r.t.
  logits instead, which is why it is not used.)  Composed with
  ``log_softmax`` this is the familiar ``p - gamma``;
- a DP cell whose three inputs are all dead is pinned to exactly ``NEG_INF``,
  so an utterance whose labels cannot be aligned in its frames gets a finite
  huge loss and zero gradients.

The kernels (``csrc/ctc_dp.cu``) run the T serial frames of each utterance
inside one CTA with the row in shared memory; they are bound by that serial
chain, not by bytes or operations.  The class gather that builds ``emit`` and
the per-class reduction of gamma stay outside in PyTorch, as the JAX package
leaves them to XLA.  Any T, B and S run.

CPU tensors take the plain twins (a loop over frames on ``(B, S)`` rows); a
CUDA tensor launches the kernels or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ctc_pytorch_tpu_torch.ops._build import KernelLibrary, device_kind

NEG_INF = -1e30

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "ctc_dp.cu",
    {"ctc_alpha": ([_VP] * 5 + [_CI] * 3 + [_VP], _CI),
     "ctc_beta": ([_VP] * 6 + [_CI] * 3 + [_VP], _CI),
     "ctc_dp_error_string": ([_CI], ctypes.c_char_p)})

# kernel launches made through ``ctc_loss`` and its backward; the plain path
# adds nothing
launches_alpha = 0
launches_beta = 0


def _lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    # all three dead: the sum underflows to 0; pin the cell to NEG_INF so no
    # -inf enters the table and no garbage enters the gradient
    live = m_safe + torch.log(torch.clamp(s, min=1e-37))
    return torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF), live)


def _shift_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """out[:, s] = x[:, s - n], NEG_INF where s < n."""
    out = torch.full_like(x, NEG_INF)
    if n < x.shape[1]:
        out[:, n:] = x[:, :x.shape[1] - n]
    return out


def _shift_left(x: torch.Tensor, n: int) -> torch.Tensor:
    """out[:, s] = x[:, s + n], NEG_INF where s + n >= S."""
    out = torch.full_like(x, NEG_INF)
    if n < x.shape[1]:
        out[:, :x.shape[1] - n] = x[:, n:]
    return out


def ctc_alpha_plain(emit, skip_in, pos_mask, input_lengths) -> torch.Tensor:
    """The alpha kernel's function in plain PyTorch: ``alphas (T, B, S)``."""
    t_max, _, s = emit.shape
    col = torch.arange(s, device=emit.device)[None, :]
    live = pos_mask > 0
    dead = torch.full_like(emit[0], NEG_INF)
    alpha = torch.where(live & (col <= 1), emit[0], dead)
    rows = [alpha]
    for t in range(1, t_max):
        new = _lse3(alpha, _shift_right(alpha, 1),
                    _shift_right(alpha, 2) + skip_in) + emit[t]
        new = torch.where(live, new, dead)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
        rows.append(alpha)
    return torch.stack(rows)


def ctc_beta_plain(emit, skip_out, pos_mask, input_lengths, s_len
                   ) -> torch.Tensor:
    """The beta kernel's function in plain PyTorch: ``betas (T, B, S)``; rows
    past each utterance's last frame are don't-care."""
    t_max, _, s = emit.shape
    col = torch.arange(s, device=emit.device)[None, :]
    live = pos_mask > 0
    dead = torch.full_like(emit[0], NEG_INF)
    last_two = (col == s_len[:, None] - 1) | (col == s_len[:, None] - 2)
    beta = dead
    rows = [None] * t_max
    for t in range(t_max - 1, -1, -1):
        new = _lse3(beta, _shift_left(beta, 1),
                    _shift_left(beta, 2) + skip_out) + emit[t]
        new = torch.where(live, new, dead)
        terminal = torch.where(last_two, emit[t], dead)
        beta = torch.where((t == input_lengths - 1)[:, None], terminal, new)
        rows[t] = beta
    return torch.stack(rows)


def _check_tables(emit, *rows_bs) -> Tuple[int, int, int]:
    t_max, b, s = emit.shape
    if emit.dtype != torch.float32:
        raise TypeError(f"emit must be float32, got {emit.dtype}")
    for r in rows_bs:
        if (r.dtype != torch.float32 or tuple(r.shape) != (b, s)
                or r.device != emit.device):
            raise ValueError(f"expected fp32 ({b}, {s}) on {emit.device}, got "
                             f"{r.dtype} {tuple(r.shape)} on {r.device}")
    if t_max < 1 or b < 1 or s < 1:
        raise ValueError(f"emit must be (T>=1, B>=1, S>=1), got "
                         f"{tuple(emit.shape)}")
    return t_max, b, s


def _int32(v: torch.Tensor, b: int, device) -> torch.Tensor:
    if tuple(v.shape) != (b,) or v.device != device:
        raise ValueError(f"expected ({b},) lengths on {device}, got "
                         f"{tuple(v.shape)} on {v.device}")
    return v.to(torch.int32).contiguous()


def _raise(lib, err: int, what: str, shape) -> None:
    msg = lib.ctc_dp_error_string(err).decode()
    raise RuntimeError(f"{what} kernel launch failed ({err}: {msg}) at "
                       f"(T, B, S)={tuple(shape)}")


def ctc_alpha_cuda(emit, skip_in, pos_mask, input_lengths) -> torch.Tensor:
    """Launch the alpha kernel on the current stream; does not synchronise."""
    global launches_alpha
    t_max, b, s = _check_tables(emit, skip_in, pos_mask)
    lens = _int32(input_lengths, b, emit.device)
    emit, skip_in, pos_mask = (x.contiguous() for x in (emit, skip_in, pos_mask))
    lib = LIBRARY.load()
    with torch.cuda.device(emit.device):
        alphas = torch.empty_like(emit)
        err = lib.ctc_alpha(
            emit.data_ptr(), skip_in.data_ptr(), pos_mask.data_ptr(),
            lens.data_ptr(), alphas.data_ptr(), t_max, b, s,
            torch.cuda.current_stream(emit.device).cuda_stream)
    if err != 0:
        _raise(lib, err, "ctc_alpha", emit.shape)
    launches_alpha += 1
    return alphas


def ctc_beta_cuda(emit, skip_out, pos_mask, input_lengths, s_len
                  ) -> torch.Tensor:
    """Launch the beta kernel on the current stream; does not synchronise."""
    global launches_beta
    t_max, b, s = _check_tables(emit, skip_out, pos_mask)
    lens = _int32(input_lengths, b, emit.device)
    slens = _int32(s_len, b, emit.device)
    emit, skip_out, pos_mask = (x.contiguous()
                                for x in (emit, skip_out, pos_mask))
    lib = LIBRARY.load()
    with torch.cuda.device(emit.device):
        betas = torch.empty_like(emit)
        err = lib.ctc_beta(
            emit.data_ptr(), skip_out.data_ptr(), pos_mask.data_ptr(),
            lens.data_ptr(), slens.data_ptr(), betas.data_ptr(), t_max, b, s,
            torch.cuda.current_stream(emit.device).cuda_stream)
    if err != 0:
        _raise(lib, err, "ctc_beta", emit.shape)
    launches_beta += 1
    return betas


def ctc_alpha(emit, skip_in, pos_mask, input_lengths) -> torch.Tensor:
    if device_kind(emit, "ctc_loss") == "cuda":
        return ctc_alpha_cuda(emit, skip_in, pos_mask, input_lengths)
    return ctc_alpha_plain(emit, skip_in, pos_mask, input_lengths)


def ctc_beta(emit, skip_out, pos_mask, input_lengths, s_len) -> torch.Tensor:
    if device_kind(emit, "ctc_loss") == "cuda":
        return ctc_beta_cuda(emit, skip_out, pos_mask, input_lengths, s_len)
    return ctc_beta_plain(emit, skip_out, pos_mask, input_lengths, s_len)


def prepare(log_probs: torch.Tensor, labels: torch.Tensor,
            label_lengths: torch.Tensor, blank: int = 0):
    """``(ext, emit, skip_in, skip_out, pos_mask, s_len)`` for the DPs."""
    t_max, b, _ = log_probs.shape
    l = labels.shape[1]
    s = 2 * l + 1
    dev = log_probs.device
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.to(torch.int64)
    col = torch.arange(s, device=dev)[None, :]
    # the skip into s is allowed when z_s is a label that differs from z_{s-2}
    ext_prev2 = torch.full_like(ext, -1)
    ext_prev2[:, 2:] = ext[:, :s - 2]
    skip_ok = (ext != ext_prev2) & (col % 2 == 1)
    skip_in = torch.where(skip_ok, 0.0, NEG_INF).to(torch.float32)
    # out of s into s + 2: allowed iff the skip into s + 2 is (0 past the end,
    # where the shifted beta is already dead)
    skip_out = torch.zeros_like(skip_in)
    skip_out[:, :s - 2] = skip_in[:, 2:]
    s_len = 2 * label_lengths.to(torch.int64) + 1
    pos_mask = (col < s_len[:, None]).to(torch.float32)
    emit = log_probs.float().gather(2, ext[None].expand(t_max, b, s))
    return ext, emit, skip_in, skip_out, pos_mask, s_len


def _ll_from_alphas(alphas, input_lengths, s_len) -> torch.Tensor:
    b = alphas.shape[1]
    rows = torch.arange(b, device=alphas.device)
    t_last = torch.clamp(input_lengths.to(torch.int64) - 1, min=0)
    final = alphas[t_last, rows]  # (B, S)
    idx_last = torch.clamp(s_len - 1, min=0)
    idx_prev = torch.clamp(s_len - 2, min=0)
    a_last = final.gather(1, idx_last[:, None])[:, 0]
    a_prev = final.gather(1, idx_prev[:, None])[:, 0]
    a_prev = torch.where(s_len >= 2, a_prev, torch.full_like(a_prev, NEG_INF))
    return torch.logaddexp(a_last, a_prev)


class _CtcNegLogLikelihood(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank):
        ext, emit, skip_in, skip_out, pos_mask, s_len = prepare(
            log_probs, labels, label_lengths, blank)
        alphas = ctc_alpha(emit, skip_in, pos_mask, input_lengths)
        ll = _ll_from_alphas(alphas, input_lengths, s_len)
        ctx.save_for_backward(ext, emit, skip_out, pos_mask, alphas,
                              input_lengths, s_len, ll)
        ctx.num_class = log_probs.shape[2]
        ctx.in_dtype = log_probs.dtype
        return -ll

    @staticmethod
    def backward(ctx, g):
        (ext, emit, skip_out, pos_mask, alphas, input_lengths, s_len,
         ll) = ctx.saved_tensors
        t_max, b, s = emit.shape
        betas = ctc_beta(emit, skip_out, pos_mask, input_lengths, s_len)
        # gamma(t, s) = alpha + beta - emit (emit is in both)
        gamma = alphas + betas - emit
        gamma = torch.where(pos_mask[None] > 0, gamma,
                            torch.full_like(gamma, NEG_INF))
        gmax = torch.clamp(gamma.max(dim=2, keepdim=True).values,
                           min=NEG_INF / 2)
        # sum the path mass of every position that carries class k
        dens = torch.zeros(t_max, b, ctx.num_class, dtype=gamma.dtype,
                           device=gamma.device)
        dens.scatter_add_(2, ext[None].expand(t_max, b, s),
                          torch.exp(gamma - gmax))
        log_dens = torch.where(dens > 0, torch.log(torch.clamp(dens, min=1e-37)),
                               torch.full_like(dens, NEG_INF))
        log_gamma_k = log_dens + gmax
        frame_valid = (torch.arange(t_max, device=emit.device)[:, None]
                       < input_lengths[None, :])[..., None]
        grad = torch.where(frame_valid,
                           -torch.exp(log_gamma_k - ll[None, :, None]),
                           torch.zeros_like(log_gamma_k))
        grad = grad * g[None, :, None]
        return grad.to(ctx.in_dtype), None, None, None, None


def ctc_neg_log_likelihood(log_probs, labels, input_lengths, label_lengths,
                           blank: int = 0) -> torch.Tensor:
    """Per-utterance ``-log P(labels | log_probs)``; (T, B, C), (B, L) ->
    (B,), differentiable in ``log_probs``."""
    return _CtcNegLogLikelihood.apply(log_probs, labels, input_lengths,
                                      label_lengths, blank)


def ctc_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int = 0,
    reduction: str = "sum_over_batch",
    zero_infinity: bool = False,
) -> torch.Tensor:
    """CTC loss over a padded batch.

    ``log_probs`` (T, B, C) log-softmax outputs, ``labels`` (B, L) padded
    targets, lengths (B,).  ``reduction``: 'none' | 'sum' | 'mean' (each loss
    over its target length, then the batch mean, as torch) |
    'sum_over_batch' (the reference's ``sum / batch_size``).
    ``zero_infinity`` zeroes the loss (and so the gradient) of utterances
    whose labels cannot be aligned."""
    neg_ll = ctc_neg_log_likelihood(log_probs, labels, input_lengths,
                                    label_lengths, blank)
    if zero_infinity:
        neg_ll = torch.where(neg_ll >= -NEG_INF / 2,
                             torch.zeros_like(neg_ll), neg_ll)
    if reduction == "none":
        return neg_ll
    if reduction == "sum":
        return neg_ll.sum()
    if reduction == "mean":
        return (neg_ll / torch.clamp(label_lengths, min=1)).mean()
    if reduction == "sum_over_batch":
        return neg_ll.sum() / neg_ll.shape[0]
    raise ValueError(f"unknown reduction {reduction!r}")
