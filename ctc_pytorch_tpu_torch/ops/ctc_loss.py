"""CTC loss with the JAX package's own VJP: one Hopper kernel forward and
one backward, their plain twins, and the ``autograd.Function``.

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

On a CUDA tensor the loss is two launches of ``csrc/ctc_dp.cu``, one CTA per
utterance: ``ctc_fwd`` builds the extended labels, gathers the emissions,
runs the alpha DP and writes ``neg_ll`` (and the alpha table when a
gradient will be taken); ``ctc_bwd`` runs the beta DP and forms gamma, its
per-class sums in a fixed order (no atomics: two calls give bit-equal
gradients) and the gradient, every entry written.  They are bound by the
serial frames, not by bytes or operations.  Any T, B and C run, and S up to
``MAX_S``.  The twins ``ctc_fwd_plain`` and ``ctc_bwd_plain`` compose
``prepare``, the alpha and beta DPs on ``(B, S)`` rows, ``_ll_from_alphas``
and the JAX package's backward body.

CPU tensors take the twins; a CUDA tensor launches the kernels or the call
raises; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ctc_pytorch_tpu_torch.ops._build import KernelLibrary, device_kind

NEG_INF = -1e30
# the widest row (S = 2L + 1 positions) whose backward fits a CTA's shared
# memory (``csrc/ctc_dp.cu``: ``launch``); the old kernels stopped at 29,055
MAX_S = 30937

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_BRANCH = ctypes.POINTER(ctypes.c_int)
LIBRARY = KernelLibrary(
    "ctc_dp.cu",
    {"ctc_fwd": ([_VP] * 6 + [_CI] * 5 + [_VP, _BRANCH], _CI),
     "ctc_bwd": ([_VP] * 9 + [_CI] * 5 + [_VP, _BRANCH], _CI),
     "ctc_dp_error_string": ([_CI], ctypes.c_char_p)})

# the kernels' branches, as ``csrc/ctc_dp.cu`` numbers them: the rows staged
# in shared memory or, past the ring's budget, read from device memory
BRANCHES = ("staged", "unstaged")

# kernel launches made through ``ctc_loss`` and its backward (the names of
# the alpha and beta kernels they replace), and by branch; the plain path
# adds nothing
launches_alpha = 0
launches_beta = 0
launches_fwd_branch = dict.fromkeys(BRANCHES, 0)
launches_bwd_branch = dict.fromkeys(BRANCHES, 0)


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
    past each utterance's last frame are dead (NEG_INF)."""
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


def ctc_fwd_plain(log_probs, labels, input_lengths, label_lengths,
                  blank: int = 0, with_alphas: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel's function in plain PyTorch: ``(neg_ll (B,),
    alphas (T, B, S) or None)``."""
    _, emit, skip_in, _, pos_mask, s_len = prepare(log_probs, labels,
                                                   label_lengths, blank)
    alphas = ctc_alpha_plain(emit, skip_in, pos_mask, input_lengths)
    neg_ll = -_ll_from_alphas(alphas, input_lengths, s_len)
    return neg_ll, alphas if with_alphas else None


def ctc_bwd_plain(log_probs, labels, input_lengths, label_lengths, alphas,
                  neg_ll, g, blank: int = 0, with_betas: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward kernel's function in plain PyTorch: ``(grad (T, B, C)
    fp32, betas (T, B, S) or None)``, ``grad`` the gradient of ``sum(g *
    neg_ll)`` w.r.t. ``log_probs``."""
    ext, emit, _, skip_out, pos_mask, s_len = prepare(log_probs, labels,
                                                      label_lengths, blank)
    t_max, b, s = emit.shape
    betas = ctc_beta_plain(emit, skip_out, pos_mask, input_lengths, s_len)
    ll = -neg_ll
    # gamma(t, s) = alpha + beta - emit (emit is in both)
    gamma = alphas + betas - emit
    gamma = torch.where(pos_mask[None] > 0, gamma,
                        torch.full_like(gamma, NEG_INF))
    gmax = torch.clamp(gamma.max(dim=2, keepdim=True).values,
                       min=NEG_INF / 2)
    # sum the path mass of every position that carries class k
    dens = torch.zeros(t_max, b, log_probs.shape[2], dtype=gamma.dtype,
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
    return grad, betas if with_betas else None


def _check(log_probs, labels, input_lengths, label_lengths, blank
           ) -> Tuple[int, int, int, int]:
    """``(T, B, C, L)`` of the loss's inputs, or raise: ``log_probs (T, B,
    C)`` floating with T, B, C at least 1, integer ``labels (B, L)``,
    lengths ``(B,)``, all on one device, ``0 <= blank < C``."""
    if log_probs.dim() != 3 or not log_probs.is_floating_point():
        raise TypeError(f"log_probs must be a floating (T, B, C) tensor, got "
                        f"{log_probs.dtype} {tuple(log_probs.shape)}")
    t_max, b, c = log_probs.shape
    if t_max < 1 or b < 1 or c < 1:
        raise ValueError(f"log_probs must be (T>=1, B>=1, C>=1), got "
                         f"{tuple(log_probs.shape)}")
    if (labels.dim() != 2 or labels.shape[0] != b
            or labels.is_floating_point()):
        raise ValueError(f"labels must be integer ({b}, L), got "
                         f"{labels.dtype} {tuple(labels.shape)}")
    for name, v in (("input_lengths", input_lengths),
                    ("label_lengths", label_lengths)):
        if tuple(v.shape) != (b,):
            raise ValueError(f"{name} must be ({b},), got {tuple(v.shape)}")
    for x in (labels, input_lengths, label_lengths):
        if x.device != log_probs.device:
            raise ValueError(f"the loss's inputs must be on {log_probs.device},"
                             f" got one on {x.device}")
    if not 0 <= blank < c:
        raise ValueError(f"blank must be in [0, {c}), got {blank}")
    return t_max, b, c, labels.shape[1]


def _check_per_utt(name: str, v, b: int, device) -> torch.Tensor:
    """A ``(B,)`` fp32 operand of the backward, contiguous, or raise."""
    if tuple(v.shape) != (b,) or v.device != device:
        raise ValueError(f"{name} must be ({b},) on {device}, got "
                         f"{tuple(v.shape)} on {v.device}")
    return v.float().contiguous()


def _launch(fn: str, args, dims) -> str:
    """Run ``LIBRARY.<fn>`` on the current stream: ``args`` the pointers,
    ``dims`` (T, B, C, L, blank); the branch it took, or raise."""
    lib = LIBRARY.load()
    branch = ctypes.c_int(-1)
    err = getattr(lib, fn)(*args, *dims, torch.cuda.current_stream().cuda_stream,
                           ctypes.byref(branch))
    if err != 0:
        msg = lib.ctc_dp_error_string(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed ({err}: {msg}) at "
                           f"(T, B, C, L)={tuple(dims[:4])}")
    return BRANCHES[branch.value]


def _cuda_inputs(log_probs, labels, input_lengths, label_lengths):
    """The kernels' operands: fp32 contiguous ``log_probs``, int32
    contiguous labels and lengths (no copy when they are so already)."""
    s = 2 * labels.shape[1] + 1
    if s > MAX_S:
        raise ValueError(f"S = 2L + 1 = {s} positions: the kernels take at "
                         f"most {MAX_S}")
    return (log_probs.float().contiguous(),
            *(x.to(torch.int32).contiguous()
              for x in (labels, input_lengths, label_lengths)))


def ctc_fwd_cuda(log_probs, labels, input_lengths, label_lengths,
                 blank: int = 0, with_alphas: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel on the current stream: ``(neg_ll (B,),
    alphas (T, B, S) or None)``; does not synchronise."""
    global launches_alpha
    t_max, b, c, l = _check(log_probs, labels, input_lengths, label_lengths,
                            blank)
    lp, lab, il, ll = _cuda_inputs(log_probs, labels, input_lengths,
                                   label_lengths)
    with torch.cuda.device(lp.device):
        neg_ll = torch.empty(b, dtype=torch.float32, device=lp.device)
        alphas = (torch.empty(t_max, b, 2 * l + 1, dtype=torch.float32,
                              device=lp.device) if with_alphas else None)
        branch = _launch(
            "ctc_fwd", (lp.data_ptr(), lab.data_ptr(), il.data_ptr(),
                        ll.data_ptr(), neg_ll.data_ptr(),
                        None if alphas is None else alphas.data_ptr()),
            (t_max, b, c, l, blank))
    launches_alpha += 1
    launches_fwd_branch[branch] += 1
    return neg_ll, alphas


def ctc_bwd_cuda(log_probs, labels, input_lengths, label_lengths, alphas,
                 neg_ll, g, blank: int = 0, with_betas: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the backward kernel on the current stream: ``(grad (T, B, C)
    fp32, betas (T, B, S) or None)``; does not synchronise."""
    global launches_beta
    t_max, b, c, l = _check(log_probs, labels, input_lengths, label_lengths,
                            blank)
    lp, lab, il, ll = _cuda_inputs(log_probs, labels, input_lengths,
                                   label_lengths)
    s = 2 * l + 1
    if (alphas.dtype != torch.float32 or tuple(alphas.shape) != (t_max, b, s)
            or alphas.device != lp.device):
        raise ValueError(f"alphas must be fp32 ({t_max}, {b}, {s}) on "
                         f"{lp.device}, got {alphas.dtype} "
                         f"{tuple(alphas.shape)} on {alphas.device}")
    alphas = alphas.contiguous()
    neg_ll = _check_per_utt("neg_ll", neg_ll, b, lp.device)
    g = _check_per_utt("g", g, b, lp.device)
    with torch.cuda.device(lp.device):
        grad = torch.empty(t_max, b, c, dtype=torch.float32, device=lp.device)
        betas = (torch.empty(t_max, b, s, dtype=torch.float32,
                             device=lp.device) if with_betas else None)
        branch = _launch(
            "ctc_bwd", (lp.data_ptr(), lab.data_ptr(), il.data_ptr(),
                        ll.data_ptr(), alphas.data_ptr(), neg_ll.data_ptr(),
                        g.data_ptr(), grad.data_ptr(),
                        None if betas is None else betas.data_ptr()),
            (t_max, b, c, l, blank))
    launches_beta += 1
    launches_bwd_branch[branch] += 1
    return grad, betas


def ctc_fwd(log_probs, labels, input_lengths, label_lengths, blank: int = 0,
            with_alphas: bool = True):
    """``ctc_fwd_cuda`` for a CUDA tensor, ``ctc_fwd_plain`` for a CPU one."""
    if device_kind(log_probs, "ctc_loss") == "cuda":
        return ctc_fwd_cuda(log_probs, labels, input_lengths, label_lengths,
                            blank, with_alphas)
    _check(log_probs, labels, input_lengths, label_lengths, blank)
    return ctc_fwd_plain(log_probs, labels, input_lengths, label_lengths,
                         blank, with_alphas)


def ctc_bwd(log_probs, labels, input_lengths, label_lengths, alphas, neg_ll,
            g, blank: int = 0, with_betas: bool = False):
    """``ctc_bwd_cuda`` for a CUDA tensor, ``ctc_bwd_plain`` for a CPU one."""
    if device_kind(log_probs, "ctc_loss") == "cuda":
        return ctc_bwd_cuda(log_probs, labels, input_lengths, label_lengths,
                            alphas, neg_ll, g, blank, with_betas)
    _, b, _, _ = _check(log_probs, labels, input_lengths, label_lengths, blank)
    for name, v in (("neg_ll", neg_ll), ("g", g)):
        _check_per_utt(name, v, b, log_probs.device)
    return ctc_bwd_plain(log_probs, labels, input_lengths, label_lengths,
                         alphas, neg_ll, g, blank, with_betas)


@torch.no_grad()
def ctc_forward_score(log_probs, labels, input_lengths, label_lengths,
                      blank: int = 0) -> torch.Tensor:
    """Per-utterance ``log P(labels | log_probs)``; (T, B, C), (B, L) -> (B,)
    fp32, no gradient (the JAX ``ctc_forward_score``, ``ops/ctc_loss.py:
    111-121``).  One launch of the forward kernel without its alpha table
    on a CUDA tensor, the twin on a CPU one.  An utterance whose labels
    cannot be aligned in its frames scores exactly ``NEG_INF``, as in JAX."""
    neg_ll, _ = ctc_fwd(log_probs, labels, input_lengths, label_lengths,
                        blank, with_alphas=False)
    return -neg_ll


class _CtcNegLogLikelihood(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank,
                need_grad):
        neg_ll, alphas = ctc_fwd(log_probs, labels, input_lengths,
                                 label_lengths, blank, with_alphas=need_grad)
        if need_grad:
            ctx.save_for_backward(log_probs, labels, input_lengths,
                                  label_lengths, alphas, neg_ll)
        ctx.blank = blank
        return neg_ll

    @staticmethod
    def backward(ctx, g):
        log_probs, labels, input_lengths, label_lengths, alphas, neg_ll = (
            ctx.saved_tensors)
        grad, _ = ctc_bwd(log_probs, labels, input_lengths, label_lengths,
                          alphas, neg_ll, g.contiguous(), ctx.blank)
        return grad.to(log_probs.dtype), None, None, None, None, None


def ctc_neg_log_likelihood(log_probs, labels, input_lengths, label_lengths,
                           blank: int = 0) -> torch.Tensor:
    """Per-utterance ``-log P(labels | log_probs)``; (T, B, C), (B, L) ->
    (B,), differentiable in ``log_probs``.  The alpha table is kept only
    when a gradient will be taken."""
    need_grad = torch.is_grad_enabled() and log_probs.requires_grad
    return _CtcNegLogLikelihood.apply(log_probs, labels, input_lengths,
                                      label_lengths, blank, need_grad)


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
