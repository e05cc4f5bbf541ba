"""Batched CTC prefix beam search on the tensors' device (fixed beam width).

Counterpart of ``ctc_pytorch_tpu/decode/beam_device.py`` (``_beam_step``
:46, ``_decode_one`` :141, ``batched_beam_search`` :183).  The JAX version
is XLA code, not a Pallas kernel: it holds no TPU kernel, so the port writes
it as plain torch ops, which run on the device of their inputs (the card in
stage 4, the CPU in the tests) and can be captured in a CUDA graph
(``decode/fused.py``): no op syncs with the host.  The batch is a leading
dimension of every op where JAX ``vmap``s, and the scan over frames is a
Python loop over the static T.

The search is the dict algorithm of ``decode/beam.py`` on a fixed-K state
(the JAX module's docstring proves the two equal): per frame, K copies and
K·C extensions are scored, an extension that recreates a surviving beam is
merged into its copy, and the top K of the pool survive.  What keeps the
port's tokens equal to JAX's:

- the pool's top K is a stable descending sort, so equal scores (the pool
  is full of ``NEG``) come in index order, as ``lax.top_k`` gives them;
- ``argmax`` runs on int and float tensors and takes the first maximum;
- the merge mask is an ``any`` over one-hot rows, so the rows without a
  parent, which point at ``(0, max(last, 0))``, cannot clear a real pair
  (JAX's ``.at[...].max``);
- everything is float32: ``jnp.maximum(probs, 1e-300)`` floors at 0 in
  float32, so a zero probability logs to ``-inf``; ``NEG`` is ``-1e9`` and
  a beam is valid while its score exceeds ``NEG / 2``.

The search runs in the dtype of its probabilities, float32 (half and bf16
are raised to it) or float64, as the JAX search does under x64.  The host
search (``native/``) sums in double, so where two prefixes' scores tie to
float32's resolution the float32 search may keep the other one: the float64
search sums as the host search does.

``batched_beam_search_sharded`` splits a batch over the devices of a mesh
(``parallel/mesh.py:make_mesh``) inside one process, as the JAX version
shards it over a data mesh: each device searches its rows, with no traffic
between them, since every utterance is searched on its own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ctc_pytorch_tpu_torch.parallel.mesh import pad_batch_to_devices, shard_batch

NEG = -1.0e9
LOG_EPS = 1e-300  # 0 in float32


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, k]]`` for ``x`` (B, N) or (B, N, L) and ``idx`` (B, K)."""
    if x.dim() == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))


def _last(prefixes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, K) last label of each beam, -1 for an empty one."""
    at = (lengths - 1).clamp_min(0)[..., None]
    return torch.where(lengths > 0, prefixes.gather(2, at)[..., 0], -1)


def _beam_step(state, probs_t, probs_prev, t_active, *, num_class: int,
               max_len: int, blank: int, lm_table, lm_alpha: float):
    """One frame for the batch: ``probs_t``, ``probs_prev`` (B, C),
    ``t_active`` (B,) bool."""
    prefixes, lengths, pr_b, pr_nb, valid = state
    b, k_width, _ = prefixes.shape
    c = num_class
    dev = prefixes.device
    arange_k = torch.arange(k_width, device=dev)
    classes = torch.arange(c, device=dev)

    # in float32 the floor is 0, so a zero probability logs to -inf
    lp = torch.log(probs_t.clamp_min(LOG_EPS))
    lp_blank = lp[:, blank]
    total = torch.where(valid, torch.logaddexp(pr_b, pr_nb), NEG)
    prev_ge = probs_prev[:, blank] >= 0.9
    last = _last(prefixes, lengths)
    last_c = last.clamp_min(0)

    # ---- parent matching: parent[j] = k with prefix_k == prefix_j[:-1] ----
    plen = (lengths - 1).clamp_min(0)  # parent length of j
    eq = prefixes[:, None, :, :] == prefixes[:, :, None, :]  # (B, j, k, L)
    cmp_mask = torch.arange(max_len, device=dev) < plen[:, :, None, None]
    prefix_match = (eq | ~cmp_mask).all(dim=3)  # (B, j, k)
    len_match = lengths[:, None, :] == plen[:, :, None]  # len_k == len_j - 1
    is_parent = (prefix_match & len_match & valid[:, None, :]
                 & valid[:, :, None] & (lengths > 0)[:, :, None])
    parent_idx = torch.argmax(is_parent.to(torch.int32), dim=2)  # (B, j)
    has_parent = is_parent.any(dim=2)

    # ---- extension scores: ext[b, k, c'] ---------------------------------
    if lm_table is not None:
        sent = lm_table.shape[0] - 1
        ctx = torch.where(last >= 0, last, sent)
        lm_term = (lm_table[ctx] * lm_alpha)[..., :c]  # (B, K, C)
    else:
        lm_term = torch.zeros((b, k_width, c), dtype=probs_t.dtype, device=dev)
    base_same = torch.where(prev_ge[:, None], total, pr_b)  # repeat-label base
    base = torch.where(classes == last[..., None], base_same[..., None],
                       total[..., None])
    ext = lp[:, None, :] + lm_term + base  # (B, K, C)
    ext = torch.where(valid[..., None], ext, NEG)
    ext = torch.where(classes == blank, NEG, ext)  # no blank extensions
    ext = torch.where(lengths[..., None] < max_len, ext, NEG)  # capacity
    ext_flat = ext.reshape(b, k_width * c)

    # ---- copy path -------------------------------------------------------
    copy_b = total + lp_blank[:, None]
    copy_nb = torch.where(last >= 0, pr_nb + lp.gather(1, last_c), NEG)
    # merge the unique extension source into the surviving copy
    merge_score = ext_flat.gather(1, parent_idx * c + last_c)
    merge_score = torch.where(has_parent, merge_score, NEG)
    copy_nb = torch.logaddexp(copy_nb, merge_score)
    # remove the merged extensions from the candidate pool
    merged = (has_parent[:, :, None, None]
              & (parent_idx[:, :, None] == arange_k)[..., None]
              & (last_c[:, :, None] == classes)[:, :, None, :]).any(dim=1)
    ext_flat = torch.where(merged.reshape(b, k_width * c), NEG, ext_flat)
    copy_total = torch.where(valid, torch.logaddexp(copy_b, copy_nb), NEG)

    # ---- top K of the K + K*C candidates, ties in index order ------------
    pool = torch.cat([copy_total, ext_flat], dim=1)
    top_scores, top_idx = torch.sort(pool, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k_width], top_idx[:, :k_width]
    is_copy = top_idx < k_width
    src = torch.where(is_copy, top_idx, (top_idx - k_width) // c)
    cls = torch.where(is_copy, 0, (top_idx - k_width) % c)

    new_prefixes = _take(prefixes, src)
    src_len = _take(lengths, src)
    new_lengths = torch.where(is_copy, src_len, src_len + 1)
    write_pos = src_len.clamp_max(max_len - 1)
    appended = new_prefixes.scatter(2, write_pos[..., None], cls[..., None])
    new_prefixes = torch.where(is_copy[..., None], new_prefixes, appended)
    new_pr_b = torch.where(is_copy, _take(copy_b, src), NEG)
    new_pr_nb = torch.where(is_copy, _take(copy_nb, src),
                            ext_flat.gather(1, src * c + cls))
    new_valid = top_scores > NEG / 2

    # ---- a blank-skip or inactive frame keeps the old state --------------
    skip = (1.0 - probs_t[:, blank] < 0.1) | ~t_active
    news = (new_prefixes, new_lengths, new_pr_b, new_pr_nb, new_valid)
    return tuple(
        torch.where(skip.reshape((b,) + (1,) * (old.dim() - 1)), old, new)
        for old, new in zip(state, news))


@torch.no_grad()
def batched_beam_search(
    probs: torch.Tensor,  # (B, T, C) probabilities
    lengths: torch.Tensor,  # (B,)
    beam_width: int = 10,
    max_len: int = 96,
    blank: int = 0,
    lm_table: Optional[torch.Tensor] = None,
    lm_alpha: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode a whole batch on ``probs``' device, in float32 or, for float64
    ``probs``, in float64.  ``lm_table`` is the ``(V+1, V+1)`` natural-log
    bigram table on the same device, taken in the search's dtype.

    Returns (sequences (B, max_len) int32, lengths (B,) int32, normalised
    scores (B,) in the search's dtype)."""
    b, t_max, c = probs.shape
    dev = probs.device
    dtype = torch.float64 if probs.dtype == torch.float64 else torch.float32
    probs = probs.to(dtype)
    if lm_table is not None:
        lm_table = lm_table.to(dtype)
    k = beam_width
    prefixes = torch.zeros((b, k, max_len), dtype=torch.int64, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int64, device=dev)
    first = torch.arange(k, device=dev) == 0
    pr_b = torch.where(first, 0.0, NEG).to(dtype).expand(b, k)
    pr_nb = torch.full((b, k), NEG, dtype=dtype, device=dev)
    valid = first.expand(b, k)
    state = (prefixes, lens, pr_b, pr_nb, valid)

    probs_prev = torch.cat([torch.ones_like(probs[:, :1]), probs[:, :-1]], 1)
    t_active = (torch.arange(t_max, device=dev)[None, :]
                < lengths.to(dev)[:, None])
    for t in range(t_max):
        state = _beam_step(state, probs[:, t], probs_prev[:, t],
                           t_active[:, t], num_class=c, max_len=max_len,
                           blank=blank, lm_table=lm_table, lm_alpha=lm_alpha)
    prefixes, lens, pr_b, pr_nb, valid = state

    total = torch.where(valid, torch.logaddexp(pr_b, pr_nb), NEG)
    if lm_table is not None:
        sent = lm_table.shape[0] - 1
        last = _last(prefixes, lens)
        end_lm = torch.where(last >= 0,
                             lm_table[last.clamp_min(0), sent] * lm_alpha, 0.0)
        total = total + end_lm
    norm = total / lens.clamp_min(1)
    best = torch.argmax(torch.where(valid, norm, NEG), dim=1, keepdim=True)
    return (_take(prefixes, best)[:, 0].to(torch.int32),
            lens.gather(1, best)[:, 0].to(torch.int32),
            norm.gather(1, best)[:, 0])


def batched_beam_search_sharded(
    probs: torch.Tensor,  # (B, T, C) probabilities
    lengths: torch.Tensor,  # (B,)
    mesh: Sequence[torch.device],
    beam_width: int = 10,
    max_len: int = 96,
    blank: int = 0,
    lm_table: Optional[torch.Tensor] = None,
    lm_alpha: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``batched_beam_search`` with the batch split over the devices of
    ``mesh`` (``ctc_pytorch_tpu/decode/beam_device.py:203-244``): the batch
    is padded to a multiple of the mesh by repeating its first row, block r
    of the rows is searched on ``mesh[r]`` (with the LM table copied there),
    and the results are gathered on the first device with the padding
    sliced off.  The same outputs as the unsplit search."""
    b = probs.shape[0]
    bp = pad_batch_to_devices(b, len(mesh))
    lengths = torch.as_tensor(lengths).to(probs.device)
    if bp != b:
        probs = torch.cat([probs, probs[:1].expand(bp - b, -1, -1)])
        lengths = torch.cat([lengths, lengths[:1].expand(bp - b)])
    outs = [batched_beam_search(
        p, n, beam_width=beam_width, max_len=max_len, blank=blank,
        lm_table=None if lm_table is None else lm_table.to(p.device),
        lm_alpha=lm_alpha) for p, n in shard_batch((probs, lengths), mesh)]
    home = mesh[0]
    return tuple(torch.cat([o[i].to(home) for o in outs])[:b]
                 for i in range(3))
