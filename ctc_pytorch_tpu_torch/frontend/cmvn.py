"""Global CMVN: corpus-level mean/variance normalisation.

Counterpart of ``ctc_pytorch_tpu/frontend/cmvn.py``, which replaces Kaldi
``compute-cmvn-stats`` + ``apply-cmvn --norm-vars=true``
(``timit/steps/make_feat.sh:28-30,36``): stats are computed once on the
training split and applied to every split.  They accumulate as ``(count,
sum, sumsq)`` in float64 (the JAX package's dtype under x64), on the device
of the features.  With a data-parallel ``group`` (``parallel/mesh.py``) each
rank adds its share of a batch and the three sums are summed over the ranks,
as the JAX ``axis_name`` ``psum``s them (``cmvn.py:52-55``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ctc_pytorch_tpu_torch.parallel.mesh import DataGroup, all_sum


class CmvnStats(NamedTuple):
    count: torch.Tensor  # 0-d, number of frames
    sum: torch.Tensor  # (F,)
    sumsq: torch.Tensor  # (F,)


def init_cmvn(dim: int, device: str | torch.device = "cpu") -> CmvnStats:
    z = torch.zeros((dim,), dtype=torch.float64, device=device)
    return CmvnStats(torch.zeros((), dtype=torch.float64, device=device),
                     z, z.clone())


def accumulate_cmvn(stats: CmvnStats, feats: torch.Tensor,
                    frame_mask: Optional[torch.Tensor] = None,
                    group: Optional[DataGroup] = None) -> CmvnStats:
    """Add a (B, T, F) padded batch; ``frame_mask`` (B, T) marks the valid
    frames.  With ``group`` the batch is this rank's share, and what it adds
    is summed over the ranks first."""
    x = feats.to(stats.sum.dtype)
    if frame_mask is not None:
        m = frame_mask.to(x.dtype)[..., None]
        x = x * m
        count = frame_mask.to(stats.count.dtype).sum()
        sq = (feats.to(x.dtype) ** 2 * m).sum(dim=(0, 1))
    else:
        count = torch.tensor(float(x.shape[0] * x.shape[1]),
                             dtype=stats.count.dtype, device=x.device)
        sq = (x * x).sum(dim=(0, 1))
    total = x.sum(dim=(0, 1))
    if group is not None:  # one collective for the three sums
        count, total, sq = all_sum(torch.cat([count[None], total, sq]),
                                   group).split([1, len(total), len(sq)])
        count = count[0]
    return CmvnStats(stats.count + count, stats.sum + total,
                     stats.sumsq + sq)


def finalize_cmvn(stats: CmvnStats, eps: float = 1e-10):
    """(mean, inv_std) in float32 from accumulated stats (norm_vars=True)."""
    count = torch.clamp(stats.count, min=1.0)
    mean = stats.sum / count
    var = torch.clamp(stats.sumsq / count - mean * mean, min=eps)
    return mean.to(torch.float32), torch.rsqrt(var).to(torch.float32)


def apply_cmvn(feats: torch.Tensor, mean: torch.Tensor,
               inv_std: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., F) -> normalised; ``inv_std=None`` is ``--norm-vars=false``."""
    out = feats - mean
    if inv_std is not None:
        out = out * inv_std
    return out


def compute_global_cmvn(feats_iter, dim: int):
    """One-pass reduction over an iterable of features or (features, mask)
    pairs, (T, F) or (B, T, F) tensors: ``(mean, inv_std)``."""
    stats = None
    for item in feats_iter:
        feats, mask = item if isinstance(item, tuple) else (item, None)
        feats = torch.as_tensor(feats)
        if feats.ndim == 2:
            feats = feats[None]
            mask = None if mask is None else torch.as_tensor(mask)[None]
        if stats is None:
            stats = init_cmvn(dim, feats.device)
        stats = accumulate_cmvn(stats, feats, mask)
    return finalize_cmvn(stats if stats is not None else init_cmvn(dim))
