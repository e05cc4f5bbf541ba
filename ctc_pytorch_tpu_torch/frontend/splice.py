"""Context splicing, frame skipping, downsample padding, batched torch ops.

Counterpart of ``ctc_pytorch_tpu/frontend/splice.py``: the per-utterance
transforms of the reference data pipeline (``timit/utils/tools.py:66-86``,
``timit/utils/data_loader.py:104-110``) as batched ops for the in-step
frontend.  The dataset keeps its host numpy copy (``data/dataset.py``).

- ``make_context(feat, l, r)``: columns [left_l ... left_1, centre,
  right_1 ... right_r], edges replicated;
- ``skip_frames(feat, skip)``: keep frames ``i % skip == 0``;
- downsample padding: zero rows until ``T % n_downsample == 0``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def make_context(feats: torch.Tensor, left: int, right: int,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., T, F) -> (..., T, F*(left+1+right)) with edge replication.

    ``lengths`` (the leading axes' shape): valid frame counts of a padded
    batch, so that the right edge replicates each utterance's own last valid
    frame (``tools.py:66-75``) and not the padded buffer's edge."""
    if left == 0 and right == 0:
        return feats
    t = feats.shape[-2]
    if lengths is not None:
        pos = torch.arange(t, device=feats.device)
        last = torch.clamp(lengths.to(torch.int64) - 1, min=0)[..., None]
        cols = []
        for shift in range(-left, right + 1):
            idx = torch.minimum(torch.clamp(pos + shift, min=0), last)
            idx = idx[..., None].expand(idx.shape + (feats.shape[-1],))
            cols.append(torch.gather(feats, -2, idx))
        return torch.cat(cols, dim=-1)
    cols = []
    for shift in range(-left, right + 1):
        if shift < 0:
            first = feats[..., :1, :].expand(
                feats.shape[:-2] + (-shift, feats.shape[-1]))
            cols.append(torch.cat([first, feats[..., :shift, :]], dim=-2))
        elif shift > 0:
            last = feats[..., -1:, :].expand(
                feats.shape[:-2] + (shift, feats.shape[-1]))
            cols.append(torch.cat([feats[..., shift:, :], last], dim=-2))
        else:
            cols.append(feats)
    return torch.cat(cols, dim=-1)


def skip_frames(feats: torch.Tensor, skip: int) -> torch.Tensor:
    """(..., T, F) -> (..., ceil(T/skip), F), keeping frames i % skip == 0."""
    if skip in (0, 1):
        return feats
    return feats[..., ::skip, :]


def skipped_len(t: int, skip: int) -> int:
    if skip in (0, 1):
        return t
    return -(-t // skip)  # ceil


def pad_to_downsample(feats: torch.Tensor, n_downsample: int) -> torch.Tensor:
    """Zero-pad the time axis so that ``T % n_downsample == 0``."""
    if n_downsample <= 1 or feats.shape[-2] % n_downsample == 0:
        return feats
    pad = n_downsample - feats.shape[-2] % n_downsample
    return torch.nn.functional.pad(feats, (0, 0, 0, pad))


def downsampled_len(t: int, n_downsample: int) -> int:
    if n_downsample <= 1:
        return t
    return t + (-t) % n_downsample


def ceil_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """``ceil(x / d)`` of an integer tensor."""
    return -torch.div(-x, d, rounding_mode="floor")


def splice_and_skip(feats: torch.Tensor, lengths: Optional[torch.Tensor],
                    left_ctx: int, right_ctx: int, n_skip_frame: int,
                    n_downsample: int
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The whole per-utterance transform of ``SpeechDataset.__getitem__``
    (``timit/utils/data_loader.py:104-110``), batched.  With ``lengths``
    the splice replicates each utterance's own edge and the returned valid
    lengths include the pad-to-downsample round-up (``skipped_len``, then
    ``downsampled_len``), as the dataset counts them."""
    out = make_context(feats, left_ctx, right_ctx, lengths=lengths)
    out = skip_frames(out, n_skip_frame)
    out = pad_to_downsample(out, n_downsample)
    if lengths is None:
        return out, None
    new_len = lengths
    if n_skip_frame > 1:
        new_len = ceil_div(new_len, n_skip_frame)
    if n_downsample > 1:
        # the reference zero-pads each item's rows to a multiple of
        # n_downsample, and the padded count is the item's length
        new_len = new_len + torch.remainder(-new_len, n_downsample)
    return out, torch.clamp(new_len, max=out.shape[-2])
