"""Fused stage-4 decode: the test set decoded from a device-resident cache,
one captured CUDA graph per batch shape.

Counterpart of ``ctc_pytorch_tpu/decode/fused.py:31-91``.  The JAX package
runs each group of same-shape batches as one jitted ``lax.scan`` (gather the
rows from the cache, forward, then argmax and collapse, or the batched beam
search of ``decode/beam_device.py``) with one host fetch of the packed
tokens per group.  The port captures that
step once per group shape ``(bucket plane, t_pad, B)`` into a CUDA graph
(``train/graphs.py``) that reads its rows through a static ``pos`` buffer,
replays it once a batch, and fetches the group's tokens once.  On CPU
tensors the same step runs eagerly.  In the beam mode (``BeamDevice``) the
graph holds the forward and the whole search, one frame after another.
"""

from __future__ import annotations

from typing import Optional

import torch

from ctc_pytorch_tpu_torch.data.batching import gather_rows
from ctc_pytorch_tpu_torch.decode.beam_device import batched_beam_search
from ctc_pytorch_tpu_torch.decode.greedy import greedy_collapse, greedy_indices
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel
from ctc_pytorch_tpu_torch.spans import span
from ctc_pytorch_tpu_torch.train.graphs import StepGraphs


def make_fused_decode_fn(spec, model: CTCModel, *, mode: str = "greedy",
                         blank: int = 0, beam_width: int = 10,
                         beam_max_len: int = 96,
                         lm_table: Optional[torch.Tensor] = None,
                         lm_alpha: float = 0.0):
    """Group decoder ``fused(arrs, pos, t_pad) -> (tokens (n, B, L), lens
    (n, B))``, int32 on the device, for the rows ``pos`` (numpy ``(n, B)``)
    of a cached bucket plane ``arrs`` (``DeviceCachedLoader.epoch_groups``)
    at the group's padded length ``t_pad``.  ``mode`` is 'greedy' (argmax
    and collapse, L = the model's T') or 'beam' (``batched_beam_search``
    with ``lm_table``, float32 on the cache's device, L = ``beam_max_len``).
    ``model`` is in eval mode on the cache's device; ``fused.graphs`` holds
    the captured graphs."""
    if mode not in ("greedy", "beam"):
        raise ValueError(f"unknown fused decode mode: {mode!r}")
    graphs = StepGraphs()

    @torch.no_grad()
    def step(arrs, t_pad: int, inputs):
        feats, frac = gather_rows(arrs, inputs["pos"], t_pad)[:2]
        # frac feeds the padding-masked BN planes ('batchmax' and 'valid'
        # packages; a no-op for 'padded')
        log_probs = model(feats, frac=frac, train=False)
        sizes = CTCModel.input_sizes(spec, frac, t_pad, log_probs.shape[0])
        if mode == "greedy":
            tokens, lens = greedy_collapse(greedy_indices(log_probs), sizes,
                                           blank)
        else:
            tokens, lens, _ = batched_beam_search(
                torch.exp(log_probs).transpose(0, 1), sizes,
                beam_width=beam_width, max_len=beam_max_len, blank=blank,
                lm_table=lm_table, lm_alpha=lm_alpha)
        return tokens.to(torch.int32), lens.to(torch.int32)

    def fused(arrs, pos, t_pad: int):
        dev = arrs["feats"].device
        n, b = pos.shape
        shape = (int(t_pad), b, n)
        with span("runner.upload", shape):
            pos_d = torch.as_tensor(pos, dtype=torch.int64).to(dev)
        tokens = lens = None
        key = (arrs["feats"].data_ptr(), int(t_pad), b)
        for i in range(n):
            with span("runner.step", shape):
                if dev.type != "cuda":
                    tok, ln = step(arrs, t_pad, {"pos": pos_d[i]})
                else:
                    cap = graphs.get(key)
                    if cap is None:
                        inputs = {"pos": pos_d[i].clone(), "arrs": arrs}
                        cap = graphs.capture(
                            key, lambda: step(arrs, t_pad, inputs), inputs)
                    else:
                        cap.inputs["pos"].copy_(pos_d[i])
                    tok, ln = cap.replay()
                if tokens is None:
                    tokens = torch.empty((n,) + tuple(tok.shape),
                                         dtype=tok.dtype, device=dev)
                    lens = torch.empty((n, b), dtype=ln.dtype, device=dev)
                tokens[i].copy_(tok)
                lens[i].copy_(ln)
        return tokens, lens

    fused.graphs = graphs
    return fused
