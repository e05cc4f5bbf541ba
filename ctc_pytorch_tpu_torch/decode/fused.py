"""Fused stage-4 decode: the test set decoded from a device-resident cache,
one captured CUDA graph per batch shape.

Counterpart of ``ctc_pytorch_tpu/decode/fused.py:31-91``, greedy mode.  The
JAX package runs each group of same-shape batches as one jitted
``lax.scan`` (gather the rows from the cache, forward, argmax, collapse)
with one host fetch of the packed tokens per group.  The port captures that
step once per group shape ``(bucket plane, t_pad, B)`` into a CUDA graph
(``train/graphs.py``) that reads its rows through a static ``pos`` buffer,
replays it once a batch, and fetches the group's tokens once.  On CPU
tensors the same step runs eagerly.  The beam mode (``BeamDevice``) is not
ported: it raises.
"""

from __future__ import annotations

import torch

from ctc_pytorch_tpu_torch.data.batching import gather_rows
from ctc_pytorch_tpu_torch.decode.greedy import greedy_collapse, greedy_indices
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel
from ctc_pytorch_tpu_torch.train.graphs import StepGraphs


def make_fused_decode_fn(spec, model: CTCModel, *, mode: str = "greedy",
                         blank: int = 0):
    """Group decoder ``fused(arrs, pos, t_pad) -> (tokens (n, B, T'), lens
    (n, B))``, int32 on the device, for the rows ``pos`` (numpy ``(n, B)``)
    of a cached bucket plane ``arrs`` (``DeviceCachedLoader.epoch_groups``)
    at the group's padded length ``t_pad``.  ``model`` is in eval mode on
    the cache's device; ``fused.graphs`` holds the captured graphs."""
    if mode != "greedy":
        raise NotImplementedError(
            f"fused decode mode {mode!r} is not ported yet; use greedy")
    graphs = StepGraphs()

    @torch.no_grad()
    def step(arrs, t_pad: int, inputs):
        feats, frac = gather_rows(arrs, inputs["pos"], t_pad)[:2]
        # frac feeds the padding-masked BN planes ('batchmax' and 'valid'
        # packages; a no-op for 'padded')
        log_probs = model(feats, frac=frac, train=False)
        sizes = CTCModel.input_sizes(spec, frac, t_pad, log_probs.shape[0])
        tokens, lens = greedy_collapse(greedy_indices(log_probs), sizes, blank)
        return tokens.to(torch.int32), lens.to(torch.int32)

    def fused(arrs, pos, t_pad: int):
        dev = arrs["feats"].device
        pos_d = torch.as_tensor(pos, dtype=torch.int64).to(dev)
        n, b = pos_d.shape
        tokens = lens = None
        key = (arrs["feats"].data_ptr(), int(t_pad), b)
        for i in range(n):
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
                tokens = torch.empty((n,) + tuple(tok.shape), dtype=tok.dtype,
                                     device=dev)
                lens = torch.empty((n, b), dtype=ln.dtype, device=dev)
            tokens[i].copy_(tok)
            lens[i].copy_(ln)
        return tokens, lens

    fused.graphs = graphs
    return fused
