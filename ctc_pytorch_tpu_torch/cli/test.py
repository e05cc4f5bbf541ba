"""Stage 4: decoding and scoring of a package checkpoint.

Counterpart of ``ctc_pytorch_tpu/cli/test.py``: loads a package, rebuilds
the model from it alone, decodes the test set with the ``decode_type`` of
the config, prints per-utterance origin/decoded pairs, and reports CER/WER
percentages and decode wall time, in the same lines as the JAX package.
The decoders:

- ``Greedy``: argmax and collapse on the device (``decode/greedy.py``);
- ``Beam``: the prefix beam search with the bigram LM of ``lm_path`` on the
  host, one copy of a batch's log-probs, then the C++ search per utterance
  (``decode/beam.py``; ``beam_use_native: False`` runs the numpy search);
- ``BeamDevice``: the same search batched on the device
  (``decode/beam_device.py``), ``beam_max_len`` tokens a hypothesis.

With ``fused_decode`` (the default), ``Greedy`` or ``BeamDevice``, and a
test set whose device cache fits ``device_cache_max_gb``, the set is cached
on the device and decoded one captured CUDA graph replay a batch
(``_evaluate_fused``, ``decode/fused.py``), as the JAX package decodes it
one jitted scan a group; otherwise batch by batch from the host (the
streaming loop; ``Beam`` always streams, as in the JAX package).  Both give
the same strings; the fused path prints the utterances group by group.
A ``feature_type: waveform`` package decodes from raw samples through the
frontend it was trained with (``frontend/e2e.py:frontend_fn_from_config``),
the sample counts in the ``frac`` slot, and always streams, as the JAX
stage 4 does (``cli/test.py:86-95``): there is no fused waveform decode.
Beam strings join their units with no leading space, greedy ones with one
before each unit (the reference's quirk).

Several cards: ``BeamDevice`` splits each batch's search over every visible
card (``decode/beam_device.py:batched_beam_search_sharded``), streaming, as
the JAX stage 4 does when it sees several devices (``cli/test.py:61-66``);
``evaluate(..., mesh=[devices])`` names the devices.

Precision: TF32 is off for matmuls and cuDNN convolutions, so an fp32
package computes in full fp32 like the JAX reference it is held against
(PyTorch's default would run fp32 convolutions in TF32).  bf16 packages
are unaffected: their operands are already bf16.

Usage: ``python -m ctc_pytorch_tpu_torch.cli.test --conf <yaml>
[--package <npz>] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.config import Config, load_config
from ctc_pytorch_tpu_torch.data import (
    DeviceCachedLoader,
    SpeechDataLoader,
    SpeechDataset,
    estimate_bytes,
)
from ctc_pytorch_tpu_torch.decode import BeamDecoder, GreedyDecoder
from ctc_pytorch_tpu_torch.decode.beam import warn_capacity
from ctc_pytorch_tpu_torch.decode.fused import make_fused_decode_fn
from ctc_pytorch_tpu_torch.frontend.e2e import frontend_fn_from_config
from ctc_pytorch_tpu_torch.models import CTCModel
from ctc_pytorch_tpu_torch.parallel.mesh import make_mesh
from ctc_pytorch_tpu_torch.train.checkpoint import model_from_package
from ctc_pytorch_tpu_torch.vocab import Vocab


def evaluate(
    cfg: Config,
    package_path: str,
    *,
    device: str | torch.device = "cuda",
    verbose: bool = True,
    max_batches: Optional[int] = None,
    log=print,
    mesh=None,
) -> dict:
    """Decode and score the test set of ``cfg`` with ``package_path``.
    ``mesh``: the devices a ``BeamDevice`` search splits each batch over
    (by default every card when there are several)."""
    dev = resolve_device(device)
    if cfg.decode_type not in ("Greedy", "Beam", "BeamDevice"):
        raise ValueError(f"unknown decode_type: {cfg.decode_type!r}")
    if cfg.decode_type != "BeamDevice":
        mesh = None
    elif (mesh is None and dev.type == "cuda"
          and torch.cuda.device_count() > 1):
        mesh = make_mesh()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    vocab = Vocab(cfg.vocab_file)
    spec, model, _ = model_from_package(package_path, dev)
    test_ds = SpeechDataset(vocab, cfg.test_scp_path, cfg.test_lab_path, cfg)
    test_ds.preload(cfg.num_workers)
    loader = SpeechDataLoader(
        test_ds, cfg.batch_size, shuffle=False, num_buckets=cfg.num_buckets,
        mode=cfg.batch_mode,
    )
    if cfg.decode_type == "Greedy":
        decoder = GreedyDecoder(vocab.index2word)
    else:
        decoder = BeamDecoder(
            vocab.index2word, beam_width=cfg.beam_width,
            lm_path=cfg.lm_path, lm_alpha=cfg.lm_alpha,
        )
    frontend_fn = frontend_fn_from_config(cfg)
    # the fused stage 4 where the JAX package takes it (cli/test.py:86-105)
    if (cfg.fused_decode and cfg.decode_type in ("Greedy", "BeamDevice")
            and frontend_fn is None and max_batches is None and mesh is None
            and loader.batcher._assignment is not None
            and estimate_bytes(loader) <= cfg.device_cache_max_gb * (1 << 30)):
        return _evaluate_fused(cfg, spec, model, decoder, loader, dev,
                               verbose=verbose, log=log)

    total_cer = total_wer = 0
    num_sentences = 0
    start = time.time()
    n = 0
    with torch.inference_mode():
        for batch in loader:
            feats = torch.from_numpy(batch.feats).to(dev)
            if frontend_fn is None:
                frac = torch.from_numpy(batch.input_frac).to(dev)
            else:  # waveform in: the frac slot carries the sample counts
                feats, frac, _ = frontend_fn(feats, torch.from_numpy(
                    batch.input_lengths).to(dev).to(torch.float32))
            log_probs = model(feats, frac=frac)
            input_sizes = CTCModel.input_sizes(
                spec, frac, feats.shape[1], log_probs.shape[0])
            if cfg.decode_type == "Greedy":
                decoded = decoder.decode(log_probs, input_sizes)
            elif cfg.decode_type == "BeamDevice":
                decoded = decoder.decode_on_device(
                    log_probs, input_sizes, max_len=cfg.beam_max_len,
                    mesh=mesh)
            else:
                decoded = decoder.decode(log_probs, input_sizes,
                                         use_native=cfg.beam_use_native)
            targets = [
                decoder.scorer.to_string(
                    batch.labels[i], int(batch.label_lengths[i])
                )
                for i in range(batch.batch_size)
            ]
            for i in range(batch.batch_size):
                if not batch.example_mask[i]:
                    continue
                if verbose:
                    log(f"{batch.utts[i]}")
                    log(f"origin : {targets[i]}")
                    log(f"decoded: {decoded[i]}")
                total_cer += decoder.scorer.cer(decoded[i], targets[i])
                total_wer += decoder.scorer.wer(decoded[i], targets[i])
                decoder.scorer.num_word += len(targets[i].split())
                decoder.scorer.num_char += len(targets[i])
                num_sentences += 1
            n += 1
            if max_batches and n >= max_batches:
                break
    minutes = (time.time() - start) / 60.0
    cer = 100.0 * total_cer / max(decoder.scorer.num_char, 1)
    wer = 100.0 * total_wer / max(decoder.scorer.num_word, 1)
    log(f"character error rate on test set: {cer:.4f}")
    log(f"word error rate on test set: {wer:.4f}")
    # sentence count, matching the reference's ``len(test_dataset)`` print
    # (test_ctc.py:112)
    log(f"time used for decode {num_sentences} sentences: "
        f"{minutes:.4f} minutes")
    return {"cer": cer, "wer": wer, "decode_minutes": minutes,
            "batches": n}


def _evaluate_fused(cfg, spec, model, decoder, loader, dev, *,
                    verbose: bool = True, log=print) -> dict:
    """Stage 4 over a ``DeviceCachedLoader`` of the test set, one captured
    graph per group shape (``decode/fused.py``) and one fetch of the tokens
    per group (counterpart of the JAX ``_evaluate_fused``,
    ``cli/test.py:163-240``).  Strings, CER/WER and the printed lines are
    the streaming loop's; the utterances come group by group."""
    start = time.time()
    cached = DeviceCachedLoader(loader, dev)
    scorer = decoder.scorer
    beam = cfg.decode_type == "BeamDevice"
    if beam:
        fused = make_fused_decode_fn(
            spec, model, mode="beam", blank=decoder.blank_index,
            beam_width=decoder.beam_width, beam_max_len=cfg.beam_max_len,
            lm_table=decoder.lm_on(dev), lm_alpha=decoder.lm_alpha)
        # without to_string's leading space, as the streaming path
        hyp_str = decoder.string
    else:
        fused = make_fused_decode_fn(spec, model, blank=decoder.blank_index)
        hyp_str = scorer.to_string
    hit_capacity = 0
    total_cer = total_wer = 0
    num_sentences = n_batches = 0
    label_host: dict = {}  # bucket plane -> its labels and lengths on the host
    for arrs, pos, mask, t_pad, idx in cached.epoch_groups(
            0, with_indices=True):
        tokens, lens = fused(arrs, pos, t_pad)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        n_batches += pos.shape[0]
        if beam:
            hit_capacity += int((lens >= cfg.beam_max_len).sum())
        key = arrs["feats"].data_ptr()
        if key not in label_host:
            label_host[key] = (arrs["labels"].cpu().numpy(),
                               arrs["lab_len"].cpu().numpy())
        labels, lab_lens = label_host[key]
        for bi in range(pos.shape[0]):
            for i in range(pos.shape[1]):
                if not mask[bi, i]:
                    continue
                row = pos[bi, i]
                target = scorer.to_string(labels[row], int(lab_lens[row]))
                hyp = hyp_str(tokens[bi, i], int(lens[bi, i]))
                if verbose:
                    log(f"{cached._utts[int(idx[bi, i])]}")
                    log(f"origin : {target}")
                    log(f"decoded: {hyp}")
                total_cer += scorer.cer(hyp, target)
                total_wer += scorer.wer(hyp, target)
                scorer.num_word += len(target.split())
                scorer.num_char += len(target)
                num_sentences += 1
    warn_capacity(hit_capacity, cfg.beam_max_len)
    minutes = (time.time() - start) / 60.0
    cer = 100.0 * total_cer / max(scorer.num_char, 1)
    wer = 100.0 * total_wer / max(scorer.num_word, 1)
    log(f"character error rate on test set: {cer:.4f}")
    log(f"word error rate on test set: {wer:.4f}")
    log(f"time used for decode {num_sentences} sentences: "
        f"{minutes:.4f} minutes")
    graphs = fused.graphs
    return {"cer": cer, "wer": wer, "decode_minutes": minutes,
            "batches": n_batches, "fused": True, "graphs": len(graphs),
            "capture_seconds": graphs.capture_seconds,
            "pool_bytes": graphs.pool_bytes() if dev.type == "cuda" else 0}


def main(argv=None):
    p = argparse.ArgumentParser(description="ctc decode + score (torch)")
    p.add_argument("--conf", default="conf/ctc_config.yaml")
    p.add_argument("--package", default=None,
                   help="checkpoint package; defaults to "
                        "<checkpoint_dir>/<exp_name>/ctc_best_model.npz")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)
    cfg = load_config(args.conf)
    package = args.package or (
        f"{cfg.checkpoint_dir}/{cfg.exp_name}/ctc_best_model.npz"
    )
    return evaluate(cfg, package, device=args.device)


if __name__ == "__main__":
    main()
