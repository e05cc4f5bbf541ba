"""Training loop: the train and eval steps, the reference's epoch loop and
its fused form over a device-resident dataset.

Counterpart of ``ctc_pytorch_tpu/train/loop.py``:

- ``train_step``: forward in train mode (bf16 matmuls, fp32 loss) -> CTC loss
  -> backward -> optional global-norm clip -> Adam update, all in place;
- the fractional length contract (``train_ctc.py:46``) through
  ``CTCModel.input_sizes``;
- ``loss = CTCLoss(sum) / batch`` as a masked mean over real examples
  (``example_mask`` drops the repeat-padded rows of a ragged last batch);
- per-step training token errors from the greedy collapse and the edit
  distance on the device (``device_token_errors``), summed there and
  fetched only where the host prints;
- ``run_epoch``, the streaming epoch: batches from the host, one eager step
  each;
- the fused epoch (the recipes' ``fused_epoch``) over a
  ``DeviceCachedLoader``: ``make_fused_fns`` / ``run_epoch_fused`` (one
  fetch and one log line per group of same-shape batches, ``fused_dispatch:
  "group"``) and ``make_epoch_fns`` / ``run_epoch_single`` (groups in
  ``t_pad`` order, one fetch per epoch, ``"epoch"``).  Where the JAX package
  runs a group or an epoch as one jitted ``lax.scan``, the port captures one
  CUDA graph per static step shape ``(bucket plane, t_pad, B)``
  (``train/graphs.py``) that gathers its batch from the cache through a
  static ``pos`` buffer, runs the whole step and adds to the device counters
  of errors and tokens; the host loop is "copy the next ``pos`` row, replay".
  No program is keyed by a group's length, so groups are not padded to
  powers of two (the JAX ``_pad_group``).  ``fused_pregather`` is accepted
  and changes nothing: the gathers run inside the graph either way.  On CPU
  tensors the runners run the same step eagerly;
- waveform in (``frontend_fn``, ``frontend/e2e.py``): batches carry padded
  raw samples and their sample counts in the ``frac`` slot, and the step's
  first op is the frontend, which rewrites both into features and frame
  fractions (the JAX ``make_step_fns(frontend_fn=...)``); in a fused epoch
  it is part of the captured graph, its cuFFT plans made by the warm-up;
- the plateau scheduler with device-side snapshots and rollback, and the
  best-dev-accuracy state kept for the final package;
- ``profile: True``: the first epoch's training pass runs under a
  ``torch.profiler`` trace written to ``<out_dir>/profile``
  (``metrics_log.py:profile_ctx``; the JAX package's ``loop.py:775-776``),
  on the path it takes without the trace: a fused epoch stays fused, its
  graphs captured inside the trace.  The trace names the runners' host
  phases (``spans.py``): ``ctc.loader.plan`` a group, ``ctc.runner.upload``
  a group and ``ctc.runner.step`` a batch with the group's ``(t_pad, B,
  n)``, ``ctc.graphs.replay`` inside each step, ``ctc.runner.fetch``, and
  ``ctc.graphs.capture`` around each of the first epoch's captures;
- data parallelism (a ``DataGroup``, ``parallel/mesh.py``; the JAX step under
  ``shard_map`` on a mesh): each rank runs the step on its rows of the
  global batch.  The loss divides by the global mask count; the model takes
  the global batch max and synchronised BN statistics; after the backward
  every gradient and the loss are summed over the ranks in one collective
  (``state.py:sum_gradients``), then the clip and Adam run on every rank
  alike; the eval loss and the token error counts are summed too, so every
  rank reports the global numbers and takes the same scheduler decisions.
  Each rank draws dropout from its own stream (``rank_seed``).  Under NCCL
  the collectives are part of each step's captured graph; gloo's run on the
  host, so a gloo group cannot run a fused epoch on the card (``Trainer``
  raises).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.data.batching import gather_rows
from ctc_pytorch_tpu_torch.decode.greedy import greedy_collapse
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.ops.ctc_loss import ctc_loss
from ctc_pytorch_tpu_torch.ops.editdistance import padded_edit_distance_device
from ctc_pytorch_tpu_torch.parallel.distributed import local_rows, rank_seed
from ctc_pytorch_tpu_torch.parallel.mesh import DataGroup, all_sum, replicate
from ctc_pytorch_tpu_torch.spans import span
from ctc_pytorch_tpu_torch.train import checkpoint as ckpt
from ctc_pytorch_tpu_torch.train.graphs import StepGraphs
from ctc_pytorch_tpu_torch.train.metrics_log import MetricsLogger, profile_ctx
from ctc_pytorch_tpu_torch.train.scheduler import PlateauScheduler
from ctc_pytorch_tpu_torch.train.state import (
    TrainState,
    apply_gradients,
    create_train_state,
    get_lr,
    restore,
    scale_lr,
    snapshot,
    sum_gradients,
)


def forward_loss(state: TrainState, spec: ModelSpec, feats, frac, labels,
                 label_lens, mask, train: bool,
                 generator: Optional[torch.Generator], frontend_fn=None,
                 group: Optional[DataGroup] = None):
    """``(loss, log_probs, input_sizes)`` of one batch in train or eval mode
    (train mode updates the BN buffers).  With ``frontend_fn`` (waveform
    in), ``feats`` are padded raw samples and ``frac`` their sample counts,
    which the frontend turns into features and frame fractions first.  With
    ``group`` the batch is this rank's rows of the global batch and the loss
    is its share of the global mean."""
    if frontend_fn is not None:
        feats, frac, _ = frontend_fn(feats, frac)
    log_probs = state.model(feats, frac=frac, example_mask=mask, train=train,
                            generator=generator, group=group)
    input_sizes = CTCModel.input_sizes(spec, frac, feats.shape[1],
                                       log_probs.shape[0], example_mask=mask,
                                       group=group)
    neg_ll = ctc_loss(log_probs, labels, input_sizes, label_lens,
                      reduction="none")
    # reference: sum over the batch / batch size (train_ctc.py:47-48); the
    # masked mean leaves out the repeat-padded rows of a ragged last batch;
    # over a group the denominator is the global count (JAX loop.py:92-95)
    denom = all_sum(mask.sum(), group)
    loss = (neg_ll * mask).sum() / torch.clamp(denom, min=1.0)
    return loss, log_probs, input_sizes


def train_step(state: TrainState, spec: ModelSpec, feats, frac, labels,
               label_lens, mask,
               generator: Optional[torch.Generator] = None, frontend_fn=None,
               group: Optional[DataGroup] = None):
    """One optimizer step, in place.  Returns ``(loss, greedy_idx (B, T'),
    input_sizes)`` on the device; nothing is fetched.  With ``group`` the
    loss is the global batch's and the update the same on every rank."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, log_probs, input_sizes = forward_loss(
        state, spec, feats, frac, labels, label_lens, mask, True, generator,
        frontend_fn, group)
    loss.backward()
    loss = loss.detach()
    if group is not None:
        loss = sum_gradients(state, group, loss)
    apply_gradients(state)
    return loss, torch.argmax(log_probs.detach(), dim=-1).T, input_sizes


@torch.no_grad()
def eval_step(state: TrainState, spec: ModelSpec, feats, frac, labels,
              label_lens, mask, frontend_fn=None,
              group: Optional[DataGroup] = None):
    """``(loss, greedy_idx, input_sizes, log_probs)`` in eval mode; with
    ``group`` the loss is summed over the ranks (the global batch's)."""
    loss, log_probs, input_sizes = forward_loss(
        state, spec, feats, frac, labels, label_lens, mask, False, None,
        frontend_fn, group)
    return (all_sum(loss, group), torch.argmax(log_probs, dim=-1).T,
            input_sizes, log_probs)


@torch.no_grad()
def device_token_errors(greedy_idx, input_sizes, labels, label_lens, mask
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(edit-distance sum, reference-token sum)`` over the batch's real
    rows, as 0-d int64 tensors on the device: greedy collapse, edit distance
    and masked sums with no host fetch (the JAX ``_device_token_errors``,
    ``train/loop.py:573-587``)."""
    tokens, lens = greedy_collapse(greedy_idx, input_sizes)
    dists = padded_edit_distance_device(labels, label_lens, tokens, lens)
    keep = mask > 0
    zero = torch.zeros((), dtype=torch.int64, device=dists.device)
    return (torch.where(keep, dists.to(torch.int64), zero).sum(),
            torch.where(keep, label_lens.to(torch.int64), zero).sum())


def _on(x, dev: torch.device) -> torch.Tensor:
    """A batch field (numpy from the host loader, a tensor from the device
    loaders) as a tensor on ``dev``."""
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(x)).to(dev)


def run_epoch(
    epoch_id: int,
    state: TrainState,
    spec: ModelSpec,
    loader,
    *,
    training: bool,
    generator: Optional[torch.Generator] = None,
    print_every: int = 50,
    compute_wer: bool = True,
    log=print,
    record: Optional[dict] = None,
    frontend_fn=None,
    group: Optional[DataGroup] = None,
) -> Tuple[float, float]:
    """One streaming pass, one eager step per batch; returns (accuracy = 1 -
    wer, average loss) like ``run_epoch`` (``train_ctc.py:26-69``).  Losses
    and token errors stay on the device and are fetched only at print
    points and at the end.  ``record``, where given, receives the pass's
    per-batch losses in visiting order and its error and token counts
    (``_epoch_done``), for parity checks between the epoch runners.  With
    ``frontend_fn`` the batches hold raw samples and the ``frac`` slot gets
    their sample counts (the JAX ``run_epoch(waveform=True)``).  With
    ``group`` each rank steps on its rows of every global batch: a host
    loader's batches (numpy) are sliced here (``local_rows``), the device
    loaders give the rank's rows already; losses and counts are the global
    batch's."""
    dev = next(state.model.parameters()).device
    device_losses = []
    cur_start = 0
    fetched_sum = 0.0
    total_errs = torch.zeros((), dtype=torch.int64, device=dev)
    total_tokens = torch.zeros((), dtype=torch.int64, device=dev)
    n_batches = 0

    def counts() -> Tuple[int, int]:  # fetched, summed over the group
        both = all_sum(torch.stack([total_errs, total_tokens]), group)
        return int(both[0]), int(both[1])

    for i, batch in enumerate(loader):
        if group is not None and not isinstance(batch.feats, torch.Tensor):
            batch = local_rows(batch, group.rank, group.world)
        feats, frac, labels, label_lens, mask = (_on(x, dev) for x in (
            batch.feats, batch.input_frac, batch.labels, batch.label_lengths,
            batch.example_mask))
        if frontend_fn is not None:
            frac = _on(batch.input_lengths, dev).to(torch.float32)
        if training:
            loss, greedy_idx, input_sizes = train_step(
                state, spec, feats, frac, labels, label_lens, mask, generator,
                frontend_fn, group)
        else:
            loss, greedy_idx, input_sizes, _ = eval_step(
                state, spec, feats, frac, labels, label_lens, mask,
                frontend_fn, group)
        device_losses.append(loss)
        n_batches += 1
        if compute_wer:
            errs, toks = device_token_errors(greedy_idx, input_sizes, labels,
                                             label_lens, mask)
            total_errs += errs
            total_tokens += toks
        if training and (i + 1) % print_every == 0:
            vals = [float(v) for v in device_losses[cur_start:]]
            fetched_sum += sum(vals)
            errs, toks = counts()
            log(
                f"Epoch = {epoch_id}, step = {i + 1}, "
                f"cur_loss = {sum(vals) / max(len(vals), 1):.4f}, "
                f"total_loss = {fetched_sum / (i + 1):.4f}, "
                f"total_wer = {errs / (toks + 1e-9):.4f}"
            )
            cur_start = len(device_losses)
    total_loss = fetched_sum + sum(float(v) for v in device_losses[cur_start:])
    if record is not None:
        record["losses"] = [float(v) for v in device_losses]
    return _epoch_done(epoch_id, training, total_loss, n_batches, *counts(),
                       log, record)


def _epoch_done(epoch_id: int, training: bool, loss_sum: float,
                n_batches: int, errs: int, toks: int, log,
                record: Optional[dict] = None) -> Tuple[float, float]:
    if record is not None:
        record.update(errs=errs, toks=toks)
    avg_loss = loss_sum / max(n_batches, 1)
    acc = 1.0 - errs / (toks + 1e-9)
    tag = "Train" if training else "Valid"
    log(f"Epoch {epoch_id} {tag} done, total_loss: {avg_loss:.4f}, "
        f"total_wer: {1.0 - acc:.4f}")
    return acc, avg_loss


# ---------------------------------------------------------------------------
# fused epochs over a device-resident cache
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _restoring(state: Optional[TrainState],
               generator: Optional[torch.Generator], tensors=()):
    """Put the train state (if given), the dropout generator (if given) and
    ``tensors`` back as they were: around a warm-up step that must leave no
    trace."""
    snap = snapshot(state) if state is not None else None
    gen_state = generator.get_state() if generator is not None else None
    saved = [t.clone() for t in tensors]
    yield
    if snap is not None:
        restore(state, snap)
    if generator is not None:
        generator.set_state(gen_state)
    for t, v in zip(tensors, saved):
        t.copy_(v)


def make_fused_fns(spec: ModelSpec,
                   generator: Optional[torch.Generator] = None,
                   frontend_fn=None, group: Optional[DataGroup] = None):
    """Per-group runners over a device-resident cache, ``(fused_train,
    fused_eval)`` (counterpart of the JAX ``make_fused_fns``,
    ``train/loop.py:168-373``).

    ``fused_train(state, arrs, pos, mask, t_pad, compute_wer)`` runs the
    group's batches, the rows ``pos[i]`` of the bucket plane ``arrs`` with
    example masks ``mask[i]`` (numpy ``(n, B)``, as ``epoch_groups`` gives
    them), one optimizer step each, in order, and returns ``(losses (n,),
    errs, toks)`` on the device, unfetched; ``fused_eval(state, arrs, pos,
    mask, t_pad, compute_wer)`` the same in eval mode without updates.
    ``state.step`` advances once a training batch.  Dropout draws from
    ``generator``.  With ``frontend_fn`` the planes hold raw samples, the
    gather passes the sample counts in the ``frac`` slot and the step
    starts with the frontend (the JAX ``make_fused_fns(waveform=True)``).
    With ``group`` the ``pos`` and ``mask`` are this rank's columns of the
    group's batches and the step is the data-parallel one; the group's
    error and token counts are summed over the ranks once, at its end (the
    JAX ``psum`` after the scan).

    On the card each step shape ``(train or eval, compute_wer, bucket
    plane, t_pad, B)`` is captured once, at its first use, into a CUDA
    graph of the shared ``StepGraphs`` (``fused_train.graphs``), and every
    batch is one replay.  The warm-up before a capture runs the step for
    real; a snapshot and a restore of the state (training) and of the error
    and token counters undo it.  The step's ``zero_grad(set_to_none=True)``
    runs first in the capture, so its backward writes fresh gradients, from
    the graphs' pool, at every replay.  The graph holds the state's tensors, which
    the rest of the trainer only ever writes in place (``train/state.py``).
    On the CPU the same step runs eagerly."""
    graphs = StepGraphs([generator])
    acc: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def run(state, arrs, pos, mask, t_pad: int, compute_wer: bool,
            training: bool):
        dev = arrs["feats"].device
        if dev not in acc:  # made outside every capture: read across graphs
            acc[dev] = (torch.zeros((), dtype=torch.int64, device=dev),
                        torch.zeros((), dtype=torch.int64, device=dev))
        errs, toks = acc[dev]
        errs.zero_()
        toks.zero_()
        n, b = pos.shape
        shape = (int(t_pad), b, n)
        with span("runner.upload", shape):
            pos_d = torch.from_numpy(np.asarray(pos, np.int64)).to(dev)
            mask_d = torch.from_numpy(np.asarray(mask, np.float32)).to(dev)
        losses = torch.empty(n, dtype=torch.float32, device=dev)

        def step(inputs):
            feats, frac, _, labels, lab_len = gather_rows(
                arrs, inputs["pos"], t_pad, waveform=frontend_fn is not None)
            m = inputs["mask"]
            if training:
                loss, greedy_idx, sizes = train_step(
                    state, spec, feats, frac, labels, lab_len, m, generator,
                    frontend_fn, group)
            else:
                loss, greedy_idx, sizes, _ = eval_step(
                    state, spec, feats, frac, labels, lab_len, m, frontend_fn,
                    group)
            if compute_wer:
                e, t = device_token_errors(greedy_idx, sizes, labels, lab_len,
                                           m)
                errs.add_(e)
                toks.add_(t)
            return (loss,)

        def totals():
            both = all_sum(torch.stack([errs, toks]), group)
            return losses, both[0], both[1]

        if dev.type != "cuda":
            for i in range(n):
                with span("runner.step", shape):
                    (loss,) = step({"pos": pos_d[i], "mask": mask_d[i]})
                    losses[i] = loss
            return totals()

        key = (training, compute_wer, id(state.model),
               arrs["feats"].data_ptr(), int(t_pad), b)
        cap = graphs.get(key)
        for i in range(n):
            with span("runner.step", shape):
                if cap is None:
                    # the static buffers, and what the graph reads besides
                    # them, live as long as it does
                    inputs = {"pos": pos_d[i].clone(),
                              "mask": mask_d[i].clone(), "arrs": arrs,
                              "model": state.model}
                    step0 = state.step
                    cap = graphs.capture(
                        key, lambda: step(inputs), inputs,
                        lambda: _restoring(state if training else None,
                                           generator if training else None,
                                           (errs, toks)))
                    state.step = step0
                else:
                    cap.inputs["pos"].copy_(pos_d[i])
                    cap.inputs["mask"].copy_(mask_d[i])
                (loss,) = cap.replay()
                losses[i].copy_(loss)
                if training:
                    state.step += 1
        return totals()

    def fused_train(state, arrs, pos, mask, t_pad: int,
                    compute_wer: bool = True):
        return run(state, arrs, pos, mask, t_pad, compute_wer, True)

    def fused_eval(state, arrs, pos, mask, t_pad: int,
                   compute_wer: bool = True):
        return run(state, arrs, pos, mask, t_pad, compute_wer, False)

    fused_train.graphs = fused_eval.graphs = graphs
    return fused_train, fused_eval


def make_epoch_fns(fused_fns):
    """Whole-epoch twins of ``make_fused_fns``' runners, ``(epoch_train,
    epoch_eval)`` (counterpart of the JAX ``make_epoch_fns``,
    ``train/loop.py:376-438``): ``epoch_train(state, groups, compute_wer)``
    runs every group of ``groups`` (``(arrs, pos, mask, t_pad)`` each) in
    the order given, on the same captured graphs, and returns ``(per-group
    losses, errs, toks)`` on the device, with nothing fetched between the
    groups; ``epoch_eval`` the same in eval mode."""
    fused_train, fused_eval = fused_fns

    def chain(fn, state, groups, compute_wer: bool):
        outs, errs, toks = [], 0, 0
        for arrs, pos, mask, t_pad in groups:
            losses, e, t = fn(state, arrs, pos, mask, t_pad, compute_wer)
            outs.append(losses)
            errs, toks = e + errs, t + toks
        return outs, errs, toks

    def epoch_train(state, groups, compute_wer: bool = True):
        return chain(fused_train, state, groups, compute_wer)

    def epoch_eval(state, groups, compute_wer: bool = True):
        return chain(fused_eval, state, groups, compute_wer)

    epoch_train.graphs = epoch_eval.graphs = fused_train.graphs
    return epoch_train, epoch_eval


def run_epoch_fused(epoch_id: int, fused_fns, state: TrainState, loader, *,
                    training: bool, compute_wer: bool = True, log=print,
                    record: Optional[dict] = None) -> Tuple[float, float]:
    """``run_epoch`` over a ``DeviceCachedLoader``, one group of same-shape
    batches at a time (``epoch_groups``); the same return contract
    (counterpart of the JAX ``run_epoch_fused``, ``train/loop.py:458-505``).
    Each group's losses and counts are fetched once, and progress is logged
    once a group.  ``record`` as ``run_epoch``'s."""
    fused_train, fused_eval = fused_fns
    loss_sum = 0.0
    n_batches = errs = toks = 0
    every = []
    for arrs, pos, mask, t_pad in loader.epoch_groups(loader.epoch):
        fn = fused_train if training else fused_eval
        losses, e, t = fn(state, arrs, pos, mask, t_pad, compute_wer)
        with span("runner.fetch"):
            vals = losses.cpu().numpy()
            e, t = int(e), int(t)
        every += vals.tolist()
        loss_sum += float(vals.sum())
        n_batches += len(vals)
        errs += e
        toks += t
        if training:
            log(
                f"Epoch = {epoch_id}, step = {n_batches}, "
                f"cur_loss = {float(vals.mean()):.4f}, "
                f"total_loss = {loss_sum / n_batches:.4f}, "
                f"total_wer = {errs / (toks + 1e-9):.4f}"
            )
    if record is not None:
        record["losses"] = every
    return _epoch_done(epoch_id, training, loss_sum, n_batches, errs, toks,
                       log, record)


def run_epoch_single(epoch_id: int, epoch_fns, state: TrainState, loader, *,
                     training: bool, compute_wer: bool = True, log=print,
                     record: Optional[dict] = None) -> Tuple[float, float]:
    """``run_epoch_fused`` through ``make_epoch_fns``: the groups in
    ``t_pad`` order (a stable sort), one fetch for the whole epoch and the
    epoch's summary as its only progress line (counterpart of the JAX
    ``run_epoch_single``, ``train/loop.py:508-570``).  ``record`` as
    ``run_epoch``'s."""
    epoch_train, epoch_eval = epoch_fns
    groups = sorted(loader.epoch_groups(loader.epoch), key=lambda g: g[3])
    if record is not None:
        record["losses"] = []
    if not groups:
        return _epoch_done(epoch_id, training, 0.0, 0, 0, 0, log, record)
    fn = epoch_train if training else epoch_eval
    losses, errs, toks = fn(state, groups, compute_wer)
    # one fetch: the fp32 losses and the counts, exact in fp64
    with span("runner.fetch"):
        flat = torch.cat([x.double() for x in losses]
                         + [torch.stack([errs, toks]).double()]).cpu().numpy()
    loss_sum, n_batches = 0.0, 0
    for vals in np.split(flat[:-2].astype(np.float32),
                         np.cumsum([len(x) for x in losses])[:-1]):
        loss_sum += float(vals.sum())
        n_batches += len(vals)
        if record is not None:
            record["losses"] += vals.tolist()
    errs, toks = int(flat[-2]), int(flat[-1])
    if training:
        log(
            f"Epoch = {epoch_id}, step = {n_batches}, "
            f"total_loss = {loss_sum / max(n_batches, 1):.4f}, "
            f"total_wer = {errs / (toks + 1e-9):.4f}"
        )
    return _epoch_done(epoch_id, training, loss_sum, n_batches, errs, toks,
                       log, record)


def quiet(*_args) -> None:
    """The log of the ranks that do not log."""


class Trainer:
    """The whole training run, with plateau scheduling and checkpointing.

    With ``fused_epoch`` the train pass, the dev pass and the
    ``dev_over_train`` pass over a ``DeviceCachedLoader`` take the fused
    runners (``run_epoch_single`` under ``fused_dispatch: "epoch"``, else
    ``run_epoch_fused``): on the card, one graph replay per batch.  Any
    other loader streams its batches in its own order, as the JAX trainer
    streams where it has no cache.  ``frontend_fn`` (waveform in,
    ``frontend/e2e.py:frontend_fn_from_config``) runs inside every step of
    every path.

    ``group`` (data parallel, the JAX ``Trainer(mesh=...)``): the loaders
    give this rank's rows of the global batches; the initial state is
    broadcast from rank 0 (``replicate``), every rank runs the same steps
    and takes the same scheduler decisions from the summed metrics, and
    only rank 0 writes checkpoints, metrics files, traces and log lines.
    ``resume`` loads on every rank.  A gloo group's collectives run on the
    host and cannot be captured, so a gloo group with ``fused_epoch`` on the
    card raises: set ``fused_epoch: false`` or use NCCL."""

    def __init__(self, cfg: Config, spec: ModelSpec,
                 device: str | torch.device = "cuda",
                 out_dir: Optional[str] = None, frontend_fn=None,
                 group: Optional[DataGroup] = None):
        if cfg.fused_dispatch not in ("group", "epoch"):
            raise ValueError(f"fused_dispatch must be 'group' or 'epoch', "
                             f"got {cfg.fused_dispatch!r}")
        self.cfg = cfg
        self.spec = spec
        self.frontend_fn = frontend_fn
        self.group = group
        if (group is not None and cfg.fused_epoch
                and torch.device(device).type == "cuda"
                and not group.capturable):
            raise ValueError(
                f"fused_epoch runs each step as a captured CUDA graph, and "
                f"the {group.backend!r} backend's collectives cannot be "
                f"captured (they copy through the host): set fused_epoch: "
                f"false, or train over NCCL")
        self.device = resolve_device(device)
        self.state = create_train_state(
            spec, cfg.init_lr, cfg.weight_decay, cfg.grad_clip, seed=cfg.seed,
            device=self.device)
        rank = 0
        if group is not None:
            replicate(self.state.model, group)
            rank = group.rank
        self.writer = rank == 0
        # dropout masks: one stream on the model's device, apart from the
        # init, and one per rank (the JAX step folds in the shard index)
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(rank_seed(cfg.seed + 1, rank))
        # the fused runners and their graphs (built even for "epoch", which
        # chains the same per-group runners)
        self.fused_fns = (make_fused_fns(spec, self.dropout_generator,
                                         frontend_fn, group)
                          if cfg.fused_epoch else None)
        self.epoch_fns = (make_epoch_fns(self.fused_fns)
                          if cfg.fused_epoch and cfg.fused_dispatch == "epoch"
                          else None)
        self.scheduler = PlateauScheduler(
            end_adjust_acc=cfg.end_adjust_acc, lr_decay=cfg.lr_decay,
            mode=cfg.scheduler_mode,
        )
        self.out_dir = Path(out_dir or Path(cfg.checkpoint_dir) / cfg.exp_name)
        self.logger = MetricsLogger(self.out_dir) if self.writer else None
        self.histories: Dict[str, list] = {
            "loss_results": [], "dev_loss_results": [], "dev_cer_results": []
        }
        if cfg.dev_over_train:
            # 863 mode: a per-epoch eval pass over the training set
            self.histories["training_cer_results"] = []
        self._rollback = snapshot(self.state)
        self._best = snapshot(self.state)
        self.epoch = 0
        self._decay_next = False

    def _fused(self, loader) -> bool:
        """Whether the passes over ``loader`` take the fused runners."""
        return self.fused_fns is not None and hasattr(loader, "epoch_groups")

    def graphs(self) -> Optional[StepGraphs]:
        """The fused runners' captured graphs (None without ``fused_epoch``)."""
        return None if self.fused_fns is None else self.fused_fns[0].graphs

    def _run(self, loader, *, training: bool, compute_wer: bool, log):
        if self._fused(loader):
            if self.epoch_fns is not None:
                return run_epoch_single(
                    self.epoch, self.epoch_fns, self.state, loader,
                    training=training, compute_wer=compute_wer, log=log)
            return run_epoch_fused(
                self.epoch, self.fused_fns, self.state, loader,
                training=training, compute_wer=compute_wer, log=log)
        return run_epoch(
            self.epoch, self.state, self.spec, loader, training=training,
            generator=self.dropout_generator if training else None,
            print_every=self.cfg.verbose_step, compute_wer=compute_wer, log=log,
            frontend_fn=self.frontend_fn, group=self.group)

    def _log_path(self, loader, log) -> None:
        """The first epoch's line on the path ``fused_epoch`` takes."""
        if self._fused(loader):
            how = ("one captured CUDA graph replay per batch"
                   if self.device.type == "cuda"
                   else "one eager step per batch on the CPU")
            log("fused_epoch: the epochs run over the device cache in the JAX "
                f"fused path's order (fused_dispatch "
                f"{self.cfg.fused_dispatch!r}), {how}")
        else:
            log("fused_epoch requested but running the streaming order: "
                f"{type(loader).__name__} has no epoch_groups (a "
                "DeviceCachedLoader is required)")

    def fit(self, train_loader, dev_loader, num_epoches: Optional[int] = None,
            compute_wer: bool = True, log=print) -> Path:
        cfg = self.cfg
        num_epoches = num_epoches or cfg.num_epoches
        if not self.writer:
            log = quiet
        stop = False
        while not stop and self.epoch < num_epoches:
            self.epoch += 1
            if self._decay_next:
                scale_lr(self.state, cfg.lr_decay)
                self._decay_next = False
            lr = get_lr(self.state)
            log(f"Start training epoch: {self.epoch}, learning_rate: {lr:.5f}")
            t0 = time.time()
            train_loader.set_epoch(self.epoch)
            if self.epoch == 1 and cfg.fused_epoch:
                self._log_path(train_loader, log)
            with profile_ctx(cfg.profile and self.epoch == 1 and self.writer,
                             self.out_dir / "profile",
                             cuda=self.device.type == "cuda"):
                train_acc, train_loss = self._run(
                    train_loader, training=True, compute_wer=compute_wer,
                    log=log)
            if cfg.dev_over_train:
                tr_eval_acc, _ = self._run(train_loader, training=False,
                                           compute_wer=True, log=log)
                log(f"cer on training set is {tr_eval_acc * 100:.4f}")
                self.histories["training_cer_results"].append(tr_eval_acc * 100)
            dev_acc, dev_loss = self._run(
                dev_loader, training=False, compute_wer=compute_wer, log=log)
            self.histories["loss_results"].append(train_loss)
            self.histories["dev_loss_results"].append(dev_loss)
            self.histories["dev_cer_results"].append(dev_acc)

            decision = self.scheduler.update(
                dev_loss, dev_acc,
                allow_adjust=self.epoch > cfg.least_train_epoch,
            )
            if decision.snapshot:
                self._rollback = snapshot(self.state)
            if decision.snapshot_best:
                self._best = snapshot(self.state)
            if decision.rollback:
                # restore params + optimizer, keep the scheduler's counters
                restore(self.state, self._rollback)
            if decision.decay_lr:
                self._decay_next = True
            stop = decision.stop

            if self.logger is not None:
                self.logger.log({
                    "epoch": self.epoch, "lr": lr,
                    "train_loss": train_loss, "train_acc": train_acc,
                    "dev_loss": dev_loss, "dev_acc": dev_acc,
                    "epoch_minutes": (time.time() - t0) / 60.0,
                    "adjust_time": self.scheduler.adjust_time,
                    "rollback": decision.rollback,
                    "decay_lr": decision.decay_lr,
                    "snapshot": decision.snapshot,
                })
            if cfg.save_every and self.epoch % cfg.save_every == 0:
                self.save_resume_checkpoint()
        return self.save_best()

    # -- persistence ----------------------------------------------------
    def _save(self, path: Path, snap) -> Path:
        """Write ``snap`` to ``path`` (rank 0 only) and return the path."""
        if not self.writer:
            return path
        ckpt.save_package(
            path, self.spec, snap["model"], optimizer=snap["optimizer"],
            step=snap["step"], config=self.cfg,
            scheduler_state=self.scheduler.state_dict(), epoch=self.epoch,
            **self.histories,
        )
        return path

    def save_best(self) -> Path:
        # TIMIT reloads the best-dev-accuracy snapshot before saving
        # (train_ctc.py:240-242); the 863 recipe saves the live model
        live = self.cfg.scheduler_mode == "acc"
        return self._save(self.out_dir / "ctc_best_model.npz",
                          snapshot(self.state) if live else self._best)

    def save_resume_checkpoint(self) -> Path:
        return self._save(self.out_dir / f"resume_ep{self.epoch:04d}.npz",
                          snapshot(self.state))

    def resume(self, path) -> None:
        manifest = ckpt.restore_train_state(path, self.state, self.spec)
        if manifest.get("scheduler"):
            self.scheduler = PlateauScheduler.from_state_dict(
                manifest["scheduler"])
        self.epoch = manifest.get("epoch") or 0
        for k in self.histories:
            self.histories[k] = manifest.get(k, [])
        self._rollback = snapshot(self.state)
        self._best = snapshot(self.state)
