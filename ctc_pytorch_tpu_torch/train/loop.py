"""Training loop: the train and eval steps and the reference's epoch loop.

Counterpart of ``ctc_pytorch_tpu/train/loop.py`` (``make_step_fns``,
``run_epoch``, ``Trainer``), streaming path:

- ``train_step``: forward in train mode (bf16 matmuls, fp32 loss) -> CTC loss
  -> backward -> optional global-norm clip -> Adam update, all in place;
- the fractional length contract (``train_ctc.py:46``) through
  ``CTCModel.input_sizes``;
- ``loss = CTCLoss(sum) / batch`` as a masked mean over real examples
  (``example_mask`` drops the repeat-padded rows of a ragged last batch);
- per-step training token errors from the greedy collapse on the device and
  the edit distance on the host;
- the plateau scheduler with device-side snapshots and rollback, and the
  best-dev-accuracy state kept for the final package.

The recipe's ``fused_epoch`` and ``device_cache`` (one program per epoch over
a device-resident dataset) are ported as far as the batch order: over a
``GroupedLoader`` (which ``cli/train.py`` builds where the JAX stage 2 would
build its device cache) the epoch visits the batches grouped by shape, in the
JAX fused path's order, still one step each from the host (no CUDA graphs).
Data parallelism, the waveform frontend and ``profile`` are not ported.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.decode.greedy import greedy_collapse
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec
from ctc_pytorch_tpu_torch.ops.ctc_loss import ctc_loss
from ctc_pytorch_tpu_torch.ops.editdistance import edit_distance
from ctc_pytorch_tpu_torch.train import checkpoint as ckpt
from ctc_pytorch_tpu_torch.train.metrics_log import MetricsLogger
from ctc_pytorch_tpu_torch.train.scheduler import PlateauScheduler
from ctc_pytorch_tpu_torch.train.state import (
    TrainState,
    apply_gradients,
    create_train_state,
    get_lr,
    restore,
    scale_lr,
    snapshot,
)


def forward_loss(state: TrainState, spec: ModelSpec, feats, frac, labels,
                 label_lens, mask, train: bool,
                 generator: Optional[torch.Generator]):
    """``(loss, log_probs, input_sizes)`` of one batch in train or eval mode
    (train mode updates the BN buffers)."""
    log_probs = state.model(feats, frac=frac, example_mask=mask, train=train,
                            generator=generator)
    input_sizes = CTCModel.input_sizes(spec, frac, feats.shape[1],
                                       log_probs.shape[0], example_mask=mask)
    neg_ll = ctc_loss(log_probs, labels, input_sizes, label_lens,
                      reduction="none")
    # reference: sum over the batch / batch size (train_ctc.py:47-48); the
    # masked mean leaves out the repeat-padded rows of a ragged last batch
    loss = (neg_ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, log_probs, input_sizes


def train_step(state: TrainState, spec: ModelSpec, feats, frac, labels,
               label_lens, mask,
               generator: Optional[torch.Generator] = None):
    """One optimizer step, in place.  Returns ``(loss, greedy_idx (B, T'),
    input_sizes)`` on the device; nothing is fetched."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, log_probs, input_sizes = forward_loss(
        state, spec, feats, frac, labels, label_lens, mask, True, generator)
    loss.backward()
    apply_gradients(state)
    return loss.detach(), torch.argmax(log_probs.detach(), dim=-1).T, input_sizes


@torch.no_grad()
def eval_step(state: TrainState, spec: ModelSpec, feats, frac, labels,
              label_lens, mask):
    """``(loss, greedy_idx, input_sizes, log_probs)`` in eval mode."""
    loss, log_probs, input_sizes = forward_loss(
        state, spec, feats, frac, labels, label_lens, mask, False, None)
    return loss, torch.argmax(log_probs, dim=-1).T, input_sizes, log_probs


def token_errors(greedy_idx, input_sizes, batch) -> Tuple[int, int]:
    """(edit-distance sum, reference-token sum) over the batch's real rows:
    greedy collapse on the device, Levenshtein on the host."""
    tokens, lens = greedy_collapse(greedy_idx, input_sizes)
    tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
    errs = toks = 0
    for i in range(batch.batch_size):
        if not batch.example_mask[i]:
            continue
        n = int(batch.label_lengths[i])
        errs += edit_distance(batch.labels[i, :n], tokens[i, :int(lens[i])])
        toks += n
    return errs, toks


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
) -> Tuple[float, float]:
    """One pass; returns (accuracy = 1 - wer, average loss) like
    ``run_epoch`` (``train_ctc.py:26-69``).  Losses stay on the device and
    are fetched only at print points and at the end."""
    dev = next(state.model.parameters()).device
    device_losses = []
    cur_start = 0
    fetched_sum = 0.0
    total_errs = total_tokens = 0
    n_batches = 0
    for i, batch in enumerate(loader):
        feats = torch.from_numpy(batch.feats).to(dev)
        frac = torch.from_numpy(batch.input_frac).to(dev)
        labels = torch.from_numpy(batch.labels).to(dev)
        label_lens = torch.from_numpy(batch.label_lengths).to(dev)
        mask = torch.from_numpy(batch.example_mask).to(dev)
        if training:
            loss, greedy_idx, input_sizes = train_step(
                state, spec, feats, frac, labels, label_lens, mask, generator)
        else:
            loss, greedy_idx, input_sizes, _ = eval_step(
                state, spec, feats, frac, labels, label_lens, mask)
        device_losses.append(loss)
        n_batches += 1
        if compute_wer:
            errs, toks = token_errors(greedy_idx, input_sizes, batch)
            total_errs += errs
            total_tokens += toks
        if training and (i + 1) % print_every == 0:
            vals = [float(v) for v in device_losses[cur_start:]]
            fetched_sum += sum(vals)
            log(
                f"Epoch = {epoch_id}, step = {i + 1}, "
                f"cur_loss = {sum(vals) / max(len(vals), 1):.4f}, "
                f"total_loss = {fetched_sum / (i + 1):.4f}, "
                f"total_wer = {total_errs / (total_tokens + 1e-9):.4f}"
            )
            cur_start = len(device_losses)
    total_loss = fetched_sum + sum(float(v) for v in device_losses[cur_start:])
    avg_loss = total_loss / max(n_batches, 1)
    acc = 1.0 - total_errs / (total_tokens + 1e-9)
    tag = "Train" if training else "Valid"
    log(f"Epoch {epoch_id} {tag} done, total_loss: {avg_loss:.4f}, "
        f"total_wer: {1.0 - acc:.4f}")
    return acc, avg_loss


class Trainer:
    """The whole training run, with plateau scheduling and checkpointing."""

    def __init__(self, cfg: Config, spec: ModelSpec,
                 device: str | torch.device = "cuda",
                 out_dir: Optional[str] = None):
        if cfg.profile:
            raise NotImplementedError("profile: tracing is not ported yet")
        if cfg.fused_dispatch not in ("group", "epoch"):
            raise ValueError(f"fused_dispatch must be 'group' or 'epoch', "
                             f"got {cfg.fused_dispatch!r}")
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)
        self.state = create_train_state(
            spec, cfg.init_lr, cfg.weight_decay, cfg.grad_clip, seed=cfg.seed,
            device=self.device)
        # dropout masks: one stream on the model's device, apart from the init
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(cfg.seed + 1)
        self.scheduler = PlateauScheduler(
            end_adjust_acc=cfg.end_adjust_acc, lr_decay=cfg.lr_decay,
            mode=cfg.scheduler_mode,
        )
        self.out_dir = Path(out_dir or Path(cfg.checkpoint_dir) / cfg.exp_name)
        self.logger = MetricsLogger(self.out_dir)
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

    def _grouped(self, loader) -> bool:
        """Whether the epochs over ``loader`` take the fused path's batch
        order: ``fused_epoch`` on and a loader that knows it."""
        return self.cfg.fused_epoch and hasattr(loader, "grouped")

    def _run(self, loader, *, training: bool, compute_wer: bool, log):
        if self._grouped(loader):
            loader = loader.grouped(self.cfg.fused_dispatch)
        return run_epoch(
            self.epoch, self.state, self.spec, loader, training=training,
            generator=self.dropout_generator if training else None,
            print_every=self.cfg.verbose_step, compute_wer=compute_wer, log=log)

    def fit(self, train_loader, dev_loader, num_epoches: Optional[int] = None,
            compute_wer: bool = True, log=print) -> Path:
        cfg = self.cfg
        num_epoches = num_epoches or cfg.num_epoches
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
                if self._grouped(train_loader):
                    log("fused_epoch: the batches go grouped by shape in the "
                        "JAX fused path's order (fused_dispatch "
                        f"{cfg.fused_dispatch!r}), one step each; CUDA graphs "
                        "are not ported")
                else:
                    log("fused_epoch requested but running the streaming "
                        f"order: {type(train_loader).__name__} has no grouped "
                        "order (a GroupedLoader is required)")
            train_acc, train_loss = self._run(
                train_loader, training=True, compute_wer=compute_wer, log=log)
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

            self.logger.log({
                "epoch": self.epoch, "lr": lr,
                "train_loss": train_loss, "train_acc": train_acc,
                "dev_loss": dev_loss, "dev_acc": dev_acc,
                "epoch_minutes": (time.time() - t0) / 60.0,
                "adjust_time": self.scheduler.adjust_time,
                "rollback": decision.rollback, "decay_lr": decision.decay_lr,
                "snapshot": decision.snapshot,
            })
            if cfg.save_every and self.epoch % cfg.save_every == 0:
                self.save_resume_checkpoint()
        return self.save_best()

    # -- persistence ----------------------------------------------------
    def _save(self, path: Path, snap) -> Path:
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
