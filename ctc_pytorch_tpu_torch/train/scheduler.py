"""Plateau LR scheduler with snapshot rollback (copy of
``ctc_pytorch_tpu/train/scheduler.py``, which imports no JAX) — the reference's exact
state machine (``timit/steps/train_ctc.py:160-227``), extracted so it is
unit-testable and reusable.

Band test on dev loss against ``loss_best ± end_adjust_acc``:

- improvement beyond the band: reset counter, snapshot model+optimizer;
- within the band: counter += 1; additionally snapshot when the loss is a new
  true best;
- worse than the band: counter jumps straight to 10;
- at counter == 10: halve (``lr_decay``) the LR *next epoch*, roll model and
  optimizer back to the last snapshot, ``adjust_time += 1``;
- stop after ``adjust_time == 8`` decays (``train_ctc.py:226-227``).

Separately tracks the best dev-accuracy state for the final save
(``train_ctc.py:209-212, 240-242``).

The 863 variant (``my_863_corpus/steps/cnn_lstm_ctc.py:175-241``; pass
``mode='acc'``) keys the machine on dev *accuracy in percent* (its ``dev()``
returns ``acc*100`` — :81-82) and differs from the TIMIT machine in three
ways, all reproduced here:

- a big improvement (branch 1) updates ``acc_best`` but NOT
  ``acc_best_true`` (:213-217);
- an epoch *worse than the band* resets the counter to 0 instead of
  forcing an immediate decay (:224-225 vs ``train_ctc.py:206-207``);
- at decay, ``acc_best = acc_best_true`` unconditionally (:236), whereas
  TIMIT guards it with ``if loss_best > loss_best_true``.

``least_train_epoch`` appears in the reference conf
(``cnn_lstm_ctc_setting.conf:21``) but is never read by the reference code;
this framework implements the natural reading (no LR adjustment before that
epoch) via ``allow_adjust``.
"""

from __future__ import annotations

import dataclasses

@dataclasses.dataclass
class PlateauDecision:
    snapshot: bool = False  # save rollback snapshot of model+optimizer
    snapshot_best: bool = False  # save "best dev accuracy" state
    rollback: bool = False  # restore rollback snapshot now
    decay_lr: bool = False  # multiply LR by lr_decay at next epoch start
    stop: bool = False


@dataclasses.dataclass
class PlateauScheduler:
    end_adjust_acc: float = 2.0
    lr_decay: float = 0.5
    max_decays: int = 8
    mode: str = "loss"  # 'loss' (timit) | 'acc' (863 keyed on accuracy)

    loss_best: float = 1000.0
    loss_best_true: float = 1000.0
    adjust_rate_count: int = 0
    adjust_time: int = 0
    acc_best: float = 0.0

    def update(self, dev_loss: float, dev_acc: float,
               allow_adjust: bool = True) -> PlateauDecision:
        """``allow_adjust=False`` implements the 863 recipe's
        ``least_train_epoch`` warmup: track bests/snapshots but never decay."""
        d = PlateauDecision()
        acc_mode = self.mode == "acc"
        # 863 works in accuracy *percent* (dev() returns acc*100,
        # cnn_lstm_ctc.py:82) negated so "smaller is better" like loss mode
        metric = -dev_acc * 100.0 if acc_mode else dev_loss
        if metric < (self.loss_best - self.end_adjust_acc):
            self.loss_best = metric
            if not acc_mode:  # 863 leaves acc_best_true (cnn_lstm_ctc:213-217)
                self.loss_best_true = metric
            self.adjust_rate_count = 0
            d.snapshot = True
        elif metric < self.loss_best + self.end_adjust_acc:
            self.adjust_rate_count += 1
            if metric < self.loss_best and metric < self.loss_best_true:
                self.loss_best_true = metric
                d.snapshot = True
        else:
            # much worse: TIMIT forces an immediate decay (count=10,
            # train_ctc.py:206-207); 863 just resets (cnn_lstm_ctc:224-225)
            self.adjust_rate_count = 0 if acc_mode else 10

        if dev_acc > self.acc_best:
            self.acc_best = dev_acc
            d.snapshot_best = True

        if self.adjust_rate_count == 10:
            if allow_adjust:
                d.decay_lr = True
                d.rollback = True
                self.adjust_time += 1
                if acc_mode or self.loss_best > self.loss_best_true:
                    self.loss_best = self.loss_best_true
            self.adjust_rate_count = 0

        if self.adjust_time == self.max_decays:
            d.stop = True
        return d

    # -- (de)serialisation for checkpoints --------------------------------
    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "PlateauScheduler":
        return cls(**d)
