"""A run of each kind, its look for a card skipped, at a size the CPU
holds: sound, it comes out correct under the cell's limits; with the timed
path broken underneath it, it comes out not correct, once for each fault
the kind can have: a step that leaves the state unchanged, half of each
batch left out of the loss (its mean taken over the rest), a token altered
where the decode produces it.  (One card: no exchange between cards.)"""

import pytest
import torch

from ctc_pytorch_tpu_torch.decode import fused as fused_decode
from ctc_pytorch_tpu_torch.train import loop
from gpubench import registry
from gpubench.reference.model import Arch
from gpubench.tests.cells import DECODE, TRAIN, small_job


def run(job):
    return registry.kind(job.mix["kind"]).run(job)


@pytest.mark.parametrize("cell", TRAIN + DECODE)
def test_sound_run_is_correct(cell):
    out = run(small_job(cell))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_is_not_correct(cell, monkeypatch):
    def no_update(state):
        state.step += 1

    monkeypatch.setattr(loop, "apply_gradients", no_update)
    out = run(small_job(cell))
    assert not out.correct
    assert out.checks["step_norm_gap"][0] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_left_out_is_not_correct(cell, monkeypatch):
    step = loop.train_step

    def half(state, spec, feats, frac, labels, label_lens, mask, *args,
             **kwargs):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0
        return step(state, spec, feats, frac, labels, label_lens, mask,
                    *args, **kwargs)

    monkeypatch.setattr(loop, "train_step", half)
    assert not run(small_job(cell)).correct


@pytest.mark.parametrize("cell", DECODE)
def test_altered_token_is_not_correct(cell, monkeypatch):
    collapse = fused_decode.greedy_collapse
    job = small_job(cell)
    n_class = Arch.from_config(job.config).n_class

    def altered(indices, lengths, blank=0):
        tokens, lens = collapse(indices, lengths, blank)
        first = tokens[:, 0]
        tokens = tokens.clone()
        tokens[:, 0] = torch.where(lens > 0, (first - 1) % (n_class - 2) + 2,
                                   first)
        return tokens, lens

    monkeypatch.setattr(fused_decode, "greedy_collapse", altered)
    assert not run(job).correct
