"""The port's device-side loaders against the JAX package's on the CPU: the
device cache's groups (``epoch_groups``: ``pos``, ``mask``, ``t_pad`` and
dataset indices, in order), its budget estimate and footprint, the batches
its iteration gathers, and the prefetching loader's batches.  Exact: these
are integer plans and copied values."""

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.config import Config as JConfig
from ctc_pytorch_tpu.data import SpeechDataLoader as JLoader
from ctc_pytorch_tpu.data import SpeechDataset as JDataset
from ctc_pytorch_tpu.data.batching import DeviceCachedLoader as JCache
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.config import Config
from ctc_pytorch_tpu_torch.data import (
    DeviceCachedLoader,
    GroupedLoader,
    PrefetchLoader,
    SpeechDataLoader,
    SpeechDataset,
    estimate_bytes,
)
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_fused_order import corpus, fused_config

BATCH_FIELDS = ("feats", "input_frac", "input_lengths", "labels",
                "label_lengths", "example_mask")


def loaders(tmp_path, mode, shuffle=True, split="train", pad=True):
    """The port's and the JAX package's host loaders over one split."""
    corpus(tmp_path, n_train=30, n_dev=9)
    out = []
    for cfg_cls, ds_cls, loader_cls, vocab_cls in (
            (Config, SpeechDataset, SpeechDataLoader, Vocab),
            (JConfig, JDataset, JLoader, JVocab)):
        cfg = fused_config(cfg_cls, tmp_path, mode=mode)
        scp, lab = ((cfg.train_scp_path, cfg.train_lab_path) if split == "train"
                    else (cfg.valid_scp_path, cfg.valid_lab_path))
        ds = ds_cls(vocab_cls(cfg.vocab_file), scp, lab, cfg)
        out.append(loader_cls(ds, cfg.batch_size, shuffle=shuffle,
                              num_buckets=cfg.num_buckets, seed=cfg.seed,
                              mode=cfg.batch_mode, pad_to_full_batch=pad))
    return out


@pytest.mark.parametrize("mode", ["quantized", "bucket"])
@pytest.mark.parametrize("pad", [True, False])
def test_epoch_groups_match_jax(tmp_path, mode, pad):
    ours, theirs = loaders(tmp_path, mode, pad=pad)
    cache, jcache = DeviceCachedLoader(ours, "cpu"), JCache(theirs)
    assert isinstance(cache, GroupedLoader)
    for epoch in (0, 1, 2, 3):
        got = list(cache.epoch_groups(epoch, with_indices=True))
        want = list(jcache.epoch_groups(epoch, with_indices=True))
        assert len(got) == len(want) >= 2
        for (arrs, pos, mask, t_pad, idx), (jarrs, jpos, jmask, jt, jidx) in zip(
                got, want):
            assert t_pad == jt and arrs["t_pad"] == jarrs["t_pad"]
            assert pos.dtype == jpos.dtype and mask.dtype == jmask.dtype
            np.testing.assert_array_equal(pos, jpos)
            np.testing.assert_array_equal(mask, jmask)
            np.testing.assert_array_equal(idx, jidx)
            for k in ("feats", "labels", "in_len", "lab_len"):
                np.testing.assert_array_equal(arrs[k].numpy(),
                                              np.asarray(jarrs[k]))
        # without indices: the first four entries of the same groups
        plain = list(cache.epoch_groups(epoch))
        assert all(len(g) == 4 for g in plain)
        # the fused order is the GroupedLoader's: the same batches, grouped
        flat = [list(i) for g in got for i in g[4]]
        plan = [list(i) for i, _, _ in cache.epoch_plan(epoch, "group")]
        assert [row[:len(p)] for row, p in zip(flat, plan)] == plan


@pytest.mark.parametrize("mode", ["quantized", "bucket"])
def test_estimate_and_footprint_match_jax(tmp_path, mode):
    ours, theirs = loaders(tmp_path, mode)
    est = estimate_bytes(ours)
    assert est == DeviceCachedLoader.estimate_bytes(ours)
    assert est == JCache.estimate_bytes(theirs)
    cache, jcache = DeviceCachedLoader(ours, "cpu"), JCache(theirs)
    assert cache.total_bytes() == jcache.total_bytes() == est
    assert cache.device == torch.device("cpu")


@pytest.mark.parametrize("mode", ["quantized", "bucket"])
def test_iteration_gathers_the_jax_batches(tmp_path, mode):
    ours, theirs = loaders(tmp_path, mode)
    cache, jcache = DeviceCachedLoader(ours, "cpu"), JCache(theirs)
    for epoch in (1, 2):
        cache.set_epoch(epoch)
        jcache.set_epoch(epoch)
        ours.set_epoch(epoch)
        got, want, host = list(cache), list(jcache), list(ours)
        assert len(got) == len(want) == len(host) == len(cache)
        for g, w, h in zip(got, want, host):
            assert g.utts == w.utts == h.utts
            for k in BATCH_FIELDS:
                gv = getattr(g, k)
                assert isinstance(gv, torch.Tensor)
                np.testing.assert_array_equal(gv.numpy(),
                                              np.asarray(getattr(w, k)))
            # and the host loader's: frac, divided in fp32 here and in fp64
            # then rounded to fp32 there, comes out the same
            for k in BATCH_FIELDS:
                np.testing.assert_array_equal(getattr(g, k).numpy(),
                                              getattr(h, k))


def test_cache_refuses_unbucketed_batches(tmp_path):
    ours, _ = loaders(tmp_path, "quantized")
    ours.batcher._assignment = None  # num_buckets=0
    with pytest.raises(ValueError, match="bucketed"):
        DeviceCachedLoader(ours, "cpu")
    assert estimate_bytes(ours) == 1 << 62


def test_prefetch_loader_yields_the_host_batches(tmp_path):
    ours, theirs = loaders(tmp_path, "bucket", split="dev", shuffle=False)
    pre = PrefetchLoader(ours, "cpu")
    assert len(pre) == len(ours) and pre.batch_size == ours.batch_size
    pre.set_epoch(3)
    assert ours.epoch == 3
    got, want = list(pre), list(ours)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.utts == w.utts
        for k in BATCH_FIELDS:
            assert isinstance(getattr(g, k), torch.Tensor)
            np.testing.assert_array_equal(getattr(g, k).numpy(), getattr(w, k))
    # the JAX PrefetchLoader's batches are the same
    from ctc_pytorch_tpu.data.batching import PrefetchLoader as JPrefetch

    for g, w in zip(got, JPrefetch(theirs)):
        np.testing.assert_array_equal(g.feats.numpy(), np.asarray(w.feats))
        np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels))
    with pytest.raises(RuntimeError, match="CUDA"):
        PrefetchLoader(ours)  # the card by default: no silent CPU run
