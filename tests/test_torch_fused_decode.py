"""The port's fused stage-4 decode against the JAX package's on the CPU: the
group decoder's tokens (``make_fused_decode_fn``) and the printed lines,
strings and scores of ``evaluate`` on its fused path (the JAX
``_evaluate_fused``), and the port's fused path against its own streaming
loop.  Exact: an fp32 package with a sharp output layer (as
``tests/test_torch_decode.py``), so that no argmax sits on a tie."""

import dataclasses

import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.cli.test import evaluate as jax_evaluate
from ctc_pytorch_tpu.data import SpeechDataLoader as JLoader
from ctc_pytorch_tpu.data import SpeechDataset as JDataset
from ctc_pytorch_tpu.data.batching import DeviceCachedLoader as JCache
from ctc_pytorch_tpu.decode.fused import make_fused_decode_fn as jax_fused_fn
from ctc_pytorch_tpu.train.checkpoint import model_from_package as jax_package
from ctc_pytorch_tpu.vocab import Vocab as JVocab
from ctc_pytorch_tpu_torch.cli.test import evaluate
from ctc_pytorch_tpu_torch.data import (
    DeviceCachedLoader,
    SpeechDataLoader,
    SpeechDataset,
)
from ctc_pytorch_tpu_torch.decode.fused import make_fused_decode_fn
from ctc_pytorch_tpu_torch.train.checkpoint import model_from_package
from ctc_pytorch_tpu_torch.vocab import Vocab
from tests.test_torch_decode import _stage4_setup


def stage4(tmp_path, add_cnn, fc_scale=10.0):
    """``_stage4_setup`` with length-bucketed batches: two bucket planes, so
    two groups of batches."""
    pkg, confs = _stage4_setup(tmp_path, add_cnn, fc_scale=fc_scale)
    for cfg in confs:
        cfg.batch_mode = "bucket"
    return pkg, confs


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_group_decoder_matches_jax(tmp_path, mode):
    """The group decoder's tokens and lengths are the JAX one's, greedy and
    beam (width 6, a random bigram table, ``beam_max_len`` 4, which some
    hypotheses fill; a softer output layer, so that the search keeps more
    than one label)."""
    pkg, (jcfg, cfg) = stage4(tmp_path, add_cnn=True,
                              fc_scale=10.0 if mode == "greedy" else 0.5)
    spec, model, _ = model_from_package(pkg, "cpu")
    jspec, params, mstate, _ = jax_package(pkg)
    n_class = spec.num_class
    table = np.log(np.random.RandomState(5).dirichlet(
        np.ones(n_class + 1), n_class + 1)).astype(np.float32)
    beam = dict(beam_width=6, beam_max_len=4, lm_alpha=0.3)
    kw = {} if mode == "greedy" else beam

    def loader(ds_cls, loader_cls, vocab_cls, c):
        ds = ds_cls(vocab_cls(c.vocab_file), c.test_scp_path, c.test_lab_path,
                    c)
        return loader_cls(ds, c.batch_size, shuffle=False,
                          num_buckets=c.num_buckets, mode=c.batch_mode)

    cache = DeviceCachedLoader(loader(SpeechDataset, SpeechDataLoader, Vocab,
                                      cfg), "cpu")
    jcache = JCache(loader(JDataset, JLoader, JVocab, jcfg))
    fused = make_fused_decode_fn(
        spec, model, mode=mode, **kw,
        **({} if mode == "greedy" else {"lm_table": torch.from_numpy(table)}))
    jfused = jax_fused_fn(
        jspec, params, mstate, mode=mode, **kw,
        **({} if mode == "greedy" else {"lm_table": table}))
    n_groups = longest = 0
    for (arrs, pos, _, t_pad), (jarrs, jpos, _, jt) in zip(
            cache.epoch_groups(0), jcache.epoch_groups(0)):
        tokens, lens = fused(arrs, pos, t_pad)
        jtokens, jlens = jfused(jarrs, jpos, jt)
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
        longest = max(longest, int(lens.max()))
        assert lens.numpy().sum() > 0
        n_groups += 1
    assert n_groups >= 2
    assert longest == (1 if mode == "greedy" else beam["beam_max_len"])
    assert len(fused.graphs) == 0  # the CPU runs the step eagerly
    with pytest.raises(ValueError, match="mode"):
        make_fused_decode_fn(spec, model, mode="Beam")


@pytest.mark.parametrize("add_cnn", [True, False])
def test_fused_evaluate_prints_the_jax_fused_lines(tmp_path, add_cnn):
    """``evaluate`` on the fused path prints the JAX fused path's lines in
    its order, and decodes the streaming loop's strings."""
    pkg, (jcfg, cfg) = stage4(tmp_path, add_cnn)
    assert cfg.fused_decode and jcfg.fused_decode  # the default
    lines, jlines = [], []
    got = evaluate(cfg, str(pkg), device="cpu", log=lines.append)
    want = jax_evaluate(jcfg, str(pkg), log=jlines.append)
    assert got["fused"] and got["batches"] == 3
    n = 3 * 11  # utt / origin / decoded per utterance
    assert lines[:n + 2] == jlines[:n + 2]  # the utterances, CER and WER
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]

    # the streaming loop: the same strings and scores
    stream_lines = []
    streamed = evaluate(dataclasses.replace(cfg, fused_decode=False), str(pkg),
                        device="cpu", log=stream_lines.append)
    assert "fused" not in streamed and streamed["batches"] == 3

    def decoded(ls):
        return {u: d for u, d in zip(ls[:n:3], ls[2:n:3])}

    assert decoded(stream_lines) == decoded(lines)
    assert streamed["cer"] == got["cer"] and streamed["wer"] == got["wer"]
    # a test set past the cache budget streams
    small = dataclasses.replace(cfg, device_cache_max_gb=1e-9)
    assert "fused" not in evaluate(small, str(pkg), device="cpu",
                                   log=lambda *_: None)
