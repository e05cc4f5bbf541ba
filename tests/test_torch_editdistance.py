"""The port's device edit distance and per-batch token errors against the JAX
package's on the CPU, on seeded random padded sequences (empty ones
included).  Exact: integer DPs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.ops.editdistance import (
    padded_edit_distance_device as jax_padded_edit_distance,
)
from ctc_pytorch_tpu.train.loop import _device_token_errors
from ctc_pytorch_tpu_torch.ops.editdistance import (
    edit_distance,
    padded_edit_distance_device,
)
from ctc_pytorch_tpu_torch.train.loop import device_token_errors


def padded_pairs(seed, b, n, m, vocab=4):
    rng = np.random.RandomState(seed)
    refs = rng.randint(0, vocab, (b, n)).astype(np.int32)
    hyps = rng.randint(0, vocab, (b, m)).astype(np.int32)
    ref_lens = rng.randint(0, n + 1, b).astype(np.int32)
    hyp_lens = rng.randint(0, m + 1, b).astype(np.int32)
    ref_lens[0], hyp_lens[1 % b] = 0, 0  # an empty ref and an empty hyp
    return refs, ref_lens, hyps, hyp_lens


@pytest.mark.parametrize("seed,b,n,m", [
    (0, 6, 5, 9), (1, 4, 12, 3), (2, 1, 1, 1), (3, 9, 8, 8), (4, 3, 20, 40),
])
def test_padded_edit_distance_matches_jax(seed, b, n, m):
    refs, ref_lens, hyps, hyp_lens = padded_pairs(seed, b, n, m)
    want = np.asarray(jax_padded_edit_distance(
        jnp.asarray(refs), jnp.asarray(ref_lens), jnp.asarray(hyps),
        jnp.asarray(hyp_lens)))
    got = padded_edit_distance_device(
        torch.from_numpy(refs), torch.from_numpy(ref_lens),
        torch.from_numpy(hyps), torch.from_numpy(hyp_lens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the scalar DP of each pair
    assert list(got.numpy()) == [
        edit_distance(refs[i, :ref_lens[i]], hyps[i, :hyp_lens[i]])
        for i in range(b)]


def test_hyp_lengths_past_the_pad_are_clamped():
    refs, ref_lens, hyps, _ = padded_pairs(5, 4, 6, 5)
    hyp_lens = np.full(4, 9, np.int32)  # longer than the (B, 5) plane
    want = jax_padded_edit_distance(*map(jnp.asarray,
                                         (refs, ref_lens, hyps, hyp_lens)))
    got = padded_edit_distance_device(*map(torch.from_numpy,
                                           (refs, ref_lens, hyps, hyp_lens)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_token_errors_match_jax(seed):
    rng = np.random.RandomState(seed)
    b, t, l, c = 5, 14, 6, 5
    greedy = rng.randint(0, c, (b, t)).astype(np.int32)
    greedy[:, 4:7] = 3  # repeats collapse
    sizes = rng.randint(0, t + 1, b).astype(np.int32)
    labels = rng.randint(1, c, (b, l)).astype(np.int32)
    label_lens = rng.randint(0, l + 1, b).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 0], np.float32)  # repeat-padded rows
    want = _device_token_errors(*map(jnp.asarray,
                                     (greedy, sizes, labels, label_lens, mask)))
    got = device_token_errors(*map(torch.from_numpy,
                                   (greedy, sizes, labels, label_lens, mask)))
    assert [int(x) for x in got] == [int(x) for x in want]
    assert all(x.dtype == torch.int64 and x.dim() == 0 for x in got)
