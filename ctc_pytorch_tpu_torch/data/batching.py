"""Static-shape bucketed batching (copy of ``ctc_pytorch_tpu/data/batching.py``
up to ``SpeechDataLoader``), the batch order of the device cache's fused
epochs (``GroupedLoader``), and the two device-side loaders: the
device-resident dataset cache (``DeviceCachedLoader``) and the prefetching
host loader (``PrefetchLoader``).

Replaces the reference's variable-length collate (``create_input``,
``timit/utils/data_loader.py:119-151``): utterances are grouped into a small
set of **length buckets** so every batch has one of a few static (T, L)
shapes, padded with zeros.  The port keeps the same batches so that both
packages see identical inputs (and CUDA graphs can later rely on the shapes).

The reference's fractional-length contract is preserved: each batch carries
``input_frac = frames / T_bucket`` exactly like ``create_input``'s
``feature_length / inputs_max_length`` (``data_loader.py:137``), which the
train step rescales by the post-CNN output length (``train_ctc.py:46``).
True frame counts are carried too for mask-based consumers.

Batches are sized to ``batch_size`` with the final ragged batch padded by
**repeating items** (weighted out of the loss via ``example_mask``) so batch
shape is also static.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Batch:
    feats: np.ndarray  # (B, T, F) float32
    input_frac: np.ndarray  # (B,) float32, frames / T  (reference contract)
    input_lengths: np.ndarray  # (B,) int32, valid frames
    labels: np.ndarray  # (B, L) int32
    label_lengths: np.ndarray  # (B,) int32
    utts: List[str]
    example_mask: np.ndarray  # (B,) float32; 0 for repeat-padding rows

    @property
    def batch_size(self) -> int:
        return self.feats.shape[0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def collate(
    items: Sequence, t_pad: Optional[int] = None, l_pad: Optional[int] = None
) -> Batch:
    """Pad a list of (feat, label, utt) tuples into one Batch."""
    feats = [it[0] for it in items]
    labels = [it[1] for it in items]
    utts = [it[2] for it in items]
    b = len(items)
    t_max = t_pad or max(f.shape[0] for f in feats)
    l_max = l_pad or max(max((len(l) for l in labels), default=1), 1)
    dim = feats[0].shape[1]
    out_f = np.zeros((b, t_max, dim), np.float32)
    out_l = np.zeros((b, l_max), np.int32)
    in_len = np.zeros((b,), np.int32)
    lab_len = np.zeros((b,), np.int32)
    for i, (f, l) in enumerate(zip(feats, labels)):
        out_f[i, : f.shape[0]] = f
        out_l[i, : len(l)] = l
        in_len[i] = f.shape[0]
        lab_len[i] = len(l)
    return Batch(
        feats=out_f,
        input_frac=(in_len / t_max).astype(np.float32),
        input_lengths=in_len,
        labels=out_l,
        label_lengths=lab_len,
        utts=utts,
        example_mask=np.ones((b,), np.float32),
    )


class BucketBatcher:
    """Yield fixed-shape batches; three modes trading padding vs dynamics.

    - ``quantized`` (default): batches form in fully-shuffled dataset order
      — the reference loader's composition (``train_ctc.py:91``) — and each
      batch's T pads UP to the nearest of ``num_buckets`` static boundaries,
      so XLA still compiles a bounded shape set.  Matches the reference's
      training dynamics (measured: the torch recipe and this mode land
      within seed spread of each other on a hard corpus where ``bucket``
      mode was ~2.5 PER points behind).
    - ``bucket``: length-homogeneous batches (items grouped by bucket) —
      least padding, peak throughput, but batch composition correlates
      with utterance length, which measurably shifts training dynamics.
    - ``num_buckets=0``: reference-exact per-batch-max padding (dynamic
      shapes; parity/debug only).
    """

    def __init__(
        self,
        lengths: np.ndarray,
        label_lengths: np.ndarray,
        batch_size: int,
        num_buckets: int = 4,
        align: int = 8,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = False,
        mode: str = "quantized",
    ):
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        if mode not in ("quantized", "bucket"):
            raise ValueError(f"unknown batch mode: {mode!r}")
        self.mode = mode
        if num_buckets == 0:
            # reference-exact mode: batches form in (shuffled) dataset order
            # and pad to their own max T/L, byte-identical to the torch
            # collate (``create_input``, data_loader.py:119-140).  Dynamic
            # shapes recompile per batch — a parity/debug tool, not the
            # production path.
            self.boundaries = []
            self.label_pad = max(1, int(np.max(label_lengths)))
            self._assignment = None
            return
        if mode == "quantized":
            # boundaries at quantiles of the per-batch MAX distribution
            # (simulated over shuffled epochs): with random composition a
            # batch's max length concentrates near the top of the length
            # distribution, so utterance-length quantiles would put every
            # boundary where no batch max ever lands and all batches would
            # pad to ~global max — measured ~2 dev PER points worse than
            # the reference's per-batch-max padding at hard regimes.  With
            # batch-max quantiles the mean overshoot over the reference's
            # padding is a few percent, at num_buckets compiled shapes.
            sim_rng = np.random.RandomState(seed ^ 0x5EED)
            reps = []
            n = len(self.lengths)
            n_full = (n // batch_size) * batch_size
            if n_full == 0:
                # corpus smaller than one batch: every batch is the whole
                # dataset, so its max is the corpus max — use raw lengths
                maxes = self.lengths
            else:
                for _ in range(32):
                    perm = sim_rng.permutation(n)[:n_full]
                    reps.append(
                        self.lengths[perm].reshape(-1, batch_size).max(axis=1)
                    )
                maxes = np.concatenate(reps)
            qs = np.quantile(maxes, np.linspace(0, 1, num_buckets + 1)[1:])
        else:
            # bucket boundaries at utterance-length quantiles, aligned up
            qs = np.quantile(self.lengths,
                             np.linspace(0, 1, num_buckets + 1)[1:])
        self.boundaries = sorted({_round_up(int(np.ceil(q)), align) for q in qs})
        if self.boundaries[-1] < self.lengths.max():
            self.boundaries[-1] = _round_up(int(self.lengths.max()), align)
        # one static label pad per bucket keeps (T, L) pairs few
        self.label_pad = max(1, _round_up(int(np.max(label_lengths)), align))
        self._assignment = np.searchsorted(self.boundaries, self.lengths)

    def bucket_of(self, idx: int) -> int:
        return int(self.boundaries[self._assignment[idx]])

    def epoch_batches(self, epoch: int) -> Iterator[tuple]:
        """Yield (indices, t_pad, l_pad) with deterministic per-epoch shuffle."""
        rng = np.random.RandomState(self.seed + epoch)
        if self._assignment is None:  # reference-exact (num_buckets=0)
            order = np.arange(len(self.lengths))
            if self.shuffle:
                rng.shuffle(order)
            for i in range(0, len(order), self.batch_size):
                chunk = order[i : i + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    break
                yield chunk, None, None
            return
        if self.mode == "quantized":
            # reference composition, static shapes: random order, then pad
            # each batch's max T up to its quantile boundary
            order = np.arange(len(self.lengths))
            if self.shuffle:
                rng.shuffle(order)
            bounds = np.asarray(self.boundaries)
            for i in range(0, len(order), self.batch_size):
                chunk = order[i : i + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    break
                t_max = int(self.lengths[chunk].max())
                t_pad = int(bounds[np.searchsorted(bounds, t_max)])
                yield chunk, t_pad, self.label_pad
            return
        all_batches = []
        for b_idx, bound in enumerate(self.boundaries):
            members = np.nonzero(self._assignment == b_idx)[0]
            if len(members) == 0:
                continue
            if self.shuffle:
                rng.shuffle(members)
            batches = [
                members[i : i + self.batch_size]
                for i in range(0, len(members), self.batch_size)
            ]
            if self.drop_last and batches and len(batches[-1]) < self.batch_size:
                batches.pop()
            all_batches.extend((chunk, bound, self.label_pad)
                               for chunk in batches)
        if self.shuffle:
            # interleave buckets: without this every epoch ran short
            # utterances first and long last — a systematic curriculum the
            # reference's fully-shuffled loader does not have (measured
            # worse dev WER at hard regimes); batch SHAPES stay per-bucket
            rng.shuffle(all_batches)
        yield from all_batches

    def num_batches(self) -> int:
        if self._assignment is None or self.mode == "quantized":
            n_items = len(self.lengths)
            if self.drop_last:
                return n_items // self.batch_size
            return -(-n_items // self.batch_size)
        n = 0
        for b_idx in range(len(self.boundaries)):
            members = int(np.sum(self._assignment == b_idx))
            if members == 0:
                continue
            if self.drop_last:
                n += members // self.batch_size
            else:
                n += -(-members // self.batch_size)
        return n


class SpeechDataLoader:
    """Bucketed loader over a SpeechDataset (host-side, deterministic).

    Batch shapes are static per bucket; ragged final batches are repeat-padded
    to ``batch_size`` with ``example_mask`` zeros so XLA sees one batch shape.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_buckets: int = 4,
        seed: int = 0,
        drop_last: bool = False,
        pad_to_full_batch: bool = True,
        mode: str = "quantized",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_to_full_batch = pad_to_full_batch
        self.batcher = BucketBatcher(
            dataset.lengths(),
            dataset.label_lengths(),
            batch_size,
            num_buckets=num_buckets,
            seed=seed,
            shuffle=shuffle,
            drop_last=drop_last,
            mode=mode,
        )
        self.epoch = 0

    def __len__(self) -> int:
        return self.batcher.num_batches()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _make_batch(self, indices, t_pad, l_pad) -> Batch:
        items = [self.dataset[int(i)] for i in indices]
        n_real = len(items)
        if self.pad_to_full_batch and n_real < self.batch_size:
            items = items + [items[-1]] * (self.batch_size - n_real)
        batch = collate(items, t_pad, l_pad)
        if n_real < batch.batch_size:
            batch.example_mask[n_real:] = 0.0
        return batch

    def __iter__(self) -> Iterator[Batch]:
        """The epoch's batches in the batcher's order (``iter_plan``)."""
        return self.iter_plan(self.batcher.epoch_batches(self.epoch))

    def iter_plan(self, plan) -> Iterator[Batch]:
        """Assemble the batches of ``plan``, ``(indices, t_pad, l_pad)``
        triples, one step ahead on a background thread (the
        reference uses torch DataLoader worker processes for the same
        overlap, ``timit/steps/train_ctc.py:91-92``).

        Early exit safe: a consumer that stops mid-epoch (``break``, e.g.
        ``evaluate(max_batches=N)``) closes the generator, which signals the
        producer to stop instead of leaving it blocked on ``q.put`` forever
        (one leaked thread + pinned batches per aborted iteration)."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for indices, t_pad, l_pad in plan:
                    if not _put(self._make_batch(indices, t_pad, l_pad)):
                        return
                _put(sentinel)
            except BaseException as exc:  # propagate: a corrupt item must
                # fail the epoch loudly, not end it early as if complete
                _put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()



def estimate_bytes(loader: SpeechDataLoader) -> int:
    """Bytes a device cache of ``loader``'s dataset would take: fp32 feature
    planes (raw-sample planes for ``feature_type: waveform``, one value a
    sample) padded to their bucket, labels and lengths (the JAX
    ``DeviceCachedLoader.estimate_bytes``, which stage 2 checks against
    ``device_cache_max_gb`` before it takes the fused path), computed from
    the host-side bucket shapes without uploading anything.  ``num_buckets
    = 0`` cannot be cached: ``1 << 62``."""
    batcher = loader.batcher
    if batcher._assignment is None:
        return 1 << 62
    dim = loader.dataset[0][0].shape[1]
    if batcher.mode == "quantized":
        m = len(batcher.lengths)
        return m * (batcher.boundaries[-1] * dim * 4 + batcher.label_pad * 4 + 8)
    tot = 0
    for b_idx, bound in enumerate(batcher.boundaries):
        m = int(np.sum(batcher._assignment == b_idx))
        tot += m * (bound * dim * 4 + batcher.label_pad * 4 + 8)
    return tot


class GroupedLoader:
    """A ``SpeechDataLoader`` that also knows the order in which the JAX
    package's fused epochs visit its batches.

    The JAX stage 2 with ``fused_epoch`` over a device cache
    (``DeviceCachedLoader.epoch_groups``) runs the epoch's batches grouped by
    static shape ``(bucket, t_pad, B)``, groups in order of first appearance
    and batches in their order within a group; with ``fused_dispatch:
    "epoch"`` the groups go in ``t_pad`` order (a stable sort, so groups of
    equal ``t_pad`` keep their order).  The batches are the same as the
    streaming order's, so only the visiting order differs.  Iterating this
    loader gives the streaming order, as iterating the JAX cache does;
    ``grouped`` gives the fused order.  Host-only: the batches are made by
    the wrapped loader.  ``DeviceCachedLoader`` adds the device cache.
    """

    def __init__(self, loader: SpeechDataLoader):
        if loader.batcher._assignment is None:
            raise ValueError(f"{type(self).__name__} needs bucketed "
                             "(static-shape) batches; num_buckets=0 has no "
                             "groups")
        self.loader = loader
        self.batcher = loader.batcher
        self.batch_size = loader.batch_size

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def epoch(self) -> int:
        return self.loader.epoch

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self) -> Iterator[Batch]:
        return iter(self.loader)

    def _groups(self, epoch: int) -> dict:
        """``{(bucket, t_pad, B): [(indices, t_pad, l_pad), ...]}`` of the
        epoch's batches, groups in order of first appearance."""
        batcher = self.batcher
        groups: dict = {}
        for indices, t_pad, l_pad in batcher.epoch_batches(epoch):
            n = max(len(indices), self.batch_size
                    if self.loader.pad_to_full_batch else 0)
            b_idx = (0 if batcher.mode == "quantized"
                     else int(batcher._assignment[indices[0]]))
            groups.setdefault((b_idx, int(t_pad), n), []).append(
                (indices, t_pad, l_pad))
        return groups

    def epoch_plan(self, epoch: int, dispatch: str = "group") -> list:
        """The fused path's ``(indices, t_pad, l_pad)`` of ``epoch``, in its
        visiting order for ``fused_dispatch`` ``dispatch``."""
        groups = self._groups(epoch)
        keys = list(groups)
        if dispatch == "epoch":
            keys.sort(key=lambda k: k[1])
        return [b for k in keys for b in groups[k]]

    def grouped(self, dispatch: str = "group") -> Iterator[Batch]:
        """The current epoch's batches in the fused path's order."""
        return self.loader.iter_plan(self.epoch_plan(self.epoch, dispatch))


def gather_rows(arrs: dict, pos, t_pad: int, waveform: bool = False):
    """``(feats, frac, in_len, labels, label_lens)`` of the rows ``pos`` (a
    device index tensor) of a cached bucket plane ``arrs``, the features
    sliced to ``t_pad`` frames and ``frac = in_len / t_pad`` in fp32 (the
    collate's ``input_frac``, ``train_ctc.py:46``).  With ``waveform`` the
    planes hold raw samples and ``frac`` carries the sample counts, which
    the step's frontend turns into frame fractions (the JAX
    ``_gather_batch``, ``train/loop.py:218-228``).  Static shapes and no
    host read: the fused runners gather inside their CUDA graphs."""
    import torch

    in_len = arrs["in_len"].index_select(0, pos)
    frac = in_len.to(torch.float32)
    return (arrs["feats"][:, :t_pad].index_select(0, pos),
            frac if waveform else frac / t_pad, in_len,
            arrs["labels"].index_select(0, pos),
            arrs["lab_len"].index_select(0, pos))


def _padded(indices, batch_size: int, pad: bool):
    """``(idx, mask)``: the batch's dataset indices, repeat-padded to
    ``batch_size`` rows when ``pad``, and its example mask."""
    idx = np.asarray(indices)
    n_real = len(idx)
    if pad and n_real < batch_size:
        idx = np.concatenate([idx, np.repeat(idx[-1:], batch_size - n_real)])
    mask = np.ones((len(idx),), np.float32)
    mask[n_real:] = 0.0
    return idx, mask


class DeviceCachedLoader(GroupedLoader):
    """Device-resident dataset cache over a ``SpeechDataLoader``
    (counterpart of ``ctc_pytorch_tpu/data/batching.py:394-611``).

    Every bucket's padded planes are uploaded once, at construction, as
    torch tensors on ``device``: ``feats`` fp32 ``(n, t_pad, F)``,
    ``labels`` int32 ``(n, L)``, ``in_len`` and ``lab_len`` int32 ``(n,)``,
    with the plane's ``t_pad``.  In ``quantized`` batch mode one plane at the
    top boundary holds every utterance, and a batch slices it down to its
    own ``t_pad``.  Each epoch's batches are gathers over the same per-epoch
    shuffle the host loader makes (``BucketBatcher.epoch_batches`` drives
    both), so the batches are the host loader's.  Check ``estimate_bytes``
    against the budget before constructing: construction uploads the whole
    dataset.

    ``epoch_groups`` gives the fused runners (``train/loop.py``,
    ``decode/fused.py``) the batches grouped by static shape; iterating the
    loader gathers each batch on the device in the streaming order.  As a
    ``GroupedLoader`` it also gives the host-made batches in the fused order
    (``grouped``).

    ``group`` (data parallel, ``parallel/mesh.py:DataGroup``): every rank
    holds the whole cache on its device and builds the same global batches
    from the same seed (the JAX cache is replicated over the mesh,
    ``batching.py:406-440``); ``epoch_groups`` and ``__iter__`` give the
    rank's contiguous rows of each (``parallel/distributed.py:row_slice``).
    """

    estimate_bytes = staticmethod(estimate_bytes)

    def __init__(self, loader: SpeechDataLoader,
                 device: str | "torch.device" = "cuda", group=None):
        import torch

        from ctc_pytorch_tpu_torch import resolve_device
        from ctc_pytorch_tpu_torch.parallel.distributed import row_slice

        super().__init__(loader)
        self.device = dev = resolve_device(device)
        self._rows = (slice(None) if group is None else
                      row_slice(loader.batch_size, group.rank, group.world))
        self.pad_to_full_batch = loader.pad_to_full_batch
        ds = loader.dataset
        batcher = loader.batcher
        self._utts = [ds.items[i][0] for i in range(len(ds))]
        n = len(ds)

        def upload(members, t_pad: int) -> dict:
            host = collate([ds[int(i)] for i in members], t_pad,
                           batcher.label_pad)
            put = {k: torch.from_numpy(v).to(dev) for k, v in (
                ("feats", host.feats), ("labels", host.labels),
                ("in_len", host.input_lengths),
                ("lab_len", host.label_lengths))}
            put["t_pad"] = t_pad
            return put

        self._bucket_arrays: dict = {}
        if batcher.mode == "quantized":
            self._bucket_of = np.zeros(n, np.int64)
            self._pos_in_bucket = np.arange(n)
            self._bucket_arrays[0] = upload(range(n), batcher.boundaries[-1])
        else:
            self._bucket_of = batcher._assignment
            self._pos_in_bucket = np.zeros(n, np.int64)
            for b_idx, bound in enumerate(batcher.boundaries):
                members = np.nonzero(self._bucket_of == b_idx)[0]
                if len(members) == 0:
                    continue
                self._pos_in_bucket[members] = np.arange(len(members))
                self._bucket_arrays[b_idx] = upload(members, bound)

    def total_bytes(self) -> int:
        return sum(arrs[k].numel() * arrs[k].element_size()
                   for arrs in self._bucket_arrays.values()
                   for k in ("feats", "labels", "in_len", "lab_len"))

    def epoch_groups(self, epoch: int, with_indices: bool = False):
        """The epoch's batches grouped by static shape, for the fused
        runners: ``(arrs, pos, mask, t_pad)`` per group, where ``arrs`` is
        the bucket's dict of device planes, ``pos`` an ``(n_batches, B)``
        int32 matrix of row positions into them and ``mask`` the matching
        ``(n_batches, B)`` float32 example masks (numpy, as the JAX method
        gives them).  The batches are ``__iter__``'s; only the order
        differs: grouped by ``(bucket, t_pad, B)`` in order of first
        appearance, the order within a group kept.  ``with_indices=True``
        appends the ``(n_batches, B)`` int64 dataset indices, so that a
        consumer can name the utterances (the fused stage-4 decode).  With a
        group, B is the rank's share of each batch.  Each group's host work
        (the first's with the epoch's plan) is one ``ctc.loader.plan`` span
        (``spans.py``), closed before the group is yielded."""
        from ctc_pytorch_tpu_torch.spans import span

        with span("loader.plan"):
            groups = list(self._groups(epoch).items())
            out = self._group(groups[0], with_indices) if groups else None
        for k, group in enumerate(groups):
            if k:
                with span("loader.plan"):
                    out = self._group(group, with_indices)
            yield out

    def _group(self, group, with_indices: bool) -> tuple:
        """One ``epoch_groups`` entry from a ``_groups`` item."""
        (b_idx, tp, _), batches = group
        poss, masks, idxs = [], [], []
        for indices, _, _ in batches:
            idx, mask = _padded(indices, self.batch_size,
                                self.pad_to_full_batch)
            idx, mask = idx[self._rows], mask[self._rows]
            poss.append(self._pos_in_bucket[idx])
            masks.append(mask)
            idxs.append(idx)
        out = (self._bucket_arrays[b_idx], np.stack(poss).astype(np.int32),
               np.stack(masks).astype(np.float32), tp)
        if with_indices:
            out = out + (np.stack(idxs).astype(np.int64),)
        return out

    def __iter__(self) -> Iterator[Batch]:
        """The epoch's batches in the streaming order, each gathered on the
        device: a ``Batch`` of device tensors (the mask too); with a group,
        the rank's rows."""
        import torch

        for indices, t_pad, _ in self.batcher.epoch_batches(self.epoch):
            idx, mask = _padded(indices, self.batch_size,
                                self.pad_to_full_batch)
            idx, mask = idx[self._rows], mask[self._rows]
            arrs = self._bucket_arrays[int(self._bucket_of[idx[0]])]
            pos = torch.from_numpy(self._pos_in_bucket[idx]).to(self.device)
            feats, frac, in_len, labels, lab_len = gather_rows(
                arrs, pos, t_pad or arrs["t_pad"])
            yield Batch(feats=feats, input_frac=frac, input_lengths=in_len,
                        labels=labels, label_lengths=lab_len,
                        utts=[self._utts[int(i)] for i in idx],
                        example_mask=torch.from_numpy(mask).to(self.device))


class PrefetchLoader:
    """Host-to-device prefetch over a ``SpeechDataLoader`` (counterpart of
    ``ctc_pytorch_tpu/data/batching.py:334-392``), for a dataset too big for
    the device cache.

    The copies of batches N+1 .. N+``depth`` are issued before batch N is
    yielded, so that they overlap step N.  Each batch is copied from pinned
    host memory with ``non_blocking`` copies on a side stream, and an event
    recorded after its copies; when the batch is yielded, the caller's
    stream waits for that event alone, so step N waits only for its own
    batch.  All copies are issued on the calling thread (the wrapped
    loader's thread only collates host arrays).  Yields ``Batch``es of
    device tensors (the example mask too).  On the CPU the batches are
    converted to tensors, with nothing to overlap.  With a data-parallel
    ``group`` each batch is cut to the rank's rows on the host, before its
    pinned copy (``parallel/distributed.py:local_rows``).
    """

    FIELDS = ("feats", "input_frac", "input_lengths", "labels",
              "label_lengths", "example_mask")

    def __init__(self, loader: SpeechDataLoader,
                 device: str | "torch.device" = "cuda", depth: int = 2,
                 group=None):
        from ctc_pytorch_tpu_torch import resolve_device

        self.loader = loader
        self.depth = depth
        self.batch_size = loader.batch_size
        self.device = resolve_device(device)
        self.group = group

    def _host_batches(self) -> Iterator[Batch]:
        """The wrapped loader's batches, cut to the rank's rows."""
        from ctc_pytorch_tpu_torch.parallel.distributed import local_rows

        for b in self.loader:
            yield (b if self.group is None
                   else local_rows(b, self.group.rank, self.group.world))

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self) -> Iterator[Batch]:
        import dataclasses
        from collections import deque

        import torch

        if self.device.type != "cuda":
            for b in self._host_batches():
                yield dataclasses.replace(b, **{
                    k: torch.from_numpy(getattr(b, k)) for k in self.FIELDS})
            return
        copy_stream = torch.cuda.Stream(self.device)
        pending: deque = deque()

        def put(b: Batch):
            with torch.cuda.stream(copy_stream):
                moved = {k: torch.from_numpy(getattr(b, k)).pin_memory().to(
                    self.device, non_blocking=True) for k in self.FIELDS}
                done = torch.cuda.Event()
                done.record(copy_stream)
            return dataclasses.replace(b, **moved), done

        def ready(b: Batch, done) -> Batch:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for k in self.FIELDS:
                # the copy stream made these; keep them from its reuse until
                # the caller's stream is done with them
                getattr(b, k).record_stream(stream)
            return b

        for b in self._host_batches():
            pending.append(put(b))
            if len(pending) > self.depth:
                yield ready(*pending.popleft())
        while pending:
            yield ready(*pending.popleft())
