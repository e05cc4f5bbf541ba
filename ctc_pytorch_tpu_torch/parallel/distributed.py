"""Process-group start-up, per-rank rows and seeds, and a local launcher.

Counterpart of ``ctc_pytorch_tpu/parallel/distributed.py``.  Where the JAX
package brings up ``jax.distributed`` and lets one program span every chip,
the port runs one process a rank, as ``torchrun`` starts them, and joins
them in a ``torch.distributed`` process group (``initialize``): NCCL on
cards, gloo on the CPU.  Every rank reads the whole scp list and builds the
same global batch plan from the same seed; a rank computes on its own
contiguous rows of each global batch (``local_rows``), the rows that the
JAX ``NamedSharding(P('data'))`` places on device r.  ``make_global_batch``
puts a rank's rows on its device, checking that every rank holds as many:
the concatenation in rank order is the global batch.  ``shard_for_host``
(round-robin over a list) is kept for callers that split a file list.

``spawn_ranks`` starts ``world`` ranks of a function on this machine with a
file store in a temporary directory, for the tests and for runs of several
ranks on one card (two gloo ranks can share a card; NCCL refuses two ranks
on one device).
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.parallel.mesh import DataGroup

log = logging.getLogger(__name__)


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device: str | torch.device = "cuda") -> Optional[DataGroup]:
    """Join this process to a ``torch.distributed`` group and return its
    ``DataGroup``; None for a single process.

    With no ``init_method``, ``world_size`` and ``rank`` it reads
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``).  A world of one, or no such
    environment, is a logged no-op, as in the JAX ``initialize``.  A failed
    start raises: a rank never continues alone.

    ``device``: ``cuda`` puts each rank on ``cuda:LOCAL_RANK``; a device
    with an index (``cuda:0``) puts every rank there; ``cpu`` the CPU."""
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        log.info("parallel.initialize: a world of one process; continuing "
                 "without a process group")
        return None
    if rank is None:
        if "RANK" not in env:
            raise RuntimeError(f"WORLD_SIZE={world_size} but RANK is not "
                               "set: start the ranks with torchrun")
        rank = int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return DataGroup(None, rank, world_size, dev, backend)


def shutdown(group: Optional[DataGroup]) -> None:
    """Leave the default process group that ``initialize`` joined."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


def shard_for_host(items: Sequence, rank: int, world: int) -> list:
    """Deterministic per-rank share of a list: round-robin by index, so the
    shares stay balanced on length-sorted lists."""
    return [x for i, x in enumerate(items) if i % world == rank]


def row_slice(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous rows ``[r n/W, (r+1) n/W)`` of ``n``."""
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split over {world} "
                         "ranks: batch_size must be a multiple of the world")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def local_rows(batch, rank: int, world: int):
    """Rank ``rank``'s rows of a global batch: a ``Batch`` (every field,
    ``utts`` too) or one array or tensor, sliced on its first axis."""
    import dataclasses

    if dataclasses.is_dataclass(batch):
        rows = row_slice(batch.feats.shape[0], rank, world)
        return dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name)[rows]
            for f in dataclasses.fields(batch)})
    return batch[row_slice(batch.shape[0], rank, world)]


def make_global_batch(local_arrays: Sequence, group: Optional[DataGroup],
                      device: str | torch.device | None = None
                      ) -> Tuple[torch.Tensor, ...]:
    """A rank's share of a global batch from its local arrays (numpy or
    tensors): each on ``device`` (by default the group's; ``cuda`` without
    a group), the counterpart of the JAX ``make_global_batch``
    (``distributed.py:69-77``).  Under ``torch.distributed`` a rank's tensor
    is its shard, and the global batch is the ranks' rows in rank order, as
    ``row_slice`` / ``local_rows`` cut them; so, as
    ``jax.make_array_from_process_local_data`` requires, every rank must
    hold the same number of rows of each array: one all-gather of the row
    counts checks it, and a mismatch raises on every rank.  A world of one
    (no group) returns the arrays on the device."""
    if device is None:
        device = group.device if group is not None else "cuda"
    dev = resolve_device(device)
    out = tuple(torch.as_tensor(a).to(dev) for a in local_arrays)
    if group is None:
        return out
    # NCCL gathers on the card, gloo on the host
    cdev = group.device if group.backend == "nccl" else torch.device("cpu")
    rows = torch.tensor([t.shape[0] for t in out], dtype=torch.int64,
                        device=cdev)
    parts = [torch.empty_like(rows) for _ in range(group.world)]
    dist.all_gather(parts, rows, group=group.group)
    gathered = torch.stack(parts).cpu()
    if not bool((gathered == gathered[0]).all()):
        raise ValueError(
            "make_global_batch: the ranks hold different row counts (rank x "
            f"array: {gathered.tolist()}); every rank must hold as many rows "
            "of each array")
    return out


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout stream: ``seed`` on rank 0, so a
    group of one draws what a single process draws, and a mix of ``seed``
    and the rank elsewhere (the JAX step folds its key with
    ``axis_index``)."""
    if rank == 0:
        return seed
    x = (seed * 0x9E3779B97F4A7C15 + rank * 0xBF58476D1CE4E5B9) % (1 << 64)
    x ^= x >> 31
    return x % (1 << 63)


def _rank_main(rank: int, fn: Callable, world: int, root: str, args: tuple,
               threads: int) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        out = fn(rank, world, f"file://{root}/store", *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, Path(root) / f"rank{rank}.pt")


def spawn_ranks(fn: Callable, world: int, args: tuple = (),
                timeout: float = 600.0, threads: int = 0) -> list:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` fresh
    processes (the spawn start method) and return each rank's return value,
    in rank order.  ``init_method`` is a file store in a new temporary
    directory, for ``initialize`` or ``init_process_group``.  A rank that
    raises or exits non-zero raises here with its traceback; ranks still
    running after ``timeout`` seconds are killed and raise ``TimeoutError``.
    ``threads`` > 0 sets each rank's ``torch.set_num_threads``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as root:
        ctx = mp.start_processes(_rank_main, args=(fn, world, root, args,
                                                   threads),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                   f"past {timeout} s")
        return [torch.load(Path(root) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
