"""Data parallelism: the rank group of a training run, the device list of a
split batch, and the collectives the model and the step use.

Counterpart of ``ctc_pytorch_tpu/parallel/mesh.py``.  The JAX package puts
one program on a 1-D ``Mesh`` of chips and shards the batch over its
``data`` axis inside ``shard_map``; its ``psum``/``pmax`` are the
collectives.  The port follows PyTorch's idiom instead:

- training runs one process a rank (``torchrun``) in a ``torch.distributed``
  process group, described by a ``DataGroup``; each rank holds the whole
  model (``replicate``), gathers its own rows of every batch and takes part
  in the step's collectives (``all_sum``, ``all_max``);
- decoding and serving split a batch over a list of devices inside one
  process (``make_mesh``, ``shard_batch``, ``pad_batch_to_devices``), as the
  JAX single-process mesh does for the sharded search and the mesh
  ``Recognizer``: each row is decoded on its own, so no collective is
  needed.

``all_sum`` is differentiable: its backward sums the incoming gradient over
the group, as JAX differentiates ``psum`` inside ``shard_map``, so the
gradient of a rank's input through a synchronised batch-norm holds every
rank's term.  A plain ``torch.distributed.all_reduce`` is invisible to
autograd and would leave those terms out.  The JAX ``shard_map_compat`` (a
shim over two ``shard_map`` APIs) has no counterpart: the port runs no
``shard_map``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ctc_pytorch_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of a data-parallel run: its process group (None is
    the default group), rank, world size, device and backend."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def capturable(self) -> bool:
        """Whether the collectives can be captured in a CUDA graph: NCCL's
        run on the card; gloo's copy CUDA tensors through the host."""
        return self.backend == "nccl"


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices a batch is split over inside one process: ``devices``
    (names or ``torch.device``s; one may repeat), by default every visible
    card.  Raises when a card is asked for and there is none."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            resolve_device("cuda")  # raises: no card
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def pad_batch_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` >= ``n`` (the batch must divide
    evenly)."""
    return ((n + n_devices - 1) // n_devices) * n_devices


def shard_batch(arrays: Sequence[torch.Tensor],
                mesh: Sequence[torch.device]) -> List[tuple]:
    """Split batch-major ``arrays`` into ``len(mesh)`` contiguous row blocks,
    block r on ``mesh[r]``: the rows that ``NamedSharding(P('data'))`` gives
    device r.  Raises when a batch does not divide (see
    ``pad_batch_to_devices``)."""
    n_dev = len(mesh)
    for a in arrays:
        if a.shape[0] % n_dev != 0:
            raise ValueError(
                f"batch size {a.shape[0]} must divide the {n_dev}-device "
                "mesh; pick batch_size as a multiple (see "
                "pad_batch_to_devices)")
    return [tuple(a.chunk(n_dev, dim=0)[r].to(dev) for a in arrays)
            for r, dev in enumerate(mesh)]


@torch.no_grad()
def replicate(module: torch.nn.Module, group: DataGroup) -> None:
    """Broadcast every parameter and buffer of ``module`` from global rank 0
    over ``group``, in place (the JAX ``replicate`` of the train state)."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=group.group)


class _AllSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradient over the group
    (the transpose of a sum that every rank receives)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """``x`` summed over ``group`` (``lax.psum``), differentiable; ``x``
    itself without a group."""
    if group is None:
        return x
    return _AllSum.apply(x, group.group)


@torch.no_grad()
def all_max(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group`` (``lax.pmax``), not
    differentiable; ``x`` itself without a group."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group.group)
    return out
