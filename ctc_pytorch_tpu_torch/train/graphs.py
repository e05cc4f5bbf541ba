"""Captured CUDA graphs of a step, one per static shape.

PyTorch's counterpart of the JAX package's jitted group and epoch programs
(``train/loop.py:make_fused_fns``, ``decode/fused.py``): where XLA compiles
one program per static shape, the port captures one CUDA graph per static
shape key and replays it, so that the host does no per-kernel work on the
hot path.  ``StepGraphs`` holds the graphs of a runner, in one private
memory pool that every shape shares (the graphs replay one at a time on one
stream, and no tensor made inside a capture is read after another graph's
replay: persistent state and accumulators are made outside the captures).

The capture of a key happens at its first use:

1. the step runs once on a side stream (the warm-up), so that cuBLAS
   handles and workspaces and every lazily made tensor exist before the
   capture; a ``guard`` (a context manager) puts back what the warm-up
   changed (the training runners snapshot and restore the train state and
   the dropout generator);
2. the step is captured on the pool, with each ``torch.Generator`` that it
   draws from registered with the graph, so that every replay draws fresh
   numbers;
3. the launch counts of the op modules (``ops/launch_counts.py``) are put
   back to what they were before the warm-up: the graph keeps what its
   capture added and adds it again at every replay.

A capture or a replay that fails raises: nothing falls back to an eager
step on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch

from ctc_pytorch_tpu_torch.ops import launch_counts
from ctc_pytorch_tpu_torch.spans import span


@dataclasses.dataclass
class Captured:
    """One captured step: its graph, its static input buffers, the outputs
    its replays write, and the launch counts one replay stands for."""

    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]
    outputs: tuple
    counts: launch_counts.Counts
    replays: int = 0

    def replay(self) -> tuple:
        with span("graphs.replay"):
            self.graph.replay()
            launch_counts.add(self.counts)
        self.replays += 1
        return self.outputs


class StepGraphs:
    """The captured graphs of one runner, keyed by static shape, in one
    private memory pool; counts what the captures cost."""

    def __init__(self, generators: Sequence[torch.Generator] = ()):
        self.generators = [g for g in generators if g is not None]
        self.graphs: Dict[Hashable, Captured] = {}
        self.pool = None
        self.capture_seconds = 0.0

    def __len__(self) -> int:
        return len(self.graphs)

    def replays(self) -> int:
        """Replays of all the graphs so far."""
        return sum(c.replays for c in self.graphs.values())

    def get(self, key: Hashable) -> Optional[Captured]:
        return self.graphs.get(key)

    def capture(self, key: Hashable, step: Callable[[], tuple],
                inputs: Dict[str, torch.Tensor],
                guard: Callable[[], contextlib.AbstractContextManager]
                = contextlib.nullcontext) -> Captured:
        """Warm ``step`` up, capture it as ``key``'s graph and return it.
        ``step()`` reads ``inputs`` (static buffers, filled by the caller
        before each replay) and returns its outputs as a tuple of tensors.
        ``guard()`` wraps the warm-up, which runs the step for real.  The
        capture itself runs nothing on the card (the caller replays), but it
        runs the step's Python: host-side state that the step moves (a step
        count) is the caller's to put back."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        with span("graphs.capture"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = launch_counts.read()
            side = torch.cuda.Stream()
            # the guard's snapshot and restore run on the caller's stream
            with guard():
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    step()
                torch.cuda.current_stream().wait_stream(side)
            launch_counts.restore(before)
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                graph.register_generator_state(gen)
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = step()
            counts = launch_counts.diff(launch_counts.read(), before)
            launch_counts.restore(before)
            torch.cuda.synchronize()
            self.capture_seconds += time.perf_counter() - t0
        captured = Captured(graph, inputs, tuple(outputs), counts)
        self.graphs[key] = captured
        return captured

    def pool_bytes(self) -> int:
        """Bytes the card holds for the private pool (its segments)."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
