"""A training step captured once as a CUDA graph and replayed for every batch
(the port's counterpart of the JAX trainer's one-dispatch epoch,
``train/trainer.py::_build_train_epoch``: the optimizer step folded over the
epoch's batches by ``lax.scan``, one program a dispatch).

``StepGraph`` holds the static inputs of a step, a ``BPRBatch`` of B rows,
and runs the Trainer's own step on them (``Trainer.train_step``:
``loss_backward`` then ``adam_step``), so the graph records exactly the eager
step's math:

- after a capture is dropped (and at the start), the first ``WARMUP_STEPS``
  steps run eagerly on the capture stream. They are real steps of the
  epoch, and they set up what a capture may not: cuSPARSE's handle and
  workspace, cuBLAS's workspace on that stream, the scatter kernel's
  shared-memory limit (``ops/scatter.py::_prepare``) and the allocator's
  blocks;
- the next step is captured (capture executes nothing) and replayed at once;
- every later step copies its batch into the static inputs (4 device copies)
  and replays the graph; the loss stays on the device.

The random draws of a step (the sampler's trees, dropout, lgn's edge
dropout) come from the Trainer's generator, registered with the graph: a
replay draws what an eager step would have drawn, and leaves the generator
where an eager step leaves it. The hand-written ``scatter_add_rows`` kernel is
launched through ctypes on the current stream, so the capture records it; the
wrapper counts a launch under capture apart (``ops/scatter.py::captured``),
and a replay counts the launches its capture recorded
(``ops/scatter.py::count_replay``).

Which configurations are captured (``captured``): every model of the
registry (mf, the LightGCN family, the SAGE family with all its convs, heads
and losses, sasrec and asage) under the fresh cadence (R = 1, T = 1, no
dask), on one process (no mesh), on a CUDA device. The Trainer makes a
``StepGraph`` for those alone; the CPU, the R / T / dask cadences and the
mesh run their steps eagerly through ``Trainer.train_step``. A failed capture
or replay raises; nothing falls back to eager steps.

The Trainer drops the graph (``drop``) whenever it replaces a tensor the
graph reads: new Adam states (``init_state``, ``restore``); the next step
warms up and captures again. ``drop`` releases the graph's memory pool (the
parameters' gradients, which the graph wrote, go with it) to the caching
allocator, and so does dropping the Trainer: the ``StepGraph`` holds its
Trainer by a weak reference, so no cycle keeps a dropped Trainer's pool until
the collector runs.
"""

from __future__ import annotations

import time
import weakref
from typing import Optional

import torch

from ..ops import scatter
from ..sampling.bpr import BPRBatch

__all__ = ["WARMUP_STEPS", "StepGraph", "captured"]

#: eager steps on the capture stream before a capture
WARMUP_STEPS = 3


def captured(cadence: str, mesh, device) -> bool:
    """Whether a step of this configuration is replayed as a CUDA graph:
    the fresh cadence, without a mesh, on a CUDA device."""
    return cadence == "fresh" and mesh is None and torch.device(device).type == "cuda"


class StepGraph:
    """The Trainer's step on static inputs, captured on CUDA (module
    docstring). ``stats``: warm-up, capture and instantiate host ms of the
    last capture, its pool's MiB, and the captures and replays so far."""

    def __init__(self, trainer):
        self.trainer = weakref.proxy(trainer)  # the Trainer holds this
        self.batch: Optional[BPRBatch] = None  # the static inputs
        self.loss: Optional[torch.Tensor] = None  # the static loss slot
        self.graph = None
        self.stream = None  # the capture stream, made at the first step
        self.warm = 0  # eager steps since the last drop
        self.scatter_launches = 0  # the scatter kernel's launches a replay adds
        self.stats = {"warmup_ms": 0.0, "capture_ms": None, "instantiate_ms": None, "pool_mib": None,
                      "captures": 0, "replays": 0}

    def drop(self) -> None:
        """Forget the captured graph and release its memory pool; the next
        steps warm up and capture anew."""
        if self.graph is not None:
            self.graph = self.loss = None
            self.trainer.model.zero_grad(set_to_none=True)  # the pool's last tensors
        self.warm = 0
        self.stats["warmup_ms"] = 0.0

    def _load(self, batch: BPRBatch) -> BPRBatch:
        """Copy ``batch`` into the static inputs (made at the first call)."""
        if batch.shard is not None:
            raise ValueError("a step graph takes whole batches")
        if self.batch is None:
            self.batch = BPRBatch(*(torch.empty_like(x) for x in (batch.user, batch.pos, batch.neg, batch.valid)))
        for dst, src in zip((self.batch.user, self.batch.pos, self.batch.neg, self.batch.valid),
                            (batch.user, batch.pos, batch.neg, batch.valid)):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"a batch of {tuple(src.shape)} {src.dtype}, the graph's {tuple(dst.shape)} "
                                 f"{dst.dtype}")
            dst.copy_(src)
        return self.batch

    def step(self, batch: BPRBatch) -> torch.Tensor:
        """One step on ``batch``; its loss, on the device (after the capture:
        the static loss slot, which the next step overwrites)."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.trainer.device)
        if self.graph is None and self.warm < WARMUP_STEPS:
            t0 = time.perf_counter()
            here = torch.cuda.current_stream(self.trainer.device)
            self.stream.wait_stream(here)
            with torch.cuda.stream(self.stream):
                loss = self.trainer.train_step(self._load(batch))
            here.wait_stream(self.stream)
            self.warm += 1
            self.stats["warmup_ms"] += 1e3 * (time.perf_counter() - t0)
            return loss
        self._load(batch)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        scatter.count_replay(self.scatter_launches)
        self.stats["replays"] += 1
        return self.loss

    def _capture(self) -> None:
        """Capture one step on the static inputs (executing nothing)."""
        dev = self.trainer.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.register_generator_state(self.trainer.generator)
        before = scatter.captured
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
            loss = self.trainer.train_step(self.batch)
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
        self.scatter_launches = scatter.captured - before
        self.graph, self.loss = graph, loss
        self.stats.update(capture_ms=1e3 * (t1 - t0), instantiate_ms=1e3 * (t2 - t1),
                          pool_mib=(torch.cuda.memory_reserved(dev) - reserved) / 2**20,
                          captures=self.stats["captures"] + 1)
