"""The whole evaluation captured once as a CUDA graph and replayed (the port's
counterpart of the JAX evaluator's one program, ``jax.jit(self._evaluate)``
in ``eval/evaluate.py``: the propagation, the tile loop's top-k and metric
sums, the cold-start sums, AUC and the coverage bitmap in one ``lax.scan``).

``EvalGraph`` holds the graph of one ``Evaluator`` on one ``EvalData``:

- the first evaluation runs eagerly on the capture stream. It is the
  warm-up: it sets up what a capture may not (cuSPARSE's handle and
  workspace, cuBLAS's workspace on that stream, the top-k kernels' occupancy
  queries, ``ops/streaming_topk.py``), makes what the models build once and
  keep (the LightGCN adjacency, the SAGE family's mean-aggregation and
  text-bag matrices) and fills the allocator's blocks;
- the second captures the whole evaluation (``Evaluator.program``, every
  tile's ``masked_topk`` launch included) into the graph's own memory pool,
  then replays it; every later evaluation replays it. One graph launch an
  evaluation; its outputs (the sums, the coverage counts and the top-K ids)
  stay on the device, in the pool, until ``Evaluator.__call__`` copies them
  to the host, the evaluation's one host sync.

``--inference sample`` draws the trees from the Evaluator's generator,
registered with the graph: it is seeded with config.seed before the capture
and before every replay, so that a replay draws the trees an eager
evaluation draws.

The hand-written top-k kernels are launched through ctypes on the current
stream, so the capture records them; ``ops/streaming_topk.py`` counts a
launch under capture apart (``captured``), and a replay counts the launches
its capture recorded (``count_replay``).

Which evaluations are captured (``core/graphs.py::captured``, the training
steps' rule): on one process (no mesh), on a CUDA device; the mesh (``eval/sharded.py``, whose gloo collectives a
capture cannot record) and the CPU evaluate eagerly. A failed capture or
replay raises; nothing falls back to the eager evaluation.

The graph reads the model's parameters and the tensors it holds, the
evaluation graph and the ``EvalData`` where they lie. It is dropped and
captured anew when the evaluation's inputs change: another ``EvalData``,
config, graph or model given to the Evaluator (compared by identity), or
``drop``, which the Trainer calls wherever it drops its step graph.
``drop`` releases the graph's memory pool to the caching allocator, and so
does dropping the Evaluator: the ``EvalGraph`` holds it by a weak reference.
"""

from __future__ import annotations

import time
import weakref
from typing import Optional

import torch

from ..core.graphs import captured, new_stats, on_capture_stream, pool_measured
from ..ops import streaming_topk

__all__ = ["EvalGraph", "captured"]


class EvalGraph:
    """An Evaluator's evaluation, captured on CUDA (module docstring).
    ``stats``: warm-up, capture and instantiate host ms of the last capture,
    its pool's MiB, and the captures and evaluations replayed so far."""

    def __init__(self, evaluator):
        self.evaluator = weakref.proxy(evaluator)  # the Evaluator holds this
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None  # the graph's outputs, which each replay overwrites
        self.inputs = None  # (data, config, graph, model) of the warm-up and capture
        self.warm = False  # the eager warm-up has run since the last drop
        self.stream = None  # the capture stream, made at the first evaluation
        self.launches = (0, 0)  # masked_topk launches a replay adds, and of those the radix select's
        self.stats = new_stats()

    def drop(self) -> None:
        """Forget the captured graph and release its memory pool; the next
        evaluation warms up and the one after it captures anew."""
        self.graph = self.out = self.inputs = None
        self.warm = False

    def run(self, data):
        """One evaluation of ``data``: eager (the warm-up), or a replay of
        the graph, captured first if need be. Returns what
        ``Evaluator.program`` returns, on the device."""
        ev = self.evaluator
        inputs = (data, ev.config, ev.graph, ev.model)
        if self.inputs is None or any(a is not b for a, b in zip(inputs, self.inputs)):
            self.drop()
            self.inputs = inputs
        if self.stream is None:
            self.stream = torch.cuda.Stream(ev.device)
        if not self.warm:
            def warm_up():
                ev.seed()
                return ev.program(data)

            out, self.stats["warmup_ms"] = on_capture_stream(self.stream, ev.device, warm_up)
            self.warm = True
            return out
        if self.graph is None:
            self._capture(data)
        ev.seed()
        self.graph.replay()
        streaming_topk.count_replay(*self.launches)
        self.stats["replays"] += 1
        return self.out

    def _capture(self, data) -> None:
        """Capture ``Evaluator.program`` on ``data`` into the graph's own
        pool (executing nothing)."""
        ev = self.evaluator
        with pool_measured(ev.device, self.stats):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            ev.seed()
            if ev.sampled:  # the trees of --inference sample
                graph.register_generator_state(ev.generator)
            before = (streaming_topk.captured, streaming_topk.wide_captured)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                out = ev.program(data)
            t1 = time.perf_counter()
            graph.instantiate()
            t2 = time.perf_counter()
        self.launches = (streaming_topk.captured - before[0], streaming_topk.wide_captured - before[1])
        self.graph, self.out = graph, out
        self.stats.update(capture_ms=1e3 * (t1 - t0), instantiate_ms=1e3 * (t2 - t1))
