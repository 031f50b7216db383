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

Under a (data, model) mesh the evaluation is two graphs in one pool, with
the collectives run eagerly around them (``Evaluator.program``):

- (a) the whole-table gather, before the evaluation (``Trainer.test``'s
  ``RowShards.whole``), into the buffers the graphs read;
- (b) ``Evaluator.local_candidates``: the propagation, the rank's block of
  the catalog and every tile's local ``masked_topk`` (the kernel inside the
  graph), into one static candidate buffer;
- (c) the exchange of every tile's candidates over ``model``, one
  collective, in place;
- (d) ``Evaluator.merged``: every tile's merge, the metric and cold-start
  sums and the coverage bitmap;
- (e) ``Evaluator._reduce``, eager: the sums over ``data``, rank 0's on
  every rank, the top-K ids gathered over ``data``.

Which evaluations are captured (``core/graphs.py::captured``, the training
steps' rule): on a CUDA device, on one process or on a mesh, except a mesh's
``--inference sample`` (its gathers over ``data`` sit inside the
propagation); the CPU evaluates eagerly, the same parts in the same order. A
failed capture or replay raises; nothing falls back to the eager evaluation.

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
from ..core.mesh import MODEL_AXIS
from ..ops import streaming_topk

__all__ = ["EvalGraph", "captured"]


class EvalGraph:
    """An Evaluator's evaluation, captured on CUDA (module docstring).
    ``stats``: warm-up, capture and instantiate host ms of the last capture,
    its pool's MiB, and the captures and evaluations replayed so far."""

    def __init__(self, evaluator):
        self.evaluator = weakref.proxy(evaluator)  # the Evaluator holds this
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.merge_graph: Optional[torch.cuda.CUDAGraph] = None  # a mesh's second graph, (d)
        self.cands: Optional[torch.Tensor] = None  # a mesh's candidate buffer, (b) -> (c) -> (d)
        self.out = None  # the graph's outputs, which each replay overwrites
        self.inputs = None  # (data, config, graph, model) of the warm-up and capture
        self.warm = False  # the eager warm-up has run since the last drop
        self.stream = None  # the capture stream, made at the first evaluation
        self.launches = (0, 0)  # masked_topk launches a replay adds, and of those the radix select's
        self.stats = new_stats()

    def drop(self) -> None:
        """Forget the captured graph and release its memory pool; the next
        evaluation warms up and the one after it captures anew."""
        self.graph = self.merge_graph = self.cands = self.out = self.inputs = None
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
        if self.merge_graph is None:
            return self.out
        ev.mesh.all_reduce(self.cands, MODEL_AXIS)
        self.merge_graph.replay()
        return ev._reduce(*self.out)

    def _capture(self, data) -> None:
        """Capture ``Evaluator.program`` on ``data`` into the graph's own
        pool (executing nothing); under a mesh its two parts, (b) and (d),
        each a graph in that pool."""
        ev = self.evaluator
        pool = torch.cuda.graph_pool_handle()
        capture_ms = instantiate_ms = 0.0

        def record(fn, sampled=False):
            nonlocal capture_ms, instantiate_ms
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            if sampled:  # the trees of --inference sample
                graph.register_generator_state(ev.generator)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, pool=pool, stream=self.stream, capture_error_mode="thread_local"):
                out = fn()
            t1 = time.perf_counter()
            graph.instantiate()
            capture_ms += 1e3 * (t1 - t0)
            instantiate_ms += 1e3 * (time.perf_counter() - t1)
            return graph, out

        with pool_measured(ev.device, self.stats):
            ev.seed()
            before = (streaming_topk.captured, streaming_topk.wide_captured)
            if ev.mesh is None:
                self.graph, self.out = record(lambda: ev.program(data), ev.sampled)
            else:
                self.graph, self.cands = record(lambda: ev.local_candidates(data))
                self.merge_graph, self.out = record(lambda: ev.merged(data, self.cands))
        self.launches = (streaming_topk.captured - before[0], streaming_topk.wide_captured - before[1])
        self.stats.update(capture_ms=capture_ms, instantiate_ms=instantiate_ms)
