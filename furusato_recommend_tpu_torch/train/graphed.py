"""A training step captured once as CUDA graphs and replayed for every batch
(the port's counterpart of the JAX trainer's one-dispatch epoch,
``train/trainer.py::_build_train_epoch``: the optimizer step folded over the
epoch's batches by ``lax.scan``, one program a dispatch, for every cadence).

``StepGraph`` holds the static inputs of a step, a ``BPRBatch`` of B rows,
and the graphs of the Trainer's cadence. A cadence's step is made of parts,
each a Trainer method (``PARTS``), so the graphs record exactly the eager
step's math:

- the fresh cadence (R = 1, T = 1): ``train_step`` (``loss_backward`` then
  ``adam_step``), one graph (without a mesh);
- R >= 2, R = 0 and ``dask``: ``_linearize`` (the feature parameters copied
  into the snapshot, the tables computed from it with their graph kept, and
  copied into the leaves) once a block, and ``_cached_step`` (the direct step
  on the leaves, the pullback through the tables' kept graph, Adam) a step;
- T > 1: ``_linearize`` at the top of each super-step (once an epoch at R =
  0), ``_inner_step`` a step and ``_outer_step`` (the pullback of the mean
  table gradient, the feature parameters' Adam) at the super-step's end.

One graph launch a step, and one a block for the linearization (under T > 1
also one for the super-step's end). ``dask``'s memmap reads stay on the
host and eager: the streamed projection at the epoch's start
(``refresh_ooc_proj``, written into the tensor the linearization reads) and
the X^T G update at its end.

- After a capture is dropped (and at the start), the parts run eagerly on
  the capture stream until ``WARMUP_STEPS`` steps and every other part have
  run: real steps of the epoch, which set up what a capture may not
  (cuSPARSE's handle and workspace, cuBLAS's workspace on that stream, the
  scatter kernel's shared-memory limit, ``ops/scatter.py::_prepare``, the
  Adams' states and the allocator's blocks) and make the cadence's static
  tensors (``trainer.py::_CachedTables``);
- at the next step every part is captured (capture executes nothing), into
  one memory pool. The step's graph reads what the linearization's graph
  wrote: the leaves and snapshot (static tensors), and the tables' saved
  activations, which stay alive in the pool (their graph is kept,
  ``retain_graph``). A capture in the middle of a block first replays the
  linearization once with the feature parameters set to the block's
  snapshot, so the tables are the block's; then the step is replayed;
- every later step copies its batch into the static inputs (4 device copies)
  and replays the step's graph; a linearization replays its own. The loss
  stays on the device.

Under a (data, model) mesh each part is cut at its collectives
(``Trainer._split``, ``segments``), which run eagerly between its graphs on
every rank, through gloo or NCCL alike (the eager trainer runs the same
segments in the same order, ``run_eagerly``):

- before a part that reads the row-sharded tables whole (the step, and the
  linearization), their gather into the rank's whole-table buffers
  (``core/mesh.py::RowShards.gather_whole``), which the graph reads where
  they lie;
- between a step's grad graph (the loss on the data rank's rows, a static
  view of the static batch, and the backward) and its update graph (the
  Adam step), the gradients' mean over the mesh, of the gradient tensors
  the grad graph's capture wrote, through one flat buffer
  (``RowShards.average``).

So a mesh's step is two graph launches (a part without an Adam step, one)
and its collectives: a gather a sharded table and a mean for each of the two
kinds of parameter it holds (lgn at (2, 2), both tables sharded: two gathers
and one mean; a model with no table sharded: one mean).
No collective is reached inside a capture: ``Mesh.all_reduce`` raises if one
is.

The random draws of a step (the sampler's trees, dropout, lgn's edge
dropout) come from the Trainer's generator, registered with each graph that
draws (the step's): a replay draws what an eager step would have drawn, and
leaves the generator where an eager step leaves it. The hand-written
``scatter_add_rows`` kernel is launched through ctypes on the current
stream, so the capture records it; the wrapper counts a launch under
capture apart (``ops/scatter.py::captured``), and a replay counts the
launches its capture recorded (``ops/scatter.py::count_replay``).

Which configurations are captured (``core/graphs.py::captured``, the
evaluation's rule too): every model of the registry under every cadence, on
a CUDA device, on one process or on a mesh, except a mesh's losses that
gather rows over a data axis in the middle of their forward and backward
(the in-batch InfoNCE, asage's ``ssl_weight``). The Trainer makes a
``StepGraph`` for those alone; the CPU and those losses run the same split
parts eagerly, and so does a step given presampled draws. A failed capture
or replay raises; nothing falls back to eager steps.

The Trainer drops the graphs (``drop``) whenever it replaces a tensor they
read: new Adam states (``init_state``, ``restore``), with which it makes the
cadence's static tensors anew; the next steps warm up and capture again.
``drop`` releases the graphs' memory pool (the parameters' gradients and the
tables' saved activations, which the graphs wrote, go with it) to the
caching allocator, and so does dropping the Trainer: the ``StepGraph``
holds its Trainer by a weak reference, so no cycle keeps a dropped
Trainer's pool until the collector runs.
"""

from __future__ import annotations

import collections
import time
import weakref
from typing import Dict, List, Optional

import torch

from ..core.graphs import captured, new_stats, on_capture_stream, pool_measured
from ..ops import scatter
from ..sampling.bpr import BPRBatch
from .sharding import average_grads

__all__ = ["PARTS", "WARMUP_STEPS", "StepGraph", "captured", "run_eagerly", "segments"]

#: eager steps on the capture stream before a capture
WARMUP_STEPS = 3

#: a cadence's parts in capture order: the Trainer method, and whether it
#: takes the step's batch (one such part a cadence)
PARTS = {
    "fresh": {"train_step": True},
    "relin": {"_linearize": False, "_cached_step": True},
    "ooc": {"_linearize": False, "_cached_step": True},
    "super": {"_linearize": False, "_inner_step": True, "_outer_step": False},
}


class StepGraph:
    """The Trainer's cadence on static inputs, captured on CUDA (module
    docstring). ``stats``: warm-up, capture and instantiate host ms of the
    last capture (every part), its pool's MiB, the captures and steps
    replayed so far, and the graph launches so far (``graph_launches``)."""

    def __init__(self, trainer):
        self.trainer = weakref.proxy(trainer)  # the Trainer holds this
        self.parts: Dict[str, bool] = dict(PARTS[trainer.cadence])
        self.step_part = next(part for part, batched in self.parts.items() if batched)
        self.batch: Optional[BPRBatch] = None  # the static inputs
        self.loss: Optional[torch.Tensor] = None  # the static loss slot
        #: each part's segments in order: a graph, or an eager collective
        #: (under a mesh); captured together
        self.graphs: Dict[str, List[_Segment]] = {}
        self.stream = None  # the capture stream, made at the first step
        self.warm = collections.Counter()  # eager calls of each part since the last drop
        self.launches: Dict[str, int] = {}  # the scatter kernel's launches a replay of each part adds
        self.stats = {**new_stats(), "graph_launches": 0}

    @property
    def graph(self):
        """The step's segments (None before a capture)."""
        return self.graphs.get(self.step_part)

    @property
    def scatter_launches(self) -> int:
        """The scatter kernel's launches a replayed step adds."""
        return self.launches.get(self.step_part, 0)

    @property
    def graphs_per_step(self) -> int:
        """Graph launches a replayed step makes: one, or under a mesh one
        for each part the collectives cut it into."""
        return sum(seg.graph is not None for seg in self.graphs.get(self.step_part, ()))

    def drop(self) -> None:
        """Forget the captured graphs and release their memory pool; the next
        steps warm up and capture anew."""
        if self.graphs:
            self.graphs, self.loss = {}, None
            self.trainer.model.zero_grad(set_to_none=True)  # the pool's last tensors
            if self.trainer.cached is not None:  # the tables' saved activations
                self.trainer.cached.tables = self.trainer.cached.inputs = None
        self.warm.clear()
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

    def _warm(self) -> bool:
        """Whether every part has run eagerly enough to be captured."""
        return all(self.warm[part] >= (WARMUP_STEPS if batched else 1) for part, batched in self.parts.items())

    def step(self, batch: BPRBatch) -> torch.Tensor:
        """One step on ``batch`` (``run`` of the step's part)."""
        return self.run(self.step_part, batch)

    def run(self, part: str, batch: Optional[BPRBatch] = None):
        """One call of the Trainer's ``part`` (on ``batch`` for the step);
        the step's loss, on the device (after the capture: the static loss
        slot, which the next step overwrites)."""
        batched = self.parts[part]
        if (batch is not None) != batched:
            raise ValueError(f"{part}: {'a batch' if batched else 'no batch'} expected")
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.trainer.device)
        if not self.graphs and not (batched and self._warm()):
            out, ms = on_capture_stream(self.stream, self.trainer.device,
                                        lambda: getattr(self.trainer, part)(*((self._load(batch),) if batched else ())))
            self.warm[part] += 1
            self.stats["warmup_ms"] += ms
            return out
        if batched:
            self._load(batch)
        if not self.graphs:
            self._capture()
        self._replay(part)
        if batched:
            self.stats["replays"] += 1
            return self.loss
        return None

    def _replay(self, part: str) -> None:
        """The part's segments in order: each graph replayed (its scatter
        launches counted), each collective run eagerly between them."""
        for seg in self.graphs[part]:
            if seg.graph is not None:
                seg.graph.replay()
                scatter.count_replay(seg.launches)
                self.stats["graph_launches"] += 1
            else:
                seg.hook()

    def _capture(self) -> None:
        """Capture every part's graphs on the static inputs into one pool
        (executing nothing, and no collective), then fill the
        linearization's tables with the block's."""
        pool = torch.cuda.graph_pool_handle()
        capture_ms = instantiate_ms = 0.0
        with pool_measured(self.trainer.device, self.stats):
            for part, batched in self.parts.items():
                segs = segments(self.trainer, part)
                first = True
                self.launches[part] = 0
                for seg in segs:
                    if seg.optimizer is not None:  # the gradients the grad graph writes
                        opt = getattr(self.trainer, seg.optimizer)
                        groups = self.trainer.shards.grad_groups(p for g in opt.param_groups for p in g["params"])
                        seg.hook = lambda groups=groups: self.trainer.shards.average(groups)
                    if seg.work is None:
                        continue
                    graph = torch.cuda.CUDAGraph(keep_graph=True)
                    if batched and first:  # the step draws the trees and dropout
                        graph.register_generator_state(self.trainer.generator)
                    before = scatter.captured
                    t0 = time.perf_counter()
                    with torch.cuda.graph(graph, pool=pool, stream=self.stream, capture_error_mode="thread_local"):
                        out = seg.work(*((self.batch,) if batched and first else ()))
                    t1 = time.perf_counter()
                    graph.instantiate()
                    capture_ms += 1e3 * (t1 - t0)
                    instantiate_ms += 1e3 * (time.perf_counter() - t1)
                    seg.launches = scatter.captured - before
                    self.launches[part] += seg.launches
                    seg.graph, seg.work = graph, None
                    if batched and first:
                        self.loss = out
                    first = False
                self.graphs[part] = segs
            if "_linearize" in self.parts:
                self._fill()
        self.stats.update(capture_ms=capture_ms, instantiate_ms=instantiate_ms)

    @torch.no_grad()
    def _fill(self) -> None:
        """Replay the linearization once from the block's snapshot: the
        feature parameters, moved by the block's eager steps, are set to it
        for the replay (which copies them into the snapshot) and set back."""
        trainer = self.trainer
        named = dict(trainer.model.named_parameters())
        feats = [(named[k], trainer._own(k, trainer.cached.snap[k])) for k in trainer.feature_names]
        held = [p.detach().clone() for p, _ in feats]
        for p, s in feats:
            p.copy_(s)
        self._replay("_linearize")
        for (p, _), h in zip(feats, held):
            p.copy_(h)


def segments(trainer, part: str) -> List["_Segment"]:
    """``part`` of the trainer's cadence cut at the mesh's collectives
    (``Trainer._split``): its device work and Adam step, one segment without
    a mesh; under one, the tables' gather before a part that reads them
    whole and the gradients' mean before the Adam step, eager segments
    between the device ones. A captured trainer records each device segment
    as a graph; the eager trainer runs them all in order (``run_eagerly``)."""
    reads_whole, work, opt = trainer._split(part)
    shards = trainer.shards
    segs = []
    if shards is not None and reads_whole and shards.names:
        segs.append(_Segment(hook=shards.gather_whole))
    if opt is None:
        segs.append(_Segment(work=work))
    elif shards is None:
        def work_and_step(*args):
            out = work(*args)
            getattr(trainer, opt).step()
            return out

        segs.append(_Segment(work=work_and_step))
    else:
        segs.append(_Segment(work=work))
        segs.append(_Segment(optimizer=opt))  # the mean of the gradients the work wrote
        segs.append(_Segment(work=lambda: getattr(trainer, opt).step()))
    return segs


def run_eagerly(trainer, part: str, *args):
    """One eager call of ``part``: its segments in order, the first device
    segment given ``args``; returns what that segment returns (the step's
    loss)."""
    out, first = None, True
    for seg in segments(trainer, part):
        if seg.optimizer is not None:
            average_grads(getattr(trainer, seg.optimizer), trainer.shards)
        elif seg.work is None:
            seg.hook()
        elif first:
            out, first = seg.work(*args), False
        else:
            seg.work()
    return out


class _Segment:
    """A piece of a part: a graph (``work`` until its capture), or an eager
    hook between graphs (``optimizer``: the Adam whose gradients its hook
    averages, set at the capture)."""

    def __init__(self, work=None, hook=None, optimizer: Optional[str] = None):
        self.work, self.hook, self.optimizer = work, hook, optimizer
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = 0
