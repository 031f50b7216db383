"""Trainer: BPR epochs, the evaluation cadence and best-by-recall
checkpoints (port of ``train/trainer.py``).

An epoch draws all of its triplets in one ``sample_bpr`` call on the device,
then runs ``num_batches`` steps of forward, backward and ``torch.optim.Adam``
(b1 0.9, b2 0.999, eps 1e-8: ``optax.adam``). Each step's loss stays on the
device; the epoch's mean is read once, at its end. ``fit`` evaluates before
training, then every ``test_span`` epochs and after the last one, and saves
the full training state whenever recall@topks[0] improves.

``ddp_recipe`` is the reference's distributed recipe on one device:
``train_iterative`` x the dataset's size in samples an epoch, positives drawn
from an alias table of edge weights capped at ``positive_num_limit`` expected
draws an item, negatives from an alias table of popularity^``negative_pow``,
and the evaluation cut to ``test_count`` user tiles. ``config.sample_pow``
draws positives by popularity instead (the reference's ``sample_prob_*.pkl``
when the data path has one).

The SAGE family's cadences of the all-entity initial (feature) tables, as the
JAX trainer runs them (``train_emb``, ``full_graph_train`` and a loss that
takes no ``tables=``, SASRec's, have none: they train as R = 1 at any R,
their epochs not rounded to blocks):

- ``relin_every`` R = 1, ``feature_update_every`` T = 1: the loss computes the
  tables inside each step, one autograd pass;
- R > 1, or R = 0 (once an epoch): at the top of each block of R steps the
  tables are computed from a snapshot of the feature parameters
  (``initial_param_keys``) and that graph is kept for the block; each step's
  loss reads the tables as detached leaves, and its gradient is the direct one
  plus the snapshot's pullback of the table gradient, then one Adam step. (The
  snapshot is a copy: Adam updates the live parameters in place, which a graph
  built on them would refuse.) The snapshot, the leaves and the sums are
  tensors made once and written in place (``_CachedTables``), so that a
  captured step reads them where the captured linearization wrote them.
  Epochs round up to whole blocks;
- T > 1: two Adams over disjoint groups. The other parameters step every step
  on their direct gradient; the feature parameters stay put for T steps, then
  take one step on the pullback of the mean table gradient plus the mean of
  their direct (L2) gradients. The linearization is renewed every super-step,
  or once an epoch when R = 0. Epochs round up to whole super-steps;
- out-of-core numeric features (``dask``): the numeric linears are out of
  Adam; the tables are linearized once an epoch with respect to the feature
  parameters and the streamed projections, whose table gradients are summed
  on the device over the epoch; after it, a streamed X^T G takes an SGD step at
  lr / num_batches (``data/ooc.py``).

Under a (data, model) mesh (``config.mesh``, over an initialised
``torch.distributed`` world of data x model processes; ``train/sharding.py``)
every rank draws the same epoch and the same randomness from the shared
generator and computes each step on its data rank's rows, the large tables
row-sharded over ``model`` (gathered eagerly into the rank's whole-table
buffers before the parts that read them); before every Adam step (the
cadences' pullbacks and both Adams under T > 1 included) a block's gradient
is averaged over ``data`` and a replicated parameter's over the world, so the
mesh trains as one process does. Each part of a step is split at those
collectives (``_split``; ``train/graphed.py::segments``).
``save`` gathers the blocks on every rank and the primary writes whole
tables and moments, which a single-process ``restore`` reads; ``restore``
and ``init_state`` shard again (new blocks: the graphs and the whole-table
buffers are dropped with the old ones). (Deviation: the JAX package raises
where a model axis spans processes; every rank of the port is a process.)
Only the primary prints and logs.

The JAX package's one-dispatch epoch (``_build_train_epoch``'s scan) has its
counterpart on the card for every model of the registry under every cadence,
with or without a mesh: each part of the cadence's step (the step; the
linearization, and under T > 1 the super-step's end) is captured once as
CUDA graphs and replayed (``train/graphed.py``), with the fused Adams; under
a mesh each part is two graphs at most, its collectives run eagerly between
them. So is its one-program evaluation (``eval/graphed.py``): from the second
``test`` on, a replay. The CPU, a mesh's data-axis InfoNCE losses
(``core/graphs.py::gathers_over_data``) and steps given presampled ``draws``
run the same parts eagerly. The JAX package's compile cache has no
counterpart here.

``pipeline_dispatch`` (on by default; off under ``dask``, as in the JAX
trainer) draws the next epoch's triplets once an epoch's steps are enqueued
and before its loss is read, the epoch's one host sync. On the card the draw
runs on a stream of its own, so the loss read waits for the steps alone (as
JAX's ``float(loss)`` waits for its buffer, not for the sampling program
dispatched after it): the card samples while the host reads the loss and
starts the next epoch, whose steps wait for the draw. ``fit`` draws none
after its last epoch. The draw is made from a copy
of the generator, so the trainer's generator stands where a synchronous
trainer's stands at every point (``save`` writes it, a direct
``sample_epoch`` or ``train_epoch`` draws from it); the next
``train_one_epoch`` takes the drawn triplets, and moves the generator past
their draw, only while the generator stands where they were drawn from.
Every path thus draws the stream a synchronous trainer draws. ``init_state``,
``restore``, ``sample_epoch`` and ``train_epoch`` drop a prefetch; under a
mesh every rank draws the same, as its epochs do.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..convert import adam_state_from_jax, adam_state_to_numpy, flatten_params, params_from_jax
from ..core.checkpoint import checkpoint_path, load_checkpoint, save_checkpoint
from ..core.device import resolve_device
from ..core.distributed import is_primary_host
from ..core.mesh import make_mesh, shard_params
from ..data.dataset import Dataset
from ..data.ooc import stream_project_grad
from ..eval.evaluate import EvalData, Evaluator, build_eval_data
from ..models.base import PairwiseModel
from ..obs.log import MetricLogger, cprint
from ..ops.alias import AliasTable
from ..sampling.bpr import BPRBatch, sample_bpr
from ..sampling.weights import (
    capped_positive_edge_weights,
    edge_alias_from_weights,
    load_sample_prob,
    negative_alias,
    popularity_positive_edge_weights,
    sample_prob_edge_weights,
)
from .graphed import StepGraph, captured, run_eagerly
from .sharding import adam, build_kernels_once, loss_backward

__all__ = ["OPTIMIZER_PREFIXES", "Trainer"]

#: the checkpoint's key prefix of each Adam: the one that steps every step,
#: then the feature parameters' under ``feature_update_every`` > 1
OPTIMIZER_PREFIXES = ("adam", "feat_adam")


class _CachedTables:
    """The cached cadences' state, in tensors made once (at the first
    linearization, eager) and written in place after: the snapshot of the
    feature parameters, ``leaves`` (the tables as a step reads them, each
    with its gradient, zeroed in place a step), the projections' table
    gradients summed over a ``dask`` epoch (``acc``), and under T > 1 the
    super-step's sums of the table gradients (``acc_t``), of the feature
    parameters' direct gradients (``acc_p``) and its step count. ``tables``
    (computed from the snapshot with their graph kept) and ``inputs`` are the
    last linearization's; ``pullback`` maps a table gradient onto the
    snapshot through them. A captured cadence's graphs read these tensors
    across one another (``train/graphed.py``)."""

    def __init__(self, names: Sequence[str], proj_sides: Sequence[str]):
        self.names = list(names)
        self.proj_sides = list(proj_sides)
        self.snap: Optional[Dict[str, torch.Tensor]] = None
        self.leaves: Optional[tuple] = None
        self.acc: Dict[str, torch.Tensor] = {}
        self.acc_t: Optional[list] = None
        self.acc_p: Optional[Dict[str, torch.Tensor]] = None
        self.count: Optional[torch.Tensor] = None
        self.tables = self.inputs = None

    def linearize(self, model) -> None:
        """Copy the feature parameters into the snapshot, compute the tables
        from it (and from the streamed projections) with their graph, and
        copy them into the leaves."""
        params = dict(model.named_parameters())
        with torch.no_grad():
            if self.snap is None:
                self.snap = {k: torch.empty_like(params[k]) for k in self.names}
            for k in self.names:
                self.snap[k].copy_(params[k])
        # the graph's inputs: new leaves over the snapshot's and the
        # projections' memory, whose gradient accumulators are made on this
        # linearization's stream (a leaf kept from an earlier one keeps its
        # accumulator's stream, which a capture on another stream refuses)
        snap = {k: x.detach().requires_grad_(True) for k, x in self.snap.items()}
        proj = {s: model._ooc_proj[s].detach().requires_grad_(True) for s in self.proj_sides}
        with torch.enable_grad():
            self.tables = model.tables_at(snap, proj if self.proj_sides else None)
        self.inputs = list(snap.values()) + [proj[s] for s in self.proj_sides]
        with torch.no_grad():
            if self.leaves is None:
                self.leaves = tuple(torch.empty_like(t).requires_grad_(True) for t in self.tables)
                for leaf in self.leaves:
                    leaf.grad = torch.zeros_like(leaf)
                self.acc = {s: torch.zeros_like(proj[s]) for s in self.proj_sides}
            for leaf, t in zip(self.leaves, self.tables):
                leaf.copy_(t)

    def pullback(self, g_tables):
        """({name: gradient of each feature parameter}, {side: gradient of
        each projection})."""
        grads = torch.autograd.grad(
            self.tables, self.inputs, grad_outputs=g_tables, retain_graph=True, allow_unused=True
        )
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, self.inputs)]
        k = len(self.names)
        return dict(zip(self.names, grads[:k])), dict(zip(self.proj_sides, grads[k:]))


class Trainer:
    def __init__(
        self,
        config: Config,
        dataset: Dataset,
        model: PairwiseModel,
        logger: Optional[MetricLogger] = None,
        item_categories: Optional[np.ndarray] = None,
        ddp_recipe: bool = False,
        device=None,
    ):
        self.feat_every = max(1, int(config.feature_update_every))
        self.relin_every = int(config.relin_every)
        #: side -> MemmapNumeric of the out-of-core numeric features (dask)
        self.ooc = dict(getattr(model, "ooc_numeric", None) or {})
        if self.feat_every > 1:
            if self.ooc:
                raise ValueError(
                    "feature_update_every > 1 is incompatible with out-of-core numeric features "
                    "(their update is already epoch-delayed)"
                )
            if not hasattr(model, "initial_param_keys"):
                raise ValueError("feature_update_every > 1 needs a SAGE-family model with cached initial tables")
        if self.relin_every < 0:
            raise ValueError(f"relin_every must be >= 0, got {self.relin_every}")
        if self.ooc and config.train_emb:
            raise ValueError("out-of-core numeric features (dask) require train_emb=False")
        # the JAX trainer's cached-tables path: the SAGE family's cadences,
        # for a loss that takes tables (not SASRec's)
        cached = (
            not config.train_emb
            and hasattr(model, "initial_tables")
            and not getattr(model, "full_graph_train", False)
            and "tables" in inspect.signature(model.loss).parameters
        )
        if self.ooc and not cached:
            raise ValueError("out-of-core numeric features need the cached-tables path (not full_graph_train)")
        if self.feat_every > 1 and not cached:
            raise ValueError("feature_update_every > 1 needs the cached-tables path (train_emb=False, SAGE family)")
        if self.ooc:
            self.cadence = "ooc"
        elif self.feat_every > 1:
            self.cadence = "super"
        elif cached and self.relin_every != 1:
            self.cadence = "relin"
        else:
            self.cadence = "fresh"
        self.config = config
        self.dataset = dataset
        self.device = resolve_device(device)
        self.mesh = None
        if config.mesh.num_devices > 1:
            for name, size in (("bpr_batch_size", config.bpr_batch_size), ("eval_user_batch", config.eval_user_batch)):
                if size % config.mesh.data:
                    raise ValueError(f"{name} {size} not divisible by mesh data axis {config.mesh.data}")
            self.mesh = make_mesh(config.mesh.data, config.mesh.model, self.device)
            build_kernels_once(self.mesh)
        self.graph = dataset.graph.to(self.device)
        self.model = model.to(self.device)
        #: the row-sharded parameters under a mesh
        self.shards = shard_params(self.model, self.mesh) if self.mesh is not None else None
        if logger is None or not is_primary_host():
            logger = MetricLogger(quiet=config.test_mode or not is_primary_host())
        self.logger = logger
        self.max_recall = -1.0
        self.step = 0
        #: the last epoch's per-step losses, on the device
        self.epoch_losses: Optional[torch.Tensor] = None

        bs = config.bpr_batch_size
        # one epoch draws train_size triplets (train_iterative x that in the
        # ddp recipe), rounded up to whole batches
        mult = config.train_iterative if ddp_recipe else 1
        self.num_batches = -(-max(dataset.train_size * mult, bs) // bs)
        # whole super-steps, or whole linearization blocks
        block = {"super": self.feat_every, "relin": max(self.relin_every, 1)}.get(self.cadence, 1)
        self.num_batches = -(-self.num_batches // block) * block
        self.samples_per_epoch = self.num_batches * bs

        self.edge_alias: Optional[AliasTable] = None
        self.neg_alias: Optional[AliasTable] = None
        if ddp_recipe:
            w = capped_positive_edge_weights(dataset, self.samples_per_epoch, config.positive_num_limit)
            self.edge_alias = edge_alias_from_weights(w).to(self.device)
            if config.negative_pow:
                self.neg_alias = negative_alias(dataset, config.negative_pow).to(self.device)
        elif config.sample_pow:
            probs = load_sample_prob(config.data_path, config.sample_pow)
            if probs is not None:
                w = sample_prob_edge_weights(dataset, probs)
            else:
                w = popularity_positive_edge_weights(dataset, config.sample_pow)
            self.edge_alias = edge_alias_from_weights(w).to(self.device)

        max_deg = int(np.max(np.bincount(dataset.train_user, minlength=dataset.n_users)))
        #: replays its captured evaluation on one CUDA device (``eval/graphed.py``)
        self.evaluator = Evaluator(self.model, self.graph, config, max_train_degree=max_deg, mesh=self.mesh)
        self.eval_data: EvalData = build_eval_data(
            dataset, config.eval_user_batch, item_categories=item_categories,
            max_batches=config.test_count if ddp_recipe else None, device=self.device,
        )

        #: the parameters the initial tables depend on (cached cadences)
        self.feature_names = sorted(model.initial_param_keys()) if self.cadence != "fresh" else []
        #: the cadence's parts are replayed as CUDA graphs (``train/graphed.py``)
        self.captured = captured(self.mesh, self.device, config, model)
        self.step_graph: Optional[StepGraph] = None
        self._new_optimizers()
        #: the sampler's stream (and edge dropout's); saved and restored with
        #: the checkpoint so a resumed run draws what an uninterrupted one would
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        #: --pipeline_dispatch (module docstring)
        self.pipeline = bool(config.pipeline_dispatch) and not self.ooc
        #: the prefetch: (the generator's state before the draw, after it,
        #: samples_per_epoch, the triplets), or None
        self._prefetch = None
        self._draw_generator: Optional[torch.Generator] = None  # the copy it draws from
        self._draw_stream: Optional[torch.cuda.Stream] = None  # the stream it draws on (CUDA)
        if self.captured:
            self.step_graph = StepGraph(self)

    def _whole(self):
        """Inside, the model reads its row-sharded tables whole (a mesh):
        gathered on entry."""
        return self.shards.whole() if self.shards is not None else contextlib.nullcontext()

    def _read_whole(self):
        """Inside, the model reads its row-sharded tables whole (a mesh) from
        the buffers the last gather filled: no collective."""
        return self.shards.read_whole() if self.shards is not None else contextlib.nullcontext()

    def _own(self, name: str, grad):
        """This rank's rows of a whole-table gradient (or moment) of
        parameter ``name``."""
        return self.shards.own(name, grad) if self.shards is not None and name in self.shards.names else grad

    def _average(self, tensors) -> None:
        """Average ``tensors`` (whole, replicated) in place over the mesh's
        world, whose model ranks hold the same ones."""
        if self.mesh is not None:
            self.mesh.average(list(tensors), None)

    def _new_optimizers(self) -> None:
        """``optimizer`` over the parameters that step every step, and under
        T > 1 ``opt_feat`` over the feature parameters (None otherwise). The
        out-of-core numeric linears are in neither."""
        named = dict(self.model.named_parameters())
        frozen = {f"{side}_numeric_{sfx}" for side in self.ooc for sfx in ("w", "b")}
        apart = set(self.feature_names) if self.cadence == "super" else set()
        self.optimizer = adam([p for k, p in named.items() if k not in frozen | apart], self.config,
                              capturable=self.captured)
        self.opt_feat = (adam([named[k] for k in self.feature_names], self.config, capturable=self.captured)
                         if apart else None)
        if self.step_graph is not None:  # its Adam states are gone
            self.step_graph.drop()
        # and the evaluation's graph with it: init_state and restore evaluate
        # their state by a capture of its own
        self.evaluator.drop()
        #: the cached cadences' tables and sums, made anew with the Adams
        self.cached = _CachedTables(self.feature_names, sorted(self.ooc)) if self.cadence != "fresh" else None

    def init_state(self, seed: Optional[int] = None) -> None:
        """Fresh parameters (drawn from ``seed``, default config.seed), fresh
        Adam moments, the sampler's stream from ``seed``, step 0."""
        seed = self.config.seed if seed is None else seed
        if self.shards is not None:
            self.shards.release()
        self.model.init_parameters(torch.Generator().manual_seed(seed))
        if self.shards is not None:
            self.shards = shard_params(self.model, self.mesh)
        self._new_optimizers()
        self.generator.manual_seed(seed)
        self._prefetch = None
        self.step = 0

    def _split(self, part: str) -> tuple:
        """A part of the cadence's step (``train/graphed.py::PARTS``) split at
        the mesh's collectives: (whether it reads the row-sharded tables
        whole, its device work before the Adam step, the attribute of the
        Adam it ends with or None). Under a mesh the tables are gathered
        before the work and the gradients averaged between the work and the
        Adam step, eagerly; a captured trainer replays the work and the step
        as graphs around them."""
        return {
            "train_step": (True, self._step_grads, "optimizer"),
            "_linearize": (True, self._linearize_tables, None),
            "_cached_step": (True, self._cached_grads, "optimizer"),
            "_inner_step": (True, self._inner_grads, "optimizer"),
            "_outer_step": (False, self._outer_grads, "opt_feat"),
        }[part]

    def _run_part(self, part: str, *args):
        """One eager call of ``part``: the gather (a mesh), its work, the
        gradients' mean (a mesh) and its Adam step, the segments a captured
        trainer replays (``train/graphed.py::run_eagerly``); the work's
        result."""
        return run_eagerly(self, part, *args)

    def train_step(self, batch: BPRBatch, draws: Optional[dict] = None) -> torch.Tensor:
        """One forward, backward and Adam step on ``batch`` with the tables
        computed inside the loss (R = 1); the loss stays on the device. The
        trainer's generator draws the step's randomness (edge dropout under
        config.dropout; the SAGE family's trees, unless ``draws`` gives them,
        and dropout). Under a mesh, this data rank's share of the loss."""
        return self._run_part("train_step", batch, draws)

    def _step_grads(self, batch: BPRBatch, draws: Optional[dict] = None) -> torch.Tensor:
        return loss_backward(self.model, self.graph, batch, self.generator, draws, self.shards)

    def _direct_step(self, batch: BPRBatch, draws: Optional[dict], lin: _CachedTables):
        """Zero the gradients (the leaves' in place), then forward and
        backward of the loss on the linearization's leaves: (loss, the
        tables' gradients); the parameters hold their direct gradients."""
        for leaf in lin.leaves:
            leaf.grad.zero_()
        loss = loss_backward(self.model, self.graph, batch, self.generator, draws, self.shards, tables=lin.leaves)
        return loss, tuple(leaf.grad for leaf in lin.leaves)

    def _linearize(self) -> _CachedTables:
        """The linearization at the top of a block (a super-step, or an
        epoch at R = 0 and under dask); the first call also makes the
        super-step's sums."""
        return self._run_part("_linearize")

    def _linearize_tables(self) -> _CachedTables:
        with self._read_whole():
            self.cached.linearize(self.model)
        if self.cadence == "super" and self.cached.acc_p is None:
            named = dict(self.model.named_parameters())
            self.cached.acc_t = [torch.zeros_like(x) for x in self.cached.leaves]
            self.cached.acc_p = {k: torch.zeros_like(named[k]) for k in self.feature_names}
            self.cached.count = torch.zeros((), device=self.device)
        return self.cached

    def _cached_step(self, batch: BPRBatch, draws: Optional[dict] = None) -> torch.Tensor:
        """A step of R >= 2, R = 0 or dask: the direct step on the leaves, the
        pullback of their gradient added to the feature parameters' direct
        gradients (and to the projections' sums), one Adam step."""
        return self._run_part("_cached_step", batch, draws)

    def _cached_grads(self, batch: BPRBatch, draws: Optional[dict] = None) -> torch.Tensor:
        lin = self.cached
        loss, g_t = self._direct_step(batch, draws, lin)
        g_feat, g_proj = lin.pullback(g_t)
        named = dict(self.model.named_parameters())
        for k, g in g_feat.items():
            p, g = named[k], self._own(k, g)
            if p.grad is None:
                p.grad = g
            else:
                p.grad.add_(g)
        for side, g in g_proj.items():
            lin.acc[side].add_(g)
        return loss

    def _inner_step(self, batch: BPRBatch, draws: Optional[dict] = None) -> torch.Tensor:
        """A step inside a super-step (T > 1): the direct step, its table and
        feature-parameter gradients added to the super-step's sums, one step
        of the non-feature parameters; the feature parameters stay put."""
        return self._run_part("_inner_step", batch, draws)

    def _inner_grads(self, batch: BPRBatch, draws: Optional[dict] = None) -> torch.Tensor:
        lin = self.cached
        loss, g_t = self._direct_step(batch, draws, lin)
        for a, g in zip(lin.acc_t, g_t):
            a.add_(g)
        named = dict(self.model.named_parameters())
        for k, a in lin.acc_p.items():
            if named[k].grad is not None:
                a.add_(named[k].grad)
        lin.count.add_(1.0)
        return loss

    def _outer_step(self) -> None:
        """A super-step's end: one step of the feature parameters on the
        pullback of the mean table gradient plus the mean of their direct
        gradients (the means over the super-step's steps); the sums zeroed."""
        self._run_part("_outer_step")

    def _outer_grads(self) -> None:
        lin = self.cached
        named = dict(self.model.named_parameters())
        g_feat, _ = lin.pullback(tuple(a / lin.count for a in lin.acc_t))
        for k, g in g_feat.items():  # opt_feat reads these alone
            named[k].grad = self._own(k, g) + lin.acc_p[k] / lin.count
        for a in (*lin.acc_t, *lin.acc_p.values(), lin.count):
            a.zero_()

    def train_epoch(self, batches: Sequence[BPRBatch], draws: Optional[Sequence[dict]] = None) -> torch.Tensor:
        """The steps of one epoch over ``batches`` under the configured
        cadence (module docstring); ``draws``: per batch, the loss's
        presampled keyword arguments (the (user, pos, neg) fanout trees as
        ``trees``, ASAGE's attribute trees as ``attr_trees``), else drawn from
        the generator. A captured trainer (``step_graph``) replays its
        cadence's graphs unless ``draws`` are given. Returns the per-step
        losses, on the device. Drops an outstanding prefetch (the steps
        draw from the generator)."""
        self._prefetch = None
        losses = self._train_epoch(batches, draws)
        self._average([losses])  # the ranks' shares: the whole batches' losses
        return losses

    def _train_epoch(self, batches: Sequence[BPRBatch], draws: Optional[Sequence[dict]]) -> torch.Tensor:
        n = len(batches)
        losses = torch.empty(n, device=self.device)
        graph = self.step_graph if draws is None else None

        def run(part: str, b: Optional[int] = None):
            """One call of the cadence's ``part`` (a Trainer method; on
            batch b for a step): a replay, or an eager call."""
            if graph is not None:
                return graph.run(part, None if b is None else batches[b])
            return getattr(self, part)(*(() if b is None else (batches[b], None if draws is None else draws[b])))

        if self.cadence == "fresh":
            for b in range(n):
                losses[b] = run("train_step", b)
            return losses
        if self.cadence == "super":
            t = self.feat_every
            for s in range(0, n, t):
                if s == 0 or self.relin_every != 0:  # R = 0: once an epoch
                    run("_linearize")
                for b in range(s, min(s + t, n)):
                    losses[b] = run("_inner_step", b)
                run("_outer_step")  # a super-step cut short ends all the same
            return losses
        if self.ooc:
            with self._whole():
                self.model.refresh_ooc_proj()
        # one linearization a block of R steps, or an epoch (R = 0, dask)
        span = self.relin_every if self.cadence == "relin" and self.relin_every > 0 else n
        for b in range(n):
            if b % span == 0:
                run("_linearize")
            losses[b] = run("_cached_step", b)
        if self.ooc:
            acc = self.cached.acc
            self._average(acc[side] for side in sorted(acc))
            self._apply_ooc_update(acc, n)
            for a in acc.values():
                a.zero_()
        return losses

    @torch.no_grad()
    def _apply_ooc_update(self, acc: Dict[str, torch.Tensor], n_steps: int) -> None:
        """The out-of-core numeric linears' epoch-delayed update: one streamed
        X^T G pass a side, plain SGD at lr / n_steps on the summed table
        gradient G (the JAX package's; the reference's dask variant never
        trains them)."""
        scale = self.config.lr / n_steps
        for side, mm in self.ooc.items():
            gw, gb = stream_project_grad(mm, acc[side])
            getattr(self.model, f"{side}_numeric_w").sub_(scale * self._own(f"{side}_numeric_w", gw))
            getattr(self.model, f"{side}_numeric_b").sub_(scale * gb)

    def _draw(self, generator: torch.Generator) -> BPRBatch:
        return sample_bpr(
            generator, self.graph, self.samples_per_epoch, self.config.neg_candidates,
            edge_alias=self.edge_alias, neg_alias=self.neg_alias,
        )

    def sample_epoch(self) -> BPRBatch:
        """The epoch's triplets, drawn on the device from the trainer's
        generator (an outstanding prefetch is dropped)."""
        self._prefetch = None
        return self._draw(self.generator)

    @property
    def prefetched(self) -> Optional[BPRBatch]:
        """The next epoch's triplets, drawn ahead (``pipeline_dispatch``), or
        None; the current stream is ordered after their draw."""
        if self._prefetch is None:
            return None
        return self._after_draw(self._prefetch[3])

    def _after_draw(self, batches: BPRBatch) -> BPRBatch:
        """Order the current stream after the draw of ``batches`` (on the
        card), and keep their memory from the draw stream's reuse until the
        current stream is done with them."""
        if self._draw_stream is not None:
            here = torch.cuda.current_stream(self.device)
            here.wait_stream(self._draw_stream)
            for t in (batches.user, batches.pos, batches.neg, batches.valid):
                t.record_stream(here)
        return batches

    def _prefetch_next(self) -> None:
        """Draw the next epoch's triplets from a copy of the generator, which
        itself stays where it is; on the card on the draw stream."""
        if self._draw_generator is None:
            self._draw_generator = torch.Generator(device=self.device)
            if self.device.type == "cuda":
                self._draw_stream = torch.cuda.Stream(self.device)
        before = self.generator.get_state()
        self._draw_generator.set_state(before)
        with torch.cuda.stream(self._draw_stream) if self._draw_stream is not None else contextlib.nullcontext():
            batches = self._draw(self._draw_generator)
        self._prefetch = (before, self._draw_generator.get_state(), self.samples_per_epoch, batches)

    def _take_prefetch(self) -> Optional[BPRBatch]:
        """The prefetched triplets, the generator set past their draw, if the
        generator still stands where they were drawn from (and the epoch's
        size is theirs); else None. The prefetch is gone either way."""
        prefetch, self._prefetch = self._prefetch, None
        if prefetch is None:
            return None
        before, after, samples, batches = prefetch
        if samples != self.samples_per_epoch or not torch.equal(self.generator.get_state(), before):
            return None
        self.generator.set_state(after)
        return self._after_draw(batches)

    def train_one_epoch(self, prefetch_next: bool = True) -> float:
        """One epoch; returns its mean loss (the epoch's one host sync). Its
        triplets are the prefetched ones when there are (``pipeline_dispatch``,
        module docstring), else drawn now; under ``pipeline_dispatch`` and
        ``prefetch_next`` the next epoch's are drawn before the loss is read."""
        bs = self.config.bpr_batch_size
        batches = self._take_prefetch()
        if batches is None:
            batches = self._draw(self.generator)
        losses = self.train_epoch([batches.slice(b * bs, (b + 1) * bs) for b in range(self.num_batches)])
        mean = losses.mean()
        if self.pipeline and prefetch_next:
            self._prefetch_next()
        self.step += 1
        self.epoch_losses = losses
        return float(mean)

    def test(self) -> Dict[str, float]:
        """One evaluation of the current parameters (``eval/evaluate.py``;
        on one CUDA device, from the second on, a replay of the captured
        evaluation); ``dask`` first streams its numeric projections, eagerly,
        into the tensors the evaluation reads."""
        with self._whole():
            if self.ooc:
                self.model.refresh_ooc_proj()
            results, _ = self.evaluator(self.eval_data, with_topk=False)
        return results

    def fit(self, epochs: Optional[int] = None, resume: bool = False) -> Dict[str, float]:
        """Evaluate, then train to ``epochs`` (default config.epochs) in all,
        evaluating every test_span epochs and after the last; returns the last
        evaluation. ``resume`` continues from the current state (after
        ``restore``) instead of a fresh ``init_state``."""
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        if not resume:
            self.init_state()
        results = self.test()
        self.logger.log(results, step=self.step)
        while self.step < epochs:
            t0 = time.perf_counter()
            loss = self.train_one_epoch(prefetch_next=self.step + 1 < epochs)
            dt = time.perf_counter() - t0
            self.logger.log(
                {
                    "loss": loss,
                    "epoch_time_s": dt,
                    "samples_per_sec": self.samples_per_epoch / max(dt, 1e-9),
                },
                step=self.step,
            )
            if self.step % cfg.test_span == 0 or self.step == epochs:
                results = self.test()
                self.logger.log(results, step=self.step)
                k0 = cfg.topks[0]
                if results.get(f"recall@{k0}", -1.0) > self.max_recall:
                    self.max_recall = results[f"recall@{k0}"]
                    self.save()
                    if is_primary_host():
                        cprint(f"[best] recall@{k0}={self.max_recall:.5f} @ epoch {self.step}")
        return results

    def _optimizers(self) -> Dict[str, torch.optim.Adam]:
        """Checkpoint prefix -> optimizer."""
        opts = {OPTIMIZER_PREFIXES[0]: self.optimizer}
        if self.opt_feat is not None:
            opts[OPTIMIZER_PREFIXES[1]] = self.opt_feat
        return opts

    def save(self, path=None) -> None:
        """Write parameters, each Adam's moments and step count, the
        sampler's generator state (with a prefetch outstanding, the state
        before its draw: the generator's own), the epoch count and the best
        recall.
        Under a mesh every rank gathers the row-sharded tables and moments
        (in the same order), and the primary writes them whole."""
        params = dict(self.model.named_parameters())
        state = {}
        for prefix, opt in self._optimizers().items():
            count, mu, nu = adam_state_to_numpy(opt, self.model)
            state[f"{prefix}_count"] = np.int64(count)
            state.update({f"{prefix}_mu/{k}": v for k, v in flatten_params(mu).items()})
            state.update({f"{prefix}_nu/{k}": v for k, v in flatten_params(nu).items()})
        for name in self.shards.names if self.shards is not None else ():
            params[name] = self.shards.gather(params[name])
            for key in [f"{prefix}_{m}/{name}" for prefix in self._optimizers() for m in ("mu", "nu")]:
                state[key] = self.shards.gather(torch.from_numpy(state[key]).to(self.device)).cpu().numpy()
        if not is_primary_host():
            return
        state["generator"] = self.generator.get_state()
        state["step"] = np.int64(self.step)
        state["max_recall"] = np.float64(self.max_recall)
        save_checkpoint(path or checkpoint_path(self.config), params, self.config, state)

    def restore(self, path=None) -> None:
        """Load the full training state written by ``save``, or by
        ``tools/export_jax_checkpoint.py``: its file has no generator state
        (JAX's key has no torch counterpart), and the sampler's stream then
        starts from config.seed. Under a mesh each rank reads the whole file
        and keeps its blocks of the row-sharded tables and moments."""
        ckpt = load_checkpoint(path or checkpoint_path(self.config))
        st = ckpt["state"]
        if self.shards is not None:
            self.shards.release()
        params_from_jax(ckpt["params"], self.model)
        if self.shards is not None:
            self.shards = shard_params(self.model, self.mesh)
        self._new_optimizers()
        names = [n for n, _ in self.model.named_parameters()]
        for prefix, opt in self._optimizers().items():
            count = int(st[f"{prefix}_count"])
            if count:
                adam_state_from_jax(
                    count,
                    {n: self._own(n, st[f"{prefix}_mu/{n}"]) for n in names},
                    {n: self._own(n, st[f"{prefix}_nu/{n}"]) for n in names},
                    opt,
                    self.model,
                )
        if "generator" in st:
            self.generator.set_state(torch.from_numpy(st["generator"]))
        else:
            self.generator.manual_seed(self.config.seed)
        self._prefetch = None
        self.step = int(st["step"])
        self.max_recall = float(st["max_recall"])
