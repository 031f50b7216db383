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
  built on them would refuse.) Epochs round up to whole blocks;
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
row-sharded over ``model`` (gathered for the forward); before every Adam
step (the cadences' pullbacks and both Adams under T > 1 included) a
block's gradient is averaged over ``data`` and a replicated parameter's over
the world, so the mesh trains as one process does.
``save`` gathers the blocks on every rank and the primary writes whole
tables and moments, which a single-process ``restore`` reads; ``restore``
and ``init_state`` shard again. (Deviation: the JAX package raises where a
model axis spans processes; every rank of the port is a process.) Only the
primary prints and logs.

The JAX package's XLA machinery (the compile cache, the epoch program split,
``pipeline_dispatch``'s prefetch) has no counterpart here: PyTorch runs
eagerly and its device queue already overlaps the host.
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
from .sharding import adam, adam_step, build_kernels_once, loss_backward

__all__ = ["OPTIMIZER_PREFIXES", "Trainer"]

#: the checkpoint's key prefix of each Adam: the one that steps every step,
#: then the feature parameters' under ``feature_update_every`` > 1
OPTIMIZER_PREFIXES = ("adam", "feat_adam")


class _Linearization:
    """The initial tables computed from a snapshot of the feature parameters
    (and of the out-of-core projections), with their graph kept: ``leaves``
    are the tables as a step reads them, ``pullback`` maps a table gradient
    onto the snapshot."""

    def __init__(self, model, names: Sequence[str], with_proj: bool):
        params = dict(model.named_parameters())
        self.names = list(names)
        snap = {k: params[k].detach().clone().requires_grad_(True) for k in self.names}
        self.proj_sides = sorted(model.ooc_numeric) if with_proj else []
        proj = {s: model._ooc_proj[s].detach().requires_grad_(True) for s in self.proj_sides}
        with torch.enable_grad():
            self.tables = model.tables_at(snap, proj if with_proj else None)
        self.inputs = list(snap.values()) + [proj[s] for s in self.proj_sides]
        self.leaves = tuple(t.detach() for t in self.tables)

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
            if config.loss_fn == "infonce" and config.mesh.data > 1:
                raise ValueError("in-batch InfoNCE takes its negatives from the whole batch; it does not "
                                 "split over a data axis")
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

        #: the parameters the initial tables depend on (cached cadences)
        self.feature_names = sorted(model.initial_param_keys()) if self.cadence != "fresh" else []
        self._new_optimizers()
        #: the sampler's stream (and edge dropout's); saved and restored with
        #: the checkpoint so a resumed run draws what an uninterrupted one would
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)

        max_deg = int(np.max(np.bincount(dataset.train_user, minlength=dataset.n_users)))
        self.evaluator = Evaluator(model, self.graph, config, max_train_degree=max_deg, mesh=self.mesh)
        self.eval_data: EvalData = build_eval_data(
            dataset, config.eval_user_batch, item_categories=item_categories,
            max_batches=config.test_count if ddp_recipe else None, device=self.device,
        )

    def _whole(self):
        """Inside, the model reads its row-sharded tables whole (a mesh)."""
        return self.shards.whole() if self.shards is not None else contextlib.nullcontext()

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
        self.optimizer = adam([p for k, p in named.items() if k not in frozen | apart], self.config)
        self.opt_feat = adam([named[k] for k in self.feature_names], self.config) if apart else None

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
        self.step = 0

    def train_step(self, batch: BPRBatch, draws: Optional[dict] = None) -> torch.Tensor:
        """One forward, backward and Adam step on ``batch`` with the tables
        computed inside the loss (R = 1); the loss stays on the device. The
        trainer's generator draws the step's randomness (edge dropout under
        config.dropout; the SAGE family's trees, unless ``draws`` gives them,
        and dropout). Under a mesh, this data rank's share of the loss."""
        loss = loss_backward(self.model, self.graph, batch, self.generator, draws, self.shards)
        adam_step(self.optimizer, self.shards)
        return loss

    def _direct_step(self, batch: BPRBatch, draws: Optional[dict], lin: _Linearization):
        """Zero the gradients, then forward and backward of the loss on the
        linearization's tables as leaves: (loss, the tables' gradients); the
        parameters hold their direct gradients."""
        leaves = tuple(t.detach().requires_grad_(True) for t in lin.leaves)
        loss = loss_backward(self.model, self.graph, batch, self.generator, draws, self.shards, tables=leaves)
        return loss, tuple(torch.zeros_like(t) if t.grad is None else t.grad for t in leaves)

    def _linearize(self) -> _Linearization:
        with self._whole():
            return _Linearization(self.model, self.feature_names, with_proj=bool(self.ooc))

    def train_epoch(self, batches: Sequence[BPRBatch], draws: Optional[Sequence[dict]] = None) -> torch.Tensor:
        """The steps of one epoch over ``batches`` under the configured
        cadence (module docstring); ``draws``: per batch, the loss's
        presampled keyword arguments (the (user, pos, neg) fanout trees as
        ``trees``, ASAGE's attribute trees as ``attr_trees``), else drawn from
        the generator. Returns the per-step losses, on the device."""
        losses = self._train_epoch(batches, draws)
        self._average([losses])  # the ranks' shares: the whole batches' losses
        return losses

    def _train_epoch(self, batches: Sequence[BPRBatch], draws: Optional[Sequence[dict]]) -> torch.Tensor:
        n = len(batches)
        draw = (lambda b: None) if draws is None else (lambda b: draws[b])
        losses = torch.empty(n, device=self.device)
        if self.cadence == "fresh":
            for b in range(n):
                losses[b] = self.train_step(batches[b], draw(b))
            return losses
        if self.cadence == "super":
            t = self.feat_every
            epoch_lin = self._linearize() if self.relin_every == 0 else None
            for s in range(0, n, t):
                steps = range(s, min(s + t, n))
                losses[s : s + len(steps)] = self._super_step(
                    [batches[b] for b in steps], [draw(b) for b in steps], epoch_lin or self._linearize()
                )
            return losses
        if self.ooc:
            with self._whole():
                self.model.refresh_ooc_proj()
        # one linearization a block of R steps, or an epoch (R = 0, dask)
        span = self.relin_every if self.cadence == "relin" and self.relin_every > 0 else n
        named = dict(self.model.named_parameters())
        acc: Dict[str, torch.Tensor] = {}
        for b in range(n):
            if b % span == 0:
                lin = self._linearize()
            losses[b], g_t = self._direct_step(batches[b], draw(b), lin)
            g_feat, g_proj = lin.pullback(g_t)
            for k, g in g_feat.items():  # the direct gradient plus the pullback
                p, g = named[k], self._own(k, g)
                p.grad = g if p.grad is None else p.grad + g
            for side, g in g_proj.items():
                acc[side] = g if side not in acc else acc[side] + g
            adam_step(self.optimizer, self.shards)
        if self.ooc:
            self._average(acc[side] for side in sorted(acc))
            self._apply_ooc_update(acc, n)
        return losses

    def _super_step(self, batches, draws, lin: _Linearization) -> torch.Tensor:
        """T steps of the non-feature parameters with the feature parameters
        held, then one step of the feature parameters on the pullback of the
        mean table gradient plus the mean of their direct gradients."""
        t = len(batches)
        named = dict(self.model.named_parameters())
        acc_t = [torch.zeros_like(x) for x in lin.leaves]
        acc_p = {k: torch.zeros_like(named[k]) for k in self.feature_names}
        losses = torch.empty(t, device=self.device)
        for i, (batch, dr) in enumerate(zip(batches, draws)):
            losses[i], g_t = self._direct_step(batch, dr, lin)
            for a, g in zip(acc_t, g_t):
                a += g
            for k, a in acc_p.items():
                if named[k].grad is not None:
                    a += named[k].grad
            adam_step(self.optimizer, self.shards)
        self.model.zero_grad(set_to_none=True)
        g_feat, _ = lin.pullback(tuple(a / t for a in acc_t))
        for k, g in g_feat.items():
            named[k].grad = self._own(k, g) + acc_p[k] / t
        adam_step(self.opt_feat, self.shards)
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

    def sample_epoch(self):
        """The epoch's triplets, drawn on the device."""
        return sample_bpr(
            self.generator, self.graph, self.samples_per_epoch, self.config.neg_candidates,
            edge_alias=self.edge_alias, neg_alias=self.neg_alias,
        )

    def train_one_epoch(self) -> float:
        """One epoch; returns its mean loss (the epoch's one host sync)."""
        bs = self.config.bpr_batch_size
        batches = self.sample_epoch()
        losses = self.train_epoch([batches.slice(b * bs, (b + 1) * bs) for b in range(self.num_batches)])
        self.step += 1
        self.epoch_losses = losses
        return float(losses.mean())

    def test(self) -> Dict[str, float]:
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
            loss = self.train_one_epoch()
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
        sampler's generator state, the epoch count and the best recall.
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
        self.step = int(st["step"])
        self.max_recall = float(st["max_recall"])
