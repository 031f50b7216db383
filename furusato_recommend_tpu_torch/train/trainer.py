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

The SAGE family's loss computes the initial (feature) tables inside each step
(one autograd pass): the JAX trainer's ``relin_every=1``, which is also its
``train_emb`` path. Its other cadences (``relin_every`` other than 1,
``feature_update_every`` > 1) and the out-of-core features belong to the next
SAGE slice and raise. The JAX package's XLA machinery (the compile cache, the
epoch program split, ``pipeline_dispatch``'s prefetch, the device mesh) has no
counterpart here: PyTorch runs eagerly and its device queue already overlaps
the host.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..convert import adam_state_from_jax, adam_state_to_numpy, flatten_params, params_from_jax
from ..core.checkpoint import checkpoint_path, load_checkpoint, save_checkpoint
from ..core.device import resolve_device
from ..data.dataset import Dataset
from ..eval.evaluate import EvalData, Evaluator, build_eval_data
from ..models.base import PairwiseModel
from ..obs.log import MetricLogger, cprint
from ..ops.alias import AliasTable
from ..sampling.bpr import sample_bpr
from ..sampling.weights import (
    capped_positive_edge_weights,
    edge_alias_from_weights,
    load_sample_prob,
    negative_alias,
    popularity_positive_edge_weights,
    sample_prob_edge_weights,
)

__all__ = ["Trainer"]

_NEXT_SAGE_SLICE = "belongs to the next SAGE slice of the port"


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
        if config.mesh.num_devices > 1:
            raise NotImplementedError("multi-device training is not ported yet")
        if config.feature_update_every > 1:
            raise NotImplementedError(f"feature_update_every > 1 {_NEXT_SAGE_SLICE}")
        if config.compile_cache:
            raise NotImplementedError("compile_cache is XLA's; the port compiles nothing per shape")
        if config.relin_every < 0:
            raise ValueError(f"relin_every must be >= 0, got {config.relin_every}")
        # the JAX trainer's cached-tables path (its relin_every cadence)
        cached_tables = (
            not config.train_emb
            and hasattr(model, "initial_tables")
            and not getattr(model, "full_graph_train", False)
        )
        if cached_tables and config.relin_every != 1:
            raise NotImplementedError(f"relin_every={config.relin_every} {_NEXT_SAGE_SLICE}")
        self.config = config
        self.dataset = dataset
        self.device = resolve_device(device)
        self.graph = dataset.graph.to(self.device)
        self.model = model.to(self.device)
        self.logger = logger or MetricLogger(quiet=config.test_mode)
        self.max_recall = -1.0
        self.step = 0
        #: the last epoch's per-step losses, on the device
        self.epoch_losses: Optional[torch.Tensor] = None

        bs = config.bpr_batch_size
        # one epoch draws train_size triplets (train_iterative x that in the
        # ddp recipe), rounded up to whole batches
        mult = config.train_iterative if ddp_recipe else 1
        self.num_batches = -(-max(dataset.train_size * mult, bs) // bs)
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

        self.optimizer = self._new_optimizer()
        #: the sampler's stream (and edge dropout's); saved and restored with
        #: the checkpoint so a resumed run draws what an uninterrupted one would
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)

        max_deg = int(np.max(np.bincount(dataset.train_user, minlength=dataset.n_users)))
        self.evaluator = Evaluator(model, self.graph, config, max_train_degree=max_deg)
        self.eval_data: EvalData = build_eval_data(
            dataset, config.eval_user_batch, item_categories=item_categories,
            max_batches=config.test_count if ddp_recipe else None, device=self.device,
        )

    def _new_optimizer(self) -> torch.optim.Adam:
        return torch.optim.Adam(
            self.model.parameters(), lr=self.config.lr, betas=(0.9, 0.999), eps=1e-8
        )

    def init_state(self, seed: Optional[int] = None) -> None:
        """Fresh parameters (drawn from ``seed``, default config.seed), fresh
        Adam moments, the sampler's stream from ``seed``, step 0."""
        seed = self.config.seed if seed is None else seed
        self.model.init_parameters(torch.Generator().manual_seed(seed))
        self.optimizer = self._new_optimizer()
        self.generator.manual_seed(seed)
        self.step = 0

    def train_step(self, batch) -> torch.Tensor:
        """One forward, backward and Adam step on ``batch``; the loss stays
        on the device. The trainer's generator draws the step's randomness
        (edge dropout under config.dropout; the SAGE family's trees and
        dropout)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.model.loss(self.graph, batch, generator=self.generator)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

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
        losses = torch.empty(self.num_batches, device=self.device)
        for b in range(self.num_batches):
            losses[b] = self.train_step(batches.slice(b * bs, (b + 1) * bs))
        self.step += 1
        self.epoch_losses = losses
        return float(losses.mean())

    def test(self) -> Dict[str, float]:
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
                    cprint(f"[best] recall@{k0}={self.max_recall:.5f} @ epoch {self.step}")
        return results

    def save(self, path=None) -> None:
        """Write parameters, Adam's moments and step count, the sampler's
        generator state, the epoch count and the best recall."""
        count, mu, nu = adam_state_to_numpy(self.optimizer, self.model)
        state = {"adam_count": np.int64(count)}
        state.update({f"adam_mu/{k}": v for k, v in flatten_params(mu).items()})
        state.update({f"adam_nu/{k}": v for k, v in flatten_params(nu).items()})
        state["generator"] = self.generator.get_state()
        state["step"] = np.int64(self.step)
        state["max_recall"] = np.float64(self.max_recall)
        save_checkpoint(
            path or checkpoint_path(self.config), dict(self.model.named_parameters()), self.config, state
        )

    def restore(self, path=None) -> None:
        """Load the full training state written by ``save``."""
        ckpt = load_checkpoint(path or checkpoint_path(self.config))
        st = ckpt["state"]
        params_from_jax(ckpt["params"], self.model)
        self.optimizer = self._new_optimizer()
        count = int(st["adam_count"])
        if count:
            names = [n for n, _ in self.model.named_parameters()]
            adam_state_from_jax(
                count,
                {n: st[f"adam_mu/{n}"] for n in names},
                {n: st[f"adam_nu/{n}"] for n in names},
                self.optimizer,
                self.model,
            )
        self.generator.set_state(torch.from_numpy(st["generator"]))
        self.step = int(st["step"])
        self.max_recall = float(st["max_recall"])
