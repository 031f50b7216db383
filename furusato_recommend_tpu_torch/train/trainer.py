"""Trainer: BPR epochs, the evaluation cadence and best-by-recall
checkpoints (port of ``train/trainer.py``, MF / LightGCN family).

An epoch draws all of its triplets in one ``sample_bpr`` call on the device,
then runs ``num_batches`` steps of forward, backward and ``torch.optim.Adam``
(b1 0.9, b2 0.999, eps 1e-8: ``optax.adam``). Each step's loss stays on the
device; the epoch's mean is read once, at its end. ``fit`` evaluates before
training, then every ``test_span`` epochs and after the last one, and saves
the full training state whenever recall@topks[0] improves.

The JAX package's XLA machinery (the compile cache, the epoch program split,
``pipeline_dispatch``'s prefetch, the device mesh) has no counterpart here:
PyTorch runs eagerly and its device queue already overlaps the host. The
SAGE-only branches (cached initial tables, ``feature_update_every``,
out-of-core features) and the weighted sampling recipes raise.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..convert import adam_state_from_jax, adam_state_to_numpy, params_from_jax, params_to_numpy
from ..core.checkpoint import checkpoint_path, load_checkpoint, save_checkpoint
from ..core.device import resolve_device
from ..data.dataset import Dataset
from ..eval.evaluate import EvalData, Evaluator, build_eval_data
from ..models.base import PairwiseModel
from ..obs.log import MetricLogger, cprint
from ..sampling.bpr import sample_bpr

__all__ = ["Trainer"]


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
        if ddp_recipe or config.sample_pow:
            raise NotImplementedError("weighted sampling recipes (ddp, sample_pow) are not ported yet")
        if config.mesh.num_devices > 1:
            raise NotImplementedError("multi-device training is not ported yet")
        if config.feature_update_every > 1:
            raise NotImplementedError("feature_update_every > 1 belongs to the SAGE family, not ported yet")
        if config.compile_cache:
            raise NotImplementedError("compile_cache is XLA's; the port compiles nothing per shape")
        if config.relin_every < 0:
            raise ValueError(f"relin_every must be >= 0, got {config.relin_every}")
        self.config = config
        self.dataset = dataset
        self.device = resolve_device(device)
        self.graph = dataset.graph.to(self.device)
        self.model = model.to(self.device)
        self.logger = logger or MetricLogger(quiet=config.test_mode)
        self.max_recall = -1.0
        self.step = 0

        bs = config.bpr_batch_size
        # one epoch draws train_size triplets, rounded up to whole batches
        self.num_batches = -(-max(dataset.train_size, bs) // bs)
        self.samples_per_epoch = self.num_batches * bs

        self.optimizer = self._new_optimizer()
        #: the sampler's stream (and edge dropout's); saved and restored with
        #: the checkpoint so a resumed run draws what an uninterrupted one would
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)

        max_deg = int(np.max(np.bincount(dataset.train_user, minlength=dataset.n_users)))
        self.evaluator = Evaluator(model, self.graph, config, max_train_degree=max_deg)
        self.eval_data: EvalData = build_eval_data(
            dataset, config.eval_user_batch, item_categories=item_categories, device=self.device
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
        on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        gen = self.generator if self.config.dropout else None
        loss, _ = self.model.loss(self.graph, batch, generator=gen)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_one_epoch(self) -> float:
        """One epoch; returns its mean loss (the epoch's one host sync)."""
        bs = self.config.bpr_batch_size
        batches = sample_bpr(
            self.generator, self.graph, self.samples_per_epoch, self.config.neg_candidates
        )
        losses = torch.empty(self.num_batches, device=self.device)
        for b in range(self.num_batches):
            losses[b] = self.train_step(batches.slice(b * bs, (b + 1) * bs))
        self.step += 1
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
        state.update({f"adam_mu/{k}": v for k, v in mu.items()})
        state.update({f"adam_nu/{k}": v for k, v in nu.items()})
        state["generator"] = self.generator.get_state()
        state["step"] = np.int64(self.step)
        state["max_recall"] = np.float64(self.max_recall)
        save_checkpoint(
            path or checkpoint_path(self.config), params_to_numpy(self.model), self.config, state
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
