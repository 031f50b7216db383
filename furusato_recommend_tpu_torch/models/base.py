"""Model interface and the pairwise losses (port of ``models/base.py``).

A model is an ``nn.Module`` that holds its parameters and exposes

- ``propagate(graph, generator=None) -> (U, I)``: full-graph user / item
  embeddings, the serving and full-catalog evaluation path (a generator turns
  on the training-time randomness, such as edge dropout, where a model has it);
- ``score_users(graph, users) -> [B, M]`` full-catalog scores;
- ``loss(graph, batch, generator=None) -> (total, {"bpr", "reg"})``: the
  training objective on a ``BPRBatch``.

Every batch row reaches a table through ``ops/scatter.py::table_gather``, so the
table gradients run the scatter-add kernel on the card. The optimizer lives in
the trainer.

A loss is a mean over the batch's valid rows, plus terms over the parameters
divided by the same count (``row_norm``, ``param_norm``). On a data rank's share of a batch
(``BPRBatch.shard``) both divide by the whole batch's count, the rows' mean
scaled by the share, so that the mean of the data ranks' losses (and
gradients) is the whole batch's.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..data.graph import BipartiteGraph
from ..ops.scatter import table_gather

__all__ = [
    "PairwiseModel",
    "bpr_loss_from_scores",
    "infonce_in_batch",
    "l2_ego",
    "l2_params",
    "row_norm",
    "param_norm",
]


def row_norm(batch) -> Optional[torch.Tensor]:
    """What a data shard's losses divide their sums over its rows by: the
    whole batch's valid rows (at least 1) times the shard's share of the
    rows; None for a whole batch, whose losses divide by its own valid rows."""
    shard = batch.shard
    if shard is None:
        return None
    return torch.clamp_min(shard.count.to(torch.float32), 1.0) * ((shard.stop - shard.start) / shard.total)


def param_norm(batch) -> torch.Tensor:
    """What a loss divides a term over the parameters by: the valid rows of
    the whole batch (at least 1)."""
    count = batch.valid.sum() if batch.shard is None else batch.shard.count
    return count.clamp_min(1)


def _weighted_mean(per: torch.Tensor, valid: torch.Tensor, norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    w = valid.to(per.dtype)
    return torch.sum(per * w) / (torch.clamp_min(torch.sum(w), 1.0) if norm is None else norm)


def bpr_loss_from_scores(pos_scores, neg_scores, valid, norm=None) -> torch.Tensor:
    """mean softplus(neg - pos) over valid rows (a sum over ``norm`` when
    given)."""
    return _weighted_mean(F.softplus(neg_scores - pos_scores), valid, norm)


def infonce_in_batch(u_emb, p_emb, valid, temperature: float) -> torch.Tensor:
    """In-batch sampled softmax: every other row's positive is a negative,
    -log softmax(u_i . p_i / tau | {u_i . p_j}_j); invalid columns dropped."""
    logits = (u_emb @ p_emb.T) / temperature
    mask = valid.to(logits.dtype)
    logits = logits + torch.log(torch.clamp_min(mask, 1e-30))[None, :]
    per = -torch.log_softmax(logits, dim=1)
    return _weighted_mean(torch.diagonal(per), valid)


def l2_ego(u_emb, p_emb, n_emb, valid, norm=None) -> torch.Tensor:
    """(1/2)(|u|^2 + |p|^2 + |n|^2) / B over valid rows (B: ``norm`` when
    given)."""
    w = valid.to(u_emb.dtype)[:, None]
    sq = (
        torch.sum((u_emb * w) * u_emb)
        + torch.sum((p_emb * w) * p_emb)
        + torch.sum((n_emb * w) * n_emb)
    )
    return 0.5 * sq / (torch.clamp_min(torch.sum(w), 1.0) if norm is None else norm)


def l2_params(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """(1/2) sum of squares of every floating-point parameter."""
    return 0.5 * sum(torch.sum(torch.square(p)) for p in params if p.is_floating_point())


def gather_batch_rows(user_emb, item_emb, batch):
    """(u, p, n) rows of a batch through ``table_gather``: one gather from the
    user table and one from the item table for positives and negatives."""
    b = batch.user.shape[0]
    u = table_gather(user_emb, batch.user)
    pn = table_gather(item_emb, torch.cat([batch.pos, batch.neg]))
    return u, pn[:b], pn[b:]


class PairwiseModel(nn.Module):
    #: apply sigmoid to full-catalog scores (MF); monotonic, so top-k invariant
    score_sigmoid: bool = False

    def __init__(self, config: Config, graph: BipartiteGraph):
        super().__init__()
        self.config = config
        self.n_users = graph.n_users
        self.m_items = graph.m_items

    @property
    def compute_dtype(self) -> torch.dtype:
        """SpMM operand precision (config.compute_dtype); sums stay float32."""
        return getattr(torch, self.config.compute_dtype)

    def _init_tables(
        self,
        std: float,
        pretrained: Optional[Tuple[np.ndarray, np.ndarray]],
        generator: Optional[torch.Generator],
    ) -> None:
        """``user_emb`` [N, d] and ``item_emb`` [M, d] parameters."""
        self._init_std = std
        self._pretrained = pretrained
        d = self.config.latent_dim
        self.user_emb = nn.Parameter(torch.empty(self.n_users, d))
        self.item_emb = nn.Parameter(torch.empty(self.m_items, d))
        self.init_parameters(generator)

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Set the tables in place: copies of the pretrained arrays when the
        model has them, else std * N(0, 1) drawn on the CPU from ``generator``
        (default: seeded with config.seed), users first."""
        if self._pretrained is not None:
            u, i = (torch.as_tensor(np.asarray(a), dtype=torch.float32) for a in self._pretrained)
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(self.config.seed)
            u = self._init_std * torch.randn(self.n_users, self.user_emb.shape[1], generator=generator)
            i = self._init_std * torch.randn(self.m_items, self.item_emb.shape[1], generator=generator)
        with torch.no_grad():
            self.user_emb.copy_(u)
            self.item_emb.copy_(i)

    def propagate(
        self, graph: BipartiteGraph, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def score_users(self, graph: BipartiteGraph, users: torch.Tensor) -> torch.Tensor:
        """Full-catalog scores [B, M]."""
        user_emb, item_emb = self.propagate(graph)
        s = user_emb[users] @ item_emb.T
        return torch.sigmoid(s) if self.score_sigmoid else s

    def main_loss(self, u, p, n, valid, norm=None) -> torch.Tensor:
        """BPR or in-batch InfoNCE, per config.loss_fn; ``norm``: the rows'
        divisor (``row_norm``), which the in-batch InfoNCE cannot take:
        its negatives are the whole batch's rows."""
        if self.config.loss_fn == "infonce":
            if norm is not None:
                raise ValueError("in-batch InfoNCE takes its negatives from the whole batch; "
                                 "it does not split over a data axis")
            return infonce_in_batch(u, p, valid, self.config.infonce_temperature)
        pos_s = torch.sum(u * p, dim=-1)
        neg_s = torch.sum(u * n, dim=-1)
        return bpr_loss_from_scores(pos_s, neg_s, valid, norm)

    def reg_loss(self, u_emb, p_emb, n_emb, valid, norm=None) -> torch.Tensor:
        return l2_ego(u_emb, p_emb, n_emb, valid, norm)

    def loss(
        self, graph: BipartiteGraph, batch, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        user_emb, item_emb = self.propagate(graph, generator)
        u, p, n = gather_batch_rows(user_emb, item_emb, batch)
        norm = row_norm(batch)
        bpr = self.main_loss(u, p, n, batch.valid, norm)
        reg = self.reg_loss(u, p, n, batch.valid, norm)
        return bpr + self.config.decay * reg, {"bpr": bpr, "reg": reg}
