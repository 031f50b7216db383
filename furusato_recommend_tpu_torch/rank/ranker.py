"""The neural re-ranker (port of ``rank/ranker.py``): a feature-cross MLP
trained with a LambdaRank pairwise objective over padded per-user candidate
groups, in place of the reference's LightGBM ``LGBMRanker``.

- the categorical id columns of ``make_X`` are embedded from one shared
  table ``cat_emb``, the numeric columns enter as they are;
- a two-layer ReLU MLP gives a scalar score, plus a bilinear user x item head
  ``<P_u f_u, P_i f_i>`` and, for an aux ranker, a linear head over the
  retriever-signal columns;
- the loss over a group: for every (i, j) with label_i > label_j,
  softplus(s_j - s_i), weighted by |delta NDCG@ndcg_at| of swapping i and j
  at the current ranks (``objective="lambdarank"``) or not (``"pairwise"``).

The parameters are ``nn.Parameter``s under the JAX package's names (``cat_emb``,
``w1`` ... ``b3``, ``pu``, ``pi``, ``wa``), so ``convert.ranker_params_from_jax``
maps its dict one to one. Every categorical gather goes through
``ops/scatter.py::table_gather``, so a training step takes ``cat_emb``'s
gradient in one ``scatter_add_rows`` launch: the kernel on the card, its plain
version on the CPU. (The JAX package indexes the table and takes XLA's gather
VJP; the gradient is the same.)

Deviations: ``calibrate`` returns its (beta, gamma, val recall) beside a
calibrated ranker instead of a ``_calibration`` leaf among the parameters;
``fit`` draws its initial parameters and batch orders from ``torch.Generator``s
seeded from ``seed`` (JAX's threefry streams cannot be reproduced), and its
``train_step`` takes any batch of group indices, so the tests feed it JAX's;
``rank`` runs its last user tile at its own size instead of padding it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.features import FeatureStore
from ..ops.scatter import table_gather
from .features import RankFeatureSpec, make_X_ids, rank_feature_spec

__all__ = ["NeuralRanker", "RankGroups", "epoch_batches"]

MASKED_SCORE = -1e9  # the loss's score of a padded slot: it ranks last


@dataclass(frozen=True)
class RankGroups:
    """Padded per-user candidate groups."""

    users: torch.Tensor  # [G] int32
    items: torch.Tensor  # [G, C] int32 candidate ids
    labels: torch.Tensor  # [G, C] float32 (1 = relevant)
    mask: torch.Tensor  # [G, C] bool
    #: optional per-candidate retriever-signal columns [G, C, A] float32
    #: (``pipeline.retriever_rank_aux``: reciprocal rank and membership per
    #: retriever); a Deviation of the JAX package from the reference's
    #: static-profile make_X, kept as it is
    aux: Optional[torch.Tensor] = None

    def to(self, device) -> "RankGroups":
        return RankGroups(**{f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    def select(self, rows) -> "RankGroups":
        """The groups at ``rows`` (indices or a boolean mask), in that order."""
        rows = torch.as_tensor(rows, device=self.users.device)
        return RankGroups(**{f.name: None if getattr(self, f.name) is None else getattr(self, f.name)[rows]
                             for f in dataclasses.fields(self)})

    def __len__(self) -> int:
        return int(self.users.shape[0])


def _xavier(shape, generator: torch.Generator) -> torch.Tensor:
    a = (6.0 / (shape[0] + shape[-1])) ** 0.5
    return (torch.rand(shape, generator=generator) * 2 - 1) * a


def epoch_batches(perm: torch.Tensor, batch_groups: int) -> torch.Tensor:
    """An epoch's batches of group indices [nb, batch_groups] from a
    permutation of the G groups, as ``jnp.resize(perm, (nb * batch_groups,))``
    with nb = max(G // batch_groups, 1): the permutation cut to whole batches,
    or repeated to fill one batch when G < batch_groups."""
    g = perm.shape[0]
    nb = max(g // batch_groups, 1)
    size = nb * batch_groups
    return perm.repeat(-(-size // g))[:size].reshape(nb, batch_groups)


class NeuralRanker(nn.Module):
    def __init__(
        self,
        features: FeatureStore,
        emb_dim: int = 16,
        hidden: Tuple[int, int] = (256, 128),
        objective: str = "lambdarank",  # or "pairwise"
        ndcg_at: int = 10,
        interaction_dim: int = 16,
        aux_dim: int = 0,
    ):
        """Parameters drawn on the CPU from seed 0 (``init_parameters``);
        ``fit`` draws them again from its seed."""
        super().__init__()
        if objective not in ("lambdarank", "pairwise"):
            raise ValueError(f"objective {objective!r} is not 'lambdarank' or 'pairwise'")
        self.features = features
        self.spec: RankFeatureSpec = rank_feature_spec(features)
        self.emb_dim = emb_dim
        self.hidden = tuple(hidden)
        self.objective = objective
        self.ndcg_at = ndcg_at
        self.interaction_dim = interaction_dim
        self.aux_dim = aux_dim
        s = self.spec
        self.in_dim = (s.n_item_cat + s.n_user_cat) * emb_dim + s.n_user_num + s.n_item_num
        self.user_in = s.n_user_cat * emb_dim + s.n_user_num
        self.item_in = s.n_item_cat * emb_dim + s.n_item_num
        h1, h2 = self.hidden
        shapes = {"cat_emb": (s.cat_vocab, emb_dim), "w1": (self.in_dim, h1), "b1": (h1,),
                  "w2": (h1, h2), "b2": (h2,), "w3": (h2, 1), "b3": (1,)}
        if interaction_dim:
            shapes.update(pu=(self.user_in, interaction_dim), pi=(self.item_in, interaction_dim))
        if aux_dim:
            shapes["wa"] = (aux_dim,)
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape)))
        self.init_parameters()

    def _kwargs(self) -> dict:
        return dict(emb_dim=self.emb_dim, hidden=self.hidden, objective=self.objective, ndcg_at=self.ndcg_at,
                    interaction_dim=self.interaction_dim, aux_dim=self.aux_dim)

    @property
    def device(self) -> torch.device:
        return self.cat_emb.device

    def to(self, *args, **kwargs) -> "NeuralRanker":
        """``nn.Module.to``, and the feature store follows the parameters."""
        super().to(*args, **kwargs)
        self.features = self.features.to(self.device)
        return self

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Set the parameters in place, drawn on the CPU: ``cat_emb`` 0.05 N(0,
        1), the weights Xavier-uniform, biases and ``wa`` zero."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        named = dict(self.named_parameters())
        with torch.no_grad():
            for name, p in named.items():
                if name == "cat_emb":
                    v = 0.05 * torch.randn(tuple(p.shape), generator=generator)
                elif name in ("w1", "w2", "w3", "pu", "pi"):
                    v = _xavier(tuple(p.shape), generator)
                else:
                    v = torch.zeros(p.shape)
                p.copy_(v)

    # ---- scores ----
    def score(self, users, items, aux: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scores of (user, item) pairs of any shapes that broadcast to [...];
        ``aux`` ([..., aux_dim] float32 retriever-signal columns) is required
        iff the ranker has aux_dim > 0."""
        cat, num = make_X_ids(self.features, users, items)
        s = self.spec
        ce = table_gather(self.cat_emb, cat)  # ids clamped into [0, cat_vocab), as JAX clips them
        lead = ce.shape[:-2]
        x = torch.cat([ce.reshape(*lead, -1), num], dim=-1)
        h = torch.relu(x @ self.w1 + self.b1)
        h = torch.relu(h @ self.w2 + self.b2)
        out = (h @ self.w3 + self.b3)[..., 0]
        if self.aux_dim:
            if aux is None:
                raise ValueError("ranker built with aux_dim > 0 needs aux columns")
            out = out + aux.to(out.device) @ self.wa
        if self.interaction_dim:
            # cat = [item_cat, user_cat], num = [user_num, item_num]
            item_vec = torch.cat([ce[..., : s.n_item_cat, :].reshape(*lead, -1), num[..., s.n_user_num:]], dim=-1)
            user_vec = torch.cat([ce[..., s.n_item_cat:, :].reshape(*lead, -1), num[..., : s.n_user_num]], dim=-1)
            out = out + torch.sum((user_vec @ self.pu) * (item_vec @ self.pi), dim=-1)
        return out

    # ---- loss ----
    def group_loss(self, groups: RankGroups) -> torch.Tensor:
        mask = groups.mask
        s = self.score(groups.users[:, None], groups.items, aux=groups.aux)  # [G, C]
        s = torch.where(mask, s, torch.full_like(s, MASKED_SCORE))
        lab = groups.labels * mask
        pref = (lab[:, :, None] > lab[:, None, :]) & (mask[:, :, None] & mask[:, None, :])
        per_pair = F.softplus(-(s[:, :, None] - s[:, None, :]))  # -log sigma(s_i - s_j)
        if self.objective == "lambdarank":
            with torch.no_grad():  # |delta NDCG| of swapping i, j at the current ranks
                # stable sorts, as jnp.argsort: the padded slots all sit at
                # MASKED_SCORE, and their order sets their ranks
                ranks = torch.argsort(torch.argsort(-s, dim=1, stable=True), dim=1, stable=True)
                disc = torch.where(ranks < self.ndcg_at, 1.0 / torch.log2(2.0 + ranks), 0.0)
                gain = 2.0 ** lab - 1.0
                delta = torch.abs((gain[:, :, None] - gain[:, None, :]) * (disc[:, :, None] - disc[:, None, :]))
            per_pair = per_pair * delta
        tot = torch.sum(per_pair * pref)
        return tot / torch.clamp_min(torch.sum(pref), 1.0)

    # ---- training ----
    def optimizer(self, lr: float, warm: bool = False) -> torch.optim.Adam:
        """``optax.adam(lr)`` over every parameter; ``warm``: Adam at 100 x lr
        over ``wa`` alone (JAX's ``multi_transform`` with the rest under
        ``set_to_zero``)."""
        params = [self.wa] if warm else list(self.parameters())
        return torch.optim.Adam(params, lr=100 * lr if warm else lr, betas=(0.9, 0.999), eps=1e-8)

    def train_step(self, groups: RankGroups, idx: torch.Tensor, opt: torch.optim.Adam) -> torch.Tensor:
        """One Adam step of ``opt`` on the groups at ``idx``; the loss stays on
        the device. Only the parameters ``opt`` steps get a gradient: a warm
        step computes ``wa``'s alone and launches no scatter, a joint step
        launches ``scatter_add_rows`` once."""
        params = [p for group in opt.param_groups for p in group["params"]]
        opt.zero_grad(set_to_none=True)
        loss = self.group_loss(groups.select(idx.to(groups.users.device)))
        loss.backward(inputs=params)
        opt.step()
        return loss.detach()

    def fit(
        self,
        groups: RankGroups,
        epochs: int = 30,
        batch_groups: int = 256,
        lr: float = 1e-3,
        seed: int = 0,
        verbose: bool = False,
        aux_warm_epochs: int = 0,
    ) -> torch.Tensor:
        """Train from fresh parameters (drawn from ``seed``); returns the
        epochs' mean losses [epochs] on the device (warm epochs not included).

        aux_warm_epochs: with aux columns, first fit ``wa`` alone for this
        many epochs (Adam at 100 x lr, every other parameter untouched), then
        every parameter with a fresh Adam. Each epoch takes a new permutation
        of the groups (``epoch_batches``)."""
        self.init_parameters(torch.Generator().manual_seed(seed))
        groups = groups.to(self.device)
        order = torch.Generator().manual_seed(seed + 1)

        def epoch(opt) -> torch.Tensor:
            batches = epoch_batches(torch.randperm(len(groups), generator=order), batch_groups)
            batches = batches.to(self.device, non_blocking=True)
            return torch.stack([self.train_step(groups, idx, opt) for idx in batches]).mean()

        if aux_warm_epochs and self.aux_dim:
            warm = self.optimizer(lr, warm=True)
            for e in range(aux_warm_epochs):
                loss = epoch(warm)
                if verbose:
                    print(f"[ranker] warm {e} loss {float(loss):.5f}")
        opt = self.optimizer(lr)
        losses: List[torch.Tensor] = []
        for e in range(epochs):
            losses.append(epoch(opt))
            if verbose:
                print(f"[ranker] epoch {e} loss {float(losses[-1]):.5f}")
        return torch.stack(losses) if losses else torch.zeros(0, device=self.device)

    # ---- the val-calibrated stack ----
    def calibrate(
        self,
        groups_val: RankGroups,
        k: int = 10,
        betas: Iterable[float] = (0.0, 0.01, 0.03, 0.1, 0.3, 1.0),
        gammas: Iterable[float] = (0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0),
    ) -> Tuple["NeuralRanker", Tuple[float, float, float]]:
        """Choose (beta, gamma) maximising validation recall@k of

            score = beta * static(u, i) + gamma * <aux, wa>

        over the grid (aux rankers only), on the host as the JAX package does;
        returns (a new ranker expressing that blend: ``w3``, ``b3`` and ``pu``
        scaled by beta, ``wa`` by gamma; (beta, gamma, val recall))."""
        if not self.aux_dim:
            raise ValueError("calibrate() requires an aux ranker")
        g = groups_val.to(self.device)
        with torch.no_grad():
            zero_aux = torch.zeros(g.items.shape + (self.aux_dim,), device=self.device)
            s_static = self.score(g.users[:, None], g.items, aux=zero_aux).cpu().numpy()
        wa = self.wa.detach().cpu().numpy()
        s_aux = groups_val.aux.cpu().numpy() @ wa
        msk = groups_val.mask.cpu().numpy()
        lab = groups_val.labels.cpu().numpy() * msk
        gt_lens = np.maximum(lab.sum(axis=1), 1.0)
        best, best_r = (1.0, 1.0), -1.0
        for beta in betas:
            for gamma in gammas:
                if beta == 0.0 and gamma == 0.0:
                    continue
                s = np.where(msk, beta * s_static + gamma * s_aux, -np.inf)
                top = np.argsort(-s, axis=1)[:, :k]
                hits = np.take_along_axis(lab, top, axis=1).sum(axis=1)
                r = float(np.mean(hits / gt_lens))
                if r > best_r:
                    best, best_r = (beta, gamma), r
        beta, gamma = best
        out = NeuralRanker(self.features, **self._kwargs()).to(self.device)
        scale = {"w3": beta, "b3": beta, "wa": gamma, **({"pu": beta} if self.interaction_dim else {})}
        own = dict(self.named_parameters())
        with torch.no_grad():
            for name, p in out.named_parameters():
                p.copy_(own[name] * scale[name] if name in scale else own[name])
        return out, (float(beta), float(gamma), best_r)

    # ---- serving ----
    @torch.no_grad()
    def rank(self, users, cand_items, k: int = 10, mask=None, chunk: int = 2048, aux=None) -> torch.Tensor:
        """Top-k candidate ids [U, min(C, k)] of each user's row of
        ``cand_items`` [U, C] (predict, sort, take k). ``mask`` [U, C] bool:
        False slots rank last and come back as id -1. Users go in tiles of
        ``chunk``; the last runs at its own size."""
        dev = self.device
        users = torch.as_tensor(users, device=dev)
        cand_items = torch.as_tensor(cand_items, device=dev)
        mask = None if mask is None else torch.as_tensor(mask, device=dev)
        aux = None if aux is None else torch.as_tensor(aux, device=dev)
        outs = []
        for lo in range(0, users.shape[0], chunk):
            hi = lo + chunk
            outs.append(self._rank_tile(users[lo:hi], cand_items[lo:hi], k,
                                        None if mask is None else mask[lo:hi],
                                        None if aux is None else aux[lo:hi]))
        return torch.cat(outs, dim=0)

    def _rank_tile(self, users, cand_items, k, mask, aux):
        s = self.score(users[:, None], cand_items, aux=aux)
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, -float("inf")))
        order = torch.argsort(-s, dim=1, stable=True)[:, :k]
        ids = torch.gather(cand_items, 1, order)
        if mask is not None:
            ids = torch.where(torch.gather(mask, 1, order), ids, torch.full_like(ids, -1))
        return ids
