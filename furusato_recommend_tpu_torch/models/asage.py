"""ASAGE, the attribute-node SAGE model (port of ``models/asage.py``).

Besides the user-item graph, each side has a bipartite graph of its
entities and their attributes (the reference's ``user_attribute.pt`` /
``product_attribute.pt`` COO pairs, ``data/features.py::
load_attribute_coos``, or the categorical feature columns,
``attributes_from_categorical``) and a learned attribute table
(``user_attr_emb``, ``item_attr_emb``). The attribute view of a seed is a
fanout tree whose levels alternate entity, attribute, entity, ..., sampled
over the entity -> attribute CSR and its transpose, and encoded with the
main conv layers. Its entity levels are initial embeddings assembled per id
(``_initial_side_emb``, one call a side for every attribute tree of the
step), never the cached tables, so under the trainer's cached cadences that
view's gradient reaches the feature parameters directly; its attribute
levels come through one ``table_gather`` of each attribute table a step,
covering every attribute tree that reads it. A step's scatter-add launches:
the main view's two tree gathers, the two attribute tables, and one word
table gather a side whose features have text (``_text_bags``).

Loss: BPR of the main view + ``attr_loss_weight`` x BPR of the attribute
view + decay x 0.5 sum of squares of every parameter but the attribute
tables, over the number of valid rows; with ``ssl_weight`` > 0, plus that
weight x an InfoNCE between the two views of the users and of the
positives. The attribute view's dropout is this module's ``DROPOUT_RATE``
(bound at import from ``sage``, as in the JAX package).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.features import FeatureStore
from ..data.graph import CSR, BipartiteGraph
from ..ops.scatter import table_gather
from ..sampling.bpr import BatchShard
from ..sampling.neighbor import SampledNeighbors, sample_neighbors
from .base import bpr_loss_from_scores, param_norm, row_norm
from .sage import DROPOUT_RATE, SAGE, dropout
from .sage_convs import xavier

__all__ = ["ASAGE", "attributes_from_categorical"]


def _csr_pair(rows: np.ndarray, cols: np.ndarray, n_rows: int, n_cols: int) -> Tuple[CSR, CSR]:
    """(entity -> attribute CSR, attribute -> entity CSR) of COO pairs:
    rows sorted by (row, col), int32 indptr and indices."""

    def mk(r, c, n):
        order = np.lexsort((c, r))
        r_s, c_s = r[order], c[order].astype(np.int32)
        indptr = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(np.bincount(r_s, minlength=n), out=indptr[1:])
        return CSR(torch.from_numpy(indptr), torch.from_numpy(c_s))

    return mk(rows, cols, n_rows), mk(cols, rows, n_cols)


def attributes_from_categorical(features: FeatureStore) -> dict:
    """{"user": (rows, cols, n, n_attrs), "item": ...}: one (entity, value)
    pair per categorical field of each entity (a value in two fields of one
    entity counts twice), whatever the feature flags."""
    out = {}
    for side, feats, vocab in (("user", features.user, features.user_cat_vocab),
                               ("item", features.item, features.item_cat_vocab)):
        if feats.categorical is None:
            raise ValueError(
                f"asage derives its attribute graphs from the categorical features, and the {side} side has "
                "none: write attribute/{user,product}_attribute.pt, pass user_attr= / item_attr=, or add c to "
                "the feature flags"
            )
        cat = feats.categorical.cpu().numpy()
        n, f = cat.shape
        out[side] = (np.repeat(np.arange(n), f), cat.reshape(-1), n, int(vocab))
    return out


class ASAGE(SAGE):
    name = "asage"

    def __init__(
        self,
        config: Config,
        graph: BipartiteGraph,
        features: FeatureStore,
        user_attr=None,  # (rows, cols, n_entities, n_attrs) COO; default: the categorical columns
        item_attr=None,
        attr_loss_weight: float = 0.1,
        ssl_weight: float = 0.0,
        **kw,
    ):
        attrs = attributes_from_categorical(features) if user_attr is None or item_attr is None else None
        ua = user_attr if user_attr is not None else attrs["user"]
        ia = item_attr if item_attr is not None else attrs["item"]
        # read by _init_values, inside SAGE.__init__
        self.n_user_attrs, self.n_item_attrs = int(ua[3]), int(ia[3])
        super().__init__(config, graph, features, conv="sage_cat", **kw)
        self._attr_csr = {"user": _csr_pair(*ua), "item": _csr_pair(*ia)}
        self.attr_loss_weight = attr_loss_weight
        self.ssl_weight = ssl_weight

    def _init_values(self, g: torch.Generator) -> dict:
        p = super()._init_values(g)
        p["user_attr_emb"] = xavier(g, (self.n_user_attrs, self.node_dim))
        p["item_attr_emb"] = xavier(g, (self.n_item_attrs, self.node_dim))
        return p

    def to(self, *args, **kwargs) -> "ASAGE":
        super().to(*args, **kwargs)
        dev = next(self.parameters()).device
        self._attr_csr = {side: tuple(c.to(dev) for c in pair) for side, pair in self._attr_csr.items()}
        return self

    # ---- the attribute view ----
    def sample_attr_tree(self, seeds: torch.Tensor, side: str, generator: torch.Generator,
                         shard: Optional[BatchShard] = None) -> List[SampledNeighbors]:
        """The attribute tree of one seed batch: L levels, the even ones'
        nodes sampled over the entity -> attribute CSR, the odd ones' back.
        ``shard``: the seeds are that share of a batch."""
        fwd, bwd = self._attr_csr[side]
        out: List[SampledNeighbors] = []
        frontier = seeds
        for l in range(self.n_layers):
            s = sample_neighbors(generator, fwd if l % 2 == 0 else bwd, frontier, self.fanout, shard)
            out.append(s)
            frontier = s.ids
        return out

    def _attr_levels(self, specs: Sequence[Tuple[torch.Tensor, str, List[SampledNeighbors]]]) -> list:
        """The level rows of each (seeds, side, attribute tree): a side's
        entity levels of every tree assembled per id in one
        ``_initial_side_emb`` call (its word rows one ``table_gather``), its
        attribute levels through one ``table_gather`` of its attribute
        table."""
        ids = {("entity", "user"): [], ("entity", "item"): [], ("attr", "user"): [], ("attr", "item"): []}
        for seeds, side, tree in specs:
            levels = [seeds] + [s.ids for s in tree]
            for l, lvl in enumerate(levels):
                ids[("entity" if l % 2 == 0 else "attr", side)].append(lvl)
        rows = {}
        for (kind, side), parts in ids.items():
            if parts:
                flat = torch.cat([p.reshape(-1) for p in parts])
                got = (self._initial_side_emb(flat, side) if kind == "entity"
                       else table_gather(getattr(self, f"{side}_attr_emb"), flat))
                rows[(kind, side)] = iter(torch.split(got, [p.numel() for p in parts]))
        out = []
        for seeds, side, tree in specs:
            levels = [seeds] + [s.ids for s in tree]
            out.append([next(rows[("entity" if l % 2 == 0 else "attr", side)]).reshape(lvl.shape + (-1,))
                        for l, lvl in enumerate(levels)])
        return out

    def _combine_attr(self, xs: list, tree: List[SampledNeighbors], generator, train: bool,
                      shard: Optional[BatchShard] = None) -> torch.Tensor:
        """Bottom-up combine of one attribute tree's level rows with the main
        conv layers."""
        has_nbr = [None] + [s.has_neighbors for s in tree]
        drop = (generator, DROPOUT_RATE) if shard is None else (generator, DROPOUT_RATE, shard)
        big_l = self.n_layers
        for i, lp in enumerate(self.layers):
            new_xs = []
            for lvl in range(big_l - i):
                target, nbrs = xs[lvl], xs[lvl + 1]
                if train:
                    nbrs = dropout(nbrs, *drop)
                aggr = torch.where(has_nbr[lvl + 1][..., None], nbrs.mean(dim=-2), 0.0)
                h = self.conv.sampled(lp, target, aggr, {"neighbors": nbrs})
                if i != big_l - 1:
                    h = torch.relu(h)
                new_xs.append(h)
            xs = new_xs
        return xs[0]

    def encode_attr_trees(self, specs, generator: Optional[torch.Generator] = None, train: bool = False,
                          shard: Optional[BatchShard] = None) -> list:
        """[B, node_dim] attribute-view encodings of each (seeds, side,
        attribute tree); ``shard``: the seeds' share of a batch."""
        return [self._combine_attr(xs, tree, generator, train, shard)
                for xs, (_, _, tree) in zip(self._attr_levels(specs), specs)]

    # ---- training ----
    def loss(
        self,
        graph: BipartiteGraph,
        batch,
        generator: Optional[torch.Generator] = None,
        trees=None,
        attr_trees=None,
        tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """BPR of the main view + attr_loss_weight x BPR of the attribute view
        + decay x the L2 of every parameter but the attribute tables over the
        number of valid rows (+ ssl_weight x the views' InfoNCE). trees /
        attr_trees: presampled (user, pos, neg) fanout and attribute trees,
        else sampled from ``generator``, which also draws the dropout.
        tables: the main view's (user_x, item_x), else computed here."""
        seeds = ((batch.user, "user"), (batch.pos, "item"), (batch.neg, "item"))
        u, p, n = self._encode_batch(graph, batch, generator, trees, tables)
        if attr_trees is None:
            attr_trees = [self.sample_attr_tree(s, side, generator, batch.shard) for s, side in seeds]
        ua, pa, na = self.encode_attr_trees(
            [(s, side, tree) for (s, side), tree in zip(seeds, attr_trees)], generator, train=True,
            shard=batch.shard)
        norm = row_norm(batch)
        bpr = bpr_loss_from_scores((u * p).sum(-1), (u * n).sum(-1), batch.valid, norm)
        attr_bpr = bpr_loss_from_scores((ua * pa).sum(-1), (ua * na).sum(-1), batch.valid, norm)
        reg = 0.5 * sum(torch.sum(torch.square(v)) for k, v in self.named_parameters() if "attr_emb" not in k)
        reg = reg / param_norm(batch)
        total = bpr + self.attr_loss_weight * attr_bpr + self.config.decay * reg
        aux = {"bpr": bpr, "attr_bpr": attr_bpr, "reg": reg}
        if self.ssl_weight > 0:
            if batch.shard is not None:
                raise ValueError("the views' in-batch InfoNCE (ssl_weight > 0) takes its negatives from the "
                                 "whole batch; it does not split over a data axis")
            un, uan, pn, pan = (x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
                                for x in (u, ua, p, pa))
            temp = 0.1
            logits_u = un @ uan.T - (un * uan).sum(-1)[:, None]
            logits_i = pn @ pan.T - (pn * pan).sum(-1)[:, None]
            infonce = torch.mean(torch.logsumexp(logits_u / temp, dim=1) + torch.logsumexp(logits_i / temp, dim=1))
            total = total + self.ssl_weight * infonce
            aux["infonce"] = infonce
        return total, aux
