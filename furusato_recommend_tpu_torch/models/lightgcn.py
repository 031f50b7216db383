"""LightGCN family (port of ``models/lightgcn.py``): lgn / rgcn / radj /
lgcnssm share one propagation.

``propagate`` runs L rounds of y = A x over the joint user + item node space and
returns the mean of the L + 1 layer outputs. ``norm="sym"`` uses the graph's
symmetric normalisation; ``norm="asym"`` (radj) re-weights each edge
deg(src)^-r * deg(dst)^-(1-r). The adjacency's CSR layout is built once per
graph and kept; with ``config.dropout`` and a generator (training), each call
keeps every edge with probability keep_prob and scales it by 1 / keep_prob,
rewriting only the matrix values.

``loss``: BPR (or ``loss_mode="softmax"``, -log softmax(pos | {pos, neg})) on
the propagated rows, plus ego-L2 on the pre-propagation rows; all six row
gathers go through ``table_gather``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..data.graph import BipartiteGraph
from ..ops.segment import Adjacency, spmm
from .base import PairwiseModel, _weighted_mean, gather_batch_rows, l2_ego, row_norm

__all__ = ["LightGCN"]


class LightGCN(PairwiseModel):
    name = "lgn"

    def __init__(
        self,
        config: Config,
        graph: BipartiteGraph,
        norm: str = "sym",
        loss_mode: str = "bpr",
        pretrained=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(config, graph)
        self.dim = config.latent_dim
        self.n_layers = config.n_layers
        self.norm = norm
        self.loss_mode = loss_mode
        self._init_tables(0.1, pretrained, generator)
        self._adj_graph = None
        self._adjacency(graph)

    def _edge_weight(self, graph: BipartiteGraph) -> torch.Tensor:
        e = graph.norm_edges
        if self.norm == "sym":
            return e.weight
        deg = torch.cat([graph.user_degrees(), graph.item_degrees()]).float().clamp_min(1.0)
        r = self.config.r
        return deg[e.src.long()].pow(-r) * deg[e.dst.long()].pow(-(1.0 - r))

    def _adjacency(self, graph: BipartiteGraph):
        """(layout, edge weights, A, A^T) of ``graph``, built on its first use
        and kept while the model is given the same graph object."""
        if self._adj_graph is not graph:
            adj = Adjacency(graph.norm_edges, graph.num_nodes, symmetric=self.norm == "sym")
            weight = self._edge_weight(graph)
            self._adj = (adj, weight, *adj.matrices(weight, self._propagate_dtype()))
            self._adj_graph = graph
        return self._adj

    def _propagate_dtype(self) -> torch.dtype:
        # The JAX package rounds to compute_dtype on its padded sym path only;
        # the asym weights and edge dropout go through its plain float32 spmm.
        return self.compute_dtype if self.norm == "sym" else torch.float32

    def propagate(self, graph: BipartiteGraph, generator: Optional[torch.Generator] = None):
        layout, weight, a, a_t = self._adjacency(graph)
        cdt = self._propagate_dtype()
        if self.config.dropout and generator is not None:
            keep = self.config.keep_prob
            kept = torch.rand(weight.shape, generator=generator, device=weight.device) < keep
            cdt = torch.float32
            a, a_t = layout.matrices(torch.where(kept, weight / keep, 0.0), cdt)
        x = torch.cat([self.user_emb, self.item_emb], dim=0)
        acc = x
        h = x
        for _ in range(self.n_layers):
            h = spmm(a, h, cdt, a_t)
            acc = acc + h
        out = acc / (self.n_layers + 1)
        return out[: self.n_users], out[self.n_users :]

    def loss(self, graph, batch, generator: Optional[torch.Generator] = None):
        user_emb, item_emb = self.propagate(graph, generator)
        u, p, n = gather_batch_rows(user_emb, item_emb, batch)
        # ego-embedding regularisation on the pre-propagation tables
        u0, p0, n0 = gather_batch_rows(self.user_emb, self.item_emb, batch)
        norm = row_norm(batch)
        reg = l2_ego(u0, p0, n0, batch.valid, norm)
        if self.loss_mode == "softmax":
            pos_s = torch.sum(u * p, dim=-1)
            neg_s = torch.sum(u * n, dim=-1)
            logits = torch.stack([pos_s, neg_s], dim=-1)
            main = _weighted_mean(-torch.log_softmax(logits, dim=-1)[:, 0], batch.valid, norm)
        else:
            main = self.main_loss(u, p, n, batch.valid, norm)
        return main + self.config.decay * reg, {"bpr": main, "reg": reg}
