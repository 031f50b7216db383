"""LightGCN family (port of ``models/lightgcn.py``): lgn / rgcn / radj /
lgcnssm share one propagation.

``propagate`` runs L rounds of y = A x over the joint user + item node space and
returns the mean of the L + 1 layer outputs. ``norm="sym"`` uses the graph's
symmetric normalisation; ``norm="asym"`` (radj) re-weights each edge
deg(src)^-r * deg(dst)^-(1-r). Edge dropout and the losses are training and
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..data.graph import BipartiteGraph, COOEdges
from ..ops.segment import sparse_adjacency, spmm
from .base import PairwiseModel

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

    def _edges(self, graph: BipartiteGraph) -> COOEdges:
        e = graph.norm_edges
        if self.norm == "sym":
            return e
        deg = torch.cat([graph.user_degrees(), graph.item_degrees()]).float().clamp_min(1.0)
        r = self.config.r
        src, dst = e.src.long(), e.dst.long()
        w = deg[src].pow(-r) * deg[dst].pow(-(1.0 - r))
        return COOEdges(e.src, e.dst, w)

    def propagate(self, graph: BipartiteGraph):
        # The JAX package rounds to compute_dtype on its padded sym path only;
        # the asym weights go through its plain float32 spmm.
        cdt = self.compute_dtype if self.norm == "sym" else torch.float32
        adj = sparse_adjacency(self._edges(graph), graph.num_nodes, cdt)
        x = torch.cat([self.user_emb, self.item_emb], dim=0)
        acc = x
        h = x
        for _ in range(self.n_layers):
            h = spmm(adj, h, cdt)
            acc = acc + h
        out = acc / (self.n_layers + 1)
        return out[: self.n_users], out[self.n_users :]
