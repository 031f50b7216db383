"""Matrix factorisation (port of ``models/mf.py``): two embedding tables
initialised N(0, 1), inner-product scores with a sigmoid on the full-catalog
path, identity propagation."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..data.graph import BipartiteGraph
from .base import PairwiseModel

__all__ = ["MF"]


class MF(PairwiseModel):
    name = "mf"
    score_sigmoid = True

    def __init__(
        self,
        config: Config,
        graph: BipartiteGraph,
        pretrained=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(config, graph)
        self.dim = config.latent_dim
        self._init_tables(1.0, pretrained, generator)

    def propagate(self, graph: BipartiteGraph):
        return self.user_emb, self.item_emb
