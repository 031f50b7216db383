"""Model interface (port of ``models/base.py``).

A model is an ``nn.Module`` that holds its parameters and exposes

- ``propagate(graph) -> (U, I)``: full-graph user / item embeddings, the
  serving and full-catalog evaluation path;
- ``score_users(graph, users) -> [B, M]`` full-catalog scores.

The losses of the JAX base module belong to the training path and are not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..data.graph import BipartiteGraph

__all__ = ["PairwiseModel"]


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
        """``user_emb`` [N, d] and ``item_emb`` [M, d] parameters: copies of
        ``pretrained`` when given, else std * N(0, 1) drawn from ``generator``
        (default: a CPU generator seeded with config.seed)."""
        d = self.config.latent_dim
        if pretrained is not None:
            u, i = (torch.as_tensor(np.asarray(a), dtype=torch.float32) for a in pretrained)
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(self.config.seed)
            u = std * torch.randn(self.n_users, d, generator=generator)
            i = std * torch.randn(self.m_items, d, generator=generator)
        self.user_emb = nn.Parameter(u.clone())
        self.item_emb = nn.Parameter(i.clone())

    def propagate(self, graph: BipartiteGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def score_users(self, graph: BipartiteGraph, users: torch.Tensor) -> torch.Tensor:
        """Full-catalog scores [B, M]."""
        user_emb, item_emb = self.propagate(graph)
        s = user_emb[users] @ item_emb.T
        return torch.sigmoid(s) if self.score_sigmoid else s
