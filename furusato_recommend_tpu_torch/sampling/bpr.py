"""BPR triplet sampling on the device (port of ``sampling/bpr.py``).

One call draws a whole epoch's (user, positive, negative) triplets at once,
from a ``torch.Generator`` on the graph's device:

- user: uniform over [0, n_users); users without train items give rows with
  ``valid`` False, which contribute nothing to the loss;
- positive: ``randint(0, 2^30) % deg`` into the user's sorted train row;
- negative: ``neg_candidates`` uniform item draws, tested against the user's
  positives by the graph's cuckoo set (``pos_hash``; binary search of the
  train row without one); the first candidate that is not a positive wins,
  and the last one when all are (probability (deg / m)^K).

The weighted recipes of the JAX package (an edge alias table for positives,
a popularity alias table for negatives: ``--sample_pow`` and the ddp recipe)
are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..data.graph import BipartiteGraph
from ..ops.csr_search import csr_contains
from ..ops.cuckoo import cuckoo_contains

__all__ = ["BPRBatch", "sample_bpr"]


@dataclass(frozen=True)
class BPRBatch:
    user: torch.Tensor  # [N] int32
    pos: torch.Tensor  # [N] int32 item ids in [0, m_items)
    neg: torch.Tensor  # [N] int32
    valid: torch.Tensor  # [N] bool; False rows contribute zero loss

    def slice(self, start: int, stop: int) -> "BPRBatch":
        return BPRBatch(
            self.user[start:stop], self.pos[start:stop], self.neg[start:stop],
            self.valid[start:stop],
        )

    def to(self, device) -> "BPRBatch":
        return BPRBatch(
            self.user.to(device), self.pos.to(device), self.neg.to(device),
            self.valid.to(device),
        )


def sample_bpr(
    generator: torch.Generator,
    graph: BipartiteGraph,
    num_samples: int,
    neg_candidates: int = 8,
    edge_alias=None,
    neg_alias=None,
) -> BPRBatch:
    """Draw ``num_samples`` (user, pos, neg) triplets on the graph's device;
    ``generator`` must live on that device."""
    if edge_alias is not None or neg_alias is not None:
        raise NotImplementedError("alias-table sampling (sample_pow, ddp recipe) is not ported yet")
    with torch.profiler.record_function("sample_bpr"):  # names it in a trace
        return _sample_uniform(generator, graph, num_samples, neg_candidates)


def _sample_uniform(generator, graph, num_samples, neg_candidates) -> BPRBatch:
    csr = graph.user_pos
    dev = csr.indptr.device
    nnz = csr.nnz

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator, device=dev)

    user = randint(graph.n_users, (num_samples,))
    start = csr.indptr[user]
    deg = csr.indptr[user + 1] - start
    valid = deg > 0
    r = randint(1 << 30, (num_samples,)) % deg.clamp_min(1)
    if nnz:
        pos = csr.indices[(start + r).clamp(0, nnz - 1)]
    else:
        pos = torch.zeros(num_samples, dtype=torch.int32, device=dev)
    cand = randint(graph.m_items, (num_samples, neg_candidates))
    if graph.pos_hash is not None:
        is_pos = cuckoo_contains(graph.pos_hash, user[:, None], cand)
    else:
        is_pos = csr_contains(csr, user[:, None], cand, max_row_len=graph.max_user_degree or None)
    ok = ~is_pos
    # argmax returns the first maximal index: the first acceptable candidate
    first_ok = ok.to(torch.uint8).argmax(dim=1)
    pick = torch.where(ok.any(dim=1), first_ok, torch.full_like(first_ok, neg_candidates - 1))
    neg = cand.gather(1, pick[:, None])[:, 0]
    return BPRBatch(
        user=user.to(torch.int32),
        pos=pos.to(torch.int32),
        neg=neg.to(torch.int32),
        valid=valid,
    )
