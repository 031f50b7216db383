"""BPR triplet sampling on the device (port of ``sampling/bpr.py``).

One call draws a whole epoch's (user, positive, negative) triplets at once,
from a ``torch.Generator`` on the graph's device:

- user: uniform over [0, n_users); users without train items give rows with
  ``valid`` False, which contribute nothing to the loss;
- positive: ``randint(0, 2^30) % deg`` into the user's sorted train row;
- or, with ``edge_alias`` (an alias table over the train edges in CSR order:
  the ddp recipe's capped weights, ``--sample_pow``), one edge draw gives both:
  the user is ``user_pos_row[e]``, the positive ``indices[e]``, every row valid;
- negative: ``neg_candidates`` uniform item draws (or draws from
  ``neg_alias``, popularity^pow), tested against the user's positives by the
  graph's cuckoo set (``pos_hash``; binary search of the train row without
  one); the first candidate that is not a positive wins, and the last one
  when all are (probability (deg / m)^K).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

import torch

from ..data.graph import BipartiteGraph
from ..ops.alias import AliasTable
from ..ops.csr_search import csr_contains
from ..ops.cuckoo import cuckoo_contains

__all__ = ["BPRBatch", "BatchShard", "draw_rows", "sample_bpr"]


@dataclass(frozen=True)
class BatchShard:
    """A batch that is rows [start, stop) of a whole batch of ``total`` rows
    (a data rank's share under a mesh), ``count`` of the whole batch's rows
    valid (a 0-d tensor on the device)."""

    start: int
    stop: int
    total: int
    count: torch.Tensor


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
              shard: Optional[BatchShard]) -> torch.Tensor:
    """``draw(shape)`` for a tensor whose leading axis runs over a batch's
    rows (each row ``shape[0] / rows`` entries of it); for a shard, what
    ``draw`` gives the whole batch, cut to the shard's rows, so that a mesh
    takes the draws of one process."""
    shape = tuple(shape)
    if shard is None:
        return draw(shape)
    per = shape[0] // (shard.stop - shard.start)
    whole = draw((shard.total * per,) + shape[1:])
    return whole[shard.start * per : shard.stop * per]


@dataclass(frozen=True)
class BPRBatch:
    user: torch.Tensor  # [N] int32
    pos: torch.Tensor  # [N] int32 item ids in [0, m_items)
    neg: torch.Tensor  # [N] int32
    valid: torch.Tensor  # [N] bool; False rows contribute zero loss
    #: set when this batch is a data rank's rows of a whole batch
    shard: Optional[BatchShard] = None

    def slice(self, start: int, stop: int) -> "BPRBatch":
        return BPRBatch(
            self.user[start:stop], self.pos[start:stop], self.neg[start:stop],
            self.valid[start:stop],
        )

    def data_shard(self, index: int, shards: int) -> "BPRBatch":
        """Rows [index x n / shards, (index + 1) x n / shards) of this batch,
        which knows the whole batch (``shard``)."""
        n = self.user.shape[0]
        if n % shards:
            raise ValueError(f"a batch of {n} rows does not split into {shards} equal shards")
        per = n // shards
        start, stop = index * per, (index + 1) * per
        return replace(self.slice(start, stop), shard=BatchShard(start, stop, n, self.valid.sum()))

    def to(self, device) -> "BPRBatch":
        shard = self.shard and replace(self.shard, count=self.shard.count.to(device))
        return BPRBatch(
            self.user.to(device), self.pos.to(device), self.neg.to(device),
            self.valid.to(device), shard,
        )


def sample_bpr(
    generator: torch.Generator,
    graph: BipartiteGraph,
    num_samples: int,
    neg_candidates: int = 8,
    edge_alias: Optional[AliasTable] = None,
    neg_alias: Optional[AliasTable] = None,
) -> BPRBatch:
    """Draw ``num_samples`` (user, pos, neg) triplets on the graph's device;
    ``generator`` and the alias tables must live on that device."""
    if edge_alias is not None and edge_alias.n != graph.train_size:
        raise ValueError(f"edge_alias has {edge_alias.n} outcomes, the graph {graph.train_size} edges")
    if neg_alias is not None and neg_alias.n != graph.m_items:
        raise ValueError(f"neg_alias has {neg_alias.n} outcomes, the graph {graph.m_items} items")
    with torch.profiler.record_function("sample_bpr"):  # names it in a trace
        return _sample(generator, graph, num_samples, neg_candidates, edge_alias, neg_alias)


def _sample(generator, graph, num_samples, neg_candidates, edge_alias, neg_alias) -> BPRBatch:
    csr = graph.user_pos
    dev = csr.indptr.device
    nnz = csr.nnz

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator, device=dev)

    if edge_alias is not None:
        e = edge_alias.sample(generator, (num_samples,))
        user = graph.user_pos_row[e].long()
        pos = csr.indices[e]
        valid = torch.ones(num_samples, dtype=torch.bool, device=dev)
    else:
        user = randint(graph.n_users, (num_samples,))
        start = csr.indptr[user]
        deg = csr.indptr[user + 1] - start
        valid = deg > 0
        r = randint(1 << 30, (num_samples,)) % deg.clamp_min(1)
        if nnz:
            pos = csr.indices[(start + r).clamp(0, nnz - 1)]
        else:
            pos = torch.zeros(num_samples, dtype=torch.int32, device=dev)
    if neg_alias is not None:
        cand = neg_alias.sample(generator, (num_samples, neg_candidates))
    else:
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
