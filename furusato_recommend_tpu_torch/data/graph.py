"""Interaction graph as sorted index tensors (port of ``data/graph.py``).

- ``CSR``: ``indptr`` + flat ``indices``, indices sorted ascending within each
  row, so membership is a binary search (``ops/csr_search.py``) and the
  serving kernel's train-positive mask a search per scored item.
- ``COOEdges``: the symmetric-normalised joint-space edge list, sorted by
  destination, which ``ops/segment.py::spmm`` turns into a CSR sparse matrix.

Host construction is numpy, in exactly the JAX package's order
(``np.lexsort`` / stable ``argsort``), so every integer array is equal to the
reference's. ``pos_hash`` is the cuckoo membership set over the train pairs
(``ops/cuckoo.py``), the sampler's negative-rejection test.

The message graph: ``build_bipartite_graph(extra_edges=)`` (and
``build_relational_graph``, which also labels each message edge with its
relation) adds CSRs over the train edges plus extra relation edge sets
(``msg_user_pos``, ``msg_item_pos``, ``msg_item_edge_perm``). Propagation,
fanout trees and the edge features read the ``prop_*`` accessors: the
message CSRs when present, else the train CSRs. The BPR sampler
(``pos_hash``, ``user_pos_row``) and the evaluation's mask stay on the train
edges.

The SAGE family's mean aggregation (the JAX ``user_agg`` / ``item_agg``) is
``mean_aggregation(side)``: one CSR matrix per direction with weights
1 / deg over the message edges, and its transpose for the backward, both
read straight from ``prop_user_pos`` / ``prop_item_pos`` and made once per
graph. The degree-bucketed, hub-dense padded layouts of the JAX package are
not carried over.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.cuckoo import CuckooSet, build_cuckoo_set
from ..ops.segment import SparsePair, sorted_layout

__all__ = ["CSR", "COOEdges", "BipartiteGraph", "build_bipartite_graph", "build_relational_graph"]


@dataclass(frozen=True)
class CSR:
    """indptr [num_rows + 1] int32; indices [nnz] int32, sorted within rows."""

    indptr: torch.Tensor
    indices: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def to(self, device) -> "CSR":
        return CSR(self.indptr.to(device), self.indices.to(device))


@dataclass(frozen=True)
class COOEdges:
    """Destination-sorted weighted edges over one node id space.

    src, dst: [E] int32, sorted by dst ascending; weight: [E] float32."""

    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]

    def to(self, device) -> "COOEdges":
        return COOEdges(self.src.to(device), self.dst.to(device), self.weight.to(device))


@dataclass(frozen=True)
class BipartiteGraph:
    """Users are nodes ``[0, n_users)`` of the joint space, items
    ``[n_users, n_users + m_items)``."""

    n_users: int
    m_items: int
    user_pos: CSR  # user -> item ids in [0, m_items)
    item_pos: CSR  # its transpose
    test_pos: CSR  # test interactions, user -> item
    norm_edges: COOEdges  # D^-1/2 A D^-1/2 over the joint space, dst-sorted
    #: permutation taking per-edge arrays from user_pos order to item_pos order
    item_edge_perm: Optional[torch.Tensor] = None
    #: [nnz] user id of each user_pos entry
    user_pos_row: Optional[torch.Tensor] = None
    #: cuckoo membership set over the train (user, item) pairs
    pos_hash: Optional[CuckooSet] = None
    #: the message graph when it differs from the train edges (rsage: purchase
    #: + favourite + review edges); None: propagation uses user_pos / item_pos
    msg_user_pos: Optional[CSR] = None
    msg_item_pos: Optional[CSR] = None
    msg_item_edge_perm: Optional[torch.Tensor] = None
    max_user_degree: int = 0
    max_test_degree: int = 0

    def __post_init__(self):
        # mean-aggregation operators, made on first use (a new graph, from
        # dataclasses.replace or .to, starts without them)
        object.__setattr__(self, "_agg", {})

    # -- propagation accessors: the message CSRs when present, else the train CSRs --
    @property
    def prop_user_pos(self) -> CSR:
        return self.user_pos if self.msg_user_pos is None else self.msg_user_pos

    @property
    def prop_item_pos(self) -> CSR:
        return self.item_pos if self.msg_item_pos is None else self.msg_item_pos

    @property
    def prop_item_edge_perm(self) -> Optional[torch.Tensor]:
        return self.item_edge_perm if self.msg_item_edge_perm is None else self.msg_item_edge_perm

    def mean_aggregation(self, side: str) -> SparsePair:
        """The mean over each ``side`` node's neighbours as a sparse operator:
        A [n_side, n_other] with weight 1 / deg(row) on each message edge (0
        rows for nodes without one), and A^T, both CSR matrices read from
        ``prop_user_pos`` / ``prop_item_pos`` without sorting
        (``prop_item_edge_perm`` maps the item CSR's entries to the edges).
        Made once per graph."""
        if side not in self._agg:
            from ..ops.csr_search import csr_row_ids

            up, ip = self.prop_user_pos, self.prop_item_pos
            e = up.nnz
            user_order = torch.arange(e, device=up.indptr.device)
            item_order = self.prop_item_edge_perm.long()
            if side == "user":
                deg, row_of_edge = up.degrees(), csr_row_ids(up).long()
            elif side == "item":
                deg, row_of_edge = ip.degrees(), up.indices.long()
            else:
                raise ValueError(f"side must be 'user' or 'item', got {side!r}")
            # 1 / deg in float64, stored float32, as the JAX package's weights
            weight = (1.0 / deg.double().clamp_min(1.0))[row_of_edge].float()
            users = sorted_layout(up.indptr, up.indices, user_order, self.m_items)
            items = sorted_layout(ip.indptr, ip.indices, item_order, self.n_users)
            fwd, bwd = (users, items) if side == "user" else (items, users)
            self._agg[side] = SparsePair(fwd, bwd, weight)
        return self._agg[side]

    @property
    def num_nodes(self) -> int:
        return self.n_users + self.m_items

    @property
    def train_size(self) -> int:
        return self.user_pos.nnz

    def user_degrees(self) -> torch.Tensor:
        return self.user_pos.degrees()

    def item_degrees(self) -> torch.Tensor:
        return self.item_pos.degrees()

    def to(self, device) -> "BipartiteGraph":
        def move(x):
            return None if x is None else x.to(device)

        return dataclasses.replace(
            self,
            user_pos=self.user_pos.to(device),
            item_pos=self.item_pos.to(device),
            test_pos=self.test_pos.to(device),
            norm_edges=self.norm_edges.to(device),
            item_edge_perm=move(self.item_edge_perm),
            user_pos_row=move(self.user_pos_row),
            pos_hash=move(self.pos_hash),
            msg_user_pos=move(self.msg_user_pos),
            msg_item_pos=move(self.msg_item_pos),
            msg_item_edge_perm=move(self.msg_item_edge_perm),
        )


def _csr_from_coo(rows: np.ndarray, cols: np.ndarray, num_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """(indptr, row-sorted indices) from COO pairs; duplicates are kept."""
    order = np.lexsort((cols, rows))
    rows_s = rows[order]
    cols_s = cols[order].astype(np.int32)
    counts = np.bincount(rows_s, minlength=num_rows)
    indptr = np.zeros(num_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return indptr, cols_s


def _message_edges(train_user, train_item, extra_edges) -> tuple[np.ndarray, np.ndarray]:
    """(users, items) of the message edges: the train edges, then each extra
    set, in that order."""
    users = np.concatenate([np.asarray(train_user, np.int64)] + [np.asarray(u, np.int64) for u, _ in extra_edges])
    items = np.concatenate([np.asarray(train_item, np.int64)] + [np.asarray(i, np.int64) for _, i in extra_edges])
    return users, items


def build_bipartite_graph(
    train_user: np.ndarray,
    train_item: np.ndarray,
    test_user: np.ndarray,
    test_item: np.ndarray,
    n_users: int,
    m_items: int,
    extra_edges=None,
) -> BipartiteGraph:
    """The graph of a dataset's COO interaction arrays, as CPU tensors.

    The joint-space weights are the symmetric normalisation
    ``1 / sqrt(deg(src) * deg(dst))`` computed in float64 and stored float32,
    destination-sorted with a stable sort, as in the JAX package.
    ``extra_edges``: [(users, items), ...], extra relation edge sets; the
    message CSRs are then built over the train edges followed by each set,
    in that order.
    """
    train_user = np.asarray(train_user, dtype=np.int64)
    train_item = np.asarray(train_item, dtype=np.int64)
    test_user = np.asarray(test_user, dtype=np.int64)
    test_item = np.asarray(test_item, dtype=np.int64)

    up_indptr, up_indices = _csr_from_coo(train_user, train_item, n_users)
    ip_indptr, ip_indices = _csr_from_coo(train_item, train_user, m_items)
    tp_indptr, tp_indices = _csr_from_coo(test_user, test_item, n_users)

    order_u = np.lexsort((train_item, train_user))
    order_i = np.lexsort((train_user, train_item))
    inv_order_u = np.empty(len(order_u), np.int64)
    inv_order_u[order_u] = np.arange(len(order_u))
    item_edge_perm = inv_order_u[order_i].astype(np.int32)

    src = np.concatenate([train_user, train_item + n_users]).astype(np.int64)
    dst = np.concatenate([train_item + n_users, train_user]).astype(np.int64)
    deg = np.bincount(
        np.concatenate([train_user, train_item + n_users]), minlength=n_users + m_items
    ).astype(np.float64)
    d_inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 0.0)
    weight = (d_inv_sqrt[src] * d_inv_sqrt[dst]).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    src, dst, weight = src[order], dst[order], weight[order]

    t = torch.from_numpy
    msg = {}
    if extra_edges:
        msg_user, msg_item = _message_edges(train_user, train_item, extra_edges)
        mu_indptr, mu_indices = _csr_from_coo(msg_user, msg_item, n_users)
        mi_indptr, mi_indices = _csr_from_coo(msg_item, msg_user, m_items)
        m_order_u = np.lexsort((msg_item, msg_user))
        m_order_i = np.lexsort((msg_user, msg_item))
        m_inv_u = np.empty(len(m_order_u), np.int64)
        m_inv_u[m_order_u] = np.arange(len(m_order_u))
        msg = dict(
            msg_user_pos=CSR(t(mu_indptr), t(mu_indices)),
            msg_item_pos=CSR(t(mi_indptr), t(mi_indices)),
            msg_item_edge_perm=t(m_inv_u[m_order_i].astype(np.int32)),
        )
    return BipartiteGraph(
        n_users=int(n_users),
        m_items=int(m_items),
        user_pos=CSR(t(up_indptr), t(up_indices)),
        item_pos=CSR(t(ip_indptr), t(ip_indices)),
        test_pos=CSR(t(tp_indptr), t(tp_indices)),
        norm_edges=COOEdges(
            t(src.astype(np.int32)), t(dst.astype(np.int32)), t(weight)
        ),
        item_edge_perm=t(item_edge_perm),
        pos_hash=build_cuckoo_set(train_user, train_item),
        user_pos_row=t(
            np.repeat(np.arange(n_users, dtype=np.int32), up_indptr[1:] - up_indptr[:-1])
        ),
        max_user_degree=int((up_indptr[1:] - up_indptr[:-1]).max(initial=0)),
        max_test_degree=int((tp_indptr[1:] - tp_indptr[:-1]).max(initial=0)),
        **msg,
    )


def build_relational_graph(dataset, relation_edges):
    """(graph, edge_label) of the multi-relational models: the message CSRs
    over the purchases plus each relation edge set of ``relation_edges``
    ([(users, items), ...]), and each message edge's label (0 a purchase, k
    the k-th extra set) as int32 in the message user-CSR edge order, which
    ``FeatureStore.edge_label`` holds."""
    graph = build_bipartite_graph(
        dataset.train_user, dataset.train_item, dataset.test_user, dataset.test_item,
        dataset.n_users, dataset.m_items, extra_edges=relation_edges,
    )
    msg_user, msg_item = _message_edges(dataset.train_user, dataset.train_item, relation_edges)
    labels = np.concatenate(
        [np.zeros(len(dataset.train_user), np.int32)]
        + [np.full(len(u), k + 1, np.int32) for k, (u, _) in enumerate(relation_edges)]
    )
    order = np.lexsort((msg_item, msg_user))  # the message user CSR's sort
    return graph, torch.from_numpy(labels[order])
