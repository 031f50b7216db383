"""Interaction graph as sorted index tensors (port of ``data/graph.py``).

- ``CSR``: ``indptr`` + flat ``indices``, indices sorted ascending within each
  row, so membership is a binary search (``ops/csr_search.py``) and the
  serving kernel's train-positive mask a search per scored item.
- ``COOEdges``: the symmetric-normalised joint-space edge list, sorted by
  destination, which ``ops/segment.py::spmm`` turns into a CSR sparse matrix.

Host construction is numpy, in exactly the JAX package's order
(``np.lexsort`` / stable ``argsort``), so every integer array is equal to the
reference's. ``pos_hash`` is the cuckoo membership set over the train pairs
(``ops/cuckoo.py``), the sampler's negative-rejection test. The degree-bucketed
padded adjacencies and the relational message graphs of the JAX
``BipartiteGraph`` are not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.cuckoo import CuckooSet, build_cuckoo_set

__all__ = ["CSR", "COOEdges", "BipartiteGraph", "build_bipartite_graph"]


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
    max_user_degree: int = 0
    max_test_degree: int = 0

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


def build_bipartite_graph(
    train_user: np.ndarray,
    train_item: np.ndarray,
    test_user: np.ndarray,
    test_item: np.ndarray,
    n_users: int,
    m_items: int,
) -> BipartiteGraph:
    """The graph of a dataset's COO interaction arrays, as CPU tensors.

    The joint-space weights are the symmetric normalisation
    ``1 / sqrt(deg(src) * deg(dst))`` computed in float64 and stored float32,
    destination-sorted with a stable sort, as in the JAX package.
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
    )
