"""Sparse propagation y = A x and its gradient (port of ``ops/segment.py::spmm``
and of the transpose VJP of ``ops/padded_adj.py``), and the segment ops
(``segment_sum``, ``segment_mean``, ``segment_max``, ``gather_segment_mean``)
with the full-graph attention aggregations built on them
(``segment_softmax``, ``segment_softmax_aggregate``, ``segment_mh_attention``).

The JAX package computes propagation outside any Pallas kernel: a gather plus a
destination-sorted segment sum, or on its default path the degree-bucketed
padded layout of ``ops/padded_adj.py``. Here it is one ``torch.sparse.mm`` on a
CSR matrix whose rows are the destinations.

- ``csr_layout`` sorts an edge list into CSR order once, for a square matrix
  over one node space (LightGCN's joint graph) or a rectangular one (bags x
  vocabulary for the SAGE family's text bags); ``_Layout.matrix`` makes a
  matrix from per-edge weights without sorting again.
- ``Adjacency`` holds the layout of A over the joint node space (and of A^T
  when A is not symmetric), so a model builds it once per graph and edge
  dropout only rewrites values. ``SparsePair`` holds a rectangular A and its
  transpose with fixed weights, and keeps the matrices it made per type.
- ``spmm`` is an ``autograd.Function``: its backward is ``A^T g`` on the
  transpose matrix (the same matrix when A is symmetric), never a transpose
  built per step.

Precision follows ``padded_spmm``: x (and, in the backward, g) and the weights
are rounded to ``compute_dtype`` and the sums accumulate in float32. The matrix
stores float32 values that hold the rounded numbers, so the sparse product
itself runs in float32 on every device. The one difference left at bfloat16:
the JAX package also rounds each product w * x to bfloat16 before summing,
where this exact float32 product does not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import torch

if TYPE_CHECKING:
    from ..data.graph import COOEdges

__all__ = [
    "Adjacency", "SparsePair", "csr_layout", "gather_segment_mean", "segment_max", "segment_mean",
    "segment_mh_attention", "segment_softmax", "segment_softmax_aggregate", "segment_sum", "sorted_layout",
    "spmm",
]


@dataclass(frozen=True)
class _Layout:
    crow: torch.Tensor  # [num_rows + 1] int32
    col: torch.Tensor  # [E] int32, ascending within each row
    order: torch.Tensor  # [E] int64: CSR position -> edge index
    shape: Tuple[int, int]

    def matrix(self, weight: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        w = weight[self.order].to(compute_dtype).float()
        return torch.sparse_csr_tensor(
            self.crow, self.col, w, size=self.shape, check_invariants=False
        )

    def to(self, device) -> "_Layout":
        return _Layout(self.crow.to(device), self.col.to(device), self.order.to(device), self.shape)


def csr_layout(
    rows: torch.Tensor, cols: torch.Tensor, num_rows: int, num_cols: Optional[int] = None
) -> _Layout:
    """CSR structure of the edges (rows[e], cols[e]) of a [num_rows, num_cols]
    matrix (square when ``num_cols`` is None): rows sorted, columns sorted
    within each row, duplicates kept as separate entries."""
    num_cols = num_rows if num_cols is None else num_cols
    rows, cols = rows.long(), cols.long()
    order = torch.argsort(rows * num_cols + cols, stable=True)
    counts = torch.bincount(rows, minlength=num_rows)
    crow = torch.zeros(num_rows + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(counts, 0)
    return _Layout(crow.to(torch.int32), cols[order].to(torch.int32), order, (num_rows, num_cols))


class Adjacency:
    """A = weight at (dst, src) over ``num_nodes`` joint nodes, with its
    transpose layout when A is not symmetric."""

    def __init__(self, edges: "COOEdges", num_nodes: int, symmetric: bool):
        self.fwd = csr_layout(edges.dst, edges.src, num_nodes)
        self.bwd = None if symmetric else csr_layout(edges.src, edges.dst, num_nodes)

    def matrices(self, weight: torch.Tensor, compute_dtype: torch.dtype):
        """(A, A^T) with the per-edge ``weight`` (edge order) rounded to
        ``compute_dtype``; A^T is A itself when A is symmetric."""
        a = self.fwd.matrix(weight, compute_dtype)
        return a, (a if self.bwd is None else self.bwd.matrix(weight, compute_dtype))


def sorted_layout(
    indptr: torch.Tensor, indices: torch.Tensor, order: torch.Tensor, num_cols: int
) -> _Layout:
    """The layout of a CSR whose columns are already sorted within rows;
    ``order`` maps its positions to the indices of the weight array."""
    return _Layout(indptr, indices, order.long(), (indptr.shape[0] - 1, num_cols))


class SparsePair:
    """A (layout ``fwd``) and A^T (layout ``bwd``) over one per-edge ``weight``
    array that stays fixed, so the matrices of each compute type are made
    once."""

    def __init__(self, fwd: _Layout, bwd: _Layout, weight: torch.Tensor):
        self.fwd, self.bwd, self.weight = fwd, bwd, weight
        self._made: Dict[torch.dtype, Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def from_edges(cls, rows, cols, weight, num_rows: int, num_cols: int) -> "SparsePair":
        """A [num_rows, num_cols] = weight at (rows[e], cols[e]), both layouts
        sorted once here."""
        return cls(
            csr_layout(rows, cols, num_rows, num_cols), csr_layout(cols, rows, num_cols, num_rows), weight
        )

    def matrices(self, compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(A, A^T) with the weights rounded to ``compute_dtype``."""
        if compute_dtype not in self._made:
            self._made[compute_dtype] = (
                self.fwd.matrix(self.weight, compute_dtype),
                self.bwd.matrix(self.weight, compute_dtype),
            )
        return self._made[compute_dtype]

    def to(self, device) -> "SparsePair":
        return SparsePair(self.fwd.to(device), self.bwd.to(device), self.weight.to(device))


class _SpMM(torch.autograd.Function):
    # the profiler ranges name the two directions for a trace's step breakdown
    @staticmethod
    def forward(ctx, x, adj, adj_t, compute_dtype):
        ctx.adj_t = adj_t
        ctx.compute_dtype = compute_dtype
        with torch.profiler.record_function("spmm_fwd"):
            return torch.sparse.mm(adj, x.to(compute_dtype).float())

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function("spmm_bwd"):
            grad = torch.sparse.mm(ctx.adj_t, g.to(ctx.compute_dtype).float())
        return grad, None, None, None


def spmm(
    adj: torch.Tensor,
    x: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    adj_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = adj @ x with x rounded to ``compute_dtype``; float32 result. Its
    gradient is ``adj_t @ g`` (``adj_t`` defaults to ``adj``: symmetric)."""
    return _SpMM.apply(x, adj, adj if adj_t is None else adj_t, compute_dtype)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of the rows of ``data`` [E, ...] per segment id; empty segments
    give 0 (``jax.ops.segment_sum``)."""
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean of the rows of ``data`` [E, ...] per segment id; empty segments
    give 0 (``ops/segment.py::segment_mean``)."""
    ids = segment_ids.long()
    s = segment_sum(data, ids, num_segments)
    # counted by a float32 segment sum of ones (exact to 2^24, then rounded as
    # bincount's integers would be): bincount reads the largest id on the
    # host, which waits for the card
    ones = torch.ones(ids.shape, dtype=torch.float32, device=data.device)
    cnt = segment_sum(ones, ids, num_segments).to(data.dtype).clamp_min(1.0)
    return s / cnt.reshape((num_segments,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Largest row of ``data`` [E, ...] per segment id, elementwise; empty
    segments give -inf (``jax.ops.segment_max`` on floats)."""
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = torch.full((num_segments,) + data.shape[1:], float("-inf"), dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, ids, data, reduce="amax", include_self=True)


def gather_segment_mean(
    x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """mean over the edges e with dst[e] = v of x[src[e]]: the SAGE mean
    aggregator as a gather and a segment mean. No path calls it (nor the
    JAX package's); it is kept beside the other segment ops and tested."""
    return segment_mean(x[src.long()], dst, num_segments)


def segment_softmax(e: torch.Tensor, rows: torch.Tensor, num_dst: int) -> torch.Tensor:
    """softmax of the edge scores e [E, ...] within each destination's edges,
    as the JAX package takes it: the segment max (0 where it is not finite)
    subtracted, the sum clamped to 1e-12. The max is detached: a shift does
    not change a softmax, so neither does its gradient."""
    e_max = segment_max(e.detach(), rows, num_dst)
    e_max = torch.where(torch.isfinite(e_max), e_max, 0.0)
    w = torch.exp(e - e_max[rows])
    denom = segment_sum(w, rows, num_dst)
    return w / denom[rows].clamp_min(1e-12)


def segment_softmax_aggregate(
    csr, scores_src: torch.Tensor, scores_dst: torch.Tensor, values: torch.Tensor, num_dst: int
) -> torch.Tensor:
    """Exact full-graph attention over a CSR's edges (destination rows,
    source columns): out[v] = sum over u in N(v) of softmax_u(leaky_relu(
    s_src[u] + s_dst[v], 0.2)) * values[u] (``--conv gat``)."""
    from .csr_search import csr_row_ids

    rows, cols = csr_row_ids(csr).long(), csr.indices.long()
    e = torch.nn.functional.leaky_relu(scores_src[cols] + scores_dst[rows], 0.2)
    alpha = segment_softmax(e, rows, num_dst)
    return segment_sum(values[cols] * alpha[:, None], rows, num_dst)


def segment_mh_attention(lp, x_self: torch.Tensor, other_x: torch.Tensor, csr, n_heads: int) -> torch.Tensor:
    """Exact full-graph multi-head dot-product attention (TransformerConv):
    per head, a softmax over each destination's edges of <q, k> / sqrt(dh),
    then the weighted sum of the sources' values; heads concatenated."""
    from .csr_search import csr_row_ids

    d = x_self.shape[-1]
    dh = d // n_heads
    num_dst = x_self.shape[0]
    rows, cols = csr_row_ids(csr).long(), csr.indices.long()
    q = (x_self @ lp["wq"]).reshape(num_dst, n_heads, dh)
    k = (other_x @ lp["wk"]).reshape(other_x.shape[0], n_heads, dh)
    v = (other_x @ lp["wv"]).reshape(other_x.shape[0], n_heads, dh)
    e = (q[rows] * k[cols]).sum(dim=-1) / dh**0.5  # [E, H]
    alpha = segment_softmax(e, rows, num_dst)
    out = segment_sum(v[cols] * alpha[..., None], rows, num_dst)  # [N, H, dh]
    return out.reshape(num_dst, d)
