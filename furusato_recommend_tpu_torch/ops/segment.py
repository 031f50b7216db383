"""Graph propagation operator y = A x and its gradient (port of
``ops/segment.py::spmm`` and of the transpose VJP of ``ops/padded_adj.py``).

The JAX package computes it outside any Pallas kernel: a gather plus a
destination-sorted segment sum, or on its default path the degree-bucketed
padded layout of ``ops/padded_adj.py``. Here it is one ``torch.sparse.mm`` on a
CSR matrix whose rows are the destinations.

- ``csr_layout`` sorts an edge list into CSR order once; ``Adjacency`` holds
  that order and makes matrices from per-edge weights without sorting again,
  so a model builds it once per graph and edge dropout only rewrites values.
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
from typing import Optional

import torch

from ..data.graph import COOEdges

__all__ = ["Adjacency", "csr_layout", "spmm"]


@dataclass(frozen=True)
class _Layout:
    crow: torch.Tensor  # [num_rows + 1] int32
    col: torch.Tensor  # [E] int32, ascending within each row
    order: torch.Tensor  # [E] int64: CSR position -> edge index
    num_nodes: int

    def matrix(self, weight: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        w = weight[self.order].to(compute_dtype).float()
        return torch.sparse_csr_tensor(
            self.crow, self.col, w, size=(self.num_nodes, self.num_nodes),
            check_invariants=False,
        )


def csr_layout(rows: torch.Tensor, cols: torch.Tensor, num_nodes: int) -> _Layout:
    """CSR structure of the edges (rows[e], cols[e]): rows sorted, columns
    sorted within each row, duplicates kept as separate entries."""
    rows, cols = rows.long(), cols.long()
    order = torch.argsort(rows * num_nodes + cols, stable=True)
    counts = torch.bincount(rows, minlength=num_nodes)
    crow = torch.zeros(num_nodes + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(counts, 0)
    return _Layout(crow.to(torch.int32), cols[order].to(torch.int32), order, num_nodes)


class Adjacency:
    """A = weight at (dst, src) over ``num_nodes`` joint nodes, with its
    transpose layout when A is not symmetric."""

    def __init__(self, edges: COOEdges, num_nodes: int, symmetric: bool):
        self.fwd = csr_layout(edges.dst, edges.src, num_nodes)
        self.bwd = None if symmetric else csr_layout(edges.src, edges.dst, num_nodes)

    def matrices(self, weight: torch.Tensor, compute_dtype: torch.dtype):
        """(A, A^T) with the per-edge ``weight`` (edge order) rounded to
        ``compute_dtype``; A^T is A itself when A is symmetric."""
        a = self.fwd.matrix(weight, compute_dtype)
        return a, (a if self.bwd is None else self.bwd.matrix(weight, compute_dtype))


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
