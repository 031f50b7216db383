"""Graph propagation operator y = A x (port of ``ops/segment.py::spmm``).

The JAX package computes it outside any Pallas kernel: a gather plus a
destination-sorted segment sum, or on its default path the degree-bucketed
padded layout of ``ops/padded_adj.py``. Here it is one ``torch.sparse.mm`` on a
CSR matrix whose rows are the destinations.

Precision follows ``padded_spmm``: x and the weights are rounded to
``compute_dtype`` and the sums accumulate in float32. The matrix stores float32
values that hold the rounded numbers, so the sparse product itself runs in
float32 on every device. The one difference left at bfloat16: the JAX package
also rounds each product w * x to bfloat16 before summing, where this exact
float32 product does not.
"""

from __future__ import annotations

import torch

from ..data.graph import COOEdges

__all__ = ["sparse_adjacency", "spmm"]


def sparse_adjacency(
    edges: COOEdges, num_nodes: int, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """[num_nodes, num_nodes] CSR matrix with A[dst, src] = weight, the weights
    rounded to ``compute_dtype`` and stored as float32; columns sorted within
    each row (duplicate edges are kept as separate entries)."""
    dst = edges.dst.long()
    src = edges.src.long()
    order = torch.argsort(dst * num_nodes + src, stable=True)
    counts = torch.bincount(dst, minlength=num_nodes)
    crow = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dst.device)
    crow[1:] = torch.cumsum(counts, 0)
    w = edges.weight[order].to(compute_dtype).float()
    return torch.sparse_csr_tensor(
        crow.to(torch.int32),
        edges.src[order].to(torch.int32),
        w,
        size=(num_nodes, num_nodes),
        check_invariants=False,
    )


def spmm(adj: torch.Tensor, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y = adj @ x with x rounded to ``compute_dtype``; float32 result."""
    return torch.sparse.mm(adj, x.to(compute_dtype).float())
