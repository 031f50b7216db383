"""Vectorised fixed-depth binary search over row-sorted CSR rows (port of
``ops/csr_search.py``).

A membership query against a user's sorted positives costs ``iters`` gathers,
one per halving of the search range, for every query at once. The serving
path's plain top-k uses ``csr_gather_padded`` to mask train positives; the
CUDA kernel does the same search per scored item inside the kernel.
"""

from __future__ import annotations

import torch

from ..data.graph import CSR

__all__ = ["lower_bound", "csr_contains", "csr_gather_padded", "csr_row_ids"]

_SEARCH_ITERS = 32  # enough for nnz < 2^32


def lower_bound(
    indices: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    vals: torch.Tensor,
    iters: int = _SEARCH_ITERS,
) -> torch.Tensor:
    """First position p in [lo, hi) with indices[p] >= vals, elementwise.

    lo, hi and vals broadcast to one shape. ``iters`` must be at least
    ceil(log2(max(hi - lo) + 1)).
    """
    lo_b, hi_b, vals_b = torch.broadcast_tensors(lo, hi, vals)
    shape = lo_b.shape
    lo_c, hi_c, v = lo_b.reshape(-1), hi_b.reshape(-1), vals_b.reshape(-1)
    nnz = indices.shape[0]
    if nnz == 0:
        return lo_c.reshape(shape)
    for _ in range(max(iters, 1)):
        active = lo_c < hi_c
        mid = torch.div(lo_c + hi_c, 2, rounding_mode="floor")
        go_right = indices[mid.clamp(0, nnz - 1)] < v
        lo_c = torch.where(active & go_right, mid + 1, lo_c)
        hi_c = torch.where(active & ~go_right, mid, hi_c)
    return lo_c.reshape(shape)


def csr_contains(
    csr: CSR, rows: torch.Tensor, vals: torch.Tensor, max_row_len: int | None = None
) -> torch.Tensor:
    """Elementwise: is ``vals`` a member of row ``rows``? rows / vals broadcast.

    Pass max_row_len to bound the search depth at log2 of the longest row.
    """
    iters = _SEARCH_ITERS if max_row_len is None else max(int(max_row_len).bit_length(), 1)
    rows_b, vals_b = torch.broadcast_tensors(torch.as_tensor(rows), torch.as_tensor(vals))
    shape = rows_b.shape
    rows_f, vals_f = rows_b.reshape(-1).long(), vals_b.reshape(-1)
    lo = csr.indptr[rows_f]
    hi = csr.indptr[rows_f + 1]
    pos = lower_bound(csr.indices, lo, hi, vals_f, iters=iters)
    nnz = csr.indices.shape[0]
    if nnz == 0:
        return torch.zeros(shape, dtype=torch.bool, device=rows_b.device)
    found = csr.indices[pos.clamp(0, nnz - 1)] == vals_f
    return ((pos < hi) & found).reshape(shape)


def csr_row_ids(csr: CSR) -> torch.Tensor:
    """[nnz] int32 row of each CSR entry, ascending (sorted segment ids for
    ``ops/segment.py``), by a search of ``indptr`` on the tensors' device."""
    positions = torch.arange(csr.indices.shape[0], dtype=csr.indptr.dtype, device=csr.indptr.device)
    return (torch.searchsorted(csr.indptr, positions, right=True) - 1).to(torch.int32)


def csr_gather_padded(csr: CSR, rows: torch.Tensor, pad_to: int, fill: int = -1):
    """Each row's indices in a [*, pad_to] block with a validity mask. Rows
    longer than pad_to are truncated.

    Returns (vals [.., pad_to] int32, mask [.., pad_to] bool).
    """
    rows = torch.as_tensor(rows).long()
    nnz = csr.indices.shape[0]
    start = csr.indptr[rows]
    deg = csr.indptr[rows + 1] - start
    offs = torch.arange(pad_to, dtype=torch.int32, device=rows.device)
    idx = start[..., None] + offs
    mask = offs < deg[..., None]
    if nnz == 0:
        return torch.full(idx.shape, fill, dtype=torch.int32, device=rows.device), mask
    vals = csr.indices[idx.clamp(0, nnz - 1)]
    vals = torch.where(mask, vals, torch.full_like(vals, fill))
    return vals, mask
