"""Fanout neighbour sampling on the device (port of ``sampling/neighbor.py``).

With-replacement fanout from a row-sorted CSR is one modulo draw and one
gather: r ~ randint(0, 2^30) % deg, neighbour = indices[start + r], all from a
``torch.Generator`` on the CSR's device. A zero-degree node draws position
``start`` (clipped into the CSR) and is flagged in ``has_neighbors``, so its
aggregate counts as 0. The flat CSR positions of the draws come back too, for
per-edge features.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..data.graph import CSR

__all__ = ["SampledNeighbors", "sample_neighbors", "sample_tree"]


class SampledNeighbors(NamedTuple):
    ids: torch.Tensor  # [..., F] int32 neighbour node ids
    edge_pos: torch.Tensor  # [..., F] int32 positions in csr.indices
    has_neighbors: torch.Tensor  # [...] bool, False for zero-degree nodes

    def to(self, device) -> "SampledNeighbors":
        return SampledNeighbors(*(x.to(device) for x in self))


def sample_neighbors(
    generator: torch.Generator, csr: CSR, nodes: torch.Tensor, fanout: int
) -> SampledNeighbors:
    """``fanout`` neighbours of every node of ``nodes`` (any shape), drawn with
    replacement; ``generator`` lives on the CSR's device."""
    with torch.profiler.record_function("sample_neighbors"):  # names it in a trace
        return _sample(generator, csr, nodes, fanout)


def _sample(generator, csr, nodes, fanout) -> SampledNeighbors:
    nnz = csr.nnz
    nodes_f = nodes.reshape(-1).long()
    start = csr.indptr[nodes_f]
    deg = csr.indptr[nodes_f + 1] - start
    r = torch.randint(
        0, 1 << 30, (nodes_f.shape[0], fanout), generator=generator, device=csr.indptr.device
    )
    r = r % deg.clamp_min(1)[:, None]
    pos = (start[:, None] + r).clamp(0, max(nnz - 1, 0))
    if nnz:
        ids = csr.indices[pos.reshape(-1)]
    else:
        ids = torch.zeros(pos.numel(), dtype=torch.int32, device=pos.device)
    return SampledNeighbors(
        ids=ids.reshape(nodes.shape + (fanout,)).to(torch.int32),
        edge_pos=pos.to(torch.int32).reshape(nodes.shape + (fanout,)),
        has_neighbors=(deg > 0).reshape(nodes.shape),
    )


def sample_tree(
    generator: torch.Generator, csr: CSR, seeds: torch.Tensor, fanout: int, num_layers: int
) -> List[SampledNeighbors]:
    """A k-hop fanout tree over one CSR: level l has shape seeds.shape +
    (F,) * (l + 1), the neighbours of level l - 1's nodes (the seeds are not
    a level)."""
    out: List[SampledNeighbors] = []
    frontier = seeds
    for _ in range(num_layers):
        s = sample_neighbors(generator, csr, frontier, fanout)
        out.append(s)
        frontier = s.ids
    return out
