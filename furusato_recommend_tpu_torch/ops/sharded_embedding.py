"""Row-sharded embedding lookup (port of ``ops/sharded_embedding.py``).

The table is row-sharded over the mesh's ``model`` axis: each model rank
holds rows [lo, lo + V / S). A lookup gathers, on every model rank, the ids
it owns from its own block, as ``table_gather``'s forward does (the other
ids read as zeros), then sums the rows over the model group. The backward puts
the cotangent of the owned ids into the rank's own rows through
``scatter_add_rows`` (the CUDA kernel on the card): the ids it does not own
go to one extra row past the block, which is dropped, so nothing is
selected on the host. Neither direction builds the whole table.

``ids`` may be the rank's data shard (``ids_data_sharded``, the default, as
in JAX): the table's gradient is then summed over the data group too, so
that every rank holds the gradient of the whole lookup, as JAX's transpose
gives it.
"""

from __future__ import annotations

import torch

from ..core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from .scatter import scatter_add_rows

__all__ = ["sharded_embedding_lookup"]


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block: torch.Tensor, ids: torch.Tensor, mesh: Mesh, data_sharded: bool) -> torch.Tensor:
        rows = block.shape[0]
        local = ids.reshape(-1).long() - mesh.index(MODEL_AXIS) * rows
        owned = (local >= 0) & (local < rows)
        vals = block.index_select(0, local.clamp(0, rows - 1))
        vals = torch.where(owned[:, None], vals, 0.0)
        ctx.save_for_backward(torch.where(owned, local, rows))  # not owned: the extra row
        ctx.rows, ctx.mesh, ctx.data_sharded, ctx.dtype = rows, mesh, data_sharded, block.dtype
        out = mesh.all_reduce(vals.contiguous(), MODEL_AXIS)
        return out.reshape(tuple(ids.shape) + (block.shape[1],))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (local,) = ctx.saved_tensors
        rows = g.reshape(-1, g.shape[-1]).to(torch.float32).contiguous()
        grad = scatter_add_rows(local, rows, ctx.rows + 1)[: ctx.rows]
        if ctx.data_sharded:
            grad = ctx.mesh.all_reduce(grad.contiguous(), DATA_AXIS)
        return grad.to(ctx.dtype), None, None, None


def sharded_embedding_lookup(
    local_table: torch.Tensor, ids: torch.Tensor, mesh: Mesh, ids_data_sharded: bool = True
) -> torch.Tensor:
    """local_table: this model rank's block of a [V, d] table row-sharded over
    ``model`` (V = S x block rows); ids: integer global ids of any shape, this
    data rank's shard when ``ids_data_sharded``. Returns the rows, ids.shape
    + (d,), equal on every model rank; differentiable with respect to the
    block."""
    return _ShardedLookup.apply(local_table, ids, mesh, ids_data_sharded)
