"""Item-sharded full-catalog top-k with a distributed merge (port of
``eval/sharded.py``).

The catalog is row-sharded over the mesh's ``model`` axis (padded to a
multiple of S rows) and the users of a tile over ``data``. Each model rank

1. scores its item block and takes its top k through the ``masked_topk``
   kernel (its plain version on the CPU): the train positives that fall in
   the block, and the block's rows past ``m_valid``, are a per-rank CSR in
   local ids (``local_mask``, built once), so they score exactly -1024 as on
   one card;
2. adds the block's offset to its ids and exchanges its [B, k] candidates
   over the model group;
3. merges the [B, S k] union back to k by the port's order, value
   descending then global id ascending: a stable descending sort of the
   union laid out in shard order, since each shard's list is already in that
   order and a lower shard holds lower ids.

A shard with fewer than k items returns all of them; the union then still
holds the global top k (k <= the padded catalog), so the answer is the
single-card one. (JAX takes ``lax.top_k`` per shard; the port takes its
kernel.)

``sharded_masked_topk`` is the two halves around the exchange:
``local_topk`` (steps 1 and 2's offset: device work alone) and
``merge_topk`` (step 3). The mesh's evaluation runs the local half for every
tile, exchanges every tile's candidates in one collective, then merges every
tile (``eval/evaluate.py``), so that both halves can be captured as CUDA
graphs with the exchange run eagerly between them (``eval/graphed.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.mesh import MODEL_AXIS, Mesh
from ..data.graph import CSR
from ..ops.streaming_topk import masked_topk

__all__ = ["sharded_masked_topk", "local_topk", "merge_topk", "local_mask", "item_block"]


def _block_rows(m: int, shards: int) -> int:
    return -(-m // shards)


def item_block(item_emb: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's rows of the [M, d] catalog padded with zero rows to
    S x ceil(M / S)."""
    per = _block_rows(item_emb.shape[0], mesh.model)
    lo = mesh.index(MODEL_AXIS) * per
    block = item_emb[lo : lo + per]
    if block.shape[0] < per:
        block = torch.cat([block, block.new_zeros((per - block.shape[0], block.shape[1]))])
    return block.contiguous()


def local_mask(pos: CSR, m: int, mesh: Mesh, m_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indptr [N + 1], indices) int32: each user's train positives in this
    model rank's block of a catalog of ``m`` rows, in local ids, followed by
    the block's rows at or past ``m_valid`` (padding). Built once; the
    positives' boolean selection waits for the device."""
    per = _block_rows(m, mesh.model)
    lo = mesh.index(MODEL_AXIS) * per
    indptr, indices = pos.indptr.long(), pos.indices.long()
    n = indptr.shape[0] - 1
    dev = indices.device
    keep = (indices >= lo) & (indices < lo + per)
    row = torch.repeat_interleave(torch.arange(n, device=dev), indptr[1:] - indptr[:-1])
    pad = torch.arange(min(max(m_valid, lo), lo + per), lo + per, device=dev) - lo  # the padding's local ids
    counts = torch.bincount(row[keep], minlength=n) + pad.numel()
    rows = torch.cat([row[keep], torch.arange(n, device=dev).repeat_interleave(pad.numel())])
    cols = torch.cat([indices[keep] - lo, pad.repeat(n)])
    order = torch.argsort(rows * (per + 1) + cols)  # each row's positives, then its padding, sorted
    new_ptr = torch.zeros(n + 1, dtype=torch.long, device=dev)
    new_ptr[1:] = torch.cumsum(counts, 0)
    return new_ptr.to(torch.int32), cols[order].to(torch.int32)


def local_topk(
    user_emb: torch.Tensor,
    item_block_emb: torch.Tensor,
    users: torch.Tensor,
    k: int,
    mask: Tuple[torch.Tensor, torch.Tensor],
    mesh: Mesh,
    sigmoid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local half: (values float32 [B, kl], global item ids int64 [B,
    kl]) of ``users`` over this model rank's block, kl = min(k, block rows),
    through one ``masked_topk`` launch; no collective."""
    per = item_block_emb.shape[0]
    if not 1 <= k <= per * mesh.model:
        raise ValueError(f"k={k} must be in [1, {per * mesh.model}] (the padded catalog)")
    v, i = masked_topk(user_emb, item_block_emb, users, min(k, per), *mask, sigmoid=sigmoid)
    return v, i + mesh.index(MODEL_AXIS) * per


def merge_topk(vg: torch.Tensor, ig: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge half: (values [B, k], ids [B, k]) from every model rank's
    candidates [S, B, kl] (values, global ids) in shard order, by value
    descending then global id ascending (a stable sort of the union)."""
    b = vg.shape[1]
    v_all = vg.permute(1, 0, 2).reshape(b, -1)  # [B, S kl], shard order
    i_all = ig.permute(1, 0, 2).reshape(b, -1)
    mv, order = torch.sort(v_all, dim=1, descending=True, stable=True)
    return mv[:, :k].contiguous(), torch.gather(i_all, 1, order[:, :k])


def sharded_masked_topk(
    user_emb: torch.Tensor,
    item_block_emb: torch.Tensor,
    users: torch.Tensor,
    k: int,
    mask: Tuple[torch.Tensor, torch.Tensor],
    mesh: Mesh,
    sigmoid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values float32 [B, k], global item ids int64 [B, k]) of this data
    rank's ``users`` (rows of ``user_emb`` [N, d]) over the whole catalog,
    equal on every model rank.

    item_block_emb: this model rank's block of the padded catalog
    (``item_block``); mask: its local CSR (``local_mask``); the catalog
    rows past ``m_valid`` score -1024 through it. k <= S x block rows."""
    v, i = local_topk(user_emb, item_block_emb, users, k, mask, mesh, sigmoid)
    return merge_topk(mesh.all_gather(v, MODEL_AXIS), mesh.all_gather(i, MODEL_AXIS), k)
