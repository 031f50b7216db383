"""Two-stage retrieval -> re-rank pipeline (port of ``rank/pipeline.py``).

The reference dumps each retriever's per-user top 50, labels the candidate
union with a held-out slice (train positives appended with label 1), fits a
grouped LambdaRank ranker on it, and re-ranks the union of the retrained
retrievers' dumps to each user's top 10.

- ``dump_candidates``: the model's own propagation, then one ``masked_topk``
  call a batch of users with the train positives masked to -1024 and no
  sigmoid (the kernel on the card, its plain version on the CPU). The JAX
  package scores with a dense product and ``lax.top_k``; the kernel computes
  the same function in the same order (value descending, id ascending), a
  routing Deviation like the evaluator's. The last batch runs at its own size
  instead of wrapping around to whole batches.
- ``build_rank_groups``, ``retriever_rank_aux`` and ``rerank_eval``: host
  numpy, as in the JAX package, line for line (every stable sort, search and
  membership test as written there); only the finished groups become tensors.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.dataset import Dataset
from ..data.graph import BipartiteGraph
from ..models.base import PairwiseModel
from ..ops.streaming_topk import MASK_SENTINEL, masked_topk
from .ranker import NeuralRanker, RankGroups

__all__ = ["MASK_SENTINEL", "build_rank_groups", "dump_candidates", "rerank_eval", "retriever_rank_aux"]


def dump_candidates(
    model: PairwiseModel,
    graph: BipartiteGraph,
    k: int = 50,
    batch: int = 1024,
    device=None,
) -> np.ndarray:
    """Per-user top-k candidates [n_users, k] int32 with the train positives
    masked, scored by raw dot products of the propagated embeddings: one
    propagation, then ``ceil(n_users / batch)`` masked_topk calls. The model
    and graph move to ``device`` (default CUDA)."""
    dev = resolve_device(device)
    model = model.to(dev)
    g = graph.to(dev)
    with torch.no_grad():
        user_emb, item_emb = model.propagate(g)
    user_emb = user_emb.detach().float().contiguous()
    item_emb = item_emb.detach().float().contiguous()
    mask = g.user_pos
    n = graph.n_users
    ids = [
        masked_topk(user_emb, item_emb, torch.arange(lo, min(lo + batch, n), device=dev), k,
                    mask.indptr, mask.indices, sigmoid=False)[1]
        for lo in range(0, n, batch)
    ]
    return torch.cat(ids).to(torch.int32).cpu().numpy()


def _dedup_rows(cand: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per-row first-occurrence dedup mask: a stable argsort groups equal
    values, duplicates after the first are invalidated; invalid slots are
    made unique so they never collide with real entries."""
    n, w = cand.shape
    keyed = np.where(valid, cand, cand.max(initial=0) + 1 + np.arange(w)[None, :])
    order = np.argsort(keyed, axis=1, kind="stable")
    svals = np.take_along_axis(keyed, order, axis=1)
    dup_sorted = np.zeros_like(svals, dtype=bool)
    dup_sorted[:, 1:] = svals[:, 1:] == svals[:, :-1]
    dup = np.empty_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    return valid & ~dup


def _compact_rows(keep: np.ndarray, *arrays, width: int):
    """Move kept entries to the front of each row (order-preserving), cut to
    ``width``. Returns (mask, compacted arrays...); arrays may carry trailing
    feature dims (the [n, W, A] aux columns)."""
    order = np.argsort(~keep, axis=1, kind="stable")[:, :width]
    kept = np.take_along_axis(keep, order, axis=1)
    outs = [
        np.take_along_axis(a, order.reshape(order.shape + (1,) * (a.ndim - 2)), axis=1)
        for a in arrays
    ]
    return kept, outs


def retriever_rank_aux(
    candidates: Sequence[np.ndarray],  # one [n_users, k] dump per retriever
    cand: np.ndarray,  # [n, W] int64 item ids to featurize
    m_items: int,
) -> np.ndarray:
    """Per-candidate retriever-signal columns [n, W, 2 * n_retrievers]: for
    each retriever, the reciprocal rank 1 / (1 + pos) in its dump (0 if
    absent) and a membership indicator."""
    n, W = cand.shape
    q = np.arange(n, dtype=np.int64)[:, None] * m_items + cand  # [n, W]
    cols = []
    for L in candidates:
        L = np.asarray(L, np.int64)
        k = L.shape[1]
        keys = (np.arange(n, dtype=np.int64)[:, None] * m_items + L).ravel()
        ranks = np.tile(np.arange(k, dtype=np.int64), n)
        sidx = np.argsort(keys, kind="stable")
        skeys, sranks = keys[sidx], ranks[sidx]
        pos = np.searchsorted(skeys, q.ravel())
        pos = np.minimum(pos, len(skeys) - 1)
        hit = skeys[pos] == q.ravel()
        rr = np.where(hit, 1.0 / (1.0 + sranks[pos]), 0.0).astype(np.float32)
        cols.append(rr.reshape(n, W))
        cols.append(hit.reshape(n, W).astype(np.float32))
    return np.stack(cols, axis=-1)


def build_rank_groups(
    dataset: Dataset,
    candidates: Sequence[np.ndarray],  # one [n_users, k] per retriever
    holdout,  # {user: held-out items} dict OR (users[np], items[np]) edge arrays
    include_train_positives: bool = True,
    max_candidates: int = 160,
    with_retriever_aux: bool = False,
) -> RankGroups:
    """Labelled per-user groups from the candidate union: candidates get
    label 0 unless they hit the held-out set; with
    ``include_train_positives`` the true train interactions are appended
    with label 1. Groups without a relevant item are dropped. CPU tensors."""
    n, m = dataset.n_users, dataset.m_items
    C = max_candidates
    cand = np.concatenate([np.asarray(c, np.int64) for c in candidates], axis=1)
    valid = np.ones_like(cand, dtype=bool)

    if include_train_positives:
        # padded per-user train positives appended after the candidate union
        deg = np.bincount(dataset.train_user, minlength=n)
        D = int(deg.max(initial=0))
        pos_pad = np.zeros((n, D), np.int64)
        pos_valid = np.arange(D)[None, :] < deg[:, None]
        order = np.argsort(dataset.train_user, kind="stable")
        cols = (np.arange(len(order)) - np.repeat(np.cumsum(deg) - deg, deg)).astype(int)
        pos_pad[dataset.train_user[order], cols] = dataset.train_item[order]
        cand = np.concatenate([cand, pos_pad], axis=1)
        valid = np.concatenate([valid, pos_valid], axis=1)

    keep = _dedup_rows(cand, valid)

    # labels: holdout membership for the candidate part (flat (u, item) keys),
    # 1.0 for the appended train positives
    k_cand = sum(c.shape[1] for c in candidates)
    labels = np.zeros_like(cand, dtype=np.float32)
    if isinstance(holdout, dict):
        hold_keys = (
            np.sort(np.concatenate([np.int64(u) * m + np.asarray(v, np.int64) for u, v in holdout.items()]))
            if holdout
            else None
        )
    else:  # (users, items) flat edge arrays
        hu, hi = holdout
        hold_keys = np.sort(np.asarray(hu, np.int64) * m + np.asarray(hi, np.int64)) if len(hu) else None
    if hold_keys is not None:
        cand_keys = np.arange(n, dtype=np.int64)[:, None] * m + cand[:, :k_cand]
        labels[:, :k_cand] = np.isin(cand_keys, hold_keys, assume_unique=False)
    if include_train_positives:
        labels[:, k_cand:] = 1.0

    arrays = [cand, labels]
    if with_retriever_aux:
        arrays.append(retriever_rank_aux(candidates, cand, m))
    kept, outs = _compact_rows(keep, *arrays, width=C)
    items, labels = outs[0], outs[1]
    labels = np.where(kept, labels, 0.0)
    # groups without any relevant item carry no pairwise signal
    rows = (labels.sum(axis=1) > 0) & kept.any(axis=1)
    t = torch.from_numpy
    return RankGroups(
        users=t(np.nonzero(rows)[0].astype(np.int32)),
        items=t(np.where(kept, items, 0)[rows].astype(np.int32)),
        labels=t(labels[rows].astype(np.float32)),
        mask=t(np.ascontiguousarray(kept[rows])),
        aux=t(outs[2][rows].astype(np.float32)) if with_retriever_aux else None,
    )


def rerank_eval(
    ranker: NeuralRanker,
    dataset: Dataset,
    candidates: Sequence[np.ndarray],
    eval_dict: Dict[int, np.ndarray],
    k: int = 10,
    max_candidates: int = 160,
) -> Dict[str, float]:
    """Second-stage evaluation: the deduplicated candidate union of each
    evaluated user, ranked by ``ranker`` on its device, then recall, ndcg
    and hit rate at k against ``eval_dict``. Padded slots are masked out of
    the ranking."""
    m = dataset.m_items
    users = np.asarray(sorted(eval_dict.keys()), np.int64)
    C = max_candidates
    cand = np.concatenate([np.asarray(c, np.int64)[users] for c in candidates], axis=1)
    keep = _dedup_rows(cand, np.ones_like(cand, dtype=bool))
    aux = None
    if ranker.aux_dim:
        # retriever-signal columns of the evaluated users' rows
        full = retriever_rank_aux([np.asarray(c, np.int64)[users] for c in candidates], cand, m)
        kept, (cand_mat, aux_mat) = _compact_rows(keep, cand, full, width=C)
        aux = torch.from_numpy(aux_mat.astype(np.float32))
    else:
        kept, (cand_mat,) = _compact_rows(keep, cand, width=C)
    top = ranker.rank(
        torch.from_numpy(users.astype(np.int32)),
        torch.from_numpy(np.where(kept, cand_mat, 0).astype(np.int32)),
        k=k,
        mask=torch.from_numpy(np.ascontiguousarray(kept)),
        aux=aux,
    ).cpu().numpy()  # [U, min(C, k)]; -1 where fewer than k valid candidates
    gt_lens = np.asarray([len(eval_dict[int(u)]) for u in users], np.float64)
    gt_keys = np.sort(np.concatenate([np.int64(u) * m + np.asarray(eval_dict[int(u)], np.int64) for u in users]))
    top_keys = np.where(top >= 0, users[:, None] * m + top, -1)
    hit = np.isin(top_keys, gt_keys) & (top >= 0)
    got = hit.sum(axis=1)
    # binary-gain ndcg@k (eval/metrics.py): DCG over hit ranks / ideal DCG
    disc = 1.0 / np.log2(2.0 + np.arange(k))
    dcg = (hit * disc[None, : hit.shape[1]]).sum(axis=1)
    idcg = np.cumsum(disc)[np.maximum(np.minimum(gt_lens.astype(int), k), 1) - 1]
    return {
        f"rerank_recall@{k}": float(np.mean(got / np.maximum(gt_lens, 1.0))),
        f"rerank_ndcg@{k}": float(np.mean(dcg / np.maximum(idcg, 1e-9))),
        f"rerank_hr@{k}": float(np.mean(got > 0)),
    }
