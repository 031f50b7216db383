"""Ranking and beyond-accuracy metrics on the device (port of ``eval/metrics.py``).

- recall / precision / hr / ndcg (binary relevance) / mrr @K as per-batch sums
  over users; the evaluator divides by the number of test users;
- diversity@K: mean pairwise Jaccard distance of the category sets in a top-K;
- novelty@K: -log2 popularity, normalised by -log2(1 / n_users);
- AUC by the rank-sum formula over the unmasked items;
- unexpectedness: mean PMI between a user's train items and the recommended
  ones, with the PMI matrix built from train co-occurrence.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.graph import CSR
from ..ops.csr_search import csr_contains

__all__ = [
    "batch_metric_sums",
    "batch_auc_sum",
    "pmi_from_cooccurrence",
    "unexpectedness_from_pmi",
]


def _hit_matrix(
    test_pos: CSR, users: torch.Tensor, topk_ids: torch.Tensor, max_test_degree=None
) -> torch.Tensor:
    """r[b, k] = 1 if topk_ids[b, k] is a test positive of users[b]."""
    return csr_contains(
        test_pos, users[:, None], topk_ids, max_row_len=max_test_degree
    ).float()


def batch_metric_sums(
    topk_ids: torch.Tensor,  # [B, Kmax] int
    users: torch.Tensor,  # [B] int
    valid: torch.Tensor,  # [B] bool (padding rows excluded)
    test_pos: CSR,
    topks: Sequence[int],
    item_categories: Optional[torch.Tensor] = None,  # [M, C] int, -1 padded
    item_popularity: Optional[torch.Tensor] = None,  # [M] float, occurrences / n_users
    n_users_norm: Optional[float] = None,
    max_test_degree: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Per-batch metric sums over users, one entry per k in topks, plus
    'count' (the number of valid users)."""
    users = users.long()
    r = _hit_matrix(test_pos, users, topk_ids, max_test_degree)
    w = valid.float()
    r = r * w[:, None]
    test_deg = (test_pos.indptr[users + 1] - test_pos.indptr[users]).float()
    dev = r.device

    out: Dict[str, torch.Tensor] = {}
    recalls, precisions, hrs, ndcgs, mrrs, divs, novs = [], [], [], [], [], [], []
    for k in topks:
        rk = r[:, :k]
        right = torch.sum(rk, dim=1)
        recalls.append(torch.sum(right / (test_deg + 1e-6) * w))
        precisions.append(torch.sum(right) / k)
        hrs.append(torch.sum((right >= 1).float() * w))
        discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32, device=dev))
        dcg = torch.sum(rk * discounts[None, :], dim=1)
        ideal_len = torch.clamp(test_deg, max=float(k))
        cum = torch.cat([torch.zeros(1, device=dev), torch.cumsum(discounts, 0)])
        idcg = cum[ideal_len.long().clamp(0, k)]
        idcg = torch.where(idcg == 0.0, torch.ones_like(idcg), idcg)
        ndcgs.append(torch.sum(dcg / idcg * w))
        # reciprocal rank of the first hit (argmax gives the first maximum)
        first_hit = torch.argmax(rk, dim=1)
        has_hit = torch.any(rk > 0, dim=1)
        rr = torch.where(has_hit, 1.0 / (first_hit + 1.0), torch.zeros_like(w))
        mrrs.append(torch.sum(rr * w))
        if item_categories is not None:
            divs.append(_diversity_sum(topk_ids[:, :k], item_categories, w))
        if item_popularity is not None and n_users_norm is not None:
            pop = torch.clamp_min(item_popularity[topk_ids[:, :k]], 1e-12)
            per_user = torch.sum(-torch.log2(pop), dim=1) / k
            novs.append(torch.sum(per_user * w) / (-np.log2(1.0 / n_users_norm)))

    out["recall"] = torch.stack(recalls)
    out["precision"] = torch.stack(precisions)
    out["hr"] = torch.stack(hrs)
    out["ndcg"] = torch.stack(ndcgs)
    out["mrr"] = torch.stack(mrrs)
    if divs:
        out["diversity"] = torch.stack(divs)
    if novs:
        out["novelty"] = torch.stack(novs)
    out["count"] = torch.sum(w)
    return out


def _diversity_sum(topk: torch.Tensor, cats: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum over users of the mean pairwise Jaccard distance between the
    category sets of the recommended items. cats: [M, C] category ids per
    item, -1 padded, unique within a row."""
    k = topk.shape[1]
    c = cats[topk]  # [B, k, C]
    present = c >= 0
    sizes = torch.sum(present, dim=-1).float()  # [B, k]
    eq = (c[:, :, None, :, None] == c[:, None, :, None, :]) & (
        present[:, :, None, :, None] & present[:, None, :, None, :]
    )  # [B, k, k, C, C]
    inter = torch.sum(eq, dim=(-1, -2)).float()  # [B, k, k]
    union = sizes[:, :, None] + sizes[:, None, :] - inter
    dist = 1.0 - inter / (union + 1e-6)
    iu = torch.triu_indices(k, k, 1, device=topk.device)
    pair_sum = torch.sum(dist[:, iu[0], iu[1]], dim=1)  # [B]
    denom = k * (k - 1) // 2
    return torch.sum(pair_sum / denom * w)


def batch_auc_sum(
    scores: torch.Tensor,  # [B, M], train positives masked to the sentinel
    users: torch.Tensor,
    valid: torch.Tensor,
    test_pos: CSR,
    mask_sentinel: float,
) -> torch.Tensor:
    """Sum over valid users of the AUC over unmasked items with the test items
    as positives: (R_pos - n_pos (n_pos + 1) / 2) / (n_pos n_neg), R_pos the
    sum of the positives' 1-based ranks by ascending score."""
    b, m = scores.shape
    items = torch.arange(m, device=scores.device)
    is_pos = csr_contains(test_pos, users.long()[:, None], items[None, :])
    unmasked = scores > mask_sentinel + 1.0
    order = torch.argsort(scores, dim=1, stable=True)
    pos_sorted = torch.gather(is_pos & unmasked, 1, order)
    un_sorted = torch.gather(unmasked, 1, order)
    ranks = torch.cumsum(un_sorted.float(), dim=1)
    r_pos = torch.sum(torch.where(pos_sorted, ranks, torch.zeros_like(ranks)), dim=1)
    n_pos = torch.sum(pos_sorted, dim=1).float()
    n_all = torch.sum(un_sorted, dim=1).float()
    n_neg = n_all - n_pos
    auc = (r_pos - n_pos * (n_pos + 1) / 2) / torch.clamp_min(n_pos * n_neg, 1.0)
    ok = valid & (n_pos > 0) & (n_neg > 0)
    return torch.sum(torch.where(ok, auc, torch.zeros_like(auc)))


def pmi_from_cooccurrence(
    train_user: np.ndarray, train_item: np.ndarray, m_items: int
) -> np.ndarray:
    """[M, M] float32 pointwise mutual information between items from their
    co-occurrence in users' train baskets: log(p(i, j) / (p(i) p(j))), 0
    where they never co-occur. Host-side, O(M^2) memory: for offline analysis."""
    n_users = int(train_user.max()) + 1 if len(train_user) else 1
    idx = torch.from_numpy(np.stack([np.asarray(train_user), np.asarray(train_item)]).astype(np.int64))
    basket = torch.sparse_coo_tensor(
        idx, torch.ones(idx.shape[1], dtype=torch.float64), (n_users, m_items)
    ).coalesce()
    basket = torch.sparse_coo_tensor(
        basket.indices(), torch.ones_like(basket.values()), basket.shape
    )  # binary baskets
    co = torch.sparse.mm(basket.t(), basket).to_dense().numpy()  # [M, M] counts
    p_i = np.maximum(co.diagonal(), 1e-12) / n_users
    p_ij = co / n_users
    with np.errstate(divide="ignore"):
        pmi = np.log(np.maximum(p_ij, 1e-12) / (p_i[:, None] * p_i[None, :]))
    pmi[p_ij == 0] = 0.0
    return pmi.astype(np.float32)


def unexpectedness_from_pmi(graph, users: np.ndarray, topk: np.ndarray, pmi: np.ndarray) -> float:
    """Mean over users (with train items) of the mean PMI between the user's
    train items and their recommendations."""
    indptr = graph.user_pos.indptr.cpu().numpy()
    indices = graph.user_pos.indices.cpu().numpy()
    total = 0.0
    cnt = 0
    for row, u in enumerate(users):
        hist = indices[indptr[u] : indptr[u + 1]]
        if len(hist) == 0:
            continue
        total += float(np.mean(pmi[np.ix_(hist, topk[row])]))
        cnt += 1
    return total / max(cnt, 1)
