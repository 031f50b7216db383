"""Host-side weights of the weighted BPR recipes (port of
``sampling/weights.py``, numpy, the same arithmetic):

- ``capped_positive_edge_weights``: the ddp recipe's per-positive-item cap
  ``positive_num_limit``, as an expected-count cap on uniform-user /
  uniform-positive edge weights, found by waterfilling;
- ``popularity_positive_edge_weights``: ``--sample_pow``'s popularity tilt
  within each user's positives;
- ``load_sample_prob`` / ``sample_prob_edge_weights``: the reference's
  precomputed ``sample_prob_*.pkl`` per-user distributions, as edge weights;
- ``popularity_negative_weights``: ``item_occurrence ** negative_pow``.

Edge weights are in the ``user_pos`` CSR edge order, the alias sampler's.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..data.dataset import Dataset
from ..ops.alias import AliasTable, build_alias_table

__all__ = [
    "popularity_positive_edge_weights",
    "capped_positive_edge_weights",
    "popularity_negative_weights",
    "edge_alias_from_weights",
    "negative_alias",
    "load_sample_prob",
    "sample_prob_edge_weights",
]


def _edge_order(dataset: Dataset) -> np.ndarray:
    """The train edges in ``user_pos`` CSR order (rows, then items)."""
    return np.lexsort((dataset.train_item, dataset.train_user))


def popularity_positive_edge_weights(dataset: Dataset, sample_pow: float) -> np.ndarray:
    """Edge weight (1 / deg_u) * pop_i ** sample_pow: a uniform user, then an
    item tilted by popularity within the user's positives."""
    order = _edge_order(dataset)
    u = dataset.train_user[order]
    i = dataset.train_item[order]
    deg_u = np.bincount(dataset.train_user, minlength=dataset.n_users).astype(np.float64)
    pop = dataset.item_occurrence().astype(np.float64)
    return (1.0 / np.maximum(deg_u[u], 1.0)) * np.maximum(pop[i], 1.0) ** sample_pow


def capped_positive_edge_weights(
    dataset: Dataset, num_draws: int, positive_num_limit: int
) -> np.ndarray:
    """Uniform-user / uniform-positive weights with each item's expected
    draws over ``num_draws`` capped at ``positive_num_limit``."""
    order = _edge_order(dataset)
    u = dataset.train_user[order]
    i = dataset.train_item[order]
    deg_u = np.bincount(dataset.train_user, minlength=dataset.n_users).astype(np.float64)
    w0 = 1.0 / np.maximum(deg_u[u], 1.0)
    # expected draws of item i: num_draws * sum_{edges of i} w_e / sum(all w).
    # Capping is a fixed point: scaling violators down raises everyone else's
    # share, so iterate to convergence (waterfilling).
    s = np.ones(dataset.m_items)
    for _ in range(100):
        w = w0 * s[i]
        exp_item = np.zeros(dataset.m_items)
        np.add.at(exp_item, i, w)
        exp_item *= num_draws / w.sum()
        viol = exp_item > positive_num_limit * 1.001
        if not viol.any():
            break
        s *= np.where(
            exp_item > positive_num_limit,
            positive_num_limit / np.maximum(exp_item, 1e-12),
            1.0,
        )
    return w0 * s[i]


def load_sample_prob(data_path: str, sample_pow: float):
    """The reference's ``sample_prob/sample_prob_{01,02,05,10}.pkl`` for
    sample_pow 0.1 / 0.2 / 0.5 / 1.0 (per-user probability arrays over each
    user's positives, in train-file order), or None when no file matches."""
    names = {0.1: "01", 0.2: "02", 0.5: "05", 1.0: "10"}
    key = next((v for k, v in names.items() if abs(sample_pow - k) < 1e-9), None)
    if key is None:
        return None
    p = Path(data_path) / "sample_prob" / f"sample_prob_{key}.pkl"
    if not p.exists():
        return None
    # the reference's own artifact, which only pickle holds
    with open(p, "rb") as f:
        return pickle.load(f)


def sample_prob_edge_weights(dataset: Dataset, probs) -> np.ndarray:
    """``probs[u]`` (a distribution over user u's positives in train-file
    order; a list or a dict) as weights over the train edges in CSR order;
    the user marginal stays uniform."""
    n = dataset.n_users
    deg = np.bincount(dataset.train_user, minlength=n)

    def _prob_row(u):
        if isinstance(probs, dict):
            return np.asarray(probs.get(u, ()), np.float64)
        return np.asarray(probs[u], np.float64) if u < len(probs) else np.empty(0)

    rows = [_prob_row(u) for u in range(n)]
    lens = np.fromiter((len(r) for r in rows), np.int64, count=n)
    if not np.array_equal(lens, deg):
        bad = int(np.nonzero(lens != deg)[0][0])
        raise ValueError(
            f"sample_prob row for user {bad} has {lens[bad]} entries, "
            f"user has {deg[bad]} positives"
        )
    # the concatenated rows are the edges in train-file order per user;
    # reorder to the CSR order the alias sampler indexes
    w_ap = np.concatenate(rows) if n else np.empty(0)
    order_ap = np.argsort(dataset.train_user, kind="stable")
    w_by_edge = np.empty(len(order_ap), np.float64)
    w_by_edge[order_ap] = w_ap
    return w_by_edge[_edge_order(dataset)]


def popularity_negative_weights(dataset: Dataset, negative_pow: float) -> np.ndarray:
    pop = dataset.item_occurrence().astype(np.float64)
    return np.maximum(pop, 1.0) ** negative_pow


def edge_alias_from_weights(weights: np.ndarray) -> AliasTable:
    return build_alias_table(weights)


def negative_alias(dataset: Dataset, negative_pow: float) -> AliasTable:
    return build_alias_table(popularity_negative_weights(dataset, negative_pow))
