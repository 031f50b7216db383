"""Per-user result CSVs with readable names (port of ``eval/results.py``).

One row a user: the customer id, the train items, the predicted top-k and the
ground truth, each as comma-joined ids and names; used to inspect
recommendations by eye. The files are written with the standard library's
``csv`` module and are byte-equal to the JAX package's
``DataFrame.to_csv(index=False)``: the same columns in the same order, minimal
quoting (a joined list of two or more is quoted), ``\\n`` line ends, an empty
field for an empty list. The functions return the rows, a list of dicts, where
the JAX package returns a DataFrame.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.dataset import Dataset

__all__ = ["save_result", "save_user_result", "COLUMNS"]

COLUMNS = (
    "customer_id", "train_ids", "train_names", "predict_ids", "predict_names", "gt_ids", "gt_names",
)


def _join(names: Sequence) -> str:
    return ",".join(str(n) for n in names)


def _names_and_ids(dataset: Dataset, product_names, customer_ids):
    names = (
        np.asarray(product_names)
        if product_names is not None
        else np.asarray([f"item_{i}" for i in range(dataset.m_items)])
    )
    cust = np.asarray(customer_ids) if customer_ids is not None else np.arange(dataset.n_users)
    return names, cust


def _row(u: int, pred, gt, ap, names, cust) -> Dict[str, object]:
    return {
        "customer_id": cust[u],
        "train_ids": _join(ap[u]),
        "train_names": _join(names[ap[u]]),
        "predict_ids": _join(pred),
        "predict_names": _join(names[pred]),
        "gt_ids": _join(gt),
        "gt_names": _join(names[gt]),
    }


def _write(path, rows: List[Dict[str, object]]) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        w.writerow(COLUMNS)
        w.writerows([r[c] for c in COLUMNS] for r in rows)


def save_result(
    path,
    dataset: Dataset,
    topk_ids: np.ndarray,  # [n_test_users, K], rows in sorted test-user order
    product_names: Optional[np.ndarray] = None,  # [m_items] str
    customer_ids: Optional[np.ndarray] = None,  # [n_users] raw ids
    k: int = 10,
) -> List[Dict[str, object]]:
    """Write the CSV of every test user (the evaluation's top-k rows);
    returns the rows."""
    names, cust = _names_and_ids(dataset, product_names, customer_ids)
    ap = dataset.all_pos()
    td = dataset.test_dict()
    rows = [
        _row(u, np.asarray(topk_ids[row_i][:k]), td[u], ap, names, cust)
        for row_i, u in enumerate(sorted(td.keys()))
    ]
    _write(path, rows)
    return rows


def save_user_result(
    path,
    dataset: Dataset,
    users: np.ndarray,  # an explicit user batch
    topk_ids: np.ndarray,  # [len(users), >= k]
    product_names: Optional[np.ndarray] = None,
    customer_ids: Optional[np.ndarray] = None,
    k: int = 10,
) -> List[Dict[str, object]]:
    """Write the CSV of an explicit user batch (production inference): every
    user gets a row, with an empty ground truth when it has no test items;
    returns the rows."""
    names, cust = _names_and_ids(dataset, product_names, customer_ids)
    ap = dataset.all_pos()
    td = dataset.test_dict()
    empty = np.empty(0, dtype=np.int64)
    rows = [
        _row(int(u), np.asarray(topk_ids[row_i][:k]), td.get(int(u), empty), ap, names, cust)
        for row_i, u in enumerate(np.asarray(users))
    ]
    _write(path, rows)
    return rows
