"""Per-user item sequences of the SASRec sequence model (port of
``data/sequence.py``).

A user's sequence is its train items in the order of the training data (a
stable sort by user), or by time when per-edge timestamps are given, cut to
the last ``max_len`` items and held as one 0-padded [n_users, max_len] int32
tensor with the lengths beside it. ``load_sequence_artifacts`` reads the
reference's precomputed ``train_items_sequence{sfx}.pkl`` (a list indexed by
user, or a {user: items} dict) and ``train_sequence_length{sfx}.pt`` into the
same layout; both give arrays bit-equal to the JAX package's.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .dataset import Dataset

__all__ = ["MAX_SEQ_LEN", "UserSequences", "build_sequences", "load_sequence_artifacts"]

MAX_SEQ_LEN = 50


@dataclass(frozen=True)
class UserSequences:
    items: torch.Tensor  # [n_users, max_len] int32, 0-padded, the last items kept
    lengths: torch.Tensor  # [n_users] int32, at most max_len
    max_len: int = MAX_SEQ_LEN

    def to(self, device) -> "UserSequences":
        return UserSequences(self.items.to(device), self.lengths.to(device), self.max_len)


def _padded(seqs, n_users: int, max_len: int):
    """Ragged sequences -> ([n_users, max_len] int32 holding each one's last
    max_len items, 0-padded; [n_users] int32 lengths); users beyond the list
    get empty rows."""
    out = np.zeros((n_users, max_len), np.int32)
    lengths = np.zeros(n_users, np.int32)
    for u in range(min(n_users, len(seqs))):
        row = seqs[u][-max_len:]
        out[u, : len(row)] = row
        lengths[u] = len(row)
    return out, lengths


def build_sequences(
    dataset: Dataset, max_len: int = MAX_SEQ_LEN, timestamps: Optional[np.ndarray] = None
) -> UserSequences:
    """Each user's train items in the order of the training data, or by
    ``timestamps`` (one per train edge, in the dataset's edge order) when
    given, as ``UserSequences``."""
    u = np.asarray(dataset.train_user)
    i = np.asarray(dataset.train_item)
    if timestamps is not None:
        order = np.lexsort((np.asarray(timestamps), u))
    else:
        order = np.argsort(u, kind="stable")
    u_s, i_s = u[order], i[order]
    bounds = np.searchsorted(u_s, np.arange(dataset.n_users + 1))
    seqs = [i_s[bounds[k] : bounds[k + 1]] for k in range(dataset.n_users)]
    items, lengths = _padded(seqs, dataset.n_users, max_len)
    return UserSequences(torch.from_numpy(items), torch.from_numpy(lengths), max_len)


def load_sequence_artifacts(
    data_path, suffix: str = "", n_users: Optional[int] = None, max_len: int = MAX_SEQ_LEN
) -> UserSequences:
    """``{data_path}/train_items_sequence{suffix}.pkl`` (a list of item
    sequences indexed by user, or a {user: sequence} dict; absent users get
    empty ones) as ``UserSequences`` of ``n_users`` rows (default: the
    artifact's), each sequence's last ``max_len`` items kept. Where
    ``train_sequence_length{suffix}.pt`` exists, its lengths win, clamped at
    ``max_len``."""
    base = Path(data_path)
    with open(base / f"train_items_sequence{suffix}.pkl", "rb") as f:
        train_items = pickle.load(f)  # the reference's own artifact
    lengths_path = base / f"train_sequence_length{suffix}.pt"
    lengths_raw = (
        np.asarray(torch.load(lengths_path, map_location="cpu")) if lengths_path.exists() else None
    )
    if isinstance(train_items, dict):
        n = (max(train_items) + 1) if train_items else 0
        seqs = [np.asarray(train_items.get(u, ()), np.int64) for u in range(n)]
    else:
        seqs = [np.asarray(s, np.int64) for s in train_items]
    if n_users is None:
        n_users = len(seqs)
    items, lengths = _padded(seqs, n_users, max_len)
    if lengths_raw is not None:
        k = min(n_users, len(lengths_raw))
        lengths[:k] = np.minimum(lengths_raw[:k], max_len).astype(np.int32)
    return UserSequences(torch.from_numpy(items), torch.from_numpy(lengths), max_len)
