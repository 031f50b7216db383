"""Second-stage ranking inputs (port of ``rank/features.py``): the reference's
``make_X`` column contract.

Per (user, item) candidate the ranker reads
``[item_categorical, user_categorical, user_numeric[:500], item_numeric[:500]]``,
the categorical columns first: they are embedded, the numeric columns are
projected.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..data.features import FeatureStore

__all__ = ["NUMERIC_CAP", "RankFeatureSpec", "make_X_ids", "rank_feature_spec"]

NUMERIC_CAP = 500  # numeric columns a side keeps


@dataclass(frozen=True)
class RankFeatureSpec:
    n_item_cat: int
    n_user_cat: int
    n_user_num: int
    n_item_num: int
    cat_vocab: int  # shared embedding-table size covering both sides' ids


def rank_feature_spec(features: FeatureStore) -> RankFeatureSpec:
    return RankFeatureSpec(
        n_item_cat=features.item.categorical.shape[1],
        n_user_cat=features.user.categorical.shape[1],
        n_user_num=min(features.user.numeric.shape[1], NUMERIC_CAP),
        n_item_num=min(features.item.numeric.shape[1], NUMERIC_CAP),
        cat_vocab=max(features.user_cat_vocab, features.item_cat_vocab),
    )


def make_X_ids(features: FeatureStore, users, items) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ranking inputs for (user, item) pairs of any shapes that broadcast to
    [...]: (cat_ids [..., n_item_cat + n_user_cat] int32, numeric [...,
    n_user_num + n_item_num] float32), in the reference's column order, on
    the features' device."""
    dev = features.item.categorical.device
    users, items = torch.broadcast_tensors(
        torch.as_tensor(users, device=dev).long(), torch.as_tensor(items, device=dev).long()
    )
    cat = torch.cat([features.item.categorical[items], features.user.categorical[users]], dim=-1)
    num = torch.cat(
        [features.user.numeric[:, :NUMERIC_CAP][users], features.item.numeric[:, :NUMERIC_CAP][items]], dim=-1
    )
    return cat, num
