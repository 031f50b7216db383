"""Categorical features: per column 1-based ordinal codes in order of first
appearance, missing and unseen values on the column's ``max_f``, each
column's block offset by the blocks before it (``max_f + 1`` each), so every
code lives in one vocabulary (port of the JAX package's
``preprocessing/categorical.py``). ``update`` pads new entity rows and codes
them with the frozen encoders."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .frame import Frame, _is_nan, unique

__all__ = ["OrdinalEncoder", "CategoricalFeature", "ProductCategoricalFeature", "CustomerCategoricalFeature"]


class OrdinalEncoder:
    """1-based codes; missing or unseen -> NaN (category_encoders'
    ``handle_missing='return_nan'``, ``handle_unknown='return_nan'``)."""

    def __init__(self):
        self.mapping: Dict = {}

    def fit_transform(self, col: np.ndarray) -> np.ndarray:
        self.mapping = {c: i + 1 for i, c in enumerate(unique(col))}
        return self.transform(col)

    def transform(self, col: np.ndarray) -> np.ndarray:
        return np.asarray(
            [self.mapping.get(v, np.nan) if not _is_nan(v) else np.nan for v in col], dtype=np.float64
        )


class CategoricalFeature:
    """Shared by both sides."""

    def __init__(self, unique_df: Frame, category_columns: List[str], id_col: str):
        self._category_columns = category_columns
        self._id_col = id_col
        self._label_encoders: Dict[str, OrdinalEncoder] = {}
        self._max_features: Dict[str, int] = {}
        self._categorical_features: Optional[np.ndarray] = None
        self.initialize(unique_df)

    def initialize(self, unique_df: Frame) -> None:
        feats = []
        offset = 0
        for col in self._category_columns:
            if col not in unique_df:
                raise KeyError(f"{col} not in the frame")
            enc = OrdinalEncoder()
            f = enc.fit_transform(unique_df[col])
            top = np.nanmax(f) if np.isfinite(f).any() else np.nan
            max_f = int(top) + 1 if np.isfinite(top) else 1
            f = np.nan_to_num(f, nan=max_f)
            f += offset
            self._max_features[col] = max_f
            self._label_encoders[col] = enc
            feats.append(f[:, None])
            offset += max_f + 1  # the missing class takes max_f inside the block
        self._categorical_features = np.concatenate(feats, axis=1).astype(np.int64)

    def update(self, new_unique_df: Frame) -> None:
        feats = self._categorical_features
        idx = np.asarray(new_unique_df[self._id_col]).astype(np.int64)
        size = int(idx.max()) + 1
        if size > feats.shape[0]:
            feats = np.pad(feats, ((0, size - feats.shape[0]), (0, 0)))
        offset = 0
        for i, col in enumerate(self._category_columns):
            f = self._label_encoders[col].transform(new_unique_df[col])
            max_f = self._max_features[col]
            f = np.nan_to_num(f, nan=max_f)
            feats[idx, i] = (f + offset).astype(np.int64)
            offset += max_f + 1
        self._categorical_features = feats

    def get_feature(self) -> np.ndarray:
        return self._categorical_features

    @property
    def vocab_size(self) -> int:
        return int(self._categorical_features.max()) + 1


class ProductCategoricalFeature(CategoricalFeature):
    def __init__(self, product_unique_df: Frame, category_columns=("head_office_pref", "head_office_addr01")):
        super().__init__(product_unique_df, list(category_columns), id_col="cf_product")


class CustomerCategoricalFeature(CategoricalFeature):
    def __init__(self, customer_unique_df: Frame, category_columns=("sex", "pref", "age")):
        super().__init__(customer_unique_df, list(category_columns), id_col="cf_customer")
