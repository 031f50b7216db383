"""Numeric (cross-purchase count) features with the increment / update
protocol (port of the JAX package's ``preprocessing/numeric.py``). A
``FeatureCounter`` counts, per entity, the classes of one column of the other
side's entities it interacted with; the output is the counts divided by the
row sum + 1e-6, as float16 (the reference's)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .frame import Frame, _is_nan, unique

__all__ = ["FeatureCounter", "CustomerNumericFeature", "ProductNumericFeature"]


class FeatureCounter:
    def __init__(self, n_entity: int, col_name: str, col: np.ndarray):
        self._counter_name = col_name
        self._counter_height = n_entity
        self._classes = unique(col)
        self._classname_to_id = {v: i for i, v in enumerate(self._classes)}
        self._counter_width = len(self._classes)
        self._codes = self._code(col)
        self._rows: List[np.ndarray] = []
        self._cols: List[np.ndarray] = []

    def _code(self, col: np.ndarray) -> np.ndarray:
        """Each value's class id, -1 where missing or unseen."""
        lookup = self._classname_to_id
        return np.fromiter((-1 if _is_nan(v) else lookup.get(v, -1) for v in col), dtype=np.int64,
                           count=len(col))

    def update(self, new_n_entity: int, new_col: np.ndarray) -> None:
        """Extend the entity count and the other side's class column."""
        self._counter_height = new_n_entity
        self._codes = np.concatenate([self._codes, self._code(new_col)])

    def increment_many(self, source_ids: np.ndarray, target_ids: np.ndarray) -> None:
        s = np.asarray(source_ids, np.int64)
        t = np.asarray(target_ids, np.int64)
        ok = (s < self._counter_height) & (t < len(self._codes))
        s, t = s[ok], t[ok]
        cls = self._codes[t]
        has = cls >= 0
        self._rows.append(s[has])
        self._cols.append(cls[has])

    def get_result_numpy(self) -> np.ndarray:
        """The counts [height, width] divided by their row sums + 1e-6."""
        rows = np.concatenate(self._rows) if self._rows else np.empty(0, np.int64)
        cols = np.concatenate(self._cols) if self._cols else np.empty(0, np.int64)
        counts = np.zeros((self._counter_height, self._counter_width), dtype=np.float64)
        np.add.at(counts, (rows, cols), 1.0)
        inv = 1.0 / (counts.sum(axis=1) + 1e-6)
        return inv[:, None] * counts


class _NumericFeature:
    def __init__(self, n_entity: int, other_unique_df: Frame, col_names: List[str], src_key: str, dst_key: str):
        self._n_entity = n_entity
        self._col_names = col_names
        self._src_key = src_key
        self._dst_key = dst_key
        self._feature_counters: Dict[str, FeatureCounter] = {
            c: FeatureCounter(n_entity, c, other_unique_df[c]) for c in col_names
        }

    def increment(self, transaction_data: Frame) -> None:
        s = transaction_data[self._src_key]
        t = transaction_data[self._dst_key]
        for c in self._col_names:
            self._feature_counters[c].increment_many(s, t)

    def initialize(self, transaction_data_orig: Frame) -> None:
        self.increment(transaction_data_orig)

    def update_counter(self, transaction_data_new: Frame) -> None:
        self.increment(transaction_data_new)

    def update_info(self, new_n_entity: int, new_other_unique_df: Frame) -> None:
        for c in self._col_names:
            self._feature_counters[c].update(new_n_entity, new_other_unique_df[c])

    def get_feature(self) -> np.ndarray:
        return np.concatenate(
            [fc.get_result_numpy().astype(np.float16) for fc in self._feature_counters.values()], axis=1
        )


class CustomerNumericFeature(_NumericFeature):
    """Per customer: counts over the product attribute classes."""

    def __init__(self, n_customer: int, product_unique_df: Frame, col_names: List[str]):
        super().__init__(n_customer, product_unique_df, col_names, src_key="cf_customer", dst_key="cf_product")


class ProductNumericFeature(_NumericFeature):
    """Per product: counts over the customer attribute classes."""

    def __init__(self, n_product: int, customer_unique_df: Frame, col_names: List[str]):
        super().__init__(n_product, customer_unique_df, col_names, src_key="cf_product", dst_key="cf_customer")
