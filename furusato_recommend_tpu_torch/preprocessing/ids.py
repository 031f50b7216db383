"""Entity ids with the initialize / update protocol (port of the JAX package's
``preprocessing/ids.py``, on ``Frame`` in place of pandas).

- ``ProductIDInfo``: raw product ids to experiment ids (``cf_product``). A row
  takes the id of an earlier row of the same name, or of the same
  ``parent_product_id``; otherwise it opens a new id, unless the Levenshtein
  ratio with the previous row's name is >= 0.9 and the prices differ by at
  most 1000 yen, when it takes the latest id (the reference's sequential
  dedup). A parent id counts only where the column holds floats (pandas reads
  ``parent_product_id`` as float64 only when it has a blank), as in the JAX
  package. Its documented Deviation carries over: the first row of an
  ``update`` batch goes through the name / parent lookup instead of taking
  the latest id unconditionally.
- ``CustomerIDInfo``: customers to ``cf_customer`` in row order.
- ``TransactionInfo``: the append-only transaction table.
- ``birth_year`` / ``TimeProcessing``: birth dates to an age in [0, 100] at
  the year 2023.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional

import numpy as np

from .frame import Frame, _is_nan, map_values
from .native import lev_ratio

__all__ = ["ProductIDInfo", "CustomerIDInfo", "TransactionInfo", "birth_year", "TimeProcessing"]


class ProductIDInfo:
    """Product id -> experiment id (cf_product) dedup with incremental update."""

    def __init__(self, product_basic_info_df: Frame):
        self._basic_info_df: Optional[Frame] = None
        self._productname_remap: Dict = {}
        self._parentid_remap: Dict = {}
        self._remapped_ids: np.ndarray = np.empty(0, np.int64)
        self._new_basic_info_df: Optional[Frame] = None
        self._new_remapped_ids: np.ndarray = np.empty(0, np.int64)
        self._previous_max_id = 0
        self.initialize(product_basic_info_df)

    @property
    def n_product(self) -> int:
        return int(self._remapped_ids.max()) + 1

    @property
    def basic_info(self) -> Frame:
        return self._basic_info_df

    @property
    def max_remapped_id(self) -> int:
        return 0 if len(self._remapped_ids) == 0 else int(self._remapped_ids.max())

    @property
    def previous_max_id(self) -> int:
        """The largest id before the last ``update``."""
        return self._previous_max_id

    @property
    def experiment_df(self) -> Frame:
        """One row per id, its last raw row, in row order, with ``cf_product``."""
        df = self._basic_info_df.copy()
        assert len(df) == len(self._remapped_ids)
        df["cf_product"] = self._remapped_ids
        return df.drop_duplicates("cf_product")

    @property
    def productid_converter(self) -> Dict:
        assert len(self._remapped_ids) == len(self._basic_info_df)
        return dict(zip(self._basic_info_df["product_id"].tolist(), self._remapped_ids.tolist()))

    def convert_product_id(self, product_id) -> Optional[int]:
        return self.productid_converter.get(product_id)

    def convert_df(self, df: Frame) -> Frame:
        df["cf_product"] = map_values(df["product_id"], self.productid_converter)
        return df

    def get_new_experiment_df(self, unseen: bool = False) -> Frame:
        """The experiment rows of the ids the last batch touched, by id."""
        exp = self.experiment_df
        out = exp.iloc(_rows_of(exp["cf_product"], np.unique(self._new_remapped_ids)))
        if unseen:
            return out.iloc(out["cf_product"] > self._previous_max_id)
        return out

    def initialize(self, basic_info: Frame) -> None:
        assert self.max_remapped_id == 0
        remapped, self._productname_remap, self._parentid_remap = self._assign_ids(
            basic_info, self._productname_remap, self._parentid_remap, 0
        )
        self._basic_info_df = basic_info
        self._remapped_ids = remapped
        self._new_basic_info_df = basic_info
        self._new_remapped_ids = remapped

    def update(self, new_product_info_df: Frame) -> None:
        assert len(self._remapped_ids) > 0
        max_id = self.max_remapped_id
        new_ids, self._productname_remap, self._parentid_remap = self._assign_ids(
            new_product_info_df, self._productname_remap, self._parentid_remap, max_id
        )
        self._previous_max_id = max_id
        self._basic_info_df = Frame.concat([self._basic_info_df, new_product_info_df])
        self._remapped_ids = np.concatenate([self._remapped_ids, new_ids])
        self._new_basic_info_df = new_product_info_df
        self._new_remapped_ids = new_ids

    @staticmethod
    def _assign_ids(df: Frame, name_remap: Dict, parent_remap: Dict, max_id: int):
        """The sequential dedup (see the module): each row joins an id through
        its name or parent, else opens a new one unless it is similar to the
        previous row."""
        names = df["name"]
        prices = df["minimum_donation_price"]
        parents = df["parent_product_id"]
        n = len(names)
        ids = np.zeros(n, dtype=np.int64)
        if n == 0:
            return ids, name_remap, parent_remap
        fresh_table = not name_remap and not parent_remap

        def has_parent(ppi) -> bool:
            return isinstance(ppi, float) and not _is_nan(ppi)

        def assign(i, prev_name, prev_price):
            nonlocal max_id
            name, price, ppi = names[i], prices[i], parents[i]
            if name in name_remap:
                return name_remap[name]
            similar = (
                prev_name is not None
                and lev_ratio(str(prev_name), str(name)) >= 0.9
                and abs(prev_price - price) <= 1000
            )
            if has_parent(ppi):
                if ppi in parent_remap:
                    return parent_remap[ppi]
                if not similar:
                    max_id += 1
                parent_remap[ppi] = max_id
                return max_id
            if not similar:
                max_id += 1
            name_remap[name] = max_id
            return max_id

        if fresh_table:  # initialize(): the first row anchors id 0
            ids[0] = max_id
            name_remap[names[0]] = max_id
            if has_parent(parents[0]):
                parent_remap[parents[0]] = max_id
        else:
            ids[0] = assign(0, None, None)
        for i in range(1, n):
            ids[i] = assign(i, names[i - 1], prices[i - 1])
        return ids, name_remap, parent_remap


def _rows_of(ids: np.ndarray, wanted: np.ndarray) -> np.ndarray:
    """Positions in ``ids`` (unique values) of each of ``wanted``, in its order."""
    order = np.argsort(ids, kind="stable")
    return order[np.searchsorted(ids, wanted, sorter=order)]


def birth_year(birth) -> Optional[int]:
    """'%m/%d/%Y %H:%M:%S AM' (or PM) -> the year; None when missing."""
    if _is_nan(birth):
        return None
    if "AM" in birth:
        return datetime.datetime.strptime(birth, "%m/%d/%Y %H:%M:%S AM").year
    if "PM" in birth:
        return datetime.datetime.strptime(birth, "%m/%d/%Y %H:%M:%S PM").year
    return None


class TimeProcessing:
    """birth date -> age in [0, 100] (the year 2023, as the reference)."""

    def __init__(self, customer_df: Frame):
        self._customer_df = customer_df

    def transform(self) -> Frame:
        df = self._customer_df
        years = [birth_year(b) for b in df["birth_year"]]
        if any(y is None for y in years):  # pandas: a None makes the column float64
            col = np.array([np.nan if y is None else float(y) for y in years], dtype=np.float64)
        else:
            col = np.array(years, dtype=np.int64)
        df["birth_year"] = col
        df["age"] = np.clip(2023 - col, 0, 100)
        return df


class CustomerIDInfo:
    """Customers -> cf_customer (1:1, append-only)."""

    def __init__(self, customer_basic_info_df: Frame):
        self._customer_ids = customer_basic_info_df["customer_id"]

    def update(self, new_customer_basic_info_df: Frame) -> None:
        self._customer_ids = np.concatenate(
            [self._customer_ids, new_customer_basic_info_df["customer_id"]]
        )

    @property
    def n_customer(self) -> int:
        return len(self._customer_ids)

    def convert_df(self, customer_df: Frame) -> Frame:
        customer_df["cf_customer"] = np.arange(len(customer_df))
        return customer_df


class TransactionInfo:
    """The append-only transaction table."""

    def __init__(self, transaction_df: Frame):
        self._transaction_df = transaction_df

    def update(self, new_transaction_df: Frame) -> None:
        self._transaction_df = Frame.concat([self._transaction_df, new_transaction_df])

    @property
    def n_transaction(self) -> int:
        return len(self._transaction_df)

    @property
    def df(self) -> Frame:
        return self._transaction_df
