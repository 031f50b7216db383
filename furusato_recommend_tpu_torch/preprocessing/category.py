"""Category ids and the product x category membership (port of the JAX
package's ``preprocessing/category.py``). ``CategoryInfo`` codes
``category_id`` (missing and unseen on the largest code + 1);
``ProductCategoryInfo`` keeps the (product, category) pairs, each once, as a
scipy COO; ``padded_categories`` is the [n_product, C] int32 layout, -1
padded, of the Diversity metric's category sets."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp

from .categorical import OrdinalEncoder
from .frame import Frame, isna, map_values

__all__ = ["CategoryInfo", "ProductCategoryInfo", "padded_categories"]


class CategoryInfo:
    def __init__(self, product_category_df: Frame):
        self._encoder = OrdinalEncoder()
        self._max_category_num = 0
        self.initialize(product_category_df)

    @property
    def product_category_df(self) -> Frame:
        return self._category_df

    def initialize(self, category_df: Frame) -> None:
        category_df = category_df.copy()
        label = self._encoder.fit_transform(category_df["category_id"])
        max_num = int(np.nanmax(label)) + 1 if len(label) else 1
        category_df["category_id"] = np.nan_to_num(label, nan=max_num)
        self._category_df = category_df
        self._max_category_num = max_num

    def update(self, new_category_df: Frame) -> None:
        new_category_df = new_category_df.copy()
        label = self._encoder.transform(new_category_df["category_id"])
        new_category_df["category_id"] = np.nan_to_num(label, nan=self._max_category_num)
        self._category_df = Frame.concat([self._category_df, new_category_df])

    @property
    def n_categories(self) -> int:
        return self._max_category_num + 1


class ProductCategoryInfo:
    """product x category membership, each pair once."""

    def __init__(self, product_category_df: Frame, n_product: int, n_category: int):
        self._pairs = np.empty((0, 2), dtype=np.int64)
        self._n_product = n_product
        self._n_category = n_category
        self.update(product_category_df)

    def update(self, product_category_df: Frame, productid_converter: Optional[Dict] = None) -> None:
        if productid_converter is not None:
            pid = map_values(product_category_df["product_id"], productid_converter)
        else:
            pid = product_category_df["cf_product"]
        cid = product_category_df["category_id"]
        ok = ~(isna(pid) | isna(cid))
        pairs = np.stack([np.asarray(pid[ok], dtype=np.float64).astype(np.int64),
                          np.asarray(cid[ok], dtype=np.float64).astype(np.int64)], axis=1)
        self._pairs = np.unique(np.concatenate([self._pairs, pairs]), axis=0)

    @property
    def n_product(self) -> int:
        return self._n_product

    @property
    def coo(self) -> sp.coo_matrix:
        p, c = self._pairs[:, 0], self._pairs[:, 1]
        return sp.coo_matrix((np.ones(len(p)), (p, c)), shape=(self._n_product, self._n_category))

    def category_sets(self) -> Dict[int, set]:
        out: Dict[int, set] = {}
        for p, c in self._pairs.tolist():
            out.setdefault(p, set()).add(c)
        return out

    def pairs(self) -> np.ndarray:
        """[nnz, 2] (product, category) pairs, sorted."""
        return self._pairs


def padded_categories(info: ProductCategoryInfo, pad_to: Optional[int] = None) -> np.ndarray:
    """[n_product, C] int32, each row its categories ascending, -1 padded; C
    the largest set (or ``pad_to``, which cuts longer rows)."""
    p, c = info.pairs()[:, 0], info.pairs()[:, 1]
    counts = np.bincount(p, minlength=info.n_product)
    width = pad_to or (int(counts.max()) if len(p) else 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(p)) - starts[p]
    keep = slot < width
    out = np.full((info.n_product, width), -1, dtype=np.int32)
    out[p[keep], slot[keep]] = c[keep]
    return out
