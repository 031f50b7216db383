"""Seeded raw tables in the reference's shape, for ``tools preprocess`` (the
port's counterpart of the JAX package's ``tests/test_full_chain.py``
frames, at any size).

``synthetic_raw_tables`` returns plain numpy columns of six tables:
products, customers, transactions, partner, category and reviews.

- Product names and comments mix Japanese (kana and kanji) and Latin text,
  so the tokenizer's CJK bigrams and Latin words both run; comments and
  ``parent_product_id`` have blanks (so pandas reads the parent column as
  float64, which the dedup's parent rule needs).
- Of the product rows, ``n_products - n_unique`` are planted duplicates, one
  third of each kind the dedup merges: the same name as an earlier product
  (one with no parent); the same ``parent_product_id`` as an earlier one;
  a name at Levenshtein ratio >= 0.9 (the product's name and one more
  character) right after its product, the price within 1000 yen. Every
  other row's price differs from its previous row's by more than 1000 yen,
  so it opens an id: the rows dedup to exactly ``n_unique`` ids. The first
  row of an incremental batch has no previous row to compare with, so no
  near-name duplicate sits at the cut of ``SPLIT_FRACS`` (one with the same
  name, or parent, stands there instead).
- Birth dates in the reference's ``'%m/%d/%Y %H:%M:%S AM'`` form, some blank.
- Transactions draw product rows by a Zipf popularity; each customer buys
  at least 4 distinct products, and some purchases repeat.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from .frame import Frame, write_csv

__all__ = ["RawTables", "synthetic_raw_tables"]

MIN_ITEMS, MAX_ITEMS = 4, 14  # distinct products a customer buys
ZIPF_ALPHA = 1.0  # the products' popularity
REPEAT_SHARE = 0.03  # purchases bought again
# the incremental fractions whose first batch row must not be a near-name
# duplicate (the tests' and tools preprocess' default)
SPLIT_FRACS = (0.1, 0.2)

PREFS = (
    "北海道", "青森県", "岩手県", "宮城県", "秋田県", "山形県", "福島県", "茨城県", "栃木県", "群馬県",
    "埼玉県", "千葉県", "東京都", "神奈川県", "新潟県", "富山県", "石川県", "福井県", "山梨県", "長野県",
    "岐阜県", "静岡県", "愛知県", "三重県", "滋賀県", "京都府", "大阪府", "兵庫県", "奈良県", "和歌山県",
    "鳥取県", "島根県", "岡山県", "広島県", "山口県", "徳島県", "香川県", "愛媛県", "高知県", "福岡県",
    "佐賀県", "長崎県", "熊本県", "大分県", "宮崎県", "鹿児島県", "沖縄県",
)
FOODS = (
    "いくら", "牛肉", "豚肉", "鶏肉", "ほたて", "かに", "うなぎ", "米", "りんご", "みかん",
    "メロン", "ぶどう", "さくらんぼ", "日本酒", "ビール", "ワイン", "チーズ", "はちみつ", "お茶", "うどん",
    "そば", "ハム", "餃子", "干物", "のり", "しらす", "えび", "まぐろ", "鮭", "桃",
)
LATIN = ("premium", "gift", "set", "wagyu", "organic", "fresh", "frozen", "limited", "family", "deluxe",
         "mini", "large")
UNITS = ("1kg", "500g", "2kg", "3本", "6個", "12個", "詰め合わせ", "定期便")
ADJS = ("新鮮な", "人気の", "甘い", "濃厚な", "やわらかい", "大粒の", "贅沢な", "定番の")
CATEGORY_STEMS = ("肉", "魚介", "果物", "野菜", "米・パン", "酒", "菓子", "加工品", "工芸品", "旅行")
CITY_SUFFIX = ("市", "町", "村")


@dataclass
class RawTables:
    """Six tables of numpy columns and the number of products they hold."""

    tables: Dict[str, Dict[str, np.ndarray]]
    n_unique_products: int

    def frames(self) -> Dict[str, Frame]:
        return {name: Frame(cols) for name, cols in self.tables.items()}

    def write_csv(self, directory) -> Dict[str, str]:
        """Each table as ``<name>.csv`` under ``directory``; returns {name: path}."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        paths = {}
        for name, frame in self.frames().items():
            paths[name] = str(d / f"{name}.csv")
            write_csv(frame, paths[name])
        return paths


def _strings(values) -> np.ndarray:
    values = list(values)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _blank(col: np.ndarray, rng: np.random.Generator, share: float) -> np.ndarray:
    out = col.copy()
    out[rng.random(len(col)) < share] = np.nan
    return out


def _pick(rng, options: Sequence[str], n: int) -> list:
    return [options[i] for i in rng.integers(0, len(options), n)]


def synthetic_raw_tables(
    seed: int = 0,
    n_customers: int = 20_000,
    n_products: int = 12_000,
    n_unique: int = 10_000,
    n_partners: int = 1741,
    n_categories: int = 40,
    n_reviews: int = 20_000,
) -> RawTables:
    """Seeded raw tables (see the module): ``n_products`` product rows of
    ``n_unique`` products, each customer ``MIN_ITEMS`` to ``MAX_ITEMS``
    distinct products (about 180,000 transactions at the defaults)."""
    if not 0 < n_unique <= n_products:
        raise ValueError(f"need 0 < n_unique <= n_products, got {n_unique}, {n_products}")
    rng = np.random.default_rng(seed)

    # -- partners: the municipality offices
    partner_pref = _pick(rng, PREFS, n_partners)
    partner = {
        "partner_id": np.arange(1, n_partners + 1, dtype=np.int64),
        "head_office_pref": _strings(partner_pref),
        "head_office_addr01": _blank(_strings(
            f"{p}第{k}{CITY_SUFFIX[k % 3]}" for k, p in enumerate(partner_pref)), rng, 0.01),
    }

    # -- products: the unique ones, then the planted duplicates
    U, n_dup = n_unique, n_products - n_unique
    base_parent = np.where(rng.random(U) < 0.3, 900_000.0 + np.arange(U), np.nan)
    base_parent[0] = np.nan
    base_name = [
        f"{PREFS[rng.integers(47)]}産 {FOODS[rng.integers(30)]}{UNITS[rng.integers(8)]} "
        f"{LATIN[rng.integers(12)]} No.{b}" for b in range(U)
    ]
    base_price = 1000 * rng.integers(5, 60, U)
    kinds = rng.integers(0, 3, n_dup)  # 0: same name, 1: same parent, 2: near name
    with_parent = np.nonzero(~np.isnan(base_parent))[0]
    without_parent = np.nonzero(np.isnan(base_parent))[0]
    kinds[(kinds == 1) & (len(with_parent) == 0)] = 0
    target = np.where(kinds == 1, with_parent[rng.integers(0, max(len(with_parent), 1), n_dup)],
                      without_parent[rng.integers(0, len(without_parent), n_dup)])
    near = kinds == 2  # any product may have a near-name duplicate, one at most
    near_targets = rng.choice(U, size=int(near.sum()), replace=False)
    target[near] = near_targets
    # order: product b at key 3b, its near-name duplicate at 3b + 1, a
    # same-name / same-parent duplicate after some later product at 3j + 2
    later = target + (rng.random(n_dup) * (U - target)).astype(np.int64)
    keys = np.concatenate([3 * np.arange(U), np.where(near, 3 * target + 1, 3 * later + 2)])
    order = np.argsort(keys, kind="stable")
    row_base = np.concatenate([np.arange(U), target])[order]
    row_kind = np.concatenate([np.full(U, -1), kinds])[order]  # -1: the product itself
    for frac in SPLIT_FRACS:  # the first row of an incremental batch
        cut = max(1, int(n_products * (1.0 - frac)))
        if cut < n_products and row_kind[cut] == 2:
            row_kind[cut] = 1 if not np.isnan(base_parent[row_base[cut]]) else 0

    names, prices, parents = [], np.empty(n_products, np.int64), np.empty(n_products)
    reissue = 0
    for r, (b, kind) in enumerate(zip(row_base.tolist(), row_kind.tolist())):
        prev = prices[r - 1] if r else None
        if kind == -1:
            price = base_price[b]
            if prev is not None and abs(price - prev) <= 1000:
                price = prev + 2000
            base_price[b] = price
            names.append(base_name[b])
            parents[r] = base_parent[b]
        elif kind == 0:
            price = 1000 * rng.integers(5, 60)
            names.append(base_name[b])
            parents[r] = np.nan
        elif kind == 1:
            price = 1000 * rng.integers(5, 60)
            reissue += 1
            names.append(f"{base_name[b]} 再販{reissue}")
            parents[r] = base_parent[b]
        else:
            price = base_price[b] + 1000 * rng.integers(-1, 2)
            names.append(base_name[b] + "★")
            parents[r] = np.nan
        prices[r] = price
    food = _pick(rng, FOODS, n_products)
    products = {
        "product_id": 100_000 + np.arange(n_products, dtype=np.int64),
        "name": _strings(names),
        "minimum_donation_price": prices,
        "parent_product_id": parents,
        "partner_id": rng.integers(1, n_partners + 1, n_products),
        "main_comment": _blank(_strings(
            f"{p}の{a}{f}です。{w} quality の{g}を{u}でお届けします"
            for p, a, f, w, g, u in zip(_pick(rng, PREFS, n_products), _pick(rng, ADJS, n_products), food,
                                        _pick(rng, LATIN, n_products), _pick(rng, FOODS, n_products),
                                        _pick(rng, UNITS, n_products))), rng, 0.1),
        "main_list_comment": _blank(_strings(
            f"{a}{f} {w}" for a, f, w in zip(_pick(rng, ADJS, n_products), food, _pick(rng, LATIN, n_products))),
            rng, 0.3),
    }

    # -- customers
    years = rng.integers(1930, 2005, n_customers)
    customers = {
        "customer_id": _strings(f"C{i:07d}" for i in rng.permutation(10 * n_customers)[:n_customers]),
        "sex": _blank(_strings(_pick(rng, ("男性", "女性"), n_customers)), rng, 0.02),
        "pref": _blank(_strings(_pick(rng, PREFS, n_customers)), rng, 0.02),
        "birth_year": _blank(_strings(
            f"{m:02d}/{d:02d}/{y} 00:00:00 AM" for m, d, y in zip(
                rng.integers(1, 13, n_customers), rng.integers(1, 29, n_customers), years)), rng, 0.02),
    }

    # -- transactions: distinct products per customer by a Zipf popularity
    weight = 1.0 / np.arange(1, n_products + 1) ** ZIPF_ALPHA
    cdf = np.cumsum(weight[rng.permutation(n_products)])
    cdf /= cdf[-1]
    k = rng.integers(MIN_ITEMS, MAX_ITEMS + 1, n_customers)
    width = 4 * MAX_ITEMS
    draws = np.minimum(np.searchsorted(cdf, rng.random((n_customers, width))), n_products - 1)
    tx_c, tx_p = [], []
    for c in range(n_customers):
        row = list(dict.fromkeys(draws[c].tolist()))[: k[c]]
        while len(row) < k[c]:  # a popularity so skewed that the draws ran short
            extra = int(rng.integers(n_products))
            if extra not in row:
                row.append(extra)
        tx_c.extend([c] * len(row))
        tx_p.extend(row)
    tx_c, tx_p = np.asarray(tx_c), np.asarray(tx_p)
    again = rng.choice(len(tx_c), size=int(REPEAT_SHARE * len(tx_c)), replace=False)
    tx_c, tx_p = np.concatenate([tx_c, tx_c[again]]), np.concatenate([tx_p, tx_p[again]])
    shuffle = rng.permutation(len(tx_c))  # purchases in time order, not by customer
    transactions = {
        "customer_id": customers["customer_id"][tx_c[shuffle]],
        "product_id": products["product_id"][tx_p[shuffle]],
    }

    # -- category: one or two categories a product row, a few unknown products
    cat_names = [f"{CATEGORY_STEMS[j % 10]}{j // 10 + 1}" for j in range(n_categories)]
    per_row = rng.integers(1, 3, n_products)
    cat_rows = np.repeat(np.arange(n_products), per_row)
    cat_pid = products["product_id"][cat_rows]
    n_unknown = max(1, n_products // 100)
    category = {
        "product_id": np.concatenate([cat_pid, 10 * n_products + 100_000 + np.arange(n_unknown)]),
        "category_id": _strings(_pick(rng, cat_names, len(cat_rows) + n_unknown)),
    }

    # -- reviews of popular rows
    rev_rows = np.minimum(np.searchsorted(cdf, rng.random(n_reviews)), n_products - 1)
    reviews = {
        "product_id": products["product_id"][rev_rows],
        "recommend_level": rng.integers(1, 6, n_reviews),
        "comment": _blank(_strings(
            f"{a}{f}でした。{w} {g}!" for a, f, w, g in zip(
                _pick(rng, ADJS, n_reviews), _pick(rng, FOODS, n_reviews), _pick(rng, LATIN, n_reviews),
                _pick(rng, ("good", "great", "また買います", "リピート", "ok"), n_reviews))), rng, 0.05),
    }
    tables = {"products": products, "customers": customers, "transactions": transactions,
              "partner": partner, "category": category, "reviews": reviews}
    return RawTables(tables=tables, n_unique_products=U)
