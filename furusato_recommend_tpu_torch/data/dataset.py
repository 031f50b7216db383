"""Dataset ingestion (port of ``data/dataset.py``): adjacency-list text files
or COO arrays -> host arrays + a lazily built ``BipartiteGraph``.

- ``uid item1 item2 ...`` text files for the train / test splits, with the
  ``for_lgbm``, ``cold_start`` and ``test_mode`` slicing rules;
- the production inference edge set: an ``inference{suffix}.txt`` file, or
  train + test when ``suffix == "all"``;
- the reference's pickled DataFrames (``Dataset.from_reference_pickles``,
  which needs pandas);
- ``synthetic_dataset``, ``synthetic_zipf_dataset`` and
  ``synthetic_structured_dataset`` (with its ground-truth latents,
  ``structured_latents``) draw the same numpy streams as the JAX package's, so
  one seed gives bit-identical arrays in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from .graph import BipartiteGraph, build_bipartite_graph

__all__ = [
    "Dataset", "load_text_dataset", "synthetic_dataset", "synthetic_zipf_dataset",
    "structured_latents", "synthetic_structured_dataset",
]


@dataclass
class Dataset:
    """Host COO interactions; ``graph`` and ``inference_graph`` are built on
    first use, as CPU tensors."""

    n_users: int
    m_items: int
    train_user: np.ndarray  # [E] int64
    train_item: np.ndarray  # [E] int64
    test_user: np.ndarray
    test_item: np.ndarray
    #: production-inference edge set (train + test for suffix "all");
    #: None -> the train edges
    inference_user: Optional[np.ndarray] = None
    inference_item: Optional[np.ndarray] = None
    _graph: Optional[BipartiteGraph] = field(default=None, repr=False)
    _inference_graph: Optional[BipartiteGraph] = field(default=None, repr=False)

    @property
    def train_size(self) -> int:
        return int(len(self.train_user))

    @property
    def test_size(self) -> int:
        return int(len(self.test_user))

    @property
    def graph(self) -> BipartiteGraph:
        if self._graph is None:
            self._graph = build_bipartite_graph(
                self.train_user,
                self.train_item,
                self.test_user,
                self.test_item,
                self.n_users,
                self.m_items,
            )
        return self._graph

    @property
    def has_inference_edges(self) -> bool:
        return self.inference_user is not None

    @property
    def inference_graph(self) -> BipartiteGraph:
        """Propagation graph over the inference edge set (train positives stay
        the masking source); the train graph when there is none."""
        if self.inference_user is None:
            return self.graph
        if self._inference_graph is None:
            self._inference_graph = build_bipartite_graph(
                self.inference_user,
                self.inference_item,
                self.test_user,
                self.test_item,
                self.n_users,
                self.m_items,
            )
        return self._inference_graph

    @classmethod
    def from_interactions(
        cls,
        train_user,
        train_item,
        test_user,
        test_item,
        n_users: Optional[int] = None,
        m_items: Optional[int] = None,
        inference_user=None,
        inference_item=None,
    ) -> "Dataset":
        """COO-array constructor; id-space sizes default to max id + 1."""
        train_user = np.asarray(train_user, dtype=np.int64)
        train_item = np.asarray(train_item, dtype=np.int64)
        test_user = np.asarray(test_user, dtype=np.int64)
        test_item = np.asarray(test_item, dtype=np.int64)
        users = np.concatenate([train_user, test_user])
        items = np.concatenate([train_item, test_item])
        if inference_user is not None:
            inference_user = np.asarray(inference_user, dtype=np.int64)
            inference_item = np.asarray(inference_item, dtype=np.int64)
            users = np.concatenate([users, inference_user])
            items = np.concatenate([items, inference_item])
        return cls(
            n_users=int(n_users if n_users is not None else users.max() + 1),
            m_items=int(m_items if m_items is not None else items.max() + 1),
            train_user=train_user,
            train_item=train_item,
            test_user=test_user,
            test_item=test_item,
            inference_user=inference_user,
            inference_item=inference_item,
        )

    @classmethod
    def from_reference_pickles(cls, data_path: str, suffix: str = "") -> "Dataset":
        """The reference's on-disk dataset of its DDP path: five pickled
        DataFrames.

        - ``{data_path}/cb/{suffix}/product_cb{suffix}.pkl`` and
          ``customer_cb{suffix}.pkl``: entity frames, whose lengths are
          m_items and n_users;
        - ``{data_path}/{suffix}/train{suffix}.pkl`` and ``test{suffix}.pkl``:
          interaction frames with ``cf_customer`` / ``cf_product`` columns;
        - ``{data_path}/{suffix}/inference{suffix}.pkl`` when ``suffix ==
          "all"`` or the file exists: the production inference edge set.

        The per-user positives come from the train COO (``all_pos``), so the
        reference's ``allPos{suffix}.pkl`` is not read. Without the entity
        frames the id spaces are max id + 1, with a warning. Reading a pickled
        DataFrame needs pandas, which is imported here, not with the module."""
        import pandas as pd

        base = Path(data_path)
        sub = base / suffix if suffix else base

        def _edges(name):
            df = pd.read_pickle(sub / f"{name}{suffix}.pkl")
            return (
                df["cf_customer"].values.astype(np.int64),
                df["cf_product"].values.astype(np.int64),
            )

        tr_u, tr_i = _edges("train")
        te_u, te_i = _edges("test")
        inf_u = inf_i = None
        if suffix == "all" or (sub / f"inference{suffix}.pkl").exists():
            inf_u, inf_i = _edges("inference")

        n_users = m_items = None
        cb = base / "cb" / suffix if suffix else base / "cb"
        cust_p = cb / f"customer_cb{suffix}.pkl"
        prod_p = cb / f"product_cb{suffix}.pkl"
        if cust_p.exists() and prod_p.exists():
            n_users = len(pd.read_pickle(cust_p))
            m_items = len(pd.read_pickle(prod_p))
        else:
            import warnings

            warnings.warn(
                f"entity frames not found under {cb}; inferring n_users/m_items "
                "from max interaction ids (entities with no interactions will "
                "be missing from the id space)"
            )
        return cls.from_interactions(
            tr_u, tr_i, te_u, te_i,
            n_users=n_users, m_items=m_items,
            inference_user=inf_u, inference_item=inf_i,
        )

    def all_pos(self) -> List[np.ndarray]:
        """Per-user train item arrays, in train-file order."""
        order = np.argsort(self.train_user, kind="stable")
        u_sorted = self.train_user[order]
        i_sorted = self.train_item[order]
        bounds = np.searchsorted(u_sorted, np.arange(self.n_users + 1))
        return [i_sorted[bounds[u] : bounds[u + 1]] for u in range(self.n_users)]

    def item_occurrence(self) -> np.ndarray:
        """Per-item train interaction counts."""
        return np.bincount(self.train_item, minlength=self.m_items)

    def sparsity(self) -> float:
        return (self.train_size + self.test_size) / (self.n_users * self.m_items)

    def test_dict(self) -> Dict[int, np.ndarray]:
        """user -> test items, for users that have any."""
        order = np.argsort(self.test_user, kind="stable")
        u_sorted = self.test_user[order]
        i_sorted = self.test_item[order]
        bounds = np.searchsorted(u_sorted, np.arange(self.n_users + 1))
        return {
            u: i_sorted[bounds[u] : bounds[u + 1]]
            for u in range(self.n_users)
            if bounds[u + 1] > bounds[u]
        }


def _parse_adjacency(path: Path, stop_uid: Optional[int]) -> List[tuple[int, List[int]]]:
    rows: List[tuple[int, List[int]]] = []
    with open(path) as f:
        for line in f:
            line = line.strip("\n")
            if not line:
                continue
            parts = line.split(" ")
            uid = int(parts[0])
            items = [int(t) for t in parts[1:] if t != ""]
            rows.append((uid, items))
            if stop_uid is not None and uid == stop_uid:
                break
    return rows


def load_text_dataset(config: Config, path: Optional[str] = None) -> Dataset:
    """Parse ``{path}/cf/{suffix}/train{suffix}.txt`` + ``test{suffix}.txt``
    (or the flat ``{path}/cf/train{suffix}.txt`` layout).

    for_lgbm holds out ``lgbm_ratio / 0.7`` of each user's items; cold_start
    gives users with uid < 10000 only ``uid // 2000`` train items and moves the
    rest to test; test_mode stops reading at uid == 100.
    """
    base = Path(path if path is not None else config.data_path) / "cf"
    sfx = config.suffix
    train_file = base / sfx / f"train{sfx}.txt" if sfx else base / f"train{sfx}.txt"
    test_file = base / sfx / f"test{sfx}.txt" if sfx else base / f"test{sfx}.txt"
    if not train_file.exists():
        train_file = base / f"train{sfx}.txt"
        test_file = base / f"test{sfx}.txt"

    stop_uid = 100 if config.test_mode else None
    train_rows = _parse_adjacency(train_file, stop_uid)
    test_rows = _parse_adjacency(test_file, stop_uid)

    tr_u: List[int] = []
    tr_i: List[int] = []
    te_u: List[int] = []
    te_i: List[int] = []
    n_user = 0
    m_item = 0
    for uid, items in train_rows:
        if not items:
            continue
        m_item = max(m_item, max(items))
        n_user = max(n_user, uid)
        if config.for_lgbm:
            valid_len = int(len(items) * config.lgbm_ratio / 0.7)
            train_len = len(items) - valid_len
            tr_u.extend([uid] * train_len)
            tr_i.extend(items[:train_len])
        elif config.cold_start and uid < 10000:
            train_len = uid // 2000
            tr_u.extend([uid] * train_len)
            tr_i.extend(items[:train_len])
            te_u.extend([uid] * (len(items) - train_len))
            te_i.extend(items[train_len:])
        else:
            tr_u.extend([uid] * len(items))
            tr_i.extend(items)
    for uid, items in test_rows:
        if not items:
            continue
        m_item = max(m_item, max(items))
        n_user = max(n_user, uid)
        te_u.extend([uid] * len(items))
        te_i.extend(items)

    tr_u_arr = np.asarray(tr_u, dtype=np.int64)
    tr_i_arr = np.asarray(tr_i, dtype=np.int64)
    te_u_arr = np.asarray(te_u, dtype=np.int64)
    te_i_arr = np.asarray(te_i, dtype=np.int64)

    # an explicit inference{suffix}.txt wins; otherwise suffix "all" means
    # train + test
    inf_u = inf_i = None
    inf_file = train_file.parent / f"inference{sfx}.txt"
    if inf_file.exists():
        iu: List[int] = []
        ii: List[int] = []
        for uid, items in _parse_adjacency(inf_file, stop_uid):
            iu.extend([uid] * len(items))
            ii.extend(items)
        inf_u = np.asarray(iu, dtype=np.int64)
        inf_i = np.asarray(ii, dtype=np.int64)
    elif sfx == "all":
        inf_u = np.concatenate([tr_u_arr, te_u_arr])
        inf_i = np.concatenate([tr_i_arr, te_i_arr])

    return Dataset(
        n_users=n_user + 1,
        m_items=m_item + 1,
        train_user=tr_u_arr,
        train_item=tr_i_arr,
        test_user=te_u_arr,
        test_item=te_i_arr,
        inference_user=inf_u,
        inference_item=inf_i,
    )


def synthetic_dataset(
    n_users: int = 200,
    m_items: int = 300,
    avg_degree: int = 12,
    test_holdout: int = 3,
    seed: int = 0,
    popularity_alpha: float = 1.2,
) -> Dataset:
    """Deterministic synthetic bipartite dataset with a Zipf-like item
    popularity. Every user gets >= test_holdout + 2 distinct items; the last
    ``test_holdout`` go to the test split."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, m_items + 1) ** popularity_alpha
    pop = pop / pop.sum()

    tr_u, tr_i, te_u, te_i = [], [], [], []
    for u in range(n_users):
        k = int(rng.integers(test_holdout + 2, max(test_holdout + 3, 2 * avg_degree)))
        items = rng.choice(m_items, size=min(k, m_items), replace=False, p=pop)
        train_part = items[:-test_holdout]
        test_part = items[-test_holdout:]
        tr_u.extend([u] * len(train_part))
        tr_i.extend(train_part.tolist())
        te_u.extend([u] * len(test_part))
        te_i.extend(test_part.tolist())

    return Dataset(
        n_users=n_users,
        m_items=m_items,
        train_user=np.asarray(tr_u, dtype=np.int64),
        train_item=np.asarray(tr_i, dtype=np.int64),
        test_user=np.asarray(te_u, dtype=np.int64),
        test_item=np.asarray(te_i, dtype=np.int64),
    )


def synthetic_zipf_dataset(
    n_users: int,
    m_items: int,
    avg_degree: int = 12,
    test_holdout: int = 3,
    seed: int = 0,
    popularity_alpha: float = 1.2,
) -> Dataset:
    """``synthetic_dataset`` in one vectorized draw, for large graphs: every
    user draws about 1.3 x k_u Zipf items with replacement, k_u ~
    Uniform[test_holdout + 2, 2 avg_degree); its first k_u distinct items (in
    id order) are kept, the last ``test_holdout`` of them held out. A user whose
    distinct draws came up short keeps fewer."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, m_items + 1) ** popularity_alpha
    pop = pop / pop.sum()
    k_u = rng.integers(test_holdout + 2, max(test_holdout + 3, 2 * avg_degree), size=n_users)
    draw = (k_u * 1.3).astype(np.int64) + 4
    u = np.repeat(np.arange(n_users, dtype=np.int64), draw)
    i = rng.choice(m_items, size=int(draw.sum()), p=pop)
    keys = np.unique(u * m_items + i)  # sorted, distinct (user, item) pairs
    uu, ii = keys // m_items, keys % m_items
    deg = np.bincount(uu, minlength=n_users)
    starts = np.cumsum(deg) - deg
    pos = np.arange(len(uu)) - starts[uu]
    kk = np.minimum(deg, k_u)
    keep = pos < kk[uu]
    uu, ii, pos = uu[keep], ii[keep], pos[keep]
    is_test = pos >= (kk[uu] - test_holdout)
    return Dataset(
        n_users=n_users,
        m_items=m_items,
        train_user=uu[~is_test],
        train_item=ii[~is_test],
        test_user=uu[is_test],
        test_item=ii[is_test],
    )


def structured_latents(
    n_users: int,
    m_items: int,
    rank: int = 16,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
):
    """(U [n_users, rank], V [m_items, rank]) float32 standard normal: the
    ground-truth latents of ``synthetic_structured_dataset``, the first two
    draws of its stream, so ``seed`` regenerates them without the dataset.
    ``rng`` continues a stream instead (the dataset generator passes its own)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    U = rng.standard_normal((n_users, rank), dtype=np.float32)
    V = rng.standard_normal((m_items, rank), dtype=np.float32)
    return U, V


def synthetic_structured_dataset(
    n_users: int = 1000,
    m_items: int = 500,
    avg_degree: int = 10,
    test_holdout: int = 3,
    seed: int = 0,
    rank: int = 16,
    signal: float = 3.0,
    popularity_alpha: float = 0.8,
    chunk: int = 2048,
) -> Dataset:
    """A bipartite dataset with collaborative structure: user u takes the
    Gumbel top-k_u items of ``signal * <U_u, V_i> / sqrt(rank) + pop_i +
    Gumbel noise`` over rank-``rank`` latents (``structured_latents``), with a
    Zipf log-popularity shuffled over the item ids. k_u ~ Uniform[test_holdout
    + 2, 2 avg_degree); the last ``test_holdout`` items of each user's set are
    the test split. Users go in chunks of ``chunk``, so the [n_users, m_items]
    score matrix is never whole."""
    rng = np.random.default_rng(seed)
    U, V = structured_latents(n_users, m_items, rank=rank, rng=rng)
    pop = (-popularity_alpha * np.log(np.arange(1, m_items + 1))).astype(np.float32)
    rng.shuffle(pop)

    k_lo, k_hi = test_holdout + 2, max(test_holdout + 3, 2 * avg_degree)
    k_u = rng.integers(k_lo, k_hi, size=n_users)
    k_max = int(k_u.max())
    scale = signal / np.sqrt(rank)

    tr_u, tr_i, te_u, te_i = [], [], [], []
    for lo in range(0, n_users, chunk):
        hi = min(lo + chunk, n_users)
        s = (U[lo:hi] @ V.T) * scale + pop[None, :]
        s += rng.gumbel(size=s.shape).astype(np.float32)
        top = np.argpartition(-s, k_max, axis=1)[:, :k_max]  # [B, k_max] distinct
        for r, u in enumerate(range(lo, hi)):
            k = int(k_u[u])
            items = top[r, :k]
            tr_u.extend([u] * (k - test_holdout))
            tr_i.extend(items[:-test_holdout].tolist())
            te_u.extend([u] * test_holdout)
            te_i.extend(items[-test_holdout:].tolist())

    return Dataset(
        n_users=n_users,
        m_items=m_items,
        train_user=np.asarray(tr_u, dtype=np.int64),
        train_item=np.asarray(tr_i, dtype=np.int64),
        test_user=np.asarray(te_u, dtype=np.int64),
        test_item=np.asarray(te_i, dtype=np.int64),
    )
