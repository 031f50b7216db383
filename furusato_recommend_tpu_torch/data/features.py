"""Side features of the SAGE / TextSAGE family (port of ``data/features.py``).

Every feature is a dense tensor, held by the model on its device:

- numeric [N, Fn] float32;
- categorical [N, Fc] int32 (the pad slots count in the mean over fields, as
  in the JAX package);
- word2vec [N, 300], sentence [N, 768], bert [N, Db] float32;
- text [N, fields, W] int32: each text field's distinct word ids, -1 padded
  (3 fields, plus the review field for items with the ``r`` flag).

``synthetic_features`` (noise with respect to the graph) and
``informative_synthetic_features`` (noisy views of the latents of
``synthetic_structured_dataset``) draw the same numpy streams as the JAX
package's, so one seed gives bit-equal arrays in both.
``load_reference_features`` reads the reference's artifacts for the flags ``n
c w t s r b``, and the per-edge purchase times (``buy_timestamp``) for tgsrec /
sasgnn; ``numeric_artifact_paths`` names the numeric matrices that the
out-of-core ``dask`` variant reads from disk instead (``data/ooc.py``);
``load_relation_edges`` reads rsage's favourite and review edge sets,
``load_attribute_coos`` asage's (entity, attribute) pairs.
"""

from __future__ import annotations

import csv
import dataclasses
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from .dataset import Dataset, structured_latents

__all__ = [
    "SideFeatures",
    "FeatureStore",
    "synthetic_features",
    "informative_synthetic_features",
    "numeric_artifact_paths",
    "pad_text_rows",
    "text_from_scipy_csr",
    "load_reference_features",
    "load_relation_edges",
    "load_attribute_coos",
    "edge_time_in_csr_order",
    "WORD2VEC_DIM",
    "SENTENCE_DIM",
    "BERT_DIM",
    "TEXT_FIELDS",
]

WORD2VEC_DIM = 300
SENTENCE_DIM = 768
BERT_DIM = 768
TEXT_FIELDS = 3  # name, main_comment, main_list_comment


def _move(x: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if x is None else x.to(device)


@dataclass(frozen=True)
class SideFeatures:
    """Features of one side (users or items); unused ones are None."""

    numeric: Optional[torch.Tensor] = None  # [N, Fn] float32
    categorical: Optional[torch.Tensor] = None  # [N, Fc] int32
    word2vec: Optional[torch.Tensor] = None  # [N, 300] float32
    sentence: Optional[torch.Tensor] = None  # [N, 768] float32
    bert: Optional[torch.Tensor] = None  # [N, Db] float32
    text: Optional[torch.Tensor] = None  # [N, fields, W] int32, -1 pad

    @property
    def n_entities(self) -> int:
        for f in dataclasses.fields(self):
            a = getattr(self, f.name)
            if a is not None:
                return a.shape[0]
        raise ValueError("empty SideFeatures")

    def to(self, device) -> "SideFeatures":
        return SideFeatures(**{f.name: _move(getattr(self, f.name), device) for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class FeatureStore:
    user: SideFeatures
    item: SideFeatures
    user_cat_vocab: int = 0
    item_cat_vocab: int = 0
    text_vocab: int = 0
    n_relations: int = 0
    #: per-edge arrays in the prop_user_pos (message) CSR edge order, which
    #: the edge-feature convs read
    edge_time: Optional[torch.Tensor] = None  # [E] float32
    edge_label: Optional[torch.Tensor] = None  # [E] int32

    def to(self, device) -> "FeatureStore":
        return dataclasses.replace(
            self,
            user=self.user.to(device),
            item=self.item.to(device),
            edge_time=_move(self.edge_time, device),
            edge_label=_move(self.edge_label, device),
        )


def pad_text_rows(rows, width: int) -> np.ndarray:
    """Ragged distinct-word-id rows -> [N, width] int32, -1 padded; a row
    longer than ``width`` keeps its first ids."""
    out = np.full((len(rows), width), -1, dtype=np.int32)
    for i, r in enumerate(rows):
        r = np.asarray(r, dtype=np.int32)[:width]
        out[i, : len(r)] = r
    return out


def text_from_scipy_csr(mat, width: int) -> np.ndarray:
    """A scipy CSR count matrix -> padded distinct-word-id rows (the counts
    are ignored, as the reference's scatter ignores them)."""
    rows = [mat.indices[mat.indptr[i] : mat.indptr[i + 1]] for i in range(mat.shape[0])]
    return pad_text_rows(rows, width)


def synthetic_features(
    dataset: Dataset,
    config: Config,
    seed: int = 0,
    n_numeric_user: int = 24,
    n_numeric_item: int = 16,
    n_cat_fields_user: int = 4,
    n_cat_fields_item: int = 5,
    cat_vocab_user: int = 40,
    cat_vocab_item: int = 60,
    text_vocab: int = 500,
    text_width: int = 12,
    with_edge_time: bool = False,
    with_edge_label: bool = False,
    n_relations: int = 3,
) -> FeatureStore:
    """Seeded synthetic artifacts shaped like the reference's, as CPU tensors;
    the same draws as the JAX package's in the same order. As there, a side
    gets the review text field when it has ``m_items`` entities and the item
    flags hold ``r``."""
    rng = np.random.default_rng(seed)
    nu, mi = dataset.n_users, dataset.m_items
    e = dataset.train_size
    t = torch.from_numpy

    def side(n, fn, fc, vocab):
        n_fields = TEXT_FIELDS + (1 if (n == mi and "r" in config.item_feature) else 0)
        text = np.full((n, n_fields, text_width), -1, dtype=np.int32)
        for i in range(n):
            for f in range(n_fields):
                k = rng.integers(1, text_width)
                text[i, f, :k] = rng.choice(text_vocab, size=k, replace=False)
        return SideFeatures(
            numeric=t(rng.random((n, fn)).astype(np.float32)),
            categorical=t(rng.integers(0, vocab, (n, fc)).astype(np.int32)),
            word2vec=t((rng.standard_normal((n, WORD2VEC_DIM)) * 0.1).astype(np.float32)),
            sentence=t((rng.standard_normal((n, SENTENCE_DIM)) * 0.1).astype(np.float32)),
            bert=t((rng.standard_normal((n, BERT_DIM)) * 0.1).astype(np.float32)),
            text=t(text),
        )

    user = side(nu, n_numeric_user, n_cat_fields_user, cat_vocab_user)
    item = side(mi, n_numeric_item, n_cat_fields_item, cat_vocab_item)
    return FeatureStore(
        user=user,
        item=item,
        user_cat_vocab=cat_vocab_user,
        item_cat_vocab=cat_vocab_item,
        text_vocab=text_vocab,
        n_relations=n_relations if with_edge_label else 0,
        edge_time=t(rng.random(e).astype(np.float32)) if with_edge_time else None,
        edge_label=t(rng.integers(0, n_relations, e).astype(np.int32)) if with_edge_label else None,
    )


def informative_synthetic_features(
    dataset: Dataset,
    config: Config,
    dataset_seed: int = 0,
    rank: int = 16,
    seed: int = 1,
    n_numeric_user: int = 24,
    n_numeric_item: int = 16,
    n_cat_fields_user: int = 4,
    n_cat_fields_item: int = 5,
    n_clusters: int = 32,
    tokens_per_cluster: int = 10,
    text_vocab: int = 500,
    text_width: int = 12,
    numeric_noise: float = 0.15,
    w2v_noise: float = 0.3,
    cluster_fidelity: float = 0.85,
) -> FeatureStore:
    """Artifacts shaped as ``synthetic_features``'s that carry the latents of
    ``synthetic_structured_dataset(..., seed=dataset_seed, rank=rank)``
    (regenerated by ``structured_latents``), as CPU tensors; the same draws as
    the JAX package's in the same order, from ``default_rng(seed +
    7_777_777)``:

    - numeric: the first ``rank`` columns are 0.5 x the latents, every column
      has ``numeric_noise`` Gaussian noise;
    - word2vec / sentence / bert: the latents through a random linear map, plus
      ``w2v_noise`` Gaussian noise;
    - text: each entity's cluster is its latent direction's nearest of
      ``n_clusters`` shared centroids, and cluster c owns the token band [c
      tokens_per_cluster, (c + 1) tokens_per_cluster); a field's tokens come
      from the entity's band with probability ``cluster_fidelity``, else
      uniformly;
    - categorical: per field, the nearest of the field's own centroids."""
    if n_clusters * tokens_per_cluster > text_vocab:
        raise ValueError("n_clusters x tokens_per_cluster must fit in text_vocab")
    rng = np.random.default_rng(seed + 7_777_777)
    nu, mi = dataset.n_users, dataset.m_items
    U, V = structured_latents(nu, mi, rank=rank, seed=dataset_seed)
    Un = U / np.linalg.norm(U, axis=1, keepdims=True)
    Vn = V / np.linalg.norm(V, axis=1, keepdims=True)

    centroids = rng.standard_normal((n_clusters, rank)).astype(np.float32)
    centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
    t = torch.from_numpy

    def dense_view(lat, width, noise):
        R = rng.standard_normal((rank, width)).astype(np.float32) / np.sqrt(rank)
        x = lat @ R + noise * rng.standard_normal((lat.shape[0], width)).astype(np.float32)
        return x.astype(np.float32)  # R / sqrt(rank) is float64

    def side(lat, latn, fn, fc):
        n = lat.shape[0]
        numeric = numeric_noise * rng.standard_normal((n, fn)).astype(np.float32)
        numeric[:, :rank] += 0.5 * lat
        cluster = np.argmax(latn @ centroids.T, axis=1)
        n_fields = TEXT_FIELDS + (1 if (n == mi and "r" in config.item_feature) else 0)
        text = np.full((n, n_fields, text_width), -1, dtype=np.int32)
        band0 = cluster * tokens_per_cluster
        for i in range(n):
            for f in range(n_fields):
                k = int(rng.integers(3, text_width))
                own = rng.random(k) < cluster_fidelity
                toks = np.where(
                    own,
                    band0[i] + rng.integers(0, tokens_per_cluster, size=k),
                    rng.integers(0, text_vocab, size=k),
                )
                distinct = np.unique(toks)
                text[i, f, : len(distinct)] = distinct
        cat = np.empty((n, fc), dtype=np.int32)
        for f in range(fc):
            cf = rng.standard_normal((n_clusters, rank)).astype(np.float32)
            cat[:, f] = np.argmax(latn @ cf.T, axis=1)
        return SideFeatures(
            numeric=t(numeric),
            categorical=t(cat),
            word2vec=t(dense_view(lat, WORD2VEC_DIM, w2v_noise)),
            sentence=t(dense_view(lat, SENTENCE_DIM, w2v_noise)),
            bert=t(dense_view(lat, BERT_DIM, w2v_noise)),
            text=t(text),
        )

    return FeatureStore(
        user=side(U, Un, n_numeric_user, n_cat_fields_user),
        item=side(V, Vn, n_numeric_item, n_cat_fields_item),
        user_cat_vocab=n_clusters,
        item_cat_vocab=n_clusters,
        text_vocab=text_vocab,
    )


def _cb_dir(config: Config, base_path: str) -> Path:
    sfx = config.suffix
    return Path(base_path) / "cb" / sfx if sfx else Path(base_path) / "cb"


def numeric_artifact_paths(config: Config, base_path: str) -> Dict[str, str]:
    """side -> the path of its numeric matrix (``cb/user_numeric_feature{sfx}.npy``,
    ``cb/product_numeric_feature{sfx}.npy``) for each side whose flags hold
    ``n``: what the out-of-core ``dask`` variant opens as a memmap."""
    sfx, cb = config.suffix, _cb_dir(config, base_path)
    out: Dict[str, str] = {}
    if "n" in config.user_feature:
        out["user"] = str(cb / f"user_numeric_feature{sfx}.npy")
    if "n" in config.item_feature:
        out["item"] = str(cb / f"product_numeric_feature{sfx}.npy")
    return out


def load_reference_features(
    config: Config,
    base_path: str,
    dataset: Optional[Dataset] = None,
    skip_numeric: bool = False,
) -> FeatureStore:
    """The reference's on-disk artifacts under ``base_path``, for the flags
    the config names: ``cb/{customer,product}_feature_pad{sfx}.npy`` (c),
    ``cb/{user,product}_numeric_feature{sfx}.npy`` (n),
    ``text/{user,product}_text_emb{sfx}.npy`` (w),
    ``cb/product_sentence_emb{sfx}.npy`` (s),
    ``text/{customer,product}_deberta_feature{sfx}.pt`` (b), and the pickled
    scipy CSR count matrices ``text/{user,product}_{name,main_comment,
    main_list_comment}_count{sfx}.pkl`` plus ``text/product_review{sfx}.pkl``
    (t, r), read into rows of at most 64 distinct words. With a suffix, the
    ``cb`` and ``text`` directories are ``cb/{sfx}`` and ``text/{sfx}``.

    ``skip_numeric`` leaves the numeric matrices on disk (the ``dask``
    variant). For tgsrec / sasgnn, ``cf/buy_timestamp{sfx}.pkl`` (a sparse
    (user, item) matrix, or a flat array in the train edges' order) gives
    ``edge_time`` in the user-CSR edge order, which needs ``dataset``."""
    sfx = config.suffix
    cb = _cb_dir(config, base_path)
    tx = Path(base_path) / "text" / sfx if sfx else Path(base_path) / "text"
    text_width = 64

    def np_load(p):
        return np.load(p, allow_pickle=True)

    def pkl_load(p):
        # the reference's own artifacts: scipy matrices that only pickle holds
        with open(p, "rb") as f:
            return pickle.load(f)

    def pt_load(p):
        x = torch.load(p, map_location="cpu", weights_only=False)
        return np.asarray(x.detach().numpy() if hasattr(x, "detach") else x)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    uf, itf = config.user_feature, config.item_feature

    def side_text(prefix, extra_review=False):
        fields = ["name", "main_comment", "main_list_comment"]
        mats = [pkl_load(tx / f"{prefix}_{f}_count{sfx}.pkl") for f in fields]
        if extra_review:
            mats.append(pkl_load(tx / f"product_review{sfx}.pkl"))
        padded = [text_from_scipy_csr(m, text_width) for m in mats]
        return np.stack(padded, axis=1), mats[0].shape[1]

    user_cat = np_load(cb / f"customer_feature_pad{sfx}.npy").astype(np.int32) if "c" in uf else None
    item_cat = np_load(cb / f"product_feature_pad{sfx}.npy").astype(np.int32) if "c" in itf else None
    vocab = 0
    user_text = item_text = None
    if "t" in uf:
        user_text, vocab = side_text("user")
    if "t" in itf or "r" in itf:
        item_text, vocab = side_text("product", extra_review="r" in itf)

    user = SideFeatures(
        numeric=f32(np_load(cb / f"user_numeric_feature{sfx}.npy")) if "n" in uf and not skip_numeric else None,
        categorical=None if user_cat is None else torch.from_numpy(user_cat),
        word2vec=f32(np_load(tx / f"user_text_emb{sfx}.npy")) if "w" in uf else None,
        bert=f32(pt_load(tx / f"customer_deberta_feature{sfx}.pt")) if "b" in uf else None,
        text=None if user_text is None else torch.from_numpy(user_text),
    )
    item = SideFeatures(
        numeric=f32(np_load(cb / f"product_numeric_feature{sfx}.npy"))
        if "n" in itf and not skip_numeric
        else None,
        categorical=None if item_cat is None else torch.from_numpy(item_cat),
        word2vec=f32(np_load(tx / f"product_text_emb{sfx}.npy")) if "w" in itf else None,
        sentence=f32(np_load(cb / f"product_sentence_emb{sfx}.npy")) if "s" in itf else None,
        bert=f32(pt_load(tx / f"product_deberta_feature{sfx}.pt")) if "b" in itf else None,
        text=None if item_text is None else torch.from_numpy(item_text),
    )
    edge_time = None
    ts_path = Path(base_path) / "cf" / f"buy_timestamp{sfx}.pkl"
    if config.model in ("tgsrec", "sasgnn") and ts_path.exists():
        if dataset is None:
            raise ValueError(f"{config.model} needs dataset= to align {ts_path} to the edge order")
        ts = pkl_load(ts_path)
        if hasattr(ts, "tocsr"):  # scipy sparse, indexed [user, item]
            raw = np.asarray(ts.tocsr()[dataset.train_user, dataset.train_item]).reshape(-1)
        else:
            raw = np.asarray(ts).reshape(-1)
        edge_time = edge_time_in_csr_order(dataset, raw)
    return FeatureStore(
        user=user,
        item=item,
        user_cat_vocab=0 if user_cat is None else int(user_cat.max()) + 1,
        item_cat_vocab=0 if item_cat is None else int(item_cat.max()) + 1,
        text_vocab=vocab,
        edge_time=edge_time,
    )


def edge_time_in_csr_order(dataset: Dataset, raw) -> torch.Tensor:
    """Per-train-edge times in the dataset's raw edge order -> float32 in the
    user-CSR edge order (``FeatureStore.edge_time``)."""
    tu, ti = dataset.train_user, dataset.train_item
    raw = np.asarray(raw, dtype=np.float32).reshape(-1)
    if raw.shape[0] != len(tu):
        raise ValueError(f"buy_timestamp length {raw.shape[0]} != train edges {len(tu)}")
    return torch.from_numpy(raw[np.lexsort((ti, tu))])


def load_relation_edges(config: Config, base_path) -> Optional[list]:
    """rsage's extra relation edge sets, ``favorite_train{sfx}.csv`` and
    ``review_train{sfx}.csv`` (columns ``cf_customer``, ``cf_product``) under
    ``base_path``: [(users, items), ...] as int64 arrays in label order
    (favourite 1, review 2), or None when either file is absent."""
    out = []
    for name in ("favorite_train", "review_train"):
        path = Path(base_path) / f"{name}{config.suffix}.csv"
        if not path.exists():
            return None
        with open(path, newline="") as f:
            rows = csv.reader(f)
            header = next(rows)
            cu, ci = header.index("cf_customer"), header.index("cf_product")
            pairs = [(r[cu], r[ci]) for r in rows if r]
        arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        out.append((arr[:, 0].copy(), arr[:, 1].copy()))
    return out


def load_attribute_coos(config: Config, base_path) -> Optional[dict]:
    """asage's attribute graphs, ``attribute/{user,product}_attribute{sfx}.pt``
    under ``base_path``: [2, nnz] (entity, attribute) index pairs, as
    {"user_attr": (rows, cols, n, n_attrs), "item_attr": ...} keyword
    arguments of the model (int64 arrays; n and n_attrs one past the largest
    index), or None when either file is absent."""
    at = Path(base_path) / "attribute"
    paths = [at / f"{name}_attribute{config.suffix}.pt" for name in ("user", "product")]
    if not all(p.exists() for p in paths):
        return None

    def coo(p):
        t = torch.load(p, map_location="cpu", weights_only=False)
        arr = np.asarray(t.detach().numpy() if hasattr(t, "detach") else t)
        rows, cols = arr[0].astype(np.int64), arr[1].astype(np.int64)
        return rows, cols, int(rows.max()) + 1, int(cols.max()) + 1

    return {"user_attr": coo(paths[0]), "item_attr": coo(paths[1])}
