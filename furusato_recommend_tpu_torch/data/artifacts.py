"""Seeded synthetic side features for a text dataset, written in the
reference's artifact layout, so the SAGE family can train on that dataset
through the CLIs (``features.load_reference_features`` reads them back); and
a dataset's interactions as the reference's text files
(``write_text_dataset``, which ``load_text_dataset`` reads back).

    python -m furusato_recommend_tpu_torch.data.artifacts --data_path ./data [--seed 0] [--suffix ""]

The dataset is ``{data_path}/cf/train{suffix}.txt`` + ``test{suffix}.txt``;
the features are ``synthetic_features`` with every flag (numeric,
categorical, word2vec, sentence, bert and the four text fields), written as
``cb/*.npy``, ``text/*.npy``, ``text/*_deberta_feature*.pt`` and pickled
scipy CSR count matrices ``text/*_count*.pkl`` / ``text/product_review*.pkl``;
and for the edge-feature models the seeded relation edge sets
``favorite_train*.csv`` / ``review_train*.csv`` (``synthetic_relation_edges``)
and the purchase times ``cf/buy_timestamp*.pkl``, a float32 array in the
train edges' order (``synthetic_edge_times``); for sasrec the item sequences
``train_items_sequence*.pkl`` (a list indexed by user) and their lengths
``train_sequence_length*.pt`` (``synthetic_sequences``); for asage the
attribute graphs ``attribute/{user,product}_attribute*.pt``, [2, nnz]
(entity, attribute) pairs (``synthetic_attributes``). Writing the count
matrices needs scipy, the reference's format.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from .dataset import load_text_dataset
from .features import TEXT_FIELDS, FeatureStore, synthetic_features

__all__ = [
    "synthetic_attributes", "synthetic_edge_times", "synthetic_relation_edges", "synthetic_sequences",
    "write_attribute_artifacts", "write_edge_artifacts", "write_reference_features", "write_sequence_artifacts",
    "write_text_dataset",
]

_FIELD_NAMES = ("name", "main_comment", "main_list_comment")


def _counts(text: np.ndarray, vocab: int):
    """[N, W] padded word ids -> an N x vocab scipy CSR matrix of ones."""
    import scipy.sparse as sp

    rows, cols = np.nonzero(text >= 0)
    return sp.csr_matrix(
        (np.ones(len(rows), np.int64), (rows, text[rows, cols])), shape=(text.shape[0], vocab)
    )


def _rows(users: np.ndarray, items: np.ndarray, n: int) -> list:
    """Each user's items, in the arrays' order."""
    order = np.argsort(users, kind="stable")
    bounds = np.searchsorted(users[order], np.arange(n + 1))
    it = items[order]
    return [it[bounds[u] : bounds[u + 1]] for u in range(n)]


def write_text_dataset(dataset, base_path, suffix: str = "") -> None:
    """The interactions of ``dataset`` as the reference's adjacency-list files
    ``{base_path}/cf/train{suffix}.txt``, ``test{suffix}.txt`` and
    ``inference{suffix}.txt`` (``uid item item ...``, a user's items in the
    dataset's order): the inference file holds the dataset's inference edge
    set, or each user's train then test items. ``load_text_dataset`` reads
    back the same arrays when the largest user and item ids have
    interactions."""
    cf = Path(base_path) / "cf"
    cf.mkdir(parents=True, exist_ok=True)
    n = dataset.n_users
    splits = {
        "train": _rows(dataset.train_user, dataset.train_item, n),
        "test": _rows(dataset.test_user, dataset.test_item, n),
    }
    if dataset.has_inference_edges:
        splits["inference"] = _rows(dataset.inference_user, dataset.inference_item, n)
    else:
        splits["inference"] = [np.concatenate([a, b]) for a, b in zip(splits["train"], splits["test"])]
    for name, rows in splits.items():
        with open(cf / f"{name}{suffix}.txt", "w") as f:
            f.writelines(f"{u} {' '.join(map(str, row.tolist()))}\n" for u, row in enumerate(rows) if len(row))


def write_reference_features(store: FeatureStore, base_path, suffix: str = "") -> None:
    """Every array of ``store`` (all of them present) under ``base_path`` in
    the reference's names."""
    base = Path(base_path)
    cb = base / "cb" / suffix if suffix else base / "cb"
    tx = base / "text" / suffix if suffix else base / "text"
    cb.mkdir(parents=True, exist_ok=True)
    tx.mkdir(parents=True, exist_ok=True)
    for side, prefix, long_prefix, f in (
        ("user", "user", "customer", store.user),
        ("item", "product", "product", store.item),
    ):
        np.save(cb / f"{prefix}_numeric_feature{suffix}.npy", f.numeric.numpy())
        np.save(cb / f"{long_prefix}_feature_pad{suffix}.npy", f.categorical.numpy())
        np.save(tx / f"{prefix}_text_emb{suffix}.npy", f.word2vec.numpy())
        torch.save(f.bert, tx / f"{long_prefix}_deberta_feature{suffix}.pt")
        text = f.text.numpy()
        for i, field in enumerate(_FIELD_NAMES[:TEXT_FIELDS]):
            with open(tx / f"{prefix}_{field}_count{suffix}.pkl", "wb") as out:
                pickle.dump(_counts(text[:, i], store.text_vocab), out)
        if side == "item":
            np.save(cb / f"product_sentence_emb{suffix}.npy", f.sentence.numpy())
            review = text[:, TEXT_FIELDS] if text.shape[1] > TEXT_FIELDS else np.full(text.shape[::2], -1)
            with open(tx / f"product_review{suffix}.pkl", "wb") as out:
                pickle.dump(_counts(review, store.text_vocab), out)


def synthetic_relation_edges(dataset, seed: int = 0):
    """rsage's two extra relation edge sets, [(users, items), ...] as int64
    arrays, from ``default_rng(seed)``: favourites, 30% of the train pairs
    drawn without replacement (duplicates of purchases) plus 10% of E
    uniform pairs; reviews, 10% of the train pairs."""
    rng = np.random.default_rng(seed)
    e = dataset.train_size
    tu, ti = np.asarray(dataset.train_user, np.int64), np.asarray(dataset.train_item, np.int64)
    fav = rng.choice(e, size=int(0.3 * e), replace=False)
    n_rand = int(0.1 * e)
    fav_u = np.concatenate([tu[fav], rng.integers(0, dataset.n_users, n_rand)])
    fav_i = np.concatenate([ti[fav], rng.integers(0, dataset.m_items, n_rand)])
    rev = rng.choice(e, size=int(0.1 * e), replace=False)
    return [(fav_u, fav_i), (tu[rev], ti[rev])]


def synthetic_edge_times(dataset, seed: int = 0) -> np.ndarray:
    """A purchase time per train edge, uniform in [0, 1), float32, in the
    dataset's raw edge order, from ``default_rng(seed)``."""
    return np.random.default_rng(seed).random(dataset.train_size).astype(np.float32)


def write_edge_artifacts(dataset, base_path, suffix: str = "", seed: int = 0) -> None:
    """The relation edge sets as ``{favorite,review}_train{suffix}.csv``
    (columns ``cf_customer``, ``cf_product``) and the purchase times as
    ``cf/buy_timestamp{suffix}.pkl``."""
    base = Path(base_path)
    for name, (u, i) in zip(("favorite_train", "review_train"), synthetic_relation_edges(dataset, seed)):
        with open(base / f"{name}{suffix}.csv", "w") as out:
            out.write("cf_customer,cf_product\n")
            out.writelines(f"{a},{b}\n" for a, b in zip(u.tolist(), i.tolist()))
    (base / "cf").mkdir(parents=True, exist_ok=True)
    with open(base / "cf" / f"buy_timestamp{suffix}.pkl", "wb") as out:
        pickle.dump(synthetic_edge_times(dataset, seed), out)


def synthetic_sequences(dataset, seed: int = 0) -> list:
    """Each user's train items (a list a user) in the order of a uniform time
    per train edge from ``default_rng(seed)``, as the reference orders them
    by purchase time."""
    t = np.random.default_rng(seed).random(dataset.train_size)
    u, i = np.asarray(dataset.train_user), np.asarray(dataset.train_item)
    order = np.lexsort((t, u))
    u_s, i_s = u[order], i[order]
    bounds = np.searchsorted(u_s, np.arange(dataset.n_users + 1))
    return [i_s[bounds[k] : bounds[k + 1]].tolist() for k in range(dataset.n_users)]


def synthetic_attributes(n: int, n_attrs: int, seed: int = 0) -> np.ndarray:
    """[2, nnz] int64 (entity, attribute) pairs: each of ``n`` entities gets
    1 to 3 distinct attributes of ``n_attrs``, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 4, n)
    cols = np.concatenate([rng.choice(n_attrs, size=c, replace=False) for c in counts])
    return np.stack([np.repeat(np.arange(n), counts), cols]).astype(np.int64)


def write_sequence_artifacts(dataset, base_path, suffix: str = "", seed: int = 0) -> None:
    """``train_items_sequence{suffix}.pkl`` and ``train_sequence_length{suffix}.pt``
    of ``synthetic_sequences``."""
    seqs = synthetic_sequences(dataset, seed)
    base = Path(base_path)
    with open(base / f"train_items_sequence{suffix}.pkl", "wb") as out:
        pickle.dump(seqs, out)
    torch.save(torch.tensor([len(q) for q in seqs], dtype=torch.int64), base / f"train_sequence_length{suffix}.pt")


def write_attribute_artifacts(dataset, base_path, suffix: str = "", seed: int = 0) -> None:
    """``attribute/user_attribute{suffix}.pt`` and ``attribute/product_attribute{suffix}.pt``
    of ``synthetic_attributes`` over 16 user and 24 item attributes (users
    from ``seed``, items from ``seed + 1``)."""
    at = Path(base_path) / "attribute"
    at.mkdir(parents=True, exist_ok=True)
    sides = (("user", dataset.n_users, 16), ("product", dataset.m_items, 24))
    for j, (name, n, k) in enumerate(sides):
        torch.save(torch.from_numpy(synthetic_attributes(n, k, seed + j)), at / f"{name}_attribute{suffix}.pt")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="furusato_recommend_tpu_torch.data.artifacts")
    ap.add_argument("--data_path", default="./data")
    ap.add_argument("--suffix", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    config = Config(data_path=args.data_path, suffix=args.suffix, user_feature="ncwtb",
                    item_feature="ncwtsrb")
    dataset = load_text_dataset(config)
    write_reference_features(synthetic_features(dataset, config, seed=args.seed), args.data_path, args.suffix)
    write_edge_artifacts(dataset, args.data_path, args.suffix, seed=args.seed)
    write_sequence_artifacts(dataset, args.data_path, args.suffix, seed=args.seed)
    write_attribute_artifacts(dataset, args.data_path, args.suffix, seed=args.seed)
    print(f"wrote features of {dataset.n_users} users and {dataset.m_items} items, relation edges, "
          f"purchase times, item sequences and attributes under {args.data_path}")


if __name__ == "__main__":
    main()
