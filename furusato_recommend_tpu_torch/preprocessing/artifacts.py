"""The artifact writer: preprocessing outputs to the on-disk feature set the
model layer loads (port of the JAX package's ``preprocessing/artifacts.py``,
in the layout ``data/features.py::load_reference_features`` reads). The
favourite and review edge CSVs go through ``frame.write_csv``."""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .frame import Frame, write_csv

__all__ = ["write_artifacts"]


def write_artifacts(
    base_path,
    suffix: str = "",
    *,
    user_categorical=None,  # [n_users, Fc] int
    item_categorical=None,
    user_numeric=None,  # [n_users, Fn] float
    item_numeric=None,
    user_word2vec=None,  # [n_users, 300]
    item_word2vec=None,
    item_sentence=None,  # [m_items, 768]
    user_text_vecs=None,  # {field: scipy csr} (name / main_comment / main_list_comment)
    item_text_vecs=None,
    item_review_vec=None,  # scipy csr
    product_categories=None,  # [m_items, C] padded category ids (the Diversity metric)
    user_bert=None,  # [n_users, Db] DeBERTa embeddings (the 'b' flag)
    item_bert=None,
    buy_timestamp=None,  # (n_users x m_items) scipy sparse, or [E] in raw order
    user_attribute=None,  # [2, nnz] (user, attribute) COO
    item_attribute=None,
    favorite_edges=None,  # (users, items) of favorite_train.csv
    review_edges=None,
) -> None:
    base = Path(base_path)
    cb = base / "cb" / suffix if suffix else base / "cb"
    tx = base / "text" / suffix if suffix else base / "text"
    cb.mkdir(parents=True, exist_ok=True)
    tx.mkdir(parents=True, exist_ok=True)

    def save_np(d, name, arr):
        if arr is not None:
            np.save(d / f"{name}{suffix}.npy", np.asarray(arr))

    def save_pkl(d, name, obj):
        if obj is not None:
            with open(d / f"{name}{suffix}.pkl", "wb") as f:
                pickle.dump(obj, f)

    save_np(cb, "customer_feature_pad", user_categorical)
    save_np(cb, "product_feature_pad", item_categorical)
    save_np(cb, "user_numeric_feature", user_numeric)
    save_np(cb, "product_numeric_feature", item_numeric)
    save_np(cb, "product_sentence_emb", item_sentence)
    save_np(tx, "user_text_emb", user_word2vec)
    save_np(tx, "product_text_emb", item_word2vec)
    for side, vecs in (("user", user_text_vecs), ("product", item_text_vecs)):
        for field, mat in (vecs or {}).items():
            save_pkl(tx, f"{side}_{field}_count", mat)
    save_pkl(tx, "product_review", item_review_vec)
    save_np(cb, "product_categories", product_categories)

    def save_pt(d, name, arr):
        if arr is not None:
            import torch

            d.mkdir(parents=True, exist_ok=True)
            torch.save(torch.as_tensor(np.asarray(arr)), d / f"{name}{suffix}.pt")

    save_pt(tx, "customer_deberta_feature", user_bert)
    save_pt(tx, "product_deberta_feature", item_bert)
    if buy_timestamp is not None:
        cf = base / "cf"
        cf.mkdir(parents=True, exist_ok=True)
        with open(cf / f"buy_timestamp{suffix}.pkl", "wb") as f:
            pickle.dump(buy_timestamp, f)
    save_pt(base / "attribute", "user_attribute", user_attribute)
    save_pt(base / "attribute", "product_attribute", item_attribute)
    for name, edges in (("favorite_train", favorite_edges), ("review_train", review_edges)):
        if edges is not None:
            u, i = edges
            write_csv(Frame({"cf_customer": np.asarray(u), "cf_product": np.asarray(i)}),
                      base / f"{name}{suffix}.csv")
