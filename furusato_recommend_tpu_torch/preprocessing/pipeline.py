"""Raw tables to a training-ready artifact directory in one call (port of the
JAX package's ``preprocessing/pipeline.py``; ``tools preprocess`` runs it).

Product-ID dedup, the partner merge, customer ids and ages, transactions to
``cf`` ids, the categorical, numeric and text features, the reviews and the
category membership, then ``write_artifacts`` and the
``cf/train.txt`` / ``cf/test.txt`` split (per user, a stable order of the
transactions, the last ``test_holdout`` to test). ``incremental_frac > 0``
holds out that fraction of every input table and pushes it through each
component's ``update()`` after initialization (the reference's OFFSET
slicing).

Host code only: it takes no device. The JAX package's Deviations carry over:
the user-side text vectors are the row-normalised sums of each user's
products' TF-IDF rows, and no word2vec ('w') or DeBERTa ('b') artifact is
written (they need outside models).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..obs.log import step_timer
from .artifacts import write_artifacts
from .categorical import CustomerCategoricalFeature, ProductCategoricalFeature
from .category import CategoryInfo, ProductCategoryInfo, padded_categories
from .frame import Frame, map_values
from .ids import CustomerIDInfo, ProductIDInfo, TimeProcessing, TransactionInfo
from .numeric import CustomerNumericFeature, ProductNumericFeature
from .partner import PartnerMerge
from .text import ProductReviewFeature, ProductTextFeature

__all__ = ["run_preprocessing"]

#: the stages ``run_preprocessing`` times into its ``sink``, in order
STAGES = ("dedup", "categorical", "numeric", "text", "reviews", "categories", "write", "split")


def _split(df: Optional[Frame], frac: float):
    """(orig, new) rows: the reference's OFFSET slicing."""
    if df is None:
        return None, None
    if frac <= 0 or len(df) < 2:
        return df, None
    cut = max(1, int(len(df) * (1.0 - frac)))
    return df.iloc(slice(0, cut)), df.iloc(slice(cut, None)) if cut < len(df) else None


def _user_text_vecs(item_vecs, tx_user, tx_item, n_users):
    """Per user, the row-normalised sum of the purchased products' TF-IDF rows."""
    inter = sp.csr_matrix(
        (np.ones(len(tx_user)), (np.asarray(tx_user), np.asarray(tx_item))),
        shape=(n_users, item_vecs["name"].shape[0]),
    )
    deg = np.asarray(inter.sum(axis=1)).ravel()
    norm = sp.diags(1.0 / np.maximum(deg, 1.0))
    return {f: (norm @ inter @ v).tocsr() for f, v in item_vecs.items()}


def _write_split(cf_dir: Path, suffix: str, u: np.ndarray, i: np.ndarray, n_customer: int, test_holdout: int):
    order = np.argsort(u, kind="stable")
    u_s, i_s = u[order], i[order]
    bounds = np.searchsorted(u_s, np.arange(n_customer + 1))
    with open(cf_dir / f"train{suffix}.txt", "w") as ftr, open(cf_dir / f"test{suffix}.txt", "w") as fte:
        for uu in range(n_customer):
            row = i_s[bounds[uu] : bounds[uu + 1]]
            if len(row) == 0:
                continue
            k = min(test_holdout, max(len(row) - 1, 0))
            tr_items = row[: len(row) - k] if k else row
            te_items = row[len(row) - k :] if k else row[:0]
            if len(tr_items):
                ftr.write(f"{uu} " + " ".join(map(str, tr_items.tolist())) + "\n")
            if len(te_items):
                fte.write(f"{uu} " + " ".join(map(str, te_items.tolist())) + "\n")


def run_preprocessing(
    products: Frame,
    customers: Frame,
    transactions: Frame,
    out_dir: str,
    *,
    product_category: Optional[Frame] = None,
    partner: Optional[Frame] = None,
    reviews: Optional[Frame] = None,
    suffix: str = "",
    incremental_frac: float = 0.0,
    test_holdout: int = 1,
    product_cat_cols=("head_office_pref", "head_office_addr01"),
    customer_cat_cols=("sex", "pref", "age"),
    customer_numeric_cols=("head_office_pref", "head_office_addr01"),
    product_numeric_cols=("pref",),
    sink=None,
) -> dict:
    """The whole flow; returns the JAX package's summary dict.

    products: product_id, name, minimum_donation_price, parent_product_id,
        partner_id, text columns, ...
    customers: customer_id and the categorical columns; a ``birth_year``
        column (with no ``age``) becomes ``age``
    transactions: ``cf_customer`` / ``cf_product``, or raw ``customer_id`` /
        ``product_id`` converted through the id maps built here
    product_category: (product_id, category_id); partner: left-joined for the
        office prefecture and address; reviews: (product_id or cf_product,
        recommend_level, comment)
    incremental_frac: the fraction of every table pushed through ``update()``
    test_holdout: the last k interactions of each user written to test
    sink: an object with ``log(metrics)`` that takes each stage's host
        seconds (``STAGES``) as ``time/<stage>``
    """
    with step_timer("dedup", sink):
        prod_orig, prod_new = _split(products, incremental_frac)
        pid = ProductIDInfo(prod_orig)
        if prod_new is not None:
            pid.update(prod_new)
        experiment_df = pid.experiment_df
        if partner is not None:
            experiment_df = PartnerMerge(partner).transform(experiment_df)
        n_product = pid.n_product
        # one row per id in id order; an id with no row would be all NaN
        dense_products = experiment_df.reindex("cf_product", n_product)
        dense_products["cf_product"] = np.arange(n_product)

        cust_orig, cust_new = _split(customers, incremental_frac)
        cid = CustomerIDInfo(cust_orig)
        if cust_new is not None:
            cid.update(cust_new)
        customer_df = Frame.concat([cust_orig] + ([cust_new] if cust_new is not None else []))
        customer_df = cid.convert_df(customer_df)
        if "birth_year" in customer_df and "age" not in customer_df:
            customer_df = TimeProcessing(customer_df).transform()
        n_customer = cid.n_customer

        tx = transactions.copy()
        if "cf_product" not in tx:
            tx["cf_product"] = map_values(tx["product_id"], pid.productid_converter)
        if "cf_customer" not in tx:
            cmap = dict(zip(customer_df["customer_id"].tolist(), customer_df["cf_customer"].tolist()))
            tx["cf_customer"] = map_values(tx["customer_id"], cmap)
        tx = tx.dropna(["cf_customer", "cf_product"])
        tx["cf_customer"] = tx["cf_customer"].astype(np.int64)
        tx["cf_product"] = tx["cf_product"].astype(np.int64)
        tx_orig, tx_new = _split(tx, incremental_frac)
        tinfo = TransactionInfo(tx_orig)
        if tx_new is not None:
            tinfo.update(tx_new)

    with step_timer("categorical", sink):
        prod_cat_cols = [c for c in product_cat_cols if c in dense_products]
        pc = ProductCategoricalFeature(dense_products, prod_cat_cols) if prod_cat_cols else None
        cust_cat_cols = [c for c in customer_cat_cols if c in customer_df]
        cc = CustomerCategoricalFeature(customer_df, cust_cat_cols) if cust_cat_cols else None

    with step_timer("numeric", sink):
        cn_cols = [c for c in customer_numeric_cols if c in dense_products]
        cnum = CustomerNumericFeature(n_customer, dense_products, cn_cols) if cn_cols else None
        pn_cols = [c for c in product_numeric_cols if c in customer_df]
        pnum = ProductNumericFeature(n_product, customer_df, pn_cols) if pn_cols else None
        for f in (cnum, pnum):
            if f is None:
                continue
            f.initialize(tx_orig)
            if tx_new is not None:
                f.update_counter(tx_new)
        user_numeric = None if cnum is None else cnum.get_feature()
        item_numeric = None if pnum is None else pnum.get_feature()

    with step_timer("text", sink):
        text_source = dense_products.copy()
        for c in ProductTextFeature.TEXT_COLS:
            if c not in text_source:
                text_source[c] = ""
        cut = n_product if prod_new is None else pid.previous_max_id + 1
        tf = ProductTextFeature(text_source.iloc(slice(0, cut)))
        if cut < n_product:
            tf.update(text_source.iloc(slice(cut, None)))
        item_vecs = {
            "name": tf.name_vec,
            "main_comment": tf.main_comment_vec,
            "main_list_comment": tf.main_list_comment_vec,
        }
        user_vecs = _user_text_vecs(item_vecs, tinfo.df["cf_customer"], tinfo.df["cf_product"], n_customer)

    review_vec = None
    with step_timer("reviews", sink):
        if reviews is not None:
            rdf = reviews.copy()
            if "cf_product" not in rdf:
                rdf["cf_product"] = map_values(rdf["product_id"], pid.productid_converter)
            r_orig, r_new = _split(rdf, incremental_frac)
            rf = ProductReviewFeature(dense_products, r_orig, tf.tfidf_vectorizer)
            rf.update_info(n_product)
            if r_new is not None:
                rf.update_feature(r_new)
            review_vec = rf.get_tfidf_vec()

    prod_categories = None
    with step_timer("categories", sink):
        if product_category is not None:
            cat_orig, cat_new = _split(product_category, incremental_frac)
            ci = CategoryInfo(pid.convert_df(cat_orig.copy()))
            if cat_new is not None:
                ci.update(pid.convert_df(cat_new.copy()))
            pci = ProductCategoryInfo(ci.product_category_df, n_product=n_product, n_category=ci.n_categories)
            prod_categories = padded_categories(pci)

    with step_timer("write", sink):
        write_artifacts(
            out_dir,
            suffix=suffix,
            user_categorical=None if cc is None else cc.get_feature(),
            item_categorical=None if pc is None else pc.get_feature(),
            user_numeric=user_numeric,
            item_numeric=item_numeric,
            item_sentence=tf.sentence_embedding,
            user_text_vecs=user_vecs,
            item_text_vecs=item_vecs,
            item_review_vec=review_vec,
            product_categories=prod_categories,
        )

    with step_timer("split", sink):
        cf_dir = Path(out_dir) / "cf" / suffix if suffix else Path(out_dir) / "cf"
        cf_dir.mkdir(parents=True, exist_ok=True)
        _write_split(cf_dir, suffix, tinfo.df["cf_customer"], tinfo.df["cf_product"], n_customer, test_holdout)

    return {
        "out_dir": str(out_dir),
        "n_product": n_product,
        "n_customer": n_customer,
        "n_transaction": tinfo.n_transaction,
        "incremental_updates": int(incremental_frac > 0),
        "item_categorical_shape": None if pc is None else list(pc.get_feature().shape),
        "user_categorical_shape": None if cc is None else list(cc.get_feature().shape),
        "text_vocab": int(item_vecs["name"].shape[1]),
        "has_reviews": review_vec is not None,
        "has_categories": prod_categories is not None,
    }
