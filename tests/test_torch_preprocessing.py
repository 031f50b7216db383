"""Port vs JAX package: the preprocessing modules on the CPU.

The same numpy columns go through both packages: DataFrames for the JAX
package, ``preprocessing.frame.Frame`` for the port. Tolerances:

- ids, codes, counts, the numeric features (float16), the padded categories,
  the sentence embeddings (one process, so one ``hash`` salt) and every
  ``.npy`` artifact: equal;
- the TF-IDF matrices against scikit-learn: vocabulary and sparsity pattern
  equal, values within rtol 1e-12 (scikit-learn's Cython l2 norm sums a row
  in another order than numpy);
- the CSV reader's kinds and values against ``pd.read_csv``, the writer's
  bytes against ``DataFrame.to_csv``: equal;
- the host C++ (``lev_ratio``, ``parse_adjacency``, ``cuckoo_build``): equal
  to the JAX package's C++ and to the plain versions.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from sklearn.feature_extraction.text import TfidfVectorizer as SkTfidf

from furusato_recommend_tpu.ops import cuckoo as jck
from furusato_recommend_tpu.preprocessing import (
    artifacts as jart,
    categorical as jcat,
    category as jcg,
    ids as jids,
    native as jnat,
    numeric as jnum,
    partner as jpart,
    pipeline as jpipe,
    text as jtext,
)
from furusato_recommend_tpu_torch.ops import cuckoo as tck
from furusato_recommend_tpu_torch.preprocessing import (
    artifacts as tart,
    categorical as tcat,
    category as tcg,
    frame as fr,
    ids as tids,
    native as tnat,
    numeric as tnum,
    partner as tpart,
    pipeline as tpipe,
    text as ttext,
    tfidf as ttf,
)
from furusato_recommend_tpu_torch.preprocessing.synthetic import synthetic_raw_tables

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_frame_equal(got: fr.Frame, want: pd.DataFrame):
    assert got.columns == [str(c) for c in want.columns]
    for c in want.columns:
        w = want[c].to_numpy()
        g = got[c]
        kind = "O" if w.dtype.kind in "OUT" else w.dtype.kind
        assert g.dtype.kind == kind, (c, g.dtype, want[c].dtype)
        if kind == "f":
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            assert [None if fr._is_nan(v) else v for v in g.tolist()] == \
                [None if (isinstance(v, float) and v != v) else v for v in w.tolist()], c


def _csr(m):
    m = sp.csr_matrix(m)
    m.sort_indices()
    return m


def _assert_csr_close(got, want, rtol=1e-12):
    got, want = _csr(got), _csr(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=0)


# -- frame: CSV and the operations ---------------------------------------------

CSV_TEXT = (
    "all_int,int_blank,floats,strings,all_blank,flags,na_words,cjk\n"
    "1,10,1.5,a,,True,NA,北海道産 いくら\n"
    "-2,,2,\"b,c\",,False,x,\"say \"\"hi\"\"\"\n"
    "3,30,1e3,,,True,null,\n"
    "\n"
    "40,40,-inf,d e,,False,,メロン\n"
)


def test_read_csv_kinds_match_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text(CSV_TEXT, encoding="utf-8")
    want = pd.read_csv(path)
    got = fr.read_csv(path)
    assert [got[c].dtype.kind for c in got.columns] == ["i", "f", "f", "O", "f", "b", "O", "O"]
    _assert_frame_equal(got, want)


def test_write_csv_bytes_match_pandas(tmp_path):
    cols = {
        "i": np.array([1, -2, 3], np.int64),
        "f": np.array([30.0, np.nan, 1.0 / 3.0]),
        "big": np.array([1e20, 1.5e-7, 0.1]),
        "s": np.array(["a,b", 'c"d', np.nan], dtype=object),
        "nl": np.array(["e\nf", " g", "北海道"], dtype=object),
    }
    fr.write_csv(fr.Frame(cols), tmp_path / "port.csv")
    pd.DataFrame(cols).to_csv(tmp_path / "jax.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    one = {"s": np.array(["x", np.nan], dtype=object)}  # a lone empty field is quoted
    fr.write_csv(fr.Frame(one), tmp_path / "p1.csv")
    pd.DataFrame(one).to_csv(tmp_path / "j1.csv", index=False)
    assert (tmp_path / "p1.csv").read_bytes() == (tmp_path / "j1.csv").read_bytes()
    back = fr.read_csv(tmp_path / "port.csv")
    _assert_frame_equal(back, pd.read_csv(tmp_path / "jax.csv"))


def test_frame_operations_match_pandas():
    rng = np.random.default_rng(0)
    cols = {
        "k": rng.integers(0, 6, 40),
        "f": np.where(rng.random(40) < 0.2, np.nan, rng.integers(0, 4, 40).astype(float)),
        "s": np.array([np.nan if r < 0.2 else f"v{int(10 * r)}" for r in rng.random(40)], dtype=object),
    }
    frame, df = fr.Frame(cols), pd.DataFrame(cols)
    for c in cols:  # unique: pd.unique less NaN, in order of first appearance
        want = [v for v in pd.unique(df[c]) if not pd.isna(v)]
        assert fr.unique(frame[c]) == want
        codes, uniq = fr.factorize(frame[c])
        wcodes, wuniq = pd.factorize(df[c])
        np.testing.assert_array_equal(codes, wcodes)
        assert list(uniq) == list(wuniq)
    mapping = {0: 10, 1: 11, 2: 12}
    for col in ("k", "f"):
        got, want = fr.map_values(frame[col], mapping), df[col].map(mapping).to_numpy()
        assert got.dtype == want.dtype, col
        np.testing.assert_array_equal(got, want)
    full = fr.map_values(np.array([0, 1, 2, 1]), mapping)
    assert full.dtype == pd.Series([0, 1, 2, 1]).map(mapping).dtype == np.int64
    _assert_frame_equal(frame.dropna(["f", "s"]), df.dropna(subset=["f", "s"]))
    _assert_frame_equal(frame.drop_duplicates("k"), df.drop_duplicates(subset="k", keep="last"))
    _assert_frame_equal(fr.Frame.concat([frame.iloc(slice(0, 7)), frame.iloc(slice(30, None))]),
                        pd.concat([df.iloc[:7], df.iloc[30:]]))
    # reindex onto arange(n) with ids missing: all-NaN rows, ints upcast to float64
    dedup = df.drop_duplicates(subset="k", keep="last").set_index("k", drop=False)
    _assert_frame_equal(frame.drop_duplicates("k").reindex("k", 9),
                        dedup.reindex(np.arange(9)))
    # a left join that keeps the left rows' order; a name in both sides suffixed
    right = {"k": np.array([4, 0, 2, 5], np.int64), "name": np.array(["d", "a", "b", "e"], dtype=object),
             "f": np.array([0.5, 1.5, 2.5, 3.5]), "n": np.array([1, 2, 3, 4], np.int64)}
    _assert_frame_equal(frame.merge_left(fr.Frame(right), on="k"),
                        pd.merge(df, pd.DataFrame(right), on="k", how="left"))
    every = {"k": np.arange(6, dtype=np.int64), "n": np.arange(6, dtype=np.int64) * 7}
    _assert_frame_equal(frame.merge_left(fr.Frame(every), on="k"),
                        pd.merge(df, pd.DataFrame(every), on="k", how="left"))


def test_read_table_pkl_needs_pandas(tmp_path):
    df = pd.DataFrame({"a": [1, 2], "b": ["x", None], "c": [0.5, np.nan]})
    df.to_pickle(tmp_path / "t.pkl")
    _assert_frame_equal(fr.read_table(str(tmp_path / "t.pkl")), df)
    code = ("import sys; sys.modules['pandas'] = None\n"
            "from furusato_recommend_tpu_torch.preprocessing.frame import read_table\n"
            f"read_table({str(tmp_path / 't.pkl')!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "needs pandas" in out.stderr, out.stderr[-2000:]


# -- host C++ ------------------------------------------------------------------


def _strings(rng, n):
    alphabet = list("abcxyz ") + list("北海道産いくらメロン") + ["\U0001F600"]
    out = ["", "", "a", "北"]
    for _ in range(n):
        out.append("".join(rng.choice(alphabet, size=rng.integers(0, 24))))
    return out


def test_lev_ratio_matches_jax_and_plain():
    rng = np.random.default_rng(1)
    names = _strings(rng, 60)
    for a, b in zip(names[:-1], names[1:]):
        got = tnat.lev_ratio(a, b)
        assert got == jnat.lev_ratio(a, b) == tnat.lev_ratio_reference(a, b), (a, b)
    np.testing.assert_array_equal(tnat.lev_ratio_consecutive(names), jnat.lev_ratio_consecutive(names))
    np.testing.assert_array_equal(tnat.lev_ratio_consecutive(names), tnat.lev_ratio_consecutive_reference(names))
    assert tnat.lev_ratio("Melon 2pc", "Melon 2pcs") >= 0.9
    assert tnat.lev_ratio_consecutive([]).shape == (0,)


def test_parse_adjacency_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    lines = [" ".join(map(str, [u, *rng.integers(0, 10**6, rng.integers(0, 9))])) for u in range(200)]
    well = tmp_path / "well.txt"
    well.write_text("\n".join(lines) + "\n")
    for path in (well,):
        got, want = tnat.parse_adjacency_text(path), jnat.parse_adjacency_text(path)
        ref = tnat.parse_adjacency_reference(path)
        for g, w, r in zip(got, want, ref):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, r)
    junk = tmp_path / "junk.txt"
    junk.write_bytes(b"\r\n0 1 2\r\n\n x 5\n3 4 ,5  6\n7")
    for g, w in zip(tnat.parse_adjacency_text(junk), jnat.parse_adjacency_text(junk)):
        np.testing.assert_array_equal(g, w)
    empty = tmp_path / "empty.txt"
    empty.write_bytes(b"")
    assert all(len(a) == 0 for a in tnat.parse_adjacency_text(empty))


def test_cuckoo_build_matches_plain_and_jax():
    rng = np.random.default_rng(3)
    u, v = rng.integers(0, 5000, 3000), rng.integers(0, 4000, 3000)
    fps = np.ascontiguousarray(tck._fingerprints(u, v))
    for size in (1024, 4096, 16384):  # 1024 and 4096 strand keys: the build doubles past them
        got, want = np.zeros(size, np.uint32), np.zeros(size, np.uint32)
        assert tnat.cuckoo_build(fps, got, 500) == tck._build_numpy(fps, want, 500)
        np.testing.assert_array_equal(got, want)
    assert tnat.cuckoo_build(fps, np.zeros(1024, np.uint32), 500) > 0
    cs = tck.build_cuckoo_set(u, v, load=0.9)  # starts at 4096: needs a doubling
    assert cs.mask + 1 > 4096
    jcs = jck.build_cuckoo_set(u, v, load=0.9)
    assert cs.mask == jcs.mask
    np.testing.assert_array_equal(cs.table.numpy(), np.asarray(jcs.table).astype(np.int64))
    with pytest.raises(TypeError):
        tnat.cuckoo_build(fps.astype(np.int64), np.zeros(16, np.uint32), 500)
    with pytest.raises(ValueError):
        tnat.cuckoo_build(fps, np.zeros(1000, np.uint32), 500)


# -- ids, partner, categorical, category, numeric ------------------------------


def _products(parent_kind: str):
    names = ["Wagyu beef set", "Wagyu beef set", "Melon 2pc", "Melon 2pcs", "Rice 10kg", "Rice 10kg X",
             "Sake 720ml", "Apple juice", "Apple juice 1L", "Tea", "Tea leaves 100g"]
    n = len(names)
    parents = np.array([np.nan, np.nan, 7.0, np.nan, np.nan, np.nan, 7.0, np.nan, 9.0, 9.0, np.nan])
    if parent_kind == "int":  # no blank: pandas reads int64 and no parent merge happens
        parents = np.array([1, 2, 7, 3, 4, 5, 7, 6, 9, 9, 8], np.int64)
    return {
        "product_id": 100 + np.arange(n),
        "name": np.array(names, dtype=object),
        "minimum_donation_price": np.array([10000, 10000, 8000, 8200, 12000, 12500, 3000, 5000, 5200, 900, 1000]),
        "parent_product_id": parents,
        "partner_id": np.array([1, 1, 2, 2, 3, 3, 4, 1, 2, 3, 4]),
    }


@pytest.mark.parametrize("parent_kind", ["float", "int"])
def test_product_ids_match_jax(parent_kind, tmp_path):
    cols = _products(parent_kind)
    pd.DataFrame(cols).to_csv(tmp_path / "p.csv", index=False)
    frame = fr.read_csv(tmp_path / "p.csv")  # the CSV reader decides the parent rule
    assert frame["parent_product_id"].dtype.kind == ("f" if parent_kind == "float" else "i")
    df = pd.read_csv(tmp_path / "p.csv")
    got, want = tids.ProductIDInfo(frame.iloc(slice(0, 7))), jids.ProductIDInfo(df.iloc[:7])
    np.testing.assert_array_equal(got._remapped_ids, want._remapped_ids)
    got.update(frame.iloc(slice(7, None)))
    want.update(df.iloc[7:])
    np.testing.assert_array_equal(got._remapped_ids, want._remapped_ids)
    assert got.n_product == want.n_product and got.previous_max_id == want._previous_max_id
    assert got.productid_converter == want.productid_converter
    _assert_frame_equal(got.experiment_df, want.experiment_df.reset_index(drop=True))
    for unseen in (False, True):
        _assert_frame_equal(got.get_new_experiment_df(unseen), want.get_new_experiment_df(unseen).reset_index(drop=True))
    merged = parent_kind == "float" and got._remapped_ids[6] == got._remapped_ids[2]
    assert merged == (parent_kind == "float")


def test_customers_time_and_transactions_match_jax():
    births = np.array(["03/15/1985 10:00:00 AM", np.nan, "01/02/1930 00:00:00 PM", "12/31/2030 00:00:00 AM",
                       "no date"], dtype=object)
    cols = {"customer_id": np.array(["a", "b", "c", "d", "e"], dtype=object), "birth_year": births}
    got = tids.TimeProcessing(fr.Frame(cols).copy()).transform()
    want = jids.TimeProcessing(pd.DataFrame(cols)).transform()
    _assert_frame_equal(got, want)
    full = {"customer_id": cols["customer_id"][:2], "birth_year": births[[0, 2]]}
    _assert_frame_equal(tids.TimeProcessing(fr.Frame(full)).transform(),
                        jids.TimeProcessing(pd.DataFrame(full)).transform())
    info, jinfo = tids.CustomerIDInfo(fr.Frame(cols)), jids.CustomerIDInfo(pd.DataFrame(cols))
    info.update(fr.Frame({"customer_id": np.array(["f"], dtype=object)}))
    jinfo.update(pd.DataFrame({"customer_id": ["f"]}))
    assert info.n_customer == jinfo.n_customer == 6
    t = tids.TransactionInfo(fr.Frame({"cf_customer": [0], "cf_product": [1]}))
    t.update(fr.Frame({"cf_customer": [1, 2], "cf_product": [0, 1]}))
    assert t.n_transaction == 3
    np.testing.assert_array_equal(t.df["cf_customer"], [0, 1, 2])


def test_partner_merge_matches_jax():
    cols = _products("float")
    partner = {"partner_id": np.array([1, 2, 3]), "head_office_pref": np.array(["h", "a", "o"], dtype=object),
               "head_office_addr01": np.array(["x", np.nan, "z"], dtype=object)}
    got = tpart.PartnerMerge(fr.Frame(partner)).transform(fr.Frame(cols))
    want = jpart.PartnerMerge(pd.DataFrame(partner)).transform(pd.DataFrame(cols))
    _assert_frame_equal(got, want)


def test_categorical_features_match_jax():
    cols = {"cf_product": np.arange(5), "head_office_pref": np.array(["h", "a", "h", np.nan, "o"], dtype=object),
            "head_office_addr01": np.array(["x", np.nan, "y", "x", np.nan], dtype=object),
            "age": np.array([30.0, np.nan, 41.0, 30.0, 7.0])}
    got = tcat.CategoricalFeature(fr.Frame(cols), ["head_office_pref", "head_office_addr01", "age"], "cf_product")
    want = jcat.CategoricalFeature(pd.DataFrame(cols), ["head_office_pref", "head_office_addr01", "age"], "cf_product")
    np.testing.assert_array_equal(got.get_feature(), want.get_feature())
    new = {"cf_product": np.array([5, 7]), "head_office_pref": np.array(["okinawa", "a"], dtype=object),
           "head_office_addr01": np.array(["x", "zz"], dtype=object), "age": np.array([41.0, 99.0])}
    got.update(fr.Frame(new))
    want.update(pd.DataFrame(new))
    np.testing.assert_array_equal(got.get_feature(), want.get_feature())
    assert got.vocab_size == want.vocab_size
    empty = {"cf_product": np.arange(2), "c": np.array([np.nan, np.nan])}
    np.testing.assert_array_equal(tcat.CategoricalFeature(fr.Frame(empty), ["c"], "cf_product").get_feature(),
                                  jcat.CategoricalFeature(pd.DataFrame(empty), ["c"], "cf_product").get_feature())


def test_category_membership_matches_jax():
    cat = {"cf_product": np.array([0, 0, 1, np.nan, 3, 0]),
           "category_id": np.array(["meat", "sea", "meat", "meat", np.nan, "sea"], dtype=object)}
    ci, jci = tcg.CategoryInfo(fr.Frame(cat)), jcg.CategoryInfo(pd.DataFrame(cat))
    new = {"cf_product": np.array([2, 1]), "category_id": np.array(["fruit", "sea"], dtype=object)}
    ci.update(fr.Frame(new))
    jci.update(pd.DataFrame(new))
    assert ci.n_categories == jci.n_categories
    _assert_frame_equal(ci.product_category_df, jci.product_category_df.reset_index(drop=True))
    pci = tcg.ProductCategoryInfo(ci.product_category_df, n_product=5, n_category=ci.n_categories)
    jpci = jcg.ProductCategoryInfo(jci.product_category_df, n_product=5, n_category=jci.n_categories)
    conv = {100: 4, 101: 2}
    raw = {"product_id": np.array([100, 101, 999]), "category_id": np.array([1.0, 0.0, 2.0])}
    pci.update(fr.Frame(raw), conv)
    jpci.update(pd.DataFrame(raw), conv)
    np.testing.assert_array_equal(pci.coo.toarray(), jpci.coo.toarray())
    assert pci.category_sets() == jpci.category_sets()
    for pad_to in (None, 1, 4):
        np.testing.assert_array_equal(tcg.padded_categories(pci, pad_to), jcg.padded_categories(jpci, pad_to))


def test_numeric_features_match_jax():
    rng = np.random.default_rng(4)
    products = {"cf_product": np.arange(30),
                "pref": np.array([np.nan if r < 0.1 else f"p{int(r * 7)}" for r in rng.random(30)], dtype=object),
                "addr": rng.integers(0, 5, 30)}
    tx = {"cf_customer": rng.integers(0, 12, 200), "cf_product": rng.integers(0, 33, 200)}
    got = tnum.CustomerNumericFeature(12, fr.Frame(products), ["pref", "addr"])
    want = jnum.CustomerNumericFeature(12, pd.DataFrame(products), ["pref", "addr"])
    got.initialize(fr.Frame(tx).iloc(slice(0, 150)))
    want.initialize(pd.DataFrame(tx).iloc[:150])
    np.testing.assert_array_equal(got.get_feature(), want.get_feature())
    more = {"cf_product": np.arange(30, 33), "pref": np.array(["p1", "new", np.nan], dtype=object),
            "addr": np.array([1, 9, 2])}
    got.update_info(14, fr.Frame(more))
    want.update_info(14, pd.DataFrame(more))
    got.update_counter(fr.Frame(tx).iloc(slice(150, None)))
    want.update_counter(pd.DataFrame(tx).iloc[150:])
    feat = got.get_feature()
    assert feat.dtype == np.float16 and feat.shape[0] == 14
    np.testing.assert_array_equal(feat, want.get_feature())


# -- text and TF-IDF -------------------------------------------------------------


def _sk(docs, **kw):
    vec = SkTfidf(**kw)
    return vec, vec.fit_transform(docs)


def _docs(rng, n, vocab):
    return [" ".join(rng.choice(vocab, size=rng.integers(0, 12))) for _ in range(n)]


@pytest.mark.parametrize("case", ["default", "tie_at_cut", "max_df", "cjk_singles"])
def test_tfidf_matches_sklearn(case):
    rng = np.random.default_rng(5)
    vocab = ["wagyu", "melon", "rice", "北海", "海道", "道産", "いく", "くら", "a", "北", "x9", "beef", "set"]
    docs = _docs(rng, 40, vocab) + [""]
    kw = {"default": dict(max_df=0.5, min_df=1, max_features=50000),
          "tie_at_cut": dict(max_df=1.0, min_df=1, max_features=4),
          "max_df": dict(max_df=0.3, min_df=11),
          "cjk_singles": dict(max_df=0.5, min_df=1)}[case]
    if case == "tie_at_cut":  # equal corpus counts at the cut: the argsort decides
        docs = ["aa bb cc dd ee", "aa bb cc dd ee", "ff gg", "ff gg hh"]
        counts = sorted((sum(d.split().count(w) for d in docs) for w in set(" ".join(docs).split())),
                        reverse=True)
        assert counts[3] == counts[4]  # seven terms tie at 2 across the cut at 4
        sk, skx = _sk(docs, **kw)
    elif case == "cjk_singles":
        docs = ["北 海 道 北海 海道", "い く ら いく くら", "米 a b ab", "北海 ab"]
        sk, skx = _sk(docs, **kw)
    else:
        sk, skx = _sk(docs, **kw)
    port = ttf.TfidfVectorizer(**kw)
    got = port.fit(docs).transform(docs)
    assert port.vocabulary_ == {k: int(v) for k, v in sk.vocabulary_.items()}
    np.testing.assert_array_equal(port.idf_, sk.idf_)
    _assert_csr_close(got, skx)
    new = _docs(np.random.default_rng(6), 10, vocab + ["unseen"])
    _assert_csr_close(port.transform(new), sk.transform(new))


def test_tfidf_raises_as_sklearn():
    for docs, kw in ((["a b", "c"], dict()), (["aa bb", "aa bb", "aa bb"], dict(max_df=0.5))):
        with pytest.raises(ValueError) as want:
            SkTfidf(**kw).fit(docs)
        with pytest.raises(ValueError) as got:
            ttf.TfidfVectorizer(**kw).fit(docs)
        assert str(got.value) == str(want.value)


def test_tokenizer_and_text_features_match_jax():
    for t in ["北海道産いくら醤油漬け", "Ｗａｇｙｕ・セット (5kg)!", "甘い", "a", "", "ゃ〜ーあ", "Mix 北海 x"]:
        assert ttext._fallback_tokenize(t) == jtext._fallback_tokenize(t)
        assert ttext.join_nouns(t) == jtext.join_nouns(t)
    assert ttext.join_nouns(np.nan) is None and jtext.join_nouns(np.nan) is None
    raw = synthetic_raw_tables(seed=3, n_customers=60, n_products=50, n_unique=40, n_partners=9,
                               n_categories=6, n_reviews=80)
    prods = fr.Frame(raw.tables["products"])
    df = pd.DataFrame(raw.tables["products"])
    got, want = ttext.ProductTextFeature(prods.iloc(slice(0, 35))), jtext.ProductTextFeature(df.iloc[:35])
    got.update(prods.iloc(slice(35, None)))
    want.update(df.iloc[35:])
    for name in ("name_vec", "main_comment_vec", "main_list_comment_vec"):
        _assert_csr_close(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.sentence_embedding, want.sentence_embedding)
    assert got.tfidf_vectorizer.vocabulary_ == {k: int(v) for k, v in want.tfidf_vectorizer.vocabulary_.items()}
    rev = dict(raw.tables["reviews"])
    rev["cf_product"] = np.where(np.arange(len(rev["product_id"])) % 7 == 0, np.nan,
                                 rev["product_id"] % 50).astype(float)
    rf = ttext.ProductReviewFeature(prods, fr.Frame(rev).iloc(slice(0, 60)), got.tfidf_vectorizer)
    jrf = jtext.ProductReviewFeature(df, pd.DataFrame(rev).iloc[:60], want.tfidf_vectorizer)
    rf.update_info(52)
    jrf.update_info(52)
    rf.update_feature(fr.Frame(rev).iloc(slice(60, None)))
    jrf.update_feature(pd.DataFrame(rev).iloc[60:])
    np.testing.assert_array_equal(rf.review_cnt, jrf.review_cnt)
    np.testing.assert_array_equal(rf.review_rate_mean, jrf.review_rate_mean)
    assert rf._texts == jrf._texts and rf._tokenized == jrf._tokenized
    _assert_csr_close(rf.get_tfidf_vec(), jrf.get_tfidf_vec())


# -- artifacts and the pipeline --------------------------------------------------


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(d, f)
    return out


def assert_artifacts_equal(got_dir, want_dir):
    """Every file of the JAX package's directory in the port's: .npy equal,
    pickled matrices of equal pattern within rtol 1e-12, the rest byte-equal."""
    got, want = _tree(got_dir), _tree(want_dir)
    assert sorted(got) == sorted(want)
    for rel, w in want.items():
        g = got[rel]
        if rel.endswith(".npy"):
            a, b = np.load(g), np.load(w)
            assert a.dtype == b.dtype and a.shape == b.shape, rel
            np.testing.assert_array_equal(a, b, err_msg=rel)
        elif rel.endswith(".pkl"):
            with open(g, "rb") as fg, open(w, "rb") as fw:
                a, b = pickle.load(fg), pickle.load(fw)
            assert type(a) is type(b), rel
            if sp.issparse(b):
                _assert_csr_close(a, b)
            else:
                np.testing.assert_array_equal(a, b, err_msg=rel)
        elif rel.endswith(".pt"):
            assert torch.equal(torch.load(g), torch.load(w)), rel
        else:
            assert open(g, "rb").read() == open(w, "rb").read(), rel


def test_write_artifacts_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    mats = {f: sp.random(8, 30, density=0.2, format="csr", random_state=1) for f in ["name", "main_comment"]}
    kw = dict(
        user_categorical=rng.integers(0, 5, (10, 3)), item_categorical=rng.integers(0, 7, (8, 2)),
        user_numeric=rng.random((10, 6)).astype(np.float16), item_sentence=rng.random((8, 768)).astype(np.float32),
        user_text_vecs=mats, item_text_vecs=mats, item_review_vec=mats["name"],
        product_categories=rng.integers(-1, 5, (8, 3)).astype(np.int32),
        user_bert=rng.random((10, 4)).astype(np.float32), buy_timestamp=sp.random(10, 8, density=0.3, format="csr"),
        user_attribute=rng.integers(0, 5, (2, 12)), favorite_edges=(rng.integers(0, 10, 9), rng.integers(0, 8, 9)),
        review_edges=(rng.integers(0, 10, 4), rng.integers(0, 8, 4)),
    )
    for suffix in ("", "all"):
        tart.write_artifacts(tmp_path / "port", suffix, **kw)
        jart.write_artifacts(tmp_path / "jax", suffix, **kw)
    assert_artifacts_equal(tmp_path / "port", tmp_path / "jax")


def small_tables(seed=11):
    return synthetic_raw_tables(seed=seed, n_customers=150, n_products=90, n_unique=75, n_partners=20,
                                n_categories=8, n_reviews=120)


@pytest.mark.parametrize("frac", [0.0, 0.2])
@pytest.mark.parametrize("extras", ["all", "none"])
def test_run_preprocessing_matches_jax(tmp_path, frac, extras):
    raw = small_tables()
    paths = raw.write_csv(tmp_path / "raw")
    got_t = {k: fr.read_csv(p) for k, p in paths.items()}
    want_t = {k: pd.read_csv(p) for k, p in paths.items()}
    opt = ("category", "partner", "reviews") if extras == "all" else ()

    def kw(t):
        return dict(product_category=t["category"] if "category" in opt else None,
                    partner=t["partner"] if "partner" in opt else None,
                    reviews=t["reviews"] if "reviews" in opt else None, incremental_frac=frac, test_holdout=2)

    timer = {}

    class Sink:
        def log(self, m, step=None):
            timer.update(m)

    got = tpipe.run_preprocessing(got_t["products"], got_t["customers"], got_t["transactions"],
                                  str(tmp_path / "port"), sink=Sink(), **kw(got_t))
    want = jpipe.run_preprocessing(want_t["products"], want_t["customers"], want_t["transactions"],
                                   str(tmp_path / "jax"), **kw(want_t))
    assert {k: v for k, v in got.items() if k != "out_dir"} == {k: v for k, v in want.items() if k != "out_dir"}
    assert got["n_product"] == raw.n_unique_products
    assert sorted(timer) == sorted(f"time/{s}" for s in tpipe.STAGES)
    assert_artifacts_equal(tmp_path / "port", tmp_path / "jax")
    # the inputs are left as they were
    for k, p in paths.items():
        _assert_frame_equal(got_t[k], pd.read_csv(p))
