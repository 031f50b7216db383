"""Port vs JAX package: the SAGE family's side features
(``data/features.py``).

- ``synthetic_features`` draws the same numpy stream in both packages: every
  array bit-equal, with and without the review field and the edge arrays;
- ``load_reference_features`` reads the same arrays from the same artifacts
  (``.npy`` files, pickled scipy CSR count matrices, a ``.pt`` tensor),
  written tiny to ``tmp_path``;
- the padded text rows, and moving a store to a device;
- the structured generators (``synthetic_zipf_dataset``,
  ``structured_latents``, ``synthetic_structured_dataset`` over several
  Gumbel chunks) and ``informative_synthetic_features`` bit-equal;
- the out-of-core loader's arguments (``skip_numeric``,
  ``numeric_artifact_paths``) and the per-edge purchase times.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data import features as jfeat
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data import features as tfeat

torch.set_num_threads(1)

SIDE_FIELDS = [f.name for f in dataclasses.fields(tfeat.SideFeatures)]


def _assert_stores_equal(got, want):
    for side in ("user", "item"):
        for name in SIDE_FIELDS:
            a, b = getattr(getattr(got, side), name), getattr(getattr(want, side), name)
            assert (a is None) == (b is None), (side, name)
            if a is not None:
                assert a.numpy().dtype == np.asarray(b).dtype, (side, name)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{side}.{name}")
    for name in ("user_cat_vocab", "item_cat_vocab", "text_vocab", "n_relations"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("edge_time", "edge_label"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize(
    "item_feature,edge_arrays",
    [("nwt", False), ("nctwsrb", False), ("nwt", True), ("ncr", True)],
)
def test_synthetic_features_bit_equal(item_feature, edge_arrays):
    kw = dict(user_feature="nctw", item_feature=item_feature)
    jd = jds.synthetic_dataset(n_users=50, m_items=70, avg_degree=6, seed=3)
    td = tds.synthetic_dataset(n_users=50, m_items=70, avg_degree=6, seed=3)
    opts = dict(seed=5, with_edge_time=edge_arrays, with_edge_label=edge_arrays)
    want = jfeat.synthetic_features(jd, JConfig(**kw), **opts)
    got = tfeat.synthetic_features(td, Config(**kw), **opts)
    _assert_stores_equal(got, want)
    # the review field follows the JAX package's rule: entities == m_items
    assert got.item.text.shape[1] == (4 if "r" in item_feature else 3)
    assert got.user.text.shape[1] == 3


def test_review_field_decided_by_entity_count():
    """A user side with as many users as items also gets the review field
    (the JAX package decides by n == m_items)."""
    kw = dict(user_feature="t", item_feature="tr")
    jd = jds.synthetic_dataset(n_users=40, m_items=40, avg_degree=5, seed=1)
    td = tds.synthetic_dataset(n_users=40, m_items=40, avg_degree=5, seed=1)
    want = jfeat.synthetic_features(jd, JConfig(**kw), seed=2, text_width=6)
    got = tfeat.synthetic_features(td, Config(**kw), seed=2, text_width=6)
    _assert_stores_equal(got, want)
    assert got.user.text.shape == (40, 4, 6)


def _count_matrix(rng, n, vocab):
    dense = (rng.random((n, vocab)) < 0.08) * rng.integers(1, 4, (n, vocab))
    dense[0] = 0  # an entity without words
    return sp.csr_matrix(dense)


def _write_artifacts(base, sfx, n_users, m_items, vocab=30, seed=0):
    rng = np.random.default_rng(seed)
    cb = base / "cb" / sfx if sfx else base / "cb"
    tx = base / "text" / sfx if sfx else base / "text"
    cb.mkdir(parents=True)
    tx.mkdir(parents=True)
    np.save(cb / f"customer_feature_pad{sfx}.npy", rng.integers(0, 7, (n_users, 3)))
    np.save(cb / f"product_feature_pad{sfx}.npy", rng.integers(0, 9, (m_items, 4)))
    np.save(cb / f"user_numeric_feature{sfx}.npy", rng.random((n_users, 5)))
    np.save(cb / f"product_numeric_feature{sfx}.npy", rng.random((m_items, 6)).astype(np.float32))
    np.save(cb / f"product_sentence_emb{sfx}.npy", rng.standard_normal((m_items, 8)))
    np.save(tx / f"user_text_emb{sfx}.npy", rng.standard_normal((n_users, 300)))
    np.save(tx / f"product_text_emb{sfx}.npy", rng.standard_normal((m_items, 300)).astype(np.float32))
    torch.save(torch.from_numpy(rng.standard_normal((n_users, 12)).astype(np.float32)),
               tx / f"customer_deberta_feature{sfx}.pt")
    torch.save(torch.from_numpy(rng.standard_normal((m_items, 12)).astype(np.float32)),
               tx / f"product_deberta_feature{sfx}.pt")
    for prefix, n in (("user", n_users), ("product", m_items)):
        for field in ("name", "main_comment", "main_list_comment"):
            with open(tx / f"{prefix}_{field}_count{sfx}.pkl", "wb") as f:
                pickle.dump(_count_matrix(rng, n, vocab), f)
    with open(tx / f"product_review{sfx}.pkl", "wb") as f:
        pickle.dump(_count_matrix(rng, m_items, vocab), f)


@pytest.mark.parametrize(
    "sfx,user_feature,item_feature",
    [("", "nctwb", "nctwsrb"), ("_v2", "nwt", "nwt"), ("", "cb", "sr")],
)
def test_load_reference_features_equal(tmp_path, sfx, user_feature, item_feature):
    _write_artifacts(tmp_path, sfx, n_users=20, m_items=25)
    kw = dict(user_feature=user_feature, item_feature=item_feature, suffix=sfx)
    want = jfeat.load_reference_features(JConfig(**kw), str(tmp_path))
    got = tfeat.load_reference_features(Config(**kw), str(tmp_path))
    _assert_stores_equal(got, want)
    if "t" in user_feature:
        assert got.user.text.shape == (20, 3, 64) and got.text_vocab == 30


def test_pad_text_rows_and_csr_rows_match_jax():
    rows = [[3, 1, 4], [], list(range(10))]
    np.testing.assert_array_equal(tfeat.pad_text_rows(rows, 5), jfeat.pad_text_rows(rows, 5))
    mat = _count_matrix(np.random.default_rng(1), 12, 40)
    np.testing.assert_array_equal(tfeat.text_from_scipy_csr(mat, 7), jfeat.text_from_scipy_csr(mat, 7))


def test_store_moves_and_counts_entities():
    td = tds.synthetic_dataset(n_users=30, m_items=20, avg_degree=5, seed=0)
    fs = tfeat.synthetic_features(td, Config(), seed=0, with_edge_time=True)
    moved = fs.to("cpu")
    assert moved.user.n_entities == 30 and moved.item.n_entities == 20
    np.testing.assert_array_equal(moved.edge_time.numpy(), fs.edge_time.numpy())
    with pytest.raises(ValueError, match="empty"):
        tfeat.SideFeatures().n_entities


def _assert_datasets_equal(got, want):
    assert (got.n_users, got.m_items) == (want.n_users, want.m_items)
    for name in ("train_user", "train_item", "test_user", "test_item"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize(
    "gen,kw",
    [
        ("synthetic_zipf_dataset", dict(n_users=400, m_items=300, avg_degree=6, seed=4)),
        ("synthetic_zipf_dataset", dict(n_users=50, m_items=20, avg_degree=12, seed=1, popularity_alpha=0.8)),
        # 300 users in chunks of 64: five Gumbel chunks, the last one short
        ("synthetic_structured_dataset", dict(n_users=300, m_items=150, avg_degree=8, seed=2, chunk=64)),
        ("synthetic_structured_dataset", dict(n_users=120, m_items=90, avg_degree=5, seed=0, rank=8,
                                              signal=2.0, popularity_alpha=1.1)),
    ],
)
def test_generators_bit_equal(gen, kw):
    _assert_datasets_equal(getattr(tds, gen)(**kw), getattr(jds, gen)(**kw))


def test_structured_latents_bit_equal_and_first_in_the_dataset_stream():
    for kw in (dict(seed=3), dict(seed=0, rank=4)):
        for a, b in zip(tds.structured_latents(70, 40, **kw), jds.structured_latents(70, 40, **kw)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    for a, b in zip(tds.structured_latents(10, 12, rng=rng_t), jds.structured_latents(10, 12, rng=rng_j)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rng_t.random(3), rng_j.random(3))  # the streams go on alike


@pytest.mark.parametrize("item_feature,seed", [("nwt", 0), ("nctwsrb", 1)])
def test_informative_synthetic_features_bit_equal(item_feature, seed):
    kw = dict(user_feature="nctwb", item_feature=item_feature)
    opts = dict(n_users=80, m_items=60, avg_degree=6, seed=5, rank=8)
    jd, td = jds.synthetic_structured_dataset(**opts), tds.synthetic_structured_dataset(**opts)
    want = jfeat.informative_synthetic_features(jd, JConfig(**kw), dataset_seed=5, rank=8, seed=seed)
    got = tfeat.informative_synthetic_features(td, Config(**kw), dataset_seed=5, rank=8, seed=seed)
    _assert_stores_equal(got, want)
    assert got.item.text.shape[1] == (4 if "r" in item_feature else 3)


@pytest.mark.parametrize("sfx,user_feature,item_feature", [("", "nwt", "nwt"), ("_v2", "wt", "nc")])
def test_out_of_core_loader_arguments_match_jax(tmp_path, sfx, user_feature, item_feature):
    _write_artifacts(tmp_path, sfx, n_users=20, m_items=25)
    kw = dict(user_feature=user_feature, item_feature=item_feature, suffix=sfx, model="dask")
    assert tfeat.numeric_artifact_paths(Config(**kw), str(tmp_path)) == jfeat.numeric_artifact_paths(
        JConfig(**kw), str(tmp_path))
    want = jfeat.load_reference_features(JConfig(**kw), str(tmp_path), skip_numeric=True)
    got = tfeat.load_reference_features(Config(**kw), str(tmp_path), skip_numeric=True)
    _assert_stores_equal(got, want)
    assert got.user.numeric is None and got.item.numeric is None


@pytest.mark.parametrize("layout", ["sparse", "flat"])
def test_edge_times_aligned_as_jax(tmp_path, layout):
    _write_artifacts(tmp_path, "", n_users=20, m_items=25)
    jd = jds.synthetic_dataset(n_users=20, m_items=25, avg_degree=5, seed=2)
    td = tds.synthetic_dataset(n_users=20, m_items=25, avg_degree=5, seed=2)
    rng = np.random.default_rng(3)
    if layout == "sparse":
        ts = sp.csr_matrix((rng.random(td.train_size) + 1, (td.train_user, td.train_item)), shape=(20, 25))
    else:
        ts = rng.random(td.train_size)
    (tmp_path / "cf").mkdir()
    with open(tmp_path / "cf" / "buy_timestamp.pkl", "wb") as f:
        pickle.dump(ts, f)
    kw = dict(user_feature="w", item_feature="w", model="tgsrec")
    want = jfeat.load_reference_features(JConfig(**kw), str(tmp_path), dataset=jd)
    got = tfeat.load_reference_features(Config(**kw), str(tmp_path), dataset=td)
    _assert_stores_equal(got, want)
    assert got.edge_time.shape == (td.train_size,)
    with pytest.raises(ValueError, match="dataset="):
        tfeat.load_reference_features(Config(**kw), str(tmp_path))
