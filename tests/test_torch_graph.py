"""Port vs JAX package: config, synthetic data, graph arrays, text loading and
CSR search. Integer arrays must be equal; float weights within 1e-7."""

import dataclasses

import numpy as np
import pytest
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data import graph as jgraph
from furusato_recommend_tpu.ops import csr_search as jcs
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data import graph as tgraph
from furusato_recommend_tpu_torch.ops import csr_search as tcs

torch.set_num_threads(1)

_DS_FIELDS = ("train_user", "train_item", "test_user", "test_item")


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_config_json_reads_in_both():
    c = Config(model="radj", latent_dim=32, topks=(5, 50), compute_dtype="float32", r=0.3)
    j = JConfig.from_json(c.to_json())
    assert j.to_json() == c.to_json()
    back = Config.from_json(JConfig(model="mf", suffix="all").to_json())
    assert back == Config(model="mf", suffix="all")
    assert {f.name for f in dataclasses.fields(Config)} == {
        f.name for f in dataclasses.fields(JConfig)
    }


@pytest.mark.parametrize("seed,n,m,deg", [(0, 40, 60, 5), (7, 120, 180, 10)])
def test_synthetic_dataset_bit_equal(seed, n, m, deg):
    a = jds.synthetic_dataset(n_users=n, m_items=m, avg_degree=deg, seed=seed)
    b = tds.synthetic_dataset(n_users=n, m_items=m, avg_degree=deg, seed=seed)
    assert (a.n_users, a.m_items) == (b.n_users, b.m_items)
    for f in _DS_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _assert_graphs_equal(jg, tg):
    assert (jg.n_users, jg.m_items) == (tg.n_users, tg.m_items)
    for name in ("user_pos", "item_pos", "test_pos"):
        for part in ("indptr", "indices"):
            x = _np(getattr(getattr(jg, name), part))
            y = _np(getattr(getattr(tg, name), part))
            assert x.dtype == y.dtype, (name, part)
            np.testing.assert_array_equal(x, y, err_msg=f"{name}.{part}")
    np.testing.assert_array_equal(_np(jg.norm_edges.src), _np(tg.norm_edges.src))
    np.testing.assert_array_equal(_np(jg.norm_edges.dst), _np(tg.norm_edges.dst))
    np.testing.assert_allclose(
        _np(jg.norm_edges.weight), _np(tg.norm_edges.weight), rtol=1e-7, atol=0
    )
    np.testing.assert_array_equal(_np(jg.item_edge_perm), _np(tg.item_edge_perm))
    np.testing.assert_array_equal(_np(jg.user_pos_row), _np(tg.user_pos_row))
    assert jg.max_user_degree == tg.max_user_degree
    assert jg.max_test_degree == tg.max_test_degree


def test_build_bipartite_graph_equal():
    ds = jds.synthetic_dataset(n_users=120, m_items=180, avg_degree=10, seed=7)
    # duplicate interactions must be kept in the same order
    tu = np.concatenate([ds.train_user, ds.train_user[:9]])
    ti = np.concatenate([ds.train_item, ds.train_item[:9]])
    args = (tu, ti, ds.test_user, ds.test_item, ds.n_users, ds.m_items)
    jg = jgraph.build_bipartite_graph(*args, padded=False)
    tg = tgraph.build_bipartite_graph(*args)
    _assert_graphs_equal(jg, tg)


def _write_adjacency(path, rows):
    with open(path, "w") as f:
        for u, items in rows:
            f.write(f"{u} " + " ".join(map(str, items)) + "\n")


@pytest.fixture(scope="module")
def text_data(tmp_path_factory):
    """Adjacency files in the flat layout and under the "all" suffix."""
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("data")
    tr, te = [], []
    for u in range(0, 130, 1):
        items = rng.choice(90, size=int(rng.integers(3, 12)), replace=False).tolist()
        tr.append((u, items[:-2]))
        te.append((u, items[-2:]))
    flat = root / "flat" / "cf"
    flat.mkdir(parents=True)
    _write_adjacency(flat / "train.txt", tr)
    _write_adjacency(flat / "test.txt", te)
    allsfx = root / "all" / "cf" / "all"
    allsfx.mkdir(parents=True)
    _write_adjacency(allsfx / "trainall.txt", tr)
    _write_adjacency(allsfx / "testall.txt", te)
    inf = root / "inf" / "cf"
    inf.mkdir(parents=True)
    _write_adjacency(inf / "train.txt", tr)
    _write_adjacency(inf / "test.txt", te)
    _write_adjacency(inf / "inference.txt", [(u, items[:3]) for u, items in te + tr])
    return root


@pytest.mark.parametrize(
    "sub,kw",
    [
        ("flat", {}),
        ("flat", {"for_lgbm": True, "lgbm_ratio": 0.2}),
        ("flat", {"cold_start": True}),
        ("flat", {"test_mode": True}),
        ("all", {"suffix": "all"}),
        ("inf", {}),
    ],
)
def test_load_text_dataset_equal(text_data, sub, kw):
    path = str(text_data / sub)
    a = jds.load_text_dataset(JConfig(data_path=path, **kw))
    b = tds.load_text_dataset(Config(data_path=path, **kw))
    assert (a.n_users, a.m_items) == (b.n_users, b.m_items)
    for f in _DS_FIELDS + ("inference_user", "inference_item"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert b.has_inference_edges == (sub != "flat")
    if b.has_inference_edges:
        _assert_graphs_equal(
            jgraph.build_bipartite_graph(
                a.inference_user, a.inference_item, a.test_user, a.test_item,
                a.n_users, a.m_items, padded=False,
            ),
            b.inference_graph,
        )


def test_from_interactions_and_ragged_views():
    ds = jds.synthetic_dataset(n_users=30, m_items=40, avg_degree=5, seed=3)
    a = jds.Dataset.from_interactions(ds.train_user, ds.train_item, ds.test_user, ds.test_item)
    b = tds.Dataset.from_interactions(ds.train_user, ds.train_item, ds.test_user, ds.test_item)
    assert (a.n_users, a.m_items, a.train_size, a.test_size) == (
        b.n_users, b.m_items, b.train_size, b.test_size
    )
    for x, y in zip(a.all_pos(), b.all_pos()):
        np.testing.assert_array_equal(x, y)
    ta, tb = a.test_dict(), b.test_dict()
    assert ta.keys() == tb.keys()
    for u in ta:
        np.testing.assert_array_equal(ta[u], tb[u])


@pytest.fixture(scope="module")
def graphs():
    ds = jds.synthetic_dataset(n_users=50, m_items=70, avg_degree=6, seed=5)
    args = (ds.train_user, ds.train_item, ds.test_user, ds.test_item, ds.n_users, ds.m_items)
    return jgraph.build_bipartite_graph(*args, padded=False), tgraph.build_bipartite_graph(*args)


@pytest.mark.parametrize("max_row_len", [None, 16])
def test_csr_contains_bit_equal(graphs, max_row_len):
    jg, tg = graphs
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 50, size=(40, 1)).astype(np.int32)
    vals = rng.integers(0, 70, size=(1, 30)).astype(np.int32)
    want = np.asarray(jcs.csr_contains(jg.user_pos, rows, vals, max_row_len=max_row_len))
    got = tcs.csr_contains(
        tg.user_pos, torch.from_numpy(rows), torch.from_numpy(vals), max_row_len=max_row_len
    ).numpy()
    assert want.any()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("pad_to,fill", [(4, -1), (24, 70)])
def test_csr_gather_padded_bit_equal(graphs, pad_to, fill):
    jg, tg = graphs
    rows = np.arange(0, 50, 3, dtype=np.int32)
    jv, jm = jcs.csr_gather_padded(jg.user_pos, rows, pad_to, fill=fill)
    tv, tm = tcs.csr_gather_padded(tg.user_pos, torch.from_numpy(rows), pad_to, fill=fill)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    assert tv.dtype == torch.int32


def test_lower_bound_equal(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(9)
    lo = np.array(jg.user_pos.indptr)[:-1]
    hi = np.array(jg.user_pos.indptr)[1:]
    vals = rng.integers(0, 70, size=lo.shape).astype(np.int32)
    want = np.asarray(jcs.lower_bound(jg.user_pos.indices, lo, hi, vals))
    got = tcs.lower_bound(
        tg.user_pos.indices, torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(vals)
    ).numpy()
    np.testing.assert_array_equal(want, got)
