"""Port vs JAX package: the cuckoo membership set (bit-exact) and the BPR
sampler (``sampling/bpr.py``; held by its distribution, since torch cannot
reproduce JAX's threefry stream, in the style of tests/test_sampling.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.ops import cuckoo as jck
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.graph import build_bipartite_graph
from furusato_recommend_tpu_torch.ops import cuckoo as tck
from furusato_recommend_tpu_torch.sampling.bpr import sample_bpr

torch.set_num_threads(1)


def _u32(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    ends = [0, 1, (1 << 31), (1 << 32) - 1]  # the ends and keys >= 2^31
    x[: min(n, 4)] = ends[: min(n, 4)]
    return x


def test_fmix32_and_fingerprints_bit_exact():
    u, v = _u32(4096, 0), _u32(4096, 1)
    want_mix = np.asarray(jck._fmix32(jnp.asarray(u)))
    got_mix = tck._fmix32(torch.from_numpy(u.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got_mix, want_mix.astype(np.int64))
    want_fp = np.asarray(jck._fingerprints(jnp.asarray(u), jnp.asarray(v)))
    got_fp = tck._fingerprints(torch.from_numpy(u.astype(np.int64)), torch.from_numpy(v.astype(np.int64)))
    np.testing.assert_array_equal(got_fp.numpy(), want_fp.astype(np.int64))
    np.testing.assert_array_equal(tck._fingerprints(u, v), jck._fingerprints(u, v))
    assert (got_fp.numpy() != 0).all()


def test_builder_table_equals_jax_numpy_builder():
    ds = tds.synthetic_dataset(n_users=300, m_items=200, avg_degree=12, seed=3)
    fps = jck._fingerprints(ds.train_user, ds.train_item)
    size = 1 << max(int(np.ceil(np.log2(len(fps) / 0.35))), 4)
    want = np.zeros(size, dtype=np.uint32)
    assert jck._build_numpy(fps, want, 500) == 0
    got = tck.build_cuckoo_set(ds.train_user, ds.train_item)
    assert got.mask == size - 1
    np.testing.assert_array_equal(got.table.numpy(), want.astype(np.int64))


def test_cuckoo_contains_bit_exact_against_jax():
    ds = tds.synthetic_dataset(n_users=300, m_items=200, avg_degree=12, seed=4)
    cs = tck.build_cuckoo_set(ds.train_user, ds.train_item)
    jcs = jck.CuckooSet(table=jnp.asarray(cs.table.numpy().astype(np.uint32)), mask=cs.mask)
    rng = np.random.default_rng(5)
    qu = np.concatenate([ds.train_user, rng.integers(0, 300, 5000)]).astype(np.int32)
    qv = np.concatenate([ds.train_item, rng.integers(0, 200, 5000)]).astype(np.int32)
    want = np.asarray(jck.cuckoo_contains(jcs, jnp.asarray(qu), jnp.asarray(qv)))
    got = tck.cuckoo_contains(cs, torch.from_numpy(qu), torch.from_numpy(qv)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[: ds.train_size].all()  # no false negatives
    # broadcast form, as the sampler calls it, and keys >= 2^31
    u = torch.from_numpy(_u32(64, 6).astype(np.int64))
    v = torch.from_numpy(_u32(3, 7).astype(np.int64))
    got_b = tck.cuckoo_contains(cs, u[:, None], v[None, :])
    want_b = jck.cuckoo_contains(
        jcs, jnp.asarray(u.numpy().astype(np.uint32))[:, None], jnp.asarray(v.numpy().astype(np.uint32))[None, :]
    )
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


@pytest.fixture(scope="module")
def tiny():
    return tds.synthetic_dataset(n_users=120, m_items=180, avg_degree=10, seed=7)


def test_positives_are_positives_negatives_are_not(tiny):
    g = torch.Generator().manual_seed(0)
    batch = sample_bpr(g, tiny.graph, 4096, neg_candidates=4)
    assert batch.user.dtype == batch.pos.dtype == batch.neg.dtype == torch.int32
    ap = tiny.all_pos()
    assert batch.valid.all()
    for uu, pp, nn in zip(batch.user.tolist(), batch.pos.tolist(), batch.neg.tolist()):
        assert pp in ap[uu]
        assert nn not in ap[uu]


def test_user_and_positive_distribution(tiny):
    g = torch.Generator().manual_seed(1)
    batch = sample_bpr(g, tiny.graph, 60000)
    u = batch.user.numpy()
    freq = np.bincount(u, minlength=tiny.n_users) / len(u)
    np.testing.assert_allclose(freq, 1.0 / tiny.n_users, atol=0.004)
    # positives uniform within each row: pooled over users, the share of
    # draws at each position of the row is 1 / deg
    ip, ix = tiny.graph.user_pos.indptr.numpy(), tiny.graph.user_pos.indices.numpy()
    pos = batch.pos.numpy()
    slot = np.array([np.searchsorted(ix[ip[a] : ip[a + 1]], b) for a, b in zip(u, pos)])
    deg = ip[u + 1] - ip[u]
    np.testing.assert_allclose(np.mean(slot / (deg - 1)), 0.5, atol=0.01)
    # negatives uniform over each user's non-positives
    neg_freq = np.bincount(batch.neg.numpy(), minlength=tiny.m_items) / len(u)
    member = np.zeros((tiny.n_users, tiny.m_items))
    member[tiny.train_user, tiny.train_item] = 1.0
    want = np.mean((1.0 - member) / (1.0 - member).sum(1, keepdims=True), axis=0)
    np.testing.assert_allclose(neg_freq, want, atol=0.0015)


def test_zero_degree_users_masked_and_without_hash():
    # user 1 has no train interactions
    g = build_bipartite_graph(np.array([0, 0, 2]), np.array([0, 1, 2]), np.array([1]), np.array([0]), 3, 4)
    for graph in (g, dataclasses.replace(g, pos_hash=None)):
        batch = sample_bpr(torch.Generator().manual_seed(2), graph, 3000)
        u, v = batch.user.numpy(), batch.valid.numpy()
        assert not v[u == 1].any()
        assert v[u != 1].all()


def test_alias_recipes_raise(tiny):
    with pytest.raises(NotImplementedError):
        sample_bpr(torch.Generator(), tiny.graph, 10, edge_alias=object())
