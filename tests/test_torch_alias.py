"""Port vs JAX package: the weighted samplers of the ddp recipe and the fanout
neighbour sampler.

- ``build_alias_table``: prob and alias bit-equal to the JAX package's;
- the weight builders of ``sampling/weights.py``: equal to float64 precision
  (the same numpy arithmetic);
- draws, held by their distribution (torch cannot reproduce JAX's threefry
  stream): alias draws, ``sample_bpr`` with the edge and the negative alias,
  and ``sample_neighbors``, each by a chi-square statistic below the
  1 - 1e-6 quantile of its distribution (the draws are seeded, so the test
  is deterministic), in the style of ``tests/test_sampling.py``;
- every sampled neighbour lies in its node's row, ``indices[edge_pos] ==
  ids``, and zero-degree nodes are flagged.
"""

import pickle

import numpy as np
import pytest
import torch
from scipy import stats

from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.ops import alias as jalias
from furusato_recommend_tpu.sampling import weights as jw
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.graph import build_bipartite_graph
from furusato_recommend_tpu_torch.ops import alias as talias
from furusato_recommend_tpu_torch.sampling import weights as tw
from furusato_recommend_tpu_torch.sampling.bpr import sample_bpr
from furusato_recommend_tpu_torch.sampling.neighbor import sample_neighbors, sample_tree

torch.set_num_threads(1)

P_FLOOR = 1e-6


def _chi2_ok(observed, expected):
    keep = expected > 0
    assert observed[~keep].sum() == 0, "draws where the probability is 0"
    stat = float(np.sum((observed[keep] - expected[keep]) ** 2 / expected[keep]))
    dof = int(keep.sum()) - 1
    limit = stats.chi2.ppf(1 - P_FLOOR, dof)
    assert stat < limit, f"chi-square {stat:.1f} >= {limit:.1f} ({dof} dof)"


@pytest.fixture(scope="module")
def data():
    jd = jds.synthetic_dataset(n_users=120, m_items=180, avg_degree=10, seed=7)
    td = tds.synthetic_dataset(n_users=120, m_items=180, avg_degree=10, seed=7)
    return jd, td


@pytest.mark.parametrize("kind", ["random", "uniform", "one_hot", "zeros_inside", "large"])
def test_build_alias_table_bit_equal(kind):
    rng = np.random.default_rng(0)
    w = {
        "random": rng.random(257),
        "uniform": np.ones(64),
        "one_hot": np.eye(1, 40, 17)[0],
        "zeros_inside": np.where(rng.random(100) < 0.3, 0.0, rng.random(100) ** 3),
        "large": rng.pareto(1.2, 20000),
    }[kind]
    want = jalias.build_alias_table(w)
    got = talias.build_alias_table(w)
    assert got.prob.dtype == torch.float32 and got.alias.dtype == torch.int32
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))


def test_build_alias_table_rejects_bad_weights():
    for bad in (np.array([1.0, -0.5]), np.zeros(4)):
        with pytest.raises(ValueError):
            talias.build_alias_table(bad)


def test_alias_draws_follow_the_weights():
    rng = np.random.default_rng(1)
    w = np.where(rng.random(60) < 0.2, 0.0, rng.random(60) ** 2)
    tbl = talias.build_alias_table(w)
    gen = torch.Generator().manual_seed(2)
    draws = tbl.sample(gen, (400, 500)).numpy()
    assert draws.shape == (400, 500)
    n = draws.size
    _chi2_ok(np.bincount(draws.ravel(), minlength=60).astype(float), n * w / w.sum())


@pytest.mark.parametrize("num_draws,limit", [(15000, 150), (2_000_000, 3000), (50_000, 40)])
def test_capped_positive_edge_weights_equal(data, num_draws, limit):
    jd, td = data
    np.testing.assert_allclose(
        tw.capped_positive_edge_weights(td, num_draws, limit),
        jw.capped_positive_edge_weights(jd, num_draws, limit),
        rtol=1e-12, atol=0,
    )


@pytest.mark.parametrize("power", [0.0, 0.2, 0.5, 1.0])
def test_popularity_weights_equal(data, power):
    jd, td = data
    np.testing.assert_allclose(
        tw.popularity_positive_edge_weights(td, power), jw.popularity_positive_edge_weights(jd, power),
        rtol=1e-12, atol=0,
    )
    np.testing.assert_allclose(
        tw.popularity_negative_weights(td, power), jw.popularity_negative_weights(jd, power),
        rtol=1e-12, atol=0,
    )
    np.testing.assert_array_equal(
        tw.negative_alias(td, power).prob.numpy(), np.asarray(jw.negative_alias(jd, power).prob)
    )


@pytest.mark.parametrize("as_dict", [False, True])
def test_sample_prob_files_and_edge_weights_equal(tmp_path, data, as_dict):
    jd, td = data
    rng = np.random.default_rng(3)
    rows = [rng.dirichlet(np.ones(len(r))) for r in td.all_pos()]
    probs = {u: r for u, r in enumerate(rows)} if as_dict else rows
    (tmp_path / "sample_prob").mkdir()
    with open(tmp_path / "sample_prob" / "sample_prob_05.pkl", "wb") as f:
        pickle.dump(probs, f)
    got_probs = tw.load_sample_prob(str(tmp_path), 0.5)
    assert tw.load_sample_prob(str(tmp_path), 0.3) is None
    assert tw.load_sample_prob(str(tmp_path), 0.2) is None  # no such file
    np.testing.assert_allclose(
        tw.sample_prob_edge_weights(td, got_probs),
        jw.sample_prob_edge_weights(jd, jw.load_sample_prob(str(tmp_path), 0.5)),
        rtol=1e-12, atol=0,
    )
    with pytest.raises(ValueError, match="positives"):
        tw.sample_prob_edge_weights(td, rows[:-1] + [np.ones(1000) / 1000])


def test_sample_bpr_edge_alias_distribution(data):
    _, td = data
    g = td.graph
    w = tw.capped_positive_edge_weights(td, 30000, 300)
    alias = tw.edge_alias_from_weights(w)
    batch = sample_bpr(torch.Generator().manual_seed(4), g, 200_000, edge_alias=alias)
    assert batch.valid.all()
    ip, ix = g.user_pos.indptr.numpy(), g.user_pos.indices.numpy()
    u, p = batch.user.numpy().astype(np.int64), batch.pos.numpy().astype(np.int64)
    # the (user, item) pair of a draw is one edge of the user's row
    e = np.array([ip[a] + np.searchsorted(ix[ip[a]:ip[a + 1]], b) for a, b in zip(u[:3000], p[:3000])])
    np.testing.assert_array_equal(ix[e], p[:3000])
    # the edges' frequencies follow the weights: count by (user, item) key
    key = u * td.m_items + p
    edge_key = g.user_pos_row.numpy().astype(np.int64) * td.m_items + ix
    counts = np.bincount(np.searchsorted(edge_key, key), minlength=len(edge_key)).astype(float)
    _chi2_ok(counts, len(key) * w / w.sum())


def test_sample_bpr_negative_alias_distribution(data):
    _, td = data
    g = td.graph
    power = 0.7
    q = tw.popularity_negative_weights(td, power)
    q = q / q.sum()
    alias = tw.negative_alias(td, power)
    k = 4
    batch = sample_bpr(torch.Generator().manual_seed(5), g, 120_000, neg_candidates=k, neg_alias=alias)
    u, n = batch.user.numpy(), batch.neg.numpy()
    member = np.zeros((td.n_users, td.m_items), bool)
    member[td.train_user, td.train_item] = True
    # the first acceptable of K draws from q, else the last draw: with s the
    # mass of q on the user's positives, a non-positive i comes with
    # probability q_i (1 - s^K) / (1 - s), a positive with s^(K-1) q_i
    s = (member * q[None, :]).sum(axis=1, keepdims=True)
    cond = np.where(member, s ** (k - 1) * q[None, :], q[None, :] * (1 - s**k) / (1 - s))
    np.testing.assert_allclose(cond.sum(axis=1), 1.0, rtol=1e-12)
    expected = np.bincount(u, minlength=td.n_users) @ cond
    _chi2_ok(np.bincount(n, minlength=td.m_items).astype(float), expected)


def test_sample_bpr_rejects_alias_of_the_wrong_size(data):
    _, td = data
    with pytest.raises(ValueError, match="edge_alias"):
        sample_bpr(torch.Generator(), td.graph, 10, edge_alias=talias.build_alias_table(np.ones(7)))
    with pytest.raises(ValueError, match="neg_alias"):
        sample_bpr(torch.Generator(), td.graph, 10, neg_alias=talias.build_alias_table(np.ones(7)))


@pytest.mark.parametrize("side", ["user", "item"])
def test_sample_neighbors_uniform_within_rows(data, side):
    _, td = data
    csr = td.graph.user_pos if side == "user" else td.graph.item_pos
    nodes = torch.arange(csr.num_rows).repeat(40).reshape(40, -1)  # [40, n]: any shape
    s = sample_neighbors(torch.Generator().manual_seed(6), csr, nodes, fanout=25)
    assert s.ids.shape == (40, csr.num_rows, 25) and s.ids.dtype == torch.int32
    ip, ix = csr.indptr.numpy(), csr.indices.numpy()
    pos = s.edge_pos.numpy()
    np.testing.assert_array_equal(ix[pos], s.ids.numpy())
    deg = ip[1:] - ip[:-1]
    has = deg > 0
    np.testing.assert_array_equal(s.has_neighbors.numpy(), np.broadcast_to(has, (40, csr.num_rows)))
    rows = np.broadcast_to(np.arange(csr.num_rows)[None, :, None], pos.shape)
    live = has[rows]
    assert ((pos[live] >= ip[rows[live]]) & (pos[live] < ip[rows[live] + 1])).all()
    counts = np.bincount(pos[live].ravel(), minlength=len(ix)).astype(float)
    per_node = 40 * 25
    row_of_edge = np.repeat(np.arange(csr.num_rows), deg)
    _chi2_ok(counts, per_node / deg[row_of_edge])


def test_zero_degree_nodes_flagged_and_tree_shapes():
    # user 1 and item 3 have no train interactions
    g = build_bipartite_graph(np.array([0, 0, 2]), np.array([0, 1, 2]), np.array([1]), np.array([0]), 3, 4)
    s = sample_neighbors(torch.Generator().manual_seed(0), g.user_pos, torch.tensor([0, 1, 2]), 6)
    np.testing.assert_array_equal(s.has_neighbors.numpy(), [True, False, True])
    assert set(s.ids[0].tolist()) <= {0, 1} and set(s.ids[2].tolist()) == {2}
    s = sample_neighbors(torch.Generator().manual_seed(0), g.item_pos, torch.tensor([3, 0]), 2)
    np.testing.assert_array_equal(s.has_neighbors.numpy(), [False, True])
    tree = sample_tree(torch.Generator().manual_seed(1), g.user_pos, torch.tensor([0, 2]), 3, 2)
    assert [tuple(t.ids.shape) for t in tree] == [(2, 3), (2, 3, 3)]
