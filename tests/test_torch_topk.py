"""The fused masked top-k: its plain version (what ``masked_topk`` runs for CPU
tensors) against the JAX package's Pallas ``streaming_topk`` in interpret
mode, ``lax.top_k``'s tie order, and the masked / sigmoid scores of the JAX
``Recommender``. The CUDA kernel itself is held against the plain version in
``test_torch_kernels.py``, on a card.

Tolerances: untied Gaussian scores agree to rtol 1e-5 (float32 sums in another
order); inputs that are small multiples of 1/8 give exact dot products, so
there values and ids must be equal, tie order included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.ops.pallas_topk import streaming_topk
from furusato_recommend_tpu_torch.ops import streaming_topk as st
from furusato_recommend_tpu_torch.ops.streaming_topk import (
    MASK_SENTINEL,
    masked_topk,
)

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize(
    "b,m,d,k,tile,b_tile,sign",
    [
        (16, 1000, 32, 8, 256, 256, 1.0),  # argsort match
        (8, 130, 16, 5, 64, 256, -1.0),  # M not a tile multiple
        (19, 257, 16, 4, 64, 8, 1.0),  # B > b_tile, not a multiple
    ],
)
def test_matches_pallas_streaming_topk(b, m, d, k, tile, b_tile, sign):
    rng = np.random.default_rng(b + m)
    u = (sign * rng.standard_normal((b, d))).astype(np.float32)
    i = rng.standard_normal((m, d)).astype(np.float32)
    jv, ji = streaming_topk(jnp.asarray(u), jnp.asarray(i), k=k, tile=tile, b_tile=b_tile, interpret=True)
    before = st.launches
    tv, ti = masked_topk(_t(u), _t(i), torch.arange(b), k)
    assert st.launches == before  # CPU tensors never launch the kernel
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64
    assert tuple(ti.shape) == (b, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def _tied_inputs(seed, n=12, m=300, d=8):
    """Embeddings in multiples of 1/8 with duplicated item rows: exact dot
    products and many ties."""
    rng = np.random.default_rng(seed)
    u = (rng.integers(-3, 4, size=(n, d)) / 8).astype(np.float32)
    i = (rng.integers(-2, 3, size=(m, d)) / 8).astype(np.float32)
    i[1::3] = i[0::3][: len(i[1::3])]
    return u, i


@pytest.mark.parametrize("k", [1, 7, 40, 300])
def test_tie_order_matches_lax_top_k(k):
    u, i = _tied_inputs(k)
    s = u @ i.T  # exact
    jv, ji = jax.lax.top_k(jnp.asarray(s), k)
    tv, ti = masked_topk(_t(u), _t(i), torch.arange(u.shape[0]), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.fixture(scope="module")
def jax_recommenders():
    from furusato_recommend_tpu.config import Config as JConfig
    from furusato_recommend_tpu.data import synthetic_dataset
    from furusato_recommend_tpu.models.registry import build_model
    from furusato_recommend_tpu.serve import Recommender

    ds = synthetic_dataset(n_users=40, m_items=60, avg_degree=8, seed=2)
    out = {}
    for name in ("mf", "lgn"):
        cfg = JConfig(model=name, latent_dim=8, n_layers=1)
        model = build_model(name, cfg, ds.graph)
        params = model.init(jax.random.PRNGKey(1))
        out[name] = (ds, Recommender(model, ds, cfg, params, use_inference_edges=False))
    return out


@pytest.mark.parametrize("name,k", [("mf", 10), ("mf", 60), ("lgn", 25)])
def test_matches_jax_recommender_topk(jax_recommenders, name, k):
    ds, rec = jax_recommenders[name]
    users = np.array([0, 3, 3, 17, 39], dtype=np.int32)
    jv, ji = rec._topk(jnp.asarray(users), rec._user_emb, rec._item_emb, rec._mask_graph, k)
    g = ds.graph
    tv, ti = masked_topk(
        _t(np.asarray(rec._user_emb)),
        _t(np.asarray(rec._item_emb)),
        _t(users),
        k,
        _t(np.asarray(g.user_pos.indptr)),
        _t(np.asarray(g.user_pos.indices)),
        sigmoid=rec.model.score_sigmoid,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    if k == 60:  # the whole catalog: train positives rank last, at exactly -1024
        deg = np.diff(np.asarray(g.user_pos.indptr))[users]
        for row, n_pos in zip(tv.numpy(), deg):
            assert (row[k - n_pos :] == MASK_SENTINEL).all()
            assert (row[: k - n_pos] > MASK_SENTINEL).all()


def _jax_rows(u, n):
    """(score row, mask row or None) that the JAX ``Recommender._topk`` uses
    for user id u of N: ``user_emb[u]`` wraps a negative id once and clamps
    the rest; ``csr_gather_padded`` indexes ``indptr`` [N + 1] the same way,
    so the mask row is off by one for negative ids, and empty for -1 and for
    ids >= N (its degree comes out <= 0)."""
    emb = min(max(u + n if u < 0 else u, 0), n - 1)
    lo = min(max(u + n + 1 if u < 0 else u, 0), n)
    hi = min(max(u + 1 + n + 1 if u + 1 < 0 else u + 1, 0), n)
    return emb, (lo if hi > lo else None)


@pytest.mark.parametrize("name", ["mf", "lgn"])
def test_out_of_range_users_against_jax_recommender(jax_recommenders, name):
    """Ids outside [0, N): the port clamps them (score and mask row of the
    clamped id), which is a deviation from the JAX ``Recommender._topk``.
    JAX's answer is shown here row by row (``_jax_rows``), next to the
    port's; in range the two agree."""
    ds, rec = jax_recommenders[name]
    g = ds.graph
    n, k = ds.n_users, 12
    indptr, indices = np.asarray(g.user_pos.indptr), np.asarray(g.user_pos.indices)
    U, I = np.asarray(rec._user_emb), np.asarray(rec._item_emb)
    users = np.array([-3, -1, -n - 5, 0, n - 1, n, 999], dtype=np.int32)
    jv, ji = rec._topk(jnp.asarray(users), rec._user_emb, rec._item_emb, rec._mask_graph, k)
    jv, ji = np.asarray(jv), np.asarray(ji)
    rows = [_jax_rows(int(u), n) for u in users]
    assert rows[:2] == [(n - 3, n - 2), (n - 1, None)] and rows[-2:] == [(n - 1, None)] * 2
    # JAX's answer: score row `emb` with the train row of `mask` (or none)
    masks = [indices[indptr[m]:indptr[m + 1]] if m is not None else np.zeros(0, np.int32)
             for _, m in rows]
    sel_ptr = np.concatenate([[0], np.cumsum([len(x) for x in masks])]).astype(np.int32)
    wv, wi = masked_topk(
        _t(U[[e for e, _ in rows]]), _t(I), torch.arange(len(users)), k,
        _t(sel_ptr), _t(np.concatenate(masks).astype(np.int32)), sigmoid=rec.model.score_sigmoid,
    )
    np.testing.assert_array_equal(wi.numpy(), ji)
    np.testing.assert_allclose(wv.numpy(), jv, rtol=1e-5, atol=1e-6)
    # the port's: the clamped id's own row and mask, equal to JAX in range only
    mk = (_t(indptr), _t(indices))
    tv, ti = masked_topk(_t(U), _t(I), _t(users), k, *mk, sigmoid=rec.model.score_sigmoid)
    cv, ci = masked_topk(_t(U), _t(I), _t(np.clip(users, 0, n - 1)), k, *mk,
                         sigmoid=rec.model.score_sigmoid)
    np.testing.assert_array_equal(ti.numpy(), ci.numpy())
    np.testing.assert_array_equal(tv.numpy(), cv.numpy())
    in_range = (users >= 0) & (users < n)
    np.testing.assert_array_equal(ti.numpy()[in_range], ji[in_range])
    assert (ti.numpy()[:2] != ji[:2]).any(axis=1).all()  # -3 and -1: other score rows


@pytest.mark.parametrize("masked", [False, True])
def test_reference_clamps_user_ids(masked):
    """Ids outside [0, N) score as the nearest valid row, with that row's
    mask, as the CUDA kernel clamps them (a deviation from the JAX package
    for negative ids and for the mask of ids >= N; see the test above)."""
    u, i = _tied_inputs(3, n=12, m=40)
    rng = np.random.default_rng(0)
    rows = [np.sort(rng.choice(40, size=5, replace=False)) for _ in range(12)]
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    mk = (_t(indptr), _t(np.concatenate(rows).astype(np.int32))) if masked else (None, None)
    tv, ti = st.masked_topk_reference(_t(u), _t(i), torch.tensor([-3, 0, 11, 12, 999]), 9, *mk)
    wv, wi = st.masked_topk_reference(_t(u), _t(i), torch.tensor([0, 0, 11, 11, 11]), 9, *mk)
    np.testing.assert_array_equal(ti.numpy(), wi.numpy())
    np.testing.assert_array_equal(tv.numpy(), wv.numpy())


def test_rejects_bad_arguments():
    u, i = _tied_inputs(0, m=20)
    users = torch.arange(3)
    with pytest.raises(ValueError, match="k="):
        masked_topk(_t(u), _t(i), users, 21)  # k > M, as lax.top_k
    with pytest.raises(ValueError, match="k="):
        masked_topk(_t(u), _t(i), users, 0)
    with pytest.raises(ValueError, match="both"):
        masked_topk(_t(u), _t(i), users, 3, mask_indptr=torch.zeros(13, dtype=torch.int32))
    with pytest.raises(ValueError, match="N \\+ 1"):
        masked_topk(
            _t(u), _t(i), users, 3,
            torch.zeros(5, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
        )
    with pytest.raises(ValueError):
        masked_topk(_t(u), _t(i[:, :4]), users, 3)


# ---- k > 128: rounds over a per-row bound (what masked_topk runs on a card) ----
def _masked_tied(seed, n=12, m=300):
    """Tied exact inputs and a train CSR in which row 0 leaves 20 items
    unmasked (so -1024 entries rank inside a large k) and other rows are
    short."""
    u, i = _tied_inputs(seed, n=n, m=m)
    rng = np.random.default_rng(seed)
    rows = [np.sort(rng.choice(m, size=m - 20 if r == 0 else int(rng.integers(0, 30)), replace=False))
            for r in range(n)]
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    return u, i, _t(indptr), _t(np.concatenate(rows).astype(np.int32))


@pytest.mark.parametrize("max_k", [128, 7])
@pytest.mark.parametrize("k", [129, 200, 300])
@pytest.mark.parametrize("masked,sig", [(False, False), (True, False), (True, True)])
def test_rounds_equal_one_topk(k, max_k, masked, sig):
    """``_topk_in_rounds`` driven by the plain version, bounded by each
    round's last key, equals one plain top-k of size k, bit for bit: on exact
    inputs full of ties, with a row so densely masked that -1024 entries
    rank; max_k 7 puts many round edges inside runs of equal values."""
    u, i, ip, ix = _masked_tied(k + max_k)
    U, I = _t(u), _t(i)
    users = torch.tensor([0, 3, 3, 11, 5])
    mk = (ip, ix) if masked else (None, None)
    calls = []

    def round_fn(kk, after):
        calls.append((kk, after is None))
        return st.masked_topk_reference(U, I, users, kk, *mk, sigmoid=sig, after=after)

    gv, gi = st._topk_in_rounds(round_fn, k, max_k)
    wv, wi = st.masked_topk_reference(U, I, users, k, *mk, sigmoid=sig)
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_array_equal(gv.numpy(), wv.numpy())
    n_rounds = -(-k // max_k)
    assert [kk for kk, _ in calls] == [max_k] * (n_rounds - 1) + [k - max_k * (n_rounds - 1)]
    assert [first for _, first in calls] == [True] + [False] * (n_rounds - 1)
    assert len(set(map(tuple, gi.numpy()))) == 4  # rows 1 and 2 are one user
    assert all(len(set(row)) == k for row in gi.numpy().tolist())  # no id twice
    if masked and not sig:
        assert (gv[0, 20:] == MASK_SENTINEL).all() and (gv[0, :20] > MASK_SENTINEL).all()


def test_reference_bound_excludes_keys_by_flag():
    """The bound is a key, not a sentinel: items whose value equals the bound
    value and whose id is larger come after it; values below -1024 (possible
    without the sigmoid) are still selected."""
    u = np.array([[1.0], [-2000.0]], np.float32)
    i = np.array([[1.0], [1.0], [2.0], [1.0], [0.5]], np.float32)
    after = (torch.tensor([1.0, -2000.0]), torch.tensor([1, 2], dtype=torch.int32))
    v, ids = st.masked_topk_reference(_t(u), _t(i), torch.tensor([0, 1]), 2, after=after)
    # row 0: the keys after (1.0, id 1); row 1: after (-2000.0, id 2), down to -4000
    np.testing.assert_array_equal(ids.numpy(), [[3, 4], [3, 2]])
    np.testing.assert_array_equal(v.numpy(), [[1.0, 0.5], [-2000.0, -4000.0]])
    with pytest.raises(ValueError, match="fewer than k"):
        st.masked_topk_reference(_t(u), _t(i), torch.tensor([0, 1]), 3, after=after)


@pytest.fixture(scope="module")
def wide_catalog():
    """A JAX and a port Recommender of lgn and mf over 260 items, the JAX
    graph without hub-dense blocks, float32, the same parameters."""
    import dataclasses

    from furusato_recommend_tpu.config import Config as JConfig
    from furusato_recommend_tpu.data import synthetic_dataset
    from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
    from furusato_recommend_tpu.models.registry import build_model
    from furusato_recommend_tpu.serve import Recommender
    from furusato_recommend_tpu_torch.config import Config
    from furusato_recommend_tpu_torch.data import dataset as tds
    from furusato_recommend_tpu_torch.models.registry import build_model as tbuild_model
    from furusato_recommend_tpu_torch.serve import Recommender as TRecommender

    jd = synthetic_dataset(n_users=40, m_items=260, avg_degree=8, seed=2)
    jd = dataclasses.replace(jd, _graph=jbuild_graph(
        jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
        hub_count=0, dst_hub_count=0))
    td = tds.synthetic_dataset(n_users=40, m_items=260, avg_degree=8, seed=2)
    out = {}
    for name in ("mf", "lgn"):
        kw = dict(model=name, latent_dim=8, n_layers=1, compute_dtype="float32")
        model = build_model(name, JConfig(**kw), jd.graph)
        params = model.init(jax.random.PRNGKey(1))
        jrec = Recommender(model, jd, JConfig(**kw), params, use_inference_edges=False)
        trec = TRecommender(tbuild_model(name, Config(**kw), td.graph), td, Config(**kw),
                            jax.tree_util.tree_map(np.asarray, params), use_inference_edges=False,
                            device="cpu")
        out[name] = (jrec, trec)
    return out


@pytest.mark.parametrize("name", ["mf", "lgn"])
def test_recommender_k200_matches_jax(wide_catalog, name):
    """k = 200 over 260 items (train positives rank last at -1024): the
    port's CPU Recommender against the JAX one; ids equal wherever
    neighbouring scores are apart, scores within rtol 1e-5."""
    jrec, trec = wide_catalog[name]
    users = np.array([0, 5, 5, 21, 39])
    jid, jsc = (np.asarray(x) for x in jrec.recommend(users, k=200))
    tid, tsc = trec.recommend(users, k=200)
    assert tid.shape == (5, 200)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-6)
    gap = np.abs(np.diff(jsc, axis=1)) > 1e-5 * np.abs(jsc[:, 1:])
    sep = np.ones(jid.shape, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(tid[sep], jid[sep])
    assert sep.mean() > 0.9
