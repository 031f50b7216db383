"""Port vs JAX package: the SAGE / TextSAGE family (``models/sage.py``,
``models/sage_convs.py``, the registry keys, ``convert.py``'s nested tree,
``--inference sample`` and serving).

Same numpy data (``synthetic_dataset(100, 140, avg_degree=8, seed=7)``,
``synthetic_features``, bit-equal in both packages), the JAX package's initial
parameters carried across by ``params_from_jax``. Tolerances:

- float32 contract: the JAX graph without hub-dense blocks
  (``hub_count=0, dst_hub_count=0``), ``compute_dtype="float32"`` and the
  JAX text hub turned off (``SAGE.TEXT_HUB_WORDS = 0``: its hub block is
  bfloat16 whatever the type); only the order of float32 sums differs, so
  rtol 1e-5, atol 1e-6 (loss rtol 1e-5; gradients rtol 1e-4, atol 1e-7,
  since they sum many small products);
- bfloat16 default: both round x and the weights to bfloat16, the JAX package
  also each product, and its hub nodes and text hub go through bfloat16 dense
  blocks: rtol 2e-2, atol 2e-3.

Fanout trees and dropout come from different generators in the two packages:
the trees are sampled by the JAX package and handed to both (``tree=`` /
``trees=``), with ``DROPOUT_RATE`` set to 0 in both modules; the port's own
dropout is held in distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data.features import synthetic_features as jfeatures
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models import sage_convs as jconvs
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import flatten_params, params_from_jax, params_to_numpy
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models import sage_convs as tconvs
from furusato_recommend_tpu_torch.models.registry import available_models, build_model
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 100, 140, 16
TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(scope="module")
def data():
    """{"hub_free", "default"} JAX datasets and the port's, same arrays."""
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    g = jbuild_graph(
        jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
        hub_count=0, dst_hub_count=0,
    )
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    return {"hub_free": dataclasses.replace(jd, _graph=g), "default": jd}, td


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _both(data, name, compute_dtype="float32", model_kw=None, **cfg):
    """(jax dataset, port dataset, jax model, port model, jax params)."""
    jsets, td = data
    jd = jsets["hub_free" if compute_dtype == "float32" else "default"]
    kw = dict(
        model=name, latent_dim=DIM, n_layers=2, num_neighbors=3, user_feature="nwt",
        item_feature="nwt", compute_dtype=compute_dtype, decay=1e-2,
    )
    kw.update(cfg)
    jf = jfeatures(jd, JConfig(**kw), seed=1)
    tf = synthetic_features(td, Config(**kw), seed=1)
    jm = jbuild_model(name, JConfig(**kw), jd.graph, features=jf, **(model_kw or {}))
    tm = build_model(name, Config(**kw), td.graph, features=tf, **(model_kw or {}))
    p = jm.init(jax.random.PRNGKey(0))
    params_from_jax(_np(p), tm)
    return jd, td, jm, tm, p


@pytest.fixture
def no_text_hub(monkeypatch):
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(jsage, "DROPOUT_RATE", 0.0)
    monkeypatch.setattr(tsage, "DROPOUT_RATE", 0.0)


# ---- convs ----
CONVS = ["sage_cat", "sage_w2", "light", "pinsage", "gcn", "ggnn"]


@pytest.mark.parametrize("conv", CONVS)
def test_conv_matches_jax(data, conv):
    jsets, td = data
    jd = jsets["hub_free"]
    jc, tc = jconvs.get_conv(conv), tconvs.get_conv(conv)
    d = 8
    jp = jc.init(jax.random.PRNGKey(3), d, 0.5)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    fresh = tc.init(torch.Generator().manual_seed(0), d, 0.5)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {k: tuple(v.shape) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    # sampled: targets [B, F, d], neighbours [B, F, F, d]
    target = rng.standard_normal((6, 3, d)).astype(np.float32)
    nbrs = rng.standard_normal((6, 3, 3, d)).astype(np.float32)
    aggr = nbrs.mean(axis=-2)
    want = jc.sampled(jp, jnp.asarray(target), jnp.asarray(aggr), {"neighbors": jnp.asarray(nbrs), "side": "user"})
    got = tc.sampled(tp, torch.from_numpy(target), torch.from_numpy(aggr),
                     {"neighbors": torch.from_numpy(nbrs), "side": "user"})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    # full graph, both sides
    xu = rng.standard_normal((N_USERS, d)).astype(np.float32)
    xi = rng.standard_normal((M_ITEMS, d)).astype(np.float32)
    for side, x_self, other in (("user", xu, xi), ("item", xi, xu)):
        agg = rng.standard_normal(x_self.shape).astype(np.float32)
        want = jc.full_graph(jp, jnp.asarray(x_self), jnp.asarray(agg), jnp.asarray(other), side, {"graph": jd.graph})
        got = tc.full_graph(tp, torch.from_numpy(x_self), torch.from_numpy(agg), torch.from_numpy(other), side,
                            {"graph": td.graph})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


def test_conv_aliases():
    assert tconvs.get_conv("sage") is tconvs.get_conv("mean") is tconvs.get_conv("sage_cat")
    with pytest.raises(KeyError):
        tconvs.get_conv("nope")


# ---- full-graph propagation ----
PROPAGATE_CASES = [
    ("textsage", {}, {}),
    ("textsage", {"user_feature": "nctwb", "item_feature": "nctwsrb", "factorization": True}, {}),
    ("textsage", {"user_feature": "nctw", "item_feature": "nctwsr", "cold_start": True}, {}),
    ("textsage", {}, {"layer_mean_output": True}),
    ("textsage", {"n_layers": 3}, {}),
    ("textsage_id", {}, {}),
    ("sage", {"user_feature": "ncw", "item_feature": "ncw"}, {}),
    ("fsage", {"user_feature": "nctw", "item_feature": "nctw"}, {}),
    ("fastsage", {}, {}),
    ("lightsage", {}, {}),
    ("pinsage", {}, {}),
    ("mrec", {"user_feature": "nwtb", "item_feature": "nwtb"}, {}),
    ("nssage", {}, {}),
    ("gnn", {"conv": "gcn"}, {}),
    ("gnn", {"conv": "sage"}, {}),
    ("gnn", {"conv": "mean"}, {}),
    ("gnn", {"conv": "light"}, {}),
    ("gnn", {"conv": "ggnn"}, {}),
]


@pytest.mark.parametrize("name,cfg,model_kw", PROPAGATE_CASES)
def test_propagate_matches_jax(data, no_text_hub, name, cfg, model_kw):
    jd, td, jm, tm, p = _both(data, name, model_kw=model_kw, **cfg)
    ju, ji = jm.propagate(p, jd.graph)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    assert tu.shape == (N_USERS, tm.node_dim) and ti.shape == (M_ITEMS, tm.node_dim)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TIGHT)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TIGHT)


@pytest.mark.parametrize(
    "name,cfg",
    [
        ("textsage", {}),
        ("textsage", {"user_feature": "nctwb", "item_feature": "nctwsrb", "factorization": True}),
        ("pinsage", {}),
        ("gnn", {"conv": "ggnn"}),
    ],
)
def test_propagate_bfloat16_default(data, name, cfg):
    jd, td, jm, tm, p = _both(data, name, compute_dtype="bfloat16", **cfg)
    ju, ji = jm.propagate(p, jd.graph)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **LOOSE)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **LOOSE)


@pytest.mark.parametrize("name", ["textsage", "fsage"])
def test_initial_all_equals_per_id(data, no_text_hub, name):
    cfg = dict(user_feature="nctw", item_feature="nctwsr", factorization=True)
    jd, td, jm, tm, p = _both(data, name, **cfg)
    with torch.no_grad():
        for side, n in (("user", N_USERS), ("item", M_ITEMS)):
            whole = tm._initial_all(side)
            per_id = tm._initial_side_emb(torch.arange(n), side)
            np.testing.assert_allclose(whole.numpy(), per_id.numpy(), **TIGHT)
            np.testing.assert_allclose(whole.numpy(), np.asarray(jm._initial_all(p, side)), **TIGHT)
            ids = torch.tensor([[3, 0], [n - 1, 7]])
            np.testing.assert_allclose(
                tm._initial_side_emb(ids, side).numpy(),
                np.asarray(jm._initial_side_emb(p, jnp.asarray(ids.numpy()), side)), **TIGHT,
            )


def test_features_must_cover_the_dataset(data):
    _, td = data
    cfg = Config(model="textsage", latent_dim=DIM)
    small = synthetic_features(tds.synthetic_dataset(n_users=50, m_items=M_ITEMS, seed=0), cfg)
    tm = build_model("textsage", cfg, td.graph, features=small)
    with pytest.raises(ValueError, match="cover 50 entities"):
        tm.propagate(td.graph)
    with pytest.raises(ValueError, match="features"):
        build_model("textsage", cfg, td.graph)


def test_registry_and_parameter_tree_round_trip(data, no_text_hub):
    assert {"textsage", "textsage_id", "sage", "fsage", "fastsage", "lightsage", "pinsage", "mrec",
            "nssage", "gnn", "dask"} <= set(available_models())
    _, td = data
    cfg = Config(latent_dim=DIM, conv="gat")
    fs = synthetic_features(td, cfg, seed=1)
    assert build_model("gnn", cfg, td.graph, features=fs).conv_name == "gat"
    with pytest.raises(KeyError, match="available"):
        build_model("nope", cfg, td.graph, features=fs)
    for name in ("textsage", "lightsage", "pinsage", "mrec", "sasrec", "asage"):
        if name == "sasrec":  # the blocks and item_tower lists beside layers
            from furusato_recommend_tpu.data.sequence import build_sequences as jbuild_sequences
            from furusato_recommend_tpu_torch.data.sequence import build_sequences

            jsets, _ = data
            kw = dict(model=name, latent_dim=DIM, n_layers=2, user_feature="nwt", item_feature="nwt")
            jm = jbuild_model(name, JConfig(**kw), jsets["default"].graph,
                              features=jfeatures(jsets["default"], JConfig(**kw), seed=1),
                              sequences=jbuild_sequences(jsets["default"]))
            tm = build_model(name, Config(**kw), td.graph, features=synthetic_features(td, Config(**kw), seed=1),
                             sequences=build_sequences(td))
            p = jm.init(jax.random.PRNGKey(0))
            params_from_jax(_np(p), tm)
            assert len(params_to_numpy(tm)["blocks"]) == 2 and len(params_to_numpy(tm)["item_tower"]) == 1
        else:
            _, _, jm, tm, p = _both(data, name)
        out = params_to_numpy(tm)
        want = _np(p)
        assert jax.tree_util.tree_structure(out) == jax.tree_util.tree_structure(want), name
        for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
        assert set(dict(tm.named_parameters())) == set(flatten_params(want))


# ---- fanout trees ----
def _batch(td, b=48, seed=0):
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(0, N_USERS, b)
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, b)
    valid = np.ones(b, dtype=bool)
    valid[-5:] = False
    arrs = [a.astype(np.int32) for a in (user, pos, neg)] + [valid]
    return JBatch(*(jnp.asarray(a) for a in arrs)), BPRBatch(*(torch.from_numpy(a) for a in arrs))


def _tree_to_torch(tree):
    return [SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in tree]


def _jax_trees(jm, jd, jb, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    seeds = ((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item"))
    return [jm.sample_seed_tree(jd.graph, s, side, k) for (s, side), k in zip(seeds, keys)]


@pytest.mark.parametrize("name,model_kw", [("textsage", {}), ("pinsage", {}), ("lightsage", {}),
                                           ("mrec", {"layer_mean_output": True})])
def test_encode_seeds_matches_jax(data, no_text_hub, name, model_kw):
    jd, td, jm, tm, p = _both(data, name, model_kw=model_kw)
    jb, tb = _batch(td)
    for seeds_j, seeds_t, side in ((jb.user, tb.user, "user"), (jb.pos, tb.pos, "item")):
        jtree = jm.sample_seed_tree(jd.graph, seeds_j, side, jax.random.PRNGKey(2))
        want = jm.encode_seeds(p, jd.graph, seeds_j, side, jax.random.PRNGKey(0), train=False, tree=jtree)
        with torch.no_grad():
            got = tm.encode_seeds(td.graph, seeds_t, side, tree=_tree_to_torch(jtree))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("name", ["textsage", "nssage"])
def test_loss_and_grads_match_jax(data, no_text_hub, no_dropout, name):
    jd, td, jm, tm, p = _both(data, name)
    jb, tb = _batch(td)
    jtrees = _jax_trees(jm, jd, jb, seed=5)
    (jl, jaux), jg = jax.value_and_grad(
        lambda q: jm.loss(q, jd.graph, jb, jax.random.PRNGKey(1), trees=jtrees), has_aux=True
    )(p)
    tl, taux = tm.loss(td.graph, tb, trees=[_tree_to_torch(t) for t in jtrees])
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("bpr", "reg"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-5)
    want = flatten_params(_np(jg))
    for n_, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[n_], rtol=1e-4, atol=1e-7, err_msg=n_)


def test_dropout_keeps_share_and_scale():
    assert tsage.DROPOUT_RATE == jsage.DROPOUT_RATE == 0.2
    n = 400_000
    out = tsage.dropout(torch.ones(n), torch.Generator().manual_seed(0))
    kept = out != 0
    share = float(kept.float().mean())
    sigma = (0.8 * 0.2 / n) ** 0.5
    assert abs(share - 0.8) < 4 * sigma, share
    np.testing.assert_array_equal(out[kept].numpy(), np.float32(1.0) / np.float32(0.8))
    # the caller's generator decides the mask
    a = tsage.dropout(torch.ones(1000), torch.Generator().manual_seed(3))
    b = tsage.dropout(torch.ones(1000), torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="generator"):
        tsage.dropout(torch.ones(3), None)


def test_training_encode_draws_dropout_from_the_generator(data):
    _, td, _, tm, _ = _both(data, "textsage")
    seeds = torch.arange(20, dtype=torch.int32)
    with torch.no_grad():
        tree = tm.sample_seed_tree(td.graph, seeds, "user", torch.Generator().manual_seed(1))
        plain = tm.encode_seeds(td.graph, seeds, "user", tree=tree)
        runs = [tm.encode_seeds(td.graph, seeds, "user", torch.Generator().manual_seed(s), train=True, tree=tree)
                for s in (7, 7, 8)]
    np.testing.assert_array_equal(runs[0].numpy(), runs[1].numpy())
    assert not np.allclose(runs[0].numpy(), plain.numpy())
    assert not np.allclose(runs[0].numpy(), runs[2].numpy())
    # every sampled neighbour lies in its node's row
    ap = td.all_pos()
    for u, row in zip(seeds.tolist(), tree[0].ids.tolist()):
        assert set(row) <= set(ap[u].tolist())


# ---- --inference sample ----
def test_propagate_sampled_matches_jax_on_fixed_trees(no_text_hub):
    """Every node has degree 1, so every tree is fixed and the encodings do
    not depend on the random stream."""
    n = 40
    perm = np.random.default_rng(0).permutation(n)
    arrays = (np.arange(n), perm, np.arange(n), (perm + 1) % n)
    jd = jds.Dataset(n, n, *arrays)
    g = jbuild_graph(*arrays, n, n, hub_count=0, dst_hub_count=0)
    jd = dataclasses.replace(jd, _graph=g)
    td = tds.Dataset(n, n, *arrays)
    kw = dict(model="textsage", latent_dim=DIM, n_layers=2, num_neighbors=3, user_feature="nwt",
              item_feature="nwt", compute_dtype="float32", sample_infer_chunk=16)
    jm = jbuild_model("textsage", JConfig(**kw), jd.graph, features=jfeatures(jd, JConfig(**kw), seed=2))
    tm = build_model("textsage", Config(**kw), td.graph, features=synthetic_features(td, Config(**kw), seed=2))
    p = jm.init(jax.random.PRNGKey(0))
    params_from_jax(_np(p), tm)
    ju, ji = jm.propagate_sampled(p, jd.graph, jax.random.PRNGKey(3))
    tu, ti = tm.propagate_sampled(td.graph, torch.Generator().manual_seed(4))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TIGHT)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TIGHT)


def test_evaluator_inference_sample(data):
    from furusato_recommend_tpu_torch.eval.evaluate import Evaluator, build_eval_data

    _, td, _, tm, _ = _both(data, "textsage", inference="sample", sample_infer_chunk=32,
                            topks=(5, 10))
    ev = Evaluator(tm, td.graph, tm.config, max_train_degree=32)
    calls = []
    real = tm.propagate_sampled
    tm.propagate_sampled = lambda *a: calls.append(1) or real(*a)
    results, _ = ev(build_eval_data(td, 64))
    assert calls == [1] and 0.0 <= results["recall@10"] <= 1.0
    again, _ = ev(build_eval_data(td, 64))  # seeded with config.seed: the same trees
    assert again == results


# ---- serving ----
def test_recommender_serves_sage_like_jax(data, no_text_hub):
    from furusato_recommend_tpu.serve import Recommender as JRecommender
    from furusato_recommend_tpu_torch.serve import Recommender

    jd, td, jm, tm, p = _both(data, "textsage", user_feature="nctw", item_feature="nctws")
    jrec = JRecommender(jm, jd, jm.config, p)
    trec = Recommender(tm, td, tm.config, _np(p), device="cpu")
    users = np.arange(N_USERS)
    jid, jsc = jrec.recommend(users, k=10)
    tid, tsc = trec.recommend(users, k=10)
    np.testing.assert_allclose(tsc, jsc, **TIGHT)
    # ids equal wherever neighbouring scores are apart
    gap = np.abs(np.diff(jsc, axis=1)) > 1e-5 * np.abs(jsc[:, 1:])
    sep = np.ones(jid.shape, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(tid[sep], jid[sep])
    assert sep.mean() > 0.9
