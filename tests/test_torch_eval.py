"""Port vs JAX package: full-catalog evaluation (``eval/evaluate.py``) and the
metrics (``eval/metrics.py``) on identical parameters.

MF with embeddings that are small multiples of 1/8 gives exact scores, every
item has a twin (ties), so the top-K ids must be equal, ties included, and
the metric sums equal up to float32 summation order (rtol 1e-5). LightGCN's
propagated embeddings differ in the last bits between the packages, so there
the ids are held where neighbouring scores are apart and the metrics within
rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data.graph import CSR as JCSR
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.eval import evaluate as jev
from furusato_recommend_tpu.eval import metrics as jmet
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import params_from_jax
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.graph import CSR
from furusato_recommend_tpu_torch.eval import evaluate as tev
from furusato_recommend_tpu_torch.eval import metrics as tmet
from furusato_recommend_tpu_torch.models.registry import build_model

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 90, 140, 16


def _categories(seed=0):
    rng = np.random.default_rng(seed)
    cats = np.full((M_ITEMS, 3), -1, dtype=np.int32)
    for i in range(M_ITEMS):
        k = rng.integers(1, 4)
        cats[i, :k] = rng.choice(8, size=k, replace=False)
    return cats


def _params(name):
    rng = np.random.default_rng(1)
    if name == "mf":
        u = (rng.integers(-2, 3, (N_USERS, DIM)) / 8).astype(np.float32)
        i = (rng.integers(-2, 3, (M_ITEMS, DIM)) / 8).astype(np.float32)
        i[1::2] = i[0::2]  # every item has a twin: ties
    else:
        u = (0.1 * rng.standard_normal((N_USERS, DIM))).astype(np.float32)
        i = (0.1 * rng.standard_normal((M_ITEMS, DIM))).astype(np.float32)
    return {"user_emb": u, "item_emb": i}


def _run_both(name, **cfg):
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=9, seed=4)
    g = jbuild_graph(
        jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
        hub_count=0, dst_hub_count=0,
    )
    jd = dataclasses.replace(jd, _graph=g)
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=9, seed=4)
    kw = dict(
        model=name, latent_dim=DIM, n_layers=2, compute_dtype="float32", topks=(5, 10),
        eval_user_batch=32, **cfg,
    )
    p = _params(name)
    cats = _categories()
    max_deg = int(np.bincount(jd.train_user, minlength=N_USERS).max())
    jm = jbuild_model(name, JConfig(**kw), jd.graph)
    jres, jshown = jev.Evaluator(jm, jd.graph, JConfig(**kw), max_deg)(
        jax.tree_util.tree_map(jnp.asarray, p), jev.build_eval_data(jd, 32, cats)
    )
    tm = build_model(name, Config(**kw), td.graph)
    params_from_jax(p, tm)
    tres, tshown = tev.Evaluator(tm, td.graph, Config(**kw), max_deg)(
        tev.build_eval_data(td, 32, cats)
    )
    return jres, jshown, tres, tshown, tm, td


def test_mf_evaluation_matches_jax_ties_included():
    jres, jshown, tres, tshown, _, _ = _run_both("mf", cold_start=True, compute_auc=True)
    np.testing.assert_array_equal(tshown, jshown)
    assert set(tres) == set(jres)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert {"cold_recall@5", "auc@10", "diversity@10", "novelty@5", "coverage@10"} <= set(tres)


def test_lgn_evaluation_matches_jax():
    jres, jshown, tres, tshown, tm, td = _run_both("lgn")
    assert set(tres) == set(jres)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # ids equal wherever the port's neighbouring scores are apart
    with torch.no_grad():
        s = tm.score_users(td.graph, torch.from_numpy(np.unique(td.test_user)))
    top = torch.gather(s, 1, torch.from_numpy(tshown)).numpy()
    gap = np.abs(np.diff(top, axis=1)) > 1e-5 * np.abs(top[:, 1:])
    sep = np.ones(tshown.shape, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(tshown[sep], jshown[sep])


def test_metric_sums_and_auc_match_jax():
    rng = np.random.default_rng(3)
    n, m, b, kmax = 40, 60, 16, 10
    rows = [np.sort(rng.choice(m, size=rng.integers(0, 6), replace=False)) for _ in range(n)]
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    indices = np.concatenate(rows).astype(np.int32)
    users = rng.choice(n, b, replace=False).astype(np.int32)
    valid = rng.random(b) < 0.8
    topk = np.stack([rng.permutation(m)[:kmax] for _ in range(b)]).astype(np.int32)
    pop = rng.random(m).astype(np.float32)
    cats = np.where(rng.random((m, 3)) < 0.6, rng.integers(0, 5, (m, 3)), -1).astype(np.int32)
    cats = np.array([np.concatenate([np.unique(r[r >= 0]), np.full(3, -1)])[:3] for r in cats], np.int32)
    jcsr = JCSR(jnp.asarray(indptr), jnp.asarray(indices))
    tcsr = CSR(torch.from_numpy(indptr), torch.from_numpy(indices))
    want = jmet.batch_metric_sums(
        jnp.asarray(topk), jnp.asarray(users), jnp.asarray(valid), jcsr, (3, 10),
        jnp.asarray(cats), jnp.asarray(pop), n_users_norm=float(n),
    )
    got = tmet.batch_metric_sums(
        torch.from_numpy(topk), torch.from_numpy(users), torch.from_numpy(valid), tcsr, (3, 10),
        torch.from_numpy(cats), torch.from_numpy(pop), n_users_norm=float(n),
    )
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    scores = (rng.integers(-8, 8, (b, m)) / 4).astype(np.float32)  # ties
    scores[:, :5] = -1024.0  # masked items
    want_auc = jmet.batch_auc_sum(jnp.asarray(scores), jnp.asarray(users), jnp.asarray(valid), jcsr, -1024.0)
    got_auc = tmet.batch_auc_sum(torch.from_numpy(scores), torch.from_numpy(users), torch.from_numpy(valid), tcsr, -1024.0)
    np.testing.assert_allclose(float(got_auc), float(want_auc), rtol=1e-5)


def test_pmi_and_unexpectedness_match_jax():
    jd = jds.synthetic_dataset(n_users=50, m_items=40, avg_degree=6, seed=5)
    td = tds.synthetic_dataset(n_users=50, m_items=40, avg_degree=6, seed=5)
    want = jmet.pmi_from_cooccurrence(jd.train_user, jd.train_item, 40)
    got = tmet.pmi_from_cooccurrence(td.train_user, td.train_item, 40)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(0)
    users = rng.choice(50, 20, replace=False)
    topk = rng.integers(0, 40, (20, 5))
    np.testing.assert_allclose(
        tmet.unexpectedness_from_pmi(td.graph, users, topk, got),
        jmet.unexpectedness_from_pmi(jd.graph, users, topk, want),
        rtol=1e-6,
    )


def test_unported_evaluation_modes_raise():
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=9, seed=4)
    cfg = Config(latent_dim=DIM, inference="sample")
    model = build_model("lgn", cfg, td.graph)
    with pytest.raises(NotImplementedError):
        tev.Evaluator(model, td.graph, cfg, 10, mesh=object())
    # --inference sample is ported for the SAGE family (tests/test_torch_sage.py);
    # a model without sampled inference propagates, as in the JAX package
    ev = tev.Evaluator(model, td.graph, cfg, 10)
    with torch.no_grad():
        want = model.propagate(td.graph)
    for a, b in zip(ev.embeddings(), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
