"""What the CPU can check of the captured evaluation (``eval/graphed.py``);
the CPU itself never captures and runs every evaluation eagerly through
``Evaluator.program``, the plain version of the graph.

- the whole evaluation as the graph records it, with every metric on (AUC,
  cold start, diversity from item categories, novelty from popularity),
  against the JAX package's ``Evaluator`` (one jitted program) on the same
  seeded numpy inputs and parameters: mf on exact inputs (multiples of 1/8,
  every item with a twin) and lgn and textsage at float32 on a hub-free JAX
  graph (the JAX text hub off), ids equal and metrics within rtol 1e-5; lgn
  at the bfloat16 default on the JAX package's default graph, metrics within
  rtol 2e-2 (both round the SpMM operands to bfloat16, the JAX package also
  each product and its hub blocks);
- the AUC matrix's mask, written without a host wait through a dropped extra
  column, against the JAX package's ``mode="drop"`` scatter on a tile whose
  rows are shorter than ``max_train_degree`` and padded with user 0;
- the rule that picks the captured evaluations (one CUDA device, no mesh),
  and the CPU's eager evaluations, repeatable (``--inference sample``
  reseeds its generator each time);
- the top-k wrapper's counting: a launch under capture counted apart, a
  replay counted as its capture recorded.

The card's replays are held against its eager evaluations in
``tests/test_torch_kernels.py`` (marked ``cuda``) and in ``chip_smoke.py``'s
phases 6, 10 and 21.
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
from furusato_recommend_tpu.eval import evaluate as jev
from furusato_recommend_tpu.eval import metrics as jmet
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import params_from_jax
from furusato_recommend_tpu_torch.core.mesh import Mesh
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.eval import evaluate as tev
from furusato_recommend_tpu_torch.eval import metrics as tmet
from furusato_recommend_tpu_torch.eval.graphed import captured
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.ops import streaming_topk as st

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 90, 140, 16
TILE = 32  # eval_user_batch: 3 tiles, the last padded
EVERY_METRIC = dict(compute_auc=True, cold_start=True)


def _categories(seed=0):
    rng = np.random.default_rng(seed)
    cats = np.full((M_ITEMS, 3), -1, dtype=np.int32)
    for i in range(M_ITEMS):
        k = rng.integers(1, 4)
        cats[i, :k] = rng.choice(8, size=k, replace=False)
    return cats


def _datasets(hub_free: bool):
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=9, seed=4)
    if hub_free:
        g = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
                         hub_count=0, dst_hub_count=0)
        jd = dataclasses.replace(jd, _graph=g)
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=9, seed=4)
    return jd, td


def _exact_tables():
    """mf's tables: multiples of 1/8 (exact scores), every item with a twin."""
    rng = np.random.default_rng(1)
    u = (rng.integers(-2, 3, (N_USERS, DIM)) / 8).astype(np.float32)
    i = (rng.integers(-2, 3, (M_ITEMS, DIM)) / 8).astype(np.float32)
    i[1::2] = i[0::2]
    return {"user_emb": u, "item_emb": i}


# (registry key, compute type, the JAX graph hub-free, metrics rtol)
CASES = {
    "mf": ("mf", "float32", True, 1e-5),
    "lgn": ("lgn", "float32", True, 1e-5),
    "textsage": ("textsage", "float32", True, 1e-5),
    "lgn_bfloat16": ("lgn", "bfloat16", False, 2e-2),
}


def _models(key, compute_dtype, hub_free, **cfg):
    """(JAX dataset, port dataset, JAX config, port config, JAX model, port
    model, JAX parameters)."""
    jd, td = _datasets(hub_free)
    kw = dict(model=key, latent_dim=DIM, n_layers=2, compute_dtype=compute_dtype, topks=(5, 10),
              eval_user_batch=TILE, **cfg)
    inputs = {}
    if key == "textsage":
        kw.update(num_neighbors=3, user_feature="nwt", item_feature="nwt")
        inputs = ({"features": jfeatures(jd, JConfig(**kw), seed=1)},
                  {"features": synthetic_features(td, Config(**kw), seed=1)})
    jcfg, tcfg = JConfig(**kw), Config(**kw)
    jm = jbuild_model(key, jcfg, jd.graph, **(inputs[0] if inputs else {}))
    tm = build_model(key, tcfg, td.graph, **(inputs[1] if inputs else {}))
    if key == "mf":
        p = _exact_tables()
    elif key == "lgn":
        rng = np.random.default_rng(1)
        p = {"user_emb": (0.1 * rng.standard_normal((N_USERS, DIM))).astype(np.float32),
             "item_emb": (0.1 * rng.standard_normal((M_ITEMS, DIM))).astype(np.float32)}
    else:
        p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params_from_jax(p, tm)
    return jd, td, jcfg, tcfg, jm, tm, p


def _max_degree(ds) -> int:
    return int(np.bincount(ds.train_user, minlength=ds.n_users).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluation_matches_jax_with_every_metric(case, monkeypatch):
    key, cdt, hub_free, rtol = CASES[case]
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)  # a bfloat16 block whatever the type
    jd, td, jcfg, tcfg, jm, tm, p = _models(key, cdt, hub_free, **EVERY_METRIC)
    cats = _categories()
    jres, jshown = jev.Evaluator(jm, jd.graph, jcfg, _max_degree(jd))(
        jax.tree_util.tree_map(jnp.asarray, p), jev.build_eval_data(jd, TILE, cats))
    ev = tev.Evaluator(tm, td.graph, tcfg, _max_degree(td))
    tres, tshown = ev(tev.build_eval_data(td, TILE, cats))
    assert ev.graphed is None  # the CPU evaluates eagerly
    assert set(tres) == set(jres)
    assert {"auc@10", "cold_recall@5", "cold_auc@5", "diversity@10", "novelty@5", "coverage@10"} <= set(tres)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=rtol, atol=1e-7, err_msg=k)
    if cdt == "float32":
        np.testing.assert_array_equal(tshown, jshown)


@pytest.mark.parametrize("key", ["mf", "lgn"])  # with and without the sigmoid
def test_auc_mask_matches_jax_with_padded_rows(key):
    jd, td, jcfg, tcfg, jm, tm, _ = _models(key, "float32", True, compute_auc=True)
    pad_to = _max_degree(td) + 3  # every row shorter than the padded width
    deg = np.diff(td.graph.user_pos.indptr.numpy())
    users = np.concatenate([np.argsort(deg)[[0, 1, -2, -1]], np.arange(10, 20), np.zeros(6, int)]).astype(np.int32)
    valid = np.arange(len(users)) < len(users) - 6  # the last six rows pad the tile with user 0
    rng = np.random.default_rng(2)
    u = (rng.integers(-4, 5, (N_USERS, DIM)) / 8).astype(np.float32)
    i = (rng.integers(-4, 5, (M_ITEMS, DIM)) / 8).astype(np.float32)
    want = jev.Evaluator(jm, jd.graph, jcfg, pad_to)._score_tile(
        jnp.asarray(u), jnp.asarray(i), jd.graph, jnp.asarray(users))
    got = tev.Evaluator(tm, td.graph, tcfg, pad_to)._scores(
        torch.from_numpy(u), torch.from_numpy(i), torch.from_numpy(users))
    assert got.shape == (len(users), M_ITEMS)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy() == tev.MASK_SENTINEL, want == jev.MASK_SENTINEL)
    assert (want == jev.MASK_SENTINEL).sum() == deg[users].sum()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    want_auc = jmet.batch_auc_sum(jnp.asarray(want), jnp.asarray(users), jnp.asarray(valid), jd.graph.test_pos,
                                  float(jev.MASK_SENTINEL))
    got_auc = tmet.batch_auc_sum(got, torch.from_numpy(users), torch.from_numpy(valid), td.graph.test_pos,
                                 float(tev.MASK_SENTINEL))
    np.testing.assert_allclose(float(got_auc), float(want_auc), rtol=1e-5)


def test_the_rule_captures_only_cuda_without_a_mesh():
    """Only CUDA is captured; a mesh's evaluation too (its collectives run
    between its two graphs), but not under --inference sample, whose
    gathers over data sit inside the propagation."""
    mesh = Mesh(2, 1, 0, torch.device("cpu"), {})
    assert captured(None, "cuda") and captured(None, torch.device("cuda", 1))
    assert not captured(None, "cpu") and not captured(None, torch.device("cpu"))
    assert captured(mesh, "cuda") and not captured(mesh, "cpu")
    ds = tds.synthetic_dataset(n_users=40, m_items=30, avg_degree=4, seed=0)
    cfg = Config(model="textsage", latent_dim=8)
    model = build_model("textsage", cfg, ds.graph, features=synthetic_features(ds, cfg, seed=0))
    assert captured(mesh, "cuda", cfg, model, evaluation=True)
    assert not captured(mesh, "cuda", cfg.replace(inference="sample"), model, evaluation=True)
    assert captured(None, "cuda", cfg.replace(inference="sample"), model, evaluation=True)


@pytest.mark.parametrize("inference", ["all", "sample"])
def test_the_cpu_evaluator_runs_eagerly_and_repeats(inference):
    """Two evaluations of one Evaluator on the CPU: both eager (no graph),
    equal; --inference sample draws its trees from the Evaluator's
    generator, seeded with config.seed each time, so they repeat, and
    leaves torch's default generator where it was."""
    _, td, _, tcfg, _, tm, _ = _models("textsage", "float32", True, inference=inference, sample_infer_chunk=32,
                                       **EVERY_METRIC)
    ev = tev.Evaluator(tm, td.graph, tcfg, _max_degree(td))
    data = tev.build_eval_data(td, TILE, _categories())
    state = torch.random.get_rng_state()
    first, again = ev(data), ev(data)
    assert ev.graphed is None
    assert (ev.generator is not None) == (inference == "sample")
    assert torch.equal(torch.random.get_rng_state(), state)
    assert first[0] == again[0]
    np.testing.assert_array_equal(first[1], again[1])
    for x, y in zip(ev.evaluate(data), ev.evaluate(data)):  # the tensors a graph would return
        pairs = zip(x.values(), y.values()) if isinstance(x, dict) else [(x, y)]
        assert all(torch.equal(a, b) for a, b in pairs)


def test_topk_counts_launches_under_capture_apart(monkeypatch):
    """A top-k call on CUDA tensors counts its launch in ``launches`` (the
    radix select's also in ``wide_launches``), one made while a stream is
    captured in ``captured`` (``wide_captured``) instead; a replay adds what
    its capture recorded."""
    for name in ("launches", "wide_launches", "captured", "wide_captured"):
        monkeypatch.setattr(st, name, 0)

    def counts():
        return st.launches, st.wide_launches, st.captured, st.wide_captured

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    st._count(wide=False)
    st._count(wide=True)
    assert counts() == (2, 1, 0, 0)
    capturing[0] = True
    for wide in (False, True, True):
        st._count(wide=wide)
    assert counts() == (2, 1, 3, 2)
    st.count_replay(3, 2)
    st.count_replay(4)
    assert counts() == (9, 3, 3, 2)
