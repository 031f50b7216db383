"""Port vs JAX package: the registry keys whose sampled-tree training had no
gradient check of its own (``models/registry.py``), and the row gathers a
training step of each makes.

- The SAGE keys ``textsage_id``, ``sage``, ``fsage`` (id embeddings, node
  width 2d), ``fastsage`` (``sage_w2``), ``lightsage`` (``light``, the layer
  mean), ``pinsage`` (the conv, its per-layer L2 normalisation and head),
  ``mrec`` (the towers) and ``gnn --conv gcn | ggnn``: the loss, its bpr / reg
  parts and every parameter's gradient on fanout trees sampled by the JAX
  package and handed to both, dropout 0, against
  ``jax.value_and_grad(model.loss)``. Same numpy data as
  ``test_torch_sage.py`` (``synthetic_dataset(100, 140, avg_degree=8,
  seed=7)``, ``synthetic_features(seed=1)``, features n / w / t, the JAX
  initial parameters carried across by ``params_from_jax``) on the hub-free
  float32 graph with the JAX text hub off: loss rtol 1e-5; gradients rtol
  1e-4, atol 1e-7 (they sum many small products in another order), but
  pinsage's at atol 1e-6: the backward of its per-layer L2 normalisation
  keeps only the part of a gradient orthogonal to the layer's output, a
  small remainder of larger terms, and the float32 GEMMs' rounding shows
  there (PyTorch's CPU BLAS rounds a float32 product more coarsely than
  XLA's CPU dot, so the two part by more than the other keys' do).
- ``rgcn``: the loss and gradients against JAX's as ``test_torch_train.py``
  holds lgn's: float32 on the hub-free graph (rtol 1e-5; gradients rtol 1e-4,
  atol 1e-7) and the bfloat16 default (rtol 2e-2, atol 2e-3; gradients atol
  5e-5).
- The ``table_gather`` calls one training step of each configuration that
  ``chip_smoke.py`` phase 20 drives makes, counted by wrapping the port's
  ``table_gather`` wherever a model module bound it: each call's backward is
  one ``scatter_add_rows`` launch on the card, and phase 20 asserts those
  launches from ``chip_smoke.scatter_per_step``, which must equal the counts
  pinned here.
"""

import dataclasses
import functools
import importlib.util
import pathlib
import sys

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
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import flatten_params, params_from_jax
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models.registry import SAGE_KEYS, build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.ops import scatter as sc
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM, B = 100, 140, 16, 48
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data():
    """The hub-free and default JAX datasets and the port's, same arrays."""
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    g = jbuild_graph(
        jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
        hub_count=0, dst_hub_count=0,
    )
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    return {"hub_free": dataclasses.replace(jd, _graph=g), "default": jd}, td


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _both(data, name, compute_dtype="float32", **cfg):
    """(jax dataset, port dataset, jax model, port model, jax params); the
    SAGE keys with features n / w / t."""
    jsets, td = data
    jd = jsets["hub_free" if compute_dtype == "float32" else "default"]
    kw = dict(model=name, latent_dim=DIM, n_layers=2, num_neighbors=3, user_feature="nwt",
              item_feature="nwt", compute_dtype=compute_dtype, decay=1e-2, **cfg)
    feats = {}
    if name in SAGE_KEYS:
        feats = {"j": {"features": jfeatures(jd, JConfig(**kw), seed=1)},
                 "t": {"features": synthetic_features(td, Config(**kw), seed=1)}}
    jm = jbuild_model(name, JConfig(**kw), jd.graph, **feats.get("j", {}))
    tm = build_model(name, Config(**kw), td.graph, **feats.get("t", {}))
    p = jm.init(jax.random.PRNGKey(0))
    params_from_jax(_np(p), tm)
    return jd, td, jm, tm, p


def _batch(td, seed=0):
    """A BPR batch from numpy: a positive from each user's row, a random
    negative, the last 5 rows invalid."""
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(0, N_USERS, B)
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, B)
    valid = np.ones(B, dtype=bool)
    valid[-5:] = False
    arrs = [a.astype(np.int32) for a in (user, pos, neg)] + [valid]
    return JBatch(*(jnp.asarray(a) for a in arrs)), BPRBatch(*(torch.from_numpy(a) for a in arrs))


@pytest.fixture
def no_text_hub_no_dropout(monkeypatch):
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
    monkeypatch.setattr(jsage, "DROPOUT_RATE", 0.0)
    monkeypatch.setattr(tsage, "DROPOUT_RATE", 0.0)


# ---- the sampled-tree loss and gradients of the SAGE keys ----
SAGE_CASES = [
    ("textsage_id", {}),
    ("sage", {}),
    ("fsage", {}),
    ("fastsage", {}),
    ("lightsage", {}),
    ("pinsage", {}),
    ("mrec", {}),
    ("gnn", {"conv": "gcn"}),
    ("gnn", {"conv": "ggnn"}),
]


GRAD_ATOL = {"pinsage": 1e-6}  # module docstring


@pytest.mark.parametrize("name,cfg", SAGE_CASES, ids=[f"{n}-{c.get('conv', '')}".rstrip("-") for n, c in SAGE_CASES])
def test_sampled_loss_and_grads_match_jax(data, no_text_hub_no_dropout, name, cfg):
    jd, td, jm, tm, p = _both(data, name, **cfg)
    jb, tb = _batch(td)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    seeds = ((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item"))
    jtrees = [jm.sample_seed_tree(jd.graph, s, side, k) for (s, side), k in zip(seeds, keys)]
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda q: jm.loss(q, jd.graph, jb, jax.random.PRNGKey(1), trees=jtrees), has_aux=True
    ))(p)
    trees = [[SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in t] for t in jtrees]
    tl, taux = tm.loss(td.graph, tb, trees=trees)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("bpr", "reg"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-5)
    want = flatten_params(_np(jg))
    got = dict(tm.named_parameters())
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for n_, prm in got.items():
        np.testing.assert_allclose(prm.grad.numpy(), want[n_], rtol=1e-4, atol=GRAD_ATOL.get(name, 1e-7), err_msg=n_)


# ---- rgcn ----
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_rgcn_loss_and_grads_match_jax(data, compute_dtype):
    jd, td, jm, tm, _ = _both(data, "rgcn", compute_dtype)
    rng = np.random.default_rng(0)
    p = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in
         (("user_emb", tm.user_emb), ("item_emb", tm.item_emb))}
    params_from_jax(p, tm)
    jb, tb = _batch(td)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda q: jm.loss(q, jd.graph, jb, jax.random.PRNGKey(0)), has_aux=True
    ))(jax.tree_util.tree_map(jnp.asarray, p))
    tl, taux = tm.loss(td.graph, tb)
    tl.backward()
    exact = compute_dtype == "float32"
    rtol, atol = (1e-5, 1e-6) if exact else (2e-2, 2e-3)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=rtol, atol=atol)
    for k in ("bpr", "reg"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=rtol, atol=atol)
    g_rtol, g_atol = (1e-4, 1e-7) if exact else (2e-2, 5e-5)
    for k in ("user_emb", "item_emb"):
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(), np.asarray(jg[k]), rtol=g_rtol, atol=g_atol)


# ---- the table gathers of a training step ----
@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_registry", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: (key, config fields, table_gather calls a step): the MF / LightGCN keys
#: gather the batch rows once (mf) or from the propagated and the ego tables
#: (4); the SAGE keys once a side for every level of the step's three trees,
#: nssage its batch rows once a side from the full propagation
GATHER_CASES = [
    ("mf", {}, 2),
    ("rgcn", {}, 4),
    ("radj", {}, 4),
    ("lgcnssm", {}, 4),
    ("textsage_id", {}, 2),
    ("sage", {}, 2),
    ("fsage", {}, 2),
    ("fastsage", {}, 2),
    ("lightsage", {}, 2),
    ("pinsage", {}, 2),
    ("mrec", {}, 2),
    ("nssage", {}, 2),
    ("gnn", {"conv": "gcn"}, 2),
    ("gnn", {"conv": "ggnn"}, 2),
]


@pytest.mark.parametrize("name,cfg,calls", GATHER_CASES,
                         ids=[f"{n}-{c.get('conv', '')}".rstrip("-") for n, c, _ in GATHER_CASES])
def test_table_gathers_per_training_step(data, monkeypatch, name, cfg, calls):
    _, td = data
    sage = name in SAGE_KEYS
    config = Config(model=name, latent_dim=DIM, n_layers=2, num_neighbors=3, bpr_batch_size=B,
                    user_feature="nwt", item_feature="nwt", eval_user_batch=64, **cfg)
    feats = {"features": synthetic_features(td, config, seed=1)} if sage else {}
    model = build_model(name, config, td.graph, generator=torch.Generator().manual_seed(0), **feats)
    trainer = Trainer(config, td, model, logger=MetricLogger(quiet=True), ddp_recipe=sage, device="cpu")
    batch = trainer.sample_epoch().slice(0, B)
    seen = []

    def counted(table, ids):
        seen.append((tuple(table.shape), table.requires_grad))
        return original(table, ids)

    original = sc.table_gather
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("furusato_recommend_tpu_torch") and \
                getattr(mod, "table_gather", None) is original:
            monkeypatch.setattr(mod, "table_gather", counted)
    losses = trainer.train_epoch([batch])
    assert torch.isfinite(losses).all()
    assert len(seen) == calls, seen
    assert _chip_smoke().scatter_per_step(name) == calls
    # every call gathers from a table the step differentiates, so its backward
    # is one scatter, at the node width (2d for the id-embedding keys)
    assert all(grad for _, grad in seen), seen
    assert {shape[1] for shape, _ in seen} == {DIM * (2 if name in ("textsage_id", "sage", "fsage") else 1)}, seen
