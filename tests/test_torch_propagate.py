"""Port vs JAX package: full-graph propagation of mf / lgn / radj with the same
parameters (carried across by ``params_from_jax``).

- float32 contract: the JAX graph has no hub-dense blocks and
  compute_dtype="float32"; only the summation order differs, so rtol 1e-5,
  atol 1e-6.
- bfloat16 default: both round x and the weights to bfloat16, but the JAX
  package also rounds each product to bfloat16 and runs its hub nodes through
  bfloat16 dense blocks; rtol 2e-2, atol 2e-3.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import params_from_jax, params_to_numpy
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.models.registry import available_models, build_model

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 90, 110, 16


def _params(name, seed=0):
    rng = np.random.default_rng(seed)
    std = 1.0 if name == "mf" else 0.1
    return {
        "user_emb": (std * rng.standard_normal((N_USERS, DIM))).astype(np.float32),
        "item_emb": (std * rng.standard_normal((M_ITEMS, DIM))).astype(np.float32),
    }


def _jax_dataset(hub_free: bool):
    ds = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=1)
    if not hub_free:
        return ds
    g = jbuild_graph(
        ds.train_user, ds.train_item, ds.test_user, ds.test_item, ds.n_users, ds.m_items,
        hub_count=0, dst_hub_count=0,
    )
    return dataclasses.replace(ds, _graph=g)


def _both(name, compute_dtype):
    hub_free = compute_dtype == "float32"
    jd = _jax_dataset(hub_free)
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=1)
    kw = dict(model=name, latent_dim=DIM, n_layers=2, compute_dtype=compute_dtype, r=0.3)
    jm = jbuild_model(name, JConfig(**kw), jd.graph)
    tm = build_model(name, Config(**kw), td.graph)
    p = _params(name)
    params_from_jax(p, tm)
    return jd, td, jm, tm, p


@pytest.mark.parametrize(
    "name,compute_dtype,rtol,atol",
    [
        ("lgn", "float32", 1e-5, 1e-6),
        ("radj", "float32", 1e-5, 1e-6),
        ("mf", "float32", 1e-5, 1e-6),
        ("lgn", "bfloat16", 2e-2, 2e-3),
        ("radj", "bfloat16", 2e-2, 2e-3),
        ("mf", "bfloat16", 2e-2, 2e-3),
    ],
)
def test_propagate_matches_jax(name, compute_dtype, rtol, atol):
    jd, td, jm, tm, p = _both(name, compute_dtype)
    ju, ji = jm.propagate(jax.tree_util.tree_map(jax.numpy.asarray, p), jd.graph)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["lgn", "mf"])
def test_score_users_matches_jax(name):
    jd, td, jm, tm, p = _both(name, "float32")
    users = np.array([0, 5, 17, 89], dtype=np.int32)
    want = jm.score_users(jax.tree_util.tree_map(jax.numpy.asarray, p), jd.graph, users)
    with torch.no_grad():
        got = tm.score_users(td.graph, torch.from_numpy(users).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_params_round_trip_and_registry():
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=1)
    cfg = Config(latent_dim=DIM)
    tm = build_model("lgn", cfg, td.graph)
    p = _params("lgn", seed=3)
    out = params_to_numpy(params_from_jax(p, tm))
    assert out.keys() == p.keys()
    for k in p:
        np.testing.assert_array_equal(out[k], p[k])
    with pytest.raises(ValueError):
        params_from_jax({"user_emb": p["user_emb"][:3], "item_emb": p["item_emb"]}, tm)
    with pytest.raises(KeyError):
        params_from_jax({"user_emb": p["user_emb"]}, tm)
    assert {"lgcnssm", "lgn", "mf", "radj", "rgcn", "textsage"} <= set(available_models())
    for missing in ("nope",):
        with pytest.raises(KeyError, match="available"):
            build_model(missing, cfg, td.graph)
    with pytest.raises(ValueError, match="features"):  # the SAGE family needs them
        build_model("textsage", cfg, td.graph)


def test_init_is_seeded():
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=1)
    cfg = Config(latent_dim=DIM, seed=5)
    a = params_to_numpy(build_model("lgn", cfg, td.graph))
    b = params_to_numpy(build_model("lgn", cfg, td.graph))
    np.testing.assert_array_equal(a["user_emb"], b["user_emb"])
    assert 0.05 < a["user_emb"].std() < 0.2  # 0.1 * N(0, 1)
    mf = params_to_numpy(build_model("mf", cfg, td.graph))
    assert 0.8 < mf["item_emb"].std() < 1.2  # N(0, 1)
    pre = build_model("mf", cfg, td.graph, pretrained=(a["user_emb"], a["item_emb"]))
    np.testing.assert_array_equal(params_to_numpy(pre)["user_emb"], a["user_emb"])
