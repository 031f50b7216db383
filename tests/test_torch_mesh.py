"""Port vs JAX package: the mesh's pieces, on the CPU. The port runs in
worlds of 4 gloo processes (``tests/torch_world.py``), the JAX package on its
8 virtual CPU devices.

- ``sharded_masked_topk`` at mesh (2, 2) and (1, 4) against JAX
  ``sharded_masked_topk`` on a (2, 2) mesh: a catalog of M = 262 rows (not
  divisible by the model size), ``m_valid``, the sigmoid, a user whose
  positives cover all but 3 items (so masked items rank): values within rtol
  1e-5, ids equal; and k = 200 above a (1, 4) shard's 66 rows against the
  plain top-k over the whole catalog;
- ``sharded_embedding_lookup``'s rows and gradient (ids sharded over data,
  repeated ids included) against JAX's on a (4, 2) mesh: rtol 1e-6 / equal;
- ``shard_params``' choice of row-sharded parameters for lgn, textsage and
  textsage_id against JAX ``shard_params`` on a (4, 2) mesh, and the blocks
  it leaves on a rank;
- one sharded lgn step (float32, 2048 users x 1024 items, both tables
  sharded) at (2, 2) against JAX ``make_sharded_train_step`` on a (4, 2) mesh
  from the same parameters and batch: loss rtol 1e-5, parameters rtol 1e-4,
  atol 1e-5 (the JAX package's own mesh test's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_world import run_world

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.core.mesh import make_mesh as jmake_mesh, shard_params as jshard_params, table_sharding
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data.features import synthetic_features as jsynthetic_features
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.eval.sharded import MASK_SENTINEL, sharded_masked_topk as jsharded_topk
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.ops.sharded_embedding import sharded_embedding_lookup as jlookup
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu.train.sharding import make_sharded_train_step as jmake_step, shard_batch as jshard
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import flatten_params
from furusato_recommend_tpu_torch.core.mesh import Mesh, shard_params, sharded_names
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models.registry import build_model

torch.set_num_threads(1)

B, M, D = 16, 262, 8
# (k, sigmoid, m_valid)
TOPK_CASES = ((10, False, None), (20, True, 250), (10, False, 240))


def _topk_inputs(seed=0):
    rng = np.random.default_rng(seed)
    users = rng.standard_normal((B, D)).astype(np.float32)
    items = rng.standard_normal((M, D)).astype(np.float32)
    pos = rng.integers(0, M, (B, 6)).astype(np.int32)
    pmask = rng.random((B, 6)) < 0.7
    rows = [sorted(set(pos[b][pmask[b]].tolist())) for b in range(B)]
    rows[0] = sorted(set(range(M)) - {5, 77, 200})  # all but three items masked: sentinels rank
    wide = max(len(r) for r in rows)
    dense_ids = np.zeros((B, wide), np.int32)
    dense_mask = np.zeros((B, wide), bool)
    for b, r in enumerate(rows):
        dense_ids[b, : len(r)], dense_mask[b, : len(r)] = r, True
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    indices = np.concatenate([np.asarray(r, np.int32) for r in rows])
    return users, items, dense_ids, dense_mask, indptr, indices


_TOPK_CHILD = '''
from furusato_recommend_tpu_torch.core.mesh import DATA_AXIS, make_mesh
from furusato_recommend_tpu_torch.data.graph import CSR
from furusato_recommend_tpu_torch.eval.sharded import item_block, local_mask, sharded_masked_topk
z = np.load(f"{OUT}/topk_inputs.npz")
mesh = make_mesh(*ARGS["mesh"])
user_emb, items = torch.from_numpy(z["users"]), torch.from_numpy(z["items"])
pos = CSR(torch.from_numpy(z["indptr"]), torch.from_numpy(z["indices"]))
per = user_emb.shape[0] // mesh.data
users = torch.arange(mesh.index(DATA_AXIS) * per, (mesh.index(DATA_AXIS) + 1) * per)
out = {}
for i, (k, sigmoid, m_valid) in enumerate(ARGS["cases"]):
    mask = local_mask(pos, items.shape[0], mesh, items.shape[0] if m_valid is None else m_valid)
    v, ids = sharded_masked_topk(user_emb, item_block(items, mesh), users, k, mask, mesh, sigmoid=sigmoid)
    out[f"v{i}"], out[f"i{i}"] = v.numpy(), ids.numpy()
np.savez(f"{OUT}/topk_{RANK}.npz", **out)
'''


def _port_topk(tmp_path, mesh, cases):
    """Each case's [B, k] values and ids, assembled from the data ranks (and
    checked equal on the model ranks)."""
    run_world(_TOPK_CHILD, 4, tmp_path, {"mesh": mesh, "cases": cases})
    per_rank = [np.load(tmp_path / f"topk_{r}.npz") for r in range(4)]
    data, model = mesh
    out = []
    for i in range(len(cases)):
        for key in (f"v{i}", f"i{i}"):
            for d in range(data):
                for m in range(1, model):
                    np.testing.assert_array_equal(per_rank[d * model + m][key], per_rank[d * model][key])
        out.append(tuple(np.concatenate([per_rank[d * model][key] for d in range(data)])
                         for key in (f"v{i}", f"i{i}")))
    return out


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_sharded_masked_topk_matches_jax(mesh, tmp_path):
    users, items, dense_ids, dense_mask, indptr, indices = _topk_inputs()
    np.savez(tmp_path / "topk_inputs.npz", users=users, items=items, indptr=indptr, indices=indices)
    cases = list(TOPK_CASES) + ([(200, False, None)] if mesh == (1, 4) else [])
    got = _port_topk(tmp_path, mesh, cases)
    jmesh = jmake_mesh(2, 2)
    for (k, sigmoid, m_valid), (v, ids) in zip(cases, got):
        if k <= M // 2:  # JAX takes lax.top_k of each (2, 2) shard: k <= its rows
            jv, ji = jsharded_topk(jnp.asarray(users), jnp.asarray(items), jnp.asarray(dense_ids),
                                   jnp.asarray(dense_mask), k, jmesh, sigmoid=sigmoid, m_valid=m_valid)
            np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5)
            np.testing.assert_array_equal(ids, np.asarray(ji))
        # the plain top-k over the whole catalog: value descending, id ascending
        s = users @ items.T
        s = 1.0 / (1.0 + np.exp(-s)) if sigmoid else s
        s = s.astype(np.float32)
        for b in range(B):
            s[b, dense_ids[b][dense_mask[b]]] = MASK_SENTINEL
        s[:, M if m_valid is None else m_valid:] = MASK_SENTINEL
        order = np.lexsort((np.broadcast_to(np.arange(M), s.shape), -s), axis=1)[:, :k]
        np.testing.assert_array_equal(ids, order)
        np.testing.assert_allclose(v, np.take_along_axis(s, order, axis=1), rtol=1e-5)
        assert (v[0, 3:] == MASK_SENTINEL).all()  # the dense row: three items, then masked ones


_LOOKUP_CHILD = '''
from furusato_recommend_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from furusato_recommend_tpu_torch.ops.sharded_embedding import sharded_embedding_lookup
mesh = make_mesh(2, 2)
z = np.load(f"{OUT}/lookup_inputs.npz")
out = {}
for name in ("a", "b"):
    table, ids = torch.from_numpy(z[f"table_{name}"]), torch.from_numpy(z[f"ids_{name}"])
    rows, per = table.shape[0] // mesh.model, ids.shape[0] // mesh.data
    block = table[mesh.index(MODEL_AXIS) * rows : (mesh.index(MODEL_AXIS) + 1) * rows].clone().requires_grad_(True)
    mine = ids[mesh.index(DATA_AXIS) * per : (mesh.index(DATA_AXIS) + 1) * per]
    vals = sharded_embedding_lookup(block, mine, mesh)
    torch.sum(vals ** 2).backward()
    out[f"vals_{name}"], out[f"grad_{name}"] = vals.detach().numpy(), block.grad.numpy()
np.savez(f"{OUT}/lookup_{RANK}.npz", **out)
'''


def test_sharded_embedding_lookup_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    inputs = {
        "table_a": rng.standard_normal((64, 16)).astype(np.float32),
        "ids_a": rng.integers(0, 64, size=32).astype(np.int32),
        "table_b": np.ones((16, 4), np.float32),
        "ids_b": np.asarray([0, 3, 3, 15], np.int32),
    }
    np.savez(tmp_path / "lookup_inputs.npz", **inputs)
    run_world(_LOOKUP_CHILD, 4, tmp_path)
    ranks = [np.load(tmp_path / f"lookup_{r}.npz") for r in range(4)]
    jmesh = jmake_mesh(data=4, model=2)
    for name in ("a", "b"):
        table = jax.device_put(jnp.asarray(inputs[f"table_{name}"]), table_sharding(jmesh))
        ids = jnp.asarray(inputs[f"ids_{name}"])
        want = np.asarray(jlookup(table, ids, jmesh))
        want_g = np.asarray(jax.grad(lambda t: jnp.sum(jlookup(t, ids, jmesh) ** 2))(table))
        vals = np.concatenate([ranks[0][f"vals_{name}"], ranks[2][f"vals_{name}"]])  # data ranks, model rank 0
        np.testing.assert_allclose(vals, want, rtol=1e-6)
        np.testing.assert_array_equal(ranks[1][f"vals_{name}"], ranks[0][f"vals_{name}"])
        grad = np.concatenate([ranks[0][f"grad_{name}"], ranks[1][f"grad_{name}"]])  # model ranks
        np.testing.assert_allclose(grad, want_g, rtol=1e-6)
        np.testing.assert_array_equal(ranks[2][f"grad_{name}"], ranks[0][f"grad_{name}"])  # summed over data


def _fake_mesh(data, model, rank):
    return Mesh(data, model, rank, torch.device("cpu"), {})


@pytest.mark.parametrize("name", ["lgn", "textsage", "textsage_id"])
def test_shard_params_choice_matches_jax(name):
    jd = jds.synthetic_dataset(n_users=2048, m_items=1000, avg_degree=4, seed=0)
    td = tds.synthetic_dataset(n_users=2048, m_items=1000, avg_degree=4, seed=0)
    kw = dict(model=name, latent_dim=16, user_feature="nwt", item_feature="nwt")
    if name == "lgn":
        jm, tm = jbuild_model(name, JConfig(**kw), jd.graph), build_model(name, Config(**kw), td.graph)
    else:
        jm = jbuild_model(name, JConfig(**kw), jd.graph, features=jsynthetic_features(jd, JConfig(**kw), seed=0))
        tm = build_model(name, Config(**kw), td.graph, features=synthetic_features(td, Config(**kw), seed=0))
    placed = jshard_params(jm.init(jax.random.PRNGKey(0)), jmake_mesh(4, 2))
    jax_sharded = sorted(k for k, x in flatten_params(placed).items() if x.sharding.spec[:1] == ("model",))
    shapes = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert sharded_names(shapes, 2) == jax_sharded
    assert bool(jax_sharded) == (name != "textsage")
    full = {k: p.detach().clone() for k, p in tm.named_parameters()}
    shards = shard_params(tm, _fake_mesh(4, 2, rank=3))  # model rank 1
    assert shards.names == jax_sharded
    for k, p in tm.named_parameters():
        want = full[k][full[k].shape[0] // 2 :] if k in jax_sharded else full[k]
        assert torch.equal(p.detach(), want), k


_STEP_CHILD = '''
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import params_from_jax
from furusato_recommend_tpu_torch.core.mesh import make_mesh
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.train.sharding import make_sharded_train_step
z = np.load(f"{OUT}/step_inputs.npz")
td = tds.synthetic_dataset(**ARGS["data"])
cfg = Config(**ARGS["config"])
model = build_model("lgn", cfg, td.graph)
params_from_jax({"user_emb": z["user_emb"], "item_emb": z["item_emb"]}, model)
mesh = make_mesh(2, 2)
init_fn, step_fn = make_sharded_train_step(model, td.graph, cfg, mesh)
shards, opt = init_fn()
loss = step_fn(shards, opt, BPRBatch(*(torch.from_numpy(z[k]) for k in ("user", "pos", "neg", "valid"))))
np.savez(f"{OUT}/step_{RANK}.npz", loss=float(loss), sharded=np.array(shards.names),
         **{k: shards.gather(p).numpy() for k, p in model.named_parameters()})
'''


def test_sharded_lgn_step_matches_jax(tmp_path):
    data = dict(n_users=2048, m_items=1024, avg_degree=6, seed=2)
    config = dict(model="lgn", latent_dim=16, n_layers=2, compute_dtype="float32", decay=1e-2, lr=0.05)
    jd = jds.synthetic_dataset(**data)
    g = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
                     hub_count=0, dst_hub_count=0)
    jd = dataclasses.replace(jd, _graph=g)
    jm = jbuild_model("lgn", JConfig(**config), jd.graph)
    rng = np.random.default_rng(0)
    ap, b = jd.all_pos(), 512
    user = rng.integers(0, data["n_users"], b)
    arrs = {"user": user.astype(np.int32), "pos": np.array([rng.choice(ap[u]) for u in user], np.int32),
            "neg": rng.integers(0, data["m_items"], b).astype(np.int32), "valid": np.arange(b) < b - 24}
    params = {k: (0.1 * rng.standard_normal((n, 16))).astype(np.float32)
              for k, n in (("user_emb", data["n_users"]), ("item_emb", data["m_items"]))}
    np.savez(tmp_path / "step_inputs.npz", **arrs, **params)
    run_world(_STEP_CHILD, 4, tmp_path, {"data": data, "config": config})

    jmesh = jmake_mesh(4, 2)
    _, step_fn = jmake_step(jm, jd.graph, JConfig(**config), jmesh, optax.adam(config["lr"]))
    rep = NamedSharding(jmesh, P())
    jp = {k: jax.device_put(jnp.asarray(v), table_sharding(jmesh)) for k, v in params.items()}
    opt = jax.device_put(optax.adam(config["lr"]).init(jp), rep)
    batch = jshard(JBatch(*(jnp.asarray(arrs[k]) for k in ("user", "pos", "neg", "valid"))), jmesh)
    with jmesh:
        jp, _, jloss = step_fn(jp, opt, batch, jax.random.PRNGKey(2))
    for r in range(4):
        got = np.load(tmp_path / f"step_{r}.npz")
        assert sorted(got["sharded"].tolist()) == ["item_emb", "user_emb"]
        np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-4, atol=1e-5)
