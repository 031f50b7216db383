"""Port vs JAX package: the edge-feature SAGE models (``rsage`` over its
relational message graph, ``tgsrec``, ``sasgnn``): the message graph and
``build_relational_graph``, ``load_relation_edges``, the ``relational_*`` /
``temporal`` / ``recency`` convs, the SAGE model over them (propagate, loss,
gradients, ``encode_seeds``, three Adam steps, one R = 8 block), the
registry keys, the parameter and Adam-state conversion, the CLI's inputs and
the server.

Same numpy data in both packages: ``synthetic_dataset(60, 80, avg_degree=6,
seed=3)`` with every edge of user 0 and item 0 taken out. The relation sets:
favourites, a seeded 40% of the train pairs (duplicates of purchases) plus
random pairs of which four touch user 0 (so user 0 has message edges and no
purchase) and none item 0 (still of degree zero in the message graph);
reviews, another seeded 20% of the train pairs. The purchase times are
quarters in [0, 1], so that many tie. The JAX package's initial parameters
come across through ``params_from_jax``; d = 16, 8 heads of 2. Each JAX
function is jitted once. Tolerances (those of ``test_torch_attention.py``):

- graph arrays: bit-equal;
- float32 forwards (the JAX graph without hub-dense blocks,
  ``compute_dtype="float32"``, its text hub off): rtol 1e-5, atol 1e-6
  (propagate and loss atol 1e-5);
- gradients: rtol 1e-4, atol 1e-6 of the gradient's largest magnitude where
  it exceeds 1;
- the bfloat16 default: rtol 2e-2, atol 2e-3;
- three Adam steps at lr 1e-3: every parameter within 1e-6 + 1e-5 |p|; one
  R = 8 block: rtol 1e-4, atol 1e-6 (``test_torch_cadence.py``'s).

Fanout trees come from the JAX package, dropout 0 in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data import features as jfeat
from furusato_recommend_tpu.data import graph as jgraph
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models import sage_convs as jconvs
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.ops import csr_search as jcsr
from furusato_recommend_tpu.ops import segment as jseg
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu_torch.config import Config, ddp_flagship_config
from furusato_recommend_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_numpy,
    flatten_params,
    params_from_jax,
    params_to_numpy,
)
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data import features as tfeat
from furusato_recommend_tpu_torch.data import graph as tgraph
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models import sage_convs as tconvs
from furusato_recommend_tpu_torch.models.registry import SAGE_KEYS, available_models, build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.ops.segment import spmm
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 60, 80, 16
TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=2e-2, atol=2e-3)
EDGE_CONVS = ["relational_add", "relational_sum", "relational_prod", "temporal", "recency"]
# (registry key, config fields) of the models this slice ports
MODELS = [
    ("rsage", {"multi_relational": "add"}),
    ("rsage", {"multi_relational": "sum"}),
    ("rsage", {"multi_relational": "prod"}),
    ("tgsrec", {}),
    ("sasgnn", {}),
]
MODEL_IDS = ["rsage-add", "rsage-sum", "rsage-prod", "tgsrec", "sasgnn"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _relations(train_user, train_item):
    rng = np.random.default_rng(11)
    e = len(train_user)
    fav = rng.choice(e, size=int(0.4 * e), replace=False)
    rand_u = np.concatenate([[0, 0, 0, 0], rng.integers(1, N_USERS, 8)])
    rand_i = rng.integers(1, M_ITEMS, 12)
    rev = rng.choice(e, size=int(0.2 * e), replace=False)
    return [
        (np.concatenate([train_user[fav], rand_u]).astype(np.int64),
         np.concatenate([train_item[fav], rand_i]).astype(np.int64)),
        (train_user[rev].astype(np.int64), train_item[rev].astype(np.int64)),
    ]


def _times(e, seed):
    """Purchase times in quarters of [0, 1]: many tie."""
    return (np.round(np.random.default_rng(seed).random(e) * 4) / 4).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    """The train arrays, relation sets, graphs (JAX hub-free and default,
    the port's) and the per-edge times and labels."""
    base = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=6, seed=3)
    keep = (base.train_user != 0) & (base.train_item != 0)
    arrays = (base.train_user[keep], base.train_item[keep], base.test_user, base.test_item)
    rel = _relations(arrays[0], arrays[1])
    jd = jds.Dataset(N_USERS, M_ITEMS, *arrays)
    td = tds.Dataset(N_USERS, M_ITEMS, *arrays)
    j_rel_default, j_labels = jgraph.build_relational_graph(jd, rel)
    t_rel, t_labels = tgraph.build_relational_graph(td, rel)
    np.testing.assert_array_equal(t_labels.numpy(), np.asarray(j_labels))
    jg = {
        "train": jgraph.build_bipartite_graph(*arrays, N_USERS, M_ITEMS, hub_count=0, dst_hub_count=0),
        "message": jgraph.build_bipartite_graph(*arrays, N_USERS, M_ITEMS, hub_count=0, dst_hub_count=0,
                                                extra_edges=rel),
        "message_default": j_rel_default,
    }
    tg = {"train": td.graph, "message": t_rel}
    e_train, e_msg = td.train_size, t_rel.prop_user_pos.nnz
    assert int(td.graph.user_degrees()[0]) == 0 and int(td.graph.item_degrees()[0]) == 0
    assert int(t_rel.prop_user_pos.degrees()[0]) == 4 and int(t_rel.prop_item_pos.degrees()[0]) == 0
    raw_time = _times(e_train, seed=5)
    return dict(
        arrays=arrays, rel=rel, jd=jd, td=td, jg=jg, tg=tg, labels=t_labels.numpy(),
        raw_time=raw_time, edge_time=tfeat.edge_time_in_csr_order(td, raw_time).numpy(),
        e_train=e_train, e_msg=e_msg,
    )


@pytest.fixture
def no_text_hub(monkeypatch):
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(jsage, "DROPOUT_RATE", 0.0)
    monkeypatch.setattr(tsage, "DROPOUT_RATE", 0.0)


# ---- the message graph ----
def _csr_equal(got, want, name):
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr), err_msg=name)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices), err_msg=name)
    assert got.indptr.dtype == got.indices.dtype == torch.int32, name


def test_message_graph_matches_jax(data):
    """build_bipartite_graph(extra_edges=) and build_relational_graph: every
    array bit-equal to JAX's (hub-free and default graphs alike), the prop_*
    accessors on the message CSRs, the train CSRs and the sampler's arrays
    unchanged, and .to() carrying the message CSRs."""
    jg, tg = data["jg"]["message"], data["tg"]["message"]
    for want_graph in (jg, data["jg"]["message_default"]):
        for name in ("user_pos", "item_pos", "test_pos", "msg_user_pos", "msg_item_pos"):
            _csr_equal(getattr(tg, name), getattr(want_graph, name), name)
        for name in ("item_edge_perm", "msg_item_edge_perm", "user_pos_row"):
            np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(want_graph, name)), name)
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(tg.norm_edges, name).numpy(), np.asarray(getattr(jg.norm_edges, name)))
    assert tg.prop_user_pos is tg.msg_user_pos and tg.prop_item_pos is tg.msg_item_pos
    assert tg.prop_item_edge_perm is tg.msg_item_edge_perm
    assert tg.prop_user_pos.nnz == data["e_msg"] == data["e_train"] + sum(len(u) for u, _ in data["rel"])
    assert tg.train_size == data["e_train"] and tg.max_user_degree == data["tg"]["train"].max_user_degree
    labels = data["labels"]
    assert labels.dtype == np.int32 and labels.shape == (data["e_msg"],)
    assert np.bincount(labels).tolist() == [data["e_train"]] + [len(u) for u, _ in data["rel"]]
    moved = tg.to("cpu")
    _csr_equal(moved.prop_user_pos, jg.msg_user_pos, "moved")
    np.testing.assert_array_equal(moved.prop_item_edge_perm.numpy(), np.asarray(jg.msg_item_edge_perm))


def test_graph_without_extra_edges_is_unchanged(data):
    tg, jg = data["tg"]["train"], data["jg"]["train"]
    plain = tgraph.build_bipartite_graph(*data["arrays"], N_USERS, M_ITEMS, extra_edges=None)
    for g in (tg, plain):
        assert g.msg_user_pos is None and g.msg_item_pos is None and g.msg_item_edge_perm is None
        assert g.prop_user_pos is g.user_pos and g.prop_item_pos is g.item_pos
        assert g.prop_item_edge_perm is g.item_edge_perm
        _csr_equal(g.prop_user_pos, jg.prop_user_pos, "user")
        _csr_equal(g.prop_item_pos, jg.prop_item_pos, "item")
        np.testing.assert_array_equal(g.prop_item_edge_perm.numpy(), np.asarray(jg.prop_item_edge_perm))


@pytest.mark.parametrize("graph", ["train", "message"])
@pytest.mark.parametrize("side", ["user", "item"])
def test_mean_aggregation_over_message_edges(data, graph, side):
    """The SAGE mean aggregation (the port's CSR SpMM and its transpose)
    against JAX segment_mean over the prop_* CSR, forward and gradient."""
    jg, tg = data["jg"][graph], data["tg"][graph]
    jc = jg.prop_user_pos if side == "user" else jg.prop_item_pos
    n_dst, n_src = (N_USERS, M_ITEMS) if side == "user" else (M_ITEMS, N_USERS)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n_src, DIM)).astype(np.float32)
    cot = rng.standard_normal((n_dst, DIM)).astype(np.float32)

    def jfn(v):
        return jseg.segment_mean(v[jc.indices], jcsr.csr_row_ids(jc), n_dst)

    want, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(x))
    a, a_t = tg.mean_aggregation(side).matrices(torch.float32)
    xt = _t(x, grad=True)
    got = spmm(a, xt, torch.float32, a_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TIGHT)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), **TIGHT)


def test_load_relation_edges_matches_jax(tmp_path):
    """The CSVs written by the JAX package's write_artifacts read back equal
    by both loaders (with a suffix too); None when a file is absent."""
    from furusato_recommend_tpu.preprocessing.artifacts import write_artifacts

    rng = np.random.default_rng(0)
    fav = (rng.integers(0, 50, 37), rng.integers(0, 70, 37))
    rev = (rng.integers(0, 50, 1), rng.integers(0, 70, 1))
    for sfx in ("", "_x"):
        write_artifacts(tmp_path, suffix=sfx, favorite_edges=fav, review_edges=rev)
        cfg = dict(suffix=sfx)
        want = jfeat.load_relation_edges(JConfig(**cfg), str(tmp_path))
        got = tfeat.load_relation_edges(Config(**cfg), tmp_path)
        assert len(got) == len(want) == 2
        for (gu, gi), (wu, wi), (su, si) in zip(got, want, (fav, rev)):
            assert gu.dtype == gi.dtype == np.int64
            for g, w, s in ((gu, wu, su), (gi, wi, si)):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, s)
    (tmp_path / "review_train.csv").unlink()
    assert jfeat.load_relation_edges(JConfig(), str(tmp_path)) is None
    assert tfeat.load_relation_edges(Config(), tmp_path) is None
    assert tfeat.load_relation_edges(Config(suffix="_x"), tmp_path) is not None


# ---- the convs ----
def test_get_conv_returns_every_edge_feature_conv():
    assert not hasattr(tconvs, "NOT_PORTED")
    for name in EDGE_CONVS:
        assert isinstance(tconvs.get_conv(name), tconvs.Conv)
    assert tconvs.N_HEADS == jconvs.N_HEADS == 8


def _conv_params(conv, gain=0.5):
    jp = jconvs.get_conv(conv).init(jax.random.PRNGKey(3), DIM, gain)
    fresh = tconvs.get_conv(conv).init(torch.Generator().manual_seed(0), DIM, gain)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {k: tuple(v.shape) for k, v in jp.items()}
    if conv == "temporal":
        np.testing.assert_array_equal(fresh["time_freq"].numpy(), np.asarray(jp["time_freq"]))
        # the frequencies of a unit time span 1 .. 1e-9: make them matter at this scale
        jp = dict(jp, time_freq=jp["time_freq"] * 3.0, time_phase=jnp.linspace(-1.0, 1.0, DIM))
    return _np(jp)


def _check_grads(jax_fn, torch_fn, inputs, seed):
    """Forward of both at ``inputs`` (a dict of numpy arrays) and the
    gradients of <out, cotangent> with respect to every float input; an
    input the function does not read (the mean a relational conv recomputes,
    the chain's rel_w / rel_b) has no gradient in torch and a zero one in
    JAX."""
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = jax_fn(jin)
    cot = np.random.default_rng(seed).standard_normal(np.shape(want)).astype(np.float32)
    floats = [k for k, v in inputs.items() if np.asarray(v).dtype == np.float32]
    jgrads = jax.jit(jax.grad(lambda q, rest: jnp.sum(jax_fn({**q, **rest}) * cot)))(
        {k: jin[k] for k in floats}, {k: v for k, v in jin.items() if k not in floats})
    tin = {k: _t(v, grad=k in floats) for k, v in inputs.items()}
    got = torch_fn(tin)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TIGHT)
    (got * torch.from_numpy(cot)).sum().backward()
    for k in floats:
        want_g = np.asarray(jgrads[k])
        if tin[k].grad is None:
            assert not want_g.any(), k
            continue
        np.testing.assert_allclose(tin[k].grad.numpy(), want_g, rtol=1e-4,
                                   atol=1e-6 * max(1.0, float(np.abs(want_g).max())), err_msg=k)


def _edge_arrays(data, graph, seed):
    """(edge_time, edge_label, rel_emb) aligned to the graph's message
    user-CSR edge order."""
    rng = np.random.default_rng(seed)
    e = data["e_train"] if graph == "train" else data["e_msg"]
    label = rng.integers(0, 3, e).astype(np.int32) if graph == "train" else data["labels"]
    return _times(e, seed), label, rng.standard_normal((3, DIM)).astype(np.float32)


def _sampled_block(data, side, seed):
    """targets [6, 3, d], neighbour blocks [6, 3, 4, d] and their slots'
    positions [6, 3, 4] in the side's message CSR: target (0, 0) draws the
    sampler's clipped slot of a degree-zero node (position 0: another node's
    edge, whose label and time are read unmasked), in (2, 1) slots 0 and 2
    hold the same edge with different rows (dropout), block (1, 2) is
    dropped out entirely."""
    rng = np.random.default_rng(seed)
    tg = data["tg"]["message"]
    csr = tg.prop_user_pos if side == "user" else tg.prop_item_pos
    target = rng.standard_normal((6, 3, DIM)).astype(np.float32)
    nbrs = rng.standard_normal((6, 3, 4, DIM)).astype(np.float32)
    pos = rng.integers(0, csr.nnz, (6, 3, 4)).astype(np.int32)
    pos[0, 0] = 0
    nbrs[0, 0] = nbrs[0, 0, :1]
    pos[2, 1, 2] = pos[2, 1, 0]
    keep = rng.random(nbrs.shape) < 0.8
    nbrs = np.where(keep, nbrs / np.float32(0.8), 0.0).astype(np.float32)
    nbrs[1, 2] = 0.0
    return target, nbrs, pos


@pytest.mark.parametrize("conv", EDGE_CONVS)
@pytest.mark.parametrize("side", ["user", "item"])
def test_conv_sampled_matches_jax(data, conv, side):
    """The sampled path over the message graph, forward and the gradients
    with respect to the layer's parameters, the node rows and the relation
    table; the item side's slots map through prop_item_edge_perm. The times
    tie, and for recency the first slot at the latest time wins."""
    jg, tg = data["jg"]["message"], data["tg"]["message"]
    jc, tc = jconvs.get_conv(conv), tconvs.get_conv(conv)
    target, nbrs, pos = _sampled_block(data, side, seed=4)
    edge_time, edge_label, rel_emb = _edge_arrays(data, "message", seed=6)
    inputs = {**_conv_params(conv), "target": target, "nbrs": nbrs, "rel_emb": rel_emb}
    perm = tg.prop_item_edge_perm.numpy()
    t_slots = edge_time[pos if side == "user" else perm[pos]]
    assert t_slots[2, 1, 0] == t_slots[2, 1, 2] and not np.array_equal(nbrs[2, 1, 0], nbrs[2, 1, 2])
    assert (t_slots == t_slots.max(-1, keepdims=True)).sum(-1).max() > 1  # ties at the maximum

    def jax_fn(q):
        ctx = {"neighbors": q["nbrs"], "side": side, "graph": jg, "edge_pos": jnp.asarray(pos),
               "edge_time": jnp.asarray(edge_time), "edge_label": jnp.asarray(edge_label), "rel_emb": q["rel_emb"]}
        return jc.sampled(q, q["target"], jnp.mean(q["nbrs"], axis=-2), ctx)

    def torch_fn(q):
        ctx = {"neighbors": q["nbrs"], "side": side, "graph": tg, "edge_pos": torch.from_numpy(pos),
               "edge_time": torch.from_numpy(edge_time)}
        if conv.startswith("relational"):  # the model gathers these rows
            ctx["rel"] = q["rel_emb"][tconvs.edge_feature(ctx, torch.from_numpy(edge_label)).long()]
        return tc.sampled(q, q["target"], q["nbrs"].mean(dim=-2), ctx)

    _check_grads(jax.jit(jax_fn), torch_fn, inputs, seed=5)


@pytest.mark.parametrize("conv", EDGE_CONVS)
@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("graph", ["train", "message"])
def test_conv_full_graph_matches_jax(data, conv, side, graph):
    """The full-graph path over the train graph (user 0 and item 0 of degree
    zero) and the message graph (item 0 of degree zero), forward and
    gradients; the times tie (recency's mean over every latest neighbour)."""
    jg, tg = data["jg"][graph], data["tg"][graph]
    jc, tc = jconvs.get_conv(conv), tconvs.get_conv(conv)
    rng = np.random.default_rng(6)
    n_self, n_other = (N_USERS, M_ITEMS) if side == "user" else (M_ITEMS, N_USERS)
    edge_time, edge_label, rel_emb = _edge_arrays(data, graph, seed=7)
    inputs = {**_conv_params(conv), "x_self": rng.standard_normal((n_self, DIM)).astype(np.float32),
              "other": rng.standard_normal((n_other, DIM)).astype(np.float32),
              "aggr": rng.standard_normal((n_self, DIM)).astype(np.float32), "rel_emb": rel_emb}

    def ctx_of(q, g, arr):
        return {"graph": g, "edge_time": arr(edge_time), "edge_label": arr(edge_label), "rel_emb": q["rel_emb"]}

    def jax_fn(q):
        return jc.full_graph(q, q["x_self"], q["aggr"], q["other"], side, ctx_of(q, jg, jnp.asarray))

    def torch_fn(q):
        return tc.full_graph(q, q["x_self"], q["aggr"], q["other"], side, ctx_of(q, tg, torch.from_numpy))

    _check_grads(jax.jit(jax_fn), torch_fn, inputs, seed=8)


# ---- the SAGE models ----
def _flagship(**kw) -> dict:
    cfg = dataclasses.asdict(ddp_flagship_config())
    cfg.pop("mesh")
    cfg.update(latent_dim=DIM, num_neighbors=3, bpr_batch_size=48, eval_user_batch=32, topks=(5, 10),
               compute_dtype="float32", decay=1e-2)
    cfg.update(kw)
    return cfg


def _both(data, name, compute_dtype="float32", **cfg):
    """(jax dataset, port dataset, jax model, port model, jax params): rsage
    over the message graph with its labels, tgsrec / sasgnn over the train
    graph with the purchase times."""
    kw = _flagship(model=name, compute_dtype=compute_dtype, **cfg)
    jc, tc = JConfig(**kw), Config(**kw)
    if name == "rsage":
        jgr = data["jg"]["message" if compute_dtype == "float32" else "message_default"]
        tgr = data["tg"]["message"]
        extra = dict(edge_label=data["labels"], n_relations=3)
    else:
        jgr = data["jg"]["train"] if compute_dtype == "float32" else None
        tgr = data["tg"]["train"]
        extra = dict(edge_time=data["edge_time"])
    jd = dataclasses.replace(data["jd"], _graph=jgr)
    td = dataclasses.replace(data["td"], _graph=tgr)
    jf = dataclasses.replace(jfeat.synthetic_features(jd, jc, seed=1),
                             **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in extra.items()})
    tf = dataclasses.replace(tfeat.synthetic_features(td, tc, seed=1),
                             **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in extra.items()})
    jm = jbuild_model(name, jc, jd.graph, features=jf)
    tm = build_model(name, tc, td.graph, features=tf)
    p = jm.init(jax.random.PRNGKey(0))
    params_from_jax(_np(p), tm)
    return jd, td, jm, tm, p


@pytest.mark.parametrize("name,cfg", MODELS, ids=MODEL_IDS)
def test_propagate_matches_jax(data, no_text_hub, name, cfg):
    jd, td, jm, tm, p = _both(data, name, **cfg)
    ju, ji = jax.jit(lambda q: jm.propagate(q, jd.graph))(p)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    assert tu.shape == (N_USERS, DIM) and ti.shape == (M_ITEMS, DIM)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,cfg", MODELS, ids=MODEL_IDS)
def test_propagate_bfloat16_default(data, name, cfg):
    jd, td, jm, tm, p = _both(data, name, compute_dtype="bfloat16", **cfg)
    ju, ji = jax.jit(lambda q: jm.propagate(q, jd.graph))(p)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **LOOSE)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **LOOSE)


def _batch(td, seed, b=48):
    """A BPR batch over users with purchases (and user 0, without), the last
    4 rows invalid."""
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(1, N_USERS, b)
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, b)
    user[1] = 0
    pos[2] = 0  # item 0: degree zero in both graphs
    valid = np.ones(b, dtype=bool)
    valid[-4:] = False
    arrs = [a.astype(np.int32) for a in (user, pos, neg)] + [valid]
    return JBatch(*(jnp.asarray(a) for a in arrs)), BPRBatch(*(torch.from_numpy(a) for a in arrs))


def _jax_trees(jm, jd, jb, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    seeds = ((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item"))
    return [jm.sample_seed_tree(jd.graph, s, side, k) for (s, side), k in zip(seeds, keys)]


def _tree_to_torch(trees):
    return [[SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in t] for t in trees]


def _jax_loss_grad(jm, jd):
    return jax.jit(jax.value_and_grad(
        lambda q, jb, trees: jm.loss(q, jd.graph, jb, jax.random.PRNGKey(1), trees=trees), has_aux=True))


@pytest.mark.parametrize("name,cfg", MODELS, ids=MODEL_IDS)
def test_loss_and_grads_match_jax(data, no_text_hub, no_dropout, name, cfg):
    """The BPR loss and every parameter's gradient on JAX-sampled trees
    (their edge_pos included); user 0's and item 0's trees hold clipped
    slots."""
    jd, td, jm, tm, p = _both(data, name, **cfg)
    jb, tb = _batch(td, seed=0)
    jtrees = _jax_trees(jm, jd, jb, seed=5)
    assert not bool(jtrees[1][0].has_neighbors[2])  # item 0
    (jl, jaux), jg = _jax_loss_grad(jm, jd)(p, jb, jtrees)
    tl, taux = tm.loss(td.graph, tb, trees=_tree_to_torch(jtrees))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("bpr", "reg"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-5)
    want = flatten_params(_np(jg))
    assert set(dict(tm.named_parameters())) == set(want)
    for n_, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[n_], rtol=1e-4,
                                   atol=1e-6 * max(1.0, float(np.abs(want[n_]).max())), err_msg=n_)


@pytest.mark.parametrize("name,cfg", MODELS, ids=MODEL_IDS)
def test_encode_seeds_matches_jax(data, no_text_hub, name, cfg):
    """encode_seeds (the --inference sample path) on the same JAX trees, for
    user and item seeds, without dropout."""
    jd, td, jm, tm, p = _both(data, name, **cfg)
    tables = jax.jit(jm.initial_tables)(p)
    for side, n, seed in (("user", N_USERS, 0), ("item", M_ITEMS, 1)):
        seeds = jnp.arange(n, dtype=jnp.int32)
        tree = jm.sample_seed_tree(jd.graph, seeds, side, jax.random.PRNGKey(seed))
        want = jax.jit(lambda q, t, tr: jm.encode_seeds(q, jd.graph, seeds, side, jax.random.PRNGKey(2),
                                                        train=False, tables=t, tree=tr))(p, tables, tree)
        with torch.no_grad():
            got = tm.encode_seeds(td.graph, torch.arange(n, dtype=torch.int32), side,
                                  tree=_tree_to_torch([tree])[0])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=side)


def _check_params(model, want, label, rounding=None, lr=1e-3, steps=0):
    """Every parameter within 1e-6 + 1e-5 |p| of JAX's, but the elements of
    ``rounding`` (name -> bool mask, ``_rounding``): those whose two
    gradients, equal within the gradient tolerance, differed at some step by
    more than 1e-3 of their own magnitude, so that Adam's normalised step
    g / (sqrt(v) + 1e-8) differs by more than 1e-3 x lr = 1e-6. They are held
    within 2 x lr a step, and there may be no more than 1 in 100 of them."""
    got = flatten_params(params_to_numpy(model))
    want = flatten_params(_np(want))
    assert set(got) == set(want)
    rounding = rounding or {}
    assert sum(int(m.sum()) for m in rounding.values()) <= 1e-2 * sum(v.size for v in want.values())
    for k in want:
        diff = np.abs(got[k] - want[k])
        loose = rounding.get(k, np.zeros(diff.shape, bool))
        assert (diff[~loose] <= 1e-6 + 1e-5 * np.abs(want[k][~loose])).all(), f"{label}: {k} off by {diff.max()}"
        assert (diff[loose] <= 2 * lr * steps).all(), f"{label}: {k}"


def _rounding(model, grads, rounding):
    """The port's gradients (on ``model``) against JAX's ``grads`` within the
    gradient tolerance (rtol 1e-4, atol 1e-6 of the largest magnitude); the
    elements where they differ by more than 1e-3 of JAX's magnitude added to
    ``rounding``."""
    want = flatten_params(_np(grads))
    for k, prm in model.named_parameters():
        g, w = prm.grad.numpy(), want[k]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(w).max())), err_msg=k)
        rounding[k] = rounding.get(k, np.zeros(w.shape, bool)) | (np.abs(g - w) > 1e-3 * np.abs(w))
    return rounding


@pytest.mark.parametrize("name,cfg", [MODELS[1], MODELS[3]], ids=["rsage-sum", "tgsrec"])
def test_three_adam_steps_match_optax_and_state_converts(data, no_text_hub, no_dropout, name, cfg):
    """Three Adam steps at lr 1e-3 on JAX-sampled batches and trees against
    jax.value_and_grad(model.loss) + optax.adam; then the JAX parameters and
    Adam state carried into a fresh port model take a fourth step equal to
    JAX's (``_check_params``' rule for the elements whose gradients agree
    within the gradient tolerance but not to Adam's 1e-3)."""
    jd, td, jm, tm, jp = _both(data, name, **cfg)
    lr = 1e-3
    opt = optax.adam(lr)
    state = opt.init(jp)
    topt = torch.optim.Adam(tm.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step_fn = _jax_loss_grad(jm, jd)
    draws = []
    for step in range(4):
        jb, tb = _batch(td, seed=10 + step)
        draws.append((jb, tb, _jax_trees(jm, jd, jb, seed=20 + step)))
    rounding = {}
    for step, (jb, tb, jtrees) in enumerate(draws[:3]):
        _, grads = step_fn(jp, jb, jtrees)
        upd, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        tm.loss(td.graph, tb, trees=_tree_to_torch(jtrees))[0].backward()
        rounding = _rounding(tm, grads, rounding)
        topt.step()
        _check_params(tm, jp, f"step {step}", rounding, lr, step + 1)

    fresh = build_model(name, tm.config, td.graph, features=tm.features)
    params_from_jax(_np(jp), fresh)
    _check_params(fresh, jp, "carried")
    fopt = torch.optim.Adam(fresh.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    adam = state[0]
    adam_state_from_jax(int(adam.count), _np(adam.mu), _np(adam.nu), fopt, fresh)
    count, mu, nu = adam_state_to_numpy(fopt, fresh)
    assert count == 3
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(_np(want))
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(_np(want))):
            np.testing.assert_array_equal(a, b)
    jb, tb, jtrees = draws[3]
    _, grads = step_fn(jp, jb, jtrees)
    upd, state = opt.update(grads, state, jp)
    jp = optax.apply_updates(jp, upd)
    fopt.zero_grad()
    fresh.loss(td.graph, tb, trees=_tree_to_torch(jtrees))[0].backward()
    rounding = _rounding(fresh, grads, {})
    fopt.step()
    _check_params(fresh, jp, "step 4 from the carried state", rounding, lr, 1)


@pytest.mark.parametrize("name,cfg", MODELS, ids=MODEL_IDS)
def test_initial_param_keys_match_jax(data, name, cfg):
    """The feature parameters: the edge-feature parameters (rel_emb, rel_w,
    rel_b, time_freq, time_phase) act in the convs and are not among them."""
    _, _, jm, tm, _ = _both(data, name, **cfg)
    keys = tm.initial_param_keys()
    assert keys == jm.initial_param_keys()
    assert not {k for k in keys if k.startswith(("rel", "layers."))}


def test_rsage_relin_block_matches_jax(data, no_text_hub, no_dropout):
    """One R = 8 block of rsage (sum) through the port's Trainer against the
    JAX trainer's relin loop (tables at the block's snapshot, the direct
    gradient plus the snapshot's pullback, optax.adam): every step's loss and
    the final parameters within rtol 1e-4, atol 1e-6."""
    jd, td, jm, tm, jp = _both(data, "rsage", multi_relational="sum", relin_every=8)
    key = jax.random.PRNGKey(0)
    cached = jax.jit(jax.value_and_grad(lambda q, t, b, tr: jm.loss(q, jd.graph, b, key, tables=t, trees=tr),
                                        argnums=(0, 1), has_aux=True))
    tables = jax.jit(jm.initial_tables)
    pullback = jax.jit(lambda q, g: jax.vjp(jm.initial_tables, q)[1](g)[0])
    draws = []
    for step in range(8):
        jb, tb = _batch(td, seed=30 + step)
        draws.append((jb, tb, _jax_trees(jm, jd, jb, seed=40 + step)))
    opt = optax.adam(tm.config.lr)
    state = opt.init(jp)
    p0, lin, losses = jp, tables(jp), []
    for jb, _, jtrees in draws:
        (loss, _), (g_p, g_t) = cached(jp, lin, jb, jtrees)
        grads = jax.tree_util.tree_map(jnp.add, g_p, pullback(p0, g_t))
        upd, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        losses.append(float(loss))
    tr = Trainer(tm.config, td, tm, device="cpu", logger=MetricLogger(quiet=True))
    assert tr.cadence == "relin"
    got = tr.train_epoch([b for _, b, _ in draws], draws=[{"trees": _tree_to_torch(t)} for _, _, t in draws])
    np.testing.assert_allclose(got.numpy(), losses, rtol=1e-4, atol=1e-6)
    got_p = flatten_params(params_to_numpy(tr.model))
    for k, want in flatten_params(_np(jp)).items():
        np.testing.assert_allclose(got_p[k], want, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name,cfg", MODELS[1:], ids=MODEL_IDS[1:])
@pytest.mark.parametrize("cadence", [{}, {"relin_every": 8}, {"feature_update_every": 8}],
                         ids=["R1", "R8", "T8"])
def test_trainer_runs_edge_models_at_each_cadence(data, name, cfg, cadence):
    """Trainer(ddp_recipe=True) for one epoch at R = 1, R = 8 and T = 8 on
    the CPU: finite losses, every parameter moved (but rsage's last
    relation bias, zero at the start: the chain does not read the last
    layer's rel_w / rel_b, as in JAX, so only the L2 term, 0 for it,
    reaches it), an evaluation."""
    kw = _flagship(model=name, **cfg, **cadence)
    _, td, _, tm, _ = _both(data, name, **cfg)
    tm = build_model(name, Config(**kw), td.graph, features=tm.features)
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tr = Trainer(Config(**kw), td, tm, device="cpu", logger=MetricLogger(quiet=True), ddp_recipe=True)
    tr.init_state()
    loss = tr.train_one_epoch()
    assert np.isfinite(loss)
    moved = {k for k, p in tm.named_parameters() if not torch.equal(p.detach(), before[k])}
    assert moved == set(before) - {"layers.1.rel_b"}
    assert all(np.isfinite(v) for v in tr.test().values())


# ---- registry, conversion, CLI, server ----
@pytest.mark.parametrize("name,cfg", MODELS, ids=MODEL_IDS)
def test_registry_keys_and_parameter_tree_round_trip(data, name, cfg):
    assert {"rsage", "tgsrec", "sasgnn"} <= set(available_models()) and {"rsage", "tgsrec", "sasgnn"} <= SAGE_KEYS
    _, _, jm, tm, p = _both(data, name, **cfg)
    conv = {"tgsrec": "temporal", "sasgnn": "recency"}.get(name, f"relational_{cfg.get('multi_relational')}")
    assert tm.conv_name == jm.conv_name == conv
    out = params_to_numpy(tm)
    want = _np(p)
    assert jax.tree_util.tree_structure(out) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    layer_keys = {"temporal": {"time_freq", "time_phase", "wq", "wk", "wv", "w_skip"},
                  "recency": {"w", "b"}}.get(conv, {"w", "b", "rel_w", "rel_b"})
    assert [set(lp) for lp in out["layers"]] == [layer_keys] * 2
    if name == "rsage":
        assert out["rel_emb"].shape == (3, DIM)
        assert out["layers"][0]["w"].shape == ((3 if cfg["multi_relational"] == "sum" else 2) * DIM, DIM)
    if name == "tgsrec":
        assert out["layers"][0]["wk"].shape == (2 * DIM, DIM)


def test_rsage_needs_edge_labels(data):
    cfg = Config(**_flagship(model="rsage"))
    fs = tfeat.synthetic_features(data["td"], cfg, seed=1)
    with pytest.raises(ValueError, match="edge_label"):
        build_model("rsage", cfg, data["tg"]["message"], features=fs)
    with pytest.raises(ValueError, match="features"):
        build_model("rsage", cfg, data["tg"]["message"])
    with pytest.raises(ValueError, match="edge_label"):
        jbuild_model("rsage", JConfig(**_flagship(model="rsage")), data["jg"]["message"],
                     features=jfeat.synthetic_features(data["jd"], JConfig(**_flagship(model="rsage")), seed=1))


def _write_text_dataset(root, n_users=40, m_items=60, seed=0):
    rng = np.random.default_rng(seed)
    cf = root / "cf"
    cf.mkdir(parents=True)
    with open(cf / "train.txt", "w") as f, open(cf / "test.txt", "w") as g:
        for u in range(n_users):
            items = rng.choice(m_items, size=rng.integers(5, 10), replace=False)
            f.write(f"{u} " + " ".join(map(str, items[:-2])) + "\n")
            g.write(f"{u} " + " ".join(map(str, items[-2:])) + "\n")


@pytest.mark.parametrize("name", ["rsage", "tgsrec", "sasgnn"])
def test_build_model_inputs_match_jax(tmp_path, name):
    """cli.build_model_inputs from artifacts written by the JAX package's
    write_artifacts (relation CSVs, buy_timestamp as a raw-order array for
    tgsrec and a sparse matrix for sasgnn): the same graph arrays, labels,
    relation count and edge times as the JAX package's build_model_inputs."""
    import scipy.sparse as sp

    from furusato_recommend_tpu.cli import build_model_inputs as jinputs
    from furusato_recommend_tpu.data.dataset import load_text_dataset as jload
    from furusato_recommend_tpu.preprocessing.artifacts import write_artifacts
    from furusato_recommend_tpu_torch.cli import build_model_inputs
    from furusato_recommend_tpu_torch.data.dataset import load_text_dataset

    _write_text_dataset(tmp_path)
    kw = dict(model=name, data_path=str(tmp_path), user_feature="n", item_feature="n", multi_relational="sum")
    jd, td = jload(JConfig(**kw)), load_text_dataset(Config(**kw))
    rng = np.random.default_rng(1)
    raw = _times(jd.train_size, seed=2)
    stamp = raw if name == "tgsrec" else sp.coo_matrix(
        (raw + 1.0, (jd.train_user, jd.train_item)), shape=(jd.n_users, jd.m_items))
    write_artifacts(
        tmp_path, user_numeric=rng.random((jd.n_users, 5)), item_numeric=rng.random((jd.m_items, 4)),
        buy_timestamp=stamp, favorite_edges=(jd.train_user[::3], jd.train_item[::3]),
        review_edges=(rng.integers(0, jd.n_users, 9), rng.integers(0, jd.m_items, 9)),
    )
    jgraph_, jkw = jinputs(JConfig(**kw), jd)
    tgraph_, tkw = build_model_inputs(Config(**kw), td)
    assert tgraph_ is td.graph
    for attr in ("user_pos", "item_pos", "test_pos", "prop_user_pos", "prop_item_pos"):
        _csr_equal(getattr(tgraph_, attr), getattr(jgraph_, attr), attr)
    np.testing.assert_array_equal(tgraph_.prop_item_edge_perm.numpy(), np.asarray(jgraph_.prop_item_edge_perm))
    jf, tf = jkw["features"], tkw["features"]
    assert tf.n_relations == jf.n_relations
    for attr in ("edge_label", "edge_time"):
        j, t = getattr(jf, attr), getattr(tf, attr)
        assert (j is None) == (t is None), attr
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=attr)
    if name == "rsage":
        assert tf.n_relations == 3 and tgraph_.msg_user_pos is not None
        assert tgraph_.prop_user_pos.nnz == td.train_size + len(jd.train_user[::3]) + 9
    else:
        assert tf.edge_time is not None and tgraph_.msg_user_pos is None


@pytest.mark.parametrize("model_args", [["--model", "rsage", "--multi_relational", "sum"], ["--model", "tgsrec"],
                                        ["--model", "sasgnn"]], ids=["rsage-sum", "tgsrec", "sasgnn"])
def test_cli_trains_edge_models_and_serves_them(tmp_path, model_args):
    """The CLI trains the edge-feature keys from the artifacts that
    ``data.artifacts`` writes (relation CSVs, purchase times) with the ddp
    recipe, and the server loads the checkpoint: rsage over the relational
    graph."""
    from furusato_recommend_tpu_torch.cli import main
    from furusato_recommend_tpu_torch.data import artifacts
    from furusato_recommend_tpu_torch.serve import Recommender

    _write_text_dataset(tmp_path / "data")
    artifacts.main(["--data_path", str(tmp_path / "data"), "--seed", "1"])
    assert (tmp_path / "data" / "favorite_train.csv").exists()
    assert (tmp_path / "data" / "cf" / "buy_timestamp.pkl").exists()
    main(model_args + [
        "--ddp_recipe", "--recdim", "16", "--bpr_batch", "256", "--lr", "0.01", "--epochs", "1",
        "--test_span", "1", "--topks", "[5,10]", "--testbatch", "32",
        "--data_path", str(tmp_path / "data"), "--path", str(tmp_path / "ck"), "--device", "cpu",
    ])
    (ckpt,) = (tmp_path / "ck" / model_args[1]).glob("*.ckpt")
    rec = Recommender.from_checkpoint(str(ckpt), device="cpu")
    assert rec.model.conv_name == {"rsage": "relational_sum", "tgsrec": "temporal", "sasgnn": "recency"}[model_args[1]]
    assert (rec._prop_graph.msg_user_pos is not None) == (model_args[1] == "rsage")
    ids, scores = rec.recommend([0, 7], k=5)
    assert ids.shape == (2, 5) and np.isfinite(scores).all()


@pytest.mark.parametrize("name,cfg", [MODELS[0], MODELS[3]], ids=["rsage-add", "tgsrec"])
def test_recommender_serves_edge_models_like_jax(data, no_text_hub, name, cfg):
    """The port's CPU Recommender (refresh = full-graph propagate over the
    message graph for rsage) against the JAX Recommender at k = 10; train
    positives (not favourites) are the mask."""
    from furusato_recommend_tpu.serve import Recommender as JRecommender
    from furusato_recommend_tpu_torch.serve import Recommender

    jd, td, jm, tm, p = _both(data, name, **cfg)
    jrec = JRecommender(jm, jd, jm.config, p)
    trec = Recommender(tm, td, tm.config, _np(p), device="cpu")
    users = np.arange(N_USERS)
    jid, jsc = (np.asarray(x) for x in jrec.recommend(users, k=10))
    tid, tsc = trec.recommend(users, k=10)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-5)
    gap = np.abs(np.diff(jsc, axis=1)) > 1e-5 * np.abs(jsc[:, 1:])
    sep = np.ones(jid.shape, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(tid[sep], jid[sep])
    assert sep.mean() > 0.9
    ap = td.all_pos()
    for u, row in zip(users, tid):
        assert not set(row.tolist()) & set(ap[u].tolist())
