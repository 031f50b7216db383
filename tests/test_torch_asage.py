"""Port vs JAX package: the attribute model ``asage`` (``models/asage.py``:
``_csr_pair``, ``attributes_from_categorical``, the attribute trees, the
loss with its attribute BPR and optional InfoNCE; ``load_attribute_coos``;
the registry key, the trainer's cadences, the CLI's attribute inputs and
the server).

Same numpy data in both packages: ``synthetic_dataset(100, 140,
avg_degree=8, seed=7)`` with ``synthetic_features(seed=1)`` (4 user and 5
item categorical fields: the attribute graphs), the JAX package's initial
parameters carried across by ``params_from_jax``; d = 16, L = 2, fanout 3.
The fanout and attribute trees are drawn by the JAX package, from the keys
its loss splits, and handed to the port; dropout 0 in both packages' ``sage``
and ``asage`` modules (``asage`` binds the rate by value). Each JAX function
is jitted once. Tolerances (those of ``test_torch_edge.py``):

- graph arrays and loaders: bit-equal;
- float32 forwards (the JAX graph without hub-dense blocks,
  ``compute_dtype="float32"``, its text hub off): rtol 1e-5, atol 1e-5;
- the bfloat16 default: rtol 2e-2, atol 2e-3;
- loss rtol 1e-5; gradients rtol 1e-4, atol 1e-6 of the gradient's largest
  magnitude where it exceeds 1;
- three Adam steps at lr 1e-3: every parameter within 1e-6 + 1e-5 |p|, but
  elements whose two gradients, equal within the gradient tolerance, differ
  by more than 1e-3 of their size: those within 2 x lr a step, at most 1 in
  100 of the parameters; one R = 4 block: rtol 1e-4, atol 1e-6.
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
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.models import asage as jasage
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu.sampling.neighbor import sample_neighbors as jsample_neighbors
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_numpy,
    flatten_params,
    params_from_jax,
    params_to_numpy,
)
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data import features as tfeat
from furusato_recommend_tpu_torch.models import asage as tasage
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models.registry import SAGE_KEYS, available_models, build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM, FANOUT = 100, 140, 16, 3
FWD = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=2e-2, atol=2e-3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    """({"hub_free", "default"} JAX datasets, the port's), same arrays, and
    both packages' features (built once: they do not depend on the config's
    fields these tests vary)."""
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    g = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
                     hub_count=0, dst_hub_count=0)
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    features = (jfeat.synthetic_features(jd, JConfig(**_kw()), seed=1),
                tfeat.synthetic_features(td, Config(**_kw()), seed=1))
    return {"hub_free": dataclasses.replace(jd, _graph=g), "default": jd}, td, features


@pytest.fixture
def no_text_hub(monkeypatch):
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)


@pytest.fixture
def no_dropout(monkeypatch):
    for module in (jsage, jasage, tsage, tasage):
        monkeypatch.setattr(module, "DROPOUT_RATE", 0.0)


def _kw(**over):
    kw = dict(model="asage", latent_dim=DIM, n_layers=2, num_neighbors=FANOUT, user_feature="nwt",
              item_feature="nwt", compute_dtype="float32", decay=1e-2, bpr_batch_size=48, eval_user_batch=32,
              topks=(5, 10))
    kw.update(over)
    return kw


def _both(data, compute_dtype="float32", model_kw=None, **over):
    """(jax dataset, port dataset, jax model, port model, jax params)."""
    jsets, td, (jf, tf) = data
    jd = jsets["hub_free" if compute_dtype == "float32" else "default"]
    kw = _kw(compute_dtype=compute_dtype, **over)
    jm = jbuild_model("asage", JConfig(**kw), jd.graph, features=jf, **(model_kw or {}))
    tm = build_model("asage", Config(**kw), td.graph, features=tf, **(model_kw or {}))
    p = jm.init(jax.random.PRNGKey(0))
    params_from_jax(_np(p), tm)
    return jd, td, jm, tm, p


def _csr_equal(got, want, name=""):
    assert got.indptr.dtype == torch.int32 and got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr), err_msg=name)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices), err_msg=name)


def _to_torch(tree):
    return [SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in tree]


# ---- the attribute graphs ----
def test_attributes_from_categorical_matches_jax(data):
    """One pair per field, a value repeated in two fields of one entity kept
    twice; the flags do not matter (nwt has no c)."""
    _, _, (jf, tf) = data
    got, want = tasage.attributes_from_categorical(tf), jasage.attributes_from_categorical(jf)
    assert got.keys() == want.keys() == {"user", "item"}
    for side in got:
        for a, b in zip(got[side][:2], want[side][:2]):
            np.testing.assert_array_equal(a, b)
        assert got[side][2:] == want[side][2:]
    rows, cols = got["user"][:2]
    assert len(rows) == 4 * N_USERS and len(set(zip(rows.tolist(), cols.tolist()))) < len(rows)
    with pytest.raises(ValueError, match="categorical"):
        tasage.attributes_from_categorical(dataclasses.replace(tf, user=dataclasses.replace(tf.user, categorical=None)))


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_pair_matches_jax(seed):
    """Both directions of COO pairs with duplicates, unsorted, entities and
    attributes without pairs."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 30, 200)
    cols = rng.integers(0, 12, 200)
    rows[rows == 7] = 8
    for got, want, name in zip(tasage._csr_pair(rows, cols, 31, 13), jasage._csr_pair(rows, cols, 31, 13),
                               ("forward", "backward")):
        _csr_equal(got, want, name)


def test_load_attribute_coos_matches_jax(tmp_path):
    """The [2, nnz] tensors written by the JAX package's write_artifacts, and
    by the port's writer, read the same by both loaders; None when absent."""
    from furusato_recommend_tpu.preprocessing.artifacts import write_artifacts
    from furusato_recommend_tpu_torch.data import artifacts as tart

    cfg, jcfg = Config(suffix="_s"), JConfig(suffix="_s")
    assert tfeat.load_attribute_coos(cfg, tmp_path) is None and jfeat.load_attribute_coos(jcfg, str(tmp_path)) is None
    rng = np.random.default_rng(2)
    ua = np.stack([rng.integers(0, 20, 50), rng.integers(0, 7, 50)])
    ia = np.stack([rng.integers(0, 30, 60), rng.integers(0, 9, 60)]).astype(np.int32)
    write_artifacts(tmp_path, "_s", user_attribute=ua, item_attribute=ia)
    td = tds.synthetic_dataset(n_users=25, m_items=35, avg_degree=4, seed=0)
    tart.write_attribute_artifacts(td, tmp_path / "port", seed=3)
    for got, want in ((tfeat.load_attribute_coos(cfg, tmp_path), jfeat.load_attribute_coos(jcfg, str(tmp_path))),
                      (tfeat.load_attribute_coos(Config(), tmp_path / "port"),
                       jfeat.load_attribute_coos(JConfig(), str(tmp_path / "port")))):
        assert got.keys() == want.keys() == {"user_attr", "item_attr"}
        for key in got:
            for a, b in zip(got[key][:2], want[key][:2]):
                assert a.dtype == np.int64
                np.testing.assert_array_equal(a, b)
            assert got[key][2:] == want[key][2:]
    port = tfeat.load_attribute_coos(Config(), tmp_path / "port")
    assert port["user_attr"][2] == 25 and port["item_attr"][2] == 35


# ---- the attribute view ----
def _jax_attr_tree(jm, seeds, side, key):
    """The attribute tree JAX's ``_encode_attr_tree`` draws from ``key``."""
    fwd, bwd = (jm.user_attr_fwd, jm.user_attr_bwd) if side == "user" else (jm.item_attr_fwd, jm.item_attr_bwd)
    out, frontier = [], seeds
    for level in range(jm.n_layers):
        key, k = jax.random.split(key)
        s = jsample_neighbors(k, fwd if level % 2 == 0 else bwd, frontier, jm.fanout)
        out.append(s)
        frontier = s.ids
    return out


def test_attribute_csrs_match_jax(data):
    _, _, jm, tm, _ = _both(data)
    for side in ("user", "item"):
        fwd, bwd = tm._attr_csr[side]
        _csr_equal(fwd, getattr(jm, f"{side}_attr_fwd"), f"{side} forward")
        _csr_equal(bwd, getattr(jm, f"{side}_attr_bwd"), f"{side} backward")
    assert (tm.n_user_attrs, tm.n_item_attrs) == (jm.n_user_attrs, jm.n_item_attrs) == (40, 60)


@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("n_layers", [2, 3])
def test_encode_attr_tree_matches_jax(data, side, n_layers):
    """The attribute view of every entity of a side on the tree JAX draws
    (entity, attribute, entity[, attribute] levels), without dropout."""
    jd, td, jm, tm, p = _both(data, n_layers=n_layers)
    n = N_USERS if side == "user" else M_ITEMS
    seeds = jnp.arange(n, dtype=jnp.int32)
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda q: jm._encode_attr_tree(q, seeds, side, key, train=False))(p)
    tree = _to_torch(_jax_attr_tree(jm, seeds, side, key))
    with torch.no_grad():
        (got,) = tm.encode_attr_trees([(torch.arange(n, dtype=torch.int32), side, tree)])
    assert got.shape == (n, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_a_step_gathers_each_table_once(data, monkeypatch):
    """A step's six table gathers (six scatter-add launches on the card):
    the main view's user and item tables; each attribute table once, the
    user table for the user tree's attribute level, the item table for the
    positive and negative trees' (B F and 2 B F rows at L = 2); and the word
    table once a side, for the text bags of that side's entity levels in
    every attribute tree (B + B F^2 users, 2 (B + B F^2) items; 3 fields of
    12 word slots each)."""
    _, td, _, tm, _ = _both(data)
    _, tb = _batch(td, seed=0)
    seen = []
    real = tasage.table_gather

    def spy(table, ids):
        seen.append((tuple(table.shape), ids.numel()))
        return real(table, ids)

    monkeypatch.setattr(tasage, "table_gather", spy)
    monkeypatch.setattr(tsage, "table_gather", spy)
    tm.loss(td.graph, tb, torch.Generator().manual_seed(0))[0].backward()
    entities = 48 + 48 * FANOUT**2
    assert sorted(seen) == sorted([
        ((N_USERS, DIM), 48 * (1 + FANOUT**2) + 2 * 48 * FANOUT),  # the main trees' user levels
        ((M_ITEMS, DIM), 48 * FANOUT + 2 * 48 * (1 + FANOUT**2)),  # and item levels
        ((40, DIM), 48 * FANOUT), ((60, DIM), 2 * 48 * FANOUT),
        ((500, DIM // 2), entities * 3 * 12), ((500, DIM // 2), 2 * entities * 3 * 12),
    ])
    assert tm.user_attr_emb.grad.abs().max() > 0 and tm.item_attr_emb.grad.abs().max() > 0


# ---- the model ----
def test_propagate_matches_jax(data, no_text_hub):
    """Propagation is the SAGE model's (the attribute view is for training)."""
    jd, td, jm, tm, p = _both(data)
    ju, ji = jax.jit(lambda q: jm.propagate(q, jd.graph))(p)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **FWD)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **FWD)


def test_propagate_bfloat16_default(data):
    jd, td, jm, tm, p = _both(data, compute_dtype="bfloat16")
    ju, ji = jax.jit(lambda q: jm.propagate(q, jd.graph))(p)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **LOOSE)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **LOOSE)


def _batch(td, seed, b=48):
    """A BPR batch, the last 4 rows invalid."""
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(0, N_USERS, b)
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, b)
    valid = np.ones(b, dtype=bool)
    valid[-4:] = False
    arrs = [a.astype(np.int32) for a in (user, pos, neg)] + [valid]
    return JBatch(*(jnp.asarray(a) for a in arrs)), BPRBatch(*(torch.from_numpy(a) for a in arrs))


def _jax_draws(jm, jd, jb, key):
    """The fanout and attribute trees JAX's ``ASAGE.loss`` draws from ``key``
    (the first three and the last three of its six keys), for the port's
    loss: {"trees": ..., "attr_trees": ...}."""
    k = jax.random.split(key, 6)
    seeds = ((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item"))
    trees = [jm.sample_seed_tree(jd.graph, s, side, kk) for (s, side), kk in zip(seeds, k[:3])]
    attr = [_jax_attr_tree(jm, s, side, kk) for (s, side), kk in zip(seeds, k[3:])]
    return {"trees": [_to_torch(t) for t in trees], "attr_trees": [_to_torch(t) for t in attr]}


def _jax_loss_grad(jm, jd):
    return jax.jit(jax.value_and_grad(lambda q, jb, key: jm.loss(q, jd.graph, jb, key), has_aux=True))


def _check_grads(model, grads):
    want = flatten_params(_np(grads))
    assert set(dict(model.named_parameters())) == set(want)
    for k, prm in model.named_parameters():
        w = want[k]
        np.testing.assert_allclose(prm.grad.numpy(), w, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(w).max())),
                                   err_msg=k)


@pytest.mark.parametrize("ssl_weight", [0.0, 0.1])
def test_loss_and_grads_match_jax(data, no_text_hub, no_dropout, ssl_weight):
    """The loss, its aux terms (bpr, attr_bpr, reg; infonce at ssl_weight
    0.1) and every parameter's gradient on the trees JAX's loss draws."""
    jd, td, jm, tm, p = _both(data, model_kw={"ssl_weight": ssl_weight})
    jb, tb = _batch(td, seed=0)
    key = jax.random.PRNGKey(3)
    (jl, jaux), jg = _jax_loss_grad(jm, jd)(p, jb, key)
    tl, taux = tm.loss(td.graph, tb, **_jax_draws(jm, jd, jb, key))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert set(taux) == set(jaux) == {"bpr", "attr_bpr", "reg"} | ({"infonce"} if ssl_weight else set())
    for k in taux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-5, err_msg=k)
    _check_grads(tm, jg)


def test_regulariser_skips_the_attribute_tables(data):
    _, td, _, tm, _ = _both(data)
    _, tb = _batch(td, seed=1)
    _, aux = tm.loss(td.graph, tb, torch.Generator().manual_seed(0))
    want = sum(0.5 * float((p.detach() ** 2).sum()) for k, p in tm.named_parameters() if "attr" not in k)
    np.testing.assert_allclose(float(aux["reg"].detach()), want / 44, rtol=1e-5)


def _check_params(model, want, label, rounding=None, lr=1e-3, steps=0):
    """Every parameter within 1e-6 + 1e-5 |p| of JAX's, but the elements of
    ``rounding`` (``_rounding``): they are held within 2 x lr a step, and
    there may be no more than 1 in 100 of them."""
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
    """The elements where the port's gradients differ from JAX's ``grads``
    by more than 1e-3 of JAX's magnitude (Adam's g / (sqrt(v) + 1e-8) turns
    that into more than 1e-3 x lr), added to ``rounding``."""
    want = flatten_params(_np(grads))
    for k, prm in model.named_parameters():
        g, w = prm.grad.numpy(), want[k]
        rounding[k] = rounding.get(k, np.zeros(w.shape, bool)) | (np.abs(g - w) > 1e-3 * np.abs(w))
    return rounding


def test_three_adam_steps_match_optax_and_state_converts(data, no_text_hub, no_dropout):
    """Three Adam steps at lr 1e-3 against jax.value_and_grad(model.loss) +
    optax.adam on JAX's draws (each step's gradient held against JAX's at the
    port's own parameters); then the JAX parameters and Adam state carried
    into a fresh port model take a fourth step equal to JAX's."""
    jd, td, jm, tm, jp = _both(data)
    lr = 1e-3
    opt = optax.adam(lr)
    state = opt.init(jp)
    topt = torch.optim.Adam(tm.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step_fn = _jax_loss_grad(jm, jd)
    rounding = {}
    for step in range(3):
        jb, tb = _batch(td, seed=10 + step)
        key = jax.random.PRNGKey(20 + step)
        _, grads = step_fn(jp, jb, key)
        upd, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        tm.loss(td.graph, tb, **_jax_draws(jm, jd, jb, key))[0].backward()
        _check_grads(tm, step_fn(params_to_numpy(tm), jb, key)[1])
        rounding = _rounding(tm, grads, rounding)
        topt.step()
        _check_params(tm, jp, f"step {step}", rounding, lr, step + 1)

    fresh = build_model("asage", tm.config, td.graph, features=tm.features)
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
    jb, tb = _batch(td, seed=13)
    key = jax.random.PRNGKey(23)
    _, grads = step_fn(jp, jb, key)
    upd, state = opt.update(grads, state, jp)
    jp = optax.apply_updates(jp, upd)
    fopt.zero_grad()
    fresh.loss(td.graph, tb, **_jax_draws(jm, jd, jb, key))[0].backward()
    _check_grads(fresh, grads)
    rounding = _rounding(fresh, grads, {})
    fopt.step()
    _check_params(fresh, jp, "step 4 from the carried state", rounding, lr, 1)


def test_relin_block_matches_jax(data, no_text_hub, no_dropout):
    """One R = 4 block through the port's Trainer against the JAX trainer's
    relin loop (the main view on tables at the block's snapshot, the
    attribute view on the live parameters; the direct gradient plus the
    snapshot's pullback; optax.adam): every step's loss and the final
    parameters within rtol 1e-4, atol 1e-6."""
    jd, td, jm, tm, jp = _both(data, relin_every=4)
    cached = jax.jit(jax.value_and_grad(lambda q, t, b, key: jm.loss(q, jd.graph, b, key, tables=t),
                                        argnums=(0, 1), has_aux=True))
    tables = jax.jit(jm.initial_tables)
    pullback = jax.jit(lambda q, g: jax.vjp(jm.initial_tables, q)[1](g)[0])
    draws = []
    for step in range(4):
        jb, tb = _batch(td, seed=30 + step)
        key = jax.random.PRNGKey(40 + step)
        draws.append((jb, tb, key, _jax_draws(jm, jd, jb, key)))
    opt = optax.adam(tm.config.lr)
    state = opt.init(jp)
    p0, lin, losses = jp, tables(jp), []
    for jb, _, key, _ in draws:
        (loss, _), (g_p, g_t) = cached(jp, lin, jb, key)
        grads = jax.tree_util.tree_map(jnp.add, g_p, pullback(p0, g_t))
        upd, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        losses.append(float(loss))
    tr = Trainer(tm.config, td, tm, device="cpu", logger=MetricLogger(quiet=True))
    assert tr.cadence == "relin"
    got = tr.train_epoch([b for _, b, _, _ in draws], draws=[d for _, _, _, d in draws])
    np.testing.assert_allclose(got.numpy(), losses, rtol=1e-4, atol=1e-6)
    got_p = flatten_params(params_to_numpy(tr.model))
    for k, want in flatten_params(_np(jp)).items():
        np.testing.assert_allclose(got_p[k], want, rtol=1e-4, atol=1e-6, err_msg=k)


def test_initial_param_keys_match_jax(data):
    """The feature parameters: the attribute tables act in the attribute
    view, not in the tables, and are not among them."""
    _, _, jm, tm, _ = _both(data)
    assert tm.initial_param_keys() == jm.initial_param_keys()
    assert not {k for k in tm.initial_param_keys() if "attr" in k}


@pytest.mark.parametrize("cadence", [{}, {"relin_every": 8}, {"feature_update_every": 8}], ids=["R1", "R8", "T8"])
def test_trainer_runs_asage_at_each_cadence(data, cadence):
    """Trainer(ddp_recipe=True) for one epoch on the CPU at R = 1, R = 8 and
    T = 8: finite losses, every parameter moved, an evaluation."""
    _, td, _, tm, _ = _both(data)
    cfg = Config(**_kw(**cadence))
    tm = build_model("asage", cfg, td.graph, features=tm.features)
    tr = Trainer(cfg, td, tm, device="cpu", logger=MetricLogger(quiet=True), ddp_recipe=True)
    assert tr.cadence == {"relin_every": "relin", "feature_update_every": "super"}.get(next(iter(cadence), ""), "fresh")
    tr.init_state()
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    assert np.isfinite(tr.train_one_epoch())
    moved = {k for k, p in tm.named_parameters() if not torch.equal(p.detach(), before[k])}
    assert moved == set(before)
    assert all(np.isfinite(v) for v in tr.test().values())


def test_attribute_dropout_binds_its_own_rate(data, monkeypatch):
    """The attribute view drops its neighbour rows at asage's DROPOUT_RATE,
    bound from sage's at import (as JAX binds it): with sage's set to 0 the
    main view has no dropout, and the attribute view still drops 0.2."""
    _, td, _, tm, _ = _both(data)
    _, tb = _batch(td, seed=2)
    monkeypatch.setattr(tsage, "DROPOUT_RATE", 0.0)
    calls = []
    real = tasage.dropout

    def spy(x, generator, rate=None):
        out = real(x, generator, rate)
        calls.append((rate, x.detach(), out.detach()))
        return out

    monkeypatch.setattr(tasage, "dropout", spy)
    main = tm._encode_batch(td.graph, tb, torch.Generator().manual_seed(0), None, None)
    again = tm._encode_batch(td.graph, tb, torch.Generator().manual_seed(0), None, None)
    assert all(torch.equal(a, b) for a, b in zip(main, again)) and not calls
    tm.loss(td.graph, tb, torch.Generator().manual_seed(1))
    assert len(calls) == 3 * 3  # three trees, L (L + 1) / 2 combines each
    x = torch.cat([c[1].reshape(-1) for c in calls])
    out = torch.cat([c[2].reshape(-1) for c in calls])
    assert all(c[0] == 0.2 for c in calls)
    kept = out[x != 0] != 0
    assert abs(1.0 - float(kept.float().mean()) - 0.2) < 0.02
    np.testing.assert_allclose(out[x != 0][kept].numpy(), (x[x != 0][kept] / 0.8).numpy(), rtol=1e-6)


# ---- registry, conversion, CLI, server ----
def test_registry_key_and_parameter_tree_round_trip(data):
    assert "asage" in available_models() and "asage" in SAGE_KEYS
    _, td, jm, tm, p = _both(data)
    out, want = params_to_numpy(tm), _np(p)
    assert jax.tree_util.tree_structure(out) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert out["user_attr_emb"].shape == (40, DIM) and out["item_attr_emb"].shape == (60, DIM)
    with pytest.raises(ValueError, match="features"):
        build_model("asage", tm.config, td.graph)
    fresh = build_model("asage", tm.config, td.graph, features=tm.features, generator=torch.Generator().manual_seed(1))
    again = build_model("asage", tm.config, td.graph, features=tm.features, generator=torch.Generator().manual_seed(1))
    for a, b in zip(fresh.parameters(), again.parameters()):
        assert torch.equal(a, b)
    before = {k: v.detach().clone() for k, v in fresh.named_parameters()}
    fresh.init_parameters(torch.Generator().manual_seed(1))
    assert all(torch.equal(before[k], v) for k, v in fresh.named_parameters())


def _write_text_dataset(root, n_users=40, m_items=60, seed=0):
    rng = np.random.default_rng(seed)
    cf = root / "cf"
    cf.mkdir(parents=True)
    with open(cf / "train.txt", "w") as f, open(cf / "test.txt", "w") as g:
        for u in range(n_users):
            items = rng.choice(m_items, size=rng.integers(5, 10), replace=False)
            f.write(f"{u} " + " ".join(map(str, items[:-2])) + "\n")
            g.write(f"{u} " + " ".join(map(str, items[-2:])) + "\n")


@pytest.mark.parametrize("source", ["categorical", "artifacts"])
def test_build_model_inputs_match_jax(tmp_path, source):
    """cli.build_model_inputs gives the JAX package's attribute graphs: from
    the categorical columns (flags with c) or from the attribute artifacts
    (flags without c); both models' CSRs bit-equal. Without either, the
    port raises naming the way out (JAX fails on the missing array)."""
    from furusato_recommend_tpu.cli import build_model_inputs as jinputs
    from furusato_recommend_tpu.data.dataset import load_text_dataset as jload
    from furusato_recommend_tpu.preprocessing.artifacts import write_artifacts
    from furusato_recommend_tpu_torch.cli import build_model_inputs
    from furusato_recommend_tpu_torch.data import artifacts as tart
    from furusato_recommend_tpu_torch.data.dataset import load_text_dataset

    _write_text_dataset(tmp_path)
    flags = "nc" if source == "categorical" else "n"
    kw = dict(model="asage", data_path=str(tmp_path), user_feature=flags, item_feature=flags, latent_dim=DIM)
    jd, td = jload(JConfig(**kw)), load_text_dataset(Config(**kw))
    rng = np.random.default_rng(1)
    write_artifacts(tmp_path, user_numeric=rng.random((jd.n_users, 5)), item_numeric=rng.random((jd.m_items, 4)),
                    user_categorical=rng.integers(0, 6, (jd.n_users, 3)),
                    item_categorical=rng.integers(0, 8, (jd.m_items, 2)))
    if source == "artifacts":
        tart.write_attribute_artifacts(td, tmp_path, seed=2)
    jgraph, jkw = jinputs(JConfig(**kw), jd)
    tgraph, tkw = build_model_inputs(Config(**kw), td)
    assert ("user_attr" in tkw) == ("user_attr" in jkw) == (source == "artifacts")
    jm = jbuild_model("asage", JConfig(**kw), jgraph, **jkw)
    tm = build_model("asage", Config(**kw), tgraph, **tkw)
    for side in ("user", "item"):
        _csr_equal(tm._attr_csr[side][0], getattr(jm, f"{side}_attr_fwd"), side)
        _csr_equal(tm._attr_csr[side][1], getattr(jm, f"{side}_attr_bwd"), side)
    if source == "artifacts":
        (tmp_path / "attribute" / "user_attribute.pt").unlink()
        _, tkw = build_model_inputs(Config(**kw), td)
        with pytest.raises(ValueError, match="categorical"):
            build_model("asage", Config(**kw), tgraph, **tkw)


def test_cli_trains_asage_and_serves_it(tmp_path):
    """The CLI trains asage from the artifacts ``data.artifacts`` writes (its
    attribute graphs among them) with the ddp recipe, and the server loads
    the checkpoint over the same attribute graphs."""
    from furusato_recommend_tpu_torch.cli import main
    from furusato_recommend_tpu_torch.data import artifacts
    from furusato_recommend_tpu_torch.serve import Recommender

    _write_text_dataset(tmp_path / "data")
    artifacts.main(["--data_path", str(tmp_path / "data"), "--seed", "1"])
    assert (tmp_path / "data" / "attribute" / "product_attribute.pt").exists()
    main(["--model", "asage", "--ddp_recipe", "--recdim", "16", "--bpr_batch", "256", "--lr", "0.01",
          "--epochs", "1", "--test_span", "1", "--topks", "[5,10]", "--testbatch", "32",
          "--data_path", str(tmp_path / "data"), "--path", str(tmp_path / "ck"), "--device", "cpu"])
    (ckpt,) = (tmp_path / "ck" / "asage").glob("*.ckpt")
    rec = Recommender.from_checkpoint(str(ckpt), device="cpu")
    assert (rec.model.n_user_attrs, rec.model.n_item_attrs) == (16, 24)
    ids, scores = rec.recommend([0, 7], k=5)
    assert ids.shape == (2, 5) and np.isfinite(scores).all()


def test_recommender_serves_asage_like_jax(data, no_text_hub):
    """The port's CPU Recommender against the JAX Recommender at k = 10."""
    from furusato_recommend_tpu.serve import Recommender as JRecommender
    from furusato_recommend_tpu_torch.serve import Recommender

    jd, td, jm, tm, p = _both(data)
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
