"""Port vs JAX package: the attention SAGE models (``tgrec``, ``tgrec2``,
``gnn --conv gat | transformer``): ``csr_row_ids``, the segment ops, the
``gat`` / ``transformer`` / ``transformer_cat`` convs, the SAGE model over
them, three Adam steps, and the parameter / Adam-state conversion of their
layers.

Same numpy data in both packages: ``synthetic_dataset(60, 80, avg_degree=6,
seed=3)`` with every edge of user 0 and item 0 taken out, so that both
sides have a node of degree zero (an empty segment in the full graph, a
clipped neighbour slot in a fanout tree). The JAX package's initial
parameters come across through ``params_from_jax``; d = 16, so 8 heads of 2.
Each JAX function is jitted once. Tolerances:

- segment ops, convs' forwards and the float32 SAGE forward (the JAX graph
  without hub-dense blocks, ``compute_dtype="float32"``, its text hub off):
  only the order of float32 sums differs, rtol 1e-5, atol 1e-6 (propagate
  and loss atol 1e-5);
- gradients: rtol 1e-4, atol 1e-6 (of the gradient's largest magnitude
  where it exceeds 1: an element sums hundreds of products);
- the bfloat16 default: both round the text-bag SpMM operands to bfloat16,
  the JAX package also each product and its text hub: rtol 2e-2, atol 2e-3;
- three Adam steps at lr 1e-3: every parameter within 1e-6 + 1e-5 |p|.

Fanout trees and dropout come from other generators in the two packages: the
JAX package samples the trees and batches and both take them, dropout 0 in
both; the convs take a dropped-out neighbour block as input.
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
from furusato_recommend_tpu.data.features import synthetic_features as jfeatures
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
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
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models import sage_convs as tconvs
from furusato_recommend_tpu_torch.models.registry import available_models, build_model
from furusato_recommend_tpu_torch.ops import csr_search as tcsr
from furusato_recommend_tpu_torch.ops import segment as tseg
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 60, 80, 16
TIGHT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
LOOSE = dict(rtol=2e-2, atol=2e-3)
ATTENTION = ["gat", "transformer", "transformer_cat"]
# (registry key, config fields) of the models this slice ports
MODELS = [("tgrec", {}), ("tgrec2", {}), ("gnn", {"conv": "gat"}), ("gnn", {"conv": "transformer"})]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


@pytest.fixture(scope="module")
def data():
    """{"hub_free", "default"} JAX datasets and the port's, same arrays, with
    user 0 and item 0 of degree zero."""
    base = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=6, seed=3)
    keep = (base.train_user != 0) & (base.train_item != 0)
    arrays = (base.train_user[keep], base.train_item[keep], base.test_user, base.test_item)
    jd = jds.Dataset(N_USERS, M_ITEMS, *arrays)
    g = jbuild_graph(*arrays, N_USERS, M_ITEMS, hub_count=0, dst_hub_count=0)
    td = tds.Dataset(N_USERS, M_ITEMS, *arrays)
    assert 200 <= td.train_size <= 400
    assert int(td.graph.user_degrees()[0]) == 0 and int(td.graph.item_degrees()[0]) == 0
    return {"hub_free": dataclasses.replace(jd, _graph=g), "default": jd}, td


@pytest.fixture
def no_text_hub(monkeypatch):
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(jsage, "DROPOUT_RATE", 0.0)
    monkeypatch.setattr(tsage, "DROPOUT_RATE", 0.0)


def _flagship(**kw) -> dict:
    """The ddp flagship recipe's fields, cut to the test's size."""
    cfg = dataclasses.asdict(ddp_flagship_config())
    cfg.pop("mesh")
    cfg.update(latent_dim=DIM, num_neighbors=3, bpr_batch_size=48, eval_user_batch=32, topks=(5, 10),
               compute_dtype="float32", decay=1e-2)
    cfg.update(kw)
    return cfg


def _both(data, name, compute_dtype="float32", **cfg):
    """(jax dataset, port dataset, jax model, port model, jax params)."""
    jsets, td = data
    jd = jsets["hub_free" if compute_dtype == "float32" else "default"]
    kw = _flagship(model=name, compute_dtype=compute_dtype, **cfg)
    jm = jbuild_model(name, JConfig(**kw), jd.graph, features=jfeatures(jd, JConfig(**kw), seed=1))
    tm = build_model(name, Config(**kw), td.graph, features=synthetic_features(td, Config(**kw), seed=1))
    p = jm.init(jax.random.PRNGKey(0))
    params_from_jax(_np(p), tm)
    return jd, td, jm, tm, p


# ---- csr_row_ids and the segment ops ----
def test_csr_row_ids_matches_jax(data):
    jsets, td = data
    jg = jsets["hub_free"].graph
    for side in ("user_pos", "item_pos", "test_pos"):
        want = np.asarray(jax.jit(jcsr.csr_row_ids)(getattr(jg, side)))
        got = tcsr.csr_row_ids(getattr(td.graph, side))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _segments(seed, trailing):
    """Sorted segment ids over 12 segments, 0, 5 and 11 of them empty, and
    Gaussian rows."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice([1, 2, 3, 4, 6, 7, 8, 9, 10], size=50)).astype(np.int32)
    return ids, rng.standard_normal((50,) + trailing).astype(np.float32)


@pytest.mark.parametrize("trailing", [(), (3,), (2, 4)])
def test_segment_ops_match_jax(trailing):
    """Rows of 0, 1 and 2 trailing dimensions (the attention's [E, H]); the
    JAX means take at most one."""
    ids, x = _segments(len(trailing), trailing)
    num = 12
    means = ("segment_mean",) if len(trailing) < 2 else ()
    for name in ("segment_sum", "segment_max") + means:
        want = np.asarray(jax.jit(getattr(jseg, name), static_argnums=2)(jnp.asarray(x), jnp.asarray(ids), num))
        got = getattr(tseg, name)(torch.from_numpy(x), torch.from_numpy(ids), num).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, **TIGHT, err_msg=name)
        empty = want[[0, 5, 11]]
        if name == "segment_max":
            assert np.isneginf(empty).all() and np.isneginf(got[[0, 5, 11]]).all()
        else:
            assert (empty == 0).all() and (got[[0, 5, 11]] == 0).all()
    if not means:
        return
    src = np.random.default_rng(1).integers(0, 50, size=50).astype(np.int32)
    want = jax.jit(jseg.gather_segment_mean, static_argnums=3)(jnp.asarray(x), jnp.asarray(src), jnp.asarray(ids), num)
    got = tseg.gather_segment_mean(torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(ids), num)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


def _check_grads(jax_fn, torch_fn, inputs, seed):
    """Forward of both at ``inputs`` (a dict of numpy arrays) and the
    gradients of <out, cotangent> with respect to every input: rtol 1e-4,
    atol 1e-6 of the gradient's largest magnitude (at least 1), since an
    element of a gradient sums hundreds of products of unit size."""
    want = jax_fn({k: jnp.asarray(v) for k, v in inputs.items()})
    cot = np.random.default_rng(seed).standard_normal(np.shape(want)).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda q: jnp.sum(jax_fn(q) * cot)))({k: jnp.asarray(v) for k, v in inputs.items()})
    tin = {k: _t(v, grad=True) for k, v in inputs.items()}
    got = torch_fn(tin)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TIGHT)
    (got * torch.from_numpy(cot)).sum().backward()
    for k, v in tin.items():
        want_g = np.asarray(jgrads[k])
        np.testing.assert_allclose(v.grad.numpy(), want_g, rtol=GRAD["rtol"],
                                   atol=GRAD["atol"] * max(1.0, float(np.abs(want_g).max())), err_msg=k)


@pytest.mark.parametrize("side", ["user", "item"])
def test_segment_attention_matches_jax(data, side):
    """segment_softmax_aggregate and segment_mh_attention over a side's CSR
    with an empty row, forward and gradients."""
    jsets, td = data
    jg, tg = jsets["hub_free"].graph, td.graph
    jcsr_, tcsr_ = (jg.user_pos, tg.user_pos) if side == "user" else (jg.item_pos, tg.item_pos)
    n_dst, n_src = (N_USERS, M_ITEMS) if side == "user" else (M_ITEMS, N_USERS)
    rng = np.random.default_rng(7)
    gat_in = {"s_src": rng.standard_normal(n_src).astype(np.float32),
              "s_dst": rng.standard_normal(n_dst).astype(np.float32),
              "values": rng.standard_normal((n_src, DIM)).astype(np.float32)}
    _check_grads(
        jax.jit(lambda q: jseg.segment_softmax_aggregate(jcsr_, q["s_src"], q["s_dst"], q["values"], n_dst)),
        lambda q: tseg.segment_softmax_aggregate(tcsr_, q["s_src"], q["s_dst"], q["values"], n_dst),
        gat_in, seed=1,
    )
    mh_in = {"x_self": rng.standard_normal((n_dst, DIM)).astype(np.float32),
             "other_x": rng.standard_normal((n_src, DIM)).astype(np.float32),
             **{w: (0.4 * rng.standard_normal((DIM, DIM))).astype(np.float32) for w in ("wq", "wk", "wv")}}
    _check_grads(
        jax.jit(lambda q: jseg.segment_mh_attention(q, q["x_self"], q["other_x"], jcsr_, jconvs.N_HEADS)),
        lambda q: tseg.segment_mh_attention(q, q["x_self"], q["other_x"], tcsr_, tconvs.N_HEADS),
        mh_in, seed=2,
    )


# ---- the convs ----
def _conv_params(conv, gain=0.5):
    jp = jconvs.get_conv(conv).init(jax.random.PRNGKey(3), DIM, gain)
    fresh = tconvs.get_conv(conv).init(torch.Generator().manual_seed(0), DIM, gain)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {k: tuple(v.shape) for k, v in jp.items()}
    return _np(jp)


def _sampled_block(seed):
    """targets [6, 3, d] and their neighbour blocks [6, 3, 4, d]: target
    (0, 0) has degree zero (the sampler's one clipped slot in every place),
    block (1, 2) is dropped out entirely, and the rest carry a dropout mask
    (kept entries scaled by 1 / 0.8)."""
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((6, 3, DIM)).astype(np.float32)
    nbrs = rng.standard_normal((6, 3, 4, DIM)).astype(np.float32)
    nbrs[0, 0] = nbrs[0, 0, :1]
    keep = rng.random(nbrs.shape) < 0.8
    nbrs = np.where(keep, nbrs / np.float32(0.8), 0.0).astype(np.float32)
    nbrs[1, 2] = 0.0
    return target, nbrs


@pytest.mark.parametrize("conv", ATTENTION)
def test_conv_sampled_matches_jax(conv):
    jc, tc = jconvs.get_conv(conv), tconvs.get_conv(conv)
    target, nbrs = _sampled_block(4)
    inputs = {**_conv_params(conv), "target": target, "nbrs": nbrs}

    def jax_fn(q):
        return jc.sampled(q, q["target"], jnp.mean(q["nbrs"], axis=-2), {"neighbors": q["nbrs"], "side": "user"})

    def torch_fn(q):
        return tc.sampled(q, q["target"], q["nbrs"].mean(dim=-2), {"neighbors": q["nbrs"], "side": "user"})

    _check_grads(jax.jit(jax_fn), torch_fn, inputs, seed=5)


@pytest.mark.parametrize("conv", ATTENTION)
@pytest.mark.parametrize("side", ["user", "item"])
def test_conv_full_graph_matches_jax(data, conv, side):
    jsets, td = data
    jg, tg = jsets["hub_free"].graph, td.graph
    jc, tc = jconvs.get_conv(conv), tconvs.get_conv(conv)
    rng = np.random.default_rng(6)
    n_self, n_other = (N_USERS, M_ITEMS) if side == "user" else (M_ITEMS, N_USERS)
    inputs = {**_conv_params(conv), "x_self": rng.standard_normal((n_self, DIM)).astype(np.float32),
              "other": rng.standard_normal((n_other, DIM)).astype(np.float32)}
    aggr = rng.standard_normal((n_self, DIM)).astype(np.float32)  # unused by attention

    def jax_fn(q):
        return jc.full_graph(q, q["x_self"], jnp.asarray(aggr), q["other"], side, {"graph": jg})

    def torch_fn(q):
        return tc.full_graph(q, q["x_self"], torch.from_numpy(aggr), q["other"], side, {"graph": tg})

    _check_grads(jax.jit(jax_fn), torch_fn, inputs, seed=7)


# ---- the SAGE models ----
@pytest.mark.parametrize("name,cfg", MODELS)
def test_propagate_matches_jax(data, no_text_hub, name, cfg):
    jd, td, jm, tm, p = _both(data, name, **cfg)
    ju, ji = jax.jit(lambda q: jm.propagate(q, jd.graph))(p)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    assert tu.shape == (N_USERS, DIM) and ti.shape == (M_ITEMS, DIM)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,cfg", MODELS[:3])
def test_propagate_bfloat16_default(data, name, cfg):
    jd, td, jm, tm, p = _both(data, name, compute_dtype="bfloat16", **cfg)
    ju, ji = jax.jit(lambda q: jm.propagate(q, jd.graph))(p)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **LOOSE)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **LOOSE)


def _batch(td, seed, b=48):
    """A BPR batch over users with neighbours (and user 0, without), the last
    4 rows invalid."""
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(1, N_USERS, b)
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, b)
    user[1] = 0  # degree zero: its tree's slots are the clipped one
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


@pytest.mark.parametrize("name,cfg", MODELS[:3])
def test_loss_and_grads_match_jax(data, no_text_hub, no_dropout, name, cfg):
    jd, td, jm, tm, p = _both(data, name, **cfg)
    jb, tb = _batch(td, seed=0)
    jtrees = _jax_trees(jm, jd, jb, seed=5)
    assert not bool(jtrees[0][0].has_neighbors[1])  # user 0 draws the clipped slot
    (jl, jaux), jg = _jax_loss_grad(jm, jd)(p, jb, jtrees)
    tl, taux = tm.loss(td.graph, tb, trees=_tree_to_torch(jtrees))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("bpr", "reg"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-5)
    want = flatten_params(_np(jg))
    for n_, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[n_], rtol=1e-4, atol=1e-6, err_msg=n_)


def test_three_adam_steps_match_optax_and_state_converts(data, no_text_hub, no_dropout):
    """tgrec at the flagship's lr 1e-3: three Adam steps on JAX-sampled
    batches and trees against jax.value_and_grad(model.loss) + optax.adam;
    then the JAX parameters and Adam state carried into a fresh port model
    and optimizer take a fourth step equal to JAX's."""
    jd, td, jm, tm, jp = _both(data, "tgrec")
    lr = 1e-3
    opt = optax.adam(lr)
    state = opt.init(jp)
    topt = torch.optim.Adam(tm.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step_fn = _jax_loss_grad(jm, jd)

    def check(model, want, label):
        got = flatten_params(params_to_numpy(model))
        want = flatten_params(_np(want))
        assert set(got) == set(want)
        for k in want:
            diff = np.abs(got[k] - want[k])
            assert (diff <= 1e-6 + 1e-5 * np.abs(want[k])).all(), f"{label}: {k} off by {diff.max()}"

    draws = []
    for step in range(4):
        jb, tb = _batch(td, seed=10 + step)
        draws.append((jb, tb, _jax_trees(jm, jd, jb, seed=20 + step)))
    for step, (jb, tb, jtrees) in enumerate(draws[:3]):
        _, grads = step_fn(jp, jb, jtrees)
        upd, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        tm.loss(td.graph, tb, trees=_tree_to_torch(jtrees))[0].backward()
        topt.step()
        check(tm, jp, f"step {step}")
    assert {"wq", "wk", "wv", "w_skip"} <= set(dict(tm.layers[0].named_parameters()))

    # the JAX state carried across: parameters, then the Adam moments
    fresh = build_model("tgrec", tm.config, td.graph, features=tm.features)
    params_from_jax(_np(jp), fresh)
    check(fresh, jp, "carried")
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
    fopt.step()
    check(fresh, jp, "step 4 from the carried state")


@pytest.mark.parametrize("name,cfg,layer_keys", [
    ("tgrec", {}, {"wq", "wk", "wv", "w_skip"}),
    ("tgrec2", {}, {"wq", "wk", "wv", "w_out", "b_out"}),
    ("gnn", {"conv": "gat"}, {"w", "a_src", "a_dst", "b"}),
    ("gnn", {"conv": "transformer"}, {"wq", "wk", "wv", "w_skip"}),
])
def test_registry_keys_and_parameter_tree_round_trip(data, name, cfg, layer_keys):
    assert {"tgrec", "tgrec2", "gnn"} <= set(available_models())
    _, _, jm, tm, p = _both(data, name, **cfg)
    assert tm.conv_name == {"tgrec": "transformer", "tgrec2": "transformer_cat"}.get(name, cfg.get("conv"))
    out = params_to_numpy(tm)
    want = _np(p)
    assert jax.tree_util.tree_structure(out) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert [set(lp) for lp in out["layers"]] == [layer_keys] * 2
    assert out["layers"][0]["wq" if "wq" in layer_keys else "a_src"].shape == (DIM, DIM if "wq" in layer_keys else 1)


def test_recommender_serves_tgrec_like_jax(data, no_text_hub):
    """The port's CPU Recommender for tgrec (refresh = full-graph propagate)
    against the JAX Recommender, at k = 10 and at k = 70 (train positives
    ranked last at -1024)."""
    from furusato_recommend_tpu.serve import Recommender as JRecommender
    from furusato_recommend_tpu_torch.serve import Recommender

    jd, td, jm, tm, p = _both(data, "tgrec")
    jrec = JRecommender(jm, jd, jm.config, p)
    trec = Recommender(tm, td, tm.config, _np(p), device="cpu")
    users = np.arange(N_USERS)
    for k in (10, 70):
        jid, jsc = (np.asarray(x) for x in jrec.recommend(users, k=k))
        tid, tsc = trec.recommend(users, k=k)
        np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-5)
        gap = np.abs(np.diff(jsc, axis=1)) > 1e-5 * np.abs(jsc[:, 1:])
        sep = np.ones(jid.shape, dtype=bool)
        sep[:, 1:] &= gap
        sep[:, :-1] &= gap
        np.testing.assert_array_equal(tid[sep], jid[sep])
        assert sep.mean() > 0.9


@pytest.mark.parametrize("model_args", [["--model", "tgrec"], ["--model", "gnn", "--conv", "gat"]])
def test_cli_trains_attention_models_and_serves_them(tmp_path, model_args):
    """The CLI trains the attention keys through the SAGE family's inputs
    (feature artifacts under --data_path) with the ddp recipe, and the
    server loads the checkpoint."""
    from furusato_recommend_tpu_torch.cli import main
    from furusato_recommend_tpu_torch.data import artifacts
    from furusato_recommend_tpu_torch.serve import Recommender

    rng = np.random.default_rng(0)
    data = tmp_path / "data" / "cf"
    data.mkdir(parents=True)
    with open(data / "train.txt", "w") as f, open(data / "test.txt", "w") as g:
        for u in range(40):
            items = rng.choice(60, size=rng.integers(5, 10), replace=False)
            f.write(f"{u} " + " ".join(map(str, items[:-2])) + "\n")
            g.write(f"{u} " + " ".join(map(str, items[-2:])) + "\n")
    artifacts.main(["--data_path", str(tmp_path / "data"), "--seed", "1"])
    main(model_args + [
        "--ddp_recipe", "--recdim", "16", "--bpr_batch", "256", "--lr", "0.01", "--epochs", "1",
        "--test_span", "1", "--topks", "[5,10]", "--testbatch", "32",
        "--data_path", str(tmp_path / "data"), "--path", str(tmp_path / "ck"), "--device", "cpu",
    ])
    (ckpt,) = (tmp_path / "ck" / model_args[1]).glob("*.ckpt")
    rec = Recommender.from_checkpoint(str(ckpt), device="cpu")
    assert rec.model.conv_name == ("transformer" if model_args[1] == "tgrec" else "gat")
    ids, scores = rec.recommend([0, 7], k=5)
    assert ids.shape == (2, 5) and np.isfinite(scores).all()
