"""Port vs JAX package: the SAGE trainer's cadences of the cached initial
tables (``train/trainer.py``: ``relin_every`` R, ``feature_update_every`` T).

The JAX side is the JAX trainer's epoch program written out as plain loops
(``jax.vjp(model.initial_tables, p)``, ``jax.value_and_grad`` and
``optax.multi_transform``, as ``train/trainer.py:279-463`` runs them), never a
JAX ``Trainer`` epoch program. Both sides take the same parameters, the same 8
batches and the same fanout trees (sampled by the JAX package), dropout 0, on
a hub-free graph at ``compute_dtype="float32"``:

- R in {0, 1, 3}, and T = 4 with R = 1 and R = 0: every step's loss and the
  final parameters within rtol 1e-4, atol 1e-6;
- the feature-parameter partition equals JAX ``initial_param_keys``, and the
  port's tables depend on exactly those parameters;
- epochs round up to whole blocks (R = 7) and super-steps (T = 4) as the JAX
  trainer's, and R = -1 raises in both;
- a T > 1 checkpoint round trip resumes bit-equal, and a JAX two-transform
  optimizer state carries across (its Adam's moments read from the optax
  state here, set by ``convert.adam_state_from_jax``).
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
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu_torch.config import Config, ddp_flagship_config
from furusato_recommend_tpu_torch.convert import (
    adam_state_from_jax,
    flatten_params,
    params_from_jax,
    params_to_numpy,
)
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM, STEPS, B = 100, 140, 16, 8, 48
TOL = dict(rtol=1e-4, atol=1e-6)


def adam_from_optax(state):
    """(count, mu, nu) of the Adam inside an optax state (``adam``, a chain,
    or ``multi_transform`` / ``masked`` around one), as numpy, with the moments
    flat (``flatten_params``) and the masked-out parameters (optax's
    ``MaskedNode``, an empty tuple) left out."""

    def find(s):
        if all(hasattr(s, a) for a in ("count", "mu", "nu")):
            return s
        if hasattr(s, "inner_states"):  # multi_transform
            children = list(s.inner_states.values())
        elif hasattr(s, "inner_state"):  # masked
            children = [s.inner_state]
        elif isinstance(s, dict):
            children = list(s.values())
        elif isinstance(s, (tuple, list)):  # a chain
            children = list(s)
        else:
            children = []
        return next((f for f in map(find, children) if f is not None), None)

    adam = find(state)
    assert adam is not None, "no Adam state in the optax state"

    def moments(tree):
        return {k: np.asarray(v) for k, v in flatten_params(tree).items()
                if not (v is None or (isinstance(v, tuple) and len(v) == 0))}

    return int(np.asarray(adam.count)), moments(adam.mu), moments(adam.nu)


def _kw(**over) -> dict:
    cfg = dataclasses.asdict(ddp_flagship_config())
    cfg.pop("mesh")
    cfg.update(latent_dim=DIM, num_neighbors=3, bpr_batch_size=B, eval_user_batch=32, topks=(5, 10),
               test_count=2, compute_dtype="float32", decay=1e-2, user_feature="nctw", item_feature="nctw")
    cfg.update(over)
    return cfg


def _batch(td, seed):
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(0, N_USERS, B)
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, B)
    valid = np.ones(B, dtype=bool)
    valid[-4:] = False
    arrs = [a.astype(np.int32) for a in (user, pos, neg)] + [valid]
    return JBatch(*(jnp.asarray(a) for a in arrs)), BPRBatch(*(torch.from_numpy(a) for a in arrs))


class _Jax:
    """The JAX model with jitted loss, tables and pullback functions (traced
    once for every cadence of this module)."""

    def __init__(self, jm, graph, ooc=False):
        self.m, self.graph = jm, graph
        key = jax.random.PRNGKey(0)

        def cached(p, t, batch, trees):
            return jm.loss(p, graph, batch, key, tables=t, trees=trees)

        def fresh(p, batch, trees):
            return jm.loss(p, graph, batch, key, tables=jm.initial_tables(p), trees=trees)

        self.cached = jax.jit(jax.value_and_grad(cached, argnums=(0, 1), has_aux=True))
        self.fresh = jax.jit(jax.value_and_grad(fresh, has_aux=True))
        if ooc:
            def tables(p, pr):
                return jm.initial_tables(p, ooc_proj=pr)
        else:
            def tables(p, pr):
                return jm.initial_tables(p)
        self.tables = jax.jit(tables)
        # the pullback at the snapshot (p, pr); recomputing the forward there
        # gives the stored vjp's numbers
        self.pullback = jax.jit(lambda p, pr, g: jax.vjp(tables, p, pr)[1](g))


@pytest.fixture(scope="module")
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
        mp.setattr(jsage, "DROPOUT_RATE", 0.0)
        mp.setattr(tsage, "DROPOUT_RATE", 0.0)
        jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
        td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
        g = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, N_USERS, M_ITEMS,
                         hub_count=0, dst_hub_count=0)
        jd = dataclasses.replace(jd, _graph=g)
        kw = _kw()
        jm = jbuild_model("textsage", JConfig(**kw), jd.graph, features=jfeatures(jd, JConfig(**kw), seed=1))
        tf = synthetic_features(td, Config(**kw), seed=1)
        jp = jm.init(jax.random.PRNGKey(0))
        batches = [_batch(td, seed=s) for s in range(STEPS)]
        jtrees, ttrees = [], []
        for s, (jb, _) in enumerate(batches):
            keys = jax.random.split(jax.random.PRNGKey(10 + s), 3)
            t = [jm.sample_seed_tree(jd.graph, x, side, k)
                 for (x, side), k in zip(((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item")), keys)]
            jtrees.append(t)
            ttrees.append({"trees": [[SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in tr]
                                     for tr in t]})
        yield dict(jd=jd, td=td, tf=tf, jp=jp, jax=_Jax(jm, jd.graph), batches=batches,
                   jtrees=jtrees, ttrees=ttrees)


def _tree_add(a, b):
    return jax.tree_util.tree_map(jnp.add, a, b)


def _labels(feat_keys, in_set):
    def build(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: "on" if path and ((getattr(path[0], "key", None) in feat_keys) == in_set) else "off",
            params,
        )
    return build


def jax_cadence(J, p, batches, trees, R, T, lr, steps=None):
    """The JAX trainer's epoch over ``batches`` at (R, T): (params, per-step
    losses, the optimizer state(s))."""
    n = len(batches)
    losses = []
    if T == 1:
        opt = optax.adam(lr)
        state = opt.init(p)
        lin = None
        for i in range(n):
            if R == 1:
                (loss, _), grads = J.fresh(p, batches[i], trees[i])
            else:
                if i % (R or n) == 0:
                    p0 = p
                    lin = J.tables(p0, None)
                (loss, _), (g_p, g_t) = J.cached(p, lin, batches[i], trees[i])
                g_feat, _ = J.pullback(p0, None, g_t)
                grads = _tree_add(g_p, g_feat)
            upd, state = opt.update(grads, state, p)
            p = optax.apply_updates(p, upd)
            losses.append(float(loss))
        return p, losses, state
    feat_keys = J.m.initial_param_keys()
    opt = optax.multi_transform({"on": optax.adam(lr), "off": optax.set_to_zero()}, _labels(feat_keys, False))
    opt_feat = optax.multi_transform({"on": optax.adam(lr), "off": optax.set_to_zero()}, _labels(feat_keys, True))
    opt_d, opt_f = steps if steps is not None else (opt.init(p), opt_feat.init(p))
    epoch_p0 = p
    for s in range(0, n, T):
        p0 = epoch_p0 if R == 0 else p
        tables0 = J.tables(p0, None)
        acc_t = jax.tree_util.tree_map(jnp.zeros_like, tables0)
        acc_p = jax.tree_util.tree_map(jnp.zeros_like, p)
        for i in range(s, s + T):
            (loss, _), (g_p, g_t) = J.cached(p, tables0, batches[i], trees[i])
            acc_t, acc_p = _tree_add(acc_t, g_t), _tree_add(acc_p, g_p)
            upd, opt_d = opt.update(g_p, opt_d, p)
            p = optax.apply_updates(p, upd)
            losses.append(float(loss))
        g_feat, _ = J.pullback(p0, None, jax.tree_util.tree_map(lambda x: x / T, acc_t))
        g_feat = jax.tree_util.tree_map(lambda a, b: a + b / T, g_feat, acc_p)
        upd, opt_f = opt_feat.update(g_feat, opt_f, p)
        p = optax.apply_updates(p, upd)
    return p, losses, (opt_d, opt_f)


def _port_trainer(env, **over):
    cfg = Config(**_kw(**over))
    model = build_model("textsage", cfg, env["td"].graph, features=env["tf"])
    params_from_jax(jax.tree_util.tree_map(np.asarray, env["jp"]), model)
    return Trainer(cfg, env["td"], model, device="cpu", logger=MetricLogger(quiet=True))


def _assert_params(model, jp, msg):
    got = flatten_params(params_to_numpy(model))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jp))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=f"{msg}: {k}")


@pytest.mark.parametrize("R,T", [(0, 1), (1, 1), (3, 1), (1, 4), (0, 4)])
def test_cadence_matches_jax_loop(env, R, T):
    tr = _port_trainer(env, relin_every=R, feature_update_every=T)
    assert tr.cadence == ("fresh" if (R, T) == (1, 1) else "relin" if T == 1 else "super")
    jb = [b for b, _ in env["batches"]]
    jp, jlosses, _ = jax_cadence(env["jax"], env["jp"], jb, env["jtrees"], R, T, tr.config.lr)
    losses = tr.train_epoch([b for _, b in env["batches"]], draws=env["ttrees"])
    np.testing.assert_allclose(losses.numpy(), jlosses, **TOL)
    _assert_params(tr.model, jp, f"R={R} T={T}")


def test_feature_params_held_inside_a_super_step(env):
    """T = 4: the feature parameters stay bit-identical for the super-step's
    steps and move at its end; the others move every step."""
    tr = _port_trainer(env, feature_update_every=4)
    named = dict(tr.model.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    tb = [b for _, b in env["batches"]]
    tr.train_epoch(tb[:3], draws=env["ttrees"][:3])  # a super-step cut short ends all the same
    moved = {k for k, p in named.items() if not torch.equal(p.detach(), before[k])}
    assert moved == set(named)
    tr2 = _port_trainer(env, feature_update_every=4)
    for i in range(3):  # the inner steps alone
        tr2._direct_step(tb[i], env["ttrees"][i], tr2._linearize())
        tr2.optimizer.step()
    named2 = dict(tr2.model.named_parameters())
    for k in tr2.feature_names:
        assert torch.equal(named2[k].detach(), before[k]), k
    assert any(not torch.equal(named2[k].detach(), before[k]) for k in named2 if k not in tr2.feature_names)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("textsage", dict(user_feature="nctw", item_feature="nctwsr")),
        ("textsage_id", dict(user_feature="nwb", item_feature="cws")),
        ("pinsage", dict(user_feature="t", item_feature="n")),
    ],
)
def test_feature_param_partition_matches_jax(env, name, kw):
    jd, td = env["jd"], env["td"]
    full = dict(user_feature="nctwb", item_feature="nctwsrb")
    jf, tf = jfeatures(jd, JConfig(**_kw(**full)), seed=2), synthetic_features(td, Config(**_kw(**full)), seed=2)
    jm = jbuild_model(name, JConfig(**_kw(**kw)), jd.graph, features=jf)
    tm = build_model(name, Config(**_kw(**kw)), td.graph, features=tf)
    keys = tm.initial_param_keys()
    assert keys == jm.initial_param_keys()
    # the names are the convert.py names of the JAX tree's keys
    assert keys <= set(flatten_params(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))))
    named = dict(tm.named_parameters())
    ux, ix = tm.initial_tables()
    grads = torch.autograd.grad(ux.sum() + ix.sum(), list(named.values()), allow_unused=True)
    depends = {k for k, g in zip(named, grads) if g is not None and bool(g.abs().sum() > 0)}
    assert depends == keys


@pytest.mark.parametrize("ddp,bs", [(True, 64), (False, 48)])
def test_epoch_rounding_matches_jax_trainer(env, ddp, bs):
    from furusato_recommend_tpu.train.trainer import Trainer as JTrainer

    jd, td = env["jd"], env["td"]
    jm = jbuild_model("textsage", JConfig(**_kw()), jd.graph, features=jfeatures(jd, JConfig(**_kw()), seed=1))
    for over in (dict(relin_every=7), dict(feature_update_every=4), dict(feature_update_every=4, relin_every=7),
                 dict(relin_every=0), dict(relin_every=7, train_emb=True)):
        kw = _kw(bpr_batch_size=bs, **over)
        jt = JTrainer(JConfig(**kw), jd, jm, ddp_recipe=ddp)
        tm = build_model("textsage", Config(**kw), td.graph, features=env["tf"])
        tt = Trainer(Config(**kw), td, tm, ddp_recipe=ddp, device="cpu", logger=MetricLogger(quiet=True))
        assert (tt.num_batches, tt.samples_per_epoch) == (jt.num_batches, jt.samples_per_epoch), over
    with pytest.raises(ValueError, match="relin_every"):
        JTrainer(JConfig(**_kw(relin_every=-1)), jd, jm)
    with pytest.raises(ValueError, match="relin_every"):
        Trainer(Config(**_kw(relin_every=-1)), td, tm, device="cpu")


def test_super_step_checkpoint_round_trip(env, tmp_path):
    tb, trees = [b for _, b in env["batches"]], env["ttrees"]
    whole = _port_trainer(env, feature_update_every=2, path=str(tmp_path))
    whole.train_epoch(tb[:4], draws=trees[:4])
    whole.save(tmp_path / "mid.ckpt")
    whole.train_epoch(tb[4:], draws=trees[4:])
    resumed = _port_trainer(env, feature_update_every=2, seed=5)
    resumed.restore(tmp_path / "mid.ckpt")
    for opt in (resumed.optimizer, resumed.opt_feat):
        assert all(int(st["step"]) > 0 for st in opt.state.values())
    assert int(next(iter(resumed.opt_feat.state.values()))["step"]) == 2  # one a super-step
    assert int(next(iter(resumed.optimizer.state.values()))["step"]) == 4
    resumed.train_epoch(tb[4:], draws=trees[4:])
    a, b = flatten_params(params_to_numpy(whole.model)), flatten_params(params_to_numpy(resumed.model))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_transform_state_carries_across(env):
    """One JAX super-step (T = 4), then its parameters and both optax
    multi_transform states into the port's two Adams; the next super-step
    on both sides agrees."""
    J, jb = env["jax"], [b for b, _ in env["batches"]]
    lr = Config(**_kw()).lr
    jp1, _, states = jax_cadence(J, env["jp"], jb[:4], env["jtrees"][:4], 1, 4, lr)
    jp2, jlosses, _ = jax_cadence(J, jp1, jb[4:], env["jtrees"][4:], 1, 4, lr, steps=states)
    tr = _port_trainer(env, feature_update_every=4)
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp1), tr.model)
    for opt, st in zip((tr.optimizer, tr.opt_feat), states):
        count, mu, nu = adam_from_optax(jax.tree_util.tree_map(np.asarray, st))
        assert count == (4 if opt is tr.optimizer else 1)
        adam_state_from_jax(count, mu, nu, opt, tr.model)
    losses = tr.train_epoch([b for _, b in env["batches"][4:]], draws=env["ttrees"][4:])
    np.testing.assert_allclose(losses.numpy(), jlosses, **TOL)
    _assert_params(tr.model, jp2, "after the carried super-step")
