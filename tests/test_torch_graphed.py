"""What the CPU can check of the captured training step
(``train/graphed.py``); the CPU itself never captures and runs every step
eagerly through ``Trainer.train_step``, the plain version of the graph.

- the step the graph records (``Trainer.train_step``), fed the JAX package's
  batches (and, for textsage, its fanout trees, dropout 0 in both), against
  ``jax.value_and_grad`` + ``optax.adam`` for 3 steps, under
  ``tests/test_torch_train.py``'s rules: float32 on a hub-free JAX graph,
  parameters within rtol 1e-5 / atol 1e-6, the moments within rtol 1e-4;
  with the CPU's Adam and with the fused Adam a captured configuration runs
  (built here on the CPU, where it cannot be capturable);
- the fused Adam's state through the optax layout and back, and through
  ``save`` / ``restore``;
- ``tests/torch_oracle.py::OptaxAdam``, the float64 form of optax.adam's rule
  that the card's captured Adam is held against, against optax itself;
- which models declare their step capturable, the rule that picks the
  captured configurations, the CPU Trainer's eager steps and default Adam,
  and the graph dropped when the Adam states are replaced.

The card's replays are held against the eager steps in
``tests/test_torch_kernels.py`` (marked ``cuda``) and in ``chip_smoke.py``'s
phase 21.
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
    adam_state_to_numpy,
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
from furusato_recommend_tpu_torch.train import trainer as trainer_module
from furusato_recommend_tpu_torch.train.graphed import captured
from furusato_recommend_tpu_torch.train.trainer import Trainer
from torch_oracle import OptaxAdam

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 100, 120, 16


def _lgn_fields(**kw) -> dict:
    base = dict(model="lgn", latent_dim=DIM, n_layers=2, bpr_batch_size=128, lr=1e-2, eval_user_batch=32,
                topks=(5, 10), compute_dtype="float32", decay=1e-2, seed=11)
    base.update(kw)
    return base


def _flagship(**kw) -> dict:
    """The ddp flagship recipe's fields, cut to the test's size."""
    cfg = dataclasses.asdict(ddp_flagship_config())
    cfg.update(latent_dim=DIM, num_neighbors=3, bpr_batch_size=256, eval_user_batch=32, topks=(5, 10),
               test_count=2, compute_dtype="float32", decay=1e-2, lr=1e-2, seed=3)
    cfg.pop("mesh")
    cfg.update(kw)
    return cfg


def _fused_adam(params, config, capturable=False):
    """The Adam of a captured configuration (``train/sharding.py::adam`` with
    ``capturable``), on the CPU, where it is fused but not capturable."""
    return torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8, fused=True)


def _trainer(key: str, **kw) -> Trainer:
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    if key == "textsage":
        cfg = Config(**_flagship(**kw))
        model = build_model("textsage", cfg, td.graph, features=synthetic_features(td, cfg, seed=1))
        return Trainer(cfg, td, model, logger=MetricLogger(quiet=True), ddp_recipe=True, device="cpu")
    cfg = Config(**_lgn_fields(model=key, **kw))
    return Trainer(cfg, td, build_model(key, cfg, td.graph), logger=MetricLogger(quiet=True), device="cpu")


def _jax_batch(td, seed, b, n_invalid):
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(0, N_USERS, b)
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, b)
    valid = np.ones(b, dtype=bool)
    valid[-n_invalid:] = False
    arrs = [a.astype(np.int32) for a in (user, pos, neg)] + [valid]
    return JBatch(*(jnp.asarray(a) for a in arrs)), BPRBatch(*(torch.from_numpy(a) for a in arrs))


def _hub_free(jd):
    g = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
                     hub_count=0, dst_hub_count=0)
    return dataclasses.replace(jd, _graph=g)


def _lgn_pair():
    """(JAX model, its graph, Trainer, JAX parameters, lr) for lgn at float32."""
    jd = _hub_free(jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2))
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    kw = _lgn_fields(bpr_batch_size=256)
    cfg = Config(**kw)
    jm = jbuild_model("lgn", JConfig(**kw), jd.graph)
    rng = np.random.default_rng(0)
    p = {"user_emb": (0.1 * rng.standard_normal((N_USERS, DIM))).astype(np.float32),
         "item_emb": (0.1 * rng.standard_normal((M_ITEMS, DIM))).astype(np.float32)}
    tm = build_model("lgn", cfg, td.graph)
    params_from_jax(p, tm)
    t = Trainer(cfg, td, tm, logger=MetricLogger(quiet=True), device="cpu")
    return jm, jd, t, jax.tree_util.tree_map(jnp.asarray, p), cfg.lr


def _textsage_pair(monkeypatch):
    """The same for the textsage flagship (features n / c / t / w, dropout 0),
    its trees sampled by the JAX package and handed to the port's loss."""
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
    monkeypatch.setattr(jsage, "DROPOUT_RATE", 0.0)
    monkeypatch.setattr(tsage, "DROPOUT_RATE", 0.0)
    jd = _hub_free(jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2))
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    kw = _flagship(user_feature="nctw", item_feature="nctw", lr=1e-3)
    jm = jbuild_model("textsage", JConfig(**kw), jd.graph, features=jfeatures(jd, JConfig(**kw), seed=1))
    tm = build_model("textsage", Config(**kw), td.graph, features=synthetic_features(td, Config(**kw), seed=1))
    jp = jm.init(jax.random.PRNGKey(0))
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    t = Trainer(Config(**kw), td, tm, logger=MetricLogger(quiet=True), ddp_recipe=True, device="cpu")
    return jm, jd, t, jp, kw["lr"]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("key", ["lgn", "textsage"])
def test_static_step_matches_jax_three_adam_steps(key, fused, monkeypatch):
    if fused:
        monkeypatch.setattr(trainer_module, "adam", _fused_adam)
    jm, jd, t, jp, lr = _lgn_pair() if key == "lgn" else _textsage_pair(monkeypatch)
    assert all(bool(group["fused"]) is fused for group in t.optimizer.param_groups)
    td = t.dataset
    opt = optax.adam(lr)
    state = opt.init(jp)
    fed = []  # the JAX trees the port's loss takes in place of its own draws
    if key == "textsage":
        monkeypatch.setattr(t.model, "sample_seed_tree", lambda *a, **k: fed.pop(0))
    # compiled once for the three steps (trees None for lgn)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda q, b, trees: jm.loss(q, jd.graph, b, jax.random.PRNGKey(0), **({} if trees is None else
                                                                                 {"trees": trees})),
        has_aux=True))
    for step in range(3):
        jb, tb = _jax_batch(td, step, 256 if key == "lgn" else 48, 16 if key == "lgn" else 4)
        trees = None
        if key == "textsage":
            keys = jax.random.split(jax.random.PRNGKey(10 + step), 3)
            trees = [jm.sample_seed_tree(jd.graph, s, side, k) for (s, side), k in
                     zip(((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item")), keys)]
            fed[:] = [[SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in tree]
                      for tree in trees]
        (jl, _), g = value_and_grad(jp, jb, trees)
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        loss = t.train_step(tb)
        assert not fed  # every tree was read
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
        got = flatten_params(params_to_numpy(t.model))
        want = flatten_params(jax.tree_util.tree_map(np.asarray, jp))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=f"step {step}: {k}")
    count, mu, nu = adam_state_to_numpy(t.optimizer, t.model)
    assert count == int(state[0].count) == 3
    want_mu = flatten_params(jax.tree_util.tree_map(np.asarray, state[0].mu))
    want_nu = flatten_params(jax.tree_util.tree_map(np.asarray, state[0].nu))
    for k, v in flatten_params(mu).items():
        np.testing.assert_allclose(v, want_mu[k], rtol=1e-4, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(flatten_params(nu)[k], want_nu[k], rtol=1e-4, atol=1e-12, err_msg=k)


def _states_equal(a: torch.optim.Adam, b: torch.optim.Adam) -> None:
    for pa, pb in zip(a.param_groups[0]["params"], b.param_groups[0]["params"]):
        sa, sb = a.state[pa], b.state[pb]
        assert sa["step"].dtype == sb["step"].dtype == torch.float32
        assert sa["step"].device == pa.device and sb["step"].device == pb.device
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("key", ["lgn", "textsage"])
def test_fused_adam_state_through_optax_layout_and_checkpoint(key, tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_module, "adam", _fused_adam)
    t = _trainer(key)
    assert all(group["fused"] for group in t.optimizer.param_groups)
    t.train_one_epoch()
    count, mu, nu = adam_state_to_numpy(t.optimizer, t.model)
    assert count == t.num_batches
    back = _trainer(key)
    params_from_jax(params_to_numpy(t.model), back.model)
    adam_state_from_jax(count, mu, nu, back.optimizer, back.model)
    _states_equal(t.optimizer, back.optimizer)
    t.save(tmp_path / "a.ckpt")
    restored = _trainer(key)
    restored.restore(tmp_path / "a.ckpt")
    _states_equal(t.optimizer, restored.optimizer)
    # all three take the same next epoch, bit for bit
    back.generator.set_state(t.generator.get_state())
    for other in (back, restored):
        other.train_one_epoch()
    t.train_one_epoch()
    for other in (back, restored):
        np.testing.assert_array_equal(other.epoch_losses.numpy(), t.epoch_losses.numpy())
        for k, v in flatten_params(params_to_numpy(t.model)).items():
            np.testing.assert_array_equal(flatten_params(params_to_numpy(other.model))[k], v, err_msg=k)


def test_adam_oracle_matches_optax_eight_steps():
    rng = np.random.default_rng(4)
    shapes = [(30, 16), (16,), (7, 3, 5)]
    params = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    ref = OptaxAdam(params, 1e-2)
    opt = optax.adam(1e-2)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    for step in range(8):
        grads = [(rng.standard_normal(sh) * 10.0 ** rng.integers(-6, 1)).astype(np.float32) for sh in shapes]
        grads[0][step] = 0.0  # rows with no gradient this step
        upd, state = opt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        ref.step(grads)
    assert ref.count == int(state[0].count) == 8
    for got, want, m, v, wm, wv in zip(ref.params, jp, ref.mu, ref.nu, state[0].mu, state[0].nu):
        # optax's float32 against float64: the file's rules
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m, np.asarray(wm), rtol=1e-4, atol=1e-12)
        np.testing.assert_allclose(v, np.asarray(wv), rtol=1e-4, atol=1e-18)


_CAPTURABLE = {"lgn": True, "rgcn": True, "radj": False, "lgcnssm": False, "mf": False, "textsage": True,
               "textsage_id": False, "sage": False, "fastsage": False, "lightsage": False, "pinsage": False,
               "mrec": False, "nssage": False, "gnn": False, "asage": False}


@pytest.mark.parametrize("key", sorted(_CAPTURABLE))
def test_models_declare_a_capturable_step(key):
    """lgn's construction (symmetric propagation, the BPR loss; rgcn is the
    same model) and textsage's (the sage_cat conv on feature tables alone)
    declare their step capturable; the others do not."""
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    if key in ("lgn", "rgcn", "radj", "lgcnssm", "mf"):
        cfg = Config(**_lgn_fields(model=key))
        model = build_model(key, cfg, td.graph)
    else:
        cfg = Config(**_flagship(model=key))
        model = build_model(key, cfg, td.graph, features=synthetic_features(td, cfg, seed=1))
    assert model.step_capturable is _CAPTURABLE[key]


class _Model:
    def __init__(self, capturable: bool):
        self.step_capturable = capturable


_MESH = object()  # any mesh: a configuration with one is never captured


@pytest.mark.parametrize("capturable,cadence,mesh,device,want", [
    (True, "fresh", None, "cuda", True),
    (True, "fresh", None, torch.device("cuda", 1), True),
    (True, "fresh", None, "cpu", False),
    (True, "fresh", None, torch.device("cpu"), False),
    (True, "fresh", _MESH, "cuda", False),
    (True, "relin", None, "cuda", False),
    (True, "super", None, "cuda", False),
    (True, "ooc", None, "cuda", False),
    (False, "fresh", None, "cuda", False),
    (False, "fresh", None, "cpu", False),
])
def test_the_rule_picks_the_captured_configurations(capturable, cadence, mesh, device, want):
    assert captured(_Model(capturable), cadence, mesh, device) is want


@pytest.mark.parametrize("key,kw", [
    ("lgn", {}),
    ("lgn", {"dropout": True, "keep_prob": 0.6}),
    ("textsage", {}),
    ("textsage", {"relin_every": 8}),
    ("textsage", {"relin_every": 0}),
    ("textsage", {"feature_update_every": 8}),
    ("mf", {}),
    ("rgcn", {}),
])
def test_the_cpu_trainer_runs_every_step_eagerly(key, kw):
    """No configuration is captured on the CPU: no step graph, torch's
    default Adam, and a fresh epoch is the ``train_step`` loop."""
    t = _trainer(key, **kw)
    assert not t.captured and t.step_graph is None
    assert not any(group["fused"] or group["capturable"] for group in t.optimizer.param_groups)
    calls = []
    step = t.train_step
    t.train_step = lambda *a, **k: calls.append(1) or step(*a, **k)
    assert np.isfinite(t.train_one_epoch())
    assert len(calls) == (t.num_batches if t.cadence == "fresh" else 0)


def test_the_graph_is_dropped_when_the_adam_states_are_replaced(tmp_path):
    t = _trainer("lgn")
    t.train_one_epoch()
    t.save(tmp_path / "a.ckpt")
    dropped = []
    t.step_graph = type("Graph", (), {"drop": lambda self: dropped.append(1)})()
    for n, replace in enumerate((t.init_state, lambda: t.restore(tmp_path / "a.ckpt")), start=1):
        replace()
        assert len(dropped) == n
