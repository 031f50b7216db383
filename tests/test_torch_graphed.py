"""What the CPU can check of the captured training step
(``train/graphed.py``); the CPU itself never captures and runs every step
eagerly through ``Trainer.train_step``, the plain version of the graph.

- the step the graph records (``Trainer.train_step``), fed the JAX package's
  batches (and, for the SAGE family, its fanout trees, asage's attribute
  trees beside them, dropout 0 in both), against ``jax.value_and_grad`` +
  ``optax.adam`` for 3 steps, under ``tests/test_torch_train.py``'s rules:
  float32 on a hub-free JAX graph, parameters within rtol 1e-5 / atol 1e-6,
  the moments within rtol 1e-4; with the CPU's Adam and with the fused Adam a
  captured configuration runs (built here on the CPU, where it cannot be
  capturable); lgn, textsage and one key of each family the card captures
  (mf, radj, lgcnssm, pinsage, nssage, tgrec, rsage, sasrec, asage);
- the fused Adam's state through the optax layout and back, and through
  ``save`` / ``restore``;
- ``tests/torch_oracle.py::OptaxAdam``, the float64 form of optax.adam's rule
  that the card's captured Adam is held against, against optax itself;
- that every registry key and every ``gnn --conv`` trains under the fresh
  cadence, which the rule captures on the card (``dask`` under its own, which
  it captures too), the rule that picks the captured configurations (every
  cadence, without a mesh, on CUDA), the CPU
  Trainer's eager steps and default Adam, and the graph dropped when the
  Adam states are replaced;
- that a step draws only from the trainer's generator, the one a graph
  registers: torch's default generator is left as it was, and two trainers
  from one seed take bit-equal steps whatever its state;
- that a step graph does not keep its trainer alive (its pool goes with the
  trainer).

The card's replays are held against the eager steps in
``tests/test_torch_kernels.py`` (marked ``cuda``) and in ``chip_smoke.py``'s
phase 21.
"""

import dataclasses
import gc
import weakref

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
from furusato_recommend_tpu.data import sequence as jseq
from furusato_recommend_tpu.models import asage as jasage
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models import sasrec as jsasrec
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu.sampling.neighbor import sample_neighbors as jsample_neighbors
from furusato_recommend_tpu_torch.config import Config, ddp_flagship_config
from furusato_recommend_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_numpy,
    flatten_params,
    params_from_jax,
    params_to_numpy,
)
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data import sequence as tseq
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.data.ooc import MemmapNumeric
from furusato_recommend_tpu_torch.models import asage as tasage
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models import sasrec as tsasrec
from furusato_recommend_tpu_torch.models.registry import SAGE_KEYS, available_models, build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors
from furusato_recommend_tpu_torch.train import trainer as trainer_module
from furusato_recommend_tpu_torch.train.graphed import PARTS, StepGraph, captured
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


_LGN_KEYS = ("lgn", "mf", "radj", "lgcnssm")  # the keys at lgn's recipe here


def _lgn_pair(key="lgn"):
    """(JAX model, its graph, Trainer, JAX parameters, lr) for lgn, mf or a
    LightGCN key at float32."""
    jd = _hub_free(jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2))
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    kw = _lgn_fields(model=key, bpr_batch_size=256)
    cfg = Config(**kw)
    jm = jbuild_model(key, JConfig(**kw), jd.graph)
    rng = np.random.default_rng(0)
    p = {"user_emb": (0.1 * rng.standard_normal((N_USERS, DIM))).astype(np.float32),
         "item_emb": (0.1 * rng.standard_normal((M_ITEMS, DIM))).astype(np.float32)}
    tm = build_model(key, cfg, td.graph)
    params_from_jax(p, tm)
    t = Trainer(cfg, td, tm, logger=MetricLogger(quiet=True), device="cpu")
    return jm, jd, t, jax.tree_util.tree_map(jnp.asarray, p), cfg.lr


# a SAGE-family key's config fields and JAX batch (rows, invalid rows) here
_SAGE_FIELDS = {"rsage": {"multi_relational": "sum"}, "sasrec": {"bpr_batch_size": 48}}


def _no_dropout(monkeypatch):
    """Dropout 0 in both packages: the SAGE family's, asage's bound copy and
    sasrec's."""
    for module in (jsage, tsage, jasage, tasage):
        monkeypatch.setattr(module, "DROPOUT_RATE", 0.0)
    monkeypatch.setattr(jsasrec, "DROPOUT", 0.0)
    monkeypatch.setattr(tsasrec, "DROPOUT", 0.0)


def _sage_pair(key, monkeypatch):
    """The same for a SAGE-family key at the flagship recipe (features n / c /
    t / w; rsage's relation labels and the edge times drawn with them; sasrec
    its item sequences), dropout 0; its trees (and asage's attribute trees)
    come from the JAX package and are handed to the port's loss."""
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
    _no_dropout(monkeypatch)
    jd = _hub_free(jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2))
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    kw = _flagship(model=key, user_feature="nctw", item_feature="nctw", lr=1e-3, **_SAGE_FIELDS.get(key, {}))
    edge = dict(with_edge_time=True, with_edge_label=True)
    jin = {"features": jfeatures(jd, JConfig(**kw), seed=1, **edge)}
    tin = {"features": synthetic_features(td, Config(**kw), seed=1, **edge)}
    np.testing.assert_array_equal(tin["features"].edge_label.numpy(), np.asarray(jin["features"].edge_label))
    if key == "sasrec":
        jin["sequences"], tin["sequences"] = jseq.build_sequences(jd), tseq.build_sequences(td)
    jm = jbuild_model(key, JConfig(**kw), jd.graph, **jin)
    tm = build_model(key, Config(**kw), td.graph, **tin)
    jp = jm.init(jax.random.PRNGKey(0))
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    t = Trainer(Config(**kw), td, tm, logger=MetricLogger(quiet=True), ddp_recipe=key != "sasrec", device="cpu")
    return jm, jd, t, jp, kw["lr"]


def _jax_attr_tree(jm, seeds, side, key):
    """The attribute tree JAX's ``ASAGE._encode_attr_tree`` draws from ``key``."""
    fwd, bwd = (jm.user_attr_fwd, jm.user_attr_bwd) if side == "user" else (jm.item_attr_fwd, jm.item_attr_bwd)
    out, frontier = [], seeds
    for level in range(jm.n_layers):
        key, k = jax.random.split(key)
        s = jsample_neighbors(k, fwd if level % 2 == 0 else bwd, frontier, jm.fanout)
        out.append(s)
        frontier = s.ids
    return out


def _jax_draws(key, jm, jd, jb, step):
    """(the JAX loss's key, its trees argument or None, the port's trees and
    attribute trees in the order its step samples them). The SAGE family's
    trees are sampled here and passed to JAX's loss; asage's loss draws its
    own from the key (the first three and the last three of its six keys),
    which are sampled here the same way; mf, the LightGCN keys, nssage and
    sasrec draw no trees."""
    jkey = jax.random.PRNGKey(0)
    if key in _LGN_KEYS or key in ("nssage", "sasrec"):
        return jkey, None, [], []
    seeds = ((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item"))
    if key == "asage":
        jkey = jax.random.PRNGKey(10 + step)
        k = jax.random.split(jkey, 6)
        trees = [jm.sample_seed_tree(jd.graph, s, side, kk) for (s, side), kk in zip(seeds, k[:3])]
        attr = [_jax_attr_tree(jm, s, side, kk) for (s, side), kk in zip(seeds, k[3:])]
        return jkey, None, _to_torch(trees), _to_torch(attr)
    keys = jax.random.split(jax.random.PRNGKey(10 + step), 3)
    trees = [jm.sample_seed_tree(jd.graph, s, side, k) for (s, side), k in zip(seeds, keys)]
    return jkey, trees, _to_torch(trees), []


def _to_torch(trees):
    return [[SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in tree] for tree in trees]


# the keys whose three steps hold the file's rule but for the elements
# ``_rounding`` picks, as tests/test_torch_edge.py, test_torch_attention.py,
# test_torch_sasrec.py and test_torch_asage.py hold these models' steps
_ROUNDING_KEYS = ("pinsage", "tgrec", "sasrec", "asage")


def _rounding(model, grads, rounding: dict) -> dict:
    """The port's gradients (on ``model``) held to JAX's ``grads`` at the
    same parameters under the gradient rule (rtol 1e-4, atol 1e-6 of the
    largest magnitude where it exceeds 1; a parameter the loss never reads
    has no gradient on either side); the elements where they differ by more
    than 1e-3 of JAX's magnitude (Adam's g / (sqrt(v) + 1e-8) turns that into
    more than 1e-3 x lr) added to ``rounding``."""
    want = flatten_params(jax.tree_util.tree_map(np.asarray, grads))
    for k, prm in model.named_parameters():
        w = want[k]
        g = np.zeros_like(w) if prm.grad is None else prm.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(w).max())), err_msg=k)
        rounding[k] = rounding.get(k, np.zeros(w.shape, bool)) | (np.abs(g - w) > 1e-3 * np.abs(w))
    return rounding


def _allclose_but(got, want, loose, rtol, atol, err_msg) -> None:
    """``got`` within rtol / atol (a number, or one an element) of ``want``
    but at the elements ``loose``."""
    atol = np.broadcast_to(atol, want.shape)[~loose]
    diff = np.abs(got[~loose] - want[~loose])
    assert (diff <= atol + rtol * np.abs(want[~loose])).all(), f"{err_msg}: off by {diff.max()}"


_JAX_STEPS = {}  # key -> (JAX model, its dataset, jitted value_and_grad of its loss)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("key", ["lgn", "textsage", "mf", "radj", "lgcnssm", "pinsage", "nssage", "tgrec", "rsage",
                                 "sasrec", "asage"])
def test_static_step_matches_jax_three_adam_steps(key, fused, monkeypatch):
    """Three ``train_step`` calls against the JAX package's, under the
    module's rules. ``_ROUNDING_KEYS`` begin each step from JAX's parameters
    and Adam state (``card_vs_cpu_epoch``'s way in ``chip_smoke.py``: a ReLU
    input within rounding of 0 may take the other side of the gate after a
    step, and Adam spreads that over the next steps); each step's gradients
    are held against JAX's under the gradient rule, and the elements whose
    port gradient differs from JAX's by more than 1e-3 of its magnitude are
    held within 2 lr instead (no more than 1 in 100 of them), their moments
    not compared; the other moments within the module's rule widened by what
    the gradient rule lets the last step's gradient add (0.1 x its tolerance
    to the first moment, 0.001 x (2 |g| + tol) x tol to the second)."""
    if fused:
        monkeypatch.setattr(trainer_module, "adam", _fused_adam)
    jm, jd, t, jp, lr = _lgn_pair(key) if key in _LGN_KEYS else _sage_pair(key, monkeypatch)
    assert all(bool(group["fused"]) is fused for group in t.optimizer.param_groups)
    td = t.dataset
    opt = optax.adam(lr)
    state = opt.init(jp)
    fed, fed_attr = [], []  # the JAX trees the port's loss takes in place of its own draws
    monkeypatch.setattr(t.model, "sample_seed_tree", lambda *a, **k: fed.pop(0), raising=False)
    monkeypatch.setattr(t.model, "sample_attr_tree", lambda *a, **k: fed_attr.pop(0), raising=False)
    # compiled once for the key's cases (trees None but for the sampled SAGE
    # keys); its JAX model gives the same parameters at every build
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jm, jd, jax.jit(jax.value_and_grad(
            lambda q, b, k, trees: jm.loss(q, jd.graph, b, k, **({} if trees is None else {"trees": trees})),
            has_aux=True))
    jm, jd, value_and_grad = _JAX_STEPS[key]
    b, n_invalid = (256, 16) if key in _LGN_KEYS else (48, 4)
    held, rounding = key in _ROUNDING_KEYS, {}
    for step in range(3):
        jb, tb = _jax_batch(td, step, b, n_invalid)
        jkey, trees, fed[:], fed_attr[:] = _jax_draws(key, jm, jd, jb, step)
        if held and step:  # the step begins from JAX's state
            params_from_jax(jax.tree_util.tree_map(np.asarray, jp), t.model)
            adam = jax.tree_util.tree_map(np.asarray, state[0])
            adam_state_from_jax(int(adam.count), adam.mu, adam.nu, t.optimizer, t.model)
        (jl, _), g = value_and_grad(jp, jb, jkey, trees)
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        loss = t.train_step(tb)
        assert not fed and not fed_attr  # every tree was read
        if held:
            rounding = _rounding(t.model, g, {})
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
        got = flatten_params(params_to_numpy(t.model))
        want = flatten_params(jax.tree_util.tree_map(np.asarray, jp))
        assert sum(int(m.sum()) for m in rounding.values()) <= 1e-2 * sum(v.size for v in want.values())
        for k in want:
            loose = rounding.get(k, np.zeros(want[k].shape, bool))
            _allclose_but(got[k], want[k], loose, 1e-5, 1e-6, f"step {step}: {k}")
            assert (np.abs(got[k] - want[k])[loose] <= 2 * lr).all(), f"step {step}: {k}"
    count, mu, nu = adam_state_to_numpy(t.optimizer, t.model)
    assert count == int(state[0].count) == 3
    want_mu = flatten_params(jax.tree_util.tree_map(np.asarray, state[0].mu))
    want_nu = flatten_params(jax.tree_util.tree_map(np.asarray, state[0].nu))
    last = flatten_params(jax.tree_util.tree_map(np.asarray, g))
    for k, v in flatten_params(mu).items():
        loose = rounding.get(k, np.zeros(v.shape, bool))
        w = np.abs(last[k])
        tol = (1e-4 * w + 1e-6 * max(1.0, float(w.max()))) if held else np.zeros_like(w)
        _allclose_but(v, want_mu[k], loose, 1e-4, 1e-9 + 0.1 * tol, k)
        _allclose_but(flatten_params(nu)[k], want_nu[k], loose, 1e-4, 1e-12 + 1e-3 * (2 * w + tol) * tol, k)


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


def _key_trainer(key: str, tmp_path=None, **kw) -> Trainer:
    """A Trainer on the CPU for any registry key at this module's size: mf
    and the LightGCN keys at lgn's recipe (edge dropout on), sasrec with its
    item sequences, every other key at the flagship recipe (features n / c /
    t / w, the edge times and relation labels drawn with them; dask with its
    numeric matrices on disk under ``tmp_path``)."""
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    if key not in SAGE_KEYS:
        cfg = Config(**_lgn_fields(model=key, dropout=True, keep_prob=0.7, **kw))
        return Trainer(cfg, td, build_model(key, cfg, td.graph), logger=MetricLogger(quiet=True), device="cpu")
    cfg = Config(**_flagship(model=key, user_feature="nctw", item_feature="nctw", **kw))
    fs = synthetic_features(td, cfg, seed=1, with_edge_time=True, with_edge_label=True)
    inputs = {}
    if key == "sasrec":
        inputs["sequences"] = tseq.build_sequences(td)
    if key == "dask":
        inputs["ooc_numeric"] = {side: MemmapNumeric.write(str(tmp_path / f"{side}.npy"), getattr(fs, side).numeric.numpy())
                                 for side in ("user", "item")}
        fs = dataclasses.replace(fs, user=dataclasses.replace(fs.user, numeric=None),
                                 item=dataclasses.replace(fs.item, numeric=None))
    model = build_model(key, cfg, td.graph, features=fs, **inputs)
    return Trainer(cfg, td, model, logger=MetricLogger(quiet=True), ddp_recipe=key != "sasrec", device="cpu")


# every registry key but gnn (cases of its own) and dask (not captured), with
# the config fields that pick rsage's combine; then gnn under every --conv
# (gcn, the default, as plain gnn)
_CONFIGS = ([(key, {}) for key in available_models() if key not in ("gnn", "rsage", "dask")]
            + [("rsage", {"multi_relational": mode}) for mode in ("add", "sum", "prod")]
            + [("gnn", {})] + [("gnn", {"conv": conv}) for conv in ("sage", "gat", "transformer", "ggnn", "mean",
                                                                     "light")])
_IDS = [key + "".join(f"-{v}" for v in over.values()) for key, over in _CONFIGS]


@pytest.mark.parametrize("key,over", _CONFIGS + [("dask", {})], ids=_IDS + ["dask"])
def test_every_fresh_key_is_captured_on_the_card(key, over, tmp_path):
    """Every registry key and every gnn --conv trains under the fresh
    cadence by default, which the rule captures on a CUDA device (mf, the
    LightGCN family, the SAGE family with all its convs, heads and losses,
    sasrec and asage); dask, whose numeric projections stream from the host,
    trains under its own cadence, which the rule captures too (the streamed
    passes stay eager, ``train/graphed.py``)."""
    t = _key_trainer(key, tmp_path, **over)
    assert t.cadence == ("ooc" if key == "dask" else "fresh")
    assert captured(None, "cuda") is True
    assert not t.captured and t.step_graph is None

@pytest.mark.parametrize("key,over", _CONFIGS, ids=_IDS)
def test_a_step_draws_only_from_the_trainers_generator(key, over):
    """A ``train_step`` (dropout and edge dropout on, the trees drawn) leaves
    torch's default generator as it was, and two trainers from one seed take
    bit-equal steps whatever its state: a replay reproduces the draws of the
    generator it registers, and of no other."""
    a, b = _key_trainer(key, **over), _key_trainer(key, **over)
    bs = a.config.bpr_batch_size
    batch = a.sample_epoch().slice(0, bs)
    b.generator.set_state(a.generator.get_state())
    torch.manual_seed(0)
    before = torch.random.get_rng_state()
    loss_a = a.train_step(batch)
    assert torch.equal(torch.random.get_rng_state(), before)
    torch.manual_seed(1)
    loss_b = b.train_step(batch)
    assert torch.equal(loss_a, loss_b)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for (k, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), k


def test_a_step_graph_does_not_keep_its_trainer():
    """The trainer holds its step graph, and the graph holds the trainer by a
    weak reference: dropping the trainer frees both (and, on the card, the
    graph's memory pool) without waiting for the cycle collector."""
    t = _trainer("lgn")
    t.step_graph = StepGraph(t)
    assert t.step_graph.trainer.device == t.device
    dead = weakref.ref(t)
    gc.disable()
    try:
        del t
        assert dead() is None
    finally:
        gc.enable()


_MESH = object()  # any mesh: its steps are captured in parts on a CUDA device


@pytest.mark.parametrize("cadence,mesh,device,want", [
    ("fresh", None, "cuda", True),
    ("fresh", None, "cuda:0", True),
    ("fresh", None, torch.device("cuda", 1), True),
    ("fresh", None, "cpu", False),
    ("fresh", None, torch.device("cpu"), False),
    ("fresh", _MESH, "cuda", True),
    ("relin", None, "cuda", True),
    ("super", None, "cuda", True),
    ("ooc", None, "cuda", True),
    ("relin", _MESH, "cpu", False),
    ("relin", None, "cpu", False),
    ("super", _MESH, "cuda", True),
    ("ooc", _MESH, "cuda", True),
])
def test_the_rule_picks_the_captured_configurations(cadence, mesh, device, want):
    """Every cadence is captured alike, with or without a mesh (whose
    collectives run between the captured parts): the rule reads the device,
    and under a mesh whether the loss gathers over data
    (``tests/test_torch_mesh_graphed.py``)."""
    assert cadence in PARTS
    assert captured(mesh, device) is want


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
