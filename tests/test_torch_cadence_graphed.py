"""Port vs JAX package: the cached cadences' steps as the card captures them
(``train/graphed.py::PARTS``: ``_linearize``, ``_cached_step``,
``_inner_step``, ``_outer_step`` on ``train/trainer.py::_CachedTables``),
run eagerly on the CPU with the fused Adam that a captured trainer takes
(``tests/test_torch_graphed.py::_fused_adam``: on the CPU fused, not
capturable), on ``tests/test_torch_cadence.py``'s inputs (the same
parameters, 8 batches and the JAX package's fanout trees, dropout 0, a
hub-free graph at float32):

- (R, T) at (0, 1), (3, 1), (1, 4) and (0, 4) against
  ``test_torch_cadence.py::jax_cadence``, and a ``dask`` epoch against
  ``test_torch_ooc.py::jax_ooc_epoch``: every step's loss and the final
  parameters within rtol 1e-4, atol 1e-6; the parts called in the cadence's
  order (one linearization a block, a super-step's end after its steps);
- two linearizations in a row, and two ``refresh_ooc_proj`` calls, leave
  every static tensor at its address (what a captured step reads where the
  captured linearization wrote it);
- under T > 1 both fused Adams round-trip through ``save`` / ``restore`` and
  the resumed run is bit-equal.

The card's replays of these parts are held against the eager parts in
``tests/test_torch_kernels.py`` (marked ``cuda``) and in ``chip_smoke.py``'s
phases 12 and 21.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data import ooc as jooc
from furusato_recommend_tpu.data.features import synthetic_features as jfeatures
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import flatten_params, params_from_jax, params_to_numpy
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data import ooc as tooc
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors
from furusato_recommend_tpu_torch.train import trainer as trainer_module
from furusato_recommend_tpu_torch.train.graphed import PARTS
from furusato_recommend_tpu_torch.train.trainer import Trainer

from test_torch_cadence import (  # noqa: F401  (env: the module's fixture)
    M_ITEMS, N_USERS, STEPS, TOL, _Jax, _assert_params, _batch, _kw, _port_trainer, env, jax_cadence,
)
from test_torch_graphed import _fused_adam
from test_torch_ooc import jax_ooc_epoch

torch.set_num_threads(1)


def _spy_parts(tr, monkeypatch) -> list:
    """The names of the cadence's parts in the order the trainer calls them."""
    calls = []
    for part in PARTS[tr.cadence]:
        fn = getattr(tr, part)
        monkeypatch.setattr(tr, part, lambda *a, _fn=fn, _part=part, **k: calls.append(_part) or _fn(*a, **k))
    return calls


def _want_parts(R: int, T: int, n: int) -> list:
    """The parts the JAX trainer's epoch of n steps at (R, T) maps onto."""
    if T == 1:
        span = R or n
        return [p for b in range(n) for p in (["_linearize"] if b % span == 0 else []) + ["_cached_step"]]
    out = []
    for s in range(0, n, T):
        out += (["_linearize"] if s == 0 or R else []) + ["_inner_step"] * T + ["_outer_step"]
    return out


def _fused(tr) -> bool:
    return all(g["fused"] for opt in (tr.optimizer, tr.opt_feat) if opt is not None for g in opt.param_groups)


@pytest.mark.parametrize("R,T", [(0, 1), (3, 1), (1, 4), (0, 4)])
def test_static_cadence_matches_jax_loop(env, R, T, monkeypatch):
    monkeypatch.setattr(trainer_module, "adam", _fused_adam)
    tr = _port_trainer(env, relin_every=R, feature_update_every=T)
    assert tr.cadence == ("relin" if T == 1 else "super") and _fused(tr)
    calls = _spy_parts(tr, monkeypatch)
    jb = [b for b, _ in env["batches"]]
    jp, jlosses, _ = jax_cadence(env["jax"], env["jp"], jb, env["jtrees"], R, T, tr.config.lr)
    losses = tr.train_epoch([b for _, b in env["batches"]], draws=env["ttrees"])
    assert calls == _want_parts(R, T, STEPS)
    np.testing.assert_allclose(losses.numpy(), jlosses, **TOL)
    _assert_params(tr.model, jp, f"R={R} T={T}")
    # the sums a super-step keeps are zero again at its end
    if T > 1:
        assert not any(bool(a.any()) for a in (*tr.cached.acc_t, *tr.cached.acc_p.values(), tr.cached.count))


@pytest.fixture(scope="module")
def ooc(tmp_path_factory):
    """``test_torch_ooc.py``'s dask inputs, its numeric matrices on disk, and
    the JAX side's jitted functions (built once for the module)."""
    tmp = tmp_path_factory.mktemp("ooc")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
        mp.setattr(jsage, "DROPOUT_RATE", 0.0)
        mp.setattr(tsage, "DROPOUT_RATE", 0.0)
        jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
        td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
        g = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, N_USERS, M_ITEMS,
                         hub_count=0, dst_hub_count=0)
        jd = dataclasses.replace(jd, _graph=g)
        kw = _kw(model="dask", user_feature="nctw", item_feature="nctw")
        jf, tf = jfeatures(jd, JConfig(**kw), seed=1), synthetic_features(td, Config(**kw), seed=1)
        jmm, tmm = {}, {}
        for side in ("user", "item"):
            tmm[side] = tooc.MemmapNumeric.write(str(tmp / f"{side}_numeric.npy"), getattr(tf, side).numeric.numpy())
            jmm[side] = jooc.MemmapNumeric(tmm[side].path)
        jf = dataclasses.replace(jf, user=dataclasses.replace(jf.user, numeric=None),
                                 item=dataclasses.replace(jf.item, numeric=None))
        tf = dataclasses.replace(tf, user=dataclasses.replace(tf.user, numeric=None),
                                 item=dataclasses.replace(tf.item, numeric=None))
        jm = jbuild_model("dask", JConfig(**kw), jd.graph, features=jf, ooc_numeric=jmm)
        batches = [_batch(td, seed=s) for s in range(STEPS)]
        jtrees, ttrees = [], []
        for s, (jb, _) in enumerate(batches):
            keys = jax.random.split(jax.random.PRNGKey(20 + s), 3)
            t = [jm.sample_seed_tree(jd.graph, x, side, k)
                 for (x, side), k in zip(((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item")), keys)]
            jtrees.append(t)
            ttrees.append({"trees": [[SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in tr]
                                     for tr in t]})

        def trainer():
            tm = build_model("dask", Config(**kw), td.graph, features=tf, ooc_numeric=tmm)
            params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
            return Trainer(Config(**kw), td, tm, device="cpu", logger=MetricLogger(quiet=True))

        jp = jm.init(jax.random.PRNGKey(0))
        yield dict(jm=jm, jp=jp, jmm=jmm, J=_Jax(jm, jd.graph, ooc=True), batches=batches, jtrees=jtrees,
                   ttrees=ttrees, trainer=trainer)


def test_static_dask_epoch_matches_jax_ooc_branch(ooc, monkeypatch):
    monkeypatch.setattr(trainer_module, "adam", _fused_adam)
    tr = ooc["trainer"]()
    assert tr.cadence == "ooc" and _fused(tr)
    calls = _spy_parts(tr, monkeypatch)
    jp, jlosses = jax_ooc_epoch(ooc["J"], ooc["jm"], ooc["jp"], [b for b, _ in ooc["batches"]], ooc["jtrees"],
                                tr.config.lr, ooc["jmm"])
    losses = tr.train_epoch([b for _, b in ooc["batches"]], draws=ooc["ttrees"])
    assert calls == _want_parts(0, 1, STEPS)
    np.testing.assert_allclose(losses.numpy(), jlosses, **TOL)
    got = flatten_params(params_to_numpy(tr.model))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    # the projections' sums are zero again after the epoch's update
    assert set(tr.cached.acc) == {"user", "item"} and not any(bool(a.any()) for a in tr.cached.acc.values())


def _addresses(tr) -> dict:
    """{name: data_ptr} of every tensor of the cadence's static state."""
    c = tr.cached
    out = {f"snap/{k}": v.data_ptr() for k, v in c.snap.items()}
    for i, leaf in enumerate(c.leaves):
        out[f"leaf/{i}"], out[f"leaf/{i}/grad"] = leaf.data_ptr(), leaf.grad.data_ptr()
    out.update({f"acc/{s}": a.data_ptr() for s, a in c.acc.items()})
    out.update({f"proj/{s}": x.data_ptr() for s, x in tr.model._ooc_proj.items()})
    out.update({f"input/{i}": x.data_ptr() for i, x in enumerate(c.inputs)})
    if c.acc_t is not None:
        out.update({f"acc_t/{i}": a.data_ptr() for i, a in enumerate(c.acc_t)})
        out.update({f"acc_p/{k}": a.data_ptr() for k, a in c.acc_p.items()})
        out["count"] = c.count.data_ptr()
    return out


@pytest.mark.parametrize("over", [{"relin_every": 3}, {"feature_update_every": 4}, "dask"])
def test_linearizations_keep_every_static_tensor_in_place(env, ooc, over):
    tr = ooc["trainer"]() if over == "dask" else _port_trainer(env, **over)
    for _ in range(2):
        tr.model.refresh_ooc_proj()
    tr._linearize()
    first = _addresses(tr)
    before = {k: v.detach().clone() for k, v in tr.cached.snap.items()}
    with torch.no_grad():  # new values, the same tensors
        for k, p in tr.model.named_parameters():
            if k in tr.cached.snap:
                p.add_(1.0)
    tr.model.refresh_ooc_proj()
    tr._linearize()
    assert _addresses(tr) == first
    assert len(first) >= 2 * len(tr.cached.leaves) + len(tr.feature_names) + 2 * len(tr.ooc)
    for k, v in tr.cached.snap.items():
        torch.testing.assert_close(v.detach(), before[k] + 1.0)
    # the leaves are the tables at the new snapshot
    for leaf, t in zip(tr.cached.leaves, tr.cached.tables):
        assert torch.equal(leaf.detach(), t.detach())


def test_super_step_fused_adams_checkpoint_round_trip(env, tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_module, "adam", _fused_adam)
    tb, trees = [b for _, b in env["batches"]], env["ttrees"]
    whole = _port_trainer(env, feature_update_every=2, path=str(tmp_path))
    assert _fused(whole)
    whole.train_epoch(tb[:4], draws=trees[:4])
    whole.save(tmp_path / "mid.ckpt")
    whole.train_epoch(tb[4:], draws=trees[4:])
    resumed = _port_trainer(env, feature_update_every=2, seed=5)
    resumed.restore(tmp_path / "mid.ckpt")
    assert _fused(resumed)
    for opt, steps in ((resumed.optimizer, 4), (resumed.opt_feat, 2)):  # opt_feat: one a super-step
        for p, st in opt.state.items():
            assert st["step"].dtype == torch.float32 and st["step"].device == p.device
            assert int(st["step"]) == steps
    resumed.train_epoch(tb[4:], draws=trees[4:])
    a, b = flatten_params(params_to_numpy(whole.model)), flatten_params(params_to_numpy(resumed.model))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for opt_a, opt_b in ((whole.optimizer, resumed.optimizer), (whole.opt_feat, resumed.opt_feat)):
        for pa, pb in zip(opt_a.param_groups[0]["params"], opt_b.param_groups[0]["params"]):
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(opt_a.state[pa][k], opt_b.state[pb][k]), k
