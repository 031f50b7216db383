"""Port vs JAX package: the training path of the MF / LightGCN family.

- loss, its bpr / reg parts and the parameter gradients against
  ``jax.value_and_grad(model.loss)`` on identical parameters and an identical
  ``BPRBatch`` made with numpy: float32 on a hub-free JAX graph (only the
  summation order differs: rtol 1e-5, atol 1e-6; gradients rtol 1e-4,
  atol 1e-7, since they sum many products of small terms), and the bfloat16
  default (rtol 2e-2, atol 2e-3 on the loss; gradients atol 5e-5);
- three Adam steps against ``optax.adam`` (rtol 1e-5, atol 1e-6);
- the epoch's size against the JAX ``Trainer``'s (built, never run);
- save / restore: a resumed run ends on the same parameters as an
  uninterrupted one, bit for bit.
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
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.ops import segment
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM, B = 100, 120, 16, 256


def _datasets(hub_free):
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    if hub_free:
        g = jbuild_graph(
            jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
            hub_count=0, dst_hub_count=0,
        )
        jd = dataclasses.replace(jd, _graph=g)
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    return jd, td


def _params(name, seed=0):
    rng = np.random.default_rng(seed)
    std = 1.0 if name == "mf" else 0.1
    return {
        "user_emb": (std * rng.standard_normal((N_USERS, DIM))).astype(np.float32),
        "item_emb": (std * rng.standard_normal((M_ITEMS, DIM))).astype(np.float32),
    }


def _batch(td, seed=0):
    """A BPR batch from numpy: users uniform (some without train items would
    be invalid: the last 16 rows are marked invalid), a positive from the row,
    a random negative."""
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(0, N_USERS, B)
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, B)
    valid = np.ones(B, dtype=bool)
    valid[-16:] = False
    arrs = [a.astype(np.int32) for a in (user, pos, neg)] + [valid]
    jb = JBatch(*(jnp.asarray(a) for a in arrs))
    tb = BPRBatch(*(torch.from_numpy(a) for a in arrs))
    return jb, tb


def _both(name, compute_dtype, **cfg):
    jd, td = _datasets(compute_dtype == "float32")
    kw = dict(model=name, latent_dim=DIM, n_layers=2, compute_dtype=compute_dtype, decay=1e-2, **cfg)
    jm = jbuild_model(name, JConfig(**kw), jd.graph)
    tm = build_model(name, Config(**kw), td.graph)
    p = _params(name)
    params_from_jax(p, tm)
    return jd, td, jm, tm, p


@pytest.mark.parametrize(
    "name,compute_dtype,cfg",
    [
        ("mf", "float32", {}),
        ("lgn", "float32", {}),
        ("lgcnssm", "float32", {}),  # loss_mode="softmax"
        ("radj", "float32", {"r": 0.3}),  # asymmetric A: the backward uses A^T
        ("mf", "float32", {"loss_fn": "infonce"}),
        ("lgn", "bfloat16", {}),
        ("mf", "bfloat16", {}),
    ],
)
def test_loss_and_grads_match_jax(name, compute_dtype, cfg):
    jd, td, jm, tm, p = _both(name, compute_dtype, **cfg)
    jb, tb = _batch(td)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    (jl, jaux), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jd.graph, jb, jax.random.PRNGKey(0))
    tl, taux = tm.loss(td.graph, tb)
    tl.backward()
    exact = compute_dtype == "float32"
    rtol, atol = (1e-5, 1e-6) if exact else (2e-2, 2e-3)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=rtol, atol=atol)
    for k in ("bpr", "reg"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=rtol, atol=atol)
    g_rtol, g_atol = (1e-4, 1e-7) if exact else (2e-2, 5e-5)
    for k in ("user_emb", "item_emb"):
        got = getattr(tm, k).grad.numpy()
        np.testing.assert_allclose(got, np.asarray(jg[k]), rtol=g_rtol, atol=g_atol)


def test_l2_params_matches_jax():
    from furusato_recommend_tpu.models.base import l2_params as jl2
    from furusato_recommend_tpu_torch.models.base import l2_params

    p = _params("lgn", seed=3)
    p["step"] = np.arange(4, dtype=np.int32)  # integer leaves do not count
    want = float(jl2(jax.tree_util.tree_map(jnp.asarray, p)))
    got = float(l2_params(torch.from_numpy(v) for v in p.values()))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_edge_dropout_keep_one_is_identity_and_scales_kept_edges():
    jd, td, jm, tm, p = _both("lgn", "float32")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        base = tm.propagate(td.graph)
        tm.config = tm.config.replace(dropout=True, keep_prob=1.0)
        same = tm.propagate(td.graph, gen)
        tm.config = tm.config.replace(keep_prob=0.5)
        dropped = tm.propagate(td.graph, gen)
        eval_path = tm.propagate(td.graph)  # no generator: no dropout
    for a, b in zip(base, same):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    for a, b in zip(base, eval_path):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.allclose(base[0].numpy(), dropped[0].numpy())
    # kept edges carry weight / keep: the mean propagated row keeps its scale
    ratio = dropped[1].abs().mean() / base[1].abs().mean()
    assert 0.7 < float(ratio) < 1.5


def test_adjacency_is_built_once_per_graph(monkeypatch):
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    built = []
    real = segment.Adjacency.__init__

    def counting(self, *a, **kw):
        built.append(1)
        real(self, *a, **kw)

    monkeypatch.setattr(segment.Adjacency, "__init__", counting)
    tm = build_model("lgn", Config(latent_dim=DIM), td.graph)
    assert len(built) == 1  # at construction
    with torch.no_grad():
        first = tm.propagate(td.graph)
        again = tm.propagate(td.graph)
    assert len(built) == 1
    np.testing.assert_array_equal(first[0].numpy(), again[0].numpy())
    other = td.graph.to("cpu")  # another graph object: built once more, then kept
    with torch.no_grad():
        tm.propagate(other)
        tm.propagate(other)
    assert len(built) == 2


def test_three_adam_steps_match_optax():
    jd, td, jm, tm, p = _both("lgn", "float32")
    lr = 1e-2
    opt = optax.adam(lr)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    state = opt.init(jp)
    topt = torch.optim.Adam(tm.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for step in range(3):
        jb, tb = _batch(td, seed=step)
        (_, _), g = jax.value_and_grad(jm.loss, has_aux=True)(jp, jd.graph, jb, jax.random.PRNGKey(0))
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        tm.loss(td.graph, tb)[0].backward()
        topt.step()
        got = params_to_numpy(tm)
        for k in jp:
            np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-5, atol=1e-6)
    # the moments carry across: optax state -> torch -> one more step on both
    count, mu, nu = adam_state_to_numpy(topt, tm)
    adam = state[0]
    assert count == int(adam.count) == 3
    for k in mu:
        np.testing.assert_allclose(mu[k], np.asarray(adam.mu[k]), rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(nu[k], np.asarray(adam.nu[k]), rtol=1e-4, atol=1e-12)
    fresh = build_model("lgn", tm.config, td.graph)
    params_from_jax({k: np.asarray(v) for k, v in jp.items()}, fresh)
    fopt = torch.optim.Adam(fresh.parameters(), lr=lr)
    adam_state_from_jax(
        int(adam.count),
        {k: np.asarray(v) for k, v in adam.mu.items()},
        {k: np.asarray(v) for k, v in adam.nu.items()},
        fopt,
        fresh,
    )
    jb, tb = _batch(td, seed=3)
    (_, _), g = jax.value_and_grad(jm.loss, has_aux=True)(jp, jd.graph, jb, jax.random.PRNGKey(0))
    upd, state = opt.update(g, state, jp)
    jp = optax.apply_updates(jp, upd)
    fresh.loss(td.graph, tb)[0].backward()
    fopt.step()
    got = params_to_numpy(fresh)
    for k in jp:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bs", [64, 256, 1000, 5000])
def test_samples_per_epoch_matches_jax_trainer(bs):
    from furusato_recommend_tpu.train.trainer import Trainer as JTrainer

    jd, td = _datasets(False)
    kw = dict(model="lgn", latent_dim=DIM, bpr_batch_size=bs, eval_user_batch=64, test_mode=True)
    jt = JTrainer(JConfig(**kw), jd, jbuild_model("lgn", JConfig(**kw), jd.graph))
    tt = Trainer(Config(**kw), td, build_model("lgn", Config(**kw), td.graph), device="cpu")
    assert (tt.num_batches, tt.samples_per_epoch) == (jt.num_batches, jt.samples_per_epoch)


def _trainer(tmp_path, dropout):
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    cfg = Config(
        model="lgn", latent_dim=DIM, n_layers=2, bpr_batch_size=128, lr=1e-2, eval_user_batch=32,
        topks=(5, 10), test_span=2, compute_dtype="float32", path=str(tmp_path), dropout=dropout,
        seed=11,
    )
    logger = MetricLogger(jsonl_path=tmp_path / "metrics.jsonl", quiet=True)
    return Trainer(cfg, td, build_model("lgn", cfg, td.graph), logger=logger, device="cpu")


@pytest.mark.parametrize("dropout", [False, True])
def test_fit_resumes_to_the_same_parameters(tmp_path, dropout):
    whole = _trainer(tmp_path / "a", dropout)
    first = whole.fit(epochs=4)
    assert first["recall@10"] > 0
    part = _trainer(tmp_path / "b", dropout)
    part.fit(epochs=2)
    part.save(tmp_path / "mid.ckpt")
    resumed = _trainer(tmp_path / "c", dropout)
    resumed.restore(tmp_path / "mid.ckpt")
    assert resumed.step == 2 and resumed.max_recall == part.max_recall
    resumed.fit(epochs=4, resume=True)
    a, b = params_to_numpy(whole.model), params_to_numpy(resumed.model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    lines = (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()
    assert any('"loss"' in line for line in lines)
    assert (tmp_path / "a" / "lgn").is_dir()  # the best-recall checkpoint


def test_trainer_raises_on_what_is_not_ported(tmp_path):
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=2)
    cfg = Config(latent_dim=DIM)
    m = build_model("lgn", cfg, td.graph)
    # a mesh is ported, and needs its world of processes (tests/test_torch_distributed.py)
    with pytest.raises(RuntimeError, match="needs a world of 2 processes"):
        Trainer(cfg.replace(mesh=dataclasses.replace(cfg.mesh, data=2)), td, m, device="cpu")
    with pytest.raises(ValueError, match="SAGE-family"):  # as the JAX trainer
        Trainer(cfg.replace(feature_update_every=2), td, m, device="cpu")
    # the weighted recipes are ported: lgn takes them as the JAX trainer does
    t = Trainer(cfg, td, m, ddp_recipe=True, device="cpu")
    assert t.edge_alias.n == td.train_size and t.neg_alias.n == td.m_items
    assert Trainer(cfg.replace(sample_pow=0.5), td, m, device="cpu").neg_alias is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, td, m)


def test_cli_trains_on_the_cpu(tmp_path):
    from furusato_recommend_tpu_torch.cli import main

    rng = np.random.default_rng(0)
    data = tmp_path / "data" / "cf"
    data.mkdir(parents=True)
    with open(data / "train.txt", "w") as f, open(data / "test.txt", "w") as g:
        for u in range(60):
            items = rng.choice(80, size=rng.integers(6, 12), replace=False)
            f.write(f"{u} " + " ".join(map(str, items[:-2])) + "\n")
            g.write(f"{u} " + " ".join(map(str, items[-2:])) + "\n")
    main([
        "--model", "mf", "--recdim", "8", "--bpr_batch", "128", "--lr", "0.05",
        "--epochs", "2", "--test_span", "1", "--topks", "[5,10]", "--testbatch", "32",
        "--data_path", str(tmp_path / "data"), "--path", str(tmp_path / "ck"), "--device", "cpu",
    ])
    assert (tmp_path / "ck" / "mf" / "metrics.jsonl").exists()
