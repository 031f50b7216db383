"""Port vs JAX package: training the TextSAGE flagship (``train/trainer.py``
with ``ddp_recipe``, ``cli.py``).

- ``Trainer(ddp_recipe=True)``: the JAX ``Trainer``'s epoch size, evaluation
  truncation and alias tables (bit-equal), built and never run;
- three Adam steps of ``textsage`` at the flagship's lr 1e-3, fed batches and
  fanout trees sampled by the JAX package, dropout 0 in both: parameters
  within rtol 1e-4, atol 1e-6 of ``jax.value_and_grad`` + ``optax.adam``
  (Adam divides by the root of the second moment, so an element whose
  gradient is within rounding of 0 moves by up to lr either way), the first
  moments within rtol 1e-3;
- a run saved and restored mid-way ends bit-equal to an uninterrupted one;
- the CLI trains ``textsage`` with ``--ddp_recipe`` on the CPU from feature
  artifacts written by ``python -m furusato_recommend_tpu_torch.data.artifacts``,
  and the server loads
  its checkpoint.
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
    adam_state_to_numpy,
    flatten_params,
    params_from_jax,
    params_to_numpy,
)
from furusato_recommend_tpu_torch.data import artifacts
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 100, 140, 16


def _flagship(**kw) -> dict:
    """The ddp flagship recipe's fields, cut to the test's size."""
    cfg = dataclasses.asdict(ddp_flagship_config())
    cfg.update(latent_dim=DIM, num_neighbors=3, bpr_batch_size=64, eval_user_batch=32, topks=(5, 10),
               test_count=2, compute_dtype="float32", decay=1e-2)
    cfg.pop("mesh")
    cfg.update(kw)
    return cfg


def _datasets():
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    return jd, td


@pytest.mark.parametrize("bs,ddp,sample_pow", [(64, True, 0.0), (5000, True, 0.0), (64, False, 0.5)])
def test_trainer_recipe_matches_jax_trainer(bs, ddp, sample_pow):
    from furusato_recommend_tpu.train.trainer import Trainer as JTrainer

    jd, td = _datasets()
    kw = _flagship(bpr_batch_size=bs, sample_pow=sample_pow)
    jf, tf = jfeatures(jd, JConfig(**kw), seed=1), synthetic_features(td, Config(**kw), seed=1)
    jt = JTrainer(JConfig(**kw), jd, jbuild_model("textsage", JConfig(**kw), jd.graph, features=jf),
                  ddp_recipe=ddp)
    tt = Trainer(Config(**kw), td, build_model("textsage", Config(**kw), td.graph, features=tf),
                 ddp_recipe=ddp, device="cpu", logger=MetricLogger(quiet=True))
    assert (tt.num_batches, tt.samples_per_epoch) == (jt.num_batches, jt.samples_per_epoch)
    assert tt.samples_per_epoch >= (3 if ddp else 1) * td.train_size
    np.testing.assert_array_equal(tt.eval_data.users.numpy(), np.asarray(jt.eval_data.users))
    np.testing.assert_array_equal(tt.eval_data.valid.numpy(), np.asarray(jt.eval_data.valid))
    if ddp:
        assert tt.eval_data.users.shape == (2, 32)  # test_count tiles of eval_user_batch users
    for name in ("edge_alias", "neg_alias"):
        got, want = getattr(tt, name), getattr(jt, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))
            np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))


def _batch(td, seed, b=48):
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(0, N_USERS, b)
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, b)
    valid = np.ones(b, dtype=bool)
    valid[-4:] = False
    arrs = [a.astype(np.int32) for a in (user, pos, neg)] + [valid]
    return JBatch(*(jnp.asarray(a) for a in arrs)), BPRBatch(*(torch.from_numpy(a) for a in arrs))


def test_three_adam_steps_match_optax(monkeypatch):
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
    monkeypatch.setattr(jsage, "DROPOUT_RATE", 0.0)
    monkeypatch.setattr(tsage, "DROPOUT_RATE", 0.0)
    jd, td = _datasets()
    g = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, N_USERS, M_ITEMS,
                     hub_count=0, dst_hub_count=0)
    jd = dataclasses.replace(jd, _graph=g)
    kw = _flagship(user_feature="nctw", item_feature="nctw")
    jm = jbuild_model("textsage", JConfig(**kw), jd.graph, features=jfeatures(jd, JConfig(**kw), seed=1))
    tm = build_model("textsage", Config(**kw), td.graph, features=synthetic_features(td, Config(**kw), seed=1))
    jp = jm.init(jax.random.PRNGKey(0))
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    lr = kw["lr"]  # the flagship's 1e-3
    opt = optax.adam(lr)
    state = opt.init(jp)
    topt = torch.optim.Adam(tm.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for step in range(3):
        jb, tb = _batch(td, seed=step)
        keys = jax.random.split(jax.random.PRNGKey(10 + step), 3)
        jtrees = [jm.sample_seed_tree(jd.graph, s, side, k)
                  for (s, side), k in zip(((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item")), keys)]
        (_, _), grads = jax.value_and_grad(
            lambda q: jm.loss(q, jd.graph, jb, jax.random.PRNGKey(0), trees=jtrees), has_aux=True
        )(jp)
        upd, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        ttrees = [[SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in t] for t in jtrees]
        topt.zero_grad()
        tm.loss(td.graph, tb, trees=ttrees)[0].backward()
        topt.step()
        got = flatten_params(params_to_numpy(tm))
        want = flatten_params(jax.tree_util.tree_map(np.asarray, jp))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=f"step {step}: {k}")
    count, mu, _ = adam_state_to_numpy(topt, tm)
    assert count == int(state[0].count) == 3
    want_mu = flatten_params(jax.tree_util.tree_map(np.asarray, state[0].mu))
    for k, v in flatten_params(mu).items():
        np.testing.assert_allclose(v, want_mu[k], rtol=1e-3, atol=1e-7, err_msg=k)


def _trainer(tmp_path, seed=3):
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    cfg = Config(**_flagship(bpr_batch_size=256, lr=1e-2, test_span=1, path=str(tmp_path), seed=seed))
    model = build_model("textsage", cfg, td.graph, features=synthetic_features(td, cfg, seed=1))
    logger = MetricLogger(jsonl_path=tmp_path / "metrics.jsonl", quiet=True)
    return Trainer(cfg, td, model, logger=logger, ddp_recipe=True, device="cpu")


def test_flagship_fit_learns_and_resumes_bit_equal(tmp_path):
    whole = _trainer(tmp_path / "a")
    whole.init_state()
    first = whole.test()
    last = whole.fit(epochs=3)
    assert last["recall@10"] > first["recall@10"]
    part = _trainer(tmp_path / "b")
    part.fit(epochs=1)
    part.save(tmp_path / "mid.ckpt")
    resumed = _trainer(tmp_path / "c", seed=99)  # the checkpoint's state wins
    resumed.restore(tmp_path / "mid.ckpt")
    assert resumed.step == 1 and resumed.max_recall == part.max_recall
    resumed.fit(epochs=3, resume=True)
    a = flatten_params(params_to_numpy(whole.model))
    b = flatten_params(params_to_numpy(resumed.model))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_trainer_raises_on_the_next_slice(tmp_path):
    """Every cadence of the cached tables constructs (this slice ported them);
    what the JAX trainer refuses raises ValueError as there; the
    edge-feature convs still belong to the next SAGE slice."""
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    base = Config(**_flagship())
    fs = synthetic_features(td, base, seed=1)
    for cfg, name, cadence in ((base.replace(relin_every=2), "textsage", "relin"),
                               (base.replace(relin_every=0), "textsage", "relin"),
                               (base.replace(feature_update_every=4), "textsage", "super"),
                               # relin_every is the cached-tables cadence: nssage and train_emb have none
                               (base.replace(relin_every=2), "nssage", "fresh"),
                               (base.replace(relin_every=2, train_emb=True), "textsage", "fresh")):
        t = Trainer(cfg, td, build_model(name, cfg, td.graph, features=fs), device="cpu",
                    logger=MetricLogger(quiet=True))
        assert t.cadence == cadence, (cfg.relin_every, cfg.feature_update_every, name)
    for cfg, name, match in ((base.replace(relin_every=-1), "textsage", "relin_every"),
                             (base.replace(feature_update_every=4, train_emb=True), "textsage", "cached"),
                             (base.replace(feature_update_every=4), "nssage", "cached")):
        with pytest.raises(ValueError, match=match):
            Trainer(cfg, td, build_model(name, cfg, td.graph, features=fs), device="cpu")


def test_cli_trains_textsage_ddp_and_serves_its_checkpoint(tmp_path):
    from furusato_recommend_tpu_torch.cli import main
    from furusato_recommend_tpu_torch.serve import Recommender

    rng = np.random.default_rng(0)
    data = tmp_path / "data" / "cf"
    data.mkdir(parents=True)
    with open(data / "train.txt", "w") as f, open(data / "test.txt", "w") as g:
        for u in range(60):
            items = rng.choice(80, size=rng.integers(6, 12), replace=False)
            f.write(f"{u} " + " ".join(map(str, items[:-2])) + "\n")
            g.write(f"{u} " + " ".join(map(str, items[-2:])) + "\n")
    artifacts.main(["--data_path", str(tmp_path / "data"), "--seed", "1"])
    main([
        "--model", "textsage", "--ddp_recipe", "--recdim", "8", "--bpr_batch", "256", "--lr", "0.01",
        "--epochs", "2", "--test_span", "1", "--topks", "[5,10]", "--testbatch", "32",
        "--user_feature", "ncwtb", "--item_feature", "ncwtsrb",
        "--data_path", str(tmp_path / "data"), "--path", str(tmp_path / "ck"), "--device", "cpu",
    ])
    assert (tmp_path / "ck" / "textsage" / "metrics.jsonl").exists()
    (ckpt,) = (tmp_path / "ck" / "textsage").glob("*.ckpt")
    rec = Recommender.from_checkpoint(str(ckpt), device="cpu")
    ids, scores = rec.recommend([0, 7], k=5)
    assert ids.shape == (2, 5) and np.isfinite(scores).all()
