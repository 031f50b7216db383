"""Port vs JAX package: the production tier on the CPU — the result CSVs
(``eval/results.py``), ``production_inference`` (``eval/inference.py``),
``Dataset.from_reference_pickles``, ``tools evaluate / infer / recommend``
from a checkpoint, ``tools/export_jax_checkpoint.py`` and the CLI's logging
sinks.

Tolerances:

- the CSVs: byte-equal, on exact inputs (parameters that are multiples of
  1/8, the float32 contract: a hub-free JAX graph, ``compute_dtype="float32"``
  and the JAX text hub off);
- Gaussian parameters: the predicted ids equal wherever neighbouring scores
  differ by more than 1e-5 relative, the multiset of scores (rtol 1e-5,
  atol 1e-6) elsewhere;
- ``tools evaluate``: every metric within 1e-6 of JAX's.

JAX checkpoints come from ``model.init`` (or set parameters) and
``optax.adam``'s state after two updates, through the JAX package's
``save_checkpoint``; no JAX epoch program is built.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from furusato_recommend_tpu import tools as jtools
from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.core.checkpoint import save_checkpoint as jsave_checkpoint
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data.features import synthetic_features as jfeatures
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.eval import inference as jinference
from furusato_recommend_tpu.eval import results as jresults
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu_torch import cli as tcli
from furusato_recommend_tpu_torch import tools as ttools
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.eval import inference as tinference
from furusato_recommend_tpu_torch.eval import results as tresults
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.ops.streaming_topk import MASK_SENTINEL
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_USERS, M_ITEMS, DIM, K = 60, 40, 16, 10
RTOL, ATOL, TIE_RTOL = 1e-5, 1e-6, 1e-5


def _export_module():
    spec = importlib.util.spec_from_file_location("export_jax_checkpoint", ROOT / "tools" / "export_jax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _coo():
    """(train u, i, test u, i): user 0 holds every item but 4 in train (more
    than M - K, so masked items rank at -1024), user 1 has no test items."""
    base = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=6, seed=3)
    tru, tri, teu, tei = base.train_user, base.train_item, base.test_user, base.test_item
    test0 = tei[teu == 0]
    heavy = np.setdiff1d(np.arange(M_ITEMS), test0)[: M_ITEMS - 4]
    keep = tru != 0
    tru = np.concatenate([np.zeros(len(heavy), np.int64), tru[keep]])
    tri = np.concatenate([heavy, tri[keep]])
    keep = teu != 1
    return tru, tri, teu[keep], tei[keep]


@pytest.fixture(scope="module")
def sets():
    """(JAX dataset with hub-free train and inference graphs, the port's):
    the inference edge set is train + test, as for suffix "all"."""
    tru, tri, teu, tei = _coo()
    kw = dict(n_users=N_USERS, m_items=M_ITEMS, inference_user=np.concatenate([tru, teu]),
              inference_item=np.concatenate([tri, tei]))
    jd = jds.Dataset.from_interactions(tru, tri, teu, tei, **kw)
    g = jbuild_graph(tru, tri, teu, tei, N_USERS, M_ITEMS, hub_count=0, dst_hub_count=0)
    gi = jbuild_graph(jd.inference_user, jd.inference_item, teu, tei, N_USERS, M_ITEMS,
                      hub_count=0, dst_hub_count=0)
    jd = dataclasses.replace(jd, _graph=g, _inference_graph=gi)
    td = tds.Dataset.from_interactions(tru, tri, teu, tei, **kw)
    return jd, td


# ---- result CSVs ----
def test_save_result_byte_equal_to_jax(sets, tmp_path):
    jd, td = sets
    rng = np.random.default_rng(0)
    n_test = len(np.unique(td.test_user))
    topk = rng.integers(0, M_ITEMS, size=(n_test, 12))
    names = np.asarray([f'item "{i}", {i % 3}' if i % 5 == 0 else f"item{i}" for i in range(M_ITEMS)])
    cust = np.asarray([f"c{u:04d}" for u in range(N_USERS)])
    for tag, kw in (("plain", {}), ("named", dict(product_names=names, customer_ids=cust))):
        rows = tresults.save_result(tmp_path / f"t_{tag}.csv", td, topk, k=7, **kw)
        df = jresults.save_result(tmp_path / f"j_{tag}.csv", jd, topk, k=7, **kw)
        assert (tmp_path / f"t_{tag}.csv").read_bytes() == (tmp_path / f"j_{tag}.csv").read_bytes(), tag
        assert rows == df.to_dict("records")
    assert len(rows) == n_test and b'"' in (tmp_path / "t_named.csv").read_bytes()


def test_save_user_result_byte_equal_to_jax(sets, tmp_path):
    jd, td = sets
    users = np.array([0, 1, 2, 17, 59])  # user 1 has no test items: an empty field
    topk = np.random.default_rng(1).integers(0, M_ITEMS, size=(len(users), K))
    names = np.asarray([f"a,b{i}" for i in range(M_ITEMS)])
    rows = tresults.save_user_result(tmp_path / "t.csv", td, users, topk, product_names=names, k=K)
    jresults.save_user_result(tmp_path / "j.csv", jd, users, topk, product_names=names, k=K)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert rows[1]["gt_ids"] == "" and rows[1]["gt_names"] == ""
    assert (tmp_path / "t.csv").read_text().splitlines()[2].endswith(",,")


# ---- production_inference ----
def _models(sets, name, monkeypatch):
    jd, td = sets
    kw = dict(model=name, latent_dim=DIM, n_layers=2, compute_dtype="float32", topks=(K,))
    if name == "textsage":
        monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
        kw.update(num_neighbors=3, user_feature="nwt", item_feature="nwt")
        jm = jbuild_model(name, JConfig(**kw), jd.graph, features=jfeatures(jd, JConfig(**kw), seed=1))
        tm = build_model(name, Config(**kw), td.graph, features=synthetic_features(td, Config(**kw), seed=1))
    else:
        jm = jbuild_model(name, JConfig(**kw), jd.graph)
        tm = build_model(name, Config(**kw), td.graph)
    return JConfig(**kw), Config(**kw), jm, tm


def _params(jm, kind):
    p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if kind == "gauss":
        return p
    rng = np.random.default_rng(2)
    return jax.tree_util.tree_map(
        lambda a: (rng.integers(-3, 4, size=a.shape) / 8).astype(a.dtype) if a.dtype.kind == "f" else a, p)


def _csv_ids(path):
    return [[int(x) for x in s.split(",")] for s in pd.read_csv(path)["predict_ids"].astype(str)]


def _scores(tm, td, users, ids):
    """The port's masked scores of ``ids`` [B, K] over the inference graph."""
    with torch.no_grad():
        u, i = tm.propagate(td.inference_graph)
    s = u.detach().float()[torch.as_tensor(users)] @ i.detach().float().T
    if tm.score_sigmoid:
        s = torch.sigmoid(s)
    pos = td.all_pos()
    for r, user in enumerate(users):
        s[r, torch.as_tensor(pos[user])] = float(MASK_SENTINEL)
    return torch.gather(s, 1, torch.as_tensor(np.asarray(ids))).numpy()


@pytest.mark.parametrize("kind", ["eighths", "gauss"])
@pytest.mark.parametrize("name", ["lgn", "textsage", "mf"])
def test_production_inference_matches_jax(sets, tmp_path, monkeypatch, capsys, name, kind):
    jd, td = sets
    jcfg, tcfg, jm, tm = _models(sets, name, monkeypatch)
    params = _params(jm, kind)
    batches, bsz = (0, 3, 9), 16  # batch 3 is the last, 12 users; batch 9 is out of range
    jpaths = jinference.production_inference(
        jm, jax.tree_util.tree_map(jnp.asarray, params), jd, jcfg, tmp_path / "j",
        user_batch_size=bsz, target_batches=batches, k=K)
    jout = capsys.readouterr().out
    tpaths = tinference.production_inference(
        tm, params, td, tcfg, tmp_path / "t", user_batch_size=bsz, target_batches=batches, k=K, device="cpu")
    tout = capsys.readouterr().out
    assert [p.name for p in tpaths] == [p.name for p in jpaths] == [
        f"{name}_{DIM}_2_0_inference.csv", f"{name}_{DIM}_2_3_inference.csv"]
    assert tout.replace(str(tmp_path / "t"), "D") == jout.replace(str(tmp_path / "j"), "D")
    assert "[infer] batch 9 out of range (n_users=60); skipped" in tout
    pos = td.all_pos()
    for tp, jp, bi in zip(tpaths, jpaths, (0, 3)):
        users = np.arange(bi * bsz, min((bi + 1) * bsz, N_USERS))
        got, want = _csv_ids(tp), _csv_ids(jp)
        assert len(got) == len(users) and all(len(r) == K for r in got)
        for u, row in zip(users, got):  # no train positive ranks above an unmasked item
            n_free = M_ITEMS - len(pos[u])
            assert not set(row[:n_free]) & set(pos[u].tolist())
        if kind == "eighths":
            assert tp.read_bytes() == jp.read_bytes()
            continue
        # the same rows but the ids: the CSV's other columns are exact
        t_df, j_df = pd.read_csv(tp, keep_default_na=False), pd.read_csv(jp, keep_default_na=False)
        assert t_df.drop(columns=["predict_ids", "predict_names"]).equals(
            j_df.drop(columns=["predict_ids", "predict_names"]))
        sv, rv = _scores(tm, td, users, got), _scores(tm, td, users, want)
        np.testing.assert_allclose(np.sort(sv, axis=1), np.sort(rv, axis=1), rtol=RTOL, atol=ATOL)
        gap = np.abs(np.diff(rv, axis=1)) > TIE_RTOL * np.abs(rv[:, 1:])
        sep = np.ones(rv.shape, dtype=bool)
        sep[:, 1:] &= gap
        sep[:, :-1] &= gap
        np.testing.assert_array_equal(np.asarray(got)[sep], np.asarray(want)[sep])
    # user 0 keeps 4 unmasked items: the other 6 of its top 10 are masked,
    # at -1024, in id order in both packages
    row0 = _csv_ids(tpaths[0])[0]
    assert row0[4:] == sorted(row0[4:]) and set(row0[4:]) <= set(pos[0].tolist())
    assert row0 == _csv_ids(jpaths[0])[0]


def test_production_inference_masks_train_not_inference_positives(sets, tmp_path):
    """The mask is the train graph's: a user's test items (in the inference
    edge set) can be predicted."""
    jd, td = sets
    tm = build_model("lgn", Config(model="lgn", latent_dim=DIM, compute_dtype="float32"), td.graph)
    (p,) = tinference.production_inference(tm, None, td, tm.config, tmp_path, user_batch_size=N_USERS,
                                          k=M_ITEMS - 4, device="cpu")
    test = td.test_dict()
    rows = _csv_ids(p)
    assert any(set(rows[u]) & set(test[u].tolist()) for u in test)
    for u, row in enumerate(rows):
        n_free = M_ITEMS - len(td.all_pos()[u])
        assert set(row[: min(n_free, len(row))]).isdisjoint(td.all_pos()[u].tolist())


# ---- from_reference_pickles ----
def _write_pickles(base, suffix, with_entities=True, n_users=12, m_items=20, seed=0):
    rng = np.random.default_rng(seed)
    sub = base / suffix if suffix else base
    sub.mkdir(parents=True, exist_ok=True)
    for name, n in (("train", 60), ("test", 20)):
        pd.DataFrame({"cf_customer": rng.integers(0, n_users, n), "cf_product": rng.integers(0, m_items, n)}
                     ).to_pickle(sub / f"{name}{suffix}.pkl")
    if suffix == "all":
        pd.DataFrame({"cf_customer": rng.integers(0, n_users, 70), "cf_product": rng.integers(0, m_items, 70)}
                     ).to_pickle(sub / f"inference{suffix}.pkl")
    if with_entities:
        cb = base / "cb" / suffix if suffix else base / "cb"
        cb.mkdir(parents=True, exist_ok=True)
        pd.DataFrame({"cf_customer": np.arange(n_users + 3), "age": 30}).to_pickle(cb / f"customer_cb{suffix}.pkl")
        pd.DataFrame({"cf_product": np.arange(m_items + 2), "price": 1}).to_pickle(cb / f"product_cb{suffix}.pkl")


@pytest.mark.parametrize("suffix,entities", [("", True), ("all", True), ("22_1_10", True), ("", False)])
def test_from_reference_pickles_matches_jax(tmp_path, suffix, entities):
    _write_pickles(tmp_path, suffix, with_entities=entities)
    if entities:
        jd = jds.Dataset.from_reference_pickles(str(tmp_path), suffix=suffix)
        td = tds.Dataset.from_reference_pickles(str(tmp_path), suffix=suffix)
        assert (td.n_users, td.m_items) == (15, 22)  # the entity frames' lengths
    else:
        with pytest.warns(UserWarning, match="entity frames"):
            jd = jds.Dataset.from_reference_pickles(str(tmp_path), suffix=suffix)
        with pytest.warns(UserWarning, match="entity frames"):
            td = tds.Dataset.from_reference_pickles(str(tmp_path), suffix=suffix)
    assert (td.n_users, td.m_items) == (jd.n_users, jd.m_items)
    for f in ("train_user", "train_item", "test_user", "test_item", "inference_user", "inference_item"):
        a, b = getattr(td, f), getattr(jd, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert td.has_inference_edges == (suffix == "all")
    for f in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(td.inference_graph.user_pos, f).numpy(),
                                      np.asarray(getattr(jd.inference_graph.user_pos, f)))


@pytest.mark.parametrize("suffix", ["", "all"])
def test_write_text_dataset_reads_back_in_both_packages(sets, tmp_path, suffix):
    """``write_text_dataset``: the reference's adjacency lists, read back by
    both packages' ``load_text_dataset`` as the same arrays, the inference
    edge set from ``inference{suffix}.txt``."""
    from furusato_recommend_tpu_torch.data.artifacts import write_text_dataset

    _, td = sets
    write_text_dataset(td, tmp_path, suffix=suffix)
    back = tds.load_text_dataset(Config(data_path=str(tmp_path), suffix=suffix))
    jback = jds.load_text_dataset(JConfig(data_path=str(tmp_path), suffix=suffix))
    assert (back.n_users, back.m_items) == (jback.n_users, jback.m_items) == (N_USERS, M_ITEMS)
    for f in ("train_user", "train_item", "test_user", "test_item", "inference_user", "inference_item"):
        np.testing.assert_array_equal(getattr(back, f), getattr(jback, f), err_msg=f)
    for f in ("train_user", "train_item", "test_user", "test_item"):
        np.testing.assert_array_equal(getattr(back, f), getattr(td, f), err_msg=f)
    inf = set(zip(back.inference_user.tolist(), back.inference_item.tolist()))
    assert inf == set(zip(td.inference_user.tolist(), td.inference_item.tolist()))
    for f in ("indptr", "indices"):
        assert torch.equal(getattr(back.graph.user_pos, f), getattr(td.graph.user_pos, f))


# ---- tools from a checkpoint ----
def _write_text_data(base):
    """cf/train.txt, test.txt and inference.txt (train + test per user)."""
    rng = np.random.default_rng(4)
    cf = base / "cf"
    cf.mkdir(parents=True)
    with open(cf / "train.txt", "w") as f, open(cf / "test.txt", "w") as g, open(cf / "inference.txt", "w") as h:
        for u in range(40):
            items = rng.choice(30, size=int(rng.integers(5, 10)), replace=False)
            f.write(f"{u} " + " ".join(map(str, items[:-2])) + "\n")
            g.write(f"{u} " + " ".join(map(str, items[-2:])) + "\n")
            h.write(f"{u} " + " ".join(map(str, items)) + "\n")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX checkpoint of mf (parameters in eighths, Adam after two updates)
    and what the JAX tools make of it; the port's export of it."""
    tmp = tmp_path_factory.mktemp("tools")
    data = tmp / "data"
    _write_text_data(data)
    jcfg = JConfig(model="mf", latent_dim=8, topks=(5, 10), eval_user_batch=16, seed=5,
                   data_path=str(tmp / "elsewhere"), path=str(tmp / "ck"))
    jd = jds.load_text_dataset(jcfg.replace(data_path=str(data)))
    rng = np.random.default_rng(6)
    params = {"user_emb": jnp.asarray(rng.integers(-4, 5, (jd.n_users, 8)) / 8, jnp.float32),
              "item_emb": jnp.asarray(rng.integers(-4, 5, (jd.m_items, 8)) / 8, jnp.float32)}
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    for _ in range(2):
        grads = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), params)
        _, opt_state = opt.update(grads, opt_state, params)
    ck = tmp / "jax.ckpt"
    jsave_checkpoint(ck, {"params": params, "opt_state": opt_state, "step": jnp.asarray(3),
                          "key": jax.random.PRNGKey(0), "max_recall": jnp.asarray(0.25)}, jcfg)
    return {"tmp": tmp, "data": data, "ck": ck, "cfg": jcfg, "params": params, "opt_state": opt_state}


def _run(fn, capsys):
    out = fn()
    return out, capsys.readouterr().out


def _metrics(printed: str) -> dict:
    start = printed.index("{\n")
    return json.loads(printed[start: printed.index("\n}", start) + 2])


def test_tools_evaluate_infer_recommend_match_jax(jax_run, capsys):
    tmp, data, ck = jax_run["tmp"], str(jax_run["data"]), str(jax_run["ck"])
    exported = str(tmp / "port.ckpt")
    _export_module().main(["--ckpt", ck, "--out", exported])
    capsys.readouterr()

    common = ["--data_path", data]
    _, j_eval = _run(lambda: jtools.main(["evaluate", "--ckpt", ck, *common,
                                          "--save_result", str(tmp / "j_eval.csv")]), capsys)
    t, t_eval = _run(lambda: ttools.main(["evaluate", "--ckpt", exported, *common, "--device", "cpu",
                                          "--save_result", str(tmp / "t_eval.csv")]), capsys)
    jm, tm = _metrics(j_eval), _metrics(t_eval)
    assert set(tm) == set(jm) and set(t["results"]) == set(jm)
    for key, v in jm.items():
        assert abs(t["results"][key] - v) <= 1e-6, key
    assert (tmp / "t_eval.csv").read_bytes() == (tmp / "j_eval.csv").read_bytes()
    assert t_eval.endswith(f"wrote {tmp / 't_eval.csv'}\n")
    assert set(t["seconds"]) == {"load", "evaluate", "csv"}

    infer = ["--user_batch", "16", "--target_batches", "0,2,7", "--k", "10", *common]
    _, j_inf = _run(lambda: jtools.main(["infer", "--ckpt", ck, "--out_dir", str(tmp / "j_inf"), *infer]), capsys)
    t, t_inf = _run(lambda: ttools.main(["infer", "--ckpt", exported, "--out_dir", str(tmp / "t_inf"),
                                         "--device", "cpu", *infer]), capsys)
    assert t_inf.replace("t_inf", "X") == j_inf.replace("j_inf", "X")
    assert "[infer] batch 7 out of range (n_users=40); skipped" in t_inf and "wrote 2 csv(s)" in t_inf
    names = sorted(p.name for p in (tmp / "j_inf").iterdir())
    assert names == sorted(p.name for p in t["paths"]) == ["mf_8_2_0_inference.csv", "mf_8_2_2_inference.csv"]
    for n in names:
        assert (tmp / "t_inf" / n).read_bytes() == (tmp / "j_inf" / n).read_bytes(), n
    assert set(t["seconds"]) == {"load", "infer/graph", "infer/propagate", "infer/topk", "infer/csv"}

    for extra in ([], ["--train_edges_only"]):
        rec = ["--users", "3,17,39", "--k", "5", *common, *extra]
        _, j_rec = _run(lambda: jtools.main(["recommend", "--ckpt", ck, *rec]), capsys)
        t, t_rec = _run(lambda: ttools.main(["recommend", "--ckpt", exported, "--device", "cpu", *rec]), capsys)
        assert t_rec == j_rec and t_rec.count("\n") == 3
        assert t["lines"] == t_rec.splitlines()


@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_exported_checkpoint_resumes_in_the_port_trainer(jax_run, backend):
    tmp = jax_run["tmp"]
    ck = jax_run["ck"]
    if backend == "orbax":
        ck = tmp / "jax_orbax"
        jsave_checkpoint(ck, {"params": jax_run["params"], "opt_state": jax_run["opt_state"],
                              "step": jnp.asarray(3), "key": jax.random.PRNGKey(0),
                              "max_recall": jnp.asarray(0.25)}, jax_run["cfg"], backend="orbax")
    exported = str(tmp / f"resume_{backend}.ckpt")
    summary = _export_module().main(["--ckpt", str(ck), "--out", exported])
    assert summary["optimizers"] == ["adam"] and summary["params"] == ["item_emb", "user_emb"]
    cfg = Config.from_json(jax_run["cfg"].to_json()).replace(data_path=str(jax_run["data"]))
    td = tds.load_text_dataset(cfg)
    tr = Trainer(cfg, td, build_model("mf", cfg, td.graph), device="cpu")
    tr.restore(exported)
    adam = jax_run["opt_state"][0]
    assert tr.step == 3 and tr.max_recall == 0.25
    named = dict(tr.model.named_parameters())
    for name in ("user_emb", "item_emb"):
        np.testing.assert_array_equal(named[name].detach().numpy(), np.asarray(jax_run["params"][name]))
        st = tr.optimizer.state[named[name]]
        assert int(st["step"]) == int(adam.count) == 2
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(adam.mu[name]))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[name]))
    assert torch.equal(tr.generator.get_state(), torch.Generator().manual_seed(cfg.seed).get_state())
    tr.train_one_epoch()  # the restored Adam steps on
    assert int(tr.optimizer.state[named["user_emb"]]["step"]) > 2


def test_exported_checkpoint_without_a_generator_seeds_from_config_seed(jax_run, tmp_path):
    """The export writes no generator state (JAX's key has no torch
    counterpart): restore starts the sampler's stream from config.seed, and
    the rest of the state is as written."""
    from furusato_recommend_tpu_torch.core.checkpoint import load_checkpoint

    src = str(tmp_path / "src.ckpt")
    _export_module().main(["--ckpt", str(jax_run["ck"]), "--out", src])
    assert "generator" not in load_checkpoint(src)["state"]
    cfg = Config.from_json(jax_run["cfg"].to_json()).replace(data_path=str(jax_run["data"]))
    td = tds.load_text_dataset(cfg)
    tr = Trainer(cfg, td, build_model("mf", cfg, td.graph), device="cpu")
    tr.generator.manual_seed(cfg.seed + 1)
    tr.restore(src)
    assert torch.equal(tr.generator.get_state(), torch.Generator().manual_seed(cfg.seed).get_state())
    assert tr.step == 3 and int(tr.optimizer.state[tr.model.user_emb]["step"]) == 2


def test_restore_refuses_a_generator_state_of_another_device(jax_run, tmp_path):
    """A generator state the trainer's generator cannot take (here CUDA's 16
    bytes of seed and offset on a CPU trainer) raises: no stream is swapped
    for another in silence."""
    from furusato_recommend_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint

    src = str(tmp_path / "src.ckpt")
    _export_module().main(["--ckpt", str(jax_run["ck"]), "--out", src])
    ck = load_checkpoint(src)
    ck["state"]["generator"] = np.zeros(16, np.uint8)
    cfg = Config.from_json(json.dumps(ck["__config__"])).replace(data_path=str(jax_run["data"]))
    save_checkpoint(tmp_path / "other.ckpt", ck["params"], cfg, ck["state"])
    td = tds.load_text_dataset(cfg)
    tr = Trainer(cfg, td, build_model("mf", cfg, td.graph), device="cpu")
    with pytest.raises(RuntimeError):
        tr.restore(tmp_path / "other.ckpt")


def test_export_finds_each_adam_of_a_partitioned_optimizer():
    """The JAX trainer's state under feature_update_every > 1: two
    multi_transforms of adam and set_to_zero; each Adam found in order, its
    moments zero outside its group."""
    exp = _export_module()
    params = {"a": jnp.ones((3, 2)), "layers": [{"w": jnp.ones((2, 2))}]}

    def labels(on_a):
        return lambda p: {"a": "on" if on_a else "off", "layers": [{"w": "off" if on_a else "on"}]}

    opts = [optax.multi_transform({"on": optax.adam(0.1), "off": optax.set_to_zero()}, labels(x))
            for x in (False, True)]
    grads = jax.tree_util.tree_map(lambda a: 0.5 * a, params)
    states = []
    for opt in opts:
        s = opt.init(params)
        _, s = opt.update(grads, s, params)
        states.append(s)
    found = exp.adam_states(tuple(states))
    assert len(found) == 2
    flat = {k: np.asarray(v) for k, v in exp.flatten_params(params).items()}
    mu0 = exp._moments(found[0].mu, flat)
    mu1 = exp._moments(found[1].mu, flat)
    assert not mu0["a"].any() and mu0["layers.0.w"].any()
    assert mu1["a"].any() and not mu1["layers.0.w"].any()
    # orbax restores a MaskedNode as None, and a parameter may be absent
    orbax_like = {"a": None, "layers": [{"w": np.asarray(found[0].mu["layers"][0]["w"])}]}
    assert not exp._moments(orbax_like, flat)["a"].any()
    assert not exp._moments({}, flat)["layers.0.w"].any()


@pytest.mark.parametrize("leaf", ["shape", "dtype"])
def test_export_refuses_a_moment_unlike_its_parameter(leaf):
    """A moment of another shape or a non-float dtype (a renamed, reshaped or
    reordered leaf) raises, naming the parameter, instead of becoming zeros."""
    exp = _export_module()
    flat = {"a": np.ones((3, 2), np.float32), "layers.0.w": np.ones((2, 2), np.float32)}
    bad = np.ones((2, 3), np.float32) if leaf == "shape" else np.ones((3, 2), np.int32)
    with pytest.raises(ValueError, match="'a'"):
        exp._moments({"a": bad, "layers": [{"w": np.ones((2, 2), np.float32)}]}, flat)


@pytest.mark.parametrize("cmd", ["preprocess", "convert-recbole"])
def test_unported_subcommands_raise(cmd, tmp_path):
    """The preprocessing subcommands, once unported, now run on the host:
    they take no --device (so no CUDA check) and read their tables, which
    raises for a file that is not there."""
    args = {
        "preprocess": ["--products", "p.csv", "--customers", "c.csv", "--transactions", "t.csv"],
        "convert-recbole": ["--interactions", "i.csv"],
    }[cmd]
    missing = [str(tmp_path / a) if a.endswith(".csv") else a for a in args]
    with pytest.raises(FileNotFoundError):
        ttools.main([cmd, *missing, "--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit):
        ttools.build_argparser().parse_args([cmd, *missing, "--out", "o", "--device", "cpu"])


@pytest.mark.parametrize("cmd", ["evaluate", "infer", "recommend", "dump-candidates", "train-ranker", "rerank-eval"])
def test_tools_default_to_cuda(jax_run, cmd):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is there")
    extra = {"recommend": ["--ckpt", str(jax_run["ck"]), "--users", "1"],
             "train-ranker": ["--candidates", "a.npy"],
             "rerank-eval": ["--candidates", "a.npy", "--ranker", str(jax_run["ck"])]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttools.main([cmd, *extra.get(cmd, ["--ckpt", str(jax_run["ck"])])])


def test_cli_accepts_wandb_and_tensorboard(jax_run, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed: the JSONL and stdout go on
    tcli.main(["--model", "mf", "--recdim", "8", "--bpr_batch", "128", "--epochs", "1", "--test_span", "1",
               "--topks", "[5]", "--testbatch", "32", "--data_path", str(jax_run["data"]),
               "--path", str(tmp_path / "ck"), "--device", "cpu", "--wandb", "x", "--tensorboard", "1"])
    out = capsys.readouterr().out
    assert "[obs] wandb unavailable (" in out
    assert list((tmp_path / "ck" / "mf" / "tb").glob("events.out.tfevents.*"))
    assert (tmp_path / "ck" / "mf" / "metrics.jsonl").stat().st_size > 0


def test_card_path_runs_without_pandas(tmp_path):
    """Every port module imports, and save_user_result and
    production_inference run, with pandas unimportable (the card's machine
    has none)."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import importlib, pkgutil\n"
        "import numpy as np\n"
        "import furusato_recommend_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from furusato_recommend_tpu_torch.config import Config\n"
        "from furusato_recommend_tpu_torch.data.dataset import synthetic_dataset\n"
        "from furusato_recommend_tpu_torch.eval.inference import production_inference\n"
        "from furusato_recommend_tpu_torch.eval.results import save_user_result\n"
        "from furusato_recommend_tpu_torch.models.registry import build_model\n"
        "ds = synthetic_dataset(n_users=30, m_items=25, avg_degree=5, seed=0)\n"
        "cfg = Config(model='lgn', latent_dim=8)\n"
        f"out = {str(tmp_path)!r}\n"
        "paths = production_inference(build_model('lgn', cfg, ds.graph), None, ds, cfg, out,\n"
        "                             user_batch_size=16, target_batches=(0, 1), k=5, device='cpu')\n"
        "rows = save_user_result(out + '/u.csv', ds, np.arange(3), np.zeros((3, 5), int), k=5)\n"
        "assert len(paths) == 2 and len(rows) == 3\n"
        "assert not [n for n, m in sys.modules.items() if n.split('.')[0] == 'pandas' and m is not None]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=180,
                         cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
