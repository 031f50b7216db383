"""Port vs JAX package: the out-of-core ``dask`` variant (``data/ooc.py``,
``train/prefetch.py``, the trainer's OOC branch) and the CLI's flags.

- ``stream_project`` and ``stream_project_grad`` on a memmap in ``tmp_path``
  against the JAX package's (uneven last chunk): rtol 1e-5 / 1e-4, as the JAX
  package holds its own against the dense products;
- ``prefetch_to_device`` / ``BackgroundProducer`` on the CPU: every item, in
  order, and the producer's error raised in the consumer;
- one ``dask`` epoch against a JAX loop that runs the JAX trainer's OOC
  branch (``train/trainer.py:156-181, 449-463, 573-599``): one linearization
  with respect to the parameters and the streamed projections, the numeric
  linears out of Adam, the projections' table gradients summed, then the
  streamed X^T G step at lr / num_batches; losses and parameters within rtol
  1e-4, atol 1e-6 (the same inputs and rules as tests/test_torch_cadence.py);
- every flag of the JAX CLI parsed by both parsers into equal ``Config``
  fields; the ignored flags' notices and ``--ckpt_backend orbax``; ``dask``
  trained through the port's CLI.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from furusato_recommend_tpu import cli as jcli
from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data import ooc as jooc
from furusato_recommend_tpu.data.features import synthetic_features as jfeatures
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu_torch import cli as tcli
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import flatten_params, params_from_jax, params_to_numpy
from furusato_recommend_tpu_torch.data import artifacts
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data import ooc as tooc
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors
from furusato_recommend_tpu_torch.train.prefetch import BackgroundProducer, prefetch_to_device
from furusato_recommend_tpu_torch.train.trainer import Trainer

from test_torch_cadence import N_USERS, M_ITEMS, STEPS, TOL, _Jax, _batch, _kw, _tree_add

torch.set_num_threads(1)


@pytest.mark.parametrize("n,fn,d,chunk", [(1000, 17, 8, 128), (300, 5, 4, 300), (64, 3, 16, 65536)])
def test_stream_project_and_grad_match_jax(tmp_path, n, fn, d, chunk):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, fn)).astype(np.float32)
    w = rng.standard_normal((fn, d)).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    g = rng.standard_normal((n, d)).astype(np.float32)
    tm = tooc.MemmapNumeric.write(str(tmp_path / "num"), x)
    jm = jooc.MemmapNumeric(tm.path)
    assert tm.shape == jm.shape == (n, fn)
    want = np.asarray(jooc.stream_project(jm, jnp.asarray(w), jnp.asarray(b), chunk=chunk))
    got = tooc.stream_project(tm, torch.from_numpy(w), torch.from_numpy(b), chunk=chunk)
    assert got.shape == (n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    jgw, jgb = jooc.stream_project_grad(jm, jnp.asarray(g), chunk=chunk)
    gw, gb = tooc.stream_project_grad(tm, torch.from_numpy(g), chunk=chunk)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-4, atol=1e-4)


def test_prefetch_yields_every_item_in_order_and_raises_the_producers_error():
    items = [(np.full(3, i, np.float32), {"k": np.arange(i)}) for i in range(7)]
    got = list(prefetch_to_device(iter(items), size=2))
    assert len(got) == 7
    for i, (a, d) in enumerate(got):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), items[i][0])
        np.testing.assert_array_equal(d["k"].numpy(), np.arange(i))

    def produce():
        for i in range(3):
            yield np.array([i])
        raise OSError("disk gone")

    p = BackgroundProducer(produce(), size=1)
    assert [int(p.get()[0]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(OSError, match="disk gone"):
        p.get()
    p.close()
    p = BackgroundProducer((np.array([i]) for i in range(2)))
    assert [int(p.get()[0]) for _ in range(2)] == [0, 1]
    with pytest.raises(StopIteration):
        p.get()
    p.close()
    p = BackgroundProducer((np.array([i]) for i in range(10**6)), size=1)  # closed while it waits on a full queue
    p.close()
    assert not p._thread.is_alive()


@pytest.fixture
def ooc_env(tmp_path, monkeypatch):
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
    monkeypatch.setattr(jsage, "DROPOUT_RATE", 0.0)
    monkeypatch.setattr(tsage, "DROPOUT_RATE", 0.0)
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    g = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, N_USERS, M_ITEMS,
                     hub_count=0, dst_hub_count=0)
    jd = dataclasses.replace(jd, _graph=g)
    kw = _kw(model="dask", user_feature="nctw", item_feature="nctw")
    jf, tf = jfeatures(jd, JConfig(**kw), seed=1), synthetic_features(td, Config(**kw), seed=1)
    jmm, tmm = {}, {}
    for side in ("user", "item"):
        x = getattr(tf, side).numeric.numpy()
        tmm[side] = tooc.MemmapNumeric.write(str(tmp_path / f"{side}_numeric.npy"), x)
        jmm[side] = jooc.MemmapNumeric(tmm[side].path)
    jf = dataclasses.replace(jf, user=dataclasses.replace(jf.user, numeric=None),
                             item=dataclasses.replace(jf.item, numeric=None))
    tf = dataclasses.replace(tf, user=dataclasses.replace(tf.user, numeric=None),
                             item=dataclasses.replace(tf.item, numeric=None))
    jm = jbuild_model("dask", JConfig(**kw), jd.graph, features=jf, ooc_numeric=jmm)
    tm = build_model("dask", Config(**kw), td.graph, features=tf, ooc_numeric=tmm)
    jp = jm.init(jax.random.PRNGKey(0))
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    return dict(jd=jd, td=td, jm=jm, tm=tm, jp=jp, jmm=jmm, cfg=Config(**kw))


def jax_ooc_epoch(J, jm, p, batches, trees, lr, mms):
    """The JAX trainer's OOC epoch: (params, per-step losses)."""
    proj = jm.refresh_ooc_proj(p)
    tables0 = J.tables(p, proj)
    frozen = {f"{side}_numeric_{sfx}" for side in mms for sfx in ("w", "b")}
    opt = optax.multi_transform(
        {"adam": optax.adam(lr), "ooc": optax.set_to_zero()},
        lambda params: jax.tree_util.tree_map_with_path(
            lambda path, _: "ooc" if (path and getattr(path[0], "key", None) in frozen) else "adam", params),
    )
    state = opt.init(p)
    p0, acc, losses = p, jax.tree_util.tree_map(jnp.zeros_like, proj), []
    for batch, tr in zip(batches, trees):
        (loss, _), (g_p, g_t) = J.cached(p, tables0, batch, tr)
        g_feat, g_pr = J.pullback(p0, proj, g_t)
        acc = _tree_add(acc, g_pr)
        upd, state = opt.update(_tree_add(g_p, g_feat), state, p)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
    p = dict(p)
    for side, mm in mms.items():
        gw, gb = jooc.stream_project_grad(mm, acc[side])
        p[f"{side}_numeric_w"] = p[f"{side}_numeric_w"] - lr / len(batches) * gw
        p[f"{side}_numeric_b"] = p[f"{side}_numeric_b"] - lr / len(batches) * gb
    return p, losses


def test_dask_epoch_matches_jax_ooc_branch(ooc_env):
    jd, td, jm, tm = ooc_env["jd"], ooc_env["td"], ooc_env["jm"], ooc_env["tm"]
    batches = [_batch(td, seed=s) for s in range(STEPS)]
    jtrees, ttrees = [], []
    for s, (jb, _) in enumerate(batches):
        keys = jax.random.split(jax.random.PRNGKey(20 + s), 3)
        t = [jm.sample_seed_tree(jd.graph, x, side, k)
             for (x, side), k in zip(((jb.user, "user"), (jb.pos, "item"), (jb.neg, "item")), keys)]
        jtrees.append(t)
        ttrees.append({"trees": [[SampledNeighbors(*(torch.tensor(np.asarray(x)) for x in lvl)) for lvl in tr]
                                 for tr in t]})
    cfg = ooc_env["cfg"]
    jp, jlosses = jax_ooc_epoch(_Jax(jm, jd.graph, ooc=True), jm, ooc_env["jp"], [b for b, _ in batches],
                                jtrees, cfg.lr, ooc_env["jmm"])
    tr = Trainer(cfg, td, tm, device="cpu", logger=MetricLogger(quiet=True))
    assert tr.cadence == "ooc" and "user_numeric_w" not in tr.feature_names
    stepped = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
    named = dict(tm.named_parameters())
    assert {k for k, p in named.items() if id(p) not in stepped} == {
        f"{s}_numeric_{x}" for s in ("user", "item") for x in ("w", "b")}
    losses = tr.train_epoch([b for _, b in batches], draws=ttrees)
    np.testing.assert_allclose(losses.numpy(), jlosses, **TOL)
    got = flatten_params(params_to_numpy(tm))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    # the evaluation streams the projections of the updated linears first
    tr.test()
    np.testing.assert_allclose(
        tm._ooc_proj["item"].numpy(),
        np.asarray(jooc.stream_project(ooc_env["jmm"]["item"], jp["item_numeric_w"], jp["item_numeric_b"])),
        rtol=1e-5, atol=1e-6)


def test_dask_rejects_what_the_jax_trainer_rejects(ooc_env):
    tm, td, cfg = ooc_env["tm"], ooc_env["td"], ooc_env["cfg"]
    for over, match in ((dict(train_emb=True), "train_emb"), (dict(feature_update_every=2), "out-of-core")):
        with pytest.raises(ValueError, match=match):
            Trainer(cfg.replace(**over), td, tm, device="cpu")
    with pytest.raises(ValueError, match="both in-core"):
        build_model("dask", cfg, td.graph, features=synthetic_features(td, cfg, seed=1),
                    ooc_numeric={"user": ooc_env["tm"].ooc_numeric["user"]})


def _every_jax_flag():
    """argv setting every option of the JAX CLI to a value other than its
    default (a choice where it has choices)."""
    argv = []
    for a in jcli.build_argparser()._actions:
        if not a.option_strings or a.dest == "help":
            continue
        flag = a.option_strings[0]
        if isinstance(a, argparse.BooleanOptionalAction):
            argv.append(f"--no-{a.dest}" if a.default else flag)
        elif a.nargs == 0:
            argv.append(flag)
        elif a.choices:
            argv += [flag, next(c for c in a.choices if c != a.default)]
        elif a.dest == "topks":
            argv += [flag, "[5,15]"]
        elif a.dest == "inference":
            argv += [flag, "sample"]
        elif a.dest == "conv":
            argv += [flag, "light"]
        elif a.dest == "multi_relational":
            argv += [flag, "prod"]
        elif a.dest in ("user_feature", "item_feature"):
            argv += [flag, "nc"]
        elif a.type is int:
            argv += [flag, str(a.default + 3)]
        elif a.type is float:
            argv += [flag, str(a.default + 0.25)]
        else:
            argv += [flag, "x"]
    return argv


def test_every_jax_flag_parses_into_equal_config_fields():
    jp, tp = jcli.build_argparser(), tcli.build_argparser()
    topts = {s: a for a in tp._actions for s in a.option_strings}
    for a in jp._actions:
        for s in a.option_strings:
            assert s in topts, s
            b = topts[s]
            assert (b.default, b.choices, type(b)) == (a.default, a.choices, type(a)), s
    argv = _every_jax_flag()
    want = dataclasses.asdict(jcli.config_from_args(jp.parse_args(argv)))
    got = dataclasses.asdict(tcli.config_from_args(tp.parse_args(argv)))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    assert want["pipeline_dispatch"] is False and want["ckpt_backend"] == "orbax"
    defaults = dataclasses.asdict(tcli.config_from_args(tp.parse_args([])))
    assert defaults == dataclasses.asdict(jcli.config_from_args(jp.parse_args([])))


def _text_dataset(tmp_path):
    rng = np.random.default_rng(0)
    data = tmp_path / "data" / "cf"
    data.mkdir(parents=True)
    with open(data / "train.txt", "w") as f, open(data / "test.txt", "w") as g:
        for u in range(60):
            items = rng.choice(80, size=rng.integers(6, 12), replace=False)
            f.write(f"{u} " + " ".join(map(str, items[:-2])) + "\n")
            g.write(f"{u} " + " ".join(map(str, items[-2:])) + "\n")
    artifacts.main(["--data_path", str(tmp_path / "data"), "--seed", "1"])


def test_cli_ignored_flags_and_orbax(tmp_path, capsys):
    _text_dataset(tmp_path)
    base = ["--model", "mf", "--recdim", "8", "--bpr_batch", "128", "--epochs", "1", "--test_span", "1",
            "--topks", "[5]", "--testbatch", "32", "--data_path", str(tmp_path / "data"),
            "--path", str(tmp_path / "ck"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="--ckpt_backend orbax"):
        tcli.main(base + ["--ckpt_backend", "orbax"])
    tcli.main(base + ["--a_fold", "10", "--compile_cache", str(tmp_path / "cc"), "--no-pipeline_dispatch"])
    out = capsys.readouterr().out
    for flag in ("--a_fold", "--compile_cache"):
        assert sum(line.startswith(f"[cli] {flag} is ignored") for line in out.splitlines()) == 1, flag
    # --pipeline_dispatch is a flag of the port's trainer (train/trainer.py), not ignored
    assert not any("--pipeline_dispatch" in line for line in out.splitlines())
    assert not (tmp_path / "cc").exists()


def test_cli_trains_dask_with_numerics_on_disk(tmp_path, monkeypatch):
    _text_dataset(tmp_path)
    built = {}
    real = tcli.build_model_inputs

    def spy(config, dataset):
        graph, kw = real(config, dataset)
        built.update(kw)
        return graph, kw

    monkeypatch.setattr(tcli, "build_model_inputs", spy)
    tcli.main([
        "--model", "dask", "--ddp_recipe", "--recdim", "8", "--bpr_batch", "256", "--lr", "0.01",
        "--epochs", "2", "--test_span", "1", "--topks", "[5,10]", "--testbatch", "32",
        "--user_feature", "nctw", "--item_feature", "nwt",
        "--data_path", str(tmp_path / "data"), "--path", str(tmp_path / "ck"), "--device", "cpu",
    ])
    assert set(built["ooc_numeric"]) == {"user", "item"}
    assert built["features"].user.numeric is None and built["features"].item.numeric is None
    assert isinstance(built["ooc_numeric"]["user"], tooc.MemmapNumeric)
    assert (tmp_path / "ck" / "dask" / "metrics.jsonl").exists()
