"""The port's serving slice end to end on the CPU against
``furusato_recommend_tpu.serve.Recommender``, on the float32 contract (JAX
graph without hub-dense blocks, compute_dtype="float32"): recommended ids
equal, scores within rtol 1e-5 / atol 1e-6. Plus checkpoints, the HTTP
endpoints, the device rule and the port's import boundary."""

import dataclasses
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.serve import Recommender as JRecommender
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.serve import Recommender, make_server

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 64, 48, 16
USERS = np.arange(N_USERS)


def _hub_free(u, i, ds):
    return jbuild_graph(
        u, i, ds.test_user, ds.test_item, ds.n_users, ds.m_items, hub_count=0, dst_hub_count=0
    )


@pytest.fixture(scope="module")
def data():
    """(jax dataset, port dataset), both with train + test inference edges."""
    base = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=6, seed=4)
    inf_u = np.concatenate([base.train_user, base.test_user])
    inf_i = np.concatenate([base.train_item, base.test_item])
    jd = dataclasses.replace(
        base,
        inference_user=inf_u,
        inference_item=inf_i,
        _graph=_hub_free(base.train_user, base.train_item, base),
        _inference_graph=_hub_free(inf_u, inf_i, base),
    )
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=6, seed=4)
    td = dataclasses.replace(td, inference_user=inf_u, inference_item=inf_i)
    return jd, td


def _params(name, seed):
    rng = np.random.default_rng(seed)
    std = 1.0 if name == "mf" else 0.1
    return {
        "user_emb": (std * rng.standard_normal((N_USERS, DIM))).astype(np.float32),
        "item_emb": (std * rng.standard_normal((M_ITEMS, DIM))).astype(np.float32),
    }


def _config(name):
    return dict(model=name, latent_dim=DIM, n_layers=2, compute_dtype="float32")


def _pair(data, name, params, **kw):
    jd, td = data
    jm = jbuild_model(name, JConfig(**_config(name)), jd.graph)
    jrec = JRecommender(
        jm, jd, JConfig(**_config(name)), jax.tree_util.tree_map(jax.numpy.asarray, params), **kw
    )
    tm = build_model(name, Config(**_config(name)), td.graph)
    trec = Recommender(tm, td, Config(**_config(name)), params, device="cpu", **kw)
    return jrec, trec


def _assert_same(jrec, trec, k, users=USERS):
    jid, jsc = jrec.recommend(users, k=k)
    tid, tsc = trec.recommend(users, k=k)
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "name,inference,exclude,k",
    [
        ("lgn", False, True, 10),
        ("lgn", False, False, 10),
        ("lgn", True, True, 20),
        ("radj", True, True, 10),
        ("mf", False, True, 48),  # sigmoid; the whole catalog, sentinel ties included
    ],
)
def test_recommend_matches_jax(data, name, inference, exclude, k):
    jrec, trec = _pair(
        data, name, _params(name, 0), use_inference_edges=inference, exclude_train=exclude
    )
    _assert_same(jrec, trec, k)
    _assert_same(jrec, trec, 5, users=[3])
    ids, scores = trec.recommend(7, k=3)  # a scalar request
    assert ids.shape == (1, 3) and scores.shape == (1, 3)


def test_refresh_tracks_params(data):
    jrec, trec = _pair(data, "lgn", _params("lgn", 0), use_inference_edges=False)
    before = trec.recommend(USERS, k=10)[0]
    p2 = _params("lgn", 1)
    trec.refresh(p2)
    jrec.refresh(jax.tree_util.tree_map(jax.numpy.asarray, p2))
    _assert_same(jrec, trec, 10)
    assert not np.array_equal(before, trec.recommend(USERS, k=10)[0])


@pytest.fixture()
def text_checkpoint(tmp_path, data):
    """A text dataset of the port's data plus a checkpoint that names it."""
    _, td = data
    root = tmp_path / "data"
    (root / "cf").mkdir(parents=True)
    ap, tdict = td.all_pos(), td.test_dict()
    with open(root / "cf" / "train.txt", "w") as f, open(root / "cf" / "test.txt", "w") as g:
        for u in range(td.n_users):
            f.write(f"{u} " + " ".join(map(str, ap[u])) + "\n")
            if u in tdict:
                g.write(f"{u} " + " ".join(map(str, tdict[u])) + "\n")
    params = _params("lgn", 2)
    cfg = Config(**_config("lgn"), data_path=str(root))
    ck = tmp_path / "m.npz"
    save_checkpoint(ck, params, cfg)
    return ck, params, cfg


def test_checkpoint_round_trip(data, text_checkpoint):
    ck, params, cfg = text_checkpoint
    state = load_checkpoint(ck)
    assert Config.from_json(json.dumps(state["__config__"])) == cfg
    for name in params:
        np.testing.assert_array_equal(state["params"][name], params[name])
    rec = Recommender.from_checkpoint(str(ck), device="cpu", use_inference_edges=False)
    _, td = data
    tm = build_model("lgn", cfg, td.graph)
    want = Recommender(tm, td, cfg, params, use_inference_edges=False, device="cpu")
    for a, b in zip(rec.recommend(USERS, k=10), want.recommend(USERS, k=10)):
        np.testing.assert_array_equal(a, b)


def test_http_server_endpoints(data, text_checkpoint):
    """healthz, GET / POST recommend, the 400 and 404 cases and hot reload,
    against an in-process server on an ephemeral port."""
    _, td = data
    ck, params, cfg = text_checkpoint
    rec = Recommender(
        build_model("lgn", cfg, td.graph), td, cfg, _params("lgn", 0),
        use_inference_edges=False, device="cpu",
    )
    srv = make_server(rec, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, obj):
        req = urllib.request.Request(base + path, data=json.dumps(obj).encode(), method="POST")
        return json.load(urllib.request.urlopen(req, timeout=30))

    try:
        h = json.load(urllib.request.urlopen(f"{base}/healthz", timeout=30))
        assert h == {"ok": True, "n_users": N_USERS, "m_items": M_ITEMS, "model": "lgn"}

        one = json.load(urllib.request.urlopen(f"{base}/recommend?user=3&k=5", timeout=30))
        want_ids, want_sc = rec.recommend([3], k=5)
        assert one["user"] == 3 and one["items"] == want_ids[0].tolist()
        np.testing.assert_allclose(one["scores"], want_sc[0], atol=1e-5)

        batch = post("/recommend", {"users": [1, 7], "k": 4})
        want_ids, _ = rec.recommend([1, 7], k=4)
        assert [r["user"] for r in batch] == [1, 7]
        assert [r["items"] for r in batch] == want_ids.tolist()

        for bad in (
            f"{base}/recommend?user=9999",
            f"{base}/recommend?user=x",
            f"{base}/recommend?k=3",
            f"{base}/recommend?user=1&k=999",
        ):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(bad, timeout=30)
            assert e.value.code == 400, bad
        for path, obj in (("/recommend", {"users": []}), ("/recommend", {"users": [-1]}),
                          ("/recommend", {"users": ["x"]}), ("/recommend", {"users": "12"}),
                          ("/recommend", {"users": [1], "k": "x"}),
                          ("/recommend", {"users": [1], "k": 999}), ("/recommend", [1]),
                          ("/reload", {})):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(path, obj)
            assert e.value.code == 400, (path, obj)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/nope", {})
        assert e.value.code == 404

        before = rec.recommend([5], k=5)[0]
        assert post("/reload", {"ckpt": str(ck)}) == {"ok": True}
        after = rec.recommend([5], k=5)[0]
        assert not np.array_equal(before, after)
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/reload", {"ckpt": str(ck) + ".missing"})
        assert e.value.code == 500
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_cuda_is_the_default_device(data):
    if torch.cuda.is_available():
        pytest.skip("this case checks a machine without CUDA")
    _, td = data
    cfg = Config(**_config("lgn"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Recommender(build_model("lgn", cfg, td.graph), td, cfg, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Recommender(build_model("lgn", cfg, td.graph), td, cfg, None, device="cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import furusato_recommend_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "names = sorted(sys.modules)\n"
        "assert 'furusato_recommend_tpu_torch.serve' in names\n"
        "bad = [n for n in names if n == 'jax' or n.startswith(('jax.', 'jaxlib'))\n"
        "       or n == 'furusato_recommend_tpu' or n.startswith('furusato_recommend_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in names if n.startswith('furusato_recommend_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 18
