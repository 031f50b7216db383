"""The serving tier's two programs as the port runs them (``serve.py``): the
refresh, and the request padded to its power-of-two tile; on the CPU, which
never captures, both run eagerly through the code a CUDA graph records.

- the padded request path against the JAX package's ``Recommender.recommend``
  (itself padded, one jitted program a tile and k) for n in {1, 7, 8, 9, 33}
  users and k in {10, 20, 200}, train exclusion on and off, inference edges
  on and off, for lgn, textsage and sasrec at float32 on a hub-free JAX graph
  (the JAX text hub off): scores within rtol 1e-5 (atol 1e-5 of the largest), ids equal
  wherever neighbouring scores part by more than 1e-5 of the row's largest
  (``_ids_held``: the two sum each dot product in other orders); lgn
  at the bfloat16 default on the JAX package's default graph: scores within
  rtol 2e-2; every answer also bit-equal to the plain top-k of the port's own
  embeddings at the padded tile, and at the request's users alone ids equal
  and scores within rtol 1e-6 (the padding rows leak nothing; the CPU's
  matrix product rounds a row by the batch it is in);
- ``refresh`` after the parameters move, against the JAX ``refresh``;
- ``reload_checkpoint`` and HTTP ``POST /reload`` twice, each answer against
  the JAX Recommender refreshed to the same parameters;
- what decides a recapture on the card (``read_tensors``: a replaced
  parameter or kept tensor is seen, an in-place write is not), the tiles
  (``request_tile``), the CPU never capturing, and the lock that every call
  takes.

The card's replays are held against its eager refreshes and requests in
``tests/test_torch_kernels.py`` (marked ``cuda``) and ``chip_smoke.py``'s
phases 4-5, 9, 13-15 and 20.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data import sequence as jseq
from furusato_recommend_tpu.data.features import synthetic_features as jfeatures
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.serve import Recommender as JRecommender
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.core.checkpoint import save_checkpoint
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data import sequence as tseq
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.ops.streaming_topk import masked_topk_reference
from furusato_recommend_tpu_torch.serve import MIN_TILE, Recommender, make_server, read_tensors, request_tile

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 72, 230, 16
SIZES = (1, 7, 8, 9, 33)
KS = (10, 20, 200)
FEATURES = dict(user_feature="nwt", item_feature="nwt", num_neighbors=3)


def _hub_free(u, i, ds):
    return jbuild_graph(u, i, ds.test_user, ds.test_item, ds.n_users, ds.m_items, hub_count=0, dst_hub_count=0)


@pytest.fixture(scope="module")
def data():
    """{hub_free: (jax dataset, port dataset)}, both with train + test
    inference edges."""
    out = {}
    for hub_free in (True, False):
        base = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=7, seed=6)
        inf_u = np.concatenate([base.train_user, base.test_user])
        inf_i = np.concatenate([base.train_item, base.test_item])
        jd = dataclasses.replace(base, inference_user=inf_u, inference_item=inf_i)
        if hub_free:
            jd = dataclasses.replace(jd, _graph=_hub_free(base.train_user, base.train_item, base),
                                     _inference_graph=_hub_free(inf_u, inf_i, base))
        td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=7, seed=6)
        out[hub_free] = (jd, dataclasses.replace(td, inference_user=inf_u, inference_item=inf_i))
    return out


def _fields(name, cdt):
    kw = dict(model=name, latent_dim=DIM, n_layers=2, compute_dtype=cdt)
    if name != "lgn":
        kw.update(FEATURES)
    return kw


def _models(data, name, cdt="float32"):
    """(JAX dataset, port dataset, JAX model, port model, config fields,
    JAX parameters as numpy)."""
    jd, td = data[cdt == "float32"]
    kw = _fields(name, cdt)
    jin, tin = {}, {}
    if name != "lgn":
        jin["features"] = jfeatures(jd, JConfig(**kw), seed=1)
        tin["features"] = synthetic_features(td, Config(**kw), seed=1)
    if name == "sasrec":
        jin["sequences"], tin["sequences"] = jseq.build_sequences(jd), tseq.build_sequences(td)
    jm = jbuild_model(name, JConfig(**kw), jd.graph, **jin)
    tm = build_model(name, Config(**kw), td.graph, **tin)
    if name == "lgn":
        rng = np.random.default_rng(2)
        p = {"user_emb": (0.1 * rng.standard_normal((N_USERS, DIM))).astype(np.float32),
             "item_emb": (0.1 * rng.standard_normal((M_ITEMS, DIM))).astype(np.float32)}
    else:
        p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jd, td, jm, tm, kw, p


def _pair(data, name, cdt="float32", **kw):
    jd, td, jm, tm, fields, p = _models(data, name, cdt)
    jrec = JRecommender(jm, jd, JConfig(**fields), jax.tree_util.tree_map(jnp.asarray, p), **kw)
    trec = Recommender(tm, td, Config(**fields), p, device="cpu", **kw)
    return jrec, trec, p


def _users(n, seed=0):
    return np.random.default_rng(seed + n).choice(N_USERS, size=n, replace=False)


def _plain(trec, users, k):
    """The plain top-k of the port's embeddings at these users alone."""
    mask = trec._mask
    scores, ids = masked_topk_reference(
        trec._user_emb, trec._item_emb, torch.from_numpy(users), k,
        None if mask is None else mask.indptr, None if mask is None else mask.indices,
        sigmoid=trec.model.score_sigmoid)
    return ids.numpy(), scores.numpy()


def _held(jrec, trec, users, k, rtol=1e-5, ids_equal=True):
    tid, tsc = trec.recommend(users, k=k)
    assert tid.shape == tsc.shape == (len(users), k) and tid.dtype == np.int64 and tsc.dtype == np.float32
    # the plain top-k of the padded tile, bit for bit, and of the users alone
    # (the CPU's matrix product rounds a row by the batch it is in)
    tile = np.zeros(request_tile(len(users)), dtype=np.int64)
    tile[: len(users)] = users
    pid, psc = _plain(trec, tile, k)
    np.testing.assert_array_equal(tid, pid[: len(users)])
    np.testing.assert_array_equal(tsc, psc[: len(users)])
    pid, psc = _plain(trec, users, k)
    np.testing.assert_array_equal(tid, pid)
    np.testing.assert_allclose(tsc, psc, rtol=1e-6, atol=1e-7)
    jid, jsc = (np.asarray(x) for x in jrec.recommend(users, k=k))
    np.testing.assert_allclose(tsc, jsc, rtol=rtol, atol=1e-5 * np.abs(jsc).max())
    if ids_equal:
        _ids_held(tid, jid, jsc)


def _ids_held(got, want, values, rel=1e-5):
    """Ids equal wherever the JAX package's neighbouring scores differ by
    more than ``rel`` of the row's largest magnitude: the two sum a dot
    product in other orders, so a pair nearer than that may swap (the last
    rank compares with its left neighbour alone)."""
    tol = rel * np.abs(values).max(axis=1, keepdims=True)
    gap = np.abs(np.diff(values, axis=1)) > tol
    sep = np.ones(values.shape, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(got[sep], want[sep])
    assert sep.mean() > 0.9, sep.mean()


@pytest.mark.parametrize("exclude", [True, False])
@pytest.mark.parametrize("inference", [True, False])
@pytest.mark.parametrize("name", ["lgn", "textsage", "sasrec"])
def test_padded_requests_match_jax(data, name, inference, exclude, monkeypatch):
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
    jrec, trec, _ = _pair(data, name, use_inference_edges=inference, exclude_train=exclude)
    for n in SIZES:
        for k in KS:
            _held(jrec, trec, _users(n), k)


def test_padded_requests_match_jax_at_bfloat16(data):
    """lgn at the bfloat16 default on the JAX package's default graph (its
    hub blocks): both round the SpMM operands to bfloat16, the JAX package
    also each product; scores within rtol 2e-2, ids where scores part."""
    jrec, trec, _ = _pair(data, "lgn", "bfloat16")
    for n in SIZES:
        for k in KS:
            _held(jrec, trec, _users(n), k, rtol=2e-2, ids_equal=False)


@pytest.mark.parametrize("name", ["lgn", "textsage"])
def test_refresh_after_the_parameters_move_matches_jax(data, name, monkeypatch):
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
    jrec, trec, p = _pair(data, name)
    users = _users(9)
    before = trec.recommend(users, k=10)
    moved = _moved(p, 5)
    trec.refresh(moved)
    jrec.refresh(jax.tree_util.tree_map(jnp.asarray, moved))
    for k in KS:
        _held(jrec, trec, users, k)
    assert not np.array_equal(before[1], trec.recommend(users, k=10)[1])


def _flat(tree, prefix=""):
    """name -> leaf of a nested parameter dict (list entries by index)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def _nest_like(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _nest_like(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_nest_like(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


def _moved(p, seed):
    rng = np.random.default_rng(seed)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype) for k, v in _flat(p).items()}
    return _nest_like(p, flat)


def test_reload_checkpoint_and_http_reload_twice(data, tmp_path):
    jrec, trec, p = _pair(data, "lgn")
    fields = _fields("lgn", "float32")
    users = _users(33)
    ckpts = []
    for i in range(3):
        ckpts.append(tmp_path / f"m{i}.npz")
        save_checkpoint(ckpts[-1], _moved(p, 10 + i), Config(**fields))
    trec.reload_checkpoint(str(ckpts[0]))
    jrec.refresh(jax.tree_util.tree_map(jnp.asarray, _moved(p, 10)))
    _held(jrec, trec, users, 20)
    srv = make_server(trec, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for i, ck in enumerate(ckpts[1:], start=11):
            req = urllib.request.Request(f"{base}/reload", data=json.dumps({"ckpt": str(ck)}).encode(),
                                         method="POST")
            assert json.load(urllib.request.urlopen(req, timeout=30)) == {"ok": True}
            jrec.refresh(jax.tree_util.tree_map(jnp.asarray, _moved(p, i)))
            _held(jrec, trec, users, 20)
            req = urllib.request.Request(f"{base}/recommend", data=json.dumps({"users": users.tolist(),
                                                                                "k": 10}).encode(), method="POST")
            got = json.load(urllib.request.urlopen(req, timeout=30))
            want_ids, _ = jrec.recommend(users, k=10)
            assert [r["items"] for r in got] == np.asarray(want_ids).tolist()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


@pytest.mark.parametrize("n,tile", [(0, 8), (1, 8), (7, 8), (8, 8), (9, 16), (33, 64), (64, 64), (65, 128),
                                    (513, 1024), (50_000, 65_536)])
def test_request_tiles_are_the_jax_packages(n, tile):
    assert request_tile(n) == tile == max(MIN_TILE, 1 << (n - 1).bit_length())


def test_the_cpu_never_captures_and_answers_repeat(data):
    _, trec, _ = _pair(data, "lgn")
    users = _users(9)
    first = trec.recommend(users, k=20)
    trec.refresh()
    again = trec.recommend(users, k=20)
    assert not trec.captured and trec.refresh_graph is None and trec.requests == {}
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    ids, scores = trec.recommend([], k=5)  # an empty request pads to one tile
    assert ids.shape == scores.shape == (0, 5)


@pytest.mark.parametrize("name", ["lgn", "textsage"])
def test_read_tensors_sees_a_replaced_tensor_and_not_an_in_place_write(data, name, monkeypatch):
    """What a captured refresh is checked against: a parameter, buffer or
    kept tensor replaced (another object) changes the list, a write in place
    does not; LightGCN's kept adjacency, rebuilt for another graph, is seen."""
    monkeypatch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
    _, trec, _ = _pair(data, name)
    graph = trec._prop_graph
    reads = read_tensors(trec.model, graph)
    assert len(reads) == len({id(t) for t in reads})
    params = list(trec.model.parameters())
    assert all(any(p is t for t in reads) for p in params)
    assert any(t is graph.user_pos.indptr for t in reads)
    with torch.no_grad():
        params[0].add_(1.0)
    again = read_tensors(trec.model, graph)
    assert len(again) == len(reads) and all(a is b for a, b in zip(again, reads))
    if name == "lgn":
        kept = trec.model._adj
        assert all(any(x is t for t in reads) for x in kept[1:])
        trec.model.propagate(tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=7, seed=6).graph)
        assert trec.model._adj is not kept
        assert not all(a is b for a, b in zip(read_tensors(trec.model, graph), reads))
    name, param = next(iter(trec.model.named_parameters()))
    owner, _, attr = name.rpartition(".")
    setattr(trec.model.get_submodule(owner), attr, torch.nn.Parameter(param.detach().clone()))
    now = read_tensors(trec.model, graph)
    assert not (len(now) == len(reads) and all(a is b for a, b in zip(now, reads)))


def test_every_call_takes_the_recommenders_lock(data):
    """Requests from several threads and a refresh among them: each answer
    equal to the answer of one thread alone (the static buffers a replay
    uses are shared, so the lock serialises the calls)."""
    _, trec, _ = _pair(data, "lgn")
    want = {n: trec.recommend(_users(n), k=10) for n in SIZES}
    got, errors = {}, []

    def ask(n):
        try:
            for _ in range(5):
                got[n] = trec.recommend(_users(n), k=10)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=ask, args=(n,)) for n in SIZES]
    threads.append(threading.Thread(target=trec.refresh))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    for n in SIZES:
        for a, b in zip(got[n], want[n]):
            np.testing.assert_array_equal(a, b)
    assert isinstance(trec.lock, type(threading.RLock()))
