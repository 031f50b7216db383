"""Port vs JAX package: the two-stage ranker on the CPU — ``rank/features.py``,
``rank/pipeline.py`` (candidate dumps, groups, the re-rank evaluation),
``rank/ranker.py`` (``NeuralRanker``) and the ``tools`` subcommands
``dump-candidates``, ``train-ranker`` and ``rerank-eval``.

Sizes as ``tests/test_rank.py``: ``synthetic_dataset(100, 120, 10, seed=3)``,
``synthetic_features(seed=2)``, rankers of emb 8 and hidden (64, 32).

Tolerances:

- ``make_X_ids``, the groups and every host numpy helper: bit-equal;
- ``dump_candidates`` in float32 over a hub-free graph: ids equal; at the
  bfloat16 default (JAX's hub-dense blocks, bf16 operands in both): the
  port's scores of both packages' ids within rtol 2e-2, atol 2e-3 x the
  largest score, ids equal wherever the port's neighbouring scores differ by
  more than 2e-2 relative;
- the ranker with JAX's parameters (``convert.ranker_params_from_jax``):
  scores and losses within rtol 1e-5, gradients within rtol 1e-4 (atol 1e-5 x the largest), parameters
  after three Adam steps on JAX's batches within rtol 1e-4; ``calibrate``'s
  choice, ``rank``'s ids and ``rerank_eval``'s metrics equal;
- the tools on shared checkpoints: the dump's ``.npy`` and the re-rank JSON
  equal to the JAX package's.

JAX's training is held by its own ``value_and_grad(group_loss)`` and
``optax.adam`` steps on the same batch indices, never the jitted ``fit``.
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from furusato_recommend_tpu import tools as jtools
from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.core.checkpoint import save_checkpoint as jsave_checkpoint
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data.features import load_reference_features as jload_features
from furusato_recommend_tpu.data.features import synthetic_features as jfeatures
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.rank import features as jrf
from furusato_recommend_tpu.rank import pipeline as jpipe
from furusato_recommend_tpu.rank.ranker import NeuralRanker as JRanker
from furusato_recommend_tpu_torch import tools as ttools
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import (
    adam_state_from_jax,
    params_from_jax,
    ranker_params_from_jax,
    ranker_params_to_numpy,
)
from furusato_recommend_tpu_torch.core.checkpoint import load_checkpoint
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.artifacts import write_reference_features, write_text_dataset
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.ops import scatter as sc
from furusato_recommend_tpu_torch.rank import features as trf
from furusato_recommend_tpu_torch.rank import pipeline as tpipe
from furusato_recommend_tpu_torch.rank.ranker import NeuralRanker, RankGroups, epoch_batches

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_USERS, M_ITEMS, DIM, K_CAND = 100, 120, 16, 50
EMB, HIDDEN = 8, (64, 32)
RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    """JAX dataset (default graph), its hub-free graph, the port's dataset,
    and both packages' features from one seed."""
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=10, seed=3)
    hub_free = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, N_USERS, M_ITEMS,
                            hub_count=0, dst_hub_count=0)
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=10, seed=3)
    jf = jfeatures(jd, JConfig(), seed=2)
    tf = synthetic_features(td, Config(), seed=2)
    return {"jd": jd, "jd_f32": dataclasses.replace(jd, _graph=hub_free), "td": td, "jf": jf, "tf": tf}


def _models(data, name, dtype):
    kw = dict(model=name, latent_dim=DIM, n_layers=2, compute_dtype=dtype)
    jd = data["jd_f32"] if dtype == "float32" else data["jd"]
    if name == "textsage":
        kw.update(num_neighbors=3, user_feature="nwt", item_feature="nwt")
        jm = jbuild_model(name, JConfig(**kw), jd.graph, features=jfeatures(jd, JConfig(**kw), seed=1))
        tm = build_model(name, Config(**kw), data["td"].graph,
                         features=synthetic_features(data["td"], Config(**kw), seed=1))
    else:
        jm = jbuild_model(name, JConfig(**kw), jd.graph)
        tm = build_model(name, Config(**kw), data["td"].graph)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params_from_jax(params, tm)
    return jd, jm, tm, params


def _dumps(data, name, dtype):
    """(JAX's dump, the port's, the port's model) at k = 50, batches of 64."""
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "float32":
            mp.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)  # the text bags without the TPU's hub block
        jd, jm, tm, params = _models(data, name, dtype)
        want = jpipe.dump_candidates(jm, jax.tree_util.tree_map(jnp.asarray, params), jd.graph,
                                     k=K_CAND, batch=64)
    got = tpipe.dump_candidates(tm, data["td"].graph, k=K_CAND, batch=64, device="cpu")
    return want, got, tm


@pytest.fixture(scope="module")
def cands(data):
    """Two retrievers' float32 dumps (mf and lgn) as JAX made them, each
    user's top 30 of 50."""
    return [_dumps(data, name, "float32")[0][:, :30] for name in ("mf", "lgn")]


# ---- rank/features.py ----
def test_make_X_ids_bit_equal(data):
    assert trf.rank_feature_spec(data["tf"]) == trf.RankFeatureSpec(
        **dataclasses.asdict(jrf.rank_feature_spec(data["jf"])))
    rng = np.random.default_rng(0)
    users = rng.integers(0, N_USERS, (7, 1))
    items = rng.integers(0, M_ITEMS, (7, 13))
    jc, jn = jrf.make_X_ids(data["jf"], jnp.asarray(users), jnp.asarray(items))
    tc, tn = trf.make_X_ids(data["tf"], torch.from_numpy(users), torch.from_numpy(items))
    assert tc.dtype == torch.int32 and tn.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


# ---- rank/pipeline.py: candidate dumps ----
@pytest.mark.parametrize("name", ["mf", "lgn", "textsage"])
def test_dump_candidates_float32_matches_jax(data, name):
    want, got, _ = _dumps(data, name, "float32")
    assert got.shape == (N_USERS, K_CAND) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    pos = data["td"].all_pos()
    for u in range(N_USERS):
        assert len(set(got[u].tolist())) == K_CAND and not set(got[u].tolist()) & set(pos[u].tolist())


@pytest.mark.parametrize("name", ["lgn", "textsage"])
def test_dump_candidates_bfloat16_matches_jax(data, name):
    want, got, tm = _dumps(data, name, "bfloat16")
    with torch.no_grad():
        u, i = tm.propagate(data["td"].graph)
    s = (u.float() @ i.float().T).numpy()
    for row, items in enumerate(data["td"].all_pos()):
        s[row, items] = -1024.0
    sv, rv = np.take_along_axis(s, got, axis=1), np.take_along_axis(s, want, axis=1)
    np.testing.assert_allclose(sv, np.sort(sv, axis=1)[:, ::-1])  # the port's own order
    np.testing.assert_allclose(np.sort(sv, axis=1), np.sort(rv, axis=1), rtol=2e-2, atol=2e-3 * np.abs(s).max())
    gap = np.abs(np.diff(sv, axis=1)) > 2e-2 * np.abs(sv[:, 1:])
    sep = np.ones(got.shape, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(got[sep], want[sep])


# ---- rank/pipeline.py: host numpy ----
def test_dedup_compact_and_aux_bit_equal():
    rng = np.random.default_rng(1)
    cand = rng.integers(0, 30, (40, 25))
    valid = rng.random((40, 25)) < 0.8
    keep = tpipe._dedup_rows(cand, valid)
    np.testing.assert_array_equal(keep, jpipe._dedup_rows(cand, valid))
    aux = rng.random((40, 25, 3)).astype(np.float32)
    tk, touts = tpipe._compact_rows(keep, cand, aux, width=16)
    jk, jouts = jpipe._compact_rows(keep, cand, aux, width=16)
    np.testing.assert_array_equal(tk, jk)
    for a, b in zip(touts, jouts):
        np.testing.assert_array_equal(a, b)
    dumps = [np.stack([rng.choice(50, 8, replace=False) for _ in range(40)]) for _ in range(2)]
    wide = rng.integers(0, 50, (40, 12))
    np.testing.assert_array_equal(tpipe.retriever_rank_aux(dumps, wide, 50),
                                  jpipe.retriever_rank_aux(dumps, wide, 50))


def _holdout(td, form):
    held = td.test_dict()
    if form == "dict":
        return held
    return (np.concatenate([np.full(len(v), u, np.int64) for u, v in held.items()]),
            np.concatenate([np.asarray(v, np.int64) for v in held.values()]))


def _assert_groups_equal(tg: RankGroups, jg):
    for f in ("users", "items", "labels", "mask", "aux"):
        a, b = getattr(tg, f), getattr(jg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("train_pos", [True, False])
@pytest.mark.parametrize("form", ["dict", "edges"])
def test_build_rank_groups_bit_equal(data, cands, form, train_pos, aux):
    kw = dict(include_train_positives=train_pos, max_candidates=64, with_retriever_aux=aux)
    tg = tpipe.build_rank_groups(data["td"], cands, holdout=_holdout(data["td"], form), **kw)
    jg = jpipe.build_rank_groups(data["jd"], cands, holdout=_holdout(data["td"], form), **kw)
    _assert_groups_equal(tg, jg)
    assert len(tg) > 10 and bool((~tg.mask).any())  # padded slots in some group


# ---- rank/ranker.py with JAX's parameters ----
@pytest.fixture(scope="module")
def rankers(data, cands):
    """Per aux width 0 / 2: (JAX ranker, its params, JAX groups, the port's
    ranker with those params, the port's groups) over both dumps, up to 64
    candidates a group (padded slots where the union is smaller); the aux
    groups are candidates-only, as the aux ranker trains."""
    out = {}
    held = data["td"].test_dict()
    for aux in (0, 2 * len(cands)):
        kw = dict(max_candidates=64)
        if aux:
            kw.update(include_train_positives=False, with_retriever_aux=True)
        jg = jpipe.build_rank_groups(data["jd"], cands, holdout=held, **kw)
        tg = tpipe.build_rank_groups(data["td"], cands, holdout=held, **kw)
        jr = JRanker(data["jf"], emb_dim=EMB, hidden=HIDDEN, aux_dim=aux)
        jp = jr.init(jax.random.PRNGKey(aux + 1))
        if aux:  # a non-zero aux head
            jp["wa"] = jnp.asarray([0.7, -0.4, 0.5, 0.2])
        tr = NeuralRanker(data["tf"], emb_dim=EMB, hidden=HIDDEN, aux_dim=aux)
        ranker_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tr)
        assert bool((~tg.mask).any())
        out[aux] = (jr, jp, jg, tr, tg)
    return out


_JITTED = {}


def _jitted(jr, kind, **kw):
    """JAX's ``group_loss``, its ``value_and_grad``, or ``rank`` with ``kw``,
    jitted once per ranker, objective and keywords (the eager ops compile one
    by one and are the slow part of this file)."""
    key = (id(jr), jr.objective, kind, tuple(sorted(kw.items())))
    if key not in _JITTED:
        # a new function each (jit would reuse a trace of the bound method,
        # whose objective is read when it is traced)
        fn = {"loss": lambda p, g: jr.group_loss(p, g),
              "grad": jax.value_and_grad(lambda p, g: jr.group_loss(p, g)),
              "rank": lambda p, u, c, m, a: jr.rank(p, u, c, mask=m, aux=a, **kw)}[kind]
        _JITTED[key] = jax.jit(fn)
    return _JITTED[key]


def _jax_batch(jg, idx):
    return jax.tree_util.tree_map(lambda a: a[jnp.asarray(idx)], jg)


def _resized(g, batch_groups, seed=5):
    """JAX's epoch batch order: resize(permutation(key, G), nb * batch_groups)."""
    perm = jax.random.permutation(jax.random.PRNGKey(seed), g)
    nb = max(g // batch_groups, 1)
    return np.asarray(jnp.resize(perm, (nb * batch_groups,)).reshape(nb, batch_groups))


@pytest.mark.parametrize("aux", [0, 4])
def test_score_matches_jax(rankers, aux):
    jr, jp, jg, tr, tg = rankers[aux]
    want = np.asarray(jr.score(jp, jg.users[:, None], jg.items, aux=jg.aux))
    with torch.no_grad():
        got = tr.score(tg.users[:, None], tg.items, aux=tg.aux).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    if aux:
        with pytest.raises(ValueError, match="aux columns"):
            tr.score(tg.users[:, None], tg.items)


@pytest.mark.parametrize("batch", ["all", "repeated"])
@pytest.mark.parametrize("objective", ["lambdarank", "pairwise"])
@pytest.mark.parametrize("aux", [0, 4])
def test_group_loss_matches_jax(rankers, aux, objective, batch):
    """Every group, or one batch of 256 indices over fewer groups (JAX's
    resize repeats the permutation); groups with padded slots throughout."""
    jr, jp, jg, tr, tg = rankers[aux]
    jr.objective = tr.objective = objective
    try:
        if batch == "repeated":
            idx = _resized(len(tg), 256)[0]
            assert len(tg) < 256 and len(np.unique(idx)) == len(tg)
            jg, tg = _jax_batch(jg, idx), tg.select(torch.from_numpy(idx))
        want = float(_jitted(jr, "loss")(jp, jg))
        with torch.no_grad():
            got = float(tr.group_loss(tg))
    finally:
        jr.objective = tr.objective = "lambdarank"
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("objective", ["lambdarank", "pairwise"])
@pytest.mark.parametrize("aux", [0, 4])
def test_gradients_match_jax(rankers, monkeypatch, aux, objective):
    """Every parameter's gradient; ``cat_emb``'s comes from one
    ``scatter_add_rows`` call (``table_gather``'s backward)."""
    jr, jp, jg, tr, tg = rankers[aux]
    calls = []
    real = sc.scatter_add_rows
    monkeypatch.setattr(sc, "scatter_add_rows", lambda *a: calls.append(a[1].shape) or real(*a))
    jr.objective = tr.objective = objective
    try:
        want = _jitted(jr, "grad")(jp, jg)[1]
        tr.zero_grad(set_to_none=True)
        tr.group_loss(tg).backward()
    finally:
        jr.objective = tr.objective = "lambdarank"
    spec = tr.spec
    assert calls == [(tg.items.numel() * (spec.n_item_cat + spec.n_user_cat), EMB)]
    # b3's gradient is 0 up to rounding (a pair's loss takes score differences)
    atol = 1e-5 * max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, p in tr.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]), rtol=1e-4, atol=atol, err_msg=name)


def _jax_steps(jr, jp, jg, batches, opt, state):
    """JAX's Adam steps; returns (params, state, losses, grads of each step)."""
    vg = _jitted(jr, "grad")
    losses, grads = [], []
    for idx in batches:
        loss, g = vg(jp, _jax_batch(jg, idx))
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        losses.append(float(loss))
        grads.append(g)
    return jp, state, losses, grads


def _assert_params_close(tr, jp, grads, lr):
    """Parameters within rtol 1e-4 of JAX's (of the value, and of the
    steps' movement). An element whose gradient was
    within rounding of 0 at some step in either package (at most 1e-5 of that
    step's largest, and not exactly 0 in both: b3, a ReLU unit active on every
    row or gated at a rounding-level input, a constant aux column; the loss
    takes score differences) takes Adam's +-lr on the sign of its rounding:
    within 2 lr a step. ``grads``: JAX's of each step; the port's last step's
    are the parameters' ``.grad``."""
    noise = {name: np.zeros(np.shape(jp[name]), bool) for name in jp}
    for i, g in enumerate(grads):
        top = max(float(np.abs(np.asarray(v)).max()) for v in g.values())
        for name, p in tr.named_parameters():
            a = np.abs(np.asarray(g[name]))
            b = np.abs(p.grad.numpy()) if i == len(grads) - 1 and p.grad is not None else a
            noise[name] |= (np.minimum(a, b) <= 1e-5 * top) & (np.maximum(a, b) > 0)
    total = sum(n.size for n in noise.values())
    assert sum(int(n.sum()) for n in noise.values()) <= 0.05 * total
    for name, p in tr.named_parameters():
        got, want = p.detach().numpy(), np.asarray(jp[name])
        # rtol 1e-4 of the value and of the steps' movement (at most lr each)
        ok = np.abs(got - want) <= 1e-6 + 1e-4 * (np.abs(want) + lr * len(grads))
        assert ok[~noise[name]].all(), (name, got[~ok & ~noise[name]], want[~ok & ~noise[name]])
        assert (np.abs(got - want) <= 2 * lr * len(grads))[noise[name]].all(), name


def _held_adam_steps(jr, jp, jg, tr, tg, batches, lr):
    """Adam steps of both packages on JAX's batch indices, the port's each
    from JAX's parameters and moments before it; returns JAX's parameters."""
    jopt = optax.adam(lr)
    state = jopt.init(jp)
    opt = tr.optimizer(lr)
    for idx in batches:
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tr)
        adam = state[0]
        if int(adam.count):
            adam_state_from_jax(int(adam.count), adam.mu, adam.nu, opt, tr)
        jp, state, (jloss,), grads = _jax_steps(jr, jp, jg, [idx], jopt, state)
        np.testing.assert_allclose(float(tr.train_step(tg, torch.from_numpy(idx), opt)), jloss, rtol=RTOL)
        _assert_params_close(tr, jp, grads, lr)
    return jp


@pytest.mark.parametrize("batch_groups", [32, 256])
@pytest.mark.parametrize("aux", [0, 4])
def test_fit_steps_match_jax(rankers, aux, batch_groups):
    """Three Adam steps on JAX's batch indices (G > batch_groups: the
    permutation cut to whole batches; G < 256: repeated to fill one), each
    from JAX's parameters and Adam moments before it."""
    jr, jp, jg, tr0, tg = rankers[aux]
    tr = NeuralRanker(tr0.features, emb_dim=EMB, hidden=HIDDEN, aux_dim=aux)
    batches = np.concatenate([_resized(len(tg), batch_groups, seed=s) for s in (7, 8, 9)])[:3]
    _held_adam_steps(jr, jp, jg, tr, tg, batches, 3e-3)


def test_warm_phase_matches_jax_multi_transform(rankers):
    """Two warm steps (Adam at 100 x lr on ``wa`` alone, every other
    parameter untouched), then two joint steps with a fresh Adam."""
    jr, jp, jg, tr0, tg = rankers[4]
    tr = NeuralRanker(tr0.features, emb_dim=EMB, hidden=HIDDEN, aux_dim=4)
    tr.load_state_dict(tr0.state_dict())
    lr = 1e-3
    warm = optax.multi_transform({"wa": optax.adam(100 * lr), "frozen": optax.set_to_zero()},
                                 {k: ("wa" if k == "wa" else "frozen") for k in jp})
    batches = _resized(len(tg), 16)[:4]
    jp1, _, _, grads = _jax_steps(jr, jp, jg, batches[:2], warm, warm.init(jp))
    before = {k: p.detach().clone() for k, p in tr.named_parameters()}
    opt = tr.optimizer(lr, warm=True)
    assert [p for group in opt.param_groups for p in group["params"]] == [tr.wa]
    for idx in batches[:2]:
        tr.train_step(tg, torch.from_numpy(idx), opt)
    for name, p in tr.named_parameters():
        if name != "wa":
            assert torch.equal(p, before[name]), name
    _assert_params_close(tr, jp1, grads, 100 * lr)
    _held_adam_steps(jr, jp1, jg, tr, tg, batches[2:], lr)


@pytest.mark.parametrize("g,batch_groups", [(100, 32), (100, 256), (96, 32)])
def test_epoch_batches_are_jnp_resize(g, batch_groups):
    perm = np.random.default_rng(g).permutation(g)
    nb = max(g // batch_groups, 1)
    want = np.asarray(jnp.resize(jnp.asarray(perm), (nb * batch_groups,)).reshape(nb, batch_groups))
    np.testing.assert_array_equal(epoch_batches(torch.from_numpy(perm), batch_groups).numpy(), want)


def test_fit_lowers_the_loss(rankers):
    """``fit`` end to end (fresh parameters from its seed): the loss falls."""
    _, _, _, tr0, tg = rankers[0]
    tr = NeuralRanker(tr0.features, emb_dim=EMB, hidden=HIDDEN)
    tr.init_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        l0 = float(tr.group_loss(tg))
    losses = tr.fit(tg, epochs=25, batch_groups=64, lr=3e-3, seed=0)
    with torch.no_grad():
        l1 = float(tr.group_loss(tg))
    assert losses.shape == (25,) and l1 < 0.9 * l0, (l0, l1)


def test_calibrate_matches_jax(rankers):
    jr, jp, jg, tr, tg = rankers[4]
    want = jr.calibrate(jp, jg, k=10)
    cal, (beta, gamma, val_r) = tr.calibrate(tg, k=10)
    b, g, r = (float(x) for x in np.asarray(want["_calibration"]))
    assert (np.float32(beta), np.float32(gamma)) == (b, g) and (beta, gamma) != (1.0, 1.0)
    np.testing.assert_allclose(val_r, r, rtol=1e-6)
    got = ranker_params_to_numpy(cal)
    assert set(got) == set(want) - {"_calibration"}
    for name, v in got.items():
        np.testing.assert_allclose(v, np.asarray(want[name]), rtol=RTOL, atol=1e-7, err_msg=name)
    # the JAX leaf round-trips through the converters
    again = NeuralRanker(tr.features, emb_dim=EMB, hidden=HIDDEN, aux_dim=4)
    leaf = ranker_params_from_jax(jax.tree_util.tree_map(np.asarray, want), again)
    np.testing.assert_allclose(leaf, (b, g, r), rtol=1e-6)
    np.testing.assert_allclose(ranker_params_to_numpy(again, leaf)["_calibration"], np.asarray(want["_calibration"]))
    with pytest.raises(ValueError, match="aux ranker"):
        rankers[0][3].calibrate(rankers[0][4])


@pytest.mark.parametrize("k", [10, 80])
@pytest.mark.parametrize("chunk", [2048, 16])
@pytest.mark.parametrize("aux", [0, 4])
def test_rank_matches_jax(rankers, aux, chunk, k):
    """Ids equal, untiled and in tiles of 16 users; k = 80 > C gives C
    columns, -1 at the masked slots."""
    jr, jp, jg, tr, tg = rankers[aux]
    want = np.asarray(_jitted(jr, "rank", k=k, chunk=chunk)(jp, jg.users, jg.items, jg.mask, jg.aux))
    got = tr.rank(tg.users, tg.items, k=k, mask=tg.mask, chunk=chunk, aux=tg.aux).numpy()
    assert got.shape == want.shape == (len(tg), min(k, tg.items.shape[1]))
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() == (k > tg.items.shape[1])


@pytest.mark.parametrize("aux", [0, 4])
def test_rerank_eval_matches_jax(data, cands, rankers, aux):
    jr, jp, jg, tr, tg = rankers[aux]
    held = data["td"].test_dict()
    want = jpipe.rerank_eval(jr, jp, data["jd"], cands, held, k=10, max_candidates=64)
    got = tpipe.rerank_eval(tr, data["td"], cands, held, k=10, max_candidates=64)
    assert got == want and got["rerank_recall@10"] > 0


# ---- tools dump-candidates / train-ranker / rerank-eval ----
def _export_module():
    spec = importlib.util.spec_from_file_location("export_jax_checkpoint", ROOT / "tools" / "export_jax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed_json(text: str) -> dict:
    start = text.index("{\n")
    return json.loads(text[start: text.index("\n}", start) + 2])


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    """A data directory in the reference's layout (``data.artifacts``), a JAX
    mf checkpoint in eighths (exact scores) and a JAX ranker checkpoint with
    a ``_calibration`` leaf, each exported into the port's format."""
    tmp = tmp_path_factory.mktemp("rank_tools")
    data = tmp / "data"
    td = tds.synthetic_dataset(n_users=60, m_items=50, avg_degree=8, seed=4)
    write_text_dataset(td, data)
    write_reference_features(synthetic_features(td, Config(), seed=3), data)
    jcfg = JConfig(model="mf", latent_dim=8, data_path=str(data))
    jd = jds.load_text_dataset(jcfg)
    rng = np.random.default_rng(6)
    params = {"user_emb": jnp.asarray(rng.integers(-4, 5, (jd.n_users, 8)) / 8, jnp.float32),
              "item_emb": jnp.asarray(rng.integers(-4, 5, (jd.m_items, 8)) / 8, jnp.float32)}
    jsave_checkpoint(tmp / "mf.ckpt", {"params": params}, jcfg)
    rcfg = JConfig(data_path=str(data), user_feature="nc", item_feature="nc")
    jr = JRanker(jload_features(rcfg, str(data)))
    rp = jr.init(jax.random.PRNGKey(3))
    rp["_calibration"] = jnp.asarray([1.0, 1.0, 0.5])
    jsave_checkpoint(tmp / "ranker.ckpt", {"params": rp}, rcfg)
    exp = _export_module()
    for name in ("mf", "ranker"):
        exp.main(["--ckpt", str(tmp / f"{name}.ckpt"), "--out", str(tmp / f"{name}_port.ckpt")])
    return {"tmp": tmp, "data": str(data)}


def test_tools_dump_candidates_matches_jax(tool_run, capsys):
    tmp, data = tool_run["tmp"], tool_run["data"]
    capsys.readouterr()
    jtools.main(["dump-candidates", "--ckpt", str(tmp / "mf.ckpt"), "--data_path", data, "--k", "20",
                 "--out", str(tmp / "j_cands.npy")])
    j_out = capsys.readouterr().out
    t = ttools.main(["dump-candidates", "--ckpt", str(tmp / "mf_port.ckpt"), "--data_path", data, "--k", "20",
                     "--out", str(tmp / "t_cands.npy"), "--device", "cpu"])
    t_out = capsys.readouterr().out
    assert t_out.replace("t_cands", "X") == j_out.replace("j_cands", "X")
    got, want = np.load(tmp / "t_cands.npy"), np.load(tmp / "j_cands.npy")
    assert got.dtype == want.dtype and got.shape == (60, 20)
    np.testing.assert_array_equal(got, want)
    assert set(t["seconds"]) == {"load", "dump", "save"} and np.array_equal(t["candidates"], got)


def test_tools_rerank_eval_of_a_jax_ranker_matches_jax(tool_run, capsys):
    tmp, data = tool_run["tmp"], tool_run["data"]
    cands = tmp / "j_cands.npy"
    if not cands.exists():
        jtools.main(["dump-candidates", "--ckpt", str(tmp / "mf.ckpt"), "--data_path", data, "--k", "20",
                     "--out", str(cands)])
    second = tmp / "shifted.npy"
    np.save(second, (np.load(cands) + 7) % 50)
    capsys.readouterr()
    argv = ["rerank-eval", "--candidates", str(cands), str(second), "--data_path", data, "--k", "10"]
    jtools.main([*argv, "--ranker", str(tmp / "ranker.ckpt")])
    want = _printed_json(capsys.readouterr().out)
    t = ttools.main([*argv, "--ranker", str(tmp / "ranker_port.ckpt"), "--device", "cpu"])
    assert _printed_json(capsys.readouterr().out) == want == t["results"]
    assert set(t["seconds"]) == {"load", "rerank"}


def test_tools_train_ranker_writes_what_rerank_eval_reads(tool_run, capsys):
    tmp, data = tool_run["tmp"], tool_run["data"]
    port = ["--data_path", data, "--device", "cpu"]
    ttools.main(["dump-candidates", "--ckpt", str(tmp / "mf_port.ckpt"), "--k", "20",
                 "--out", str(tmp / "c.npy"), *port])
    out = tmp / "trained.ckpt"
    t = ttools.main(["train-ranker", "--candidates", str(tmp / "c.npy"), "--epochs", "1", "--out", str(out), *port])
    printed = capsys.readouterr().out
    assert "[ranker] epoch 0 loss" in printed and printed.endswith(f"wrote {out}\n")
    assert t["losses"].shape == (1,) and np.isfinite(t["losses"]).all() and t["groups"] > 0
    assert set(t["seconds"]) == {"load", "groups", "fit", "save"}
    ck = load_checkpoint(out)
    assert ck["__config__"]["for_lgbm"] and ck["__config__"]["user_feature"] == "nc"
    assert set(ck["params"]) == {"cat_emb", "w1", "b1", "w2", "b2", "w3", "b3", "pu", "pi"}
    r = ttools.main(["rerank-eval", "--candidates", str(tmp / "c.npy"), "--ranker", str(out), *port])
    assert set(r["results"]) == {"rerank_recall@10", "rerank_ndcg@10", "rerank_hr@10"}
    assert all(0.0 <= v <= 1.0 for v in r["results"].values())


def test_rank_imports_no_jax():
    code = (
        "import sys\n"
        "import furusato_recommend_tpu_torch.rank.pipeline, furusato_recommend_tpu_torch.rank.ranker\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'optax'))\n"
        "       or n == 'furusato_recommend_tpu' or n.startswith('furusato_recommend_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
