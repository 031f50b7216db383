"""Port vs JAX package: the sequence model ``sasrec`` (``data/sequence.py``,
``models/sasrec.py``, ``convert.py``'s ``blocks`` / ``item_tower`` lists, the
registry key, the trainer's fresh path, the CLI's sequence inputs and the
server), and every key of the JAX registry built in the port.

Same numpy data in both packages: ``synthetic_dataset(100, 140, avg_degree=8,
seed=7)`` with ``synthetic_features(seed=1)``, the sequences built from it
(bit-equal), the JAX package's initial parameters carried across by
``params_from_jax``; d = 16, L = 2, 8 heads of 2. Each JAX function is
jitted once. Tolerances:

- sequences and the artifact loader: bit-equal;
- float32 forwards, dropout 0: rtol 1e-5, atol 1e-5 (outputs of order 1
  through layer norms and residual sums, as ``test_torch_edge.py``'s
  propagations; only the order of float32 sums differs);
- loss rtol 1e-5; gradients rtol 1e-4, atol 1e-6 of the gradient's largest
  magnitude where it exceeds 1;
- three Adam steps at lr 1e-3: every parameter within 1e-6 + 1e-5 |p|, but
  elements whose two gradients, equal within the gradient tolerance, differ
  by more than 1e-3 of their size (Adam's g / (sqrt(v) + 1e-8) turns that
  into more than 1e-6): those within 2 x lr a step, at most 1 in 100 of the
  parameters (``test_torch_edge.py``'s rule).
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data import sequence as jseq
from furusato_recommend_tpu.data.features import synthetic_features as jfeatures
from furusato_recommend_tpu.models import sasrec as jsasrec
from furusato_recommend_tpu.models.registry import available_models as javailable_models
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_numpy,
    flatten_params,
    params_from_jax,
    params_to_numpy,
)
from furusato_recommend_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data import sequence as tseq
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models import sasrec as tsasrec
from furusato_recommend_tpu_torch.models.registry import SAGE_KEYS, available_models, build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 100, 140, 16
TIGHT = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    jd = jds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=8, seed=7)
    return jd, td


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(jsasrec, "DROPOUT", 0.0)
    monkeypatch.setattr(tsasrec, "DROPOUT", 0.0)


def _kw(**over):
    kw = dict(model="sasrec", latent_dim=DIM, n_layers=2, user_feature="nwt", item_feature="nwt",
              compute_dtype="float32", decay=1e-2, bpr_batch_size=48, eval_user_batch=32, topks=(5, 10))
    kw.update(over)
    return kw


def _both(data, **over):
    """(jax dataset, port dataset, jax model, port model, jax params)."""
    jd, td = data
    kw = _kw(**over)
    jm = jbuild_model("sasrec", JConfig(**kw), jd.graph, features=jfeatures(jd, JConfig(**kw), seed=1),
                      sequences=jseq.build_sequences(jd))
    tm = build_model("sasrec", Config(**kw), td.graph, features=synthetic_features(td, Config(**kw), seed=1),
                     sequences=tseq.build_sequences(td))
    p = jm.init(jax.random.PRNGKey(0))
    params_from_jax(_np(p), tm)
    return jd, td, jm, tm, p


def _seq_equal(got, want):
    assert got.max_len == want.max_len
    assert got.items.dtype == torch.int32 and got.lengths.dtype == torch.int32
    np.testing.assert_array_equal(got.items.numpy(), np.asarray(want.items))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


# ---- sequences ----
@pytest.mark.parametrize("max_len", [50, 5])
@pytest.mark.parametrize("timed", [False, True], ids=["data-order", "timestamps"])
def test_build_sequences_matches_jax(data, max_len, timed):
    """In the data's order or by time (quarters of [0, 1], so that many tie);
    at max_len 5 most users keep only their last items."""
    jd, td = data
    ts = (np.round(np.random.default_rng(3).random(td.train_size) * 4) / 4) if timed else None
    got = tseq.build_sequences(td, max_len=max_len, timestamps=ts)
    _seq_equal(got, jseq.build_sequences(jd, max_len=max_len, timestamps=ts))
    assert (got.lengths.numpy() == np.minimum(np.bincount(td.train_user, minlength=N_USERS), max_len)).all()


@pytest.mark.parametrize("form", ["list", "dict"])
@pytest.mark.parametrize("with_lengths", [False, True], ids=["no-lengths", "lengths"])
def test_load_sequence_artifacts_matches_jax(tmp_path, form, with_lengths):
    """The reference's pickle as a list or a dict (users missing from the
    dict, sequences longer than 50), with and without the .pt lengths (some
    larger than 50, some not the sequence's own), for n_users above and
    below the artifact's."""
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, 90, rng.integers(0, 70)).tolist() for _ in range(30)]
    obj = seqs if form == "list" else {u: s for u, s in enumerate(seqs) if u % 4}
    with open(tmp_path / "train_items_sequence_x.pkl", "wb") as f:
        pickle.dump(obj, f)
    if with_lengths:
        lengths = torch.tensor([len(s) + (u % 3) for u, s in enumerate(seqs)])
        torch.save(lengths, tmp_path / "train_sequence_length_x.pt")
    assert max(len(s) for s in seqs) > 50
    for n_users in (None, 24, 35):
        got = tseq.load_sequence_artifacts(tmp_path, "_x", n_users=n_users)
        _seq_equal(got, jseq.load_sequence_artifacts(str(tmp_path), "_x", n_users=n_users))


def test_user_sequences_move():
    s = tseq.UserSequences(torch.zeros((3, 4), dtype=torch.int32), torch.tensor([0, 2, 4], dtype=torch.int32), 4)
    moved = s.to("cpu")
    assert moved.max_len == 4 and torch.equal(moved.lengths, s.lengths)
    assert tseq.MAX_SEQ_LEN == jseq.MAX_SEQ_LEN == 50


# ---- the model's parts ----
def test_constants_match_jax():
    assert tsasrec.N_HEADS == jsasrec.N_HEADS and tsasrec.DROPOUT == jsasrec.DROPOUT


def test_block_matches_jax(data):
    """One pre-norm block without dropout on [6, 50, 16] rows whose last
    positions are zero (pads), with layer-norm scales and biases that are
    not 1 and 0; forward and the gradients of the rows and parameters."""
    _, _, jm, tm, p = _both(data)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 50, DIM)).astype(np.float32)
    x[:, 40:] = 0.0
    bp = {k: np.asarray(v) for k, v in _np(p)["blocks"][0].items()}
    for k in ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "ffn_b"):
        bp[k] = bp[k] + 0.3 * rng.standard_normal(DIM).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    causal = jnp.tril(jnp.ones((50, 50), bool))

    def jf(q, xx):
        return jnp.sum(jm._block(q, xx, causal, jax.random.PRNGKey(0), False) * w)

    jv, (jg_p, jg_x) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(bp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in bp.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = tm._block(tp, tx, None, False)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jm._block(bp, jnp.asarray(x), causal, None, False)), **TIGHT)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(float(out.detach().mul(torch.from_numpy(w)).sum()), float(jv), rtol=1e-5)
    for k in bp:
        g = np.asarray(jg_p[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), g, rtol=1e-4, atol=1e-6 * max(1.0, np.abs(g).max()), err_msg=k)
    # a pad row's layer-norm gradient is scaled by 1 / sqrt(1e-5): the largest
    # magnitudes are there
    g = np.asarray(jg_x)
    np.testing.assert_allclose(tx.grad.numpy(), g, rtol=1e-4, atol=1e-6 * np.abs(g).max())


def test_forward_user_and_item_match_jax(data):
    jd, td, jm, tm, p = _both(data)
    item_initial = jax.jit(lambda q: jm._initial_side_emb(q, jnp.arange(M_ITEMS), "item"))(p)
    with torch.no_grad():
        t_initial = tm._initial_side_emb(torch.arange(M_ITEMS), "item")
    np.testing.assert_allclose(t_initial.numpy(), np.asarray(item_initial), **TIGHT)
    users = np.array([0, 5, 17, 99, 5], dtype=np.int32)
    want = jax.jit(lambda q, u: jm.forward_user(q, item_initial, u))(p, jnp.asarray(users))
    with torch.no_grad():
        got = tm.forward_user(t_initial, torch.from_numpy(users))
        items = tm.forward_item(t_initial)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    np.testing.assert_allclose(items.numpy(), np.asarray(jax.jit(jm.forward_item)(p, item_initial)), **TIGHT)


def test_propagate_matches_jax(data):
    jd, td, jm, tm, p = _both(data)
    ju, ji = jax.jit(lambda q: jm.propagate(q, jd.graph))(p)
    with torch.no_grad():
        tu, ti = tm.propagate(td.graph)
    assert tu.shape == (N_USERS, DIM) and ti.shape == (M_ITEMS, DIM)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TIGHT)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TIGHT)


def test_propagate_in_chunks(data, monkeypatch):
    """Chunks of 7 users give the rows of one chunk of all."""
    _, td, _, tm, _ = _both(data)
    with torch.no_grad():
        whole = tm.propagate(td.graph)[0]
        monkeypatch.setattr(tsasrec, "PROPAGATE_CHUNK", 7)
        chunked = tm.propagate(td.graph)[0]
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **TIGHT)


def test_garbage_beyond_the_length_changes_nothing(data):
    """A user's rows beyond its length (here item 7) do not move its
    embedding, in the port as in JAX: the causal mask keeps the valid
    positions from reading later ones."""
    jd, td, jm, tm, p = _both(data)
    seqs = tm.sequences
    lens = seqs.lengths.numpy()
    u0 = int(np.argmax(lens < 40))
    items = seqs.items.clone()
    items[u0, lens[u0]:] = 7
    garbage = dataclasses.replace(seqs, items=items)
    other = build_model("sasrec", tm.config, td.graph, features=tm.features, sequences=garbage)
    params_from_jax(_np(p), other)
    with torch.no_grad():
        initial = tm._initial_side_emb(torch.arange(M_ITEMS), "item")
        e1 = tm.forward_user(initial, torch.tensor([u0]))
        e2 = other.forward_user(initial, torch.tensor([u0]))
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), atol=1e-6)
    jm2 = jbuild_model("sasrec", jm.config, jd.graph, features=jm.features,
                       sequences=jseq.UserSequences(items=jnp.asarray(items.numpy()), lengths=jnp.asarray(lens),
                                                    max_len=seqs.max_len))
    j_initial = jm._initial_side_emb(p, jnp.arange(M_ITEMS), "item")
    np.testing.assert_allclose(e2.numpy(), np.asarray(jm2.forward_user(p, j_initial, jnp.asarray([u0]))), **TIGHT)


# ---- training ----
def _batch(td, seed, b=48):
    """A BPR batch, the last 4 rows invalid; user 0 twice."""
    rng = np.random.default_rng(seed)
    ap = td.all_pos()
    user = rng.integers(0, N_USERS, b)
    user[1] = user[0]
    pos = np.array([rng.choice(ap[u]) for u in user])
    neg = rng.integers(0, M_ITEMS, b)
    valid = np.ones(b, dtype=bool)
    valid[-4:] = False
    arrs = [a.astype(np.int32) for a in (user, pos, neg)] + [valid]
    return JBatch(*(jnp.asarray(a) for a in arrs)), BPRBatch(*(torch.from_numpy(a) for a in arrs))


def _jax_loss_grad(jm, jd):
    return jax.jit(jax.value_and_grad(
        lambda q, jb: jm.loss(q, jd.graph, jb, jax.random.PRNGKey(1)), has_aux=True))


def _check_grads(model, grads):
    want = flatten_params(_np(grads))
    assert set(dict(model.named_parameters())) == set(want)
    for k, prm in model.named_parameters():
        w = want[k]
        g = np.zeros_like(w) if prm.grad is None else prm.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(w).max())), err_msg=k)


def test_loss_and_grads_match_jax(data, no_dropout):
    """The loss, its aux terms and every parameter's gradient (zero for the
    SAGE parameters the model never reads, and for the user side's)."""
    jd, td, jm, tm, p = _both(data)
    jb, tb = _batch(td, seed=0)
    (jl, jaux), jg = _jax_loss_grad(jm, jd)(p, jb)
    tl, taux = tm.loss(td.graph, tb)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert set(taux) == set(jaux)
    for k in taux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-5, err_msg=k)
    _check_grads(tm, jg)
    assert tm.blocks[0]["wq"].grad.abs().max() > 0 and tm.word_emb.grad.abs().max() > 0
    unread = {k for k, prm in tm.named_parameters() if prm.grad is None}
    assert unread == {k for k in flatten_params(_np(jg)) if k.startswith(("user_", "layers."))}


def test_regulariser_is_the_embedding_tables(data):
    """reg: 0.5 sum of squares of the top-level parameters named *emb*
    (with features ncwt: word_emb and both categorical tables), over the
    valid rows."""
    _, td, _, tm, _ = _both(data, user_feature="ncwt", item_feature="ncwt")
    _, tb = _batch(td, seed=1)
    _, aux = tm.loss(td.graph, tb, torch.Generator().manual_seed(0))
    want = sum(0.5 * float((getattr(tm, k).detach() ** 2).sum()) for k in ("word_emb", "user_cat_emb", "item_cat_emb"))
    np.testing.assert_allclose(float(aux["reg"]), want / 44, rtol=1e-5)


def test_a_step_gathers_two_tables_once(data, monkeypatch):
    """A step's two table gathers (two scatter-add launches on the card):
    the word table for every item's text bags (3 fields of 12 word slots),
    and the initial item table for the sequence rows, the positives and the
    negatives in one call; its ids hold every padded slot as item 0."""
    from furusato_recommend_tpu_torch.models import sage as tsage

    _, td, _, tm, _ = _both(data)
    _, tb = _batch(td, seed=2)
    seen = []
    real = tsasrec.table_gather

    def spy(table, ids):
        seen.append((tuple(table.shape), ids.clone()))
        return real(table, ids)

    monkeypatch.setattr(tsasrec, "table_gather", spy)
    monkeypatch.setattr(tsage, "table_gather", spy)
    tm.loss(td.graph, tb, torch.Generator().manual_seed(0))[0].backward()
    ((word_shape, word_ids), (shape, ids)) = seen
    assert word_shape == (500, DIM // 2) and word_ids.shape == (M_ITEMS, 3, 12)
    assert shape == (M_ITEMS, DIM)
    users = tb.user.long()
    seq = tm.sequences.items[users]
    np.testing.assert_array_equal(ids.numpy(), torch.cat([seq.reshape(-1), tb.pos.long(), tb.neg.long()]).numpy())
    pads = 50 - tm.sequences.lengths[users]
    assert int((ids[: seq.numel()] == 0).sum()) >= int(pads.sum()) > 0


def _check_params(model, want, label, rounding=None, lr=1e-3, steps=0):
    """Every parameter within 1e-6 + 1e-5 |p| of JAX's, but the elements of
    ``rounding`` (``_rounding``): those whose two gradients, equal within the
    gradient tolerance, differed at some step by more than 1e-3 of their own
    magnitude, so that Adam's normalised step g / (sqrt(v) + 1e-8) differs
    by more than 1e-3 x lr = 1e-6. They are held within 2 x lr a step, and
    there may be no more than 1 in 100 of them (``test_torch_edge.py``'s
    rule)."""
    got = flatten_params(params_to_numpy(model))
    want = flatten_params(_np(want))
    assert set(got) == set(want)
    rounding = rounding or {}
    assert sum(int(m.sum()) for m in rounding.values()) <= 1e-2 * sum(v.size for v in want.values())
    for k in want:
        diff = np.abs(got[k] - want[k])
        loose = rounding.get(k, np.zeros(diff.shape, bool))
        assert (diff[~loose] <= 1e-6 + 1e-5 * np.abs(want[k][~loose])).all(), f"{label}: {k} off by {diff.max()}"
        assert (diff[loose] <= 2 * lr * steps).all(), f"{label}: {k}"


def _rounding(model, grads, rounding):
    """The elements where the port's gradients differ from JAX's ``grads``
    by more than 1e-3 of JAX's magnitude, added to ``rounding``."""
    want = flatten_params(_np(grads))
    for k, prm in model.named_parameters():
        w = want[k]
        g = np.zeros_like(w) if prm.grad is None else prm.grad.numpy()
        rounding[k] = rounding.get(k, np.zeros(w.shape, bool)) | (np.abs(g - w) > 1e-3 * np.abs(w))
    return rounding


def test_three_adam_steps_match_optax_and_state_converts(data, no_dropout):
    """Three Adam steps at lr 1e-3 against jax.value_and_grad(model.loss) +
    optax.adam (each step's gradient held against JAX's at the port's own
    parameters); then the JAX parameters and Adam state carried into a
    fresh port model take a fourth step equal to JAX's."""
    jd, td, jm, tm, jp = _both(data)
    lr = 1e-3
    opt = optax.adam(lr)
    state = opt.init(jp)
    topt = torch.optim.Adam(tm.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step_fn = _jax_loss_grad(jm, jd)
    rounding = {}
    for step in range(3):
        jb, tb = _batch(td, seed=10 + step)
        _, grads = step_fn(jp, jb)
        upd, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        tm.loss(td.graph, tb)[0].backward()
        # the gradient at the port's own parameters, which differ from JAX's
        # within the parameter rule after the first step
        _check_grads(tm, step_fn(params_to_numpy(tm), jb)[1])
        rounding = _rounding(tm, grads, rounding)
        topt.step()
        _check_params(tm, jp, f"step {step}", rounding, lr, step + 1)

    fresh = build_model("sasrec", tm.config, td.graph, features=tm.features, sequences=tm.sequences)
    params_from_jax(_np(jp), fresh)
    _check_params(fresh, jp, "carried")
    fopt = torch.optim.Adam(fresh.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    adam = state[0]
    adam_state_from_jax(int(adam.count), _np(adam.mu), _np(adam.nu), fopt, fresh)
    count, mu, nu = adam_state_to_numpy(fopt, fresh)
    assert count == 3
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(_np(want))
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(_np(want))):
            np.testing.assert_array_equal(a, b)
    jb, tb = _batch(td, seed=13)
    _, grads = step_fn(jp, jb)
    upd, state = opt.update(grads, state, jp)
    jp = optax.apply_updates(jp, upd)
    fopt.zero_grad()
    fresh.loss(td.graph, tb)[0].backward()
    _check_grads(fresh, grads)
    rounding = _rounding(fresh, grads, {})
    fopt.step()
    _check_params(fresh, jp, "step 4 from the carried state", rounding, lr, 1)


def test_dropout_share(data, monkeypatch):
    """In training each block drops DROPOUT of the attention output and of
    the feed-forward, the kept elements scaled by 1 / (1 - DROPOUT), drawn
    from the generator (the same seed draws the same loss)."""
    _, td, _, tm, _ = _both(data)
    _, tb = _batch(td, seed=3)
    calls = []
    real = tsasrec.dropout

    def spy(x, generator, rate=None):
        out = real(x, generator, rate)
        calls.append((rate, x.detach(), out.detach()))
        return out

    monkeypatch.setattr(tsasrec, "dropout", spy)
    losses = [float(tm.loss(td.graph, tb, torch.Generator().manual_seed(4))[0]) for _ in range(2)]
    assert losses[0] == losses[1]
    assert len(calls) == 2 * 2 * 2  # two losses x two blocks x two places
    for rate, x, out in calls:
        assert rate == tsasrec.DROPOUT == 0.2
        nz = x != 0
        kept = out[nz] != 0
        assert abs(1.0 - float(kept.float().mean()) - 0.2) < 0.03
        np.testing.assert_allclose(out[nz][kept].numpy(), (x[nz][kept] / 0.8).numpy(), rtol=1e-6)
    with torch.no_grad():
        a = tm.propagate(td.graph)[0]
        b = tm.propagate(td.graph)[0]
    assert torch.equal(a, b)  # no dropout outside training


def test_trainer_takes_the_fresh_path_at_relin_every(data):
    """sasrec's loss takes no tables=, so the trainer takes the fresh path
    at relin_every 8 and does not round the epoch to blocks: the batch count
    is the JAX trainer's; one epoch moves every parameter the loss reads."""
    from furusato_recommend_tpu.train.trainer import Trainer as JTrainer

    jd, td, jm, tm, _ = _both(data, relin_every=8, bpr_batch_size=64)
    for ddp in (False, True):
        jt = JTrainer(JConfig(**_kw(relin_every=8, bpr_batch_size=64)), jd, jm, ddp_recipe=ddp)
        tr = Trainer(tm.config, td, tm, device="cpu", logger=MetricLogger(quiet=True), ddp_recipe=ddp)
        assert tr.cadence == "fresh" and not jt._use_cache
        assert tr.num_batches == jt.num_batches and tr.num_batches % 8 != 0
    textsage = build_model("textsage", Config(**_kw(model="textsage", relin_every=8, bpr_batch_size=64)), td.graph,
                           features=tm.features)
    assert Trainer(textsage.config, td, textsage, device="cpu", logger=MetricLogger(quiet=True)).cadence == "relin"
    tr.init_state()
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    assert np.isfinite(tr.train_one_epoch())
    moved = {k for k, p in tm.named_parameters() if not torch.equal(p.detach(), before[k])}
    # item_last_b adds the same to u . p and u . n: its BPR gradient is 0
    assert moved == {k for k in before if not k.startswith(("user_", "layers."))} - {"item_last_b"}
    assert all(np.isfinite(v) for v in tr.test().values())


# ---- conversion, registry, CLI, server ----
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_parameter_tree_round_trips_through_convert_and_checkpoint(data, tmp_path, n_layers):
    """The SASRec tree (``layers``, ``blocks`` of L, ``item_tower`` of L - 1:
    empty at L = 1) through params_from_jax / params_to_numpy and a
    checkpoint, bit-equal, with JAX's tree structure."""
    _, td, jm, tm, p = _both(data, n_layers=n_layers)
    want = _np(p)
    out = params_to_numpy(tm)
    assert jax.tree_util.tree_structure(out) == jax.tree_util.tree_structure(want)
    assert len(out["blocks"]) == n_layers and len(out["item_tower"]) == n_layers - 1
    for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert set(dict(tm.named_parameters())) == set(flatten_params(want))
    save_checkpoint(tmp_path / "s.ckpt", dict(tm.named_parameters()), tm.config)
    fresh = build_model("sasrec", tm.config, td.graph, features=tm.features, sequences=tm.sequences)
    params_from_jax(load_checkpoint(tmp_path / "s.ckpt")["params"], fresh)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(fresh)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_sasrec_needs_sequences(data):
    _, td, _, tm, _ = _both(data)
    assert "sasrec" in available_models() and "sasrec" in SAGE_KEYS
    with pytest.raises(ValueError, match="sequences"):
        build_model("sasrec", tm.config, td.graph, features=tm.features)
    with pytest.raises(ValueError, match="features"):
        build_model("sasrec", tm.config, td.graph, sequences=tm.sequences)


@pytest.mark.parametrize("key", javailable_models())
def test_every_jax_registry_key_builds_in_the_port(data, key):
    """Each key of the JAX registry builds in the port from the inputs its
    JAX constructor takes, and its parameter names are the JAX tree's,
    flattened."""
    jd, td = data
    kw = _kw(model=key, user_feature="nwtc", item_feature="nwtc")
    inputs = {}
    if key in SAGE_KEYS:
        fs = synthetic_features(td, Config(**kw), seed=1, with_edge_time=True, with_edge_label=True)
        inputs["features"] = fs
    if key == "sasrec":
        inputs["sequences"] = tseq.build_sequences(td)
    tm = build_model(key, Config(**kw), td.graph, **inputs)
    jin = {}
    if key in SAGE_KEYS:
        jf = jfeatures(jd, JConfig(**kw), seed=1, with_edge_time=True, with_edge_label=True)
        jin["features"] = jf
    if key == "sasrec":
        jin["sequences"] = jseq.build_sequences(jd)
    jm = jbuild_model(key, JConfig(**kw), jd.graph, **jin)
    want = flatten_params(_np(jm.init(jax.random.PRNGKey(0))))
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}


def _write_text_dataset(root, n_users=40, m_items=60, seed=0):
    rng = np.random.default_rng(seed)
    cf = root / "cf"
    cf.mkdir(parents=True)
    with open(cf / "train.txt", "w") as f, open(cf / "test.txt", "w") as g:
        for u in range(n_users):
            items = rng.choice(m_items, size=rng.integers(5, 10), replace=False)
            f.write(f"{u} " + " ".join(map(str, items[:-2])) + "\n")
            g.write(f"{u} " + " ".join(map(str, items[-2:])) + "\n")


@pytest.mark.parametrize("artifacts", [False, True], ids=["built", "artifacts"])
def test_build_model_inputs_match_jax(tmp_path, artifacts):
    """cli.build_model_inputs gives the JAX package's sequences: built from
    the train items in order, or read from the artifacts that
    ``data.artifacts`` writes (a seeded time order and the lengths)."""
    from furusato_recommend_tpu.cli import build_model_inputs as jinputs
    from furusato_recommend_tpu.data.dataset import load_text_dataset as jload
    from furusato_recommend_tpu_torch.cli import build_model_inputs
    from furusato_recommend_tpu_torch.data import artifacts as tart
    from furusato_recommend_tpu_torch.data.dataset import load_text_dataset

    _write_text_dataset(tmp_path)
    kw = dict(model="sasrec", data_path=str(tmp_path), user_feature="n", item_feature="n")
    jd, td = jload(JConfig(**kw)), load_text_dataset(Config(**kw))
    rng = np.random.default_rng(1)
    from furusato_recommend_tpu.preprocessing.artifacts import write_artifacts

    write_artifacts(tmp_path, user_numeric=rng.random((jd.n_users, 5)), item_numeric=rng.random((jd.m_items, 4)))
    if artifacts:
        tart.write_sequence_artifacts(td, tmp_path, seed=2)
    _, jkw = jinputs(JConfig(**kw), jd)
    graph, tkw = build_model_inputs(Config(**kw), td)
    assert graph is td.graph
    _seq_equal(tkw["sequences"], jkw["sequences"])
    built = tseq.build_sequences(td)
    assert torch.equal(tkw["sequences"].items, built.items) != artifacts
    assert torch.equal(tkw["sequences"].lengths, built.lengths)


def test_cli_trains_sasrec_and_serves_it(tmp_path):
    """The CLI trains sasrec from the artifacts ``data.artifacts`` writes
    (its sequence pickle among them) with the ddp recipe, and the server
    loads the checkpoint with the same sequences."""
    from furusato_recommend_tpu_torch.cli import main
    from furusato_recommend_tpu_torch.data import artifacts
    from furusato_recommend_tpu_torch.serve import Recommender

    _write_text_dataset(tmp_path / "data")
    artifacts.main(["--data_path", str(tmp_path / "data"), "--seed", "1"])
    assert (tmp_path / "data" / "train_items_sequence.pkl").exists()
    main(["--model", "sasrec", "--ddp_recipe", "--recdim", "16", "--bpr_batch", "256", "--lr", "0.01",
          "--epochs", "1", "--test_span", "1", "--topks", "[5,10]", "--testbatch", "32",
          "--data_path", str(tmp_path / "data"), "--path", str(tmp_path / "ck"), "--device", "cpu"])
    (ckpt,) = (tmp_path / "ck" / "sasrec").glob("*.ckpt")
    rec = Recommender.from_checkpoint(str(ckpt), device="cpu")
    want = tseq.load_sequence_artifacts(tmp_path / "data", n_users=40)
    assert torch.equal(rec.model.sequences.items, want.items)
    ids, scores = rec.recommend([0, 7], k=5)
    assert ids.shape == (2, 5) and np.isfinite(scores).all()


def test_recommender_serves_sasrec_like_jax(data):
    """The port's CPU Recommender against the JAX Recommender at k = 10: the
    train positives masked."""
    from furusato_recommend_tpu.serve import Recommender as JRecommender
    from furusato_recommend_tpu_torch.serve import Recommender

    jd, td, jm, tm, p = _both(data)
    jrec = JRecommender(jm, jd, jm.config, p)
    trec = Recommender(tm, td, tm.config, _np(p), device="cpu")
    users = np.arange(N_USERS)
    jid, jsc = (np.asarray(x) for x in jrec.recommend(users, k=10))
    tid, tsc = trec.recommend(users, k=10)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-5)
    gap = np.abs(np.diff(jsc, axis=1)) > 1e-5 * np.abs(jsc[:, 1:])
    sep = np.ones(jid.shape, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(tid[sep], jid[sep])
    assert sep.mean() > 0.9
    ap = td.all_pos()
    for u, row in zip(users, tid):
        assert not set(row.tolist()) & set(ap[u].tolist())
