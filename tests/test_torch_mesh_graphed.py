"""The mesh's training steps and evaluations as the card's CUDA graphs run
them, on the CPU: the same parts, run eagerly, in worlds of gloo processes
(``tests/torch_world.py``) at mesh (2, 2) and (2, 1), 4 and 2 ranks.

A mesh's step is cut at its collectives (``train/graphed.py::segments``):
the whole-table gather into the rank's buffers (``RowShards.gather_whole``),
the grad part (the loss on the data rank's rows and the backward, reading
the tables through ``RowShards.read_whole``, no collective), the gradients'
mean through one flat buffer (``Mesh.average``) and the update part (the
Adam step). The CPU's trainer runs those segments in order
(``run_eagerly``), the card replays the device ones as graphs. Its
evaluation is cut the same way (``Evaluator.local_candidates``, the exchange
of every tile's candidates over ``model``, ``Evaluator.merged``,
``Evaluator._reduce``).

- two steps of lgn (2048 users x 1024 items, float32: both tables
  row-sharded at (2, 2), replicated at (2, 1)) and of textsage (the ddp
  flagship recipe, its trees drawn by the JAX package and handed to the
  port, dropout 0) from JAX's parameters, each against JAX
  ``make_sharded_train_step`` on its (4, 2) virtual CPU mesh at lr 1e-3
  (where Adam's first steps do not scale the rounding of a gradient below
  its eps past the tolerance): the loss within rtol 1e-5, each step's
  averaged gradients within 1e-5 x their largest, the parameters within
  rtol 1e-4, atol 1e-5
  (``tests/test_torch_mesh.py::test_sharded_lgn_step_matches_jax``'s);
  the collectives a step counted (lgn at (2, 2): two table gathers, the
  blocks' mean and the epoch's loss mean; one mean and the loss's
  otherwise), and the whole-table buffers and the mean's flat buffers
  written in place, where the graphs read them;
- the split evaluation on JAX's parameters against the JAX ``Evaluator``:
  the metrics within rtol 1e-5, the top-K ids equal;
- ``Trainer`` at each mesh against the port's one process
  (``tests/test_torch_distributed.py``'s ``setup`` and ``run``: an
  evaluation, two epochs, an evaluation; textsage also ``--inference
  sample``) under that file's rules, the ranks bit-equal;
- the capture rule under a mesh: the data-axis InfoNCE losses (``--loss_fn
  infonce``, asage's ``ssl_weight``) at data > 1 and a mesh's
  ``--inference sample`` evaluation stay eager, the rest is captured;
- ``Mesh.all_reduce`` (and so the gather and the mean) raises while the
  current stream is capturing (a stub reports a capture: the CPU has none);
- the segments of every cadence's parts with and without a mesh.

The card's replays are held against eager mesh steps and evaluations in
``chip_smoke.py``'s phase 19.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_world import REPO, run_world

from furusato_recommend_tpu.config import Config as JConfig
from furusato_recommend_tpu.core.mesh import make_mesh as jmake_mesh, table_sharding
from furusato_recommend_tpu.data import dataset as jds
from furusato_recommend_tpu.data.features import synthetic_features as jfeatures
from furusato_recommend_tpu.data.graph import build_bipartite_graph as jbuild_graph
from furusato_recommend_tpu.eval import evaluate as jev
from furusato_recommend_tpu.models import sage as jsage
from furusato_recommend_tpu.models.registry import build_model as jbuild_model
from furusato_recommend_tpu.sampling.bpr import BPRBatch as JBatch
from furusato_recommend_tpu.train.sharding import make_sharded_train_step as jmake_step, shard_batch as jshard
from furusato_recommend_tpu_torch.config import Config, ddp_flagship_config
from furusato_recommend_tpu_torch.convert import flatten_params
from furusato_recommend_tpu_torch.core import mesh as mesh_module
from furusato_recommend_tpu_torch.core.graphs import captured
from furusato_recommend_tpu_torch.core.mesh import Mesh, RowShards
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.train.graphed import PARTS, segments

from test_torch_distributed import _bit_equal, _params_rule, _same_results, run, setup, whole_params

torch.set_num_threads(1)

MESHES = [(2, 2), (2, 1)]
STEPS = 2
TILE = 256


def _lgn_fields() -> dict:
    return dict(model="lgn", latent_dim=16, n_layers=2, compute_dtype="float32", decay=1e-2, lr=1e-3,
                eval_user_batch=TILE, topks=(5, 10))


def _textsage_fields() -> dict:
    cfg = dataclasses.asdict(ddp_flagship_config())
    cfg.pop("mesh")
    cfg.update(latent_dim=16, num_neighbors=3, compute_dtype="float32", decay=1e-2, lr=1e-3,
               eval_user_batch=128, topks=(5, 10))
    return cfg


# each model's dataset and config; textsage's at test_torch_distributed.py's size
CASES = {
    "lgn": {"data": dict(n_users=2048, m_items=1024, avg_degree=6, seed=2), "config": _lgn_fields(), "b": 512},
    "textsage": {"data": dict(n_users=512, m_items=384, avg_degree=8, seed=6), "config": _textsage_fields(),
                 "b": 256},
}


_CHILD = '''
sys.path.insert(0, f"{ARGS['repo']}/tests")
from furusato_recommend_tpu_torch.config import Config, MeshConfig
from furusato_recommend_tpu_torch.convert import params_from_jax
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.eval.evaluate import build_eval_data
from furusato_recommend_tpu_torch.models import sage as tsage
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.sampling.bpr import BPRBatch
from furusato_recommend_tpu_torch.sampling.neighbor import SampledNeighbors
from furusato_recommend_tpu_torch.train.trainer import Trainer
from test_torch_distributed import run, setup, whole_params

mesh = tuple(ARGS["mesh"])
res = {}
for kind, spec in ARGS["cases"].items():
    z = np.load(f"{OUT}/{kind}_inputs.npz")
    td = tds.synthetic_dataset(**spec["data"])
    cfg = Config(**spec["config"]).replace(mesh=MeshConfig(*mesh))
    inputs = {"features": synthetic_features(td, cfg, seed=1)} if kind == "textsage" else {}
    model = build_model(kind, cfg, td.graph, **inputs)
    params_from_jax({k[2:]: z[k] for k in z.files if k.startswith("p/")}, model)
    rate, tsage.DROPOUT_RATE = tsage.DROPOUT_RATE, 0.0  # JAX's steps and trees run without dropout
    tr = Trainer(cfg, td, model, logger=MetricLogger(quiet=True), ddp_recipe=kind == "textsage", device="cpu")
    with tr._whole():  # the split evaluation, on JAX's parameters
        metrics, shown = tr.evaluator(build_eval_data(td, cfg.eval_user_batch))
    out = {"metrics": metrics, "collectives": [], "in_place": []}
    arrays = {"shown": shown}
    levels = cfg.n_layers
    for s in range(ARGS["steps"]):
        batch = BPRBatch(*(torch.from_numpy(z[f"b{s}/{k}"]) for k in ("user", "pos", "neg", "valid")))
        draws = None
        if kind == "textsage":
            draws = [{"trees": [[SampledNeighbors(*(torch.from_numpy(z[f"t{s}/{t}/{l}/{f}"]) for f in range(3)))
                                 for l in range(levels)] for t in range(3)]}]
        before = tr.mesh.collectives
        out.setdefault("loss", []).append(float(tr.train_epoch([batch], draws)[0]))
        out["collectives"].append(tr.mesh.collectives - before)
        buffers = {**tr.shards.tables, **{str(i): f for i, f in enumerate(tr.mesh._flat.values())}}
        out["in_place"].append({k: v.data_ptr() for k, v in buffers.items()})
        for k, v in whole_params(tr).items():
            arrays[f"{s}/{k}"] = v.copy()  # not a view of a parameter the next step moves
        for k, p in tr.model.named_parameters():
            g = tr.shards.gather(p.grad) if k in tr.shards.names else p.grad
            arrays[f"{s}/grad/{k}"] = g.numpy().copy()
    out["sharded"] = tr.shards.names
    out["flat_buffers"] = len(tr.mesh._flat)
    np.savez(f"{OUT}/{kind}_steps_{RANK}.npz", **arrays)
    tsage.DROPOUT_RATE = rate
    # the Trainer at this mesh, for the one-process comparison
    trainer = setup(kind, mesh, OUT)
    got = run(trainer)
    got["generator"] = trainer.generator.get_state().numpy().tolist()
    np.savez(f"{OUT}/{kind}_run_{RANK}.npz", **whole_params(trainer))
    out["run"] = got
    res[kind] = out
print(json.dumps(res))
'''


def _hub_free(jd):
    g = jbuild_graph(jd.train_user, jd.train_item, jd.test_user, jd.test_item, jd.n_users, jd.m_items,
                     hub_count=0, dst_hub_count=0)
    return dataclasses.replace(jd, _graph=g)


def _batch(ds, b, step, seed):
    """A batch of ``b`` triplets drawn with numpy, its last 24 rows padding."""
    rng = np.random.default_rng(seed + step)
    ap = ds.all_pos()
    user = rng.integers(0, ds.n_users, b)
    return {"user": user.astype(np.int32), "pos": np.array([rng.choice(ap[u]) for u in user], np.int32),
            "neg": rng.integers(0, ds.m_items, b).astype(np.int32), "valid": np.arange(b) < b - 24}


class _WithTrees:
    """The JAX model with its loss taking the given trees: what
    ``make_sharded_train_step`` steps with, so that JAX and the port score
    the same draws."""

    def __init__(self, jm, trees):
        self.jm, self.trees = jm, trees

    def init(self, key):
        return self.jm.init(key)

    def loss(self, params, graph, batch, key):
        return self.jm.loss(params, graph, batch, key, trees=self.trees)


_JAX = {}  # kind -> (the ranks' inputs, JAX's results)


def _jax_reference(kind):
    """JAX's evaluation and STEPS sharded steps on the case's inputs: (the
    inputs the ranks read (parameters, batches, textsage's trees), JAX's
    results); made once."""
    if kind in _JAX:
        return _JAX[kind]
    spec = CASES[kind]
    jd = _hub_free(jds.synthetic_dataset(**spec["data"]))
    jcfg = JConfig(**spec["config"])
    inputs = {"features": jfeatures(jd, jcfg, seed=1)} if kind == "textsage" else {}
    jm = jbuild_model(kind, jcfg, jd.graph, **inputs)
    if kind == "lgn":
        rng = np.random.default_rng(0)
        params = {k: (0.1 * rng.standard_normal((n, 16))).astype(np.float32)
                  for k, n in (("user_emb", jd.n_users), ("item_emb", jd.m_items))}
    else:
        params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    files = {f"p/{k}": v for k, v in flatten_params(params).items()}
    max_deg = int(np.bincount(jd.train_user, minlength=jd.n_users).max())
    metrics, shown = jev.Evaluator(jm, jd.graph, jcfg, max_deg)(
        jax.tree_util.tree_map(jnp.asarray, params), jev.build_eval_data(jd, jcfg.eval_user_batch))
    jmesh = jmake_mesh(4, 2)
    rep = NamedSharding(jmesh, P())
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    if kind == "lgn":
        jp = {k: jax.device_put(v, table_sharding(jmesh)) for k, v in jp.items()}
    opt = optax.adam(jcfg.lr)
    state = jax.device_put(opt.init(jp), rep)
    steps = []
    for s in range(STEPS):
        arrs = _batch(jd, spec["b"], s, 30)
        files.update({f"b{s}/{k}": v for k, v in arrs.items()})
        whole = JBatch(*(jnp.asarray(arrs[k]) for k in ("user", "pos", "neg", "valid")))
        trees = None
        if kind == "textsage":
            keys = jax.random.split(jax.random.PRNGKey(40 + s), 3)
            seeds = ((whole.user, "user"), (whole.pos, "item"), (whole.neg, "item"))
            trees = [jm.sample_seed_tree(jd.graph, x, side, k) for (x, side), k in zip(seeds, keys)]
            for t, tree in enumerate(trees):
                for level, sn in enumerate(tree):
                    for f, x in enumerate(sn):
                        files[f"t{s}/{t}/{level}/{f}"] = np.asarray(x)
        model = _WithTrees(jm, trees) if trees is not None else jm
        _, step_fn = jmake_step(model, jd.graph, jcfg, jmesh, opt)
        grad = jax.jit(jax.grad(lambda q, b: model.loss(q, jd.graph, b, jax.random.PRNGKey(2))[0]))(jp, whole)
        with jmesh:
            jp, state, loss = step_fn(jp, state, jshard(whole, jmesh), jax.random.PRNGKey(2))
        steps.append({"loss": float(loss), "grad": flatten_params(jax.tree_util.tree_map(np.asarray, grad)),
                      "params": flatten_params(jax.tree_util.tree_map(np.asarray, jp))})
    _JAX[kind] = files, {"metrics": metrics, "shown": np.asarray(shown), "steps": steps}
    return _JAX[kind]


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"mesh{m[0]}x{m[1]}")
def world(request, tmp_path_factory):
    """Each mesh's world of 4 ranks on the cases' inputs, and JAX's
    references: (mesh, {kind: JAX's}, [each rank's results], its folder)."""
    mesh = request.param
    tmp = tmp_path_factory.mktemp(f"mesh{mesh[0]}x{mesh[1]}")
    patch = pytest.MonkeyPatch()
    patch.setattr(jsage.SAGE, "TEXT_HUB_WORDS", 0)
    patch.setattr(jsage, "DROPOUT_RATE", 0.0)
    try:
        ref = {}
        for kind in CASES:
            files, ref[kind] = _jax_reference(kind)
            np.savez(tmp / f"{kind}_inputs.npz", **files)
    finally:
        patch.undo()
    outs = run_world(_CHILD, mesh[0] * mesh[1], tmp, {"mesh": list(mesh), "cases": CASES, "steps": STEPS, "repo": REPO},
                     timeout=300)
    return mesh, ref, [json.loads(text.strip().splitlines()[-1]) for text in outs], tmp


_SINGLE = {}  # kind -> (one process's run, its whole parameters)


def _single(kind, tmp_path):
    if kind not in _SINGLE:
        tr = setup(kind, (1, 1), str(tmp_path / f"single_{kind}"))
        _SINGLE[kind] = run(tr), whole_params(tr), tr.generator.get_state().numpy().tolist()
    return _SINGLE[kind]


@pytest.mark.parametrize("kind", sorted(CASES))
def test_split_steps_match_jax(world, kind):
    mesh, ref, ranks, tmp = world
    want = ref[kind]["steps"]
    for r, res in enumerate(ranks):
        got = np.load(tmp / f"{kind}_steps_{r}.npz")
        for s, w in enumerate(want):
            np.testing.assert_allclose(res[kind]["loss"][s], w["loss"], rtol=1e-5, err_msg=f"step {s}")
            for k, wg in w["grad"].items():
                np.testing.assert_allclose(got[f"{s}/grad/{k}"], wg, rtol=0, atol=1e-5 * np.abs(wg).max(),
                                           err_msg=f"rank {r} step {s} grad {k}")
                np.testing.assert_allclose(got[f"{s}/{k}"], w["params"][k], rtol=1e-4, atol=1e-5,
                                           err_msg=f"rank {r} step {s} {k}")
    sharded = ["item_emb", "user_emb"] if kind == "lgn" and mesh[1] == 2 else []
    assert all(res[kind]["sharded"] == sharded for res in ranks)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_split_steps_collectives_and_buffers(world, kind):
    """The collectives a step: a gather a sharded table, one mean a kind of
    parameter (the blocks over data, the replicated over the world), the
    epoch's loss mean; the gather's and the mean's buffers stay where the
    graphs read them, one flat buffer for each mean."""
    mesh, _, ranks, _ = world
    sharded = kind == "lgn" and mesh[1] == 2
    for res in ranks:
        out = res[kind]
        assert out["collectives"] == [(2 + 1 + 1) if sharded else (1 + 1)] * STEPS
        assert out["in_place"][0] == out["in_place"][-1] and len(out["in_place"][0]) >= 1
        assert out["flat_buffers"] == 2  # the gradients' mean and the losses'


@pytest.mark.parametrize("kind", sorted(CASES))
def test_split_evaluation_matches_jax(world, kind):
    _, ref, ranks, tmp = world
    want = ref[kind]
    for r, res in enumerate(ranks):
        got = res[kind]["metrics"]
        assert set(got) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=f"rank {r} {k}")
        np.testing.assert_array_equal(np.load(tmp / f"{kind}_steps_{r}.npz")["shown"], want["shown"])


@pytest.mark.parametrize("kind", sorted(CASES))
def test_split_trainer_equals_single_process(world, kind, tmp_path):
    """``test_torch_distributed.py``'s rules: losses rtol 1e-5, metrics atol
    1e-6, parameters phase 7's rule, one process's draws, the ranks
    bit-equal."""
    _, _, ranks, tmp = world
    want, want_params, want_gen = _single(kind, tmp_path)
    head = ranks[0][kind]["run"]
    for r, res in enumerate(ranks):
        got = res[kind]["run"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for key in ("first", "last") + (("sample",) if kind == "textsage" else ()):
            _same_results(got[key], want[key])
        params = dict(np.load(tmp / f"{kind}_run_{r}.npz"))
        _params_rule(params, want_params)
        assert got["generator"] == want_gen
        assert got == head, r
        _bit_equal(params, dict(np.load(tmp / f"{kind}_run_0.npz")))


def _asage(ssl_weight):
    ds = tds.synthetic_dataset(n_users=40, m_items=30, avg_degree=4, seed=0)
    cfg = Config(model="asage", latent_dim=8, user_feature="nwtc", item_feature="nwtc")
    return cfg, build_model("asage", cfg, ds.graph, features=synthetic_features(ds, cfg, seed=0),
                            ssl_weight=ssl_weight)


@pytest.mark.parametrize("data,model_axis", [(2, 2), (2, 1), (1, 4), (4, 1)])
def test_the_rule_keeps_data_axis_gathers_eager(data, model_axis):
    """On a CUDA device a mesh's steps are captured unless the loss gathers
    rows over a data axis of more than one rank (the in-batch InfoNCE,
    asage's views' InfoNCE), and its evaluations unless --inference sample
    (whose gathers sit inside the propagation); the CPU never captures."""
    mesh = Mesh(data, model_axis, 0, torch.device("cpu"), {})
    ds = tds.synthetic_dataset(n_users=40, m_items=30, avg_degree=4, seed=0)
    lgn_cfg = Config(model="lgn", latent_dim=8)
    lgn = build_model("lgn", lgn_cfg, ds.graph)
    gathers = data > 1
    assert captured(mesh, "cuda", lgn_cfg, lgn)
    assert captured(mesh, "cuda", lgn_cfg.replace(loss_fn="infonce"), lgn) is not gathers
    assert not captured(mesh, "cpu", lgn_cfg, lgn)
    cfg, plain = _asage(0.0)
    assert captured(mesh, "cuda", cfg, plain)
    cfg, ssl = _asage(0.1)
    assert captured(mesh, "cuda", cfg, ssl) is not gathers
    assert captured(mesh, "cuda", cfg, ssl, evaluation=True)  # the evaluation has no loss
    assert captured(mesh, "cuda", cfg, plain, evaluation=True)
    assert not captured(mesh, "cuda", cfg.replace(inference="sample"), plain, evaluation=True)
    assert captured(None, "cuda", cfg.replace(inference="sample"), plain, evaluation=True)
    assert captured(None, "cuda", lgn_cfg.replace(loss_fn="infonce"), lgn)


def _capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)


def test_a_collective_inside_a_capture_raises(monkeypatch):
    """A collective reached while the current stream captures raises before
    it calls the backend: the gather, the mean and the plain sum (a stub
    reports the capture)."""
    mesh = Mesh(2, 2, 0, torch.device("cpu"), {})
    model = torch.nn.Module()
    model.table = torch.nn.Parameter(torch.ones(4, 2))
    shards = RowShards(model, mesh, ["table"], {"table": 8})
    assert not mesh_module.capturing()
    _capturing(monkeypatch)
    assert mesh_module.capturing()
    for call in (lambda: mesh.all_reduce(torch.zeros(3)), lambda: mesh.average([torch.ones(2)]),
                 lambda: mesh.all_gather(torch.ones(2), "model"), shards.gather_whole, mesh.barrier):
        with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
            call()
    assert mesh.collectives == 0


def _stub_trainer(cadence, mesh: bool, names=("table",)):
    """A trainer's parts as ``segments`` reads them, on a stub mesh."""
    tr = types.SimpleNamespace(optimizer=object(), opt_feat=object(), cadence=cadence)
    split = {"train_step": (True, "step", "optimizer"), "_linearize": (True, "linearize", None),
             "_cached_step": (True, "cached", "optimizer"), "_inner_step": (True, "inner", "optimizer"),
             "_outer_step": (False, "outer", "opt_feat")}
    tr._split = lambda part: split[part]
    tr.shards = None
    if mesh:
        tr.shards = types.SimpleNamespace(names=list(names), gather_whole=lambda: None)
    return tr


@pytest.mark.parametrize("cadence", sorted(PARTS))
@pytest.mark.parametrize("mesh,names", [(False, ()), (True, ("table",)), (True, ())])
def test_every_part_is_cut_at_the_collectives(cadence, mesh, names):
    """Without a mesh a part is one device segment (one graph); under one,
    the gather comes before a part that reads the tables whole (when a table
    is sharded), and the gradients' mean between the work and the Adam step,
    each an eager segment between device ones."""
    tr = _stub_trainer(cadence, mesh, names)
    for part in PARTS[cadence]:
        reads_whole, work, opt = tr._split(part)
        kinds = ["gather" if s.hook is not None else "mean" if s.optimizer is not None else "graph"
                 for s in segments(tr, part)]
        if not mesh:
            want = ["graph"]
        else:
            want = (["gather"] if reads_whole and names else []) + ["graph"] + (["mean", "graph"] if opt else [])
        assert kinds == want, (part, kinds)
        first = next(s for s in segments(tr, part) if s.work is not None)
        # the work alone, or without a mesh the work and its Adam step in one
        assert (first.work is work) is (mesh or opt is None)
        if mesh and opt is not None:
            assert next(s for s in segments(tr, part) if s.optimizer is not None).optimizer == opt
