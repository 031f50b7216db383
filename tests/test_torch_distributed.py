"""The port's multi-device training against its single-process run, on the
CPU: worlds of 4 gloo processes (``tests/torch_world.py``).

- ``Trainer`` at mesh (2, 2) and (4, 1) for lgn (2048 users, 1024 items: both
  tables row-sharded at (2, 2)), also under ``--loss_fn infonce`` (each data
  rank's rows against the whole batch's, gathered over ``data``), at (2, 2)
  for asage with its views' InfoNCE (``ssl_weight`` 0.1), for textsage ``--ddp_recipe``,
  also under the cadences relin_every R = 4 and feature_update_every T = 4
  (the pullback's gradients, both Adams), and at (2, 2) for sasrec (its
  dropout drawn for the whole batch) and asage (its attribute trees and
  dropout), each with vocabularies of 1024 words and item attributes, whose
  tables row-shard: two epochs between two
  evaluations, float32 SpMM. Every rank holds the
  single-process losses (rtol 1e-5), metrics (atol 1e-6) and parameters
  (phase 7's rule of chip_smoke.py: all but 1e-3 of them within 1e-6 + 1e-5
  |p|); textsage's ``--inference sample`` evaluation too; and the four
  ranks hold bit-equal losses, metrics and whole parameters (a replica that
  drifts from another shows there);
- the checkpoint: only the primary writes it (every rank calls ``save``),
  with whole tables and Adam moments bit-equal to every rank's gathered
  ones, and the generator state of the single-process run (the mesh draws
  what one process draws); a single-process ``Trainer`` restores it and
  evaluates equal, and the mesh restores it and trains on as one process
  does;
- the CLI under ``torch.distributed.run --nproc_per_node 4`` at mesh (2, 2)
  (only rank 0 writes metrics.jsonl and the checkpoint, whose metrics equal
  the single-process CLI's), and its raises: no world, a world of another
  size;
- the world's own raises: a world of another size than asked, an
  unreachable rendezvous (within its timeout), a mesh on a world of another
  size, the evaluator's two mesh raises; the rank-folded generator, the
  primary, and the backend each device asks for.

Under bfloat16 SpMM operands each data rank rounds its own cotangent before
the transposed SpMM where one process rounds their sum, so gradients differ
by up to 2^-8 relative and Adam moves a near-zero one by +-lr: the equality
is held in float32 (the losses and metrics agree under bfloat16 too).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_world import REPO, run_world

from furusato_recommend_tpu_torch.config import Config, MeshConfig, ddp_flagship_config
from furusato_recommend_tpu_torch.core.checkpoint import load_checkpoint
from furusato_recommend_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from furusato_recommend_tpu_torch.data.dataset import synthetic_dataset
from furusato_recommend_tpu_torch.data.sequence import build_sequences
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.eval.evaluate import Evaluator
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

EPOCHS = 2
#: the textsage variants: the cadences' config fields
CADENCES = {"textsage": {}, "textsage_r4": {"relin_every": 4}, "textsage_t4": {"feature_update_every": 4}}
PARAM_SHARE = 1e-3  # phase 7's rule: the share of parameters that may lie outside 1e-6 + 1e-5 |p|


def setup(kind, mesh, out):
    """The Trainer of one config, single-process (mesh (1, 1)) or as one
    rank of a mesh."""
    if kind in ("lgn", "lgn_infonce"):
        ds = synthetic_dataset(n_users=2048, m_items=1024, avg_degree=6, seed=1)
        # the in-batch InfoNCE at bench.py's lr 1e-3: at 0.02 Adam turns the
        # float32 rounding of its gradients near eps (the mesh sums them in
        # another order than one process) into moves past phase 7's rule on
        # more than its share of the parameters within an epoch
        cfg = Config(model="lgn", latent_dim=16, bpr_batch_size=512, lr=1e-3 if kind == "lgn_infonce" else 0.02,
                     compute_dtype="float32", eval_user_batch=256, topks=(10, 20), path=out,
                     loss_fn="infonce" if kind == "lgn_infonce" else "bpr")
        model, ddp = build_model("lgn", cfg, ds.graph), False
    elif kind in ("sasrec", "asage", "asage_ssl"):
        name = kind.split("_")[0]
        ds = synthetic_dataset(n_users=256, m_items=384, avg_degree=6, seed=3)
        cfg = Config(model=name, latent_dim=16, n_layers=2, num_neighbors=3, user_feature="nwt",
                     item_feature="nwt", bpr_batch_size=256, lr=0.01, decay=1e-2, compute_dtype="float32",
                     eval_user_batch=128, topks=(10,), path=out)
        inputs = {"sequences": build_sequences(ds)} if name == "sasrec" else {}
        if kind == "asage_ssl":
            inputs["ssl_weight"] = 0.1
        # vocabularies of 1024 words and item attributes: their tables row-shard
        fs = synthetic_features(ds, cfg, seed=2, text_vocab=1024, cat_vocab_item=1024)
        model = build_model(name, cfg, ds.graph, features=fs, **inputs)
        ddp = False
    else:
        ds = synthetic_dataset(n_users=512, m_items=384, avg_degree=8, seed=6)
        cfg = ddp_flagship_config().replace(latent_dim=16, bpr_batch_size=512, num_neighbors=3, eval_user_batch=128,
                                            topks=(10,), train_iterative=2, positive_num_limit=50,
                                            compute_dtype="float32", sample_infer_chunk=128, path=out,
                                            **CADENCES[kind])
        model = build_model("textsage", cfg, ds.graph, features=synthetic_features(ds, cfg, seed=2))
        ddp = True
    cfg = cfg.replace(mesh=MeshConfig(*mesh))
    return Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=ddp, device="cpu")


def run(tr):
    tr.init_state()
    first = tr.test()
    losses = [tr.train_one_epoch() for _ in range(EPOCHS)]
    out = {"first": first, "losses": losses, "last": tr.test()}
    if tr.config.model == "textsage":
        tr.evaluator.config = tr.config.replace(inference="sample")
        out["sample"] = tr.test()
        tr.evaluator.config = tr.config
    return out


def whole_params(tr):
    shards = tr.shards
    return {k: (shards.gather(p) if shards is not None and k in shards.names else p.detach()).numpy()
            for k, p in tr.model.named_parameters()}


def whole_moments(tr):
    """Every Adam moment of the trainer under its checkpoint key (as
    ``Trainer.save`` names it), the row-sharded ones gathered whole, and
    the generator's state."""
    shards, named = tr.shards, dict(tr.model.named_parameters())
    out = {"generator": tr.generator.get_state().numpy()}
    for prefix, opt in tr._optimizers().items():
        for name, p in named.items():
            for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                if p in opt.state:
                    t = opt.state[p][moment]
                    out[f"{prefix}_{key}/{name}"] = (shards.gather(t) if name in shards.names else t).numpy()
    return out


_CHILD = '''
sys.path.insert(0, f"{ARGS['repo']}/tests")
from test_torch_distributed import run, setup, whole_moments, whole_params
tr = setup(ARGS["kind"], ARGS["mesh"], OUT)
res = run(tr)
res["sharded"] = tr.shards.names
res["generator"] = tr.generator.get_state().numpy().tolist()
np.savez(f"{OUT}/params_{RANK}.npz", **whole_params(tr))
if ARGS["save"]:
    np.savez(f"{OUT}/moments_{RANK}.npz", **whole_moments(tr))
    tr.save(f"{OUT}/ckpt_{RANK}.npz")  # every rank takes part; the primary writes
    tr.mesh.barrier()
    tr.restore(f"{OUT}/ckpt_0.npz")
    res["resumed"] = tr.train_one_epoch()
    np.savez(f"{OUT}/resumed_{RANK}.npz", **whole_params(tr))
print(json.dumps(res))
'''


def _params_rule(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    off = total = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 4 * 0.02 + 1e-6, (k, d.max())
        off += int((d > 1e-6 + 1e-5 * np.abs(w)).sum())
        total += d.size
    assert off <= PARAM_SHARE * total, f"{off} of {total} parameters off"


def _same_results(got: dict, want: dict, atol=1e-6) -> None:
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= atol, (k, got[k], want[k])


def _bit_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind,mesh", [("lgn", (2, 2)), ("lgn", (4, 1)), ("textsage", (2, 2)),
                                       ("textsage_r4", (2, 2)), ("textsage_t4", (2, 2)), ("sasrec", (2, 2)),
                                       ("asage", (2, 2)), ("lgn_infonce", (2, 2)), ("lgn_infonce", (4, 1)),
                                       ("asage_ssl", (2, 2))])
def test_trainer_mesh_equals_single_process(kind, mesh, tmp_path):
    save = (kind, mesh) == ("lgn", (2, 2))
    outs = run_world(_CHILD, 4, tmp_path, {"kind": kind, "mesh": mesh, "save": save, "repo": REPO})
    single = setup(kind, (1, 1), str(tmp_path / "single"))
    want = run(single)
    want_params = whole_params(single)
    results = [json.loads(text.strip().splitlines()[-1]) for text in outs]
    for rank, got in enumerate(results):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for key in ("first", "last") + (("sample",) if kind.startswith("textsage") else ()):
            _same_results(got[key], want[key])
        params = dict(np.load(tmp_path / f"params_{rank}.npz"))
        _params_rule(params, want_params)
        # the mesh draws what one process draws
        assert got["generator"] == single.generator.get_state().numpy().tolist()
        # the replicas: every rank holds rank 0's numbers bit for bit
        assert got == results[0], rank
        _bit_equal(params, dict(np.load(tmp_path / "params_0.npz")))
    if kind.startswith("lgn") and mesh == (2, 2):
        assert results[0]["sharded"] == ["item_emb", "user_emb"]
    if kind.startswith(("sasrec", "asage")):
        assert results[0]["sharded"] == (["item_attr_emb", "word_emb"] if kind.startswith("asage") else ["word_emb"])
    if save:
        assert sorted(p.name for p in tmp_path.glob("ckpt_*")) == ["ckpt_0.npz"]
        # whole tables and moments, bit-equal to every rank's; one process's draws
        ckpt = load_checkpoint(tmp_path / "ckpt_0.npz")
        for rank in range(4):
            moments = dict(np.load(tmp_path / f"moments_{rank}.npz"))
            np.testing.assert_array_equal(ckpt["state"]["generator"], moments.pop("generator"))
            for key, v in moments.items():
                np.testing.assert_array_equal(ckpt["state"][key], v, err_msg=key)
        _bit_equal(ckpt["params"], dict(np.load(tmp_path / "params_0.npz")))
        np.testing.assert_array_equal(ckpt["state"]["generator"], single.generator.get_state().numpy())
        # the primary's checkpoint, whole, restores into one process
        single.save(tmp_path / "single.npz")
        back = setup(kind, (1, 1), str(tmp_path / "back"))
        back.restore(tmp_path / "ckpt_0.npz")
        _params_rule(whole_params(back), want_params)
        _same_results(back.test(), want["last"])
        ref = dict(np.load(tmp_path / "single.npz"))
        got = dict(np.load(tmp_path / "ckpt_0.npz"))
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert got[key].shape == ref[key].shape, key
        # the mesh restored from it trains on as one process does
        single.restore(tmp_path / "single.npz")
        loss = single.train_one_epoch()
        for rank, text in enumerate(outs):
            np.testing.assert_allclose(json.loads(text.strip().splitlines()[-1])["resumed"], loss, rtol=1e-5)
            _params_rule(dict(np.load(tmp_path / f"resumed_{rank}.npz")), whole_params(single))


def _cli_data(root) -> None:
    cf = root / "cf"
    cf.mkdir(parents=True)
    rng = np.random.default_rng(0)
    with open(cf / "train.txt", "w") as f_tr, open(cf / "test.txt", "w") as f_te:
        for u in range(64):
            items = rng.choice(96, size=8, replace=False)
            f_tr.write(f"{u} " + " ".join(map(str, items[:6])) + "\n")
            f_te.write(f"{u} " + " ".join(map(str, items[6:])) + "\n")


_CLI = ["--model", "lgn", "--recdim", "8", "--bpr_batch", "64", "--epochs", "2", "--test_span", "1",
        "--testbatch", "32", "--topks", "[5,10]", "--device", "cpu"]


def test_cli_torchrun_mesh(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 4 -m
    furusato_recommend_tpu_torch.cli --mesh_data 2 --mesh_model 2 --device
    cpu``: trains, evaluates and checkpoints; only rank 0 writes, and its
    metrics are the single-process CLI's."""
    from furusato_recommend_tpu_torch.cli import main

    _cli_data(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, PYTHONWARNINGS="ignore")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
           "-m", "furusato_recommend_tpu_torch.cli", *_CLI, "--mesh_data", "2", "--mesh_model", "2",
           "--data_path", str(tmp_path), "--path", str(tmp_path / "mesh")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=180, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.count("[best]") >= 1 and r.stdout.count("model=lgn") == 1  # rank 0 alone prints
    main([*_CLI, "--data_path", str(tmp_path), "--path", str(tmp_path / "one")])
    rows = {}
    for run in ("mesh", "one"):
        rows[run] = [json.loads(line) for line in (tmp_path / run / "lgn" / "metrics.jsonl").read_text().splitlines()]
        assert (tmp_path / run / "lgn" / "8_2__run.ckpt").exists()
    assert len(rows["mesh"]) == len(rows["one"])
    for a, b in zip(rows["mesh"], rows["one"]):
        for key in b:
            if key.startswith(("recall", "ndcg", "precision", "hr", "coverage")):
                assert abs(a[key] - b[key]) <= 1e-6, key
            elif key == "loss":
                np.testing.assert_allclose(a[key], b[key], rtol=1e-4)


def test_cli_mesh_needs_its_world(tmp_path, monkeypatch):
    from furusato_recommend_tpu_torch.cli import main

    _cli_data(tmp_path)
    argv = [*_CLI, "--mesh_data", "2", "--mesh_model", "2", "--data_path", str(tmp_path), "--path", str(tmp_path)]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="needs 4 processes: launch with torchrun"):
        main(argv)
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is 3"):
        main(argv)


def test_default_backend_follows_the_device(monkeypatch):
    """The CLI's backend: gloo on the CPU and for a named card that the
    host's ranks share (NCCL refuses two ranks on one card), NCCL for one
    card a rank."""
    from furusato_recommend_tpu_torch.core.distributed import default_backend

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert [default_backend(d) for d in ("cpu", "cuda", "cuda:0")] == ["gloo", "nccl", "gloo"]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert [default_backend(d) for d in ("cpu", "cuda", "cuda:0")] == ["gloo", "nccl", "nccl"]
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert default_backend(None) == "gloo" and default_backend("cuda:1") == "nccl"


_BAD_WORLD = '''
import sys, time
sys.path.insert(0, sys.argv[1])
from furusato_recommend_tpu_torch.core.distributed import initialize_multihost, shutdown
from furusato_recommend_tpu_torch.core.mesh import make_mesh
initialize_multihost(world_size=1, rank=0, init_method=f"file://{sys.argv[2]}/one", backend="gloo", timeout_s=10)
for call in (lambda: initialize_multihost(world_size=2), lambda: make_mesh(2, 2)):
    try:
        call()
        print("NO RAISE")
    except (RuntimeError, ValueError) as e:
        print("RAISED", type(e).__name__, e)
shutdown()
t0 = time.time()
try:
    initialize_multihost(world_size=2, rank=1, init_method="tcp://127.0.0.1:1", backend="gloo", timeout_s=5)
    print("NO RAISE")
except Exception as e:
    print("RAISED", type(e).__name__, round(time.time() - t0))
'''


def test_world_raises(tmp_path):
    """A world of another size than asked, a mesh on it, and an unreachable
    rendezvous each raise; the last within its timeout."""
    r = subprocess.run([sys.executable, "-c", _BAD_WORLD, REPO, str(tmp_path)], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 3 and "NO RAISE" not in r.stdout, r.stdout
    assert "asked for a world of 2 processes" in lines[0] and "mesh (2, 2) needs 4 ranks" in lines[1]
    assert lines[2].startswith("RAISED") and int(lines[2].split()[-1]) <= 60


_GENERATOR = '''
from furusato_recommend_tpu_torch.core.distributed import host_divergent_generator, is_primary_host, local_rank
a = torch.rand(4, generator=host_divergent_generator(7)).tolist()
b = torch.rand(4, generator=host_divergent_generator(7)).tolist()
print(json.dumps({"a": a, "b": b, "primary": is_primary_host(), "local_rank": local_rank()}))
'''


def test_host_divergent_generator_and_primary(tmp_path):
    """The per-rank stream (the reference's np.random.seed(1000 * rank)):
    the same on a rank each time it is made, another on each rank; rank 0
    alone is the primary."""
    outs = [json.loads(text.strip().splitlines()[-1]) for text in run_world(_GENERATOR, 2, tmp_path)]
    assert all(o["a"] == o["b"] for o in outs)
    assert outs[0]["a"] != outs[1]["a"]
    assert [o["primary"] for o in outs] == [True, False]
    assert [o["local_rank"] for o in outs] == [0, 1]


def test_evaluator_mesh_raises():
    """As the JAX Evaluator: compute_auc under a mesh, and --inference
    sample with a sample_infer_chunk that does not divide by data."""
    ds = synthetic_dataset(n_users=40, m_items=30, avg_degree=4, seed=0)
    mesh = Mesh(2, 2, 0, torch.device("cpu"), {})
    cfg = Config(model="mf", latent_dim=8)
    model = build_model("mf", cfg, ds.graph)
    with pytest.raises(ValueError, match="compute_auc"):
        Evaluator(model, ds.graph, cfg.replace(compute_auc=True), max_train_degree=4, mesh=mesh)
    with pytest.raises(ValueError, match="sample_infer_chunk"):
        Evaluator(model, ds.graph, cfg.replace(inference="sample", sample_infer_chunk=129), max_train_degree=4,
                  mesh=mesh)
    Evaluator(model, ds.graph, cfg.replace(inference="sample", sample_infer_chunk=128), max_train_degree=4,
              mesh=mesh)
    assert mesh.index(DATA_AXIS) == 0 and mesh.index(MODEL_AXIS) == 0
