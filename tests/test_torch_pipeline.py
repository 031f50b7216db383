"""``--pipeline_dispatch`` in the port's trainer (``train/trainer.py``): the
next epoch's triplets drawn before the epoch's loss is read, from a copy of
the trainer's generator, held on the CPU against the same trainer with
``pipeline_dispatch=False``.

- mf, lgn (edge dropout on), textsage, and textsage at R = 8 and T = 4: 3
  epochs pipelined against 3 synchronous ones from the same seed, the
  prefetched triplets, the per-step losses, the parameters and the generator
  states bit-equal after every epoch;
- a save with a prefetch outstanding (the generator's state, which is the
  state before the draw), restored into a fresh trainer, continuing the
  synchronous stream (the counterpart of the JAX package's
  ``test_pipeline_dispatch_equals_sync``);
- a direct ``train_epoch`` or ``sample_epoch`` after a prefetch, and a
  generator moved by its caller, drawing the synchronous stream;
- ``fit`` leaving no prefetch after its last epoch; ``dask`` staying
  synchronous; the CLI's flag reaching the trainer.

The card's pipelined epochs (replays) are held against synchronous ones in
``tests/test_torch_kernels.py`` (marked ``cuda``) and ``chip_smoke.py``'s
phase 21.
"""

import dataclasses

import numpy as np
import pytest
import torch

from furusato_recommend_tpu_torch import cli as tcli
from furusato_recommend_tpu_torch.config import Config, ddp_flagship_config
from furusato_recommend_tpu_torch.data import dataset as tds
from furusato_recommend_tpu_torch.data.artifacts import main as write_artifacts
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.data.ooc import MemmapNumeric
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.train import trainer as trainer_module
from furusato_recommend_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

N_USERS, M_ITEMS, DIM = 80, 96, 8
EPOCHS = 3

# case -> (registry key, config fields)
CASES = {
    "mf": ("mf", {}),
    "lgn": ("lgn", {"dropout": True, "keep_prob": 0.7}),
    "textsage": ("textsage", {}),
    "textsage_r8": ("textsage", {"relin_every": 8}),
    "textsage_t4": ("textsage", {"feature_update_every": 4}),
}


def _trainer(key: str, pipeline: bool, tmp_path=None, **over) -> Trainer:
    td = tds.synthetic_dataset(n_users=N_USERS, m_items=M_ITEMS, avg_degree=6, seed=5)
    if key in ("mf", "lgn"):
        cfg = Config(model=key, latent_dim=DIM, n_layers=2, bpr_batch_size=64, lr=1e-2, eval_user_batch=32,
                     topks=(5,), compute_dtype="float32", seed=7, pipeline_dispatch=pipeline, **over)
        return Trainer(cfg, td, build_model(key, cfg, td.graph), logger=MetricLogger(quiet=True), device="cpu")
    fields = dataclasses.asdict(ddp_flagship_config())
    fields.pop("mesh")
    fields.update(model=key, latent_dim=DIM, num_neighbors=3, bpr_batch_size=128, eval_user_batch=32, topks=(5,),
                  test_count=1, compute_dtype="float32", lr=1e-2, seed=3, train_iterative=1,
                  pipeline_dispatch=pipeline, **over)
    cfg = Config(**fields)
    fs = synthetic_features(td, cfg, seed=1)
    inputs = {}
    if key == "dask":  # its numeric matrices on disk
        inputs["ooc_numeric"] = {side: MemmapNumeric.write(str(tmp_path / f"{side}.npy"),
                                                           getattr(fs, side).numeric.numpy())
                                 for side in ("user", "item")}
        fs = dataclasses.replace(fs, user=dataclasses.replace(fs.user, numeric=None),
                                 item=dataclasses.replace(fs.item, numeric=None))
    model = build_model(key, cfg, td.graph, features=fs, **inputs)
    return Trainer(cfg, td, model, logger=MetricLogger(quiet=True), ddp_recipe=True, device="cpu")


def _pair(case: str):
    key, over = CASES[case]
    pipe, sync = _trainer(key, True, **over), _trainer(key, False, **over)
    for tr in (pipe, sync):
        tr.init_state()
    assert pipe.pipeline and not sync.pipeline
    return pipe, sync


def _batches_equal(a, b) -> None:
    for x, y in zip((a.user, a.pos, a.neg, a.valid), (b.user, b.pos, b.neg, b.valid)):
        assert torch.equal(x, y)


def _same_state(a: Trainer, b: Trainer) -> None:
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for (k, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), k


def _epoch_equal(pipe: Trainer, sync: Trainer) -> None:
    """One epoch of each, bit-equal; the prefetched triplets (drawn after the
    pipelined epoch) equal to the synchronous trainer's next draw from its
    generator, which stands where the pipelined one's stands."""
    lp, ls = pipe.train_one_epoch(), sync.train_one_epoch()
    assert lp == ls
    assert torch.equal(pipe.epoch_losses, sync.epoch_losses)
    _same_state(pipe, sync)
    assert pipe.prefetched is not None and sync.prefetched is None
    state = sync.generator.get_state()
    _batches_equal(pipe.prefetched, sync.sample_epoch())
    sync.generator.set_state(state)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_epochs_equal_synchronous_ones(case):
    pipe, sync = _pair(case)
    for _ in range(EPOCHS):
        _epoch_equal(pipe, sync)
    assert pipe.step == sync.step == EPOCHS


@pytest.mark.parametrize("case", ["lgn", "textsage_r8"])
def test_save_with_a_prefetch_outstanding_resumes_the_synchronous_stream(case, tmp_path):
    pipe, sync = _pair(case)
    _epoch_equal(pipe, sync)
    assert pipe.prefetched is not None  # a prefetch IS outstanding
    pipe.save(tmp_path / "mid.ckpt")
    key, over = CASES[case]
    resumed = _trainer(key, True, **over)
    resumed.restore(tmp_path / "mid.ckpt")
    assert resumed.prefetched is None
    _same_state(resumed, sync)
    for _ in range(2):
        _epoch_equal(resumed, sync)
    # and the pipelined trainer that saved, consuming its own prefetch
    other = _trainer(key, False, **over)
    other.restore(tmp_path / "mid.ckpt")
    for _ in range(2):
        pipe.train_one_epoch()
        other.train_one_epoch()
    assert torch.equal(pipe.epoch_losses, other.epoch_losses)
    _same_state(pipe, other)


def test_checkpoints_written_with_and_without_a_prefetch_are_equal(tmp_path):
    from furusato_recommend_tpu_torch.core.checkpoint import load_checkpoint

    pipe, sync = _pair("textsage")
    _epoch_equal(pipe, sync)
    pipe.save(tmp_path / "p.ckpt")
    sync.save(tmp_path / "s.ckpt")
    a, b = load_checkpoint(tmp_path / "p.ckpt"), load_checkpoint(tmp_path / "s.ckpt")
    np.testing.assert_array_equal(a["state"]["generator"], b["state"]["generator"])
    for k in b["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])


@pytest.mark.parametrize("case", ["lgn", "textsage"])
def test_direct_draws_after_a_prefetch_take_the_synchronous_stream(case):
    """A direct ``train_epoch`` (its steps draw dropout or the trees) and a
    direct ``sample_epoch`` after a prefetch drop it and draw from the
    generator where a synchronous trainer's stands; so does an epoch after
    the caller moved the generator."""
    pipe, sync = _pair(case)
    _epoch_equal(pipe, sync)
    bs = pipe.config.bpr_batch_size
    state = sync.generator.get_state()
    batches = sync.sample_epoch()  # the batches only: the generator set back
    sync.generator.set_state(state)
    batches = [batches.slice(b * bs, (b + 1) * bs) for b in range(2)]
    got, want = pipe.train_epoch(batches), sync.train_epoch(batches)
    assert pipe.prefetched is None
    assert torch.equal(got, want)
    _same_state(pipe, sync)
    _epoch_equal(pipe, sync)
    _batches_equal(pipe.sample_epoch(), sync.sample_epoch())
    assert pipe.prefetched is None
    _same_state(pipe, sync)
    _epoch_equal(pipe, sync)
    for tr in (pipe, sync):  # the caller moves the generator: the prefetch is stale
        tr.generator.manual_seed(123)
    _epoch_equal(pipe, sync)


def test_init_state_drops_the_prefetch():
    pipe, sync = _pair("mf")
    _epoch_equal(pipe, sync)
    pipe.init_state()
    sync.init_state()
    assert pipe.prefetched is None
    _epoch_equal(pipe, sync)


@pytest.mark.parametrize("case", ["mf", "textsage"])
def test_fit_leaves_no_prefetch_after_its_last_epoch(case, monkeypatch):
    pipe, sync = _pair(case)
    drawn = []
    real = Trainer._prefetch_next

    def spy(self):
        drawn.append(self.step)
        real(self)

    monkeypatch.setattr(Trainer, "_prefetch_next", spy)
    got = pipe.fit(epochs=EPOCHS)
    want = sync.fit(epochs=EPOCHS)
    assert pipe.prefetched is None and drawn == list(range(EPOCHS - 1))
    assert got == want
    _same_state(pipe, sync)


def test_dask_stays_synchronous(tmp_path):
    tr = _trainer("dask", True, tmp_path)
    tr.init_state()
    assert tr.config.pipeline_dispatch and not tr.pipeline
    tr.train_one_epoch()
    assert tr.prefetched is None


def _text_dataset(root):
    rng = np.random.default_rng(0)
    data = root / "data" / "cf"
    data.mkdir(parents=True)
    with open(data / "train.txt", "w") as f, open(data / "test.txt", "w") as g:
        for u in range(50):
            items = rng.choice(60, size=rng.integers(6, 10), replace=False)
            f.write(f"{u} " + " ".join(map(str, items[:-2])) + "\n")
            g.write(f"{u} " + " ".join(map(str, items[-2:])) + "\n")
    write_artifacts(["--data_path", str(root / "data"), "--seed", "1"])


@pytest.mark.parametrize("flag,want", [([], True), (["--no-pipeline_dispatch"], False)])
def test_cli_flag_reaches_the_trainer_without_a_notice(flag, want, tmp_path, capsys, monkeypatch):
    _text_dataset(tmp_path)
    made = []
    real = trainer_module.Trainer.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(trainer_module.Trainer, "__init__", spy)
    tcli.main(["--model", "mf", "--recdim", "8", "--bpr_batch", "128", "--epochs", "2", "--test_span", "1",
               "--topks", "[5]", "--testbatch", "32", "--data_path", str(tmp_path / "data"),
               "--path", str(tmp_path / "ck"), "--device", "cpu"] + flag)
    out = capsys.readouterr().out
    assert not any("pipeline_dispatch" in line for line in out.splitlines())
    assert len(made) == 1 and made[0].pipeline is want
    assert made[0].prefetched is None  # fit's last epoch draws none
