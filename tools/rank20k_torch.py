#!/usr/bin/env python3
"""The two-stage ranking protocol at the anchor20k shape through the PyTorch
port: the run that ``benchmarks/rank20k.py`` makes with the JAX package, made
with ``furusato_recommend_tpu_torch`` on an NVIDIA GPU.

    python3 tools/rank20k_torch.py                      # 30 retriever / 40 ranker epochs
    python3 tools/rank20k_torch.py --device cpu --users 400 --items 300 \\
        --retriever_epochs 2 --ranker_epochs 2 --out_dir /tmp/rank   # a CPU rehearsal

The protocol (the reference's ``test.py`` -> ``train_lgbm.py`` ->
``eval_lgbm.py`` at 20k users x 10k items):

1. the data: ``synthetic_structured_dataset(20000, 10000, avg_degree=8,
   seed=0, rank=16, signal=3.0, popularity_alpha=0.8)`` and
   ``informative_synthetic_features(dataset_seed=0, rank=16, seed=0)``,
   written in the reference's layout and read back through
   ``load_text_dataset``: the full train set, and with ``for_lgbm`` the
   reduced one (the last ``len * 0.1 / 0.7`` of each user's train items
   held out; 128,736 reduced and 10,840 held edges);
2. stage A: lgn (d 32, B 2048, lr 0.01, decay 1e-7) and TextSAGE
   (``ddp_flagship_config``, d 32) trained on the reduced set, each user's top
   50 dumped (``dump_candidates``, batches of 2048 users); the parity groups
   (the union labelled by the held-out edges, train positives appended) and
   the aux groups (candidates only, with the retriever-signal columns); the
   parity ranker and the aux ranker (15 warm epochs, the 80% of groups with
   ``users % 5 != 0``) fitted (``NeuralRanker`` at its defaults, 256 groups a
   batch, lr 1e-3, up to 160 candidates);
3. stage B: both retrievers retrained on the full set and dumped again, each
   alone scored by its dump's first 10 columns and by ``Trainer``'s
   evaluation, then ``rerank_eval`` of the parity ranker, the aux ranker and
   the val-calibrated stack (``calibrate`` on the ``users % 5 == 0`` aux
   groups); last, ``rank()``'s time at 4096 users x 100 candidates.

Each row goes to stdout and to ``{--out_dir}/rank20k_{device type}.jsonl``
(default ``tools/results/``) in the JAX record's format
(``benchmarks/results/rank20k.jsonl``); the meta row holds the card's name and
power limit. ``run`` is the protocol itself; ``chip_smoke.py`` phase 17 drives
it at cut epochs with its checks. Raises without CUDA unless given ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from anchor_torch import DSEED, M_ITEMS, N_USERS, TRAIN_EDGES, anchor_config, anchor_dataset, card  # noqa: E402
from furusato_recommend_tpu_torch.config import Config  # noqa: E402
from furusato_recommend_tpu_torch.core.device import resolve_device  # noqa: E402
from furusato_recommend_tpu_torch.data.artifacts import write_reference_features, write_text_dataset  # noqa: E402
from furusato_recommend_tpu_torch.data.dataset import load_text_dataset  # noqa: E402
from furusato_recommend_tpu_torch.data.features import informative_synthetic_features  # noqa: E402
from furusato_recommend_tpu_torch.models.registry import build_model  # noqa: E402
from furusato_recommend_tpu_torch.obs.log import MetricLogger  # noqa: E402
from furusato_recommend_tpu_torch.rank.pipeline import build_rank_groups, dump_candidates, rerank_eval  # noqa: E402
from furusato_recommend_tpu_torch.rank.ranker import NeuralRanker  # noqa: E402
from furusato_recommend_tpu_torch.train.trainer import Trainer  # noqa: E402

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
REDUCED_EDGES, HELD_EDGES = 128_736, 10_840  # the JAX record's lgbm_split row
RETRIEVERS = ("lgn", "textsage")
K_CAND, DUMP_BATCH, LGBM_RATIO = 50, 2048, 0.1
RANKER = dict(batch_groups=256, lr=1e-3)
MAX_CANDIDATES, WARM_EPOCHS, VAL_EVERY = 160, 15, 5  # the aux fit leaves out users % 5 == 0
LATENCY_USERS = 4096


def lgbm_split(data_path: str):
    """(reduced dataset, full dataset, held-out (users, items)) of a data
    directory in the reference's layout: ``load_text_dataset`` with and
    without ``for_lgbm``, the held edges one flat-key setdiff, as ``tools
    train-ranker`` takes them."""
    full = load_text_dataset(Config(data_path=data_path))
    reduced = load_text_dataset(Config(data_path=data_path, for_lgbm=True, lgbm_ratio=LGBM_RATIO))
    m = np.int64(full.m_items)
    held = np.setdiff1d(full.train_user * m + full.train_item, reduced.train_user * m + reduced.train_item)
    return reduced, full, (held // m, held % m)


def train_retriever(ds, fs, name: str, epochs: int, seed: int, device) -> Trainer:
    """A retriever at its anchor recipe (``tools/anchor_torch.py``), trained
    ``epochs`` epochs from ``init_state(seed)``."""
    cfg = anchor_config(name, seed, epochs, max(epochs, 1))
    inputs = {"features": fs} if name == "textsage" else {}
    trainer = Trainer(cfg, ds, build_model(name, cfg, ds.graph, **inputs), logger=MetricLogger(quiet=True),
                      ddp_recipe=name == "textsage", device=device)
    trainer.init_state(seed=seed)
    for _ in range(epochs):
        trainer.train_one_epoch()  # ends in the epoch's one host sync
    return trainer


def candidate_metrics(cand: np.ndarray, eval_dict: Dict[int, np.ndarray], m: int, k: int = 10) -> dict:
    """recall, ndcg and hit rate at k of each user's first k candidates (a
    dump is in score order): the retriever alone under the re-rank protocol."""
    users = np.asarray(sorted(eval_dict), np.int64)
    top = np.asarray(cand, np.int64)[users, :k]
    gt_keys = np.sort(np.concatenate([np.int64(u) * m + np.asarray(eval_dict[int(u)], np.int64) for u in users]))
    gt_lens = np.asarray([len(eval_dict[int(u)]) for u in users], np.float64)
    hit = np.isin(users[:, None] * m + top, gt_keys)
    disc = 1.0 / np.log2(2.0 + np.arange(k))
    idcg = np.cumsum(disc)[np.maximum(np.minimum(gt_lens.astype(int), k), 1) - 1]
    return {
        f"recall@{k}": float(np.mean(hit.sum(1) / np.maximum(gt_lens, 1.0))),
        f"ndcg@{k}": float(np.mean((hit * disc[None, :]).sum(1) / idcg)),
        f"hr@{k}": float(np.mean(hit.any(axis=1))),
    }


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _fit_rankers(reduced, held, fs, ranker_epochs, seed, device, out, timed, emit) -> None:
    """Stage A's groups over the reduced set's dumps, and the parity and aux
    rankers fitted on them."""
    secs = out["seconds"]
    dumps_a = [out["dumps"][(name, "A")] for name in RETRIEVERS]
    groups = timed("groups", lambda: build_rank_groups(reduced, dumps_a, holdout=held,
                                                       max_candidates=MAX_CANDIDATES))
    groups_aux = timed("groups_aux", lambda: build_rank_groups(
        reduced, dumps_a, holdout=held, include_train_positives=False, max_candidates=MAX_CANDIDATES,
        with_retriever_aux=True))
    out["groups"], out["groups_aux"] = groups, groups_aux
    emit(stage="groups", n_groups=len(groups), width=int(groups.items.shape[1]), n_groups_aux=len(groups_aux),
         groups_s=secs["groups"], groups_aux_s=secs["groups_aux"])
    fit_rows = groups_aux.users % VAL_EVERY != 0
    for tag, aux_dim, gr, warm in (("ref", 0, groups, 0),
                                   ("aux", int(groups_aux.aux.shape[-1]), groups_aux.select(fit_rows),
                                    WARM_EPOCHS)):
        rk = NeuralRanker(fs, aux_dim=aux_dim).to(device)
        losses = timed(f"fit_{tag}", lambda: rk.fit(gr, epochs=ranker_epochs, seed=seed,
                                                    aux_warm_epochs=warm, **RANKER))
        out[f"ranker_{tag}"], out[f"losses_{tag}"] = rk, losses.cpu().numpy()
        emit(stage="ranker_fit", variant=tag, groups=len(gr), fit_s=secs[f"fit_{tag}"],
             groups_per_s=len(gr) * ranker_epochs / secs[f"fit_{tag}"],
             loss_first=float(out[f"losses_{tag}"][0]), loss_last=float(out[f"losses_{tag}"][-1]))


def run(
    reduced,
    full,
    held,
    fs,
    retriever_epochs: int,
    ranker_epochs: int,
    device,
    seed: int = 0,
    emit: Callable[..., None] = lambda **row: None,
    part: Callable[[str], contextlib.AbstractContextManager] = lambda name: contextlib.nullcontext(),
) -> dict:
    """The protocol's stages A and B; ``emit(**row)`` takes each record row,
    ``part(name)`` wraps each part (for launch counts). Returns every
    trainer, dump, group set, ranker, result and host second."""
    out: dict = {"seconds": {}, "trainers": {}, "dumps": {}, "alone": {}, "trainer_eval": {}}
    secs = out["seconds"]

    def timed(name, fn):
        with part(name):
            _sync(device)
            t0 = time.perf_counter()
            res = fn()
            _sync(device)
            secs[name] = time.perf_counter() - t0
        return res

    for stage, ds in (("A", reduced), ("B", full)):
        for name in RETRIEVERS:
            tr = timed(f"train_{name}_{stage}", lambda: train_retriever(ds, fs, name, retriever_epochs, seed, device))
            cand = timed(f"dump_{name}_{stage}", lambda: dump_candidates(tr.model, tr.graph, k=K_CAND,
                                                                         batch=DUMP_BATCH, device=device))
            out["trainers"][(name, stage)] = tr
            out["dumps"][(name, stage)] = cand
            row = {"stage": stage, "retriever": name, "train_s": secs[f"train_{name}_{stage}"],
                   "dump_s": secs[f"dump_{name}_{stage}"]}
            if stage == "B":
                with part(f"evaluate_{name}"):
                    results, topk = tr.evaluator(tr.eval_data)
                alone = candidate_metrics(cand, full.test_dict(), full.m_items)
                out["alone"][name], out["trainer_eval"][name] = alone, (results, topk)
                row.update({f"alone_{k}": v for k, v in alone.items()},
                           **{f"trainer_{k}": results[k] for k in ("recall@10", "ndcg@10")})
            emit(**row)
        if stage == "A":
            _fit_rankers(reduced, held, fs, ranker_epochs, seed, device, out, timed, emit)

    eval_dict = full.test_dict()
    dumps_b = [out["dumps"][(name, "B")] for name in RETRIEVERS]
    res = timed("rerank", lambda: rerank_eval(out["ranker_ref"], full, dumps_b, eval_dict, k=10))
    emit(stage="rerank", rerank_s=secs["rerank"], **res)
    res_aux = timed("rerank_aux", lambda: rerank_eval(out["ranker_aux"], full, dumps_b, eval_dict, k=10))
    emit(stage="rerank_aux", rerank_s=secs["rerank_aux"], **res_aux,
         wa=[float(x) for x in out["ranker_aux"].wa.detach().cpu()])
    g_val = out["groups_aux"].select(out["groups_aux"].users % VAL_EVERY == 0)
    stack, (beta, gamma, val_r) = timed("calibrate", lambda: out["ranker_aux"].calibrate(g_val, k=10))
    res_cal = timed("rerank_stack", lambda: rerank_eval(stack, full, dumps_b, eval_dict, k=10))
    emit(stage="rerank_stack", beta=beta, gamma=gamma, val_recall=val_r, calibrate_s=secs["calibrate"],
         rerank_s=secs["rerank_stack"], **res_cal)
    out.update(ranker_stack=stack, calibration=(beta, gamma, val_r),
               rerank={"ref": res, "aux": res_aux, "stack": res_cal})
    return out


def rank_latency_ms(ranker: NeuralRanker, full, dumps, reps: int = 20) -> dict:
    """CUDA-event ms of ``rank()`` at 4096 users x 100 candidates (the two
    dumps side by side, every slot valid, as the JAX record times it)."""
    users = torch.arange(LATENCY_USERS, device=ranker.device, dtype=torch.int32)
    cand = torch.from_numpy(np.concatenate([d[:LATENCY_USERS] for d in dumps], axis=1)).to(ranker.device)
    mask = torch.ones_like(cand, dtype=torch.bool)

    def call():
        return ranker.rank(users, cand, k=10, mask=mask)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        call()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / reps
    return {"batch": LATENCY_USERS, "cand_width": int(cand.shape[1]), "call_ms": ms,
            "users_per_s": LATENCY_USERS / (ms / 1e3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/rank20k_torch.py")
    ap.add_argument("--retriever_epochs", type=int, default=30)
    ap.add_argument("--ranker_epochs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=N_USERS)
    ap.add_argument("--items", type=int, default=M_ITEMS)
    ap.add_argument("--out_dir", default=RESULTS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises without CUDA unless --device cpu
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"rank20k_{device.type}.jsonl")
    t_start = time.time()
    with open(path, "w") as f, tempfile.TemporaryDirectory() as tmp:

        def emit(**row):
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
            f.flush()

        ds = anchor_dataset(args.users, args.items)
        full_size = (args.users, args.items) == (N_USERS, M_ITEMS)
        if full_size and ds.train_size != TRAIN_EDGES:
            raise RuntimeError(f"{ds.train_size} train edges, the record has {TRAIN_EDGES}")
        fs = informative_synthetic_features(ds, anchor_config("textsage", 0, 1, 1), dataset_seed=DSEED, rank=16,
                                            seed=0)
        write_text_dataset(ds, tmp)  # the reference's layout, read back as load_text_dataset reads it
        write_reference_features(fs, tmp)
        reduced, full, held = lgbm_split(tmp)
        emit(meta=True, features="informative", n_users=full.n_users, m_items=full.m_items,
             train_edges=full.train_size, lgbm_ratio=LGBM_RATIO, k_cand=K_CAND,
             retriever_epochs=args.retriever_epochs, ranker_epochs=args.ranker_epochs, device=str(device),
             **(card() if device.type == "cuda" else {}))
        emit(stage="lgbm_split", reduced_edges=reduced.train_size, held_edges=len(held[0]))
        if full_size and (reduced.train_size, len(held[0])) != (REDUCED_EDGES, HELD_EDGES):
            raise RuntimeError(f"split {reduced.train_size} / {len(held[0])}, the record's "
                               f"{REDUCED_EDGES} / {HELD_EDGES}")
        out = run(reduced, full, held, fs, args.retriever_epochs, args.ranker_epochs, device, args.seed, emit)
        if device.type == "cuda":
            emit(stage="rank_latency", **rank_latency_ms(out["ranker_ref"], full,
                                                         [out["dumps"][(n, "B")] for n in RETRIEVERS]))
        emit(done=True, total_s=time.time() - t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
