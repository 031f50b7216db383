#!/usr/bin/env python3
"""The anchor20k quality check through the PyTorch port: the run that
``benchmarks/anchor20k.py --side tpu`` makes with the JAX package, made with
``furusato_recommend_tpu_torch`` on an NVIDIA GPU.

    python3 tools/anchor_torch.py --model textsage --seeds 0 1 2             # R = 1
    python3 tools/anchor_torch.py --model textsage --seeds 0 --relin_every 8
    python3 tools/anchor_torch.py --model lgn --seeds 0 1
    python3 tools/anchor_torch.py --model sasrec --seeds 0

The same data and recipes as the JAX records in ``benchmarks/results/``
(``anchor20k_textsage_tpu_inf_s*.jsonl``, ``anchor20k_lgn_tpu_s*.jsonl``,
``anchor20k_sasrec_tpu_s0.jsonl``):

- data: ``synthetic_structured_dataset(20000, 10000, avg_degree=8, seed=0,
  rank=16, signal=3.0, popularity_alpha=0.8)``, 139,576 train edges;
- textsage: ``informative_synthetic_features(dataset_seed=0, rank=16,
  seed=0)``, ``ddp_flagship_config()`` (d 32, 2 layers, fanout 5, B 5000, lr
  1e-3, decay 1e-6, features n / w / t) with ``Trainer(ddp_recipe=True)``,
  420,000 samples an epoch (440,000 at R = 8: whole blocks), and
  ``--relin_every``;
- lgn: d 32, B 2048, lr 0.01, decay 1e-7, the uniform sampler;
- sasrec: ``synthetic_features(seed=0)`` (the records' "noise" features), the
  train items in order as sequences (``build_sequences``), d 64, 2 layers, B
  2048, lr 1e-3, decay 1e-6, features n / w / t, the uniform sampler;
- 30 epochs, an evaluation (recall and ndcg at 10 and 20 over every user)
  every 3, from ``Trainer.init_state(seed)``.

Each run prints a meta line, then one JSON line per evaluation in the records'
format (``side`` is the device type, ``cuda`` on the card, whose name and power
limit the meta line holds), and writes them to
``{--out_dir}/anchor20k_{model}_{side}[_r{R}]_s{seed}.jsonl``
(default ``tools/results/``, where the curves of its runs on an NVIDIA H100
80GB HBM3 at 700 W are kept, as ``benchmarks/results/`` keeps the JAX
package's). It runs on the card and raises without CUDA unless given
``--device cpu`` (with ``--users`` / ``--items`` to cut the data for a
rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from furusato_recommend_tpu_torch.config import Config, ddp_flagship_config  # noqa: E402
from furusato_recommend_tpu_torch.core.device import resolve_device  # noqa: E402
from furusato_recommend_tpu_torch.data.dataset import synthetic_structured_dataset  # noqa: E402
from furusato_recommend_tpu_torch.data.features import (  # noqa: E402
    informative_synthetic_features,
    synthetic_features,
)
from furusato_recommend_tpu_torch.data.sequence import build_sequences  # noqa: E402
from furusato_recommend_tpu_torch.models.registry import build_model  # noqa: E402
from furusato_recommend_tpu_torch.obs.log import MetricLogger  # noqa: E402
from furusato_recommend_tpu_torch.train.trainer import Trainer  # noqa: E402

N_USERS, M_ITEMS, DSEED = 20_000, 10_000, 0
TRAIN_EDGES = 139_576  # the records' meta lines
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def anchor_dataset(n_users: int = N_USERS, m_items: int = M_ITEMS):
    return synthetic_structured_dataset(
        n_users=n_users, m_items=m_items, avg_degree=8, seed=DSEED, rank=16, signal=3.0,
        popularity_alpha=0.8,
    )


def anchor_config(model: str, seed: int, epochs: int, eval_every: int, relin_every: int = 1) -> Config:
    if model == "textsage":
        return ddp_flagship_config().replace(
            eval_user_batch=2048, topks=(10, 20), seed=seed, epochs=epochs, test_span=eval_every,
            relin_every=relin_every,
        )
    if model == "sasrec":
        return Config(
            model="sasrec", latent_dim=64, bpr_batch_size=2048, lr=1e-3, decay=1e-6, user_feature="nwt",
            item_feature="nwt", eval_user_batch=2048, topks=(10, 20), seed=seed, epochs=epochs, test_span=eval_every,
        )
    return Config(
        model="lgn", latent_dim=32, bpr_batch_size=2048, lr=0.01, decay=1e-7, eval_user_batch=2048,
        topks=(10, 20), seed=seed, epochs=epochs, test_span=eval_every,
    )


def card() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.split(","))
    return {"card": name, "power_limit": limit}


def run(args, ds, inputs: dict, seed: int) -> str:
    cfg = anchor_config(args.model, seed, args.epochs, args.eval_every, args.relin_every)
    device = resolve_device(args.device)
    ddp = args.model == "textsage"
    trainer = Trainer(cfg, ds, build_model(args.model, cfg, ds.graph, **inputs), logger=MetricLogger(quiet=True),
                      ddp_recipe=ddp, device=device)
    tag = f"_r{args.relin_every}" if args.model == "textsage" and args.relin_every != 1 else ""
    path = os.path.join(args.out_dir, f"anchor20k_{args.model}_{device.type}{tag}_s{seed}.jsonl")
    os.makedirs(args.out_dir, exist_ok=True)
    t_start = time.time()
    with open(path, "w") as f:

        def emit(row):
            row = {"model": args.model, "side": device.type, "seed": seed, **row}
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
            f.flush()

        emit({"meta": True, "train_edges": ds.train_size, "samples_per_epoch": trainer.samples_per_epoch,
              "epochs": args.epochs, "recipe": "ddp_flagship" if ddp else "uniform",
              "relin_every": cfg.relin_every, "device": str(device),
              **(card() if device.type == "cuda" else {})})
        trainer.init_state(seed=seed)
        for ep in range(1, args.epochs + 1):
            t0 = time.time()
            loss = trainer.train_one_epoch()  # ends in the epoch's one host sync
            dt = time.time() - t0
            if ep % args.eval_every == 0 or ep == args.epochs:
                r = trainer.test()
                emit({
                    "epoch": ep, "loss": round(loss, 4), "epoch_s": round(dt, 2),
                    "elapsed_s": round(time.time() - t_start, 1),
                    **{k: round(v, 5) for k, v in r.items() if k.startswith(("recall", "ndcg"))},
                })
    print(json.dumps({"done": path, "total_s": round(time.time() - t_start, 1)}), flush=True)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/anchor_torch.py")
    ap.add_argument("--model", default="textsage", choices=["textsage", "lgn", "sasrec"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--relin_every", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--eval_every", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=N_USERS)
    ap.add_argument("--items", type=int, default=M_ITEMS)
    ap.add_argument("--out_dir", default=RESULTS)
    args = ap.parse_args(argv)
    resolve_device(args.device)  # raises without CUDA unless --device cpu

    t0 = time.time()
    ds = anchor_dataset(args.users, args.items)
    if (args.users, args.items) == (N_USERS, M_ITEMS) and ds.train_size != TRAIN_EDGES:
        raise RuntimeError(f"{ds.train_size} train edges, the records have {TRAIN_EDGES}")
    inputs = {}
    if args.model == "textsage":
        inputs["features"] = informative_synthetic_features(ds, anchor_config("textsage", 0, 1, 1),
                                                            dataset_seed=DSEED, rank=16, seed=0)
    elif args.model == "sasrec":
        inputs["features"] = synthetic_features(ds, anchor_config("sasrec", 0, 1, 1), seed=0)
        inputs["sequences"] = build_sequences(ds)
    print(json.dumps({"data_s": round(time.time() - t0, 1), "train_edges": ds.train_size}), flush=True)
    for seed in args.seeds:
        run(args, ds, inputs, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
