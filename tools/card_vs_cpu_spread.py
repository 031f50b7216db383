#!/usr/bin/env python3
"""How far the card's and the CPU's training runs part after a few Adam steps
from the same state, held in three ways: at the end of the run (every
parameter within 2 x lr, all but 1e-3 of them within 1e-6 + 1e-5 |p|, after
all the steps), step by step (the same rule after each optimizer step, the
card then taking the CPU's parameters and Adam moments), and step by step
with the card's ReLUs taking the CPU's gates (``chip_smoke.card_vs_cpu_epoch``,
which also bounds the |x| where a gate differs).

    python3 tools/card_vs_cpu_spread.py                # from the repository root; needs a card
    python3 tools/card_vs_cpu_spread.py --model sasrec --gradients 3 --blocks 40
    python3 tools/card_vs_cpu_spread.py --device cpu --users 1000 --items 500 --blocks 2  # a rehearsal

The state is phase 14's or 15's (``--model rsage | sasrec | asage``): the
key on ``chip_smoke.py``'s anchor20k graph (``synthetic_structured_dataset(
20000, 10000, avg_degree=8, seed=0, rank=16, signal=3.0,
popularity_alpha=0.8)``, ``informative_synthetic_features``; rsage add with
the seeded relation sets) under the phase's recipe, trained 3 epochs on the
card. Then, for each of ``--blocks`` blocks of 4 batches and fanout trees
drawn on the card from seeds 16, 17, ..., the 4 steps run on the card and on
the CPU from the trained parameters with dropout 0, held the three ways.

With ``--gradients S`` it instead trains S states (model seeds 1 .. S) and
holds one step's gradients, card against CPU, on ``--blocks`` batches each
(seed 99), with the card's own ReLU gates and with the CPU's, and prints a
line a state and one JSON line {"device", "smi", "model", "gradients": [{"seed",
"own_gates", "cpu_gates": [the largest relative norm error of a parameter's
gradient, a batch each], "gates_taken", "gate_max_rel_x"}, ...]}.

Prints a line a block (the parameters off by name), then one JSON line:
{"device", "smi": "<name>, <power limit>", "model", "params", "allowed" (1e-3
of the parameters), "at_end": [parameters off after the 4 steps, a block
each], "step_by_step" and "step_by_step_gated": [[off after each step], a
block each], "gate_max_rel_x": the largest |x| / max |x| where a gate was
taken}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from furusato_recommend_tpu_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from furusato_recommend_tpu_torch.data.dataset import synthetic_structured_dataset  # noqa: E402
from furusato_recommend_tpu_torch.data.features import informative_synthetic_features  # noqa: E402
from furusato_recommend_tpu_torch.models import asage, sage, sasrec  # noqa: E402
from furusato_recommend_tpu_torch.models.registry import build_model  # noqa: E402
from furusato_recommend_tpu_torch.obs.log import MetricLogger  # noqa: E402
from furusato_recommend_tpu_torch.train.trainer import Trainer  # noqa: E402

STEPS = 4
EPOCHS = 3  # phases 14 and 15 train each key 3 epochs before the check


def off_at_end(ds, fs, cfg, params, batches, draws, dev) -> dict:
    """The 4 steps on the card and on the CPU, each run from ``params``:
    {name: parameters outside 1e-6 + 1e-5 |p| after the last step}."""
    out = {}
    rates = (sage.DROPOUT_RATE, asage.DROPOUT_RATE, sasrec.DROPOUT)
    sage.DROPOUT_RATE = asage.DROPOUT_RATE = sasrec.DROPOUT = 0.0
    try:
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            model = build_model(cfg.model, cfg, ds.graph, features=fs, **cs.model_inputs_20k(cfg.model, ds))
            params_from_jax(params, model)
            tr = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=cfg.model != "sasrec",
                         device=d)
            tr.train_epoch([b.to(d) for b in batches], draws=[cs._draws_to(t, d) for t in draws])
            out[name] = {k: p.detach().cpu() for k, p in tr.model.named_parameters()}
    finally:
        sage.DROPOUT_RATE, asage.DROPOUT_RATE, sasrec.DROPOUT = rates
    pc, pp = out["card"], out["cpu"]
    return cs.params_off({k: (pc[k] - pp[k]).abs().numpy() for k in pp}, pp)


def gradient_errors(ds, fs, cfg, params, batch, draw, dev) -> tuple:
    """One step's gradients from ``params`` on the CPU (its ReLU gates
    recorded) and on the card twice, with its own gates and with the CPU's:
    (the largest relative norm error of a parameter's gradient without the
    CPU's gates, with them, the gates taken, the largest |x| / max |x| at
    one)."""
    rates = (sage.DROPOUT_RATE, asage.DROPOUT_RATE, sasrec.DROPOUT)
    sage.DROPOUT_RATE = asage.DROPOUT_RATE = sasrec.DROPOUT = 0.0
    gates = cs._ReluGates()
    out = []
    try:
        for d, relu in ((torch.device("cpu"), gates.record), (dev, cs._RELU), (dev, gates.replay)):
            model = build_model(cfg.model, cfg, ds.graph, features=fs, **cs.model_inputs_20k(cfg.model, ds))
            params_from_jax(params, model)
            tr = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=cfg.model != "sasrec",
                         device=d)
            torch.relu = relu
            try:
                loss, _ = tr.model.loss(tr.graph, batch.to(d), generator=tr.generator, **cs._draws_to(draw, d))
                loss.backward()
            finally:
                torch.relu = cs._RELU
            out.append({k: p.grad.detach().cpu() for k, p in tr.model.named_parameters() if p.grad is not None})
    finally:
        sage.DROPOUT_RATE, asage.DROPOUT_RATE, sasrec.DROPOUT = rates
    gp, own, taken = out
    keys = [k for k in gp if gp[k].norm() > 0]
    err = [max(float((g[k] - gp[k]).norm() / gp[k].norm()) for k in keys) for g in (own, taken)]
    return err[0], err[1], int(gates.flips), float(gates.worst)


def trained(ds, fs, name, seed, dev):
    """The key's config and trainer after ``EPOCHS`` epochs from ``seed``."""
    over = {"multi_relational": "add"} if name == "rsage" else {}
    cfg, model = cs.model_20k(ds, fs, name, seed, **over)
    tr = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=name != "sasrec", device=dev)
    tr.init_state()
    for _ in range(EPOCHS):
        tr.train_one_epoch()
    return cfg, tr


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=cs.A20_USERS)
    ap.add_argument("--items", type=int, default=cs.A20_ITEMS)
    ap.add_argument("--blocks", type=int, default=30)
    ap.add_argument("--model", default="rsage", choices=("rsage", "sasrec", "asage"))
    ap.add_argument("--gradients", type=int, default=0,
                    help="instead: one step's gradients, card against CPU, at this many trained states "
                         "(seeds 1, 2, ...), --blocks batches each, with the card's own ReLU gates and the CPU's")
    args = ap.parse_args()
    dev = torch.device(args.device)
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    ds = synthetic_structured_dataset(args.users, args.items, avg_degree=8, seed=0, rank=16, signal=3.0,
                                      popularity_alpha=0.8)
    fs = informative_synthetic_features(ds, cs.a20_config(), dataset_seed=0, rank=16, seed=0)
    if args.model == "rsage":
        with tempfile.TemporaryDirectory() as tmp:
            (ds, fs), _, _ = cs.edge_20k_data(ds, fs, tmp)
    if args.gradients:
        states = []
        for seed in range(cs.SEED + 1, cs.SEED + 1 + args.gradients):
            cfg, tr = trained(ds, fs, args.model, seed, dev)
            params = params_to_numpy(tr.model)
            gen = torch.Generator(device=dev).manual_seed(cs.SEED + 99)
            batches, draws = cs._block(tr, gen, args.blocks)
            errs = [gradient_errors(ds, fs, cfg, params, b, t, dev) for b, t in zip(batches, draws)]
            states.append({"seed": seed, "own_gates": [e[0] for e in errs], "cpu_gates": [e[1] for e in errs],
                           "gates_taken": [e[2] for e in errs], "gate_max_rel_x": max(e[3] for e in errs)})
            print(f"seed {seed}: the largest relative norm error of a gradient, a batch each: with the card's "
                  f"own ReLU gates {[f'{e[0]:.2e}' for e in errs]}; with the CPU's {[f'{e[1]:.2e}' for e in errs]}",
                  flush=True)
        print(json.dumps({"device": str(dev), "smi": smi, "model": args.model, "gradients": states}))
        return
    cfg, tr = trained(ds, fs, args.model, cs.SEED + 1, dev)
    params = params_to_numpy(tr.model)
    at_end, by_step, by_step_gated, worst_gate = [], [], [], 0.0
    for j in range(args.blocks):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 16 + j)
        batches, draws = cs._block(tr, gen, STEPS)
        end = off_at_end(ds, fs, cfg, params, batches, draws, dev)
        runs = {}
        for align in (False, True):
            _, _, per_step, refs, gates = cs.held_steps(ds, fs, cfg, params, batches, draws, dev, align)
            runs[align] = [cs.params_off(diff, ref) for diff, ref in zip(per_step, refs)]
        print(f"block {j}: at the end {end}; step by step {runs[False]}; and with the CPU's ReLU gates "
              f"{runs[True]} (gates taken {gates[0]}, at |x| <= {gates[1]:.3g} x max |x|)", flush=True)
        at_end.append(sum(end.values()))
        by_step.append([sum(o.values()) for o in runs[False]])
        by_step_gated.append([sum(o.values()) for o in runs[True]])
        worst_gate = max(worst_gate, gates[1])
        total = sum(d.size for d in per_step[0].values())
    print(json.dumps({"device": str(dev), "smi": smi, "model": args.model, "params": total, "allowed": 1e-3 * total,
                      "at_end": at_end, "step_by_step": by_step, "step_by_step_gated": by_step_gated,
                      "gate_max_rel_x": worst_gate}))


if __name__ == "__main__":
    main()
