#!/usr/bin/env python3
"""How far the port's SpMM (``ops/segment.py::spmm``: ``torch.sparse.mm`` on
a CSR matrix, cuSPARSE on the card) parts from itself on the same operands,
and how far the LightGCN propagation and a whole evaluation part, eagerly
and captured in a CUDA graph, on the lgn-50k graph of ``chip_smoke.py``
(phases 4-6: ``synthetic_dataset(50000, 20000, avg_degree=30, seed=0)``,
d = 64, L = 2, bfloat16 SpMM operands, random 0.1 * N(0, 1) tables):

    python3 tools/spmm_spread.py [--repeats 5]    # needs a card; --device cpu to rehearse

It is the measurement behind ``chip_smoke.py::evaluation_rule``: a replayed
evaluation is held against an eager one under the propagation's own spread.
Prints one JSON line: {"device", "smi", "spmm": [elements of each repeat that
differ from the first], "elements", "propagate": {"eager", "graph"}: [(differing
elements, max abs difference) a side] against the first eager propagation,
"evaluation": {"ids", "eager", "replays"}: top-K ids that differ from the first
eager evaluation's (the first replay is the capture's)}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from furusato_recommend_tpu_torch.config import Config  # noqa: E402
from furusato_recommend_tpu_torch.data import synthetic_dataset  # noqa: E402
from furusato_recommend_tpu_torch.models.registry import build_model  # noqa: E402
from furusato_recommend_tpu_torch.obs.log import MetricLogger  # noqa: E402
from furusato_recommend_tpu_torch.ops.segment import spmm  # noqa: E402
from furusato_recommend_tpu_torch.train.trainer import Trainer  # noqa: E402


def _parted(a, b) -> list:
    return [(int((x != y).sum()), float((x - y).abs().max())) for x, y in zip(a, b)]


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=50_000)
    ap.add_argument("--items", type=int, default=20_000)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("spmm_spread.py needs a CUDA device (or --device cpu)")
    ds = synthetic_dataset(n_users=args.users, m_items=args.items, avg_degree=30, seed=0)
    cfg = Config(model="lgn", latent_dim=64, n_layers=2, compute_dtype="bfloat16", seed=0, topks=(10, 20),
                 eval_user_batch=1024)
    trainer = Trainer(cfg, ds, build_model("lgn", cfg, ds.graph), logger=MetricLogger(quiet=True), device=dev)
    trainer.init_state()
    model, graph = trainer.model, trainer.graph
    _, _, a, a_t = model._adjacency(graph)
    x = torch.cat([model.user_emb, model.item_emb]).detach()
    products = [spmm(a, x, torch.bfloat16, a_t).clone() for _ in range(args.repeats)]
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "spmm": [int((products[0] != y).sum()) for y in products[1:]], "elements": products[0].numel()}

    def propagate():
        return [t.detach().clone() for t in model.propagate(graph)]

    first = propagate()
    out["propagate"] = {"eager": _parted(first, propagate())}
    ev, data = trainer.evaluator, trainer.eval_data
    if dev.type == "cuda":
        out["smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            propagate()  # the warm-up on the capture stream
        torch.cuda.current_stream(dev).wait_stream(stream)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            held = model.propagate(graph)
        g.replay()
        out["propagate"]["graph"] = _parted(first, [t.clone() for t in held])

    def eager_ids():
        ev.seed()
        return ev.program(data)[3].clone()

    ids = eager_ids()
    out["evaluation"] = {"ids": ids.numel(), "eager": int((eager_ids() != ids).sum())}
    if dev.type == "cuda":
        ev.evaluate(data)  # the warm-up
        out["evaluation"]["replays"] = [int((ev.evaluate(data)[3] != ids).sum()) for _ in range(3)]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
