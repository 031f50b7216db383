#!/usr/bin/env python3
"""Two ways to write the sampled multi-head attention of the port's
``transformer`` conv (``models/sage_convs.py::_mh_attention``), timed in a
tgrec training step on the card: as the port writes it (its two contractions
as broadcast products and sums) and as two einsums (which torch lowers to
batched products of one row by dh columns, one per node and head).

    python3 tools/attention_forms.py    # from the repository root; needs a card
    python3 tools/attention_forms.py --device cpu --users 400 --items 300  # a rehearsal

The shape is ``chip_smoke.py`` phase 13's: ``synthetic_structured_dataset(20000,
10000, avg_degree=8, seed=0, rank=16, signal=3.0, popularity_alpha=0.8)`` with
``informative_synthetic_features``, ``tgrec`` on ``ddp_flagship_config()`` (d
32, 8 heads of 4, B 5000) and ``Trainer(ddp_recipe=True)``. The forms run in
turns (broadcast, einsum, einsum, broadcast), each a warm step and then
``--steps`` steps under ``torch.profiler``. Both forms compute the same
function; the script first holds their outputs on seeded inputs of a
step's shape against each other (max abs err below 1e-4).

Prints one JSON line: {"device", "smi": "<name>, <power limit>", "max_abs_err", "rows":
[{"form", "device_ms_per_step", "device_ops_per_step", "host_ms_per_step"},
...]}; on the CPU the device numbers are null.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from furusato_recommend_tpu_torch.config import ddp_flagship_config  # noqa: E402
from furusato_recommend_tpu_torch.data.dataset import synthetic_structured_dataset  # noqa: E402
from furusato_recommend_tpu_torch.data.features import informative_synthetic_features  # noqa: E402
from furusato_recommend_tpu_torch.models import sage_convs  # noqa: E402
from furusato_recommend_tpu_torch.models.registry import build_model  # noqa: E402
from furusato_recommend_tpu_torch.obs.log import MetricLogger  # noqa: E402
from furusato_recommend_tpu_torch.train.trainer import Trainer  # noqa: E402


# the port's profiler ranges (``record_function``), which also show as spans
# on the card: not work
RANGES = {"spmm_fwd", "spmm_bwd", "table_gather", "scatter_add_rows", "sample_bpr", "evaluate",
          "sample_neighbors", "Optimizer.step#Adam.step"}


def einsum_attention(lp, target, nbrs):
    """``sage_convs._mh_attention`` with its two contractions as einsums."""
    d = target.shape[-1]
    dh = d // sage_convs.N_HEADS
    q = (target @ lp["wq"]).reshape(target.shape[:-1] + (sage_convs.N_HEADS, dh))
    k = (nbrs @ lp["wk"]).reshape(nbrs.shape[:-1] + (sage_convs.N_HEADS, dh))
    v = (nbrs @ lp["wv"]).reshape(nbrs.shape[:-1] + (sage_convs.N_HEADS, dh))
    e = torch.einsum("...hd,...fhd->...fh", q, k) / dh**0.5
    alpha = torch.softmax(e, dim=-2)
    return torch.einsum("...fh,...fhd->...hd", alpha, v).reshape(target.shape)


def profile_steps(trainer, blocks) -> tuple:
    """(device ms, device operations, host ms) a step over ``blocks``; the
    device numbers are None off the card."""
    cuda = trainer.device.type == "cuda"
    if not cuda:
        t0 = time.perf_counter()
        trainer.train_epoch(blocks)
        return None, None, 1e3 * (time.perf_counter() - t0) / len(blocks)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(blocks)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / len(blocks)
    work = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in RANGES]
    us = sum(e.time_range.elapsed_us() for e in work)
    return us / 1e3 / len(blocks), len(work) / len(blocks), host_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=20_000)
    ap.add_argument("--items", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("attention_forms needs a CUDA device (or --device cpu)")
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]

    ds = synthetic_structured_dataset(args.users, args.items, avg_degree=8, seed=0, rank=16, signal=3.0,
                                      popularity_alpha=0.8)
    cfg = ddp_flagship_config().replace(model="tgrec", seed=0)
    fs = informative_synthetic_features(ds, cfg, dataset_seed=0, rank=16, seed=0)
    model = build_model("tgrec", cfg, ds.graph, features=fs, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=True, device=dev)
    trainer.init_state()
    bs = cfg.bpr_batch_size
    batches = trainer.sample_epoch()
    n = min(args.steps, trainer.num_batches)
    blocks = [batches.slice(i * bs, (i + 1) * bs) for i in range(n)]

    port_form = sage_convs._mh_attention
    # the two forms compute the same function: a step's shape, seeded inputs
    gen = torch.Generator(device=dev).manual_seed(1)
    d, f = cfg.latent_dim, cfg.num_neighbors
    lp = {name: torch.randn((d, d), generator=gen, device=dev) / d**0.5 for name in ("wq", "wk", "wv")}
    target = torch.randn((bs, d), generator=gen, device=dev)
    nbrs = torch.randn((bs, f, d), generator=gen, device=dev)
    max_abs_err = float((port_form(lp, target, nbrs) - einsum_attention(lp, target, nbrs)).abs().max())
    assert max_abs_err < 1e-4, f"the forms differ by {max_abs_err}"
    rows = []
    try:
        for form, fn in (("broadcast", port_form), ("einsum", einsum_attention),
                         ("einsum", einsum_attention), ("broadcast", port_form)):
            sage_convs._mh_attention = fn
            trainer.train_epoch(blocks[:1])  # warm
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms, ops, host = profile_steps(trainer, blocks)
            rows.append({"form": form, "device_ms_per_step": ms, "device_ops_per_step": ops,
                         "host_ms_per_step": host})
    finally:
        sage_convs._mh_attention = port_form
    print(json.dumps({"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                      "smi": smi, "max_abs_err": max_abs_err, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
