#!/usr/bin/env python3
"""Three ways to gather the word rows of the text bags that the port's
``SAGE._initial_side_emb`` assembles per id (``models/sage.py::_text_bags``),
timed in a sasrec and an asage training step on the card: through
``table_gather``, as the port writes it (the word table's gradient is one
``scatter_add_rows`` launch), as plain indexing (its gradient PyTorch's
indexing backward) and as ``F.embedding_bag`` with per-sample weights (its
gradient PyTorch's embedding-bag backward). A step's word rows pile onto the
500-word table: sasrec 360,000 rows (every item's three fields of 12 slots),
asage 14.0M (the entity levels of its three attribute trees).

    python3 tools/text_bag_forms.py    # from the repository root; needs a card
    python3 tools/text_bag_forms.py --device cpu --users 400 --items 300  # a rehearsal

The shapes are ``chip_smoke.py`` phase 15's: ``synthetic_structured_dataset(20000,
10000, avg_degree=8, seed=0, rank=16, signal=3.0, popularity_alpha=0.8)`` with
``informative_synthetic_features``; sasrec at d 64, B 2048, the uniform
sampler; asage on ``ddp_flagship_config()`` (d 32, B 5000) with
``Trainer(ddp_recipe=True)``. Per model the forms run in turns (port, index,
embedding_bag, embedding_bag, index, port), each a warm step and then
``--steps`` steps under ``torch.profiler``. The forms compute the same
function: the script first holds their bags and word-table gradients on a
step's item ids against the port's (within 1e-5 of the largest magnitude).

Prints one JSON line: {"device", "smi": "<name>, <power limit>", "max_rel_err", "rows":
[{"model", "form", "device_ms_per_step", "device_ops_per_step", "host_ms_per_step"},
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
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from furusato_recommend_tpu_torch.config import Config, ddp_flagship_config  # noqa: E402
from furusato_recommend_tpu_torch.data.dataset import synthetic_structured_dataset  # noqa: E402
from furusato_recommend_tpu_torch.data.features import informative_synthetic_features  # noqa: E402
from furusato_recommend_tpu_torch.data.sequence import build_sequences  # noqa: E402
from furusato_recommend_tpu_torch.models.registry import build_model  # noqa: E402
from furusato_recommend_tpu_torch.models.sage import SAGE  # noqa: E402
from furusato_recommend_tpu_torch.obs.log import MetricLogger  # noqa: E402
from furusato_recommend_tpu_torch.train.trainer import Trainer  # noqa: E402

# the port's profiler ranges (``record_function``), which also show as spans
# on the card: not work
RANGES = {"spmm_fwd", "spmm_bwd", "table_gather", "scatter_add_rows", "sample_bpr", "evaluate",
          "sample_neighbors", "Optimizer.step#Adam.step"}


def index_bags(self, wids):
    """``SAGE._text_bags`` with the word rows gathered by plain indexing."""
    emb = self.word_emb[wids.clamp_min(0).long()]
    m = (wids >= 0)[..., None].to(emb.dtype)
    return (emb * m).sum(dim=-2) / m.sum(dim=-2).clamp_min(1.0)


def embedding_bag_bags(self, wids):
    """``SAGE._text_bags`` as one ``F.embedding_bag``: each bag a weighted sum
    with weight 1 / |words| on its words and 0 on its pads."""
    flat = wids.reshape(-1, wids.shape[-1])
    valid = (flat >= 0).to(self.word_emb.dtype)
    weights = valid / valid.sum(dim=-1, keepdim=True).clamp_min(1.0)
    out = F.embedding_bag(flat.clamp_min(0).long(), self.word_emb, per_sample_weights=weights, mode="sum")
    return out.reshape(wids.shape[:-1] + (self.word_emb.shape[1],))


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


def forms_agree(model, wids) -> float:
    """The largest difference of each form's bags and word-table gradient
    from the port's, over the port's largest magnitude."""
    out = {}
    for name, fn in (("port", PORT_FORM), ("index", index_bags), ("embedding_bag", embedding_bag_bags)):
        model.word_emb.grad = None
        bags = fn(model, wids)
        bags.square().sum().backward()
        out[name] = (bags.detach(), model.word_emb.grad.clone())
    model.word_emb.grad = None
    worst = 0.0
    for name in ("index", "embedding_bag"):
        for got, want in zip(out[name], out["port"]):
            worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    return worst


PORT_FORM = SAGE._text_bags


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=20_000)
    ap.add_argument("--items", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("text_bag_forms needs a CUDA device (or --device cpu)")
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]

    ds = synthetic_structured_dataset(args.users, args.items, avg_degree=8, seed=0, rank=16, signal=3.0,
                                      popularity_alpha=0.8)
    flagship = ddp_flagship_config().replace(seed=0)
    fs = informative_synthetic_features(ds, flagship, dataset_seed=0, rank=16, seed=0)
    configs = {
        "sasrec": Config(model="sasrec", latent_dim=64, bpr_batch_size=2048, lr=1e-3, decay=1e-6,
                         user_feature="nwt", item_feature="nwt", seed=0),
        "asage": flagship.replace(model="asage"),
    }
    rows, max_rel_err = [], 0.0
    try:
        for name, cfg in configs.items():
            extra = {"sequences": build_sequences(ds)} if name == "sasrec" else {}
            model = build_model(name, cfg, ds.graph, features=fs, generator=torch.Generator().manual_seed(0),
                                **extra)
            trainer = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=name != "sasrec",
                              device=dev)
            trainer.init_state()
            bs = cfg.bpr_batch_size
            batches = trainer.sample_epoch()
            n = min(args.steps, trainer.num_batches)
            blocks = [batches.slice(i * bs, (i + 1) * bs) for i in range(n)]
            items = batches.pos[:bs].long()
            max_rel_err = max(max_rel_err, forms_agree(model, model.features.item.text[items][..., :3, :]))
            assert max_rel_err < 1e-5, f"the forms differ by {max_rel_err} of the largest magnitude"
            forms = (("port", PORT_FORM), ("index", index_bags), ("embedding_bag", embedding_bag_bags))
            for form, fn in forms + forms[::-1]:
                SAGE._text_bags = fn
                trainer.train_epoch(blocks[:1])  # warm
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ms, ops, host = profile_steps(trainer, blocks)
                rows.append({"model": name, "form": form, "device_ms_per_step": ms, "device_ops_per_step": ops,
                             "host_ms_per_step": host})
                print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
            SAGE._text_bags = PORT_FORM
    finally:
        SAGE._text_bags = PORT_FORM
    print(json.dumps({"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                      "smi": smi, "max_rel_err": max_rel_err, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
