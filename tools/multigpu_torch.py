#!/usr/bin/env python3
"""The mesh over NCCL, one rank a card, on every card of the machine.

    python3 tools/multigpu_torch.py            # a machine with 2 or more cards

The runs of ``chip_smoke.py``'s phase 19 (the DDP flagship, textsage at d 32,
and lgn at d 64, both with the ddp recipe, float32 SpMM operands, an
evaluation, 2 epochs and an evaluation on the anchor20k graph and features,
written in the reference's layout under a temporary directory), made on one
card in one process, then on a (2, 1) mesh of 2 cards and a (2, 2) mesh of 4
cards where the machine has them, each rank a process on card ``cuda:{rank}``
with NCCL collectives. Every mesh is held against the one-card run under
phase 19's rules (``chip_smoke.check_mesh``), and the samples/s of each run
are printed beside the cards' name and power limit: here each rank has a
card of its own, so the samples/s do say how the mesh scales. Raises on a
machine with fewer than 2 cards. The last line is one JSON object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from furusato_recommend_tpu_torch.data.artifacts import write_reference_features, write_text_dataset  # noqa: E402

MESHES = {2: (2, 1), 4: (2, 2)}


def main() -> int:
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        raise SystemExit(f"tools/multigpu_torch.py needs 2 or more cards; this machine has {cards}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    cs._cuda.build()
    ds, fs, _ = cs.anchor20k_data()
    out = {"cards": smi, "runs": {}}
    with tempfile.TemporaryDirectory() as root:
        data_dir = os.path.join(root, "data")
        write_text_dataset(ds, data_dir)
        write_reference_features(fs, data_dir)
        t0 = time.perf_counter()
        single = cs.mesh_single(data_dir, torch.device("cuda", 0), root)
        out["runs"]["1"] = {kind: {"samples_per_s": single[kind]["samples_per_s"], "epoch_s": single[kind]["epoch_s"],
                                   "losses": single[kind]["losses"], "last": single[kind]["last"]}
                            for kind in ("textsage", "lgn")}
        print(f"1 card: {time.perf_counter() - t0:.0f} s", flush=True)
        for n, mesh in MESHES.items():
            if n > cards:
                continue
            run_dir = os.path.join(root, f"mesh{n}")
            ranks, wall = cs.launch_mesh(mesh, data_dir, run_dir, "nccl", "cuda:{rank}")
            facts = cs.check_mesh(single, ranks, run_dir, data_dir, f"{n} cards {mesh}")
            out["runs"][str(n)] = {"mesh": list(mesh), "wall_s": wall, **facts}
        for kind in ("textsage", "lgn"):
            rates = {n: (run[kind]["samples_per_s"] if n == "1" else run[kind]["ranks"][0]["samples_per_s"])
                     for n, run in out["runs"].items()}
            print(f"{kind} samples/s by cards (NCCL, one rank a card): "
                  + ", ".join(f"{n}: {r:.0f}" for n, r in rates.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
