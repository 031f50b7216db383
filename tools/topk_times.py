#!/usr/bin/env python3
"""Times ``masked_topk`` of a checkout of the port on the card at the serving
and evaluation shapes of ``chip_smoke.py``, so that two checkouts (a parent
and a change) can be compared in one machine, in turns:

    python3 tools/topk_times.py [--root DIR]    # needs a card and nvcc

``--root`` is the checkout whose ``furusato_recommend_tpu_torch`` is imported
and built (default: this one). The shapes, with random 0.1 * N(0, 1) tables
and train rows from a numpy seed:
  lgn       N = 50000, M = 20000, d = 64, rows of 5-60 ids (phases 4-5):
            B = 1, 64, 512, 1024 at k = 20, B = 512 at k = 10, B = 2048 at
            k = 256
  textsage  N = 100000, M = 30000, d = 32, rows of 3-13 ids (phase 9):
            B = 1, 64, 512, 1024 at k = 20
  a20       N = 20000, M = 10000, d = 32, rows of 3-13 ids (phases 12-13):
            B = 2048 at k = 10 and 20 (the evaluation tile), B = 512 at k = 20
            and at k = 200, B = 1000 at k = 200 (production-20k's batch); a
            checkout whose kernel takes k <= 128 reports null above it

Prints one JSON line: {"root", "device", "smi": "<name>, <power limit>",
"blocks_per_sm": {"k20_d64": ..., ...} (pass 1, occupancy API), "rows":
[{"shape", "B", "k", "call_ms", "device_ms", "kernels"}, ...]}: "call_ms" the
median of CUDA-event times around 30 wrapper calls, "device_ms" the
profiler's device time a call over 20 calls (every kernel of the call and its
fills), "kernels" that time by kernel name.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = {  # name: (N, M, d, shortest row, longest row + 1, [(B, k), ...])
    "lgn": (50_000, 20_000, 64, 5, 60, [(1, 20), (64, 20), (512, 20), (1024, 20), (512, 10), (2048, 256)]),
    "textsage": (100_000, 30_000, 32, 3, 14, [(1, 20), (64, 20), (512, 20), (1024, 20)]),
    "a20": (20_000, 10_000, 32, 3, 14, [(2048, 10), (2048, 20), (512, 20), (512, 200), (1000, 200)]),
}


def event_ms(fn, reps=30) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, n=20) -> tuple:
    """(device ms a call, {kernel name: device ms a call})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:48]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / n / 1e3
    return sum(by_name.values()), by_name


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from furusato_recommend_tpu_torch.ops import streaming_topk as st

    assert Path(st.__file__).resolve().is_relative_to(root), st.__file__
    if not torch.cuda.is_available():
        raise SystemExit("topk_times needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    occupancy = {f"k{k}_d{d}": st._blocks_per_sm(0, k, d) for k in (20, 64, 128) for d in (64, 100)}
    rows = []
    for name, (n, m, d, lo, hi, cases) in SHAPES.items():
        rng = np.random.default_rng(0)
        U = torch.from_numpy((0.1 * rng.standard_normal((n, d))).astype(np.float32)).to(dev)
        I = torch.from_numpy((0.1 * rng.standard_normal((m, d))).astype(np.float32)).to(dev)
        lens = rng.integers(lo, hi, size=n)
        indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)).to(dev)
        indices = torch.from_numpy(np.concatenate(
            [np.sort(rng.choice(m, size=int(c), replace=False)) for c in lens]).astype(np.int32)).to(dev)
        for b, k in cases:
            users = torch.from_numpy(rng.choice(n, b, replace=False)).to(dev)

            def call(users=users, k=k):
                return st.masked_topk(U, I, users, k, indptr, indices)

            try:
                call()
            except ValueError as e:  # a kernel of k <= 128
                rows.append({"shape": name, "B": b, "k": k, "call_ms": None, "device_ms": None,
                             "error": str(e)})
                continue
            dev_ms, by_name = device_ms(call)
            rows.append({"shape": name, "B": b, "k": k, "call_ms": event_ms(call), "device_ms": dev_ms,
                         "kernels": by_name})
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0), "smi": smi,
                      "blocks_per_sm": occupancy, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
