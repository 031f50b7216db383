"""The scatter-add kernel's modes, side by side on the card: builds
``csrc/scatter_add_rows.cu``, holds every mode against the plain version at
each shape, and times each mode and ``index_add_`` there.

    python3 tools/scatter_modes.py    # from the repository root; needs a card and nvcc

Shapes (N, R, D), ids drawn on the host from seed 0:
  tree_item_zipf   (30000, 285000, 32)  Zipf(1.2) ids, the largest id ~18% of rows
  tree_item_hub    (30000, 285000, 32)  uniform ids, 9.7% of the rows on one id
  tree_user        (100000, 180000, 32) uniform ids
  categorical      (40, 400000, 32)     uniform ids
  lgn_user         (50000, 8192, 64)    uniform ids
  lgn_item         (20000, 16384, 64)   half Zipf(1.2), half uniform ids
Modes: the plan's own (``plan_scatter``), and row and tile forced through the
wrapper's private launch; tile_scalar is the tile plan with 4-byte loads and
adds where D % 4 == 0 would take 16 bytes.

Prints the build's register and spill lines, the count of shared-memory
atomic instructions in the tile kernel's machine code when ``cuobjdump`` is
there, and one JSON line: {"device", "smi", "shapes": [{"name", "N", "R", "D",
"plan": {mode: plan}, "device_ms": {mode: median of three rounds of the
profiler's device time a call, memset included}, "max_abs_err"}, ...]}.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from furusato_recommend_tpu_torch.ops import _cuda  # noqa: E402
from furusato_recommend_tpu_torch.ops import scatter as sc  # noqa: E402

TOL = 1e-5


def _shapes(rng):
    hub = rng.integers(0, 30000, 285000)
    hub[rng.permutation(285000)[:27645]] = 123  # 9.7% of the rows
    half = 16384 // 2
    return [
        ("tree_item_zipf", 30000, np.minimum(rng.zipf(1.2, 285000) - 1, 29999), 32),
        ("tree_item_hub", 30000, hub, 32),
        ("tree_user", 100000, rng.integers(0, 100000, 180000), 32),
        ("categorical", 40, rng.integers(0, 40, 400000), 32),
        ("lgn_user", 50000, rng.integers(0, 50000, 8192), 64),
        ("lgn_item", 20000, np.concatenate([np.minimum(rng.zipf(1.2, half) - 1, 19999),
                                            rng.integers(0, 20000, half)]), 64),
    ]


def _scalar_launch(ids, rows, n, plan):
    """The kernel under ``plan`` with float4 loads and adds switched off."""
    out = torch.empty((n, rows.shape[1]), device=rows.device)
    sc._prepare(0, plan.mode)
    err = _cuda.launch(0, _cuda.stream(0), sc._kernel(), ids.data_ptr(), int(ids.dtype == torch.int64),
                       rows.data_ptr(), rows.shape[0], rows.shape[1], n, sc.MODES[plan.mode],
                       plan.tile, plan.blocks, plan.chunk,
                       plan.smem_bytes, 0, out.data_ptr())
    if err:
        raise RuntimeError(f"CUDA error {err}")
    return out


def _device_ms(fn, n=20) -> float:
    """The profiler's device time per call of fn over n calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / n / 1e3


def _check(got, want, mag, exact):
    got, want, mag = (x.cpu().numpy() for x in (got, want, mag))
    if exact:
        np.testing.assert_array_equal(got, want)
        return 0.0
    err = np.abs(got - want)
    assert (err <= TOL + TOL * mag).all(), err.max()
    return float(err.max(initial=0.0))


def _sass_atomics(lib: Path) -> dict:
    """Lines of the tile kernels' machine code that are shared-memory or
    global atomics, by opcode; {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()[:40]
        for op in ("ATOMS.CAST", "ATOMS.ADD", "ATOMS.CAS", "ATOMS", "RED.E.ADD", "REDG", "REDS"):
            if op in line:
                key = f"{kernel}:{op}"
                counts[key] = counts.get(key, 0) + 1
                break
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("scatter_modes needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = _cuda.build(["scatter_add_rows"])
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    print(f"sass atomics: {_sass_atomics(_cuda._target('scatter_add_rows'))}", flush=True)

    rng = np.random.default_rng(0)
    sms = sc.sm_count(0)
    out = []
    for name, n, ids_np, d in _shapes(rng):
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
        r = ids.shape[0]
        plans = {"plan": sc.plan_scatter(n, r, d, sms)}
        for mode in ("row", "tile"):
            plans[mode] = sc.plan_scatter(n, r, d, sms, mode)
        max_err = 0.0
        for exact in (True, False):
            if exact:
                rows_np = (rng.integers(-8, 9, (r, d)) / 8).astype(np.float32)
            else:
                rows_np = rng.standard_normal((r, d)).astype(np.float32)
            rows = torch.from_numpy(rows_np).to(dev)
            want = sc.scatter_add_rows_reference(ids, rows, n)
            mag = sc.scatter_add_rows_reference(ids, rows.abs(), n)
            for mode, plan in list(plans.items()) + [("tile_scalar", plans["tile"])]:
                launch = _scalar_launch if mode == "tile_scalar" else sc._launch
                got = launch(ids, rows, n, plan)
                torch.cuda.synchronize()
                try:
                    max_err = max(max_err, _check(got, want, mag, exact))
                except AssertionError as e:
                    raise AssertionError(f"{name} {mode} exact={exact}: {e}") from None
        times = {mode: [] for mode in list(plans) + ["tile_scalar", "index_add_"]}
        ids_long = ids.long()
        fns = {mode: (lambda plan=plan: sc._launch(ids, rows, n, plan)) for mode, plan in plans.items()}
        fns["tile_scalar"] = lambda: _scalar_launch(ids, rows, n, plans["tile"])
        fns["index_add_"] = lambda: torch.zeros((n, d), device=dev).index_add_(0, ids_long, rows)
        for rnd in range(3):
            for mode in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
                times[mode].append(_device_ms(fns[mode]))
        row = {"name": name, "N": n, "R": r, "D": d,
               "plan": {m: p._asdict() for m, p in plans.items()},
               "device_ms": {m: float(np.median(v)) for m, v in times.items()},
               "rounds": times, "max_abs_err": max_err}
        print(f"{name}: " + ", ".join(f"{m} {v:.5f}" for m, v in row["device_ms"].items())
              + f" (plan {plans['plan'].mode}, tile {plans['plan'].tile})", flush=True)
        out.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
