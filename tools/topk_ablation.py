"""Where the masked top-k kernel's time goes: builds ``csrc/streaming_topk.cu``
of the port four times, with parts of pass 1 switched off by the source's
``TOPK_ABLATE`` macro, and times each build on the card at the evaluation's
and the serving path's large tiles.

    python3 tools/topk_ablation.py    # from the repository root; needs a card and nvcc

Builds (results of the cut builds are wrong and are not checked, only timed):
  full           TOPK_ABLATE=0, the kernel as shipped
  no_selection   TOPK_ABLATE=1: no mask, no candidate scan or merges;
                 copies, score product, score tile and barriers
  no_product     TOPK_ABLATE=2: no FMAs (the score tile holds what shared
                 memory held); copies, selection and barriers
  neither        TOPK_ABLATE=3: copies and barriers alone

Prints one JSON line: {"device": ..., "smi": "<name>, <power limit>", "rows":
[{"variant", "B", "k", "ms"}, ...]}, ms being the median of CUDA-event times
over 30 calls of the two passes (the plan of ``plan_tiles``, data of
``chip_smoke.py``'s shape: N = 50000, M = 20000, d = 64, rows of 5-60 train
ids).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from furusato_recommend_tpu_torch.ops import _cuda  # noqa: E402
from furusato_recommend_tpu_torch.ops import streaming_topk as st  # noqa: E402

VARIANTS = {"full": 0, "no_selection": 1, "no_product": 2, "neither": 3}
SHAPES = ((512, 20), (1024, 20))


def _build(out_dir: Path) -> dict:
    """One nvcc per variant, all started together; {name: bound entry}."""
    src = _cuda.CSRC / "streaming_topk.cu"
    procs = {}
    for name, bits in VARIANTS.items():
        so = out_dir / f"libtopk_{name}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-DTOPK_ABLATE={bits}", "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).masked_topk_launch
        fn.argtypes = st._ARGTYPES
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _event_ms(fn, reps=30) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("topk_ablation needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out_dir = _cuda.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = _build(out_dir)

    rng = np.random.default_rng(0)
    n, m, d = 50_000, 20_000, 64
    U = torch.from_numpy((0.1 * rng.standard_normal((n, d))).astype(np.float32)).to(dev)
    I = torch.from_numpy((0.1 * rng.standard_normal((m, d))).astype(np.float32)).to(dev)
    rows = [np.sort(rng.choice(m, size=int(rng.integers(5, 60)), replace=False))
            for _ in range(n)]
    indptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)).to(dev)
    indices = torch.from_numpy(np.concatenate(rows).astype(np.int32)).to(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = _cuda.stream(0)
    out = []
    for b, k in SHAPES:
        users = torch.from_numpy(rng.choice(n, b, replace=False)).to(dev)
        _, n_seg, seg_len = st.plan_tiles(b, m, sms, st._blocks_per_sm(0, k, d))
        cand = torch.empty(2 * b * n_seg * k, dtype=torch.int32, device=dev)
        vals = torch.empty((b, k), device=dev)
        ids = torch.empty((b, k), dtype=torch.int64, device=dev)
        for name, fn in libs.items():
            def call(fn=fn, name=name):
                err = fn(U.data_ptr(), I.data_ptr(), users.data_ptr(), 1, b, n, m, d, k,
                         indptr.data_ptr(), indices.data_ptr(), 0, n_seg, seg_len, None, None,
                         cand.data_ptr(), vals.data_ptr(), ids.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            out.append({"variant": name, "B": b, "k": k, "ms": _event_ms(call)})
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
