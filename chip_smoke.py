#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with one card

Phases (any failure raises and exits non-zero):
  1. device    the card's name and power limit (nvidia-smi); fails without CUDA
  2. build     every CUDA source of the port, compiled by nvcc for sm_90a
  3. kernels   each kernel against its plain PyTorch version on the card
               (d=64, M=20000, B in {1, 8, 64, 512}, k in {10, 20, 128},
               with and without mask and sigmoid):
               (a) exact inputs (multiples of 1/8, duplicated items, one row
                   masked so densely that -1024 entries rank): ids and values equal
               (b) Gaussian inputs: values within rtol 1e-5 / atol 1e-6; ids equal
                   wherever the plain version's neighbouring values differ by
                   more than 1e-5 relative, the value multiset elsewhere
  4. serve     lgn, d=64, L=2, bfloat16 SpMM, on synthetic_dataset(50000 users,
               20000 items, avg degree 30, seed 0), random 0.1 * N(0, 1)
               parameters: Recommender on the card, requests of 1 / 8 / 64 / 512
               users at k = 10 and 20 and over HTTP, each answer held against
               the plain version under rule 3(b); propagation held against a
               float64 CPU propagation on the same rounded inputs
  5. numbers   one JSON line of kernels (time, plain time, library time,
               bound, launches on the serve path), then the serve timings

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.data import synthetic_dataset
from furusato_recommend_tpu_torch.data.graph import CSR
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.ops import _cuda
from furusato_recommend_tpu_torch.ops import streaming_topk as st
from furusato_recommend_tpu_torch.ops.csr_search import csr_gather_padded
from furusato_recommend_tpu_torch.serve import Recommender, make_server

SEED = 0
D, M_KERNEL, N_KERNEL = 64, 20000, 600
TILES = (1, 8, 64, 512)
# H100 SXM published peaks (dense, 700 W): HBM bytes/s and float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
RTOL, ATOL, TIE_RTOL = 1e-5, 1e-6, 1e-5


def log(*a):
    print(*a, flush=True)


def compare(kv, ki, rv, ri, exact: bool) -> float:
    """Rule 3 of the module docstring; returns the max abs value error."""
    kv, ki, rv, ri = (x.cpu().numpy() for x in (kv, ki, rv, ri))
    if exact:
        np.testing.assert_array_equal(ki, ri)
        np.testing.assert_array_equal(kv, rv)
        return 0.0
    np.testing.assert_allclose(kv, rv, rtol=RTOL, atol=ATOL)
    gap = np.abs(np.diff(rv, axis=1)) > TIE_RTOL * np.abs(rv[:, 1:])
    sep = np.ones(ri.shape, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(ki[sep], ri[sep])
    np.testing.assert_allclose(np.sort(kv, axis=1), np.sort(rv, axis=1), rtol=RTOL, atol=ATOL)
    return float(np.abs(kv - rv).max())


def kernel_cases(dev) -> float:
    rng = np.random.default_rng(SEED)
    exact_u = (rng.integers(-4, 5, size=(N_KERNEL, D)) / 8).astype(np.float32)
    exact_i = (rng.integers(-2, 3, size=(M_KERNEL, D)) / 8).astype(np.float32)
    exact_i[1::2] = exact_i[0::2]  # every item has a twin: ties
    gauss_u = (0.3 * rng.standard_normal((N_KERNEL, D))).astype(np.float32)
    gauss_i = (0.3 * rng.standard_normal((M_KERNEL, D))).astype(np.float32)
    rows = []
    for u in range(N_KERNEL):
        # row 0 leaves 50 items unmasked: at k > 50, -1024 entries rank; it
        # is longer than the kernel stages in shared memory
        deg = M_KERNEL - 50 if u == 0 else int(rng.integers(0, 80))
        rows.append(np.sort(rng.choice(M_KERNEL, size=deg, replace=False)))
    indptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    ).to(dev)
    indices = torch.from_numpy(np.concatenate(rows).astype(np.int32)).to(dev)
    max_err, n = 0.0, 0
    for kind, (u, i) in (("exact", (exact_u, exact_i)), ("gauss", (gauss_u, gauss_i))):
        U, I = torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev)
        for b in TILES:
            users = torch.from_numpy(rng.permutation(N_KERNEL)[:b]).to(dev)
            users[0] = 0
            for k in (10, 20, 128):
                for masked in (False, True):
                    mask = (indptr, indices) if masked else (None, None)
                    for sig in (False, True):
                        kv, ki = st.masked_topk(U, I, users, k, *mask, sigmoid=sig)
                        rv, ri = st.masked_topk_reference(U, I, users, k, *mask, sigmoid=sig)
                        torch.cuda.synchronize()
                        err = compare(kv, ki, rv, ri, exact=kind == "exact")
                        max_err = max(max_err, err)
                        n += 1
                        if masked and not sig and k == 128:
                            # row 0: 50 unmasked items, then sentinels by id
                            assert (kv[0, 50:] == st.MASK_SENTINEL).all()
    log(f"kernels: {n} cases equal to the plain version (max abs err {max_err:.3g})")
    return max_err


def reference_propagate(graph, params, n_layers, cdt) -> np.ndarray:
    """LightGCN propagation in float64 on the CPU with x and the weights
    rounded to ``cdt`` as the port rounds them; [N + M, d]."""
    e = graph.norm_edges
    n = graph.num_nodes
    w = e.weight.to(cdt).double()
    adj = torch.sparse_coo_tensor(
        torch.stack([e.dst.long(), e.src.long()]), w, (n, n)
    ).coalesce().to_sparse_csr()
    x = torch.cat([torch.from_numpy(params["user_emb"]), torch.from_numpy(params["item_emb"])])
    acc = x.double()
    h = x
    for _ in range(n_layers):
        h = torch.sparse.mm(adj, h.to(cdt).double()).float()
        acc = acc + h.double()
    return (acc / (n_layers + 1)).numpy()


def event_ms(fn, reps=30, warmup=5) -> float:
    for _ in range(warmup):
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


def host_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def device_profile(fn, n=20):
    """torch.profiler over n calls of fn: device time per call by kernel name
    (ms), all device time per call, and the share of the window's wall time
    with nothing running on the card (the profiler's own overhead counts as
    idle). None when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:48]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        return None
    busy = sum(by_name.values())
    return {
        "by_kernel_ms": {k: v / n / 1e3 for k, v in sorted(by_name.items(), key=lambda x: -x[1])},
        "device_ms": busy / n / 1e3,
        "idle_share": 1.0 - busy / wall_us,
    }


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    report = _cuda.build()
    log(f"build: {len(report)} sources in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    max_err = kernel_cases(dev)

    # 4. the serve path at full width
    t0 = time.perf_counter()
    ds = synthetic_dataset(n_users=50_000, m_items=20_000, avg_degree=30, seed=SEED)
    graph = ds.graph
    log(f"data: {ds.n_users} users, {ds.m_items} items, {ds.train_size} train edges "
        f"({time.perf_counter() - t0:.1f} s)")
    cfg = Config(model="lgn", latent_dim=D, n_layers=2, compute_dtype="bfloat16", seed=SEED)
    rng = np.random.default_rng(SEED)
    params = {
        "user_emb": (0.1 * rng.standard_normal((ds.n_users, D))).astype(np.float32),
        "item_emb": (0.1 * rng.standard_normal((ds.m_items, D))).astype(np.float32),
    }
    model = build_model("lgn", cfg, graph)
    request_users = {
        b: np.random.default_rng(SEED + b).choice(ds.n_users, size=b, replace=False)
        for b in TILES
    }

    st.launches = 0
    t0 = time.perf_counter()
    rec = Recommender(model, ds, cfg, params, device="cuda")
    torch.cuda.synchronize()
    first_refresh_s = time.perf_counter() - t0
    answers = {}
    for b in TILES:
        for k in (10, 20):
            before = st.launches
            answers[(b, k)] = rec.recommend(request_users[b], k=k)
            assert st.launches >= before + 1, "a request did not launch the kernel"
    srv = make_server(rec, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        before = st.launches
        one = json.load(urllib.request.urlopen(f"{base}/recommend?user=17&k=10", timeout=60))
        req = urllib.request.Request(
            f"{base}/recommend", data=json.dumps({"users": [3, 40000], "k": 10}).encode(),
            method="POST",
        )
        batch = json.load(urllib.request.urlopen(req, timeout=60))
        assert st.launches >= before + 2, "an HTTP request did not launch the kernel"
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    serve_launches = st.launches
    assert not th.is_alive()
    n_requests = len(answers) + 2
    log(f"serve: {n_requests} requests, {serve_launches} kernel launches")

    # the answers against the plain version on the same embeddings
    U, I = rec._user_emb, rec._item_emb
    mask = (rec._mask.indptr, rec._mask.indices)
    pos = ds.all_pos()
    for (b, k), (ids, scores) in answers.items():
        assert ids.shape == (b, k) and np.isfinite(scores).all()
        users = torch.from_numpy(request_users[b]).to(dev)
        rv, ri = st.masked_topk_reference(U, I, users, k, *mask)
        max_err = max(max_err, compare(
            torch.from_numpy(scores), torch.from_numpy(ids), rv, ri, exact=False))
        for u, row in zip(request_users[b], ids):
            assert not set(row.tolist()) & set(pos[u].tolist()), "a train positive was served"
    want_ids, _ = rec.recommend([17], k=10)
    assert one["user"] == 17 and one["items"] == want_ids[0].tolist()
    want_ids, _ = rec.recommend([3, 40000], k=10)
    assert [r["items"] for r in batch] == want_ids.tolist()
    ref = reference_propagate(graph, params, cfg.n_layers, torch.bfloat16)
    got = torch.cat([U, I]).cpu().numpy()
    assert got.shape == (ds.n_users + ds.m_items, D) and np.isfinite(got).all()
    # a layer's float32 sum may round to bfloat16 on the other side of a
    # rounding boundary than the float64 sum does: rtol 2e-3, atol 1e-5
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-5)
    log(f"propagate: equal to the float64 CPU propagation (max abs err "
        f"{np.abs(got - ref).max():.3g}); first refresh {first_refresh_s:.2f} s")

    # 5. numbers
    propagate_ms = host_ms(lambda: rec.refresh(None), reps=10)
    propagate_profile = device_profile(lambda: rec.refresh(None), n=5)
    tiles = []
    pos_csr = CSR(*mask)
    for b in TILES:
        for k in (10, 20):
            users = torch.from_numpy(request_users[b]).to(dev)
            deg = pos_csr.degrees()[users.long()]
            pad_to = int(deg.max())
            cols, valid = csr_gather_padded(pos_csr, users, pad_to)
            rows = torch.arange(b, device=dev)[:, None].expand_as(cols)
            mrows, mcols = rows[valid], cols[valid].long()
            sentinel = torch.tensor(float(st.MASK_SENTINEL), device=dev)

            def library():
                s = U[users] @ I.T
                s.index_put_((mrows, mcols), sentinel)
                return torch.topk(s, k)

            nbytes = 4 * (I.numel() + b * D + b + 2 * b + int(deg.sum())) + 12 * b * k
            flops = 2 * b * ds.m_items * D
            t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
            tiles.append({
                "B": b, "k": k,
                "ms": event_ms(lambda: st.masked_topk(U, I, users, k, *mask)),
                "plain_ms": event_ms(lambda: st.masked_topk_reference(U, I, users, k, *mask)),
                "library_ms": event_ms(library),
                "bound_ms": 1e3 * max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                "request_ms": host_ms(lambda: rec.recommend(request_users[b], k=k)),
                "kernel_profile": device_profile(lambda: st.masked_topk(U, I, users, k, *mask)),
                "request_profile": device_profile(lambda: rec.recommend(request_users[b], k=k)),
            })
    head = next(t for t in tiles if t["B"] == 512 and t["k"] == 20)
    kernels = [{
        "name": "masked_topk",
        "route": "cuda",
        "source": "furusato_recommend_tpu_torch/csrc/streaming_topk.cu",
        "replaces": "furusato_recommend_tpu/ops/pallas_topk.py:152",
        "launches": serve_launches,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "at": {"B": 512, "k": 20, "M": ds.m_items, "d": D},
        "tiles": tiles,
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "serve": {"propagate_ms": propagate_ms, "first_refresh_s": first_refresh_s,
                  "propagate_profile": propagate_profile,
                  "request_ms": {f"B{t['B']}_k{t['k']}": t["request_ms"] for t in tiles}}
    }))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
