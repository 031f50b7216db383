#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py        # from the repository root, on a machine with one card

Phases (any failure raises and exits non-zero):
  1. device    the card's name and power limit (nvidia-smi); fails without CUDA
  2. build     every CUDA source of the port, compiled by nvcc for sm_90a, one
               nvcc per source, all started together; the top-k pass 1's
               blocks per SM from the occupancy API
  3. kernels   each kernel against its plain PyTorch version on the card.
               masked_topk (d=64, M=20000, B in {1, 8, 64, 512}, k in
               {10, 20, 128}; and the tiling's edges: (M, d) in {(127, 32),
               (20001, 100), (20000, 30)}, B in {1, 33, 65, 1000}, k in
               {1, 20, 128}; each with and without mask and sigmoid, one
               user twice in a tile):
               (a) exact inputs (multiples of 1/8, duplicated items, one row
                   masked so densely that -1024 entries rank): ids and values equal
               (b) Gaussian inputs: values within rtol 1e-5 / atol 1e-6; ids equal
                   wherever the plain version's neighbouring values differ by
                   more than 1e-5 relative, the value multiset elsewhere
               the first call runs under torch.cuda.set_sync_debug_mode("error")
               scatter_add_rows ((N, R, D) = (50000, 8192, 64) and
               (20000, 16384, 64), the bench step's user and item gathers;
               R = 999; R = 0; one id 5,000 times; ids out of range, D = 50;
               and the kernel's edges: one id 285,000 times, ids that are all
               multiples of a tile's hash slot count, R = T - 1, T and T + 1
               under the item-side tree gather's tile plan, and the row mode
               forced at that gather's shape):
               (a) exact inputs (multiples of 1/8): bit-equal
               (b) Gaussian inputs: within 1e-5 + 1e-5 * (the sum of the
                   magnitudes added into the element): only the order of the
                   float32 sums differs, and with atomics it changes from run
                   to run
               the first call runs under torch.cuda.set_sync_debug_mode("error"):
               the wrapper never waits for the card
  4. serve     lgn, d=64, L=2, bfloat16 SpMM, on synthetic_dataset(50000 users,
               20000 items, avg degree 30, seed 0), random 0.1 * N(0, 1)
               parameters: Recommender on the card, requests of 1 / 8 / 64 / 512
               users at k = 10 and 20 and over HTTP, each answer held against
               the plain version under rule 3(b); propagation held against a
               float64 CPU propagation on the same rounded inputs
  5. numbers   the serve path's timings (printed at the end), and masked_topk
               at the evaluation's tile (B = 1024, k = 20)
  6. train     Trainer for lgn, d=64, L=2, bfloat16 SpMM, B=8192, lr 1e-3 on the
               same graph: test(), one warm-up epoch, two timed epochs,
               test(); the scatter kernel launched at least once per step and
               masked_topk once per evaluation tile; the loss of the last
               epoch below the first's; recall@20 above its value at
               initialisation
  7. card/CPU  two steps on the card and two on the CPU (plain versions) from
               the same parameters on the same batches (sampled on the card):
               losses within rtol 1e-5 (step 1) and 1e-4 (step 2); after two
               steps every parameter within 4 * lr, and all but 1e-3 of them
               within 1e-6 + 1e-5 * |p| (Adam's first steps are +-lr where a
               gradient is within rounding of 0, so a sign there may differ);
               one evaluation of the trained tables through masked_topk and
               through masked_topk_reference on the card: ids equal where
               neighbouring values differ by more than 1e-5 relative, metric
               sums equal (bit-equal when every id is)
  8. numbers   the train path's numbers (samples/s, the step split by
               torch.profiler into SpMM forward / backward, scatter, gather,
               sampler, Adam and the rest, the evaluation, the card's idle
               share)
  9. serve-textsage-100k
               the TextSAGE flagship (ddp_flagship_config: d=32, L=2, fanout 5,
               features n / w / t, bfloat16 SpMM) on synthetic_dataset(100000
               users, 30000 items, avg degree 8, seed 0) with
               synthetic_features(seed 0), random xavier parameters from a
               seeded generator: data and features built (host time), the
               index refreshed (host and device time), requests of 1 / 8 / 64
               / 512 users at k = 20 and two over HTTP, each answer held
               against the plain version under rule 3(b); the propagation on
               the card held against a CPU propagation of the same parameters
               (rtol 2e-2, atol 2e-3 x the largest magnitude: both round the
               SpMM operands to bfloat16, and a float32 sum on the other side of
               a rounding boundary moves an element by a bfloat16 step)
 10. train-textsage-100k
               Trainer(ddp_recipe=True), B=5000, lr 1e-3: an evaluation, a
               warm-up of 10 steps, one timed epoch (421 steps of alias-sampled
               triplets, fanout trees and dropout on the card), an evaluation;
               the loss of the epoch's last tenth below its first tenth's;
               scatter_add_rows launched twice a step (one tree gather per
               side), masked_topk once per evaluation tile; one evaluation
               through the kernel against the plain version (phase 7's rule);
               one --inference sample pass over all 130000 entities, timed;
               one step on the card and on the CPU from the same parameters on
               the same batch and trees, dropout 0: losses within rtol 1e-4,
               every parameter within 2 x lr, all but 1e-3 of them within 1e-6
               + 1e-5 |p| (Adam's first step is +-lr, so a gradient within
               rounding of 0 may take the other sign)
 11. numbers   one JSON line of kernels (time, plain time, library time,
               bound, launches on the main paths; masked_topk also at the
               evaluation's tile and at TextSAGE's d = 32 over 30000 items;
               scatter_add_rows at each shape: its plan (mode, T, blocks,
               shared memory), the kernel, its row mode forced and index_add_
               timed in ten alternating rounds, median and quartiles, each
               one's device time, and the global adds the plan implies for
               those ids, counted on the card outside the timed window; also
               at the TextSAGE step's tree gathers and a categorical gather),
               the serve and train lines of the lgn paths and of the TextSAGE
               paths (samples/s, host and device ms a step with the profiler's
               split, the idle share)

Kernel cases at TextSAGE's shapes join phase 3: masked_topk at d = 32, M =
30000, B in {1, 64, 512, 1024}, k in {10, 20}; scatter_add_rows at (N, R, D) =
(100000, 180000, 32), (30000, 285000, 32) (a step's tree gathers, Zipf(1.2)
ids here, ids of sampled trees in phase 11) and (40, 400000, 32), all in tile
mode.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

from furusato_recommend_tpu_torch.config import Config, ddp_flagship_config
from furusato_recommend_tpu_torch.convert import flatten_params, params_from_jax, params_to_numpy
from furusato_recommend_tpu_torch.data import synthetic_dataset
from furusato_recommend_tpu_torch.data.features import synthetic_features
from furusato_recommend_tpu_torch.data.graph import CSR
from furusato_recommend_tpu_torch.eval.metrics import batch_metric_sums
from furusato_recommend_tpu_torch.models import sage
from furusato_recommend_tpu_torch.models.registry import build_model
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.ops import _cuda
from furusato_recommend_tpu_torch.ops import scatter as sc
from furusato_recommend_tpu_torch.ops import streaming_topk as st
from furusato_recommend_tpu_torch.ops.csr_search import csr_gather_padded
from furusato_recommend_tpu_torch.sampling.bpr import sample_bpr
from furusato_recommend_tpu_torch.serve import Recommender, make_server
from furusato_recommend_tpu_torch.train.trainer import Trainer

SEED = 0
D, M_KERNEL, N_KERNEL = 64, 20000, 600
TILES = (1, 8, 64, 512)
EVAL_TILE = 1024  # the evaluator's users per masked_topk call (eval_user_batch)
# (M, d) of the top-k tiling's edges: M not a multiple of the item tile, d
# resident and in chunks, d not a multiple of 4
TOPK_EDGES = ((127, 32), (20001, 100), (20000, 30))
# H100 SXM published peaks (dense, 700 W): HBM bytes/s and float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
RTOL, ATOL, TIE_RTOL = 1e-5, 1e-6, 1e-5
# the bench.py training step: B = 8192 triplets gather 8192 user rows and
# 16384 item rows (positives and negatives in one gather)
TRAIN_B, TRAIN_LR = 8192, 1e-3
SCATTER_SHAPES = ((50_000, 8_192), (20_000, 16_384))  # (N, R) at D = 64
SC_TOL = 1e-5
# the TextSAGE flagship: the shape of benchmarks/textsage_bench.py
TS_USERS, TS_ITEMS, TS_DEGREE = 100_000, 30_000, 8
TS_D = 32
TS_TILES = (1, 8, 64, 512)
TS_K = 20
TS_WARMUP = 10
# (N, R) of a flagship step's two tree gathers at D = 32 (B = 5000, fanout 5,
# L = 2: users 5000 + 2 x 25000 + 125000, items 25000 + 2 x (5000 + 125000)),
# and a categorical gather (100000 users x 4 fields into 40 categories)
TS_SCATTER = ((TS_USERS, 180_000), (TS_ITEMS, 285_000), (40, 400_000))
# profiler ranges (ops/segment.py, ops/scatter.py, sampling/bpr.py,
# sampling/neighbor.py, eval/evaluate.py, torch.optim's own) and the step part
# each one names
RANGES = {
    "spmm_fwd": "spmm_fwd", "spmm_bwd": "spmm_bwd", "table_gather": "gather",
    "scatter_add_rows": "scatter", "sample_bpr": "sampler", "evaluate": "eval",
    "sample_neighbors": "trees", "Optimizer.step#Adam.step": "adam",
}
# the port's kernels, launched through ctypes outside any torch operation
OWN_KERNELS = {
    "scatter_add_rows_kernel": "scatter", "scatter_tile_kernel": "scatter",
    "score_segments": "masked_topk",
    "merge_segments": "masked_topk",
}


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


def _topk_cases(dev, rng, n, m, d, tiles, ks, first_checked) -> tuple:
    """masked_topk against its plain version on one (N, M, d); returns
    (cases, max abs err). The first call runs under sync debug mode "error"
    unless ``first_checked``."""
    exact_u = (rng.integers(-4, 5, size=(n, d)) / 8).astype(np.float32)
    exact_i = (rng.integers(-2, 3, size=(m, d)) / 8).astype(np.float32)
    exact_i[1::2] = exact_i[0::2][: m // 2]  # every item has a twin: ties
    scale = 0.3 * (64 / d) ** 0.5
    gauss_u = (scale * rng.standard_normal((n, d))).astype(np.float32)
    gauss_i = (scale * rng.standard_normal((m, d))).astype(np.float32)
    rows = []
    for u in range(n):
        # row 0 leaves 50 items unmasked: at k > 50, -1024 entries rank; it
        # is longer than the kernel stages in shared memory
        deg = m - 50 if u == 0 else int(rng.integers(0, min(m, 80)))
        rows.append(np.sort(rng.choice(m, size=deg, replace=False)))
    indptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    ).to(dev)
    indices = torch.from_numpy(np.concatenate(rows).astype(np.int32)).to(dev)
    max_err, n_cases = 0.0, 0
    for kind, (u, i) in (("exact", (exact_u, exact_i)), ("gauss", (gauss_u, gauss_i))):
        U, I = torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev)
        for b in tiles:
            users = torch.from_numpy(rng.permutation(n)[:b]).to(dev)
            users[0] = 0
            if b > 3:
                users[3] = users[2]  # one user twice in a tile
            for k in (k for k in ks if k <= m):
                for masked in (False, True):
                    mask = (indptr, indices) if masked else (None, None)
                    for sig in (False, True):
                        if not first_checked:
                            torch.cuda.synchronize()
                            torch.cuda.set_sync_debug_mode("error")  # raises on a host sync
                            try:
                                kv, ki = st.masked_topk(U, I, users, k, *mask, sigmoid=sig)
                            finally:
                                torch.cuda.set_sync_debug_mode(0)
                            first_checked = True
                        else:
                            kv, ki = st.masked_topk(U, I, users, k, *mask, sigmoid=sig)
                        rv, ri = st.masked_topk_reference(U, I, users, k, *mask, sigmoid=sig)
                        torch.cuda.synchronize()
                        err = compare(kv, ki, rv, ri, exact=kind == "exact")
                        max_err = max(max_err, err)
                        n_cases += 1
                        if masked and not sig and k == 128:
                            # row 0: 50 unmasked items, then sentinels by id
                            assert (kv[0, 50:] == st.MASK_SENTINEL).all()
    return n_cases, max_err


def kernel_cases(dev) -> float:
    rng = np.random.default_rng(SEED)
    n, max_err = _topk_cases(dev, rng, N_KERNEL, M_KERNEL, D, TILES, (10, 20, 128), False)
    for m, d in TOPK_EDGES:
        c, e = _topk_cases(dev, rng, 1100, m, d, (1, 33, 65, 1000), (1, 20, 128), True)
        n, max_err = n + c, max(max_err, e)
    # TextSAGE's serving and evaluation shape
    c, e = _topk_cases(dev, rng, 1100, TS_ITEMS, TS_D, (1, 64, 512, 1024), (10, 20), True)
    n, max_err = n + c, max(max_err, e)
    log(f"kernels: {n} cases equal to the plain version (max abs err {max_err:.3g}); "
        f"no host sync in the wrapper")
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


def alternating_ms(fns: dict, rounds=10, reps=30) -> dict:
    """CUDA-event times of several functions taken in turns: in each of
    ``rounds`` rounds every function is timed once (``event_ms``, the median
    of ``reps`` calls), in reversed order every other round. {name: {"ms":
    median of the round medians, "quartiles": [first, third], "rounds": [...]}}"""
    per = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            per[name].append(event_ms(fns[name], reps=reps))
    return {name: {"ms": float(np.median(v)),
                   "quartiles": [float(np.percentile(v, 25)), float(np.percentile(v, 75))],
                   "rounds": v} for name, v in per.items()}


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


def _is_range(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name in RANGES


def device_profile(fn, n=20):
    """torch.profiler over n calls of fn: device time per call by kernel name
    (ms), all device time and device operations per call (fewer than the
    calls launch means the profiler lost records), and the share of the
    window's wall time with nothing running on the card (the profiler's own
    overhead counts as idle). None when the profiler records no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name, n_ops = {}, 0
    for e in prof.events():
        # the port's profiler ranges also show as spans on the card: not work
        if e.device_type == torch.autograd.DeviceType.CUDA and not _is_range(e):
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:48]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
            n_ops += 1
    if not by_name:
        return None
    busy = sum(by_name.values())
    return {
        "by_kernel_ms": {k: v / n / 1e3 for k, v in sorted(by_name.items(), key=lambda x: -x[1])},
        "device_ms": busy / n / 1e3,
        "device_ops_per_call": n_ops / n,
        "idle_share": 1.0 - busy / wall_us,
    }


def scatter_cases(dev) -> float:
    """Phase 3, scatter_add_rows: the kernel against its plain version;
    returns the max abs error of the Gaussian cases."""
    rng = np.random.default_rng(SEED + 1)
    cases = [(n, rng.integers(0, n, r), D, None) for n, r in SCATTER_SHAPES]
    cases += [
        (1000, rng.integers(0, 1000, 999), D, None),  # R not a multiple of 32
        (500, np.zeros(0, np.int64), D, None),  # no rows: a zero table
        (100, np.concatenate([np.full(5000, 7), rng.integers(0, 100, 300)]), D, None),  # a hub
        (300, np.concatenate([rng.integers(0, 300, 2000), [-3, 300, 10**6]]), 50, None),  # clamped
    ]
    # TextSAGE's tree gathers (Zipf items hit often, as tree neighbours are)
    # and a categorical gather, at D = 32
    zipf = np.minimum(rng.zipf(1.2, TS_SCATTER[1][1]) - 1, TS_ITEMS - 1)
    cases += [
        (TS_USERS, rng.integers(0, TS_USERS, TS_SCATTER[0][1]), TS_D, None),
        (TS_ITEMS, zipf, TS_D, None),
        (40, rng.integers(0, 40, TS_SCATTER[2][1]), TS_D, None),
    ]
    # the modes' edges: every row on one id; ids that are all multiples of a
    # tile's hash slot count; R = T - 1, T, T + 1 under the item-side gather's
    # tile plan; and the row mode forced at that gather's shape
    sms = sc.sm_count(_cuda.device_index(dev))
    user_plan = sc.plan_scatter(TS_USERS, TS_SCATTER[0][1], TS_D, sms)
    item_plan = sc.plan_scatter(TS_ITEMS, TS_SCATTER[1][1], TS_D, sms)
    assert (user_plan.mode, item_plan.mode) == ("tile", "tile"), (user_plan, item_plan)
    slots = 2 * user_plan.tile
    cases += [
        (TS_ITEMS, np.full(TS_SCATTER[1][1], TS_ITEMS - 1), TS_D, None),
        (TS_USERS, rng.integers(0, TS_USERS // slots, TS_SCATTER[0][1]) * slots, TS_D, None),
    ]
    cases += [(TS_ITEMS, zipf[: item_plan.tile + e], TS_D, item_plan) for e in (-1, 0, 1)]
    cases.append((TS_ITEMS, zipf, TS_D, sc.plan_scatter(TS_ITEMS, len(zipf), TS_D, sms, "row")))
    max_err, n_cases = 0.0, 0
    for n, ids, d, plan in cases:
        ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
        for exact in (True, False):
            if exact:
                rows = (rng.integers(-8, 9, (len(ids), d)) / 8).astype(np.float32)
            else:
                rows = rng.standard_normal((len(ids), d)).astype(np.float32)
            rows_t = torch.from_numpy(rows).to(dev)
            before = sc.launches
            if n_cases == 0:
                torch.cuda.set_sync_debug_mode("error")  # raises on a host sync
                try:
                    got = sc.scatter_add_rows(ids_t, rows_t, n)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            elif plan is None:
                got = sc.scatter_add_rows(ids_t, rows_t, n)
            else:
                got = sc._launch(ids_t, rows_t, n, plan)
            want = sc.scatter_add_rows_reference(ids_t, rows_t, n)
            mag = sc.scatter_add_rows_reference(ids_t, rows_t.abs(), n)
            torch.cuda.synchronize()
            assert sc.launches == before + 1, "scatter_add_rows did not launch its kernel"
            got, want, mag = (x.cpu().numpy() for x in (got, want, mag))
            assert got.shape == (n, d)
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                err = np.abs(got - want)
                assert (err <= SC_TOL + SC_TOL * mag).all(), f"scatter N={n} R={len(ids)}: {err.max()}"
                max_err = max(max_err, float(err.max(initial=0.0)))
            n_cases += 1
    log(f"scatter: {n_cases} cases equal to the plain version (exact cases bit-equal, "
        f"max abs err {max_err:.3g}); no host sync in the wrapper")
    return max_err


def _own_kernel(name: str):
    return next((part for key, part in OWN_KERNELS.items() if key in name), None)


def _is_memset(name: str) -> bool:
    return name.startswith("Memset")


def _step_part(e) -> str:
    """The step part of a profiler CPU event: the innermost port range
    around it (RANGES), else "other"."""
    while e is not None:
        if e.name in RANGES:
            return RANGES[e.name]
        e = e.cpu_parent
    return "other"


def split_profile(fn, n):
    """torch.profiler over n calls of fn: device time per call split into
    step parts (the port's own kernels by name, every other kernel by the
    port range around the torch operation that launched it; "unattributed"
    is what the profiler ties to no operation), all device time and the
    number of device operations per call, and the share of the window's
    wall time with nothing running on the card (the profiler's own overhead
    counts as idle). None when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.events()
    # the host's runtime calls by correlation id: a memset goes by the range
    # around the cudaMemsetAsync that issued it, since the profiler ties it to
    # the torch operation around the ctypes call (the scatter entry zeroes its
    # table so), which lies outside the port's range
    runtime = {e.id: e for e in events
               if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda")}
    split, device_us, n_device = {}, 0.0, 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not _is_range(e):
                us = e.time_range.elapsed_us()
                device_us += us
                n_device += 1
                part = _own_kernel(e.name)
                if part is None and _is_memset(e.name) and e.id in runtime:
                    part = _step_part(runtime[e.id])
                if part is not None:
                    split[part] = split.get(part, 0.0) + us
        elif e.kernels:
            spent = sum(k.duration for k in e.kernels if k.name not in RANGES
                        and _own_kernel(k.name) is None and not _is_memset(k.name))
            if spent:
                part = _step_part(e)
                split[part] = split.get(part, 0.0) + spent
    split["unattributed"] = device_us - sum(split.values())
    if device_us == 0.0:
        return None
    return {
        "split_ms": {k: v / n / 1e3 for k, v in sorted(split.items(), key=lambda x: -x[1])},
        "device_ms": device_us / n / 1e3,
        "device_ops_per_call": n_device / n,  # kernels, copies and fills
        "wall_ms": wall_us / n / 1e3,
        "idle_share": 1.0 - device_us / wall_us,
    }


def host_syncs(fn) -> list:
    """The messages of torch's sync debug mode while fn runs: one per
    operation that made the host wait for the card."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]


def train_config() -> Config:
    return Config(
        model="lgn", latent_dim=D, n_layers=2, compute_dtype="bfloat16",
        bpr_batch_size=TRAIN_B, lr=TRAIN_LR, seed=SEED, topks=(10, 20), eval_user_batch=1024,
    )


def train_path(ds, dev):
    """Phase 6: the trainer on the card; returns (trainer, facts)."""
    cfg = train_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ds, build_model("lgn", cfg, ds.graph),
                      logger=MetricLogger(quiet=True), device=dev)
    trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_tiles = int(trainer.eval_data.users.shape[0])

    sc.launches = st.launches = 0
    t0 = time.perf_counter()
    before = trainer.test()
    first_eval_s = time.perf_counter() - t0
    losses, epoch_s = [], []
    for _ in range(3):  # one warm-up epoch, then two timed ones
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_one_epoch())  # ends in the epoch's one host sync
        epoch_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    after = trainer.test()
    eval_s = time.perf_counter() - t0
    launches = {"scatter_add_rows": sc.launches, "masked_topk": st.launches}

    steps = 3 * trainer.num_batches
    assert launches["scatter_add_rows"] >= steps, f"scatter launched {launches} in {steps} steps"
    assert launches["masked_topk"] == 2 * n_tiles, f"masked_topk launched {launches} for {n_tiles} tiles"
    for res in (before, after):
        assert all(np.isfinite(v) for v in res.values()), res
    assert np.isfinite(losses).all() and losses[-1] < losses[0], f"loss did not fall: {losses}"
    assert after["recall@20"] > before["recall@20"], (before["recall@20"], after["recall@20"])
    log(f"train: {steps} steps of {trainer.samples_per_epoch // trainer.num_batches} triplets, "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, recall@20 {before['recall@20']:.5f} -> "
        f"{after['recall@20']:.5f}; scatter launches {launches['scatter_add_rows']} "
        f"({launches['scatter_add_rows'] / steps:g} per step), masked_topk launches "
        f"{launches['masked_topk']} ({n_tiles} tiles per evaluation)")
    return trainer, {
        "steps_per_epoch": trainer.num_batches,
        "samples_per_epoch": trainer.samples_per_epoch,
        "epoch_s": epoch_s,
        "samples_per_s": trainer.samples_per_epoch / float(np.mean(epoch_s[1:])),
        "step_ms": 1e3 * float(np.mean(epoch_s[1:])) / trainer.num_batches,
        "loss": losses,
        "recall@20": [before["recall@20"], after["recall@20"]],
        "ndcg@20": [before["ndcg@20"], after["ndcg@20"]],
        "eval_s": eval_s,
        "first_eval_s": first_eval_s,
        "setup_s": setup_s,
        "eval_tiles": n_tiles,
        "launches": launches,
        "scatter_launches_per_step": launches["scatter_add_rows"] / steps,
    }


def card_vs_cpu(ds, trainer) -> dict:
    """Phase 7, first half: two steps on the card and on the CPU."""
    cfg = trainer.config
    rng = np.random.default_rng(SEED + 2)
    params = {
        "user_emb": (0.1 * rng.standard_normal((ds.n_users, D))).astype(np.float32),
        "item_emb": (0.1 * rng.standard_normal((ds.m_items, D))).astype(np.float32),
    }
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 2)
    batches = sample_bpr(gen, trainer.graph, 2 * TRAIN_B, cfg.neg_candidates)
    out = {}
    for name, dev, graph in (("card", trainer.device, trainer.graph),
                             ("cpu", torch.device("cpu"), ds.graph)):
        model = build_model("lgn", cfg, ds.graph)
        params_from_jax(params, model)
        model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        losses = []
        for step in range(2):
            batch = batches.slice(step * TRAIN_B, (step + 1) * TRAIN_B).to(dev)
            opt.zero_grad(set_to_none=True)
            loss, _ = model.loss(graph, batch)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        out[name] = (params_to_numpy(model), losses)
    (pc, lc), (pp, lp) = out["card"], out["cpu"]
    np.testing.assert_allclose(lc[0], lp[0], rtol=1e-5)
    np.testing.assert_allclose(lc[1], lp[1], rtol=1e-4)
    worst, off = 0.0, 0
    total = 0
    for k in pp:
        diff = np.abs(pc[k] - pp[k])
        assert (diff <= 4 * cfg.lr).all(), f"{k}: {diff.max()}"
        off += int((diff > 1e-6 + 1e-5 * np.abs(pp[k])).sum())
        total += diff.size
        worst = max(worst, float(diff.max()))
    assert off <= 1e-3 * total, f"{off} of {total} parameters differ"
    log(f"card vs CPU: losses {lc} / {lp}; parameters within 1e-6 + 1e-5 |p| but "
        f"{off} of {total} (max abs diff {worst:.3g})")
    return {"losses_card": lc, "losses_cpu": lp, "params_off": off, "params_total": total,
            "max_abs_diff": worst}


def eval_kernel_vs_plain(trainer) -> dict:
    """Phase 7, second half: one evaluation through the kernel and through
    its plain version on the card."""
    g, data, cfg = trainer.graph, trainer.eval_data, trainer.config
    with torch.no_grad():
        U, I = trainer.model.propagate(g)
    U, I = U.float().contiguous(), I.float().contiguous()
    kmax = max(cfg.topks)
    sums = {"kernel": None, "plain": None}
    moved = 0
    for users, valid in zip(data.users, data.valid):
        kv, ki = st.masked_topk(U, I, users, kmax, g.user_pos.indptr, g.user_pos.indices)
        rv, ri = st.masked_topk_reference(U, I, users, kmax, g.user_pos.indptr, g.user_pos.indices)
        compare(kv, ki, rv, ri, exact=False)
        moved += int((ki != ri).sum())
        for name, ids in (("kernel", ki), ("plain", ri)):
            b = batch_metric_sums(
                ids, users, valid, g.test_pos, cfg.topks, None, data.item_popularity,
                n_users_norm=float(g.n_users), max_test_degree=g.max_test_degree or None,
            )
            sums[name] = b if sums[name] is None else {k: sums[name][k] + v for k, v in b.items()}
    for k in sums["plain"]:
        a, b = sums["kernel"][k].cpu().numpy(), sums["plain"][k].cpu().numpy()
        if moved == 0:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:  # ids swapped only inside near-ties (checked above)
            np.testing.assert_allclose(a, b, rtol=1e-3, err_msg=k)
    log(f"evaluation: metric sums through masked_topk equal to the plain version's "
        f"({moved} ids in near-ties placed otherwise)")
    return {"ids_moved_in_ties": moved}


def scatter_numbers(trainer, dev) -> list:
    """Phase 8: scatter_add_rows at the bench step's two shapes, on the ids
    of a sampled batch."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    batch = sample_bpr(gen, trainer.graph, TRAIN_B, trainer.config.neg_candidates)
    cases = [(n, ids) for (n, _), ids in zip(SCATTER_SHAPES, (batch.user, torch.cat([batch.pos, batch.neg])))]
    assert [ids.shape[0] for _, ids in cases] == [r for _, r in SCATTER_SHAPES]
    return scatter_numbers_at(cases, dev, D, rows_seed=SEED + 4)


def textsage_config() -> Config:
    return ddp_flagship_config().replace(seed=SEED, topks=(10, 20), eval_user_batch=EVAL_TILE)


def textsage_data():
    """Phase 9's data: the flagship graph and its side features (host)."""
    t0 = time.perf_counter()
    ds = synthetic_dataset(n_users=TS_USERS, m_items=TS_ITEMS, avg_degree=TS_DEGREE, seed=SEED)
    graph = ds.graph
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs = synthetic_features(ds, textsage_config(), seed=SEED)
    features_s = time.perf_counter() - t0
    log(f"textsage data: {ds.n_users} users, {ds.m_items} items, {graph.train_size} train edges "
        f"({data_s:.1f} s); features ({features_s:.1f} s)")
    return ds, fs, {"data_s": data_s, "features_s": features_s}


def _textsage_model(ds, fs, seed):
    cfg = textsage_config()
    return build_model("textsage", cfg, ds.graph, features=fs,
                       generator=torch.Generator().manual_seed(seed))


def serve_textsage(ds, fs, dev, host_s) -> dict:
    """Phase 9: the flagship's serving path and its numbers."""
    cfg = textsage_config()
    model = _textsage_model(ds, fs, SEED)
    params = params_to_numpy(model)
    users = {b: np.random.default_rng(SEED + 10 + b).choice(ds.n_users, size=b, replace=False)
             for b in TS_TILES}

    st.launches = sc.launches = 0
    t0 = time.perf_counter()
    rec = Recommender(model, ds, cfg, None, device="cuda")
    torch.cuda.synchronize()
    first_refresh_s = time.perf_counter() - t0
    answers = {}
    for b in TS_TILES:
        before = st.launches
        answers[b] = rec.recommend(users[b], k=TS_K)
        assert st.launches == before + 1, "a request did not launch the kernel"
    srv = make_server(rec, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        before = st.launches
        one = json.load(urllib.request.urlopen(f"{base}/recommend?user=17&k={TS_K}", timeout=60))
        req = urllib.request.Request(
            f"{base}/recommend", data=json.dumps({"users": [3, ds.n_users - 1], "k": TS_K}).encode(),
            method="POST",
        )
        batch = json.load(urllib.request.urlopen(req, timeout=60))
        assert st.launches == before + 2, "an HTTP request did not launch the kernel"
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    launches = {"masked_topk": st.launches, "scatter_add_rows": sc.launches}
    assert not th.is_alive()
    assert launches["scatter_add_rows"] == 0, "the serve path launched the scatter kernel"

    U, I = rec._user_emb, rec._item_emb
    mask = (rec._mask.indptr, rec._mask.indices)
    max_err = 0.0
    pos = ds.all_pos()
    for b, (ids, scores) in answers.items():
        assert ids.shape == (b, TS_K) and np.isfinite(scores).all()
        rv, ri = st.masked_topk_reference(U, I, torch.from_numpy(users[b]).to(dev), TS_K, *mask)
        max_err = max(max_err, compare(torch.from_numpy(scores), torch.from_numpy(ids), rv, ri, exact=False))
        for u, row in zip(users[b], ids):
            assert not set(row.tolist()) & set(pos[u].tolist()), "a train positive was served"
    assert one["items"] == rec.recommend([17], k=TS_K)[0][0].tolist()
    assert [r["items"] for r in batch] == rec.recommend([3, ds.n_users - 1], k=TS_K)[0].tolist()

    # the propagation on the card against the CPU's on the same parameters
    cpu_model = build_model("textsage", cfg, ds.graph, features=fs)
    params_from_jax(params, cpu_model)
    with torch.no_grad():
        cu, ci = cpu_model.propagate(ds.graph)
    got = torch.cat([U, I]).cpu().numpy()
    want = torch.cat([cu, ci]).numpy()
    assert got.shape == (ds.n_users + ds.m_items, TS_D) and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3 * scale)
    prop_err = float(np.abs(got - want).max())
    log(f"serve-textsage: {len(answers) + 2} requests, {launches['masked_topk']} masked_topk launches, "
        f"answers equal to the plain version (max abs err {max_err:.3g}); propagation equal to the "
        f"CPU's (max abs err {prop_err:.3g} of max |x| {scale:.3g}); first refresh {first_refresh_s:.2f} s")

    refresh_ms = host_ms(lambda: rec.refresh(None), reps=10)
    refresh_profile = device_profile(lambda: rec.refresh(None), n=5)
    if refresh_profile is not None:
        log(f"serve-textsage: refresh {refresh_ms:.3f} ms on the host, "
            f"{refresh_profile['device_ms']:.3f} ms on the device")
    tiles = []
    pos_csr = CSR(*mask)
    for b in TS_TILES + (EVAL_TILE,):
        u = torch.from_numpy(np.random.default_rng(SEED + 20 + b).choice(ds.n_users, b, replace=False)).to(dev)
        tiles.append(topk_numbers(U, I, u, TS_K, mask, pos_csr, dev,
                                  request=(lambda u=u: rec.recommend(u.cpu().numpy(), k=TS_K))))
    return {
        **host_s,
        "first_refresh_s": first_refresh_s,
        "refresh_ms": refresh_ms,
        "refresh_profile": refresh_profile,
        "launches": launches,
        "max_abs_err": max_err,
        "propagate_vs_cpu_max_abs_err": prop_err,
        "tiles": tiles,
    }


def topk_numbers(U, I, users, k, mask, pos_csr, dev, request=None) -> dict:
    """masked_topk's times at one tile, beside its plain version's, the
    library call's (matmul + index_put_ + topk) and its bound."""
    b, d, m = users.shape[0], U.shape[1], I.shape[0]
    deg = pos_csr.degrees()[users.long()]
    cols, valid = csr_gather_padded(pos_csr, users, int(deg.max()))
    rows = torch.arange(b, device=dev)[:, None].expand_as(cols)
    mrows, mcols = rows[valid], cols[valid].long()
    sentinel = torch.tensor(float(st.MASK_SENTINEL), device=dev)

    def library():
        s = U[users] @ I.T
        s.index_put_((mrows, mcols), sentinel)
        return torch.topk(s, k)

    nbytes = 4 * (I.numel() + b * d + b + 2 * b + int(deg.sum())) + 12 * b * k
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, 2 * b * m * d / F32_FLOP_PER_S
    out = {
        "B": b, "k": k, "M": m, "d": d,
        "ms": event_ms(lambda: st.masked_topk(U, I, users, k, *mask)),
        "plain_ms": event_ms(lambda: st.masked_topk_reference(U, I, users, k, *mask)),
        "library_ms": event_ms(library),
        "bound_ms": 1e3 * max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "kernel_profile": device_profile(lambda: st.masked_topk(U, I, users, k, *mask)),
    }
    if request is not None:
        out["request_ms"] = host_ms(request)
        out["request_profile"] = device_profile(request)
    return out


def tree_gather_ids(model, graph, batch, gen):
    """The ids a flagship step's two table gathers take: every level of the
    (user, pos, neg) trees, users and items apart, in the model's order."""
    ids = {"user": [], "item": []}
    for seeds, side in ((batch.user, "user"), (batch.pos, "item"), (batch.neg, "item")):
        tree = model.sample_seed_tree(graph, seeds, side, gen)
        for s, lvl in zip(model._sides(side), [seeds] + [t.ids for t in tree]):
            ids[s].append(lvl.reshape(-1))
    return torch.cat(ids["user"]), torch.cat(ids["item"])


def implied_global_adds(plan, ids, n, d) -> dict:
    """The global adds (and the longest chain of them into one address) that
    ``plan`` makes for these ids: one a column for each distinct id of a tile
    in tile mode, one an element in row mode. Counted on the card."""
    ids = ids.long().clamp(0, n - 1)
    r = ids.shape[0]
    if plan.mode == "row" or r == 0:
        return {"adds": r * d, "share": 1.0 if r else 0.0,
                "longest_chain": int(torch.bincount(ids, minlength=n).max()) if r else 0}
    tile_of = torch.arange(r, device=ids.device) // plan.tile
    distinct = torch.unique(tile_of * n + ids)
    return {"adds": int(distinct.numel()) * d, "share": distinct.numel() / r,
            "longest_chain": int(torch.bincount(distinct % n, minlength=n).max())}


def scatter_numbers_at(cases, dev, d, rows_seed) -> list:
    """scatter_add_rows at each (N, ids) with Gaussian rows of width d: the
    plan, the call against its row mode forced and index_add_ in ten
    alternating rounds (they are close and host-bound), the device profiles
    of all three, the plain version, the bound and the global adds that the
    plan implies for these ids."""
    rows_gen = torch.Generator(device=dev).manual_seed(rows_seed)
    sms = sc.sm_count(_cuda.device_index(dev))
    out = []
    for n, ids in cases:
        r = ids.shape[0]
        rows = torch.randn((r, d), generator=rows_gen, device=dev)
        ids_long = ids.long()
        plan = sc.plan_scatter(n, r, d, sms)
        row_plan = sc.plan_scatter(n, r, d, sms, "row")
        t_bytes = 4 * r * (d + 1) / HBM_BYTES_PER_S + 4 * n * d / HBM_BYTES_PER_S
        t_flops = r * d / F32_FLOP_PER_S

        def library(n=n, ids_long=ids_long, rows=rows):
            return torch.zeros((n, d), device=dev).index_add_(0, ids_long, rows)

        fns = {"kernel": lambda n=n, ids=ids, rows=rows: sc.scatter_add_rows(ids, rows, n),
               "row_mode": lambda n=n, ids=ids, rows=rows, p=row_plan: sc._launch(ids, rows, n, p),
               "library": library}
        alt = alternating_ms(fns)
        profiles = {name: device_profile(fn) for name, fn in fns.items()}
        adds = implied_global_adds(plan, ids, n, d)
        row_adds = implied_global_adds(row_plan, ids, n, d)
        dev_ms = {name: (p or {}).get("device_ms") for name, p in profiles.items()}
        log(f"scatter (N={n}, R={r}, D={d}): {plan.mode} mode (T {plan.tile}, {plan.blocks} blocks, "
            f"{plan.smem_bytes} B shared); device ms: kernel {dev_ms['kernel']}, row mode "
            f"{dev_ms['row_mode']}, index_add_ {dev_ms['library']}; bound "
            f"{1e3 * max(t_bytes, t_flops):.5f}; global adds {adds['adds']} "
            f"({adds['share']:.3f} of R x D), longest chain {adds['longest_chain']} "
            f"(row mode {row_adds['longest_chain']})")
        out.append({
            "N": n, "R": r, "D": d,
            "plan": plan._asdict(),
            "ms": alt["kernel"]["ms"],
            "row_mode_ms": alt["row_mode"]["ms"],
            "plain_ms": event_ms(lambda: sc.scatter_add_rows_reference(ids, rows, n)),
            "library_ms": alt["library"]["ms"],
            "device_ms": dev_ms["kernel"],
            "row_mode_device_ms": dev_ms["row_mode"],
            "library_device_ms": dev_ms["library"],
            "alternating": alt,
            "bound_ms": 1e3 * max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "global_adds": adds,
            "row_mode_global_adds": row_adds,
            "distinct_ids": int(torch.unique(ids).numel()),
            "largest_id_share": float(torch.bincount(ids_long, minlength=n).max()) / r,
            "kernel_profile": profiles["kernel"],
            "row_mode_profile": profiles["row_mode"],
            "library_profile": profiles["library"],
        })
    return out


def train_textsage(ds, fs, dev) -> tuple:
    """Phase 10: the flagship's training path; returns (trainer, facts)."""
    cfg = textsage_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ds, _textsage_model(ds, fs, SEED + 1), logger=MetricLogger(quiet=True),
                      ddp_recipe=True, device=dev)
    trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_tiles = int(trainer.eval_data.users.shape[0])
    bs = cfg.bpr_batch_size
    warm = sample_bpr(trainer.generator, trainer.graph, TS_WARMUP * bs, cfg.neg_candidates,
                      edge_alias=trainer.edge_alias, neg_alias=trainer.neg_alias)

    sc.launches = st.launches = 0
    t0 = time.perf_counter()
    before = trainer.test()
    first_eval_s = time.perf_counter() - t0
    for i in range(TS_WARMUP):
        trainer.train_step(warm.slice(i * bs, (i + 1) * bs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_loss = trainer.train_one_epoch()  # ends in the epoch's one host sync
    epoch_s = time.perf_counter() - t0
    losses = trainer.epoch_losses.cpu().numpy()
    t0 = time.perf_counter()
    after = trainer.test()
    eval_s = time.perf_counter() - t0
    launches = {"scatter_add_rows": sc.launches, "masked_topk": st.launches}

    steps = TS_WARMUP + trainer.num_batches
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    assert launches["scatter_add_rows"] == 2 * steps, f"scatter launched {launches} in {steps} steps"
    assert launches["masked_topk"] == 2 * n_tiles, f"masked_topk launched {launches} for {n_tiles} tiles"
    for res in (before, after):
        assert all(np.isfinite(v) for v in res.values()), res
    assert np.isfinite(losses).all() and last < first, f"loss did not fall: {first} -> {last}"
    log(f"train-textsage: {trainer.num_batches} steps of {bs} triplets in {epoch_s:.2f} s "
        f"({trainer.samples_per_epoch / epoch_s:.0f} samples/s), loss {first:.5f} -> {last:.5f} "
        f"(first and last tenth), recall@20 {before['recall@20']:.5f} -> {after['recall@20']:.5f}; "
        f"scatter launches {launches['scatter_add_rows']} ({launches['scatter_add_rows'] / steps:g} per "
        f"step), masked_topk launches {launches['masked_topk']} ({n_tiles} tiles per evaluation)")

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    su, si = trainer.model.propagate_sampled(trainer.graph, gen)
    torch.cuda.synchronize()
    sample_inference_s = time.perf_counter() - t0
    assert su.shape == (ds.n_users, TS_D) and si.shape == (ds.m_items, TS_D)
    assert bool(torch.isfinite(su).all()) and bool(torch.isfinite(si).all())
    log(f"train-textsage: --inference sample over {ds.n_users + ds.m_items} entities in "
        f"{sample_inference_s:.2f} s")
    return trainer, {
        "steps_per_epoch": trainer.num_batches,
        "samples_per_epoch": trainer.samples_per_epoch,
        "epoch_s": epoch_s,
        "samples_per_s": trainer.samples_per_epoch / epoch_s,
        "step_ms": 1e3 * epoch_s / trainer.num_batches,
        "loss_mean": mean_loss,
        "loss_first_last_tenth": [first, last],
        "recall@20": [before["recall@20"], after["recall@20"]],
        "ndcg@20": [before["ndcg@20"], after["ndcg@20"]],
        "eval_s": eval_s,
        "first_eval_s": first_eval_s,
        "setup_s": setup_s,
        "eval_tiles": n_tiles,
        "launches": launches,
        "scatter_launches_per_step": launches["scatter_add_rows"] / steps,
        "sample_inference_s": sample_inference_s,
    }


def card_vs_cpu_textsage(ds, fs, trainer) -> dict:
    """Phase 10's card-against-CPU step (dropout 0)."""
    cfg = trainer.config
    params = params_to_numpy(trainer.model)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 9)
    batch = sample_bpr(gen, trainer.graph, cfg.bpr_batch_size, cfg.neg_candidates,
                       edge_alias=trainer.edge_alias, neg_alias=trainer.neg_alias)
    trees = [trainer.model.sample_seed_tree(trainer.graph, s, side, gen)
             for s, side in ((batch.user, "user"), (batch.pos, "item"), (batch.neg, "item"))]
    out = {}
    rate, sage.DROPOUT_RATE = sage.DROPOUT_RATE, 0.0
    try:
        for name, dev, graph in (("card", trainer.device, trainer.graph),
                                 ("cpu", torch.device("cpu"), ds.graph)):
            model = build_model("textsage", cfg, ds.graph, features=fs)
            params_from_jax(params, model)
            model.to(dev)
            opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
            loss, _ = model.loss(graph, batch.to(dev), trees=[[lvl.to(dev) for lvl in t] for t in trees])
            loss.backward()
            opt.step()
            out[name] = (flatten_params(params_to_numpy(model)), float(loss.detach()))
    finally:
        sage.DROPOUT_RATE = rate
    (pc, lc), (pp, lp) = out["card"], out["cpu"]
    np.testing.assert_allclose(lc, lp, rtol=1e-4)
    worst, off, total = 0.0, 0, 0
    for k in pp:
        diff = np.abs(pc[k] - pp[k])
        assert (diff <= 2 * cfg.lr).all(), f"{k}: {diff.max()}"
        off += int((diff > 1e-6 + 1e-5 * np.abs(pp[k])).sum())
        total += diff.size
        worst = max(worst, float(diff.max()))
    assert off <= 1e-3 * total, f"{off} of {total} parameters differ"
    log(f"textsage card vs CPU: loss {lc} / {lp}; parameters within 1e-6 + 1e-5 |p| but "
        f"{off} of {total} (max abs diff {worst:.3g})")
    return {"loss_card": lc, "loss_cpu": lp, "params_off": off, "params_total": total,
            "max_abs_diff": worst}


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
    occupancy = {f"k{k}_d{d}": st._blocks_per_sm(0, k, d) for k in (20, 64, 128) for d in (64, 100)}
    log(f"masked_topk pass 1, blocks per SM (occupancy API): {occupancy}")

    # 3. kernels against their plain versions
    max_err = kernel_cases(dev)
    sc_max_err = scatter_cases(dev)

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
        for b in TILES + (EVAL_TILE,)
    }

    st.launches = sc.launches = 0
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
    assert sc.launches == 0, "the serve path launched the scatter kernel"
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
    for b, k in [(b, k) for b in TILES for k in (10, 20)] + [(EVAL_TILE, 20)]:
        users = torch.from_numpy(request_users[b]).to(dev)
        tiles.append(topk_numbers(U, I, users, k, mask, pos_csr, dev,
                                  request=lambda b=b, k=k: rec.recommend(request_users[b], k=k)))
    head = next(t for t in tiles if t["B"] == 512 and t["k"] == 20)
    eval_tile = next(t for t in tiles if t["B"] == EVAL_TILE)

    # 6. the training path at full width
    trainer, train = train_path(ds, dev)

    # 7. the card against the CPU, and the evaluation against the plain top-k
    train["card_vs_cpu"] = card_vs_cpu(ds, trainer)
    train["eval_vs_plain"] = eval_kernel_vs_plain(trainer)

    # 8. numbers
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    batch = sample_bpr(gen, trainer.graph, TRAIN_B, trainer.config.neg_candidates)
    train["host_syncs_per_step"] = host_syncs(lambda: trainer.train_step(batch))
    train["host_syncs_sampler"] = host_syncs(
        lambda: sample_bpr(gen, trainer.graph, trainer.samples_per_epoch,
                           trainer.config.neg_candidates))
    trainer.train_step(batch)
    torch.cuda.synchronize()
    train["step_profile"] = split_profile(lambda: trainer.train_step(batch), n=20)
    train["sampler_profile"] = split_profile(
        lambda: sample_bpr(gen, trainer.graph, trainer.samples_per_epoch,
                           trainer.config.neg_candidates), n=1)
    train["eval_profile"] = split_profile(trainer.test, n=1)
    if train["step_profile"] is not None:
        # the device's idle share of an unprofiled step: its device time
        # against the step's wall time in the timed epochs
        train["idle_share_unprofiled"] = 1.0 - train["step_profile"]["device_ms"] / train["step_ms"]
    sc_shapes = scatter_numbers(trainer, dev)
    sc_head = sc_shapes[0]
    del trainer, rec

    # 9. serve-textsage-100k
    ts_ds, ts_fs, ts_host = textsage_data()
    ts_serve = serve_textsage(ts_ds, ts_fs, dev, ts_host)

    # 10. train-textsage-100k
    ts_trainer, ts_train = train_textsage(ts_ds, ts_fs, dev)
    ts_train["eval_vs_plain"] = eval_kernel_vs_plain(ts_trainer)
    ts_train["card_vs_cpu"] = card_vs_cpu_textsage(ts_ds, ts_fs, ts_trainer)

    # 11. numbers
    cfg_ts = ts_trainer.config
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    ts_batch = sample_bpr(gen, ts_trainer.graph, cfg_ts.bpr_batch_size, cfg_ts.neg_candidates,
                          edge_alias=ts_trainer.edge_alias, neg_alias=ts_trainer.neg_alias)
    ts_train["host_syncs_per_step"] = host_syncs(lambda: ts_trainer.train_step(ts_batch))
    ts_train["host_syncs_sampler"] = host_syncs(ts_trainer.sample_epoch)
    torch.cuda.synchronize()
    ts_train["step_profile"] = split_profile(lambda: ts_trainer.train_step(ts_batch), n=20)
    ts_train["sampler_profile"] = split_profile(ts_trainer.sample_epoch, n=1)
    ts_train["eval_profile"] = split_profile(ts_trainer.test, n=1)
    if ts_train["step_profile"] is not None:
        ts_train["idle_share_unprofiled"] = (
            1.0 - ts_train["step_profile"]["device_ms"] / ts_train["step_ms"])
        split = ", ".join(f"{k} {v:.3f}" for k, v in ts_train["step_profile"]["split_ms"].items())
        log(f"train-textsage: {ts_train['samples_per_s']:.0f} samples/s; a step {ts_train['step_ms']:.2f} ms "
            f"on the host, {ts_train['step_profile']['device_ms']:.3f} ms on the device ({split}); "
            f"idle {ts_train['idle_share_unprofiled']:.3f}")
    user_ids, item_ids = tree_gather_ids(ts_trainer.model, ts_trainer.graph, ts_batch, gen)
    assert (user_ids.numel(), item_ids.numel()) == tuple(r for _, r in TS_SCATTER[:2])
    cat_ids = torch.randint(0, TS_SCATTER[2][0], (TS_SCATTER[2][1],), generator=gen, device=dev,
                            dtype=torch.int32)
    ts_sc_shapes = scatter_numbers_at(
        [(TS_USERS, user_ids), (TS_ITEMS, item_ids), (TS_SCATTER[2][0], cat_ids)], dev, TS_D,
        rows_seed=SEED + 7)
    ts_head = next(t for t in ts_serve["tiles"] if t["B"] == 512)

    ts_serve_launches = ts_serve["launches"]["masked_topk"]
    ts_train_launches = ts_train["launches"]
    kernels = [{
        "name": "masked_topk",
        "route": "cuda",
        "source": "furusato_recommend_tpu_torch/csrc/streaming_topk.cu",
        "replaces": "furusato_recommend_tpu/ops/pallas_topk.py:152",
        "launches": (serve_launches + train["launches"]["masked_topk"] + ts_serve_launches
                     + ts_train_launches["masked_topk"]),
        "launches_by_path": {"serve": serve_launches, "train": train["launches"]["masked_topk"],
                             "serve_textsage": ts_serve_launches,
                             "train_textsage": ts_train_launches["masked_topk"]},
        "textsage": {"at": {"B": 512, "k": TS_K, "M": ts_ds.m_items, "d": TS_D},
                     **{key: ts_head[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                      "bound_by")},
                     "tiles": ts_serve["tiles"]},
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "at": {"B": 512, "k": 20, "M": ds.m_items, "d": D},
        "pass1_blocks_per_sm": occupancy,
        "eval_tile": {key: eval_tile[key] for key in (
            "B", "k", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_profile")},
        "tiles": tiles,
    }, {
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "furusato_recommend_tpu_torch/csrc/scatter_add_rows.cu",
        "replaces": "furusato_recommend_tpu/ops/pallas_scatter.py:97",
        "launches": train["launches"]["scatter_add_rows"] + ts_train_launches["scatter_add_rows"],
        "launches_by_path": {"serve": 0, "train": train["launches"]["scatter_add_rows"],
                             "serve_textsage": ts_serve["launches"]["scatter_add_rows"],
                             "train_textsage": ts_train_launches["scatter_add_rows"]},
        "launches_per_step": train["scatter_launches_per_step"],
        "launches_per_step_textsage": ts_train["scatter_launches_per_step"],
        "textsage_shapes": ts_sc_shapes,
        "max_abs_err": sc_max_err,
        "ms": sc_head["ms"],
        "row_mode_ms": sc_head["row_mode_ms"],
        "plain_ms": sc_head["plain_ms"],
        "bound_ms": sc_head["bound_ms"],
        "bound_by": sc_head["bound_by"],
        "library_ms": sc_head["library_ms"],
        "at": {"N": sc_head["N"], "R": sc_head["R"], "D": D},
        "shapes": sc_shapes,
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "serve": {"propagate_ms": propagate_ms, "first_refresh_s": first_refresh_s,
                  "propagate_profile": propagate_profile,
                  "request_ms": {f"B{t['B']}_k{t['k']}": t["request_ms"] for t in tiles}}
    }))
    log(json.dumps({"train": {
        "model": "lgn", "d": D, "layers": 2, "B": TRAIN_B, "lr": TRAIN_LR,
        "compute_dtype": "bfloat16", "users": ds.n_users, "items": ds.m_items,
        "train_edges": ds.train_size, **train}}))
    ts_shape = {"model": "textsage", "d": TS_D, "layers": cfg_ts.n_layers, "fanout": cfg_ts.num_neighbors,
                "compute_dtype": cfg_ts.compute_dtype, "users": ts_ds.n_users, "items": ts_ds.m_items,
                "train_edges": ts_ds.train_size}
    log(json.dumps({"serve_textsage": {**ts_shape, **ts_serve}}))
    log(json.dumps({"train_textsage": {**ts_shape, "B": cfg_ts.bpr_batch_size, "lr": cfg_ts.lr,
                                       **ts_train}}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
