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
               R = 999; R = 0; one id 5,000 times; ids out of range, D = 50):
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
  8. numbers   one JSON line of kernels (time, plain time, library time,
               bound, launches on the main paths; masked_topk also at the
               evaluation's tile; scatter_add_rows and index_add_ timed in ten
               alternating rounds, median and quartiles), the serve line, and the
               train line (samples/s, the step split by torch.profiler into
               SpMM forward / backward, scatter, gather, sampler, Adam and
               the rest, the evaluation, and the card's idle share)

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

from furusato_recommend_tpu_torch.config import Config
from furusato_recommend_tpu_torch.convert import params_from_jax, params_to_numpy
from furusato_recommend_tpu_torch.data import synthetic_dataset
from furusato_recommend_tpu_torch.data.graph import CSR
from furusato_recommend_tpu_torch.eval.metrics import batch_metric_sums
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
# profiler ranges (ops/segment.py, ops/scatter.py, sampling/bpr.py,
# eval/evaluate.py, torch.optim's own) and the step part each one names
RANGES = {
    "spmm_fwd": "spmm_fwd", "spmm_bwd": "spmm_bwd", "table_gather": "gather",
    "scatter_add_rows": "scatter", "sample_bpr": "sampler", "evaluate": "eval",
    "Optimizer.step#Adam.step": "adam",
}
# the port's kernels, launched through ctypes outside any torch operation
OWN_KERNELS = {
    "scatter_add_rows_kernel": "scatter", "score_segments": "masked_topk",
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
    cases = [(n, rng.integers(0, n, r), D) for n, r in SCATTER_SHAPES]
    cases += [
        (1000, rng.integers(0, 1000, 999), D),  # R not a multiple of 32
        (500, np.zeros(0, np.int64), D),  # no rows: a zero table
        (100, np.concatenate([np.full(5000, 7), rng.integers(0, 100, 300)]), D),  # a hub
        (300, np.concatenate([rng.integers(0, 300, 2000), [-3, 300, 10**6]]), 50),  # clamped
    ]
    max_err, n_cases = 0.0, 0
    for n, ids, d in cases:
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
            else:
                got = sc.scatter_add_rows(ids_t, rows_t, n)
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
    rows_gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = []
    for (n, r), ids in zip(SCATTER_SHAPES, (batch.user, torch.cat([batch.pos, batch.neg]))):
        assert ids.shape[0] == r
        rows = torch.randn((r, D), generator=rows_gen, device=dev)
        ids_long = ids.long()
        t_bytes = 4 * r * (D + 1) / HBM_BYTES_PER_S + 4 * n * D / HBM_BYTES_PER_S
        t_flops = r * D / F32_FLOP_PER_S

        def library():
            return torch.zeros((n, D), device=dev).index_add_(0, ids_long, rows)

        # the call and index_add_'s are close and host-bound: taken in turns
        alt = alternating_ms({"kernel": lambda: sc.scatter_add_rows(ids, rows, n),
                              "library": library})
        out.append({
            "N": n, "R": r, "D": D,
            "ms": alt["kernel"]["ms"],
            "plain_ms": event_ms(lambda: sc.scatter_add_rows_reference(ids, rows, n)),
            "library_ms": alt["library"]["ms"],
            "alternating": alt,
            "bound_ms": 1e3 * max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "distinct_ids": int(torch.unique(ids).numel()),
            "kernel_profile": device_profile(lambda: sc.scatter_add_rows(ids, rows, n)),
            "library_profile": device_profile(library),
        })
    return out


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
    kernels = [{
        "name": "masked_topk",
        "route": "cuda",
        "source": "furusato_recommend_tpu_torch/csrc/streaming_topk.cu",
        "replaces": "furusato_recommend_tpu/ops/pallas_topk.py:152",
        "launches": serve_launches + train["launches"]["masked_topk"],
        "launches_by_path": {"serve": serve_launches, "train": train["launches"]["masked_topk"]},
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
        "launches": train["launches"]["scatter_add_rows"],
        "launches_by_path": {"serve": 0, "train": train["launches"]["scatter_add_rows"]},
        "launches_per_step": train["scatter_launches_per_step"],
        "max_abs_err": sc_max_err,
        "ms": sc_head["ms"],
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
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
