"""The port's CUDA kernels against their plain PyTorch versions, on a card; and
the top-k kernels' launch plans, which run anywhere.

This file imports neither JAX nor the JAX package, so on a machine with a card
and no JAX it runs on its own:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py

Tolerances: inputs that are small multiples of 1/8 give exact dot products and
sums in any summation order, so there ids and values must be equal. For
masked_topk, Gaussian inputs give values within rtol 1e-5 / atol 1e-6 and
equal ids wherever the plain version's neighbouring values differ by more
than 1e-5 relative. For scatter_add_rows, Gaussian rows give sums within
1e-5 + 1e-5 * (the sum of the magnitudes added into the element): the kernel's
atomic adds take another order than the plain version's, and it changes from
run to run.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from furusato_recommend_tpu_torch.ops import scatter as sc
from furusato_recommend_tpu_torch.ops import streaming_topk as st
from furusato_recommend_tpu_torch.ops.streaming_topk import (
    ITEM_TILE,
    USER_TILE,
    WIDE_MAX_SEGMENT,
    masked_topk,
    masked_topk_reference,
    masked_topk_wide,
    plan_tiles,
    plan_wide,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("b", [1, 8, 33, 64, 65, 512, 1000, 1024, 5000])
@pytest.mark.parametrize("m", [127, 20000, 20001])
@pytest.mark.parametrize("per_sm", [1, 2])  # pass-1 blocks per SM: k > 32, k <= 32 on an H100
def test_plan_tiles_cover_users_and_catalog(b, m, per_sm):
    sms = 132
    n_ut, n_seg, seg_len = plan_tiles(b, m, sms, per_sm)
    assert (n_ut - 1) * USER_TILE < b <= n_ut * USER_TILE  # every row in one user tile
    assert seg_len % ITEM_TILE == 0 and 1 <= n_seg <= 2**31 - 1
    bounds = [(s * seg_len, min(m, (s + 1) * seg_len)) for s in range(n_seg)]
    assert all(lo < hi for lo, hi in bounds)  # no empty segment
    covered = np.zeros(m, dtype=int)
    for lo, hi in bounds:
        covered[lo:hi] += 1
    assert (covered == 1).all()  # every item in exactly one segment
    # two blocks per SM wherever there are that many (user tile, item tile) pairs
    assert n_ut * n_seg >= min(2 * sms, n_ut * -(-m // ITEM_TILE))


@pytest.mark.parametrize("b", [1, 8, 33, 64, 65, 512, 1000, 1024, 2048, 100_000])
@pytest.mark.parametrize("m", [1, 127, 300, 10000, 20001, 30000])
@pytest.mark.parametrize("per_sm", [1, 2])
def test_plan_wide_covers_users_and_catalog(b, m, per_sm):
    """The radix select's plan: every row in one user tile, every item in
    exactly one segment of whole item tiles, at most 65535 items a segment
    (its 16-bit counts), and one wave wherever the user tiles leave room."""
    sms = 132
    n_ut, n_seg, seg_len = plan_wide(b, m, sms, per_sm)
    assert (n_ut - 1) * USER_TILE < b <= n_ut * USER_TILE
    assert seg_len % ITEM_TILE == 0 and seg_len <= WIDE_MAX_SEGMENT < 2**16
    assert (n_seg - 1) * seg_len < m <= n_seg * seg_len  # no empty segment, none missing
    if n_ut <= per_sm * sms:
        assert n_ut * n_seg <= per_sm * sms
        # segments a tile shorter would not fit the wave
        per_seg, n_tiles = seg_len // ITEM_TILE, -(-m // ITEM_TILE)
        assert per_seg == 1 or n_ut * -(-n_tiles // (per_seg - 1)) > per_sm * sms


def _compare(kv, ki, rv, ri, exact):
    kv, ki, rv, ri = (x.cpu().numpy() for x in (kv, ki, rv, ri))
    if exact:
        np.testing.assert_array_equal(ki, ri)
        np.testing.assert_array_equal(kv, rv)
        return
    np.testing.assert_allclose(kv, rv, rtol=1e-5, atol=1e-6)
    gap = np.abs(np.diff(rv, axis=1)) > 1e-5 * np.abs(rv[:, 1:])
    sep = np.ones_like(ki, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(ki[sep], ri[sep])


def _cases(n, m, d, seed=5):
    rng = np.random.default_rng(seed)
    exact = (
        (rng.integers(-4, 5, size=(n, d)) / 8).astype(np.float32),
        (rng.integers(-2, 3, size=(m, d)) / 8).astype(np.float32),
    )
    exact[1][1::2] = exact[1][0::2][: m // 2]  # every item has a twin: ties
    scale = 0.3 * (64 / d) ** 0.5  # scaled so that the sigmoid does not saturate
    gauss = (
        (scale * rng.standard_normal((n, d))).astype(np.float32),
        (scale * rng.standard_normal((m, d))).astype(np.float32),
    )
    rows = []
    for u in range(n):
        # row 7 leaves 50 items unmasked, so -1024 entries rank at k > 50
        deg = m - 50 if u == 7 else int(rng.integers(0, min(m, 60)))
        rows.append(np.sort(rng.choice(m, size=deg, replace=False)))
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    return exact, gauss, indptr, np.concatenate(rows).astype(np.int32)


def _users(b, n, dev):
    users = torch.arange(b, device=dev) % n
    users[0] = 7  # the densely masked row
    if b > 3:
        users[2] = users[3] = 11  # the same user twice in one tile
    return users


def _check_topk(n, m, d, tiles, ks, dev, topk=masked_topk):
    exact, gauss, indptr, indices = _cases(n, m, d)
    ip, ix = torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev)
    for kind, (u, i) in (("exact", exact), ("gauss", gauss)):
        U, I = torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev)
        for b in tiles:
            users = _users(b, n, dev)
            for k in (k for k in ks if k <= m):
                for masked in (False, True):
                    for sig in (False, True):
                        mk = (ip, ix) if masked else (None, None)
                        before = (st.launches, st.wide_launches)
                        kv, ki = topk(U, I, users, k, *mk, sigmoid=sig)
                        wide = topk is masked_topk_wide or k > st.MAX_K
                        assert (st.launches, st.wide_launches) == (before[0] + 1, before[1] + wide)
                        rv, ri = masked_topk_reference(U, I, users, k, *mk, sigmoid=sig)
                        torch.cuda.synchronize()
                        _compare(kv, ki, rv, ri, kind == "exact")
                        if masked and not sig and k >= 128:
                            assert (kv[0, 50:] == -1024.0).all()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    _need_card()
    _check_topk(300, 20000, 64, (1, 8, 64, 512), (10, 20, 128), torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [127, 20000, 20001])
@pytest.mark.parametrize("d", [32, 64, 100])
def test_cuda_kernel_tiling_edges(m, d):
    """Rows not a multiple of the user tile, catalogs not a multiple of the
    item tile, d resident (<= 64) and in chunks (100)."""
    _need_card()
    _check_topk(1100, m, d, (1, 33, 65, 512, 1000, 1024), (1, 20, 128), torch.device("cuda"))


@pytest.mark.cuda
def test_cuda_kernel_at_the_textsage_shape():
    """The TextSAGE flagship's serving and evaluation shape: d = 32 over
    30,000 items, requests of 1-512 users and the evaluation's 1024."""
    _need_card()
    _check_topk(1100, 30000, 32, (1, 8, 64, 512, 1024), (10, 20), torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(20001, 30), (3000, 300), (500, 4096)])
def test_cuda_kernel_odd_widths(m, d):
    """d not a multiple of 4 (4-byte copies), several chunks, the widest d."""
    _need_card()
    _check_topk(200, m, d, (1, 65), (1, 20, 128), torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(20000, 64), (10000, 32)])
def test_cuda_kernel_above_128_in_rounds(m, d):
    """k > 128 runs the radix select of csrc/streaming_topk_wide.cu, one
    launch a call; held against one plain top-k of size k."""
    _need_card()
    _check_topk(1100, m, d, (1, 65, 512, 2048), (129, 200, 256), torch.device("cuda"))


@pytest.mark.cuda
def test_cuda_kernel_at_the_candidate_dump_shape():
    """The ranker's candidate dumps: k = 50 over 10,000 items at d = 32, tiles
    of 2048 and 1024 users (and one), the sigmoid off as the dumps run it
    (and on)."""
    _need_card()
    _check_topk(2100, 10000, 32, (1, 1024, 2048), (50,), torch.device("cuda"))


@pytest.mark.cuda
def test_cuda_kernel_whole_catalog_in_rounds():
    """k = M = 300 in one radix-select launch, the densely masked row's -1024
    entries ranked by id at its end; and the radix select itself at k = 1,
    50 and 128."""
    _need_card()
    _check_topk(200, 300, 32, (1, 65), (300,), torch.device("cuda"))
    _check_topk(200, 300, 32, (1, 65), (1, 50, 128), torch.device("cuda"), topk=masked_topk_wide)


@pytest.mark.cuda
def test_cuda_rounds_launch_once_a_round_without_waiting():
    """One launch a call at any k (the radix select above 128), none of them
    waiting for the card."""
    _need_card()
    dev = torch.device("cuda")
    exact, _, indptr, indices = _cases(300, 2000, 64)
    U, I = (torch.from_numpy(x).to(dev) for x in exact)
    mk = (torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev))
    users = torch.arange(100, device=dev)
    for k in (128, 129, 200, 385):
        before = (st.launches, st.wide_launches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # raises on a host sync
        try:
            kv, ki = masked_topk(U, I, users, k, *mk)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert (st.launches, st.wide_launches) == (before[0] + 1, before[1] + (k > st.MAX_K))
        _compare(kv, ki, *masked_topk_reference(U, I, users, k, *mk), exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sigmoid_saturated", "zero_user", "all_equal", "few_unmasked"])
def test_cuda_radix_select_ties(kind):
    """The radix select on tie-heavy inputs, ids and values equal to the plain
    version: scores that the sigmoid saturates (multiples of 128: exactly 1.0
    above zero, 0.0 below, 0.5 at it); user
    rows of zeros (every score +-0.0); an item table of one repeated row; a
    row masked down to 20 items at k = 200 and 300 (runs of -1024 tied by
    id). A large k takes the sort in device memory (k = 10000)."""
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    n, m, d = 300, 12000, 32
    u = (rng.integers(-4, 5, size=(n, d)) / 8).astype(np.float32)
    i = (rng.integers(-2, 3, size=(m, d)) / 8).astype(np.float32)
    sig = kind == "sigmoid_saturated"
    if sig:
        u *= 8192.0
    if kind == "zero_user":
        u[::3] = 0.0
    if kind == "all_equal":
        i[:] = i[7]
    rows = [np.sort(rng.choice(m, size=m - 20 if r % 5 == 0 else int(rng.integers(0, 40)), replace=False))
            for r in range(n)]
    ip = torch.from_numpy(np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)).to(dev)
    ix = torch.from_numpy(np.concatenate(rows).astype(np.int32)).to(dev)
    U, I = torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev)
    for b in (1, 65, 512):
        users = torch.from_numpy(rng.permutation(n)[:b]).to(dev)
        for k in (1, 50, 128, 200, 300, 10000):
            for mk in ((None, None), (ip, ix)):
                kv, ki = masked_topk_wide(U, I, users, k, *mk, sigmoid=sig)
                rv, ri = masked_topk_reference(U, I, users, k, *mk, sigmoid=sig)
                torch.cuda.synchronize()
                _compare(kv, ki, rv, ri, exact=True)  # the sigmoid's 0, 0.5 and 1 are exact too


@pytest.mark.cuda
def test_cuda_kernel_clamps_ids_and_takes_both_widths():
    _need_card()
    dev = torch.device("cuda")
    exact, _, indptr, indices = _cases(300, 2000, 64)
    U, I = (torch.from_numpy(x).to(dev) for x in exact)
    mk = (torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev))
    for dtype in (torch.int32, torch.int64):
        users = torch.tensor([-5, 0, 299, 300, 10**6, 7], dtype=dtype, device=dev)
        kv, ki = masked_topk(U, I, users, 20, *mk)
        rv, ri = masked_topk_reference(U, I, users, 20, *mk)
        _compare(kv, ki, rv, ri, exact=True)
        _compare(kv[:2], ki[:2], *masked_topk_reference(U, I, users.new_tensor([0, 0]), 20, *mk),
                 exact=True)


@pytest.mark.cuda
def test_cuda_kernels_never_wait_for_the_card():
    _need_card()
    dev = torch.device("cuda")
    exact, _, indptr, indices = _cases(300, 2000, 64)
    U, I = (torch.from_numpy(x).to(dev) for x in exact)
    mk = (torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev))
    users = torch.arange(100, device=dev)
    ids = torch.randint(0, 500, (4000,), device=dev)
    rows = torch.randn((4000, 64), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # raises on a host sync
    try:
        masked_topk(U, I, users, 20, *mk)
        sc.scatter_add_rows(ids, rows, 500)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _scatter_rows(r, d, exact, rng):
    if exact:
        return (rng.integers(-8, 9, (r, d)) / 8).astype(np.float32)
    return rng.standard_normal((r, d)).astype(np.float32)


def _check_scatter(n, ids_np, d, exact, rng, plan=None, dtype=np.int32):
    """The kernel (under ``plan``, default the wrapper's own) against the plain
    version: exact rows bit-equal, Gaussian rows within 1e-5 + 1e-5 * the
    summed magnitudes."""
    dev = torch.device("cuda")
    ids = torch.from_numpy(np.asarray(ids_np).astype(dtype)).to(dev)
    rows = torch.from_numpy(_scatter_rows(ids.shape[0], d, exact, rng)).to(dev)
    before = sc.launches
    got = sc.scatter_add_rows(ids, rows, n) if plan is None else sc._launch(ids, rows, n, plan)
    want = sc.scatter_add_rows_reference(ids, rows, n)
    mag = sc.scatter_add_rows_reference(ids, rows.abs(), n)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    got, want, mag = (x.cpu().numpy() for x in (got, want, mag))
    assert got.shape == (n, d)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= 1e-5 + 1e-5 * mag).all()


def _zipf_ids(n, r, rng):
    return np.minimum(rng.zipf(1.2, r) - 1, n - 1)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,r,d",
    [
        (50000, 8192, 64),  # the bench step's user gather
        (20000, 16384, 64),  # its item gather (positives and negatives)
        (1000, 999, 64),  # R not a multiple of 32
        (500, 0, 64),  # no rows: a zero table, and still one launch
        (300, 2003, 50),  # D not a multiple of 32
        (100_000, 180_000, 32),  # the TextSAGE step's user-side tree gather
        (30_000, 285_000, 32),  # its item-side tree gather: Zipf(1.2) ids, as tree neighbours
        (40, 400_000, 32),  # a categorical gather: 100k users x 4 fields, 40 categories
    ],
)
@pytest.mark.parametrize("exact", [True, False])
def test_cuda_scatter_matches_plain_version(n, r, d, exact):
    _need_card()
    rng = np.random.default_rng(n + r + d)
    ids = _zipf_ids(n, r, rng) if (n, r) == (30_000, 285_000) else rng.integers(0, n, r)
    _check_scatter(n, ids, d, exact, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
def test_cuda_scatter_at_the_ranker_shape(exact):
    """The ranker's categorical gradient: 256 groups x 111 candidates x 9
    columns into a 32-row table at emb 16, about 8,000 rows an id."""
    _need_card()
    rng = np.random.default_rng(23)
    _check_scatter(32, rng.integers(0, 32, 256 * 111 * 9), 16, exact, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
def test_cuda_scatter_one_id_takes_every_row(exact):
    _need_card()
    rng = np.random.default_rng(21)
    _check_scatter(30_000, np.full(285_000, 29_999), 32, exact, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(100_000, 180_000), (30_000, 285_000)])
@pytest.mark.parametrize("exact", [True, False])
def test_cuda_scatter_colliding_ids(n, r, exact):
    """Ids that are all multiples of the tile's hash slot count."""
    _need_card()
    rng = np.random.default_rng(22)
    plan = sc.plan_scatter(n, r, 32, sc.sm_count(0))
    assert plan.mode == "tile"
    slots = 2 * plan.tile
    _check_scatter(n, rng.integers(0, n // slots, r) * slots, 32, exact, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [-1, 0, 1])
@pytest.mark.parametrize("mode", ["plan", "tile"])
def test_cuda_scatter_tile_edges(edge, mode):
    """R = T - 1, T, T + 1 for the item-side gather's T (the last tile partial,
    one tile, one tile and a row), under the plan that R itself gets and under
    the item-side gather's tile plan."""
    _need_card()
    rng = np.random.default_rng(23)
    tile_plan = sc.plan_scatter(30_000, 285_000, 32, sc.sm_count(0))
    r = tile_plan.tile + edge
    for exact in (True, False):
        _check_scatter(30_000, _zipf_ids(30_000, r, rng), 32, exact, rng,
                       plan=tile_plan if mode == "tile" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4, 50, 300, 4096])
@pytest.mark.parametrize("mode", ["plan", "tile", "row"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [3, 2000])
def test_cuda_scatter_widths_modes_and_id_types(d, mode, dtype, n):
    """Every mode at odd and wide D (column chunks in tile mode at D = 4096),
    on skewed ids of both widths, out-of-range ids included, into a table of
    3 rows and of 2000."""
    _need_card()
    rng = np.random.default_rng(d)
    r = 5000
    ids = np.concatenate([_zipf_ids(n, r - 3, rng), [-3, n, 10**6]])
    plan = None if mode == "plan" else sc.plan_scatter(n, r, d, sc.sm_count(0), mode)
    for exact in (True, False):
        _check_scatter(n, ids, d, exact, rng, plan=plan, dtype=dtype)


@pytest.mark.cuda
def test_cuda_scatter_hub_and_clamped_ids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(3)
    n, d = 100, 64
    ids = np.concatenate([np.full(5000, 7), rng.integers(0, n, 300), [-3, n, 10**6]])
    rows = _scatter_rows(len(ids), d, True, rng)
    dev = torch.device("cuda")
    got = sc.scatter_add_rows(torch.from_numpy(ids.astype(np.int32)).to(dev),
                              torch.from_numpy(rows).to(dev), n)
    want = np.zeros((n, d), np.float32)
    np.add.at(want, np.clip(ids, 0, n - 1), rows)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_table_gather_gradient_runs_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(4)
    table = (rng.integers(-8, 9, (2000, 64)) / 8).astype(np.float32)
    ids = rng.integers(0, 2000, (3, 700)).astype(np.int64)
    weight = (rng.integers(-4, 5, (3, 700, 64)) / 4).astype(np.float32)
    grads = []
    for dev in ("cpu", "cuda"):
        t = torch.from_numpy(table).to(dev).requires_grad_(True)
        out = sc.table_gather(t, torch.from_numpy(ids).to(dev))
        torch.sum(out * torch.from_numpy(weight).to(dev)).backward()
        grads.append(t.grad.cpu().numpy())
    np.testing.assert_array_equal(grads[1], grads[0])


def _graph_trainer(dropout: bool, key: str = "lgn", tmp=None, **over):
    """A Trainer on the card whose steps are captured: mf or a LightGCN
    key (d 32, B 1024), or a SAGE-family key at the textsage flagship cut to
    d 32, fanout 3, B 512 (features n / w / t, asage's n / c / t / w; the edge
    times and relation labels drawn with them; sasrec with its item
    sequences; dask with its numeric matrices on disk under ``tmp``);
    ``over``: config fields (gnn's conv, rsage's combine, the cadence).
    Module-level imports stay free of the trainer's."""
    import dataclasses

    from furusato_recommend_tpu_torch.config import Config, ddp_flagship_config
    from furusato_recommend_tpu_torch.data.dataset import synthetic_dataset
    from furusato_recommend_tpu_torch.data.features import synthetic_features
    from furusato_recommend_tpu_torch.data.ooc import MemmapNumeric
    from furusato_recommend_tpu_torch.data.sequence import build_sequences
    from furusato_recommend_tpu_torch.models.registry import SAGE_KEYS, build_model
    from furusato_recommend_tpu_torch.obs.log import MetricLogger
    from furusato_recommend_tpu_torch.train.trainer import Trainer

    ds = synthetic_dataset(n_users=3000, m_items=2000, avg_degree=10, seed=0)
    if key in SAGE_KEYS:
        fields = dataclasses.asdict(ddp_flagship_config())
        fields.pop("mesh")
        fields.update(model=key, latent_dim=32, num_neighbors=3, bpr_batch_size=512, eval_user_batch=256,
                      topks=(10, 20), test_count=2, compute_dtype="float32", lr=1e-3, seed=5, **over)
        if key == "asage":  # its attribute graphs from the categorical columns
            fields.update(user_feature="nctw", item_feature="nctw")
        cfg = Config(**fields)
        inputs = {"features": synthetic_features(ds, cfg, seed=1, with_edge_time=True, with_edge_label=True)}
        if key == "sasrec":
            inputs["sequences"] = build_sequences(ds)
        if key == "dask":
            fs = inputs["features"]
            inputs["ooc_numeric"] = {side: MemmapNumeric.write(str(tmp / f"{side}_numeric.npy"),
                                                               getattr(fs, side).numeric.numpy())
                                     for side in ("user", "item")}
            inputs["features"] = dataclasses.replace(fs, user=dataclasses.replace(fs.user, numeric=None),
                                                     item=dataclasses.replace(fs.item, numeric=None))
        model = build_model(key, cfg, ds.graph, **inputs)
    else:
        cfg = Config(model=key, latent_dim=32, n_layers=2, bpr_batch_size=1024, lr=1e-3, eval_user_batch=256,
                     topks=(10, 20), compute_dtype="float32", seed=5, dropout=dropout, keep_prob=0.7, **over)
        model = build_model(key, cfg, ds.graph)
    trainer = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True),
                      ddp_recipe=key in SAGE_KEYS and key != "sasrec", device="cuda")
    trainer.init_state()
    return trainer


def _graph_state(trainer):
    """(parameters on the host, the optimizer's state tensors, the generator
    state), copied."""
    params = {k: p.detach().cpu().numpy().copy() for k, p in trainer.model.named_parameters()}
    adam = [{k: v.clone() for k, v in trainer.optimizer.state[p].items()} for p in trainer.model.parameters()]
    return params, adam, trainer.generator.get_state()


@torch.no_grad()
def _set_graph_state(trainer, state):
    params, adam, gen = state
    for k, p in trainer.model.named_parameters():
        p.copy_(torch.from_numpy(params[k]))
    for p, saved in zip(trainer.model.parameters(), adam):
        for k, v in saved.items():
            trainer.optimizer.state[p][k].copy_(v)
    trainer.generator.set_state(gen)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [False, True])
def test_cuda_replayed_epoch_equals_the_eager_epoch(dropout):
    """An epoch by replays of the captured lgn step against the eager steps
    from the same state (edge dropout drawn in the graph from the trainer's
    generator): the generator states equal, the losses within rtol 1e-5 (the
    first 1e-6), the parameters under phase 7's rule of ``chip_smoke.py``
    (within 4 lr, all but 1e-3 of them within 1e-6 + 1e-5 |p|: the scatter
    kernel's atomic adds sum in no fixed order); each replay counted as 4
    scatter launches; no host sync in the replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from furusato_recommend_tpu_torch.train.graphed import WARMUP_STEPS

    t = _graph_trainer(dropout)
    n, bs = t.num_batches, t.config.bpr_batch_size
    t.train_one_epoch()  # the warm-up steps, the capture, replays
    graph = t.step_graph
    assert t.captured and graph.graph is not None and graph.stats["captures"] == 1
    assert graph.scatter_launches == 4
    start = _graph_state(t)
    batches = t.sample_epoch()
    sc.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed = t.train_epoch([batches.slice(b * bs, (b + 1) * bs) for b in range(n)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sc.launches == 4 * n and graph.stats["replays"] == 2 * n - WARMUP_STEPS
    got = (replayed.cpu().numpy(), *_graph_state(t)[::2])
    _set_graph_state(t, start)
    batches = t.sample_epoch()
    eager = torch.stack([t.train_step(batches.slice(b * bs, (b + 1) * bs)) for b in range(n)])
    want = (eager.cpu().numpy(), *_graph_state(t)[::2])
    assert torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    off = total = 0
    for k, w in want[1].items():
        diff = np.abs(got[1][k] - w)
        assert diff.max() <= 4 * t.config.lr, k
        off += int((diff > 1e-6 + 1e-5 * np.abs(w)).sum())
        total += diff.size
    assert off <= 1e-3 * total, f"{off} of {total} parameters off"


@pytest.mark.cuda
def test_cuda_step_graph_recaptures_after_init_state_and_restore(tmp_path):
    """The graph is dropped when init_state or restore replace the Adam
    states, and the next epoch captures again; every epoch launches the
    scatter kernel 4 times a step; a trainer restored from a checkpoint takes
    the epoch the saved one takes, by its own capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    t = _graph_trainer(False)
    n = t.num_batches
    for captures, replace in ((1, None), (2, t.init_state), (3, lambda: t.restore(tmp_path / "a.ckpt"))):
        if replace is not None:
            replace()
            assert t.step_graph.graph is None
        sc.launches = 0
        assert np.isfinite(t.train_one_epoch())
        assert sc.launches == 4 * n
        assert t.step_graph.stats["captures"] == captures and t.step_graph.graph is not None
        if captures == 1:
            t.save(tmp_path / "a.ckpt")
    other = _graph_trainer(False)
    other.restore(tmp_path / "a.ckpt")
    t.restore(tmp_path / "a.ckpt")
    t.train_one_epoch()
    other.train_one_epoch()
    assert torch.equal(t.generator.get_state(), other.generator.get_state())
    np.testing.assert_allclose(other.epoch_losses.cpu().numpy(), t.epoch_losses.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_cuda_step_graph_takes_whole_batches_of_one_shape():
    """The static inputs are made once at the first batch's shape; a batch
    of another shape, or one rank's share of a batch, is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    t = _graph_trainer(False)
    batches = t.sample_epoch()
    t.step_graph.step(batches.slice(0, 1024))
    ptr = t.step_graph.batch.user.data_ptr()
    with pytest.raises(ValueError, match="a batch of"):
        t.step_graph.step(batches.slice(0, 512))
    with pytest.raises(ValueError, match="whole batches"):
        t.step_graph.step(batches.slice(0, 1024).data_shard(0, 2))
    t.step_graph.step(batches.slice(1024, 2048))
    assert t.step_graph.batch.user.data_ptr() == ptr


# one key of each family the trainer captures (a SAGE-family step's own
# conv, head or loss), and every configuration it captures besides lgn and
# textsage (the first two captured), with its config fields
_FAMILY_KEYS = ["lgn", "textsage", "mf", "radj", "pinsage", "nssage", "tgrec", "rsage", "sasrec", "asage"]
_NEW_KEYS = ([(key, {}) for key in ("mf", "radj", "lgcnssm", "textsage_id", "sage", "fsage", "fastsage", "lightsage",
                                    "pinsage", "mrec", "nssage")]
             + [("gnn", {"conv": conv}) for conv in ("gcn", "ggnn", "gat", "transformer")]
             + [("tgrec", {}), ("tgrec2", {})]
             + [("rsage", {"multi_relational": mode}) for mode in ("add", "sum", "prod")]
             + [(key, {}) for key in ("tgsrec", "sasgnn", "sasrec", "asage")])
# the parameters a key's loss never reads (sasrec scores its users by their
# item sequences: the user side's projections and the SAGE layers go unread);
# every other parameter of a captured key has a gradient every step
_UNREAD = {"sasrec": {"user_numeric_w", "user_numeric_b", "user_proj_w", "user_proj_b",
                      "layers.0.w", "layers.0.b", "layers.1.w", "layers.1.b"}}


@pytest.mark.cuda
@pytest.mark.parametrize("key", _FAMILY_KEYS)
def test_cuda_captured_adam_matches_optax_over_eight_steps(key):
    """The fused, capturable Adam of a captured configuration over 8 real
    steps (as many as tests/test_torch_cadence.py's epoch: 3 eager warm-up
    steps, the capture, 5 replays) against optax.adam's rule in float64
    (``tests/torch_oracle.py::OptaxAdam``, held against optax on the CPU), fed
    each step's gradients as the card computed them: the parameters within
    test_torch_cadence.py's rtol 1e-4 / atol 1e-6, the moments within rtol
    1e-4 (atol 1e-9 / 1e-12, as test_torch_graphed.py holds them against
    optax), the step count 8. Every parameter has a gradient at every step
    but those the key's loss never reads (``_UNREAD``: sasrec's user side and
    SAGE layers), which have none, no state and do not move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from furusato_recommend_tpu_torch.train.graphed import WARMUP_STEPS
    from torch_oracle import OptaxAdam

    t = _graph_trainer(False, key)
    assert t.captured and all(g["fused"] and g["capturable"] for g in t.optimizer.param_groups)
    params = [p for g in t.optimizer.param_groups for p in g["params"]]
    names = {id(p): k for k, p in t.model.named_parameters()}
    read = [names[id(p)] not in _UNREAD.get(key, ()) for p in params]
    bs = t.config.bpr_batch_size
    batches = t.sample_epoch()
    start = [p.detach().clone() for p in params]
    ref = OptaxAdam([x.cpu().numpy() for x, r in zip(start, read) if r], t.config.lr)
    for b in range(8):
        t.step_graph.step(batches.slice(b * bs, (b + 1) * bs))
        assert [p.grad is not None for p in params] == read, b
        ref.step([p.grad.cpu().numpy() for p, r in zip(params, read) if r])
    assert t.step_graph.stats["captures"] == 1 and t.step_graph.stats["replays"] == 8 - WARMUP_STEPS
    stepped = [p for p, r in zip(params, read) if r]
    for p, x, r in zip(params, start, read):
        if not r:
            assert not t.optimizer.state[p] and torch.equal(p.detach(), x)
    for i, p in enumerate(stepped):
        state = t.optimizer.state[p]
        assert float(state["step"]) == ref.count == 8
        np.testing.assert_allclose(p.detach().cpu().numpy(), ref.params[i], rtol=1e-4, atol=1e-6, err_msg=str(i))
        np.testing.assert_allclose(state["exp_avg"].cpu().numpy(), ref.mu[i], rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(state["exp_avg_sq"].cpu().numpy(), ref.nu[i], rtol=1e-4, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("key,over", _NEW_KEYS,
                         ids=[key + "".join(f"-{v}" for v in over.values()) for key, over in _NEW_KEYS])
def test_cuda_key_captures_without_a_host_sync_and_replays_its_eager_steps(key, over):
    """Each captured configuration but lgn and textsage: after one eager step (which
    builds what the step keeps), its warm-up steps, capture and first replay
    run under torch's sync debug mode "error"; then 3 replays, also under it,
    against 3 eager steps from the same state on the same batches: the
    generator states equal, the first losses within 1e-6 relative, the
    losses and parameters under the key's rule (mf and the LightGCN keys
    ``chip_smoke.py``'s phase 7's: losses rtol 1e-5, every parameter within
    4 lr, all but 1e-3 of them within 1e-6 + 1e-5 |p|; the SAGE family, whose
    ReLU gates may turn on the scatter kernel's order of atomic adds: losses
    rtol 1e-4, every parameter within half an lr, so that a replay that
    misses or repeats an Adam update fails, all but 1e-2 of them within
    1e-6 + 1e-5 |p|); each replay counted as as many scatter launches as an
    eager step makes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from furusato_recommend_tpu_torch.models.registry import SAGE_KEYS
    from furusato_recommend_tpu_torch.train.graphed import WARMUP_STEPS

    t = _graph_trainer(False, key, **over)
    graph, bs = t.step_graph, t.config.bpr_batch_size
    batches = t.sample_epoch()
    batch = [batches.slice(b * bs, (b + 1) * bs) for b in range(WARMUP_STEPS + 5)]
    t.train_step(batch[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batch[1:WARMUP_STEPS + 2]:  # the warm-up steps, the capture and its first replay
            graph.step(b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graph.graph is not None and graph.stats["captures"] == 1
    start = _graph_state(t)
    sc.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed = torch.stack([graph.step(b).clone() for b in batch[-3:]])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    replay_launches = sc.launches
    got = (replayed.cpu().numpy(), *_graph_state(t)[::2])
    _set_graph_state(t, start)
    sc.launches = 0
    eager = torch.stack([t.train_step(b) for b in batch[-3:]])
    assert replay_launches == sc.launches == 3 * graph.scatter_launches > 0, (replay_launches, sc.launches)
    want = (eager.cpu().numpy(), *_graph_state(t)[::2])
    assert torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-6)
    loss_rtol, lrs, share = (1e-4, 0.5, 1e-2) if key in SAGE_KEYS else (1e-5, 4, 1e-3)
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol)
    off = total = 0
    for k, w in want[1].items():
        diff = np.abs(got[1][k] - w)
        assert diff.max() <= lrs * t.config.lr, k
        off += int((diff > 1e-6 + 1e-5 * np.abs(w)).sum())
        total += diff.size
    assert off <= share * total, f"{off} of {total} parameters off"


@pytest.mark.cuda
def test_cuda_dropped_trainer_frees_its_graph_pool():
    """A captured trainer dropped (no collector run) gives its graph's memory
    pool back: the card's reserved memory falls by at least the pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import gc

    t = _graph_trainer(False, "textsage")
    t.train_one_epoch()
    pool = t.step_graph.stats["pool_mib"] * 2**20
    assert pool > 0
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    gc.disable()
    try:
        del t
        torch.cuda.empty_cache()
        assert reserved - torch.cuda.memory_reserved() >= pool
    finally:
        gc.enable()


# the cached cadences the trainer captures since slice 19: textsage at R = 8,
# R = 0 and T = 8, and dask (R = 0 with the streamed projections); each
# epoch cut to CADENCE_STEPS steps, two whole blocks of 8
_CADENCES = {"R8": ("textsage", {"relin_every": 8}), "R0": ("textsage", {"relin_every": 0}),
             "T8": ("textsage", {"feature_update_every": 8}), "dask": ("dask", {})}
CADENCE_STEPS = 16


def _cadence_trainer(case: str, tmp_path):
    key, over = _CADENCES[case]
    t = _graph_trainer(False, key, tmp=tmp_path, **over)
    t.num_batches, t.samples_per_epoch = CADENCE_STEPS, CADENCE_STEPS * t.config.bpr_batch_size
    return t


def _adam_states(trainer) -> list:
    """The states of every parameter both Adams step, in order."""
    return [opt.state[p] for opt in (trainer.optimizer, trainer.opt_feat) if opt is not None
            for g in opt.param_groups for p in g["params"]]


def _cadence_state(trainer):
    """(parameters on the host, both Adams' state tensors, the generator
    state), copied."""
    params = {k: p.detach().cpu().numpy().copy() for k, p in trainer.model.named_parameters()}
    return params, [{k: v.clone() for k, v in st.items()} for st in _adam_states(trainer)], trainer.generator.get_state()


@torch.no_grad()
def _set_cadence_state(trainer, state):
    params, adam, gen = state
    for k, p in trainer.model.named_parameters():
        p.copy_(torch.from_numpy(params[k]))
    for st, saved in zip(_adam_states(trainer), adam, strict=True):
        for k, v in saved.items():
            st[k].copy_(v)
    trainer.generator.set_state(gen)


def _host_syncs(fn):
    """(fn's result, the messages of torch's sync debug mode while it ran:
    one per operation that made the host wait for the card)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [str(w.message).splitlines()[0] for w in caught
                 if "synchroniz" in str(w.message) and "prototype feature" not in str(w.message)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["R8", "R0", "T8", "dask"])
def test_cuda_replayed_cadence_epoch_equals_the_eager_epoch(case, tmp_path):
    """A cached cadence's epoch of 16 steps by replays (one graph launch a
    step, one a linearization, under T = 8 one a super-step's end; dask's
    streamed passes eager) against the trainer's eager epoch from the same
    state on the same batches: no host sync in the replayed epoch, as many
    scatter launches as the eager epoch, the generator states equal, the
    first losses within 1e-6 relative, the losses within rtol 1e-3 and
    every parameter within 2 lr (the scatter kernel's atomic adds sum in no
    fixed order, and a ReLU gate within rounding of 0 may turn on it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from furusato_recommend_tpu_torch.train.graphed import PARTS

    t = _cadence_trainer(case, tmp_path)
    n, bs = t.num_batches, t.config.bpr_batch_size
    t.train_one_epoch()  # the warm-up steps and parts, the capture, replays
    graph = t.step_graph
    assert t.captured and list(graph.graphs) == list(PARTS[t.cadence]) and graph.stats["captures"] == 1
    assert graph.scatter_launches == 2
    start = _cadence_state(t)
    batches = t.sample_epoch()
    sc.launches, replays = 0, graph.stats["replays"]
    replayed, syncs = _host_syncs(lambda: t.train_epoch([batches.slice(b * bs, (b + 1) * bs) for b in range(n)]))
    assert not syncs, syncs
    assert graph.stats["replays"] == replays + n and graph.stats["captures"] == 1
    launches = sc.launches
    got = (replayed.cpu().numpy(), *_cadence_state(t)[::2])
    _set_cadence_state(t, start)
    batches = t.sample_epoch()
    t.step_graph = None  # the same epoch, each part called eagerly
    try:
        sc.launches = 0
        eager = t.train_epoch([batches.slice(b * bs, (b + 1) * bs) for b in range(n)])
    finally:
        t.step_graph = graph
    assert launches == sc.launches == 2 * n, (launches, sc.launches)
    want = (eager.cpu().numpy(), *_cadence_state(t)[::2])
    assert torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    for k, w in want[1].items():
        assert np.abs(got[1][k] - w).max() <= 2 * t.config.lr, k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["R8", "T8"])
def test_cuda_cadence_captured_adam_matches_optax(case, tmp_path):
    """The fused, capturable Adams of a captured cadence, its parts driven
    one by one (R = 8: a block of 8 steps, 3 eager, the capture in the
    block, 5 replays; T = 8: two super-steps of 8, the first eager, the
    second replayed), against optax.adam's rule in float64
    (``tests/torch_oracle.py::OptaxAdam``) fed each step's gradients as the
    card computed them: the parameters within rtol 1e-4 / atol 1e-6, the
    moments within rtol 1e-4 (atol 1e-9 / 1e-12), each Adam's step count
    (T = 8: 16 steps of the others, 2 of the feature parameters)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from torch_oracle import OptaxAdam

    t = _cadence_trainer(case, tmp_path)
    graph, bs = t.step_graph, t.config.bpr_batch_size
    opts = [o for o in (t.optimizer, t.opt_feat) if o is not None]
    assert all(g["fused"] and g["capturable"] for o in opts for g in o.param_groups)
    params = {id(o): [p for g in o.param_groups for p in g["params"]] for o in opts}
    refs = {id(o): OptaxAdam([p.detach().cpu().numpy() for p in params[id(o)]], t.config.lr) for o in opts}

    def feed(opt):
        assert all(p.grad is not None for p in params[id(opt)])
        refs[id(opt)].step([p.grad.cpu().numpy() for p in params[id(opt)]])

    steps = 8 if case == "R8" else 16
    batches = t.sample_epoch()
    for b in range(steps):
        if b % 8 == 0:
            graph.run("_linearize")
        graph.run(graph.step_part, batches.slice(b * bs, (b + 1) * bs))
        feed(t.optimizer)
        if case == "T8" and b % 8 == 7:
            graph.run("_outer_step")
            feed(t.opt_feat)
    assert graph.stats["captures"] == 1 and graph.stats["replays"] == (5 if case == "R8" else 8)
    for o in opts:
        ref = refs[id(o)]
        assert ref.count == (2 if o is t.opt_feat else steps)
        for i, p in enumerate(params[id(o)]):
            state = o.state[p]
            assert float(state["step"]) == ref.count
            np.testing.assert_allclose(p.detach().cpu().numpy(), ref.params[i], rtol=1e-4, atol=1e-6, err_msg=str(i))
            np.testing.assert_allclose(state["exp_avg"].cpu().numpy(), ref.mu[i], rtol=1e-4, atol=1e-9)
            np.testing.assert_allclose(state["exp_avg_sq"].cpu().numpy(), ref.nu[i], rtol=1e-4, atol=1e-12)


@pytest.mark.cuda
def test_cuda_dropped_cadence_trainer_frees_its_graph_pool(tmp_path):
    """A captured T = 8 trainer (three graphs in one pool, the tables' saved
    activations among its tensors) dropped without a collector run gives
    the pool back: the card's reserved memory falls by at least the pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import gc

    t = _cadence_trainer("T8", tmp_path)
    t.train_one_epoch()
    assert len(t.step_graph.graphs) == 3
    pool = t.step_graph.stats["pool_mib"] * 2**20
    assert pool > 0
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    gc.disable()
    try:
        del t
        torch.cuda.empty_cache()
        assert reserved - torch.cuda.memory_reserved() >= pool
    finally:
        gc.enable()


# the captured evaluation (eval/graphed.py): a key of each family, every
# metric the evaluator computes on the card (AUC, cold start), textsage also
# under --inference sample (its trees drawn in the graph)
_EVAL_CASES = {"mf": ("mf", {}), "lgn": ("lgn", {}), "textsage": ("textsage", {}),
               "textsage_sample": ("textsage", {"inference": "sample"}), "sasrec": ("sasrec", {}),
               "asage": ("asage", {})}


def _eval_trainer(case: str):
    key, over = _EVAL_CASES[case]
    return _graph_trainer(False, key, compute_auc=True, cold_start=True, **over)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """``chip_smoke.py`` as a module: its rule for two evaluations from the
    same parameters (``evaluation_rule``) and its eager evaluation
    (``eager_evaluation``), which these tests share with it."""
    spec = importlib.util.spec_from_file_location("chip_smoke_kernels", Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held_evaluation(got, want, ev, data):
    """A replayed evaluation (results, top-K ids) against an eager one from
    the same parameters, under ``chip_smoke.py::evaluation_rule``: bit-equal,
    or where cuSPARSE's SpMM (the propagation's, which sums in no fixed
    order on the H100) parts them, scores, ids outside ties and metrics
    within its limits. mf propagates nothing and is held bit-equal."""
    rule = _chip_smoke().evaluation_rule(got, want, ev, data)
    if ev.model.name == "mf":
        assert rule["ids_moved"] == 0 and not rule["metrics_off"], rule


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_EVAL_CASES))
def test_cuda_replayed_evaluation_equals_eager(case):
    """The evaluator's first call runs eagerly (the warm-up), the second
    captures the whole evaluation and replays it, the third replays: both
    replays equal to the eager one (results and top-K ids, under
    ``_held_evaluation``: the capture records the eager kernels in their
    order), one capture, each evaluation n_tiles masked_topk launches (a
    replay counted as its capture recorded)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    t = _eval_trainer(case)
    ev, data = t.evaluator, t.eval_data
    n_tiles = data.users.shape[0]
    st.launches = 0
    eager = ev(data)
    assert ev.graphed is not None and ev.graphed.graph is None
    replays = [ev(data), ev(data)]
    assert ev.graphed.stats["captures"] == 1 and ev.graphed.stats["replays"] == 2
    assert ev.graphed.launches == (n_tiles, 0) and st.launches == 3 * n_tiles
    for got in replays:
        _held_evaluation(got, eager, ev, data)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lgn", "textsage_sample"])
def test_cuda_evaluation_replay_never_waits(case):
    """A replayed evaluation and an eager one (once the first call has built
    what the models keep) make no host sync under the sync debug mode's
    "error"; ``__call__`` adds its one copy to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    t = _eval_trainer(case)
    ev, data = t.evaluator, t.eval_data
    ev(data)
    ev(data)  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev.evaluate(data)  # a replay
        ev.seed()
        ev.program(data)  # the eager evaluation
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _, syncs = _host_syncs(lambda: ev(data, with_topk=False))
    assert len(syncs) == 1, syncs


@pytest.mark.cuda
def test_cuda_evaluation_graph_freed_with_its_trainer():
    """A trainer whose evaluation is captured, dropped without a collector
    run, gives the graph's memory pool back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import gc

    t = _eval_trainer("textsage")
    t.test()
    t.test()
    pool = t.evaluator.graphed.stats["pool_mib"] * 2**20
    assert pool > 0
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    gc.disable()
    try:
        del t
        torch.cuda.empty_cache()
        assert reserved - torch.cuda.memory_reserved() >= pool
    finally:
        gc.enable()


@pytest.mark.cuda
def test_cuda_evaluation_recaptures_after_restore(tmp_path):
    """restore (and init_state) drop the evaluation's graph: the next
    evaluation is eager, the one after it a new capture, and both equal the
    evaluation of the saved state; an evaluation after training replays the
    first capture with the trained parameters, held against an eager
    evaluation of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    t = _eval_trainer("lgn")
    t.test()
    saved = t.test()
    assert t.evaluator.graphed.stats["captures"] == 1
    t.save(tmp_path / "a.ckpt")
    t.train_one_epoch()
    ev, data = t.evaluator, t.eval_data
    trained = ev(data)
    assert ev.graphed.stats["captures"] == 1 and trained[0] != saved
    with _chip_smoke().eager_evaluation(ev):
        eager = ev(data)
    _held_evaluation(trained, eager, ev, data)
    t.restore(tmp_path / "a.ckpt")
    assert t.evaluator.graphed.graph is None
    for _ in range(2):  # eager, then a new capture
        got = t.test()
        assert set(got) == set(saved)
        for k in saved:  # the propagation's SpMM sums in no fixed order (_held_evaluation)
            np.testing.assert_allclose(got[k], saved[k], rtol=1e-3, err_msg=k)
    assert t.evaluator.graphed.stats["captures"] == 2
    t.init_state()
    assert t.evaluator.graphed.graph is None


# the serving tier's two programs (serve.py) and --pipeline_dispatch's
# prefetch (train/trainer.py) on the card


def _serve_recommender(key: str):
    """A Recommender on the card of a ``_graph_trainer`` model (lgn at
    float32, d 32; a SAGE-family key at the flagship cut) and its dataset."""
    from furusato_recommend_tpu_torch.serve import Recommender

    t = _graph_trainer(False, key)
    return Recommender(t.model, t.dataset, t.config, None, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["lgn", "textsage", "sasrec", "asage"])
def test_cuda_serve_graph_refresh_replays_equal_eager(key):
    """The constructor's refresh is the eager warm-up, the next captures,
    every later one (new parameters written in place included) replays the
    one capture; a replay held against an eager refresh of the same
    parameters under ``chip_smoke.py::refresh_rule`` (phase 4's rule for
    lgn, phase 9's for the SAGE family, sasrec's at rtol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cs = _chip_smoke()
    rec = _serve_recommender(key)
    assert rec.captured and rec.refresh_graph is None and rec.refresh_stats["captures"] == 0
    cs.held_refresh(rec, key, key)
    stats = rec.refresh_stats
    assert stats["captures"] == 1 and stats["pool_mib"] is not None
    replays = stats["replays"]
    for _ in range(3):
        rec.refresh()
    assert stats["captures"] == 1 and stats["replays"] == replays + 3
    moved = {k: 1.5 * p.detach().cpu().numpy() for k, p in rec.model.named_parameters()}
    before = cs._embeddings(rec)
    rec.refresh(moved)
    assert stats["captures"] == 1 and not np.array_equal(cs._embeddings(rec), before)
    cs.held_refresh(rec, key, key)
    assert stats["captures"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 200])
def test_cuda_serve_graph_requests_replay_equal_eager(k):
    """At B in {1, 8, 64, 512, 513}: the first request of a shape eager,
    the second captured and replayed, each replay bit-equal to the eager
    answer and to the kernel called on the request's users alone (the
    padding rows leak nothing); the capture records one launch (the radix
    select's at k = 200) and a replay counts it; the copy in and the replay
    make no host sync under the sync debug mode's "error", and a whole
    replayed request one (its copy out)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from furusato_recommend_tpu_torch.serve import request_tile

    cs = _chip_smoke()
    rec = _serve_recommender("lgn")
    rng = np.random.default_rng(3)
    mask = (rec._mask.indptr, rec._mask.indices)
    for b in (1, 8, 64, 512, 513):
        users = rng.choice(rec.n_users, size=b, replace=False)
        with cs.eager_serving(rec):
            want = rec.recommend(users, k=k)
        rec.recommend(users, k=k)  # the shape's warm-up
        st.launches = st.wide_launches = 0
        got = rec.recommend(users, k=k)  # the capture (b = 8 shares b = 1's tile), then a replay
        req = rec.requests[(request_tile(b), k)]
        replays = req.stats["replays"]
        assert req.graph is not None and req.launches == (1, int(k > st.MAX_K))
        assert (st.launches, st.wide_launches) == (1, int(k > st.MAX_K))
        direct = masked_topk(rec._user_emb, rec._item_emb, torch.from_numpy(users).cuda(), k, *mask)
        for g, w, d in zip(got, want, (direct[1], direct[0])):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, d.cpu().numpy())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            req.ids.copy_(req.host_ids, non_blocking=True)
            req.graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        again, syncs = _host_syncs(lambda: rec.recommend(users, k=k))
        assert len(syncs) == 1, syncs
        for g, w in zip(again, want):
            np.testing.assert_array_equal(g, w)
        assert req.stats["captures"] == 1 and req.stats["replays"] == replays + 1


@pytest.mark.cuda
def test_cuda_serve_graph_recaptures_after_a_replaced_buffer():
    """A parameter replaced by another tensor (not written in place): the
    next refresh sees it, drops the refresh graph and the request graphs and
    runs eagerly with the new tensor; the one after captures anew, and its
    replays read the new tensor (a write into it in place reaches them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cs = _chip_smoke()
    rec = _serve_recommender("lgn")
    users = np.arange(64)
    rec.refresh()
    for _ in range(3):
        rec.recommend(users, k=10)
    assert rec.refresh_stats["captures"] == 1 and rec.requests[(64, 10)].graph is not None
    old = cs._embeddings(rec)
    rec.model.user_emb = torch.nn.Parameter(rec.model.user_emb.detach() * -1.0)
    rec.refresh()
    assert rec.refresh_graph is None and rec.requests == {}
    eager = cs._embeddings(rec)
    assert not np.allclose(eager, old)
    rec.refresh()
    assert rec.refresh_stats["captures"] == 2 and rec.refresh_graph is not None
    np.testing.assert_allclose(cs._embeddings(rec), eager, rtol=2e-3, atol=1e-5)
    with torch.no_grad():
        rec.model.user_emb.mul_(2.0)
    rec.refresh()
    assert rec.refresh_stats["captures"] == 2
    with cs.eager_serving(rec):
        rec.refresh()
        want = cs._embeddings(rec)
    rec.refresh()
    np.testing.assert_allclose(cs._embeddings(rec), want, rtol=2e-3, atol=1e-5)
    assert not np.allclose(want, eager)


@pytest.mark.cuda
def test_cuda_pipeline_epochs_draw_the_synchronous_triplets():
    """lgn with edge dropout (drawn inside each replayed step from the
    trainer's generator), pipelined against synchronous from one seed over
    3 epochs: after each, the generator states equal and the triplets drawn
    ahead (on the trainer's draw stream) bit-equal to those the synchronous
    trainer draws next (the
    prefetch's generator state, set when it is taken, is the one the
    replays read), the losses within rtol 1e-5 (the first 1e-6: the scatter
    kernel's atomic adds sum in no fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    pipe = _graph_trainer(True)
    sync = _graph_trainer(True, pipeline_dispatch=False)
    assert pipe.pipeline and not sync.pipeline
    for _ in range(3):
        pipe.train_one_epoch()
        sync.train_one_epoch()
        assert pipe._draw_stream is not None and pipe._draw_stream != torch.cuda.current_stream()
        assert torch.equal(pipe.generator.get_state(), sync.generator.get_state())
        state = sync.generator.get_state()
        want = sync.sample_epoch()
        sync.generator.set_state(state)
        got = pipe.prefetched
        for a, b in zip((got.user, got.pos, got.neg, got.valid), (want.user, want.pos, want.neg, want.valid)):
            assert torch.equal(a, b)
        gl, wl = pipe.epoch_losses.cpu().numpy(), sync.epoch_losses.cpu().numpy()
        np.testing.assert_allclose(gl[0], wl[0], rtol=1e-6)
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert pipe.step_graph.stats["captures"] == 1
