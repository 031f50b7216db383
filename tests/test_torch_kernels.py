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
