"""Port vs JAX package: the row scatter-add and the table gather whose
gradient it is (``ops/scatter.py`` against ``ops/pallas_scatter.py``), and the
CUDA kernel's launch plan, which runs anywhere.

On the CPU the port's wrapper runs its plain ``index_add_`` version; the JAX
kernel runs in interpret mode. Both sum float32 rows in different orders:
rtol 1e-5, atol 1e-5 for Gaussian rows (as tests/test_pallas.py holds the JAX
kernel against XLA), bit-equal for rows that are small multiples of 1/8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.ops import pallas_scatter as jps
from furusato_recommend_tpu_torch.ops import scatter as ts

torch.set_num_threads(1)


def _case(n, d, r, seed, exact=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, r).astype(np.int32)
    if exact:
        rows = (rng.integers(-8, 9, (r, d)) / 8).astype(np.float32)
    else:
        rows = rng.standard_normal((r, d)).astype(np.float32)
    return ids, rows


@pytest.mark.parametrize(
    "n,d,r,exact",
    [
        (300, 32, 5000, False),  # r not a chunk multiple: the JAX kernel pads
        (64, 64, 2048, True),
        (20, 8, 4096, True),  # d < 128: the JAX kernel packs 16 rows per lane row
    ],
)
def test_scatter_add_rows_matches_jax_kernel(n, d, r, exact):
    ids, rows = _case(n, d, r, seed=n + d, exact=exact)
    want = np.asarray(jps.scatter_add_rows(jnp.asarray(ids), jnp.asarray(rows), n, interpret=True))
    got = ts.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), n).numpy()
    assert got.shape == (n, d) and got.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _skewed_ids(n, r, rng):
    """Zipf(1.2) ids with the most frequent id on about a tenth of the rows,
    as a hub item is in a SAGE step's sampled trees."""
    ids = np.minimum(rng.zipf(1.2, r) - 1, n - 1)
    ids[rng.permutation(r)[: r // 10]] = n // 3
    return rng.permutation(n)[ids].astype(np.int32)


@pytest.mark.parametrize("skew", ["hub", "small_table"])
@pytest.mark.parametrize("exact", [True, False])
def test_scatter_add_rows_matches_jax_kernel_on_repeated_ids(skew, exact):
    # what the kernel's tile mode is for: one id on ~10% of the
    # rows (a hub item), and a table of 40 rows that every update hits
    rng = np.random.default_rng(11)
    n, d, r = (3000, 32, 6000) if skew == "hub" else (40, 32, 6000)
    ids = _skewed_ids(n, r, rng) if skew == "hub" else rng.integers(0, n, r).astype(np.int32)
    if skew == "hub":
        assert np.bincount(ids).max() >= r // 10
    _, rows = _case(n, d, r, seed=12, exact=exact)
    want = np.asarray(jps.scatter_add_rows(jnp.asarray(ids), jnp.asarray(rows), n, interpret=True))
    got = ts.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), n).numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "n,d,r",
    [
        (50, 64, 0),  # no rows: a zero table
        (1, 16, 300),  # one row takes every update
        (5000, 64, 999),  # R not a multiple of 32
    ],
)
def test_scatter_add_rows_matches_xla_scatter(n, d, r):
    ids, rows = _case(n, d, r, seed=r + 1)
    want = np.asarray(jnp.zeros((n, d), jnp.float32).at[jnp.asarray(ids)].add(jnp.asarray(rows)))
    got = ts.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_scatter_repeated_id_and_clamped_ids():
    # one id 5,000 times (a hub item); ids outside [0, n) clamp into the
    # table, as the JAX kernel's callers clip them
    n, d = 40, 16
    rng = np.random.default_rng(9)
    ids = np.concatenate([np.full(5000, 7), [-3, n, n + 100, 0]]).astype(np.int32)
    rows = (rng.integers(-4, 5, (len(ids), d)) / 8).astype(np.float32)
    want = np.asarray(
        jnp.zeros((n, d)).at[jnp.clip(jnp.asarray(ids), 0, n - 1)].add(jnp.asarray(rows))
    )
    got = ts.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), n).numpy()
    np.testing.assert_array_equal(got, want)
    ref = ts.scatter_add_rows_reference(torch.from_numpy(ids).long(), torch.from_numpy(rows), n)
    np.testing.assert_array_equal(ref.numpy(), want)


def test_scatter_rejects_bad_input_and_never_launches_on_cpu():
    ts.launches = 0
    with pytest.raises(ValueError):
        ts.scatter_add_rows(torch.zeros(3, dtype=torch.int32), torch.zeros(4, 2), 5)
    with pytest.raises(ValueError):
        ts.scatter_add_rows(torch.zeros(3), torch.zeros(3, 2), 5)
    with pytest.raises(ValueError):
        ts.scatter_add_rows(torch.zeros(3, dtype=torch.int32), torch.zeros(3, 2), 0)
    ids, rows = _case(10, 4, 50, seed=0)
    ts.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), 10)
    assert ts.launches == 0


@pytest.mark.parametrize("shape", [(7, 9), (64,)])
def test_table_gather_value_and_grad_match_jax(shape):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, shape).astype(np.int32)
    weight = rng.standard_normal(shape + (8,)).astype(np.float32)

    def f(t):
        return jnp.sum(jps.table_gather(t, jnp.asarray(ids)) ** 2 * weight)

    want_v, want_g = jax.value_and_grad(f)(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = ts.table_gather(t, torch.from_numpy(ids))
    assert out.shape == shape + (8,)
    got_v = torch.sum(out**2 * torch.from_numpy(weight))
    got_v.backward()
    np.testing.assert_allclose(float(got_v.detach()), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


SMS = 132  # an H100's SMs
CHIP_SHAPES = {  # (N, R, D) of the main paths -> (mode, T, blocks)
    (30_000, 285_000, 32): ("tile", 1088, 262),  # the TextSAGE item-side tree gather
    (100_000, 180_000, 32): ("tile", 704, 256),  # its user-side tree gather
    (40, 400_000, 32): ("tile", 1536, 261),  # a categorical gather
    (50_000, 8_192, 64): ("row", 8, 1024),  # the lgn step's user gather
    (20_000, 16_384, 64): ("row", 8, 2048),  # its item gather
}


def _block_rows(plan, r):
    """Rows each block of the grid adds, as the kernel walks them."""
    if plan.mode == "tile":  # block b takes tiles b, b + blocks, ...
        return [np.concatenate([np.arange(t * plan.tile, min(r, (t + 1) * plan.tile))
                                for t in range(b, plan.tiles, plan.blocks)] or [np.zeros(0, int)])
                for b in range(plan.blocks)]
    warps = plan.blocks * ts.ROW_WARPS  # row mode: warp w takes rows w, w + warps, ...
    return [np.arange(w, r, warps) for w in range(warps)]


@pytest.mark.parametrize("n", [1, 40, 20_000, 100_000])
@pytest.mark.parametrize("d", [1, 4, 32, 50, 64, 300, 4096])
@pytest.mark.parametrize("r", [0, 1, 31, 8192, 285_000])
def test_plan_scatter_invariants(n, d, r):
    chosen = ts.plan_scatter(n, r, d, SMS)
    tile_plan = ts.plan_scatter(n, r, d, SMS, "tile")
    # tiles, unless they would be too short to repay their pass in shared
    # memory and the row mode's chains stay short
    assert (chosen.mode == "row") == (tile_plan.tile < ts.ROW_BELOW_TILE and r < ts.ROW_CHAIN * n)
    for plan in (chosen, tile_plan, ts.plan_scatter(n, r, d, SMS, "row")):  # every D has a plan
        assert plan.tiles == -(-r // plan.tile) and plan.blocks >= 1
        covered = np.bincount(np.concatenate(_block_rows(plan, r) + [np.zeros(0, int)]),
                              minlength=r)
        assert (covered == 1).all()  # the tiles cover R exactly once
        if plan.mode == "row":
            assert plan.tile == ts.ROW_WARPS and plan.smem_bytes == 0
            continue
        assert plan.tile % 32 == 0 and plan.tile <= ts.MAX_TILE
        # shared memory: a block's most, and the SM's for the two blocks it holds
        assert plan.smem_bytes == ts.tile_smem(plan.tile, plan.chunk, 4 if d % 4 == 0 else 1)
        assert plan.smem_bytes <= ts.SMEM_PER_BLOCK
        assert ts.TILE_BLOCKS_PER_SM * (plan.smem_bytes + ts.SMEM_RESERVED) <= ts.SMEM_PER_SM
        # column chunks: aligned for float4s, as few as fit
        assert 1 <= plan.chunk and (d % 4 or plan.chunk % 4 == 0)
        assert plan.chunk >= d or -(-d // plan.chunk) * plan.chunk - d < plan.chunk
        # one wave: every tile has its block, and the grid fills 2 x SMs
        # wherever there are that many tiles
        slots = ts.TILE_BLOCKS_PER_SM * SMS
        assert plan.blocks == max(1, min(plan.tiles, slots))
        # the tiles are as long as one wave of 2 x SMs blocks needs, and no longer
        assert plan.tiles <= slots or plan.tile == ts.MAX_TILE
        if plan.tile > 32 and plan.tiles <= slots:
            assert -(-r // (plan.tile - 32)) > slots


@pytest.mark.parametrize("shape", sorted(CHIP_SHAPES))
def test_plan_scatter_at_the_main_paths_shapes(shape):
    plan = ts.plan_scatter(*shape, SMS)
    assert (plan.mode, plan.tile, plan.blocks) == CHIP_SHAPES[shape]
    assert plan.chunk == shape[2]  # one pass over the columns
